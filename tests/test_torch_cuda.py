"""CUDA kernels of octane_tpu_torch against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present.  Run them on
the GPU with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Budgets: the warp is bit-exact (samples, flags and tile statistics); so
are the PCG passes, block partials included (the plain versions sum in the
kernels' order), and the pass driver; a 30-iteration solve agrees to rel
5e-4 with the reference loop flow.cg.pcg_solve (docs/PARITY.md).
"""

import numpy as np
import pytest
import torch

from octane_tpu_torch.flow.cg import pcg_solve
from octane_tpu_torch.flow.stencil import StencilSystem, apply_stencil
from octane_tpu_torch.ops import pcg, warp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("spread", [2.0, 40.0])
@pytest.mark.parametrize("hw", [(256, 384), (250, 131), (40, 70)])
def test_warp_kernel_bit_exact(dev, hw, spread):
    h, w = hw
    rng = np.random.default_rng(0)
    fields = torch.from_numpy(rng.normal(0, 1, (6, h, w)).astype(np.float32)).to(dev)
    u = torch.from_numpy(rng.uniform(-spread, spread, (h, w)).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.uniform(-spread, spread, (h, w)).astype(np.float32)).to(dev)
    before = warp.warp.launches
    s, bx, by, stats, staged = warp.warp(fields, u, v, with_stats=True)
    assert warp.warp.launches == before + 1
    ps, pbx, pby = warp.warp_bilinear_dense(fields, u, v)
    assert torch.equal(s, ps) and torch.equal(bx, pbx) and torch.equal(by, pby)
    assert torch.equal(stats, warp.warp_block_stats(u, v))
    assert staged.shape == stats.shape[1:]


@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("hw", [(256, 384), (97, 131)])
def test_pcg_kernels_match_plain(dev, hw, quad):
    h, w = hw
    rng = np.random.default_rng(1)

    def arr(lo, hi, shape=(h, w)):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)

    s = StencilSystem(arr(4.5, 9.0), arr(-0.2, 0.2), arr(4.5, 9.0),
                      *((-1.0,) * 4 if quad else [-arr(0.3, 1.0) for _ in range(4)]),
                      arr(-100, 100), arr(-100, 100))
    cf = torch.stack([s.a1, s.a4, s.a2] + ([] if quad else [s.a5, s.a6, s.a7, s.a8]))
    x, r, p = (arr(-10, 10, (2, h, w)) for _ in range(3))
    ab = torch.tensor([0.4, 0.9], device=dev)
    ka = pcg.pcg_pass_a(x, r, p, cf, ab)
    pa = pcg.pcg_pass_a_plain(x, r, p, cf, ab)
    for k, q in zip(ka, pa):
        assert torch.equal(k, q)
    kb = pcg.pcg_pass_b(r, ka[2], cf, ab[:1].clone())
    pb = pcg.pcg_pass_b_plain(r, ka[2], cf, ab[:1].clone())
    assert torch.equal(kb[0], pb[0]) and torch.equal(kb[1], pb[1])
    fu, fv = pcg.pcg_solve_fused(s, 1e-8, 30)
    gu, gv = pcg.pcg_solve_fused(s, 1e-8, 30, pcg.pcg_pass_a_plain, pcg.pcg_pass_b_plain)
    assert torch.equal(fu, gu) and torch.equal(fv, gv)
    ru, rv = pcg_solve(lambda a, b: apply_stencil(s, a, b), s.a1, s.a4, s.bu, s.bv,
                       1e-8, 30)
    assert max(_rel(fu, ru), _rel(fv, rv)) <= 5e-4
