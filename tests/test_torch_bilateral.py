"""The arithmetic of the bilateral kernel (csrc/bilateral.cu), replayed on
the CPU, against the plain version ``ops.bilateral.bilateral_plain`` and
octane_tpu's ``srsal_smooth`` at rel <= 1e-5 (docs/PARITY.md:91).

``folded_replay`` is a plain float32 PyTorch function that computes what
the kernel computes, in its order: the spatial weight folded into one
base-2 exponent, L[kc][lc] = log2 gk[kc] + log2 gk[lc] and k = -sigpix2
log2(e) summed in float64 and rounded to float32; per tap d = c_n - c_0 in
metres, t = k d, arg = fma(-t, d, L), a = 2^arg with results below 2^-126
flushed to 0, au = fma(u_n, a, au), av = fma(v_n, a, av), a2 += a; each
thread's R pixels of one column take their taps column offset outer, then
window row by window row, each row serving the pixels whose window holds
it.  ``torch.exp2`` in float64, rounded to float32, stands in for the
card's MUFU.EX2 (ex2.approx.ftz; float64 because the float32 exp2 of the
CPU rounds differently in its vector and scalar paths) and an FMA is a
product and sum in float64 rounded once to float32 (exact but for a
double rounding, rare and below the budget); only the card checks the
hardware op (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octane_tpu.post.srsal import srsal_smooth as jax_srsal_smooth
from octane_tpu_torch.core.gaussian import gaussian_kernel_1d
from octane_tpu_torch.ops.bilateral import bilateral_plain, reflect_pad
from tests import torch_fixtures as fx

torch.set_num_threads(2)
SIGPIX2 = -1.0 / (2.0 * 20.0 * 20.0)
LOG2E = 1.4426950408889634
FTZ = 2.0 ** -126


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def folded_replay(u, v, cth, gk, sigpix2, rows=6):
    """The (2, H, W) smoothed flow by the kernel's arithmetic, ``rows``
    pixels per thread."""
    gk = np.asarray(gk, np.float32)
    n = len(gk)
    p = (n - 1) // 2
    lg = np.log2(gk.astype(np.float64))
    table = torch.from_numpy((lg[:, None] + lg[None, :]).astype(np.float32))   # L[kc, lc]
    k = torch.tensor(-float(np.float32(sigpix2)) * LOG2E, dtype=torch.float32)
    h, w = u.shape
    nb = -(-h // rows)                  # blocks of rows; the last may be ragged
    extra = nb * rows - h

    def rows_past_edge(t):              # rows the kernel reads and never writes
        return torch.cat([t, t[-1:].expand(extra, -1)]) if extra else t

    up, vp, cp = (rows_past_edge(reflect_pad(t, p)) for t in (u, v, cth))
    c0 = rows_past_edge(cth).reshape(nb, rows, w)
    au, av, a2 = (torch.zeros((nb, rows, w)) for _ in range(3))
    for kc in range(n):
        for s in range(rows + 2 * p):
            # window row s of every block serves its pixels i0..i1 at lc = s - i
            i0, i1 = max(0, s - 2 * p), min(rows - 1, s)
            src = slice(s, s + nb * rows, rows)
            cn, un, vn = (t[src, kc:kc + w][:, None] for t in (cp, up, vp))
            lw = table[kc, s - torch.arange(i0, i1 + 1)][None, :, None]
            d = cn - c0[:, i0:i1 + 1]
            arg = _fma(-(k * d), d, lw)
            a = torch.exp2(arg.double()).float()
            a = torch.where(a < FTZ, torch.zeros_like(a), a)
            au[:, i0:i1 + 1] = _fma(un, a, au[:, i0:i1 + 1])
            av[:, i0:i1 + 1] = _fma(vn, a, av[:, i0:i1 + 1])
            a2[:, i0:i1 + 1] = a2[:, i0:i1 + 1] + a
    return torch.stack([au / a2, av / a2]).reshape(2, nb * rows, w)[:, :h]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


CASES = [(hw, cth, 18, rows) for hw in [(19, 19), (40, 48), (64, 72)]
         for cth in ["uniform", "2-km steps"] for rows in (1, 6)]
CASES += [((40, 48), "2-km steps", 6, rows) for rows in (1, 4)]


@pytest.mark.parametrize("hw,cth,p,rows", CASES)
def test_folded_replay_within_budget(hw, cth, p, rows):
    """Uniform 0-12 km CTH (nearly every off-centre weight underflows) and
    fx.cth_steps, 2-km plateaus with a +-30 m ripple (the smoke's field);
    6 rows per thread as the kernel's p = 18 geometry, 4 as its run-time-p
    instantiation (p = 6 here), and 1, one pixel per thread: each pixel
    keeps its order of taps whatever the rows per thread, ragged last
    blocks included."""
    h, w = hw
    rng = np.random.default_rng(h + w + p)
    u, v = (rng.normal(0, 2, hw).astype(np.float32) for _ in range(2))
    c = (rng.uniform(0, 12000, hw) if cth == "uniform"
         else fx.cth_steps(h, w, seed=h)).astype(np.float32)
    gk = gaussian_kernel_1d(p / 2.0, p)
    tu, tv, tc = (torch.from_numpy(a) for a in (u, v, c))
    got = folded_replay(tu, tv, tc, gk, SIGPIX2, rows=rows).numpy()
    assert got.shape == (2, h, w) and np.isfinite(got).all()
    plain = bilateral_plain(tu, tv, tc, gk, SIGPIX2).numpy()
    ju, jv = jax_srsal_smooth(jnp.asarray(u), jnp.asarray(v), jnp.asarray(c), filtsigma=p / 2.0)
    for i, want in enumerate((np.asarray(ju), np.asarray(jv))):
        assert _rel(got[i], plain[i]) <= 1e-5
        assert _rel(got[i], want) <= 1e-5
