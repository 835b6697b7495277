"""octane_tpu_torch.ops.pyramid (a level of the solver pyramid) on the CPU.

On CPU tensors ``pyramid_level`` runs its plain version, counted as a
plain call and never as a launch, and equals ``core.zoom``'s
``pyramid_downsample`` (a whole image) and ``pyramid_downsample_rows`` (a
band's slab) exactly; it refuses what its kernel does not take, and its
tiling holds every tile of the pyramid's indices.  The solve
on the CPU, through its wrapper or its internal plain route, makes one
plain call a coarse level (the banded solve none).  The kernel itself runs in
tests/test_torch_cuda.py (marker ``cuda``).
"""

import numpy as np
import pytest
import torch

from octane_tpu_torch import ops
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.core import zoom
from octane_tpu_torch.core.gaussian import blur_separable, solver_filtsize
from octane_tpu_torch.flow.variational import _coarse_to_fine, variational_flow
from octane_tpu_torch.ops.pyramid import (MAX_ROWS, MAX_TAPS, PITCH, SMEM_BYTES, pyramid_level,
                                          pyramid_level_plain, pyramid_taps, row_step, tiling)

torch.set_num_threads(2)


def _img(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(0, 255, shape)
                            .astype(np.float32))


@pytest.mark.parametrize("factor", [0.5, 0.25, 0.125, 1 / 32])
@pytest.mark.parametrize("shape", [(4, 64, 80), (8, 45, 37), (4, 3, 9)])
def test_level_equals_pyramid_downsample(factor, shape):
    img = _img(shape)
    h = shape[1]
    ops.reset_counters()
    got = pyramid_level(img, 0, h, factor, (0, zoom.zoom_size(h, factor)))
    assert ops.counters()["pyramid_level"] == (0, 1)
    assert torch.equal(got, zoom.pyramid_downsample(img, factor))


@pytest.mark.parametrize("factor", [0.5, 0.125, 1 / 32])
@pytest.mark.parametrize("rows", [(0, 7), (5, 12), (9, 16)])
def test_slab_level_equals_the_whole_call_rows(factor, rows):
    h, w = 140, 52
    img = _img((4, h, w), seed=1)
    nyy = zoom.zoom_size(h, factor)
    rows = (min(rows[0], nyy - 1), min(rows[1], nyy))
    s0, s1 = zoom.pyramid_rows(h, factor, rows)
    slab = img[:, s0:s1].contiguous()
    got = pyramid_level(slab, s0, h, factor, rows)
    assert torch.equal(got, zoom.pyramid_downsample_rows(slab, s0, h, factor, rows))
    assert torch.equal(got, zoom.pyramid_downsample(img, factor)[:, rows[0]:rows[1]])


def test_plain_version_is_the_blur_then_the_subsample():
    img = _img((4, 30, 41), seed=2)
    fs, taps = pyramid_taps(0.25)
    # trunc(j / f) in float32, as the CUDA integer cast
    ridx = torch.from_numpy(np.trunc(np.arange(8, dtype=np.float32) / np.float32(0.25))
                            .astype(np.int64))
    cidx = torch.from_numpy(np.trunc(np.arange(10, dtype=np.float32) / np.float32(0.25))
                            .astype(np.int64))
    want = blur_separable(img, taps, fs).index_select(-2, ridx).index_select(-1, cidx)
    assert pyramid_level_plain is zoom.pyramid_downsample_rows
    ops.reset_counters()
    assert torch.equal(pyramid_level_plain(img, 0, 30, 0.25, (0, 8)), want)
    assert torch.equal(zoom.pyramid_downsample(img, 0.25), want)
    assert ops.counters()["pyramid_level"] == (0, 0)      # uncounted outside the wrapper


def test_level_refuses_what_the_kernel_does_not_take():
    img = _img((4, 20, 20))
    lvl = (0, 10)
    bad = [((img.double(), 0, 20, 0.5, lvl), "float32"),
           ((img.transpose(1, 2), 0, 20, 0.5, lvl), "contiguous"),
           ((img[0], 0, 20, 0.5, lvl), "shape"),
           ((img[:, :0], 0, 20, 0.5, (0, 0)), "shape"),
           ((img, 0, 20, 1.0, lvl), "factor"),
           ((img, 0, 20, 0.5, (0, 11)), "level rows"),
           ((img, 0, 20, 0.5, (5, 4)), "level rows"),
           ((img, 0, 40, 0.5, (0, 20)), "do not hold"),        # the slab is too short
           ((img, 5, 40, 0.5, (4, 8)), "do not hold")]         # and starts too low
    tiny = 1.0 / 5000.0                 # fs = 2 / sqrt(2 f) = 100: 200 taps
    assert 2 * solver_filtsize(tiny) > MAX_TAPS
    bad.append(((img, 0, 20, tiny, (0, 0)), "taps"))
    ops.reset_counters()
    for args, what in bad:
        with pytest.raises(ValueError, match=what):
            pyramid_level(*args)
    assert ops.counters()["pyramid_level"] == (0, 0)


@pytest.mark.parametrize("factor,step", [(0.5, 2), (0.25, 4), (0.125, 8), (1 / 32, 32),
                                         (0.6, 3), (1 / 3, 4), (0.1, 11)])
def test_row_step_is_exact_for_powers_of_two(factor, step):
    assert row_step(factor) == step


def _tile_spans(idx, rows, fs, n_in):
    """The source rows each tile of ``rows`` output rows stages (the
    kernel's first window to its last, clamped)."""
    first, last = idx[::rows], idx[rows - 1::rows]
    last = np.append(last, idx[-1]) if len(idx) % rows else last
    return np.clip(last + fs - 1, 0, n_in - 1) - np.clip(first - fs, 0, n_in - 1) + 1


@pytest.mark.parametrize("factor", [0.5, 0.25, 0.125, 1 / 16, 1 / 32, 1 / 64, 0.6, 1 / 3, 0.3,
                                    0.07, 1 / 2000])
def test_tiling_fits_the_kernel(factor):
    """A tile's staged rows fit its room at every shape, with the indices of
    float32 division (the CPU) and of a product with the float32 reciprocal
    (torch's CUDA division by a scalar)."""
    fs, taps = pyramid_taps(factor)
    assert taps.dtype == np.float32 and len(taps) == 2 * fs <= MAX_TAPS
    rows, cap = tiling(fs, factor)
    assert 1 <= rows <= MAX_ROWS and cap >= 2 * fs
    assert rows == 1 or 4 * PITCH * cap <= SMEM_BYTES
    assert 4 * PITCH * cap <= 48 * 1024                  # no opt-in shared memory
    f = np.float32(factor)
    for n_in in (9, 777, 5424, 21696):
        pos = np.arange(zoom.zoom_size(n_in, factor), dtype=np.float32)
        if len(pos) == 0:
            continue
        for idx in (np.trunc(pos / f), np.trunc(pos * (np.float32(1) / f))):
            idx = np.clip(idx.astype(np.int64), 0, n_in - 1)
            assert (np.diff(idx) >= 0).all()
            assert _tile_spans(idx, rows, fs, n_in).max() <= cap
        assert torch.equal(torch.from_numpy(np.clip(np.trunc(pos / f).astype(np.int64), 0,
                                                    n_in - 1)),
                           zoom.pyramid_index(0, len(pos), n_in, factor))


def _pair(h, w, shift=2.0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    def mk(cx):
        return (200 * np.exp(-(((xx - cx) ** 2 + (yy - h / 2) ** 2) / (2 * (w / 10) ** 2)))
                + 30 + 5 * np.sin(xx / 5.0) * np.cos(yy / 7.0)).astype(np.float32)

    z = np.zeros((h, w), np.float32)
    return [torch.from_numpy(a) for a in (mk(w / 2 - shift / 2), mk(w / 2 + shift / 2), z, z)]


@pytest.mark.parametrize("solver", ["pcg", "sor"])
def test_solve_makes_one_level_call_a_coarse_level(solver):
    cfg = OFConfig(kiters=3, cgiters=10, solver=solver)
    # the banded solve still builds its levels with core.zoom.pyramid_downsample_rows
    assert "pyramid_level" in ops.PATHS[solver]
    assert "pyramid_level" not in ops.PATHS[f"mesh_{solver}"]
    t = _pair(48, 40)
    ops.reset_counters()
    u, v = variational_flow(*t, cfg)
    assert ops.counters()["pyramid_level"] == (0, cfg.kiters - 1)
    ops.reset_counters()
    pu, pv = _coarse_to_fine(t[0][None], t[1][None], t[2], t[3], cfg, plain=True)
    assert ops.counters()["pyramid_level"] == (0, cfg.kiters - 1)
    assert torch.equal(u, pu) and torch.equal(v, pv)
