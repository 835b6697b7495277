"""octane_tpu_torch.flow.patch_match against octane_tpu.flow.patch_match and
the serial oracle ``reference_impl.patch_match`` on the CPU.

* the spiral offset table equal to octane_tpu's for srad 1-3;
* the zero-guess slice path, the first-guess gather path (rad 1 and 2) and
  the factored full-disk form (``FIRST_GUESS_MAX_PIXELS`` set low in both
  packages for the test): whole-pixel offsets equal to octane_tpu's at
  every pixel and u, v within 1e-4 px of them (the packages sum in the
  same order; XLA may contract a multiply-add, eager PyTorch does not), and
  within 2e-3 px of the oracle (tests/test_patch_match.py's tolerance);
* the zero-guess fast path equal to the zero-first-guess gather path bit
  for bit; an integer translation recovered; the first-guess guard's
  ValueError;
* the search's wrapper (ops.patch_match): what it refuses, its count on
  the CPU route, and the two cost forms that the kernel repeats equal at
  the radii of its instances and beyond them; the zero-guess search at
  radii beyond the instances' against octane_tpu, whole and on bands.
Inputs are noisy images made with numpy from a seed, so no two offsets tie.
"""

import numpy as np
import pytest
import torch

import reference_impl as ref
from octane_tpu.flow import patch_match as jpm
from octane_tpu_torch import ops
from octane_tpu_torch.flow import patch_match as tpm
from octane_tpu_torch.ops import patch_match as kpm

torch.set_num_threads(2)


def _pair(seed, h, w, shift):
    rng = np.random.default_rng(seed)
    im1 = rng.normal(100, 25, (h, w)).astype(np.float32)
    im2 = (np.roll(im1, shift, axis=(0, 1))
           + rng.normal(0, 0.5, (h, w))).astype(np.float32)
    return im1, im2


def _port(*args, **kw):
    u, v = tpm.patch_match_flow(*args, device="cpu", **kw)
    assert u.dtype == v.dtype == torch.float32 and u.device.type == "cpu"
    return u.numpy(), v.numpy()


def _check_against_jax(got, want):
    for g, j in zip(got, want):
        j = np.asarray(j)
        # the refined offset lies within half a pixel of the whole-pixel winner
        np.testing.assert_array_equal(np.rint(g), np.rint(j))
        np.testing.assert_allclose(g, j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("srad", [1, 2, 3])
def test_spiral_offsets_match_jax(srad):
    got = tpm.spiral_offsets(srad)
    assert got.dtype == np.int32 and got.shape == ((2 * srad + 1) ** 2, 2)
    np.testing.assert_array_equal(got, jpm.spiral_offsets(srad))


@pytest.mark.parametrize("rad", [1, 2])
def test_zero_guess_matches_jax_and_oracle(rad):
    im1, im2 = _pair(5, 14, 16, (0, 1))
    got = _port(im1, im2, None, None, rad=rad, srad=2)
    _check_against_jax(got, jpm.patch_match_flow(im1, im2, None, None, rad=rad, srad=2))
    z = np.zeros_like(im1)
    want = ref.patch_match(im1, im2, z, z, rad=rad, srad=2)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-3)


@pytest.mark.parametrize("rad", [1, 2])
def test_first_guess_matches_jax_and_oracle(rad):
    im1, im2 = _pair(7, 12, 12, (1, 2))
    u0 = np.full(im1.shape, 1.4, np.float32)
    v0 = np.full(im1.shape, 0.6, np.float32)
    got = _port(im1, im2, torch.from_numpy(u0), torch.from_numpy(v0), rad=rad, srad=2)
    _check_against_jax(got, jpm.patch_match_flow(im1, im2, u0, v0, rad=rad, srad=2))
    want = ref.patch_match(im1, im2, u0, v0, rad=rad, srad=2)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-3)


@pytest.mark.parametrize("shape,srad", [((40, 36), 2), ((33, 47), 1)])
def test_factored_form_matches_jax(monkeypatch, shape, srad):
    """Above the guard the zero-guess path sums windows of one e^2 plane
    and selects its probes from the 7^2 - 4 offsets around the spiral."""
    monkeypatch.setattr(jpm, "FIRST_GUESS_MAX_PIXELS", 100)
    monkeypatch.setattr(tpm, "FIRST_GUESS_MAX_PIXELS", 100)
    im1, im2 = _pair(3, *shape, (1, -1))
    got = _port(im1, im2, None, None, rad=2, srad=srad)
    _check_against_jax(got, jpm.patch_match_flow(im1, im2, None, None, rad=2, srad=srad))
    if srad == 2:
        z = np.zeros_like(im1)
        for g, r in zip(got, ref.patch_match(im1, im2, z, z, rad=2, srad=2)):
            np.testing.assert_allclose(g, r, rtol=0, atol=2e-3)


def test_fast_path_matches_gather_path():
    """u0=None (slices) equals u0=zeros (gathers) bit for bit."""
    im1, im2 = _pair(11, 18, 22, (1, -1))
    z = torch.zeros(im1.shape)
    want = _port(im1, im2, z, z, rad=2, srad=2)
    got = _port(im1, im2, None, None, rad=2, srad=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_integer_translation_recovered():
    rng = np.random.default_rng(9)
    im1 = rng.normal(100, 25, (32, 32)).astype(np.float32)
    im2 = np.roll(im1, (0, 2), axis=(0, 1))
    u, v = _port(torch.from_numpy(im1), torch.from_numpy(im2), None, None)
    interior = u[6:-6, 6:-6]
    assert abs(np.median(interior) - 2.0) < 0.2
    assert abs(interior.mean() - 2.0) < 0.2
    assert abs(np.median(v[6:-6, 6:-6])) < 0.2


def test_first_guess_scale_guard():
    h = 4096
    w = tpm.FIRST_GUESS_MAX_PIXELS // h + 1
    g = torch.zeros((h, w))
    with pytest.raises(ValueError, match="sector-scale only"):
        tpm.patch_match_flow(g, g, g, g)


# ---------------------------------------------------------------------------
# ops.patch_match: the zero-guess search's wrapper (csrc/patch_match.cu on the
# card, _patch_match_local here)
# ---------------------------------------------------------------------------

def _padded(im1, im2, rad, srad):
    g1, g2 = torch.from_numpy(im1), torch.from_numpy(im2)
    return tpm._edge_pad(g1, rad), tpm._edge_pad(g2, rad + srad + 1)


def test_search_refuses_what_the_kernel_does_not_take():
    im1, im2 = _pair(13, 12, 14, (0, 1))
    h, w = im1.shape
    g1p, g2p = _padded(im1, im2, 2, 2)
    bad = [((g1p.double(), g2p, 2, 2, h, w), "float64"),
           ((g1p, g2p.t().contiguous().t(), 2, 2, h, w), "not contiguous"),
           ((g1p[0], g2p, 2, 2, h, w), "2-D"),
           ((g1p, g2p.to("meta"), 2, 2, h, w), "g2p on meta"),
           ((g1p.to("meta"), g2p.to("meta"), 2, 2, h, w), "unsupported device"),
           ((g1p, _padded(im1, im2, 2, 1)[1], 2, 2, h, w), "padded by 2 and 5"),
           ((g1p, g2p, 2, 2, h, w + 1), "are not rows"),
           ((g1p, g2p, 2, 2, h, w, 1), "are not rows"),        # rows past the image
           ((g1p[:4], g2p, 2, 2, h, w), "are not rows"),       # no row of its own
           ((g1p, g2p, -1, 2, h, w), "negative"),
           ((g1p, g2p, 2, -1, h, w), "negative")]
    ops.reset_counters()
    for args, what in bad:
        with pytest.raises(ValueError, match=what):
            kpm.patch_match_search(*args)
    assert ops.counters()["patch_match"] == (0, 0)


def test_cpu_route_counts_a_plain_search_and_no_launch():
    """The wrapper runs the plain version here and counts it, once a call."""
    im1, im2 = _pair(17, 20, 18, (1, 0))
    g1p, g2p = _padded(im1, im2, 1, 2)
    ops.reset_counters()
    got = kpm.patch_match_search(g1p, g2p, 1, 2, *im1.shape)
    want = tpm._patch_match_local(g1p, g2p, 1, 2, *im1.shape)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.counters()["patch_match"] == (0, 1)
    flow = tpm.patch_match_flow(im1, im2, rad=1, srad=2, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(flow, want))
    assert ops.counters()["patch_match"] == (0, 2)


# the kernel's instances (csrc/patch_match.cu), then radii that its any-radius
# kernel takes
RADII = [(1, 1), (1, 2), (1, 3), (2, 1), (2, 2), (2, 3), (3, 4), (1, 5), (4, 1)]


@pytest.mark.parametrize("rad,srad", RADII)
def test_both_cost_forms_agree_at_every_radius(monkeypatch, rad, srad):
    """The kernel repeats one arithmetic at every size: the sector form
    (per-tap sums, gather probes) and the full-disk form (windows of e^2,
    selected probes) give the same bits at each radius."""
    im1, im2 = _pair(19, 23, 29, (2, -3))
    g1p, g2p = _padded(im1, im2, rad, srad)
    sector = tpm._patch_match_local(g1p, g2p, rad, srad, *im1.shape)
    monkeypatch.setattr(tpm, "FIRST_GUESS_MAX_PIXELS", 10)
    full = tpm._patch_match_local(g1p, g2p, rad, srad, *im1.shape)
    assert all(torch.equal(a, b) for a, b in zip(sector, full))


@pytest.mark.parametrize("form", ["sector", "factored"])
@pytest.mark.parametrize("rad,srad", [(3, 4), (1, 5), (4, 1)])
def test_zero_guess_beyond_the_instances_matches_jax(monkeypatch, form, rad, srad):
    """Radii that OFConfig takes and no instance is built for search as the
    JAX package does, in both cost forms."""
    if form == "factored":
        monkeypatch.setattr(jpm, "FIRST_GUESS_MAX_PIXELS", 100)
        monkeypatch.setattr(tpm, "FIRST_GUESS_MAX_PIXELS", 100)
    im1, im2 = _pair(23, 26, 31, (3, -4))
    got = _port(im1, im2, None, None, rad=rad, srad=srad)
    _check_against_jax(got, jpm.patch_match_flow(im1, im2, None, None, rad=rad, srad=srad))


def test_banded_search_beyond_the_instances():
    """At rad 3, srad 4 on four CPU bands: the whole image's flow, bit for
    bit, counted as one plain search."""
    from octane_tpu_torch.parallel.mesh import make_mesh

    im1, im2 = _pair(29, 37, 22, (-2, 3))
    want = _port(im1, im2, None, None, rad=3, srad=4)
    ops.reset_counters()
    got = tpm.patch_match_flow_sharded(im1, im2, make_mesh((4, 1), [torch.device("cpu")] * 4),
                                       rad=3, srad=4)
    assert ops.counters()["patch_match"] == (0, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
