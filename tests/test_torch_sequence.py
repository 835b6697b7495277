"""sequence.run_sequence in the port on the CPU, against octane_tpu's, on the
4 frames of 40^2 of tests/test_sequence.py (a blob moving +2 px in x every
600 s):

* the products against octane_tpu's run_sequence: the same files, the
  shorts within 1 count, every other variable and attribute equal; the
  checkpoint's pair index and flow (within 1e-4 px of octane_tpu's);
* warm starts seed each pair with the previous pair's flow
  (``compute_flow(..., first_guess=...)``), and the warm-started flow
  stays near the cold-started one;
* a resume skips the pairs already done; a job killed after two pairs and
  resumed, interpolated frames included, writes what an uninterrupted run
  writes; a resume with other settings, with reordered frames, or from a
  checkpoint octane_tpu wrote is refused, the last with the message that
  says why;
* a polar sequence names its products with the grid's suffix.
"""

import dataclasses
import os

import h5py
import numpy as np
import pytest
import torch

from octane_tpu.config import OFConfig as JaxOFConfig
from octane_tpu.sequence import _load_checkpoint as jax_load_checkpoint
from octane_tpu.sequence import run_sequence as jax_run_sequence
from octane_tpu_torch import sequence
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.sequence import _load_checkpoint, run_sequence
from tests import synth

torch.set_num_threads(2)


def _jax_cfg(cfg):
    return JaxOFConfig(**dataclasses.asdict(cfg))


@pytest.fixture
def frames(tmp_path):
    """tests/test_sequence.py's frames."""
    h = w = 40
    files = []
    for i in range(4):
        c = synth.blob_counts(h, w, 16 + 2 * i, 20)
        files.append(synth.make_goes_file(
            str(tmp_path / f"f{i}.nc"), c, t=650000000.0 + 600.0 * i))
    return files, (h, w)


def _vars(path):
    out = {}
    with h5py.File(path) as f:
        def visit(name, obj):
            attrs = {k: (v.decode() if isinstance(v, bytes) else v)
                     for k, v in obj.attrs.items()
                     if k not in ("DIMENSION_LIST", "REFERENCE_LIST")}
            out[name] = (np.asarray(obj[()]), attrs)
        f.visititems(visit)
    return out


def _same_products(pa, pb, shorts_within=1):
    a, b = _vars(pa), _vars(pb)
    assert a.keys() == b.keys()
    for name in a:
        (va, aa), (vb, ab) = a[name], b[name]
        assert va.dtype == vb.dtype and va.shape == vb.shape, name
        if name in ("U", "V", "U_raw", "V_raw"):
            d = np.abs(va.astype(np.int32) - vb.astype(np.int32))
            assert d.max() <= shorts_within, f"{name}: max short diff {d.max()}"
        else:
            np.testing.assert_array_equal(va, vb, err_msg=name)
        assert aa.keys() == ab.keys(), name
        for k in aa:
            np.testing.assert_array_equal(aa[k], ab[k], err_msg=f"{name}.{k}")


@pytest.mark.parametrize("solver", ["pcg", "sor"])
def test_sequence_products_match_jax(frames, tmp_path, solver):
    files, (h, w) = frames
    cfg = OFConfig(kiters=2, cgiters=10, solver=solver)
    out = run_sequence(files, cfg, outdir=str(tmp_path / "port"),
                       checkpoint=str(tmp_path / "port.h5"), device="cpu")
    jax = jax_run_sequence(files, _jax_cfg(cfg), outdir=str(tmp_path / "jax"),
                           checkpoint=str(tmp_path / "jax.h5"))
    assert [os.path.basename(p) for p in out] == [os.path.basename(p) for p in jax] == [
        f"outfile_{i:03d}.nc" for i in range(3)]
    for pp, pj in zip(out, jax):
        _same_products(pj, pp)
        with h5py.File(pp) as f:
            assert (np.abs(f["U_raw"][()] * 0.01) > 0.5).any()   # each pair moved +2 px
    idx, u, v = _load_checkpoint(str(tmp_path / "port.h5"))
    jidx, ju, jv = jax_load_checkpoint(str(tmp_path / "jax.h5"))
    assert idx == jidx == 2 and u.shape == (h, w) and u.dtype == np.float32
    np.testing.assert_allclose(u, ju, rtol=0, atol=1e-4)
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-4)


def test_warm_start_seeds_the_next_pair(frames, tmp_path, monkeypatch):
    """Pair i + 1 starts from pair i's flow; with warm_start=False from zero.
    The warm-started flow stays near the cold-started one
    (test_sequence.py::test_warm_start_consistency)."""
    files, _ = frames
    seeds = []
    real = sequence.compute_flow

    def spy(scene1, scene2, cfg, first_guess=None):
        seeds.append(None if first_guess is None else first_guess[0])
        out = real(scene1, scene2, cfg, first_guess=first_guess)
        seeds.append(out.u_pix)
        return out
    monkeypatch.setattr(sequence, "compute_flow", spy)
    cfg = OFConfig(kiters=2, cgiters=10)
    warm = run_sequence(files[:3], cfg, outdir=str(tmp_path / "w"), device="cpu")
    assert seeds[0] is None and seeds[2] is seeds[1]
    seeds.clear()
    cold = run_sequence(files[:3], cfg, outdir=str(tmp_path / "c"), warm_start=False,
                        device="cpu")
    assert seeds[0] is None and seeds[2] is None
    with h5py.File(warm[1]) as fw, h5py.File(cold[1]) as fc:
        uw, uc = fw["U_raw"][()] * 0.01, fc["U_raw"][()] * 0.01
    assert np.abs(np.median(uw) - np.median(uc)) < 0.5


def test_resume_skips_done_pairs(frames, tmp_path):
    files, _ = frames
    cfg = OFConfig(kiters=2, cgiters=10)
    ck = str(tmp_path / "ckpt.h5")
    run_sequence(files[:3], cfg, outdir=str(tmp_path / "seq"), checkpoint=ck, device="cpu")
    out = run_sequence(files, cfg, outdir=str(tmp_path / "seq"), checkpoint=ck, device="cpu")
    assert len(out) == 1 and out[0].endswith("_002.nc")
    assert not os.path.exists(ck + ".tmp")


def test_killed_and_resumed_with_interp(frames, tmp_path):
    """A job killed after two pairs resumes to the products of an
    uninterrupted run, the interpolated frames included."""
    files, _ = frames
    cfg = OFConfig(kiters=2, cgiters=10, do_interp=True, deltat=200.0)
    ref_dir = str(tmp_path / "ref")
    ref = run_sequence(files, cfg, outdir=ref_dir, interp_dir=str(tmp_path / "ref_interp"),
                       device="cpu")
    assert len(ref) == 3 * 3       # per pair the product and frames at 1/3, 2/3
    ck = str(tmp_path / "ckpt.h5")
    part_dir = str(tmp_path / "part")
    run_sequence(files[:3], cfg, outdir=part_dir, checkpoint=ck,
                 interp_dir=str(tmp_path / "part_interp"), device="cpu")
    out = run_sequence(files, cfg, outdir=part_dir, checkpoint=ck,
                       interp_dir=str(tmp_path / "part_interp"), device="cpu")
    assert all("_002" in p or "pair_002" in p for p in out) and len(out) == 3
    for rp in ref:
        pp = rp.replace(ref_dir, part_dir).replace("ref_interp", "part_interp")
        assert os.path.exists(pp), pp
        _same_products(rp, pp, shorts_within=0)


def test_resume_refuses_changed_settings(frames, tmp_path):
    files, _ = frames
    ck = str(tmp_path / "ckpt.h5")
    run_sequence(files[:3], OFConfig(kiters=2, cgiters=10), outdir=str(tmp_path / "a"),
                 checkpoint=ck, device="cpu")
    with pytest.raises(ValueError, match="different solver settings"):
        run_sequence(files, OFConfig(kiters=2, cgiters=12), outdir=str(tmp_path / "a"),
                     checkpoint=ck, device="cpu")


def test_resume_refuses_reordered_frames(frames, tmp_path):
    files, _ = frames
    cfg = OFConfig(kiters=2, cgiters=10)
    ck = str(tmp_path / "ckpt.h5")
    run_sequence(files[:3], cfg, outdir=str(tmp_path / "a"), checkpoint=ck, device="cpu")
    reordered = [files[1], files[0]] + files[2:]
    with pytest.raises(ValueError, match="different frame list"):
        run_sequence(reordered, cfg, outdir=str(tmp_path / "a"), checkpoint=ck, device="cpu")


def test_resume_refuses_a_jax_checkpoint(frames, tmp_path):
    """The fingerprint hashes repr(cfg), and octane_tpu's OFConfig has more
    fields: a checkpoint it wrote does not resume in the port, and the
    error says that the other package wrote it."""
    files, _ = frames
    cfg = OFConfig(kiters=2, cgiters=10)
    ck = str(tmp_path / "ckpt.h5")
    jax_run_sequence(files[:3], _jax_cfg(cfg), outdir=str(tmp_path / "a"), checkpoint=ck)
    with pytest.raises(ValueError, match="octane_tpu fingerprints its own"):
        run_sequence(files, cfg, outdir=str(tmp_path / "a"), checkpoint=ck, device="cpu")


def test_sequence_needs_two_frames(frames):
    with pytest.raises(ValueError, match="two frames"):
        run_sequence(frames[0][:1], OFConfig(), device="cpu")


def test_polar_sequence_names(tmp_path):
    yy, xx = np.mgrid[0:40, 0:40].astype(np.float32)
    files = [synth.make_flat_grid_file(
        str(tmp_path / f"p{i}.nc"),
        200 * np.exp(-(((xx - 16 - 2 * i) ** 2 + (yy - 20) ** 2) / 32.0)) + 20,
        grid="polar", lat1=60.0, t=600.0 * i) for i in range(3)]
    cfg = OFConfig(grid="polar", kiters=2, cgiters=10)
    out = run_sequence(files, cfg, outdir=str(tmp_path / "seq"), device="cpu")
    jax = jax_run_sequence(files, _jax_cfg(cfg), outdir=str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in out] == [os.path.basename(p) for p in jax] == [
        "outfile_polar_000.nc", "outfile_polar_001.nc"]
    for pp, pj in zip(out, jax):
        with h5py.File(pp) as fp, h5py.File(pj) as fj:
            np.testing.assert_allclose(fp["U"][()], fj["U"][()], rtol=0, atol=1e-3)
