"""Multi-frame sequences with warm starts and checkpoint/resume (counterpart
of octane_tpu.sequence).

The reference's only sequence mechanism is -firstguess: a previous
product's navigated winds seed the next solve (main.cc:274-278,
oct_optical_flow.cc:52).  ``run_sequence`` makes it a mode of its own:

* consecutive pairs are solved in turn, each warm-started from the previous
  pair's pixel flow through ``compute_flow(..., first_guess=...)`` (the
  flow after SRSAL when SRSAL is on; weighted into the energy by lambdac,
  the reference's hinting term);
* after each pair the flow is checkpointed to HDF5 (the port's codec, ``io.hdf5``),
  so a long job resumes mid-sequence; the checkpoint holds a fingerprint of
  the settings and the frames done, and a resume with other settings or a
  reordered frame list is refused;
* optional temporal interpolation between each pair, each pair's frames in
  their own ``pair_NNN`` directory.

The fingerprint hashes ``repr(cfg)``.  The port's ``OFConfig`` has fewer
fields than octane_tpu's, so a checkpoint resumes only in the package that
wrote it.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional

import numpy as np

from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.flow.dispatcher import compute_flow
from octane_tpu_torch.io import hdf5
from octane_tpu_torch.io.readers import read_scene
from octane_tpu_torch.io.writers import write_product
from octane_tpu_torch.pipeline import SUFFIX, interpolate_sequence


def cfg_key(cfg: OFConfig) -> str:
    """Fingerprint of the settings that must not change across a resume."""
    return hashlib.sha256(repr(cfg).encode()).hexdigest()


def _save_checkpoint(path: str, index: int, u, v, key: str, files_done: List[str]):
    """Pair ``index``'s flow (host float32) and the frames done, written to
    ``path + ".tmp"`` and then moved over ``path``: a kill mid-save keeps
    the previous checkpoint."""
    tmp = path + ".tmp"
    with hdf5.File(tmp, "w") as f:
        f.create_dataset("pair_index", data=np.int64(index))
        f.create_dataset("u_pix", data=_host(u))
        f.create_dataset("v_pix", data=_host(v))
        f.attrs["cfg_key"] = key
        f.attrs["files_done"] = "\n".join(files_done)
    os.replace(tmp, path)


def _host(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def _load_checkpoint(path: str, key: str = None, files: List[str] = None):
    """(pair index, u_pix, v_pix) of the checkpoint at ``path``, or None if
    there is none.  With ``key``, the settings must be those of the run that
    wrote it; with ``files``, its frames must be a prefix of them."""
    if not os.path.exists(path):
        return None
    with hdf5.File(path, "r") as f:
        def _s(a):
            return a.decode() if isinstance(a, bytes) else str(a)

        if key is not None and _s(f.attrs.get("cfg_key", "")) != key:
            raise ValueError(
                "checkpoint was written by a run with different solver settings, "
                "or by the other package (octane_tpu fingerprints its own, larger "
                "OFConfig, so its checkpoints do not resume in octane_tpu_torch "
                "nor these in it); delete it (or rerun with the original settings "
                f"and package) to resume: {path}")
        idx = int(f["pair_index"][()])
        if files is not None:
            done = _s(f.attrs.get("files_done", "")).split("\n")
            if done != list(files[:len(done)]):
                raise ValueError(
                    "checkpoint was written against a different frame list "
                    f"(appending new frames is fine; reordering is not): {path}")
        return idx, np.asarray(f["u_pix"][()]), np.asarray(f["v_pix"][()])


def run_sequence(
    files: List[str],
    cfg: OFConfig,
    outdir: str = "./",
    checkpoint: Optional[str] = None,
    warm_start: bool = True,
    interp_dir: str = "./interpolation",
    device="cuda",
) -> List[str]:
    """Process the consecutive pairs of ``files`` on ``device``; returns the
    products written (``outfile{grid suffix}_{i:03d}.nc``, then the pair's
    interpolated frames).  With ``checkpoint`` set, the flow is saved after
    each pair and a rerun resumes from the first pair not done."""
    if len(files) < 2:
        raise ValueError("a sequence needs at least two frames")
    os.makedirs(outdir, exist_ok=True)
    written: List[str] = []
    start = 0
    u_prev = v_prev = None
    key = cfg_key(cfg)
    if checkpoint:
        state = _load_checkpoint(checkpoint, key, files)
        if state is not None:
            start, u_prev, v_prev = state
            start += 1

    scene1 = read_scene(files[start], cfg, donav=True, device=device)
    for i in range(start, len(files) - 1):
        scene2 = read_scene(files[i + 1], cfg, donav=False, device=device)
        if cfg.grid == "goes":
            scene1.nav.g2x_offset = scene2.nav.x_offset
            scene1.nav.g2y_offset = scene2.nav.y_offset
        # the previous pair's pixel flow seeds the solver (and the hinting
        # term when cfg.lambdac > 0): the reference's first-guess path
        # without the netCDF round trip
        fg = (u_prev, v_prev) if (warm_start and u_prev is not None) else None
        compute_flow(scene1, scene2, cfg, first_guess=fg)

        out = os.path.join(outdir, f"outfile{SUFFIX[cfg.grid]}_{i:03d}.nc")
        written.append(write_product(out, scene1, cfg, interp=False))
        if cfg.do_interp:
            # frame indices restart at 1 every pair, so each pair writes
            # into its own directory
            written += interpolate_sequence(
                scene1, scene2, cfg, os.path.join(interp_dir, f"pair_{i:03d}"))

        u_prev, v_prev = scene1.u_pix, scene1.v_pix
        if checkpoint:
            _save_checkpoint(checkpoint, i, u_prev, v_prev, key, files[:i + 2])
        # roll: frame i+1, navigated, becomes the new reference frame
        scene1 = read_scene(files[i + 1], cfg, donav=True, scene=scene2, device=device)
    return written
