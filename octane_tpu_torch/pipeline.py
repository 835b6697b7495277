"""End-to-end pair pipeline: ingest -> flow -> navigation -> product ->
interpolated frames (counterpart of octane_tpu.pipeline; src/main.cc:398-480).

Ported: one pair on one device, on the GOES fixed grid with channels 2
and 3 (``channel2``/``channel3``, regridded onto channel 1) or on a polar
or mercator grid, with the cloud-top height (CTP product, SRSAL
smoothing), the first-guess winds and the temporally interpolated frames
(``-interp``).  Products are named with the grid's suffix, as octane_tpu
names them (oct_filewrite.cc:707-715).  Under a device mesh (``-mesh``)
the frames run on its row bands (``parallel.post.sharded_interpolate_frame``).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.flow.dispatcher import active_mesh, compute_flow
from octane_tpu_torch.io.datamodel import Scene
from octane_tpu_torch.io.native import requantize
from octane_tpu_torch.io.readers import read_cth, read_first_guess, read_scene
from octane_tpu_torch.io.writers import write_product
from octane_tpu_torch.post.temporal import interpolate_frame

SUFFIX = {"goes": "", "polar": "_polar", "mercator": "_merc"}


def run_pipeline(
    file1: str,
    file2: str,
    cfg: OFConfig,
    outdir: str = "./",
    cth_file: Optional[str] = None,
    firstguess_file: Optional[str] = None,
    channel2: Optional[tuple] = None,
    channel3: Optional[tuple] = None,
    interp_dir: str = "./interpolation",
    device="cuda",
) -> List[str]:
    """Run the pair pipeline on ``device``; returns the list of files
    written.  ``channel2``/``channel3`` are (file for image 1, file for
    image 2) pairs of GOES files."""
    os.makedirs(outdir, exist_ok=True)
    scene1 = read_scene(file1, cfg, donav=True, device=device)
    scene2 = read_scene(file2, cfg, donav=False, device=device)
    if cfg.grid == "goes":
        scene1.nav.g2x_offset = scene2.nav.x_offset
        scene1.nav.g2y_offset = scene2.nav.y_offset
    # a CTH file turns CTH on even under -ahi, as in octane_tpu
    if cth_file is not None:
        cfg = cfg.replace(do_cth=True)
        read_cth(cth_file, scene1, cfg)
    if firstguess_file is not None:
        cfg = cfg.replace(do_firstguess=True)
        read_first_guess(firstguess_file, scene1)
    for channel, files in ((2, channel2), (3, channel3)):
        if files is not None:
            read_scene(files[0], cfg, donav=False, channel=channel, scene=scene1, device=device)
            read_scene(files[1], cfg, donav=False, channel=channel, scene=scene2, device=device)
    cfg = cfg.replace(nchannels=scene1.nchannels)

    compute_flow(scene1, scene2, cfg)

    outname = os.path.join(outdir, f"outfile{SUFFIX[cfg.grid]}.nc")
    written = [write_product(outname, scene1, cfg)]
    if cfg.do_interp:
        written += interpolate_sequence(scene1, scene2, cfg, interp_dir)
    return written


def interpolate_sequence(scene1: Scene, scene2: Scene, cfg: OFConfig,
                         interp_dir: str) -> List[str]:
    """Write interpolated frames between the pair (main.cc:450-480 loop:
    frames every ``deltat`` seconds while frt < 1), each requantized to
    radiance counts on the host into the type of ``scene1.raw_counts``
    (int16 counts on GOES, float32 on flat grids)."""
    os.makedirs(interp_dir, exist_ok=True)
    written = []
    step = cfg.deltat / scene1.dt
    frt = step
    idx = 1
    counts_dtype = torch.empty(0, dtype=scene1.raw_counts.dtype).numpy().dtype
    mesh = active_mesh(cfg, scene1.data.device)
    if mesh is not None:
        from octane_tpu_torch.parallel.post import sharded_interpolate_frame
        # the splat's halo from the flow, rounded up as octane_tpu rounds it
        md = float(max(scene1.u_pix.abs().max(), scene1.v_pix.abs().max()))
        max_disp = max(8, int(-(-md // 8) * 8))
    while frt < 1.0 and (1.0 - frt) >= step / 2.0:
        if mesh is not None:
            img, occ = sharded_interpolate_frame(scene1.u_pix, scene1.v_pix, scene1.data,
                                                 scene2.data, frt, mesh, max_disp=max_disp)
        else:
            img, occ = interpolate_frame(scene1.u_pix, scene1.v_pix, scene1.data,
                                         scene2.data, frt)
        img = img.cpu().numpy()
        # normalized 0-255 image back to radiance counts (oct_interp.cc:424-457)
        counts = np.empty(img.shape, counts_dtype)
        for c in range(img.shape[0]):
            vmin, vmax = scene1.norm_ranges[c]
            counts[c] = requantize(img[c], vmin, vmax, scene1.nav.rad_scale[c],
                                   scene1.nav.rad_offset[c])
        scene1.occlusion = occ
        scene1.frdt = float(frt)
        scene1.t_interp = scene1.t + scene1.dt * frt
        saved = scene1.raw_counts
        scene1.raw_counts = counts
        path = os.path.join(interp_dir, f"outfile_interp{SUFFIX[cfg.grid]}{idx}.nc")
        written.append(write_product(path, scene1, cfg, interp=True))
        scene1.raw_counts = saved
        idx += 1
        frt += step
    return written
