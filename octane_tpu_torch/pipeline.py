"""End-to-end pair pipeline: ingest -> flow -> navigation -> product
(counterpart of octane_tpu.pipeline.run_pipeline; src/main.cc:398-480).

Ported: one GOES channel-1 pair on one device, with the cloud-top height
(CTP product, SRSAL smoothing) and the first-guess winds.  Extra channels
and temporal interpolation raise NotImplementedError.
"""

from __future__ import annotations

import os
from typing import List, Optional

from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.flow.dispatcher import compute_flow
from octane_tpu_torch.io.readers import read_cth, read_first_guess, read_scene
from octane_tpu_torch.io.writers import write_product


def run_pipeline(
    file1: str,
    file2: str,
    cfg: OFConfig,
    outdir: str = "./",
    cth_file: Optional[str] = None,
    firstguess_file: Optional[str] = None,
    channel2: Optional[tuple] = None,
    channel3: Optional[tuple] = None,
    device="cuda",
) -> List[str]:
    """Run the pair pipeline on ``device``; returns the list of files written."""
    for name, val in (("channel 2", channel2), ("channel 3", channel3)):
        if val is not None:
            raise NotImplementedError(f"{name} input is not ported yet")
    if cfg.do_interp:
        raise NotImplementedError("temporal interpolation is not ported yet")
    os.makedirs(outdir, exist_ok=True)
    scene1 = read_scene(file1, cfg, donav=True, device=device)
    scene2 = read_scene(file2, cfg, donav=False, device=device)
    scene1.nav.g2x_offset = scene2.nav.x_offset
    scene1.nav.g2y_offset = scene2.nav.y_offset
    # a CTH file turns CTH on even under -ahi, as in octane_tpu
    if cth_file is not None:
        cfg = cfg.replace(do_cth=True)
        read_cth(cth_file, scene1, cfg)
    if firstguess_file is not None:
        cfg = cfg.replace(do_firstguess=True)
        read_first_guess(firstguess_file, scene1)
    cfg = cfg.replace(nchannels=scene1.nchannels)

    compute_flow(scene1, scene2, cfg)

    outname = os.path.join(outdir, "outfile.nc")
    return [write_product(outname, scene1, cfg)]
