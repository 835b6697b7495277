"""Roofline shares of the relaxers and the least time of patch-match's
search, from the frozen counts of ``rooflines.json``: the least time the
card could take for the algorithm's work (the larger of its bytes over
the HBM rate and its float32 operations over the FP32 rate, summed over
the rounds) over the device time of the kernels that a metric names.  The work is counted from the
configuration's level shapes and the program's counters, never from the
kernels' design."""

from __future__ import annotations

import math
import os

import numpy as np

from octbench.spec import HERE, load_json


def counts() -> dict:
    return load_json(os.path.join(HERE, "rooflines.json"))


def level_shapes(settings: dict, rows: int, cols: int):
    """(rows, cols) of each pyramid level, coarsest first (the program's
    rule: factor = float32(scale)^(kiters - k - 1), size int(n f + 0.5))."""
    out = []
    for k in range(settings["kiters"]):
        f = float(np.float32(settings["scale_factor"]) ** (settings["kiters"] - k - 1))
        out.append((int(rows * f + 0.5), int(cols * f + 0.5)))
    return out


def rounds(settings: dict, rows: int, cols: int):
    """(pixels, quadratic?) of every GNC round of one pair, in order."""
    return [(h * w, step == 0) for h, w in level_shapes(settings, rows, cols)
            for step in range(settings["gnc_steps"]) for _ in range(settings["liters"])]


def _bound(nbytes: float, flops: float, peaks: dict) -> float:
    return max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks["fp32_flops_per_s"])


def pcg_bound_s(settings, rows, cols, pairs: int, iterations: int, c=None) -> float:
    """Least seconds for ``iterations`` PCG iterations over ``pairs`` pairs."""
    c = c or counts()
    spec, rs = c["pcg"], rounds(settings, rows, cols)
    per_round = iterations / (pairs * len(rs))      # = cgiters where every round ran all
    kind = {True: "quadratic", False: "robust"}
    return pairs * sum(per_round * _bound(px * spec["bytes_per_pixel"][kind[q]],
                                          px * spec["flops_per_pixel"][kind[q]], c["peaks"])
                       for px, q in rs)


def sor_bound_s(settings, rows, cols, pairs: int, passes: int, c=None) -> float:
    """Least seconds for ``passes`` SOR passes over ``pairs`` pairs."""
    c = c or counts()
    spec, rs = c["sor"], rounds(settings, rows, cols)
    full = math.ceil(settings["cgiters"] / spec["pass_sweeps"])   # passes of a full round
    sweeps = settings["cgiters"] * (passes / (pairs * len(rs) * full))
    kind = {True: "quadratic", False: "robust"}
    return pairs * sum(_bound(px * spec["bytes_per_pixel"][kind[q]],
                              px * (sweeps * spec["flops_per_pixel_per_sweep"][kind[q]]
                                    + spec["flops_per_pixel_per_round"]), c["peaks"])
                       for px, q in rs)


def patch_match_bound_s(settings: dict, rows: int, cols: int, pairs: int, c=None) -> float:
    """Least seconds for the zero-guess patch-match of ``pairs`` pairs at
    the full image, with the settings' radii (OCTANE's 2 and 2 by default)."""
    c = c or counts()
    spec = c["patch_match"]
    taps = (2 * settings.get("rad", 2) + 1) ** 2
    offsets = (2 * settings.get("srad", 2) + 1) ** 2
    f = spec["flops_per_pixel"]
    flops = (offsets * (f["per_offset"] + (taps - 1) * f["per_offset_per_tap_after_the_first"])
             + (offsets - 1) * f["per_offset_after_the_first"] + f["fit"])
    px = rows * cols
    return pairs * _bound(px * spec["bytes_per_pixel"], px * flops, c["peaks"])


def bands(settings: dict) -> int:
    """The row bands of the configuration's mesh (``mesh_shape``, rows x
    cols; 1 without one)."""
    ry, rx = settings.get("mesh_shape", (1, 1))
    return ry * rx


def work(settings: dict, counters: dict, layer: str):
    """The relaxer's iterations (PCG) or passes (SOR) in ``counters``
    ({wrapper: launches}): the whole-image kernel's launches plus the band
    form's over the number of bands, each band launching it once an
    iteration or pass."""
    c = counts()[layer]
    return counters.get(c["counter"], 0) + counters.get(c["band_counter"], 0) / bands(settings)


def share(run, layer: str, kernels) -> float:
    """Percent of the bound that the named kernels reach over the profiled
    slice, summed over the cards, or None where they did not run."""
    from octbench import trace

    kernel_s = trace.kernel_us(run.trace, kernels) / 1e6
    n = work(run.config["settings"], run.slice_counters, layer)
    if kernel_s <= 0 or n <= 0:
        return None
    s = run.config["settings"]
    fn = pcg_bound_s if layer == "pcg" else sor_bound_s
    return 100.0 * fn(s, run.config["rows"], run.config["cols"], run.slice_pairs, n) / kernel_s
