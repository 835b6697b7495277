"""Readings of a cell's comparison for setting its limits, with where the
largest flow gaps lie.

    python3 tools/limit_readings.py --workload <cell> --seeds <n> ...
                                    [--alt control witness] [--program --seconds <s>]

With ``--alt`` (on one card): for each seed the cell's scans made from the
seed, and for each compared pair the plain reference (``reference.REFERENCE``)
once and each alternative in the program's place: ``control``
(``reference.CONTROL``: navigation float32, solve bfloat16) and
``witness`` (the reference with its dot products summed in float32, a
second sound computation).  Their numbers do not depend on the program, so
a cell whose program needs four cards is read on one.  Only cells without
warm starts (each compared pair solved from zero).

With ``--program`` (on the cell's cards): a run of the cell with a window
of ``--seconds`` (``run.run``, as ``octbench.calibrate`` makes it; the
window has to hold the compared pair), the program's numbers against the
cell's committed limits.  At 21696 x 21696 on four cards, one seed a
process: the allocator's reserve after one comparison leaves card 0 short
of memory for the next seed's capture.

Each seed prints one JSON line: the numbers, whether they are within the
limits (``run.within``) and, for u and v, where the gaps lie
(``located``): the largest gap, its pixel, its distance in rows from the
nearest seam of the cell's row bands, its distance from the image centre
in half-widths, whether the sun is down there (a reflective band's
subsolar point), the reference's data of both scans and |v| there; and of
the largest 0.1 % of gaps the share within ``SEAM_ROWS`` rows of a seam
(``near_seam``, beside the share of rows that are) and the share where the
sun is down.  A reflective cell's line also has the dark share of its
earth pixels.  Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEAM_ROWS = 64      # rows either side of a seam counted as near it: 4 x halo_warp


def seams(cell) -> list:
    """The first rows of the cell's row bands after the first."""
    from octane_tpu_torch.parallel.mesh import band_rows

    n = cell.config["settings"].get("mesh_shape", [1, 1])[0]
    h = cell.config["rows"]
    return [r0 for r0, r1 in (band_rows(h, n, i) for i in range(1, n)) if r1 > r0]


def sky(cell, device):
    """(dark, dark share of earth pixels): the pixels where the sun is down
    on the earth, or (None, None) for an emissive band."""
    import torch

    from octbench import grid, traffic

    if not traffic.reflective(cell.config):
        return None, None
    lat, on = grid.earth_latlon(cell.config, device)
    mu0 = traffic.cos_solar_zenith(cell.traffic["reflectance"], lat,
                                   grid.earth_lon(cell.config, device))
    dark = (mu0 <= 0) & on
    share = float(dark.sum()) / float(on.sum())
    del lat, mu0, on
    torch.cuda.empty_cache()
    return dark, share


def locate(got, ref, ref1, ref2, ref_v, rows_at, dark) -> dict:
    """Where the gaps |got - ref| of one flow component lie (see the module
    docstring); ``rows_at`` are the seams' rows."""
    import torch

    d = (got.to(ref.device) - ref).abs()
    h, w = d.shape
    i = int(torch.nan_to_num(d, nan=float("inf")).argmax())
    r, c = divmod(i, w)

    def seam_distance(rows):
        if not rows_at:
            return None
        at = torch.as_tensor(rows_at, device=rows.device)
        return (rows[:, None] - at[None, :]).abs().min(dim=1).values

    top = torch.topk(torch.nan_to_num(d, nan=float("inf")).flatten(),
                     max(1, d.numel() // 1000)).indices
    top_rows = top // w
    near = seam_distance(top_rows)
    all_rows = seam_distance(torch.arange(h, device=d.device))
    out = {"largest": float(d[r, c]), "at": [r, c],
           "seam_rows": None if near is None else int(seam_distance(
               torch.tensor([r], device=d.device))[0]),
           "radius": ((r - h / 2) ** 2 + (c - w / 2) ** 2) ** 0.5 / (h / 2),
           "data": [float(ref1[r, c]), float(ref2[r, c])], "ref_v_px": float(ref_v[r, c].abs()),
           "near_seam": None if near is None else float((near <= SEAM_ROWS).float().mean()),
           "rows_near_seam": None if all_rows is None else
           float((all_rows <= SEAM_ROWS).float().mean())}
    if dark is not None:
        out["dark"] = bool(dark[r, c])
        out["top_dark"] = float(dark.flatten()[top].float().mean())
    return out


def read_alternatives(cell, stream, positions, device, alts, dark, rows_at):
    """{alt: (numbers, located)} of the compared pairs, the reference solved
    once a pair (the loop of ``run.judge`` without warm starts)."""
    import torch

    from octbench import grid, reference, run

    cfg, s = cell.config, cell.config["settings"]
    nav = grid.nav_constants(cfg)
    vmin, vmax = cfg["norm_min"], cfg["norm_max"]
    solver = cell.traffic["solver"]
    gaps = {a: run._Gaps() for a in alts}
    found = {a: [] for a in alts}
    for pos in positions:
        loop, i = stream.pairs[pos]
        c1, c2 = stream.frames[loop][i], stream.frames[loop][i + 1]
        dt = stream.times[loop][i + 1] - stream.times[loop][i]
        d1 = reference.normalised(c1, nav, vmin, vmax, device)
        d2 = reference.normalised(c2, nav, vmin, vmax, device)
        zero = torch.zeros_like(d1)
        u, v, _ = reference.solve(d1[None], d2[None], zero, zero, s, solver,
                                  acc=reference.REFERENCE.accumulate)
        ref_products = reference.winds(u, v, nav, dt)
        for alt in alts:
            prec = reference.CONTROL if alt == "control" else reference.Precision()
            e1 = reference.normalised(c1, nav, vmin, vmax, device, prec)
            e2 = reference.normalised(c2, nav, vmin, vmax, device, prec)
            au, av, _ = reference.solve(e1[None], e2[None], zero, zero, s, solver, prec.solve,
                                        prec.accumulate)
            gaps[alt].add(e1, e2, d1, d2, au, av, u, v, reference.winds(au, av, nav, dt, prec),
                          ref_products)
            found[alt].append({"position": pos,
                               "u": locate(au, u, d1, d2, v, rows_at, dark),
                               "v": locate(av, v, d1, d2, v, rows_at, dark)})
            del e1, e2, au, av
            torch.cuda.empty_cache()
    return {a: (gaps[a].numbers(), found[a]) for a in alts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--alt", nargs="*", default=[], choices=("control", "witness"))
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--seconds", type=float, default=20.0)
    a = ap.parse_args(argv)

    import torch

    from octbench import run, spec, traffic

    if not torch.cuda.is_available():
        print("limit_readings: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cell = spec.cell(a.workload)
    if a.alt and cell.traffic["warm_start"]:
        print("limit_readings: --alt reads cells without warm starts", file=sys.stderr)
        return 2
    rows_at = seams(cell)
    dark, dark_share = sky(cell, dev)
    found = []
    if a.program:               # the program's gaps, located as run.judge meets them
        add = run._Gaps.add

        def add_located(gaps, got1, got2, ref1, ref2, u, v, ru, rv, products, ref_products):
            found.append({"u": locate(u, ru, ref1, ref2, rv, rows_at, dark),
                          "v": locate(v, rv, ref1, ref2, rv, rows_at, dark)})
            add(gaps, got1, got2, ref1, ref2, u, v, ru, rv, products, ref_products)
        run._Gaps.add = add_located
    for seed in a.seeds:
        t0 = time.perf_counter()
        rec = {"seed": seed, "workload": a.workload, "seams": rows_at, "dark_share": dark_share}
        if a.program:
            found.clear()
            out, numbers, _ = run.run(cell, seed, a.seconds, False, "cuda", t_start=t0)
            rec["program"] = {"numbers": numbers, "within_limits": run.within(numbers, cell.limits),
                              "located": list(found), "pairs": out["attempted"],
                              "memory_peak_bytes_per_card":
                                  out["device"].get("memory_peak_bytes_per_card")}
        if a.alt:
            stream = traffic.make_stream(cell.config, cell.traffic, seed, dev)
            got = read_alternatives(cell, stream, run.compared_positions(cell, seed), dev,
                                    a.alt, dark, rows_at)
            for alt, (numbers, located) in got.items():
                numbers["missing_pairs"] = 0.0      # the program's, not the alternative's
                rec[alt] = {"numbers": numbers, "within_limits": run.within(numbers, cell.limits),
                            "located": located}
            del stream
        rec["seconds"] = time.perf_counter() - t0
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": a.workload, "limits": cell.limits,
                      "device": torch.cuda.get_device_name(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
