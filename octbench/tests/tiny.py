"""A cell cut to a size the CPU tests can run: the mesoscale loops at
48 x 48 with either relaxer, two levels, eight relaxer iterations, and
limits set from the readings of that size (flow gaps ~1e-4 px; the
control ~0.2 px); and the same under the hybrid, each pair from a zero
guess (flow gaps ~1e-5 to 7e-3 px; the control ~0.2 px)."""

from octbench import spec

LIMITS = {"ingest_mismatch": 1e-3, "flow_gap_px": 0.02, "flow_gap_p999_px": 0.005,
          "wind_gap": 50.0, "raw_gap": 3.0}


def tiny_cell(solver="pcg", n=48):
    cell = spec.cell("meso-sor-seq")
    cell.traffic["solver"] = solver
    cell.config["rows"] = cell.config["cols"] = n
    cell.config["settings"].update(kiters=2, cgiters=8)
    cell.traffic.update(sequences=1, frames=3, compare_pairs=2, trace_pairs=2)
    cell.limits = dict(LIMITS)
    return cell


def tiny_hybrid_cell(solver="pcg", n=48):
    """``tiny_cell`` under the hybrid (patch-match's flow refined, OCTANE's
    radii), each pair from a zero guess."""
    cell = tiny_cell(solver, n)
    cell.traffic["warm_start"] = False
    cell.config["settings"].update(algorithm="hybrid", rad=2, srad=2)
    return cell
