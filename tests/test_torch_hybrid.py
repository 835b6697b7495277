"""The hybrid full disk (patch-match's start refined by the variational
PCG solve), the benchmark's configuration ``goes-fd-b13-hybrid`` and cell
``fd-hybrid-pcg``, at CPU sizes: the port's ``compute_flow`` on a seeded
``fd-stream-pcg`` stream of that configuration against octbench's plain
reference (``reference.patch_match`` and ``reference.solve`` from its
flow), tight enough that the reference's control (navigation float32,
solve bfloat16) fails; patch-match's winners in both of its cost forms
against the reference's; the profiler range ``octane.patch_match`` and
the counter ``ops.counters()["patch_match"]``; and the cell's two
patch-match readers."""

import types

import pytest
import torch

from octane_tpu_torch import ops
from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.flow import patch_match as pm
from octane_tpu_torch.flow.dispatcher import compute_flow
from octane_tpu_torch.io.datamodel import NavConstants
from octane_tpu_torch.io.readers import scene_from_goes_arrays, set_goes_grid
from octane_tpu_torch.parallel.mesh import make_mesh
from octane_tpu_torch.utils import profiling

# by its module name (pytest puts tests/ on the path): an installed package
# named ``tests`` would shadow ``tests.torch_fixtures``
from torch_fixtures import FIXTURE_T0, fixture_counts, goes_arrays

from octbench import grid, reference, roofline, spec, trace, traffic

CONFIG = f"{spec.HERE}/configs/goes-fd-b13-hybrid.json"
RAD = SRAD = 2


def _hybrid_stream(seed: int, n: int = 128):
    """The goes-fd-b13-hybrid deployment at n x n under fd-stream-pcg: its
    grid and pixels scaled by 5424 / n, so the disk is the same, and a
    cadence at which the traffic's 60 m/s is 6 px."""
    cfg = spec.load_json(CONFIG)
    k = cfg["rows"] / n
    cfg.update(rows=n, cols=n, x_scale=cfg["x_scale"] * k, y_scale=cfg["y_scale"] * k,
               pixel_km=cfg["pixel_km"] * k, cadence_s=6.0 * cfg["pixel_km"] * k * 1e3 / 60.0)
    return cfg, traffic.make_stream(cfg, spec.traffic("fd-stream-pcg"), seed, "cpu")


def _pair(st):
    """The counts and times of the stream's first pair."""
    loop, i = st.pairs[0]
    return (st.frames[loop][i], st.frames[loop][i + 1], st.times[loop][i],
            st.times[loop][i + 1])


def _normalised(cfg, st, prec=reference.REFERENCE):
    c1, c2, _, _ = _pair(st)
    nav = grid.nav_constants(cfg)
    return tuple(reference.normalised(c, nav, cfg["norm_min"], cfg["norm_max"], "cpu", prec)
                 for c in (c1, c2))


# ---------------------------------------------------------------------------
# the port against the reference, end to end
# ---------------------------------------------------------------------------

# The tolerances, from the readings of seeds 2**33 + 30 and + 31 at 128 x 128
# (program: flow 2.7e-3 / 1.4e-4 px, its 99.9th percentile 8.7e-4 / 4.5e-5 px,
# winds 3 / 1 and shorts of pixels 1 / 1 counts; the reference with float32
# dots, a second sound computation: 1.8e-3 / 7.4e-4 px; control: 0.91 / 0.68
# px, 0.85 / 0.37 px, 1378 / 712 and 91 / 69 counts).  The port's patch-match
# start has the reference's winners (below), so the gaps are the solve's
# float32 round-off against the reference's float64 dot products.
FLOW_GAP_PX = 0.02      # float32 round-off grown by the truncated PCG: 7x the largest reading
FLOW_P999_PX = 0.01     # the same for all but the worst 0.1 % of pixels: 11x its reading
WIND_GAP = 50           # 0.5 m/s: a 0.02-px gap moves a wind by ~20 counts at this grid
RAW_GAP = 3             # shorts of 0.01 px: a 0.02-px gap is 2 counts, and 1 of truncation


def _gaps(u, v, got_u, got_v, products, ref):
    d = torch.cat([(got_u - u).abs().flatten(), (got_v - v).abs().flatten()])
    diffs = [int((a.int() - b.int()).abs().max()) for a, b in zip(products, ref)]
    return (float(d.max()), float(torch.topk(d, d.numel() // 1000).values.min()),
            max(diffs[:2]), max(diffs[2:]))


def _within(g) -> bool:
    return (g[0] <= FLOW_GAP_PX and g[1] <= FLOW_P999_PX and g[2] <= WIND_GAP
            and g[3] <= RAW_GAP)


@pytest.mark.parametrize("seed", [2 ** 33 + 30, 2 ** 33 + 31])
def test_hybrid_pair_against_the_reference(seed):
    cfg, st = _hybrid_stream(seed)
    n = cfg["rows"]
    assert abs(st.max_px - 6.0) < 1e-3
    nav = grid.nav_constants(cfg)
    x, y = grid.scan_counts(cfg)
    s = cfg["settings"]
    assert (s["algorithm"], s["rad"], s["srad"]) == ("hybrid", RAD, SRAD)
    ocfg = OFConfig(solver="pcg", **s)
    c1, c2, t1, t2 = _pair(st)
    s1, s2 = (scene_from_goes_arrays(c, x, y, set_goes_grid(NavConstants(**nav), n, n, 13), ocfg,
                                     "cpu", donav=donav, t=t, band=13)
              for c, t, donav in ((c1, t1, True), (c2, t2, False)))
    ops.reset_counters()
    compute_flow(s1, s2, ocfg)
    assert ops.counters()["patch_match"] == (0, 1)

    d1, d2 = _normalised(cfg, st)
    assert torch.equal(d1, s1.data[0]) and torch.equal(d2, s2.data[0])      # ingest
    u0, v0 = reference.patch_match(d1, d2, RAD, SRAD)
    u, v, _ = reference.solve(d1[None], d2[None], u0, v0, s, "pcg",
                              acc=reference.REFERENCE.accumulate)
    ref = reference.winds(u, v, nav, t2 - t1)
    assert float(torch.sqrt(u * u + v * v).max()) > 1.0        # the flow moves (1.87-3.85 px)
    got = _gaps(u, v, s1.u_pix, s1.v_pix, (s1.u_wind, s1.v_wind, s1.u_raw, s1.v_raw), ref)
    assert _within(got), got

    e1, e2 = _normalised(cfg, st, reference.CONTROL)
    cu0, cv0 = reference.patch_match(e1, e2, RAD, SRAD, reference.CONTROL)
    cu, cv, _ = reference.solve(e1[None], e2[None], cu0, cv0, s, "pcg", torch.bfloat16,
                                reference.CONTROL.accumulate)
    control = _gaps(u, v, cu, cv, reference.winds(cu, cv, nav, t2 - t1, reference.CONTROL), ref)
    assert not _within(control), control


# ---------------------------------------------------------------------------
# both cost forms of patch-match against the reference
# ---------------------------------------------------------------------------

def _port_winners(monkeypatch, d1, d2):
    """(u, v, n, m): the port's flow and its integer winners, caught where
    the sub-pixel fit takes them (``_refine``'s centres: n, then m)."""
    centres = []
    refine = pm._refine

    def catch(center, *costs):
        centres.append(center.clone())
        return refine(center, *costs)

    monkeypatch.setattr(pm, "_refine", catch)
    u, v = pm.patch_match_flow(d1, d2, None, None, RAD, SRAD, device="cpu")
    assert len(centres) == 2
    return u, v, centres[0], centres[1]


# Exact ties (pixels where two offsets share the least cost, so the winner
# rests on the spiral's visit order and the strict <) at 96 x 96, counted
# (at a cost of 0: space and the limb, where patches of space match; above 0):
# both forms resolve every one as the reference does.
TIES = {2 ** 33 + 30: (1831, 0), 2 ** 33 + 31: (1831, 5)}


@pytest.mark.parametrize("form", ["taps", "squared_difference_plane"])
@pytest.mark.parametrize("seed", [2 ** 33 + 30, 2 ** 33 + 31])
def test_patch_match_winners_are_the_references(monkeypatch, form, seed):
    cfg, st = _hybrid_stream(seed, 96)
    d1, d2 = _normalised(cfg, st)
    n = cfg["rows"]
    if form == "squared_difference_plane":      # the full-disk form at 96 x 96
        monkeypatch.setattr(pm, "FIRST_GUESS_MAX_PIXELS", n * n - 1)
    u, v, wn, wm = _port_winners(monkeypatch, d1, d2)
    rows, cols = torch.arange(n)[:, None], torch.arange(n)[None, :]
    rn, rm, _ = reference._search(d1, d2, rows, cols, RAD, SRAD)
    assert torch.equal(wn.long(), rn) and torch.equal(wm.long(), rm)
    assert int(wn.abs().max()) == SRAD or int(wm.abs().max()) == SRAD     # the search reaches
    ru, rv = reference.patch_match(d1, d2, RAD, SRAD)
    # the fit: the same five costs through another summation order of the
    # same float32 terms (the reference gathers, the port slices) -> 1e-5 px
    assert float((u - ru).abs().max()) <= 1e-5 and float((v - rv).abs().max()) <= 1e-5
    costs = torch.stack([reference._jsose(d1, d2, rows, cols, a, b, RAD)
                         for a, b in reference.spiral(SRAD)])
    least = costs.min(0).values
    tie = (costs == least).sum(0) > 1
    assert (int((tie & (least == 0)).sum()), int((tie & (least > 0)).sum())) == TIES[seed]


def test_both_cost_forms_are_bit_for_bit_alike(monkeypatch):
    cfg, st = _hybrid_stream(2 ** 33 + 30, 96)
    d1, d2 = _normalised(cfg, st)
    taps = pm.patch_match_flow(d1, d2, None, None, RAD, SRAD, device="cpu")
    monkeypatch.setattr(pm, "FIRST_GUESS_MAX_PIXELS", 0)
    plane = pm.patch_match_flow(d1, d2, None, None, RAD, SRAD, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(taps, plane))


# ---------------------------------------------------------------------------
# the range and the counter
# ---------------------------------------------------------------------------

def _ranges(fn):
    """(fn's result, how many ``octane.patch_match`` ranges a profile of it
    holds, the names of every range that starts with "octane.")."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    names = [e.name for e in prof.events()]
    return out, names.count(pm.RANGE), {n for n in names if n.startswith("octane.")}


def _images(n=40):
    gen = torch.Generator().manual_seed(n)
    g1 = torch.rand((n, n), generator=gen)
    return g1, torch.roll(g1, (1, -1), (0, 1))


@pytest.mark.parametrize("call", ["zero_guess", "first_guess", "sharded"])
def test_one_range_and_one_count_a_search(call):
    assert not profiling.enabled()
    g1, g2 = _images()
    guess = torch.full_like(g1, 0.5)
    fn = {"zero_guess": lambda: pm.patch_match_flow(g1, g2, None, None, RAD, SRAD),
          "first_guess": lambda: pm.patch_match_flow(g1, g2, guess, guess, RAD, SRAD),
          "sharded": lambda: pm.patch_match_flow_sharded(
              g1, g2, make_mesh((4, 1), [torch.device("cpu")] * 4), RAD, SRAD)}[call]
    ops.reset_counters()
    _, opened, names = _ranges(lambda: (fn(), fn()))
    assert opened == 2 and ops.counters()["patch_match"] == (0, 2)
    assert names == {pm.RANGE}
    if call == "sharded":           # equal to the whole-image search
        assert all(torch.equal(a, b) for a, b in zip(
            fn(), pm.patch_match_flow(g1, g2, None, None, RAD, SRAD)))


def _scenes(n=48):
    """The two-scan GOES fixture, moved (1.2, -0.6) px in 60 s, read on the CPU."""
    scenes = []
    for shift, t, donav in (((0, 0), FIXTURE_T0, True), ((1.2, -0.6), FIXTURE_T0 + 60, False)):
        counts, x, y, nav, t, _, _ = goes_arrays(fixture_counts(*shift, n, n), t)
        scenes.append(scene_from_goes_arrays(counts, x, y, nav, OFConfig(), "cpu", donav=donav,
                                             t=t))
    return scenes


@pytest.mark.parametrize("algorithm,searches", [("variational", 0), ("hybrid", 1),
                                                 ("patch_match", 1)])
def test_pairs_open_the_range_only_where_they_search(algorithm, searches):
    cfg = OFConfig(kiters=1, cgiters=4, algorithm=algorithm)    # few ops to profile
    s1, s2 = _scenes()
    ops.reset_counters()
    _, opened, names = _ranges(lambda: compute_flow(s1, s2, cfg))
    assert opened == searches and ops.counters()["patch_match"] == (0, searches)
    assert names == ({pm.RANGE} if searches else set())     # the tracer's spans are off


def test_tracer_span_of_the_search_inside_the_solve():
    s1, s2 = _scenes()
    profiling.reset()
    profiling.enable()
    try:
        with profiling.request(0):
            compute_flow(s1, s2, OFConfig(kiters=2, algorithm="hybrid"))
        spans = profiling.records()[0]
    finally:
        profiling.disable()
        profiling.reset()
    by_id = {s.id: s for s in spans}
    found = [s for s in spans if s.name == "octane.flow.patch_match"]
    assert len(found) == 1
    span = found[0]
    assert by_id[span.parent].name == "octane.flow.solve"
    assert span.device_start is not None and span.device_start <= span.device_end
    solve = next(s for s in spans if s.name == "octane.solve")     # the refinement's
    assert by_id[solve.parent].name == "octane.flow.solve"
    assert span.end <= by_id[solve.parent].end


# ---------------------------------------------------------------------------
# the configuration and the cell's readers
# ---------------------------------------------------------------------------

def test_hybrid_cell_loads():
    cell = spec.cell("fd-hybrid-pcg")
    fd = spec.cell("fd-pcg")
    assert cell.chips == 1 and cell.traffic == fd.traffic
    assert cell.traffic["solver"] == "pcg" and not cell.traffic["warm_start"]
    assert (cell.traffic["trace_pairs"], cell.traffic["compare_pairs"]) == (2, 1)
    s = dict(cell.config["settings"])
    assert (s.pop("algorithm"), s.pop("rad"), s.pop("srad")) == ("hybrid", RAD, SRAD)
    assert s == fd.config["settings"]
    same = {k: v for k, v in cell.config.items() if k not in ("name", "deployment", "source",
                                                               "settings")}
    assert same == {k: fd.config[k] for k in same}
    assert {m["name"] for m in cell.per_layer} == {
        "ingest_ms", "flow_ms", "output_ms", "device_idle_share", "pcg_roofline",
        "pcg_iterations", "patch_match_ms", "patch_match_roofline"}
    assert {m["name"] for m in cell.end_to_end} == {"pair_ms", "setup_s"}
    entry = next(c for c in spec.benchmark()["configs"] if c["name"] == "goes-fd-b13-hybrid")
    assert entry["reduced"] == [] and entry["file"] == "octbench/configs/goes-fd-b13-hybrid.json"


def _slice(launched_in, pairs=2):
    """A run of a 5424 x 5424 hybrid cell whose profiled slice [0, 1000) us
    of ``pairs`` pairs holds one device operation of 100 us for each entry
    of ``launched_in`` (the ranges open at its launch), one after another."""
    dev = [(100.0 * i, 100.0 * (i + 1), f"kernel_{i}", 0) for i in range(len(launched_in))]
    tr = trace.Trace(dev, [(0.0, 1000.0, trace.SLICE)], 0.0, 1000.0, 1, list(launched_in))
    return types.SimpleNamespace(trace=tr, slice_pairs=pairs,
                                 config=spec.load_json(CONFIG))


def test_readers_none_without_a_trace_or_a_range():
    for name in ("patch_match_ms", "patch_match_roofline"):
        read = spec.metric_reader(name)
        assert read(types.SimpleNamespace(trace=None, slice_pairs=0)) is None
        # the tracer's span of the same name and the solve's: not the range
        run = _slice([("octane.flow.patch_match", "octane.flow.solve", trace.SLICE),
                      ("octane.flow.solve", trace.SLICE), ()])
        assert read(run) is None


def test_readers_on_a_trace_with_nested_ranges():
    inside = (pm.RANGE, "octane.flow.patch_match", "octane.flow.solve", "octane.flow",
              trace.SLICE)
    run = _slice([inside, inside, ("octane.flow.solve", trace.SLICE), inside,
                  ("octane.flow.patch_match", trace.SLICE), (trace.SLICE,), (pm.RANGE,)])
    ms = spec.metric_reader("patch_match_ms")(run)
    assert ms == pytest.approx(4 * 100e-3 / 2)              # 4 operations, 2 pairs
    share = spec.metric_reader("patch_match_roofline")(run)
    bound = roofline.patch_match_bound_s(run.config["settings"], 5424, 5424, 2)
    assert bound == pytest.approx(2 * 0.3047e-3, rel=1e-3)
    assert share == pytest.approx(100.0 * bound / 400e-6)
