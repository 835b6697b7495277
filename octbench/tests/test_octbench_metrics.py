"""The metric arithmetic on hand-worked inputs: the union of device
intervals, the idle share, the idle gaps by host range, p95 over every
sample, and the roofline counts."""

import types

import numpy as np
import pytest

from octbench import roofline, spec, trace


def _trace():
    # slice [0, 100) us; kernels overlap at 10-30 and 25-40, one at 60-70;
    # a user-annotation-free device list, host ranges around the gaps
    dev = [(10.0, 30.0, "pcg_pass_a<true>", 0), (25.0, 40.0, "pcg_pass_b", 0),
           (60.0, 70.0, "Memcpy DtoH (Device -> Pageable)", 0)]
    host = [(0.0, 100.0, trace.SLICE), (38.0, 62.0, "octbench.output"),
            (39.0, 61.0, "cudaMemcpyAsync"), (65.0, 99.0, "cudaDeviceSynchronize")]
    return trace.Trace(dev, host, 0.0, 100.0)


def test_union_busy_and_idle_share():
    tr = _trace()
    assert trace.union([(5, 6), (1, 3), (2, 4)]) == [(1, 4), (5, 6)]
    assert trace.busy_us(tr) == pytest.approx(40.0)          # 10-40 and 60-70
    assert trace.kernel_us(tr, ("pcg_pass_a", "pcg_pass_b")) == pytest.approx(35.0)
    idle = spec.metric_reader("device_idle_share")
    assert idle(types.SimpleNamespace(trace=tr)) == pytest.approx(0.6)
    assert idle(types.SimpleNamespace(trace=None)) is None


def test_idle_gaps_by_host_range_and_device_ops():
    gaps = dict(trace.idle_gaps(_trace()))
    # 0-10 (no range but the slice), 40-60 (the output's copy), 70-100 (a sync)
    assert gaps == pytest.approx({"no host range open": 10e-6,
                                  "octbench.output: cudaMemcpyAsync": 20e-6,
                                  "cudaDeviceSynchronize": 30e-6})
    ops = dict(trace.device_ops(_trace()))
    assert ops["PCG pass A"] == pytest.approx(20e-6)
    assert ops["copies / cat / stack"] == pytest.approx(10e-6)


def test_p95_over_every_sample_and_pair_ms():
    lat = [0.010] * 95 + [0.020] * 5
    run = types.SimpleNamespace(latencies=lat, window_s=1.5, pairs=100)
    p95 = spec.metric_reader("pair_ms_p95")(run)
    assert p95 == pytest.approx(float(np.percentile(np.asarray(lat) * 1e3, 95)))
    assert 10.0 < p95 < 20.0
    assert spec.metric_reader("pair_ms")(run) == pytest.approx(15.0)
    assert spec.metric_reader("pair_ms_p95")(types.SimpleNamespace(latencies=lat[:10])) is None


SETTINGS = {"kiters": 2, "scale_factor": 0.5, "gnc_steps": 3, "liters": 1, "cgiters": 30}


def test_level_shapes_and_rounds():
    assert roofline.level_shapes(SETTINGS, 100, 64) == [(50, 32), (100, 64)]
    assert roofline.level_shapes({"kiters": 4, "scale_factor": 0.5}, 5424, 5424)[0] == (678, 678)
    assert roofline.rounds(SETTINGS, 100, 64) == [(1600, True), (1600, False), (1600, False),
                                                  (6400, True), (6400, False), (6400, False)]


def test_pcg_bound_by_hand():
    # one pair, every round at cgiters = 30 iterations: bytes-bound,
    # (1600 + 6400) px x 30 x (60 + 2 x 76) bytes over 3.35e12 B/s
    want = (1600 + 6400) * 30 * (60 + 76 + 76) / 3.35e12
    assert roofline.pcg_bound_s(SETTINGS, 100, 64, 1, 6 * 30) == pytest.approx(want)
    # fewer iterations are spread evenly over the rounds
    assert roofline.pcg_bound_s(SETTINGS, 100, 64, 1, 6 * 15) == pytest.approx(want / 2)


def test_sor_bound_by_hand():
    # cgiters 30 = passes of 8, 8, 8, 6: four passes a full round; a robust
    # round at 30 sweeps is (36 x 30 + 4) operations against 52 bytes a pixel
    def rnd(px, b, f):
        return max(px * b / 3.35e12, px * f / 6.7e13)
    want = sum(rnd(px, 36, 30 * 30 + 4) + 2 * rnd(px, 52, 36 * 30 + 4) for px in (1600, 6400))
    assert roofline.sor_bound_s(SETTINGS, 100, 64, 1, 6 * 4) == pytest.approx(want)


def test_patch_match_bound_by_hand():
    # rad 2, srad 2: 25 offsets x (a square, 2, and 24 sums in jsose's order)
    # + 24 comparisons + the fit, 20: 694 operations against 16 bytes a pixel,
    # bound by the operations; 5424^2: 0.3047 ms
    px = 5424 * 5424
    want = max(px * 16 / 3.35e12, px * 694 / 6.7e13)
    assert roofline.patch_match_bound_s({}, 5424, 5424, 1) == pytest.approx(want)
    assert want == pytest.approx(0.3047e-3, rel=1e-3)
    # rad 3, srad 1, two pairs: 9 x (2 + 48) + 8 + 20 = 478
    assert roofline.patch_match_bound_s({"rad": 3, "srad": 1}, 100, 64, 2) == pytest.approx(
        2 * max(6400 * 16 / 3.35e12, 6400 * 478 / 6.7e13))


def test_share_is_none_without_the_kernels():
    run = types.SimpleNamespace(trace=trace.Trace([], [], 0.0, 1.0), slice_counters={},
                                config={"settings": SETTINGS, "rows": 100, "cols": 64},
                                slice_pairs=1)
    assert roofline.share(run, "pcg", ("pcg_pass_a",)) is None
    run.trace = trace.Trace([(0.0, 1000.0, "pcg_pass_a", 0), (1000.0, 1500.0, "pcg_pass_b", 0)],
                            [], 0.0, 2000.0)
    run.slice_counters = {"pcg_pass_a": 180}
    want = 100 * roofline.pcg_bound_s(SETTINGS, 100, 64, 1, 180) / 1.5e-3
    assert roofline.share(run, "pcg", ("pcg_pass_a", "pcg_pass_b")) == pytest.approx(want)


def _two_cards():
    # card 0 busy 10-40, card 1 busy 30-80 and 90-95, in a slice of 100 us:
    # 85 us of 200 card-us busy; no card busy 0-10, 80-90 and 95-100 (under
    # GAP_MIN_US); card 1 alone idle 0-30
    dev = [(10.0, 30.0, "pcg_pass_a<true, true>", 0), (20.0, 40.0, "pcg_pass_b", 0),
           (30.0, 80.0, "pcg_pass_a<false, true>", 1), (90.0, 95.0, "memset", 1)]
    host = [(0.0, 100.0, trace.SLICE), (79.0, 91.0, "cudaStreamSynchronize")]
    return trace.Trace(dev, host, 0.0, 100.0, cards=2)


def test_busy_and_idle_share_per_card():
    tr = _two_cards()
    assert trace.busy_us(tr) == pytest.approx(30.0 + 55.0)
    assert trace.busy_by_card(tr) == pytest.approx({0: 30.0, 1: 55.0})
    assert trace.idle_share(tr) == pytest.approx(1.0 - 85.0 / 200.0)
    idle = spec.metric_reader("device_idle_share")
    assert idle(types.SimpleNamespace(trace=tr)) == pytest.approx(1.0 - 85.0 / 200.0)
    # a card of the run that did no work counts as idle
    tr.cards = 4
    assert trace.idle_share(tr) == pytest.approx(1.0 - 85.0 / 400.0)
    # gaps are those in which no card is busy
    gaps = dict(trace.idle_gaps(_two_cards()))
    assert sum(gaps.values()) == pytest.approx((10.0 + 10.0) * 1e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(10e-6)


def test_one_card_reads_what_the_union_over_the_wall_read():
    tr = _trace()
    union = sum(e - s for s, e in trace.union([(s, e) for s, e, *_ in tr.device]))
    assert trace.busy_us(tr) == union
    assert trace.idle_share(tr) == 1.0 - union / (tr.t1 - tr.t0)


@pytest.mark.parametrize("layer,counter,band_counter,per_pair", [
    ("pcg", "pcg_pass_a", "pcg_pass_a_band", 180), ("sor", "sor_pass", "sor_pass_band", 24)])
def test_a_pair_is_counted_once_on_one_band_or_four(layer, counter, band_counter, per_pair):
    # one pair's work: whole-image launches on one band, each of four bands
    # launching the band form once an iteration or pass
    def run(mesh, counters):
        settings = dict(SETTINGS, **({"mesh_shape": mesh} if mesh else {}))
        return types.SimpleNamespace(
            config={"settings": settings, "rows": 100, "cols": 64}, slice_pairs=1,
            slice_counters=counters, window_counters=counters, pairs=1,
            trace=trace.Trace([(0.0, 1000.0, f"{counter}<true>", c) for c in range(4)],
                              [], 0.0, 2000.0, cards=4))
    one = run(None, {counter: per_pair})
    four = run([4, 1], {band_counter: 4 * per_pair})
    kernels = (counter,)
    assert roofline.share(four, layer, kernels) == roofline.share(one, layer, kernels)
    assert roofline.work(four.config["settings"], four.slice_counters, layer) == per_pair
    reader = spec.metric_reader("pcg_iterations" if layer == "pcg" else "sor_passes")
    assert reader(four) == reader(one) == per_pair


@pytest.mark.parametrize("chips", [1, 4])
def test_device_record_per_card(chips, monkeypatch):
    import torch

    from octbench import run

    peaks = {0: 7 * 2 ** 30, 1: 9 * 2 ** 30, 2: 8 * 2 ** 30, 3: 2 ** 30}
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d: peaks[d.index])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "NVIDIA H100 80GB HBM3")
    devices = run.cards(torch.device("cuda", 0), chips)
    assert [d.index for d in devices] == list(range(chips))
    rec = run.device_record(devices)
    assert rec["count"] == chips and rec["platform"] == "gpu"
    assert rec["memory_peak_bytes_per_card"] == [peaks[i] for i in range(chips)]
    assert rec["memory_peak_bytes"] == max(peaks[i] for i in range(chips))
    assert rec["kind"] == "NVIDIA H100 80GB HBM3"
    assert run.device_record(run.cards(torch.device("cpu"), chips))["count"] == 1


def _ev(name, start, end, cuda=False, card=0, id=0, thread=1, user=False):
    """An event as ``prof.events()`` gives it: ``id`` is a runtime call's
    and its device operations' correlation id."""
    import torch

    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=start, end=end),
                                 device_type=kind, device_index=card, id=id, thread=thread,
                                 is_user_annotation=user)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _launches():
    # slice [0, 100) us.  Host thread 1: octane.flow [5, 60) holding
    # octane.flow.patch_match [10, 30), an earlier patch_match range [-20, -1)
    # before the slice; kernels on two cards, each found by its runtime call:
    #  a: card 0 [20, 26), aten::sub's cudaLaunchKernel at 12.5, in patch_match
    #  b, c: card 1 [45, 70) and [95, 110), one cudaGraphLaunch at 40 on a thread
    #        that opened no range (CUPTI's thread id), in octane.flow
    #  d: card 0 [82, 90), aten::add's launch at 80, in the slice alone
    #  e: card 0 [90, 92), with no runtime call
    #  f: card 1 [-5, 3), a graph launch at -10 in the first patch_match range
    # and the patch_match range's mirror on card 0, which is no operation
    host = [_ev(trace.SLICE, 0.0, 100.0, id=1, user=True),
            _ev("octane.flow", 5.0, 60.0, id=2, user=True),
            _ev("octane.flow.patch_match", 10.0, 30.0, id=3, user=True),
            _ev("aten::sub", 12.0, 14.0, id=4),
            _ev("cudaLaunchKernel", 12.5, 13.5, id=1001),
            _ev("cudaGraphLaunch", 40.0, 41.0, id=1002, thread=90001),
            _ev("aten::add", 79.0, 82.0, id=5),
            _ev("cudaLaunchKernel", 80.0, 81.0, id=1003),
            _ev("octane.flow.patch_match", -20.0, -1.0, id=6, user=True),
            _ev("cudaGraphLaunch", -10.0, -9.0, id=1005, thread=90001)]
    dev = [_ev("sub_kernel", 20.0, 26.0, cuda=True, card=0, id=1001),
           _ev("graph_kernel_1", 45.0, 70.0, cuda=True, card=1, id=1002),
           _ev("graph_kernel_2", 95.0, 110.0, cuda=True, card=1, id=1002),
           _ev("add_kernel", 82.0, 90.0, cuda=True, card=0, id=1003),
           _ev("stray_kernel", 90.0, 92.0, cuda=True, card=0, id=1004),
           _ev("early_kernel", -5.0, 3.0, cuda=True, card=1, id=1005),
           _ev("octane.flow.patch_match", 20.0, 26.0, cuda=True, card=0, user=True)]
    return trace.from_profiler(_Prof(host + dev), cards=2)


def test_device_time_by_launching_range():
    tr = _launches()
    assert len(tr.device) == 6 and len(tr.launched_in) == 6
    by_name = {d[2]: names for d, names in zip(tr.device, tr.launched_in)}
    assert by_name["sub_kernel"] == ("octane.flow.patch_match", "octane.flow", trace.SLICE)
    assert by_name["graph_kernel_1"] == by_name["graph_kernel_2"] == ("octane.flow", trace.SLICE)
    assert by_name["add_kernel"] == (trace.SLICE,)
    assert by_name["stray_kernel"] == ()
    assert by_name["early_kernel"] == ("octane.flow.patch_match",)
    # summed over the cards, clipped to the slice: f's [0, 3), c's [95, 100)
    assert trace.device_us_in(tr, "octane.flow.patch_match") == pytest.approx(6.0 + 3.0)
    assert trace.device_us_in(tr, "octane.flow.patch") == pytest.approx(9.0)
    assert trace.device_us_in(tr, "octane.flow") == pytest.approx(9.0 + 25.0 + 5.0)
    assert trace.device_us_in(tr, trace.SLICE) == pytest.approx(6.0 + 25.0 + 5.0 + 8.0)
    assert trace.device_us_in(tr, "octbench.ingest") == 0.0


@pytest.mark.parametrize("make", [_trace, _two_cards])
def test_reductions_of_a_profile_are_those_of_its_trace(make):
    # the hand-made traces as a profiler gives them: every reduction reads
    # what it reads of the Trace made by hand
    want = make()
    events = [_ev(n, s, e, id=i + 1, user=n == trace.SLICE)
              for i, (s, e, n) in enumerate(want.host)]
    events += [_ev(n, s, e, cuda=True, card=c, id=5000 + i)
               for i, (s, e, n, c) in enumerate(want.device)]
    got = trace.from_profiler(_Prof(events), cards=want.cards)
    assert (got.device, got.host, got.t0, got.t1) == (want.device, want.host, want.t0, want.t1)
    assert trace.busy_by_card(got) == trace.busy_by_card(want)
    assert trace.busy_us(got) == trace.busy_us(want)
    assert trace.idle_share(got) == trace.idle_share(want)
    assert trace.device_ops(got) == trace.device_ops(want)
    assert trace.idle_gaps(got) == trace.idle_gaps(want)
    assert trace.kernel_us(got, ("pcg_pass_a",)) == trace.kernel_us(want, ("pcg_pass_a",))
    assert got.launched_in == [()] * len(got.device)
