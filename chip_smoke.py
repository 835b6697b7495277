"""Smoke run of the PyTorch/CUDA port (octane_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. environment: torch, CUDA, nvcc, which of triton/h5py/jax are installed,
     the card's name and power limit;
  2. build the CUDA kernels from octane_tpu_torch/csrc;
  3. warp kernel vs its plain version: bit-exact samples and flags, exact
     tile statistics, both the staged and the global-memory branch;
  4. Jacobi-PCG passes vs their plain versions (bit-exact, block partials
     included: the plain versions sum in the kernels' order) and 30-iteration
     solves vs the reference loop flow.cg.pcg_solve (rel <= 5e-4), quad and
     robust;
  5. the main path on the 512^2 product fixture pair (tests/golden/
     product_512.npz): through the CLI where h5py is installed, else through
     scene_from_goes_arrays -> compute_flow; shorts within 1 count and
     mostly exact (EXACT_SHARE), every kernel launched and no plain
     version called;
  6. the 256^2 oracle fixture (variational_256.npz): mean EPE < 0.01 px,
     max < 0.1 px;
  7. a GOES full-disk 5424^2 pair (kiters=4) through variational_flow and
     pix2uv, timed with CUDA events with the kernels and with their plain
     versions (the solver's internal plain route); the two flows must be
     bit-identical.  The warp and both PCG passes are held bit-exact against
     their plain versions at every pyramid level's shape (5424^2 .. 678^2)
     and timed beside them at 5424^2.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  ``--only`` runs a subset, e.g.
``--only build,warp,pcg``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "build", "warp", "pcg", "main", "golden", "fulldisk")
WARP_SRC = "octane_tpu_torch/csrc/warp.cu"
PCG_SRC = "octane_tpu_torch/csrc/pcg.cu"


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def load_tests_module(name):
    """tests/<name>.py loaded by its path: an installed package named
    ``tests`` would shadow the repo's tests directory on ``import``."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------------------
# synthetic inputs
# ----------------------------------------------------------------------------

def pcg_system(h, w, quad, device, seed=1):
    """A well-conditioned coupled system (tests/test_fused_cg.py:20-32)."""
    from octane_tpu_torch.flow.stencil import StencilSystem

    rng = np.random.default_rng(seed)

    def arr(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, (h, w)).astype(np.float32)).to(device)

    diag = (arr(4.5, 9.0), arr(4.5, 9.0))
    rhs = (arr(-100, 100), arr(-100, 100))
    offd = (-1.0,) * 4 if quad else tuple(-arr(0.3, 1.0) for _ in range(4))
    return StencilSystem(diag[0], arr(-0.2, 0.2), diag[1], *offd, *rhs)


def rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def compare_passes(x, r, p, ap_in, cf, ab):
    """Both PCG passes, kernel vs plain version, on the same inputs.

    Returns (all outputs bit-equal, max |d| of pass A's outputs, of pass B's,
    max rel of the partials' sums)."""
    from octane_tpu_torch.ops.pcg import (pcg_pass_a, pcg_pass_a_plain, pcg_pass_b,
                                          pcg_pass_b_plain)

    alpha = ab[:1].clone()
    ka = pcg_pass_a(x, r, p, cf, ab)
    pa = pcg_pass_a_plain(x, r, p, cf, ab)
    kb = pcg_pass_b(r, ap_in, cf, alpha)
    pb = pcg_pass_b_plain(r, ap_in, cf, alpha)
    equal = all(torch.equal(k, q) for k, q in list(zip(ka, pa)) + list(zip(kb, pb)))
    err_a = max(float((k - q).abs().max()) for k, q in zip(ka, pa))
    err_b = max(float((k - q).abs().max()) for k, q in zip(kb, pb))
    part_rel = max(rel(ka[3].sum(), pa[3].sum()), rel(kb[1].sum(0), pb[1].sum(0)))
    return equal, err_a, err_b, part_rel


def cuda_ms(fn, n=10):
    """Mean milliseconds of ``fn()`` over n runs after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# ----------------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------------

def phase_env():
    from octane_tpu_torch.ops.build import _nvcc

    say("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
               f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    ver = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True)
    say("env", "nvcc " + ver.stdout.strip().splitlines()[-1])
    have = {m: importlib.util.find_spec(m) is not None for m in ("triton", "h5py", "jax")}
    say("env", "installed: " + ", ".join(f"{m}={'yes' if v else 'no'}" for m, v in have.items()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return have


def phase_build():
    from octane_tpu_torch.ops import build

    t0 = time.perf_counter()
    info = build.load_kernels().build_info
    say("build", f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
                 f"(nvcc {info.get('seconds', 0.0):.2f} s)")
    for line in info.get("ptxas", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            say("build", line.strip())


def phase_warp(dev, report):
    from octane_tpu_torch.ops.warp import warp, warp_bilinear_dense, warp_block_stats

    rng = np.random.default_rng(0)
    staged_tiles = global_tiles = 0
    worst = 0.0
    for (h, w) in ((512, 512), (500, 372)):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        smooth = (2.0 + 1.5 * np.sin(xx / 37.0) * np.cos(yy / 23.0),
                  -1.0 + np.cos(xx / 29.0 + yy / 41.0))
        # a sheared +-40 px jet across rows, and rows/columns pushed past
        # the edges so the clamp paths run
        jet_u = 40.0 * np.tanh((yy - h / 2) / 6.0) + rng.uniform(-1, 1, (h, w))
        jet_v = 3.0 * np.sin(xx / 17.0) - 6.0 * (yy < 8) + 6.0 * (yy > h - 9)
        jet_u = jet_u + 8.0 * (xx > w - 5) - 8.0 * (xx < 4)
        noise = (rng.uniform(-40, 40, (h, w)), rng.uniform(-40, 40, (h, w)))
        fields = torch.from_numpy(rng.normal(0, 1, (6, h, w)).astype(np.float32)).to(dev)
        for name, (u, v) in (("smooth", smooth), ("jet", (jet_u, jet_v)),
                             ("noise40", noise)):
            u = torch.from_numpy(u.astype(np.float32)).to(dev)
            v = torch.from_numpy(v.astype(np.float32)).to(dev)
            s, bx, by, stats, staged = warp(fields, u, v, with_stats=True)
            ps, pbx, pby = warp_bilinear_dense(fields, u, v)
            pstats = warp_block_stats(u, v)
            torch.cuda.synchronize()
            err = float((s - ps).abs().max())
            ok = (torch.equal(s, ps) and torch.equal(bx, pbx) and torch.equal(by, pby)
                  and torch.equal(stats, pstats))
            n_st = int(staged.sum())
            staged_tiles += n_st
            global_tiles += staged.numel() - n_st
            worst = max(worst, err)
            say("warp", f"{h}x{w} {name}: max|d| {err:.3e}, flags/stats equal "
                        f"{ok}, tiles staged {n_st} / global {staged.numel() - n_st}")
            if not ok:
                raise AssertionError(f"warp {h}x{w} {name}: kernel differs from plain")
    say("warp", f"tiles staged {staged_tiles}, global {global_tiles}")
    if staged_tiles == 0 or global_tiles == 0:
        raise AssertionError("warp: both branches must be taken")
    report["warp_bilinear"] = {"max_abs_err": worst}


def state_planes(rng, h, w, dev, n=4):
    """n random (2, h, w) float32 PCG state planes."""
    return [torch.from_numpy(rng.normal(0, 10, (2, h, w)).astype(np.float32)).to(dev)
            for _ in range(n)]


def coef_stack(s, quad):
    planes = [s.a1, s.a4, s.a2] + ([] if quad else [s.a5, s.a6, s.a7, s.a8])
    return torch.stack(planes)


def phase_pcg(dev, report):
    from octane_tpu_torch.flow.cg import pcg_solve
    from octane_tpu_torch.flow.stencil import apply_stencil
    from octane_tpu_torch.ops.pcg import pcg_solve_fused

    rng = np.random.default_rng(2)
    err_a = err_b = 0.0
    for (h, w) in ((512, 512), (500, 372)):
        for quad in (True, False):
            s = pcg_system(h, w, quad, dev)
            ab = torch.tensor([0.37, 0.81], dtype=torch.float32, device=dev)
            equal, ea, eb, part_rel = compare_passes(*state_planes(rng, h, w, dev),
                                                     coef_stack(s, quad), ab)
            tol = 1e-8
            fu, fv = pcg_solve_fused(s, tol, 30)
            ru, rv = pcg_solve(lambda a, b: apply_stencil(s, a, b), s.a1, s.a4,
                               s.bu, s.bv, tol, 30)
            ds = max(rel(fu, ru), rel(fv, rv))
            torch.cuda.synchronize()
            mode = "quad" if quad else "robust"
            say("pcg", f"{h}x{w} {mode}: passes A/B bit-exact {equal} (max|d| "
                       f"{max(ea, eb):.3e}, partial sums rel {part_rel:.2e}), "
                       f"30-iteration solve vs pcg_solve rel {ds:.2e}")
            if not (equal and ds <= 5e-4):
                raise AssertionError(f"pcg {h}x{w} {mode}: outside the budget")
            err_a, err_b = max(err_a, ea), max(err_b, eb)
    report["pcg_pass_a"] = {"max_abs_err": err_a}
    report["pcg_pass_b"] = {"max_abs_err": err_b}


def _check_counters(phase):
    from octane_tpu_torch import ops

    c = ops.counters()
    say(phase, "launches (kernel, plain): " + json.dumps(c))
    for name in ops.WRAPPERS:
        launches, plain = c[name]
        if launches <= 0 or plain != 0:
            raise AssertionError(f"{phase}: {name} launched {launches} times, "
                                 f"plain version called {plain} times")
    return c


def phase_main(dev, have_h5py):
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow.dispatcher import compute_flow
    from octane_tpu_torch.io.readers import scene_from_goes_arrays

    fx = load_tests_module("torch_fixtures")
    FIXTURE_T0, fixture_counts, goes_arrays = fx.FIXTURE_T0, fx.fixture_counts, fx.goes_arrays
    want = np.load(os.path.join(ROOT, "tests", "golden", "product_512.npz"))
    c1, c2 = fixture_counts(0, 0), fixture_counts(3.0, -1.5)
    cfg = OFConfig()
    ops.reset_counters()
    t0 = time.perf_counter()
    if have_h5py:
        import h5py
        make_goes_file = load_tests_module("synth").make_goes_file
        from octane_tpu_torch.cli import main as cli_main

        out = os.path.join(ROOT, "chiprun_out", "chip_smoke")
        os.makedirs(out, exist_ok=True)
        f1 = make_goes_file(os.path.join(out, "g1.nc"), c1, band=13)
        f2 = make_goes_file(os.path.join(out, "g2.nc"), c2, band=13,
                            t=FIXTURE_T0 + 60.0)
        cli_main(["-i1", f1, "-i2", f2, "-o", out, "--device", "cuda"])
        with h5py.File(os.path.join(out, "outfile.nc")) as f:
            got = {k: np.asarray(f[k][()]) for k in ("U", "V", "U_raw", "V_raw")}
        how = "cli.main"
    else:
        s1 = scene_from_goes_arrays(*goes_arrays(c1, FIXTURE_T0)[:4], cfg, dev,
                                    donav=True, t=FIXTURE_T0)
        s2 = scene_from_goes_arrays(*goes_arrays(c2, FIXTURE_T0 + 60.0)[:4], cfg,
                                    dev, donav=False, t=FIXTURE_T0 + 60.0)
        s1.nav.g2x_offset, s1.nav.g2y_offset = s2.nav.x_offset, s2.nav.y_offset
        compute_flow(s1, s2, cfg)
        got = {"U": s1.u_wind, "V": s1.v_wind, "U_raw": s1.u_raw, "V_raw": s1.v_raw}
        got = {k: t.cpu().numpy() for k, t in got.items()}
        how = "scene_from_goes_arrays -> compute_flow -> pix2uv (no h5py)"
    torch.cuda.synchronize()
    say("main", f"512x512 fixture pair via {how} in {time.perf_counter() - t0:.2f} s")
    counts = _check_counters("main")
    for var in ("U", "V", "U_raw", "V_raw"):
        d = np.abs(got[var].astype(np.int32) - want[var].astype(np.int32))
        exact = float((d == 0).mean())
        say("main", f"{var}: max short diff {int(d.max())}, exact {exact:.5f}")
        if d.max() > 1 or exact <= fx.EXACT_SHARE[var]:
            raise AssertionError(f"main: {var} differs from product_512.npz")
    return counts


def phase_golden(dev):
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow.variational import variational_flow
    from octane_tpu_torch.io.native import epe_stats

    g = np.load(os.path.join(ROOT, "tests", "golden", "variational_256.npz"))
    z = torch.zeros(g["u"].shape, device=dev)
    u, v = variational_flow(torch.from_numpy(g["im1"]).to(dev),
                            torch.from_numpy(g["im2"]).to(dev), z, z,
                            OFConfig(kiters=4))
    mean, mx, _ = epe_stats(u.cpu().numpy(), v.cpu().numpy(), g["u"], g["v"])
    say("golden", f"variational_256 (kiters=4, pcg): mean EPE {mean:.3e} px, "
                  f"max {mx:.3e} px")
    if not (mean < 0.01 and mx < 0.1):
        raise AssertionError("golden: EPE outside the budget")


def phase_fulldisk(dev, report):
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.core.gradients import gradient_4th
    from octane_tpu_torch.core.zoom import zoom_size
    from octane_tpu_torch.flow.stencil import assemble
    from octane_tpu_torch.flow.variational import _coarse_to_fine, variational_flow
    from octane_tpu_torch.nav.winds import pix2uv
    from octane_tpu_torch.ops.pcg import (pcg_pass_a, pcg_pass_a_plain, pcg_pass_b,
                                          pcg_pass_b_plain)
    from octane_tpu_torch.ops.warp import warp, warp_bilinear_dense

    fx = load_tests_module("torch_fixtures")
    for name in ("warp_bilinear", "pcg_pass_a", "pcg_pass_b"):
        report.setdefault(name, {"max_abs_err": 0.0})
    h = w = 5424
    t0 = time.perf_counter()
    im1, im2 = fx.bench_pair(h, w)
    g1 = torch.from_numpy(im1[None]).to(dev)
    g2 = torch.from_numpy(im2[None]).to(dev)
    z = torch.zeros((h, w), device=dev)
    _, _, _, nav, *_ = fx.goes_arrays(np.zeros((h, w), np.int16), fx.FIXTURE_T0)
    nav.g2x_offset, nav.g2y_offset = nav.x_offset, nav.y_offset
    say("fulldisk", f"{h}x{w} pair made in {time.perf_counter() - t0:.2f} s")
    mpix = h * w / 1e6
    cfg = OFConfig(kiters=4)
    runs = {"kernels": lambda: variational_flow(g1, g2, z, z, cfg),
            "plain": lambda: _coarse_to_fine(g1, g2, z, z, cfg, plain=True)}
    results = {}
    for label, run in runs.items():
        run()                                            # warm-up
        torch.cuda.synchronize()
        ops.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        u, v = run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        results[label] = (u, v)
        say("fulldisk", f"{label}: {ms:.1f} ms per pair, {mpix / (ms / 1e3):.3f} Mpix/s, "
                        f"peak {peak:.2f} GiB, PCG host syncs "
                        f"{ops.counters()['pcg_host_syncs']}")
        if label == "kernels":
            report["_launches"] = _check_counters("fulldisk")
        else:
            c = ops.counters()
            say("fulldisk", "plain route (kernel, plain): " + json.dumps(c))
            if any(c[n][0] != 0 or c[n][1] <= 0 for n in ops.WRAPPERS):
                raise AssertionError("fulldisk: the plain route launched a kernel")
    (u, v), (pu, pv) = results["kernels"], results["plain"]
    same = torch.equal(u, pu) and torch.equal(v, pv)
    diff = max(float((u - pu).abs().max()), float((v - pv).abs().max()))
    med_u = float(u[512:-512, 512:-512].median())
    med_v = float(v[512:-512, 512:-512].median())
    say("fulldisk", f"kernels vs plain: bit-identical {same} (max |d| {diff:.3e} px); "
                    f"median flow ({med_u:.4f}, {med_v:.4f}) px, truth (2.4, 0)")
    if not (same and abs(med_u - 2.4) < 0.1 and abs(med_v) < 0.1):
        raise AssertionError("fulldisk: flow differs from the plain route or the truth")
    uw, vw, ur, vr = pix2uv(u, v, nav, 60.0)
    torch.cuda.synchronize()
    if not (torch.isfinite(u).all() and torch.isfinite(v).all()
            and uw.shape == (h, w) and ur.shape == (h, w)):
        raise AssertionError("fulldisk: non-finite flow or wrong product shape")

    # the warp at the finest level's shape, on the final flow
    gx2, gy2 = gradient_4th(g2)
    gxx, _ = gradient_4th(gx2)
    gxy, gyy = gradient_4th(gy2)
    gx1, gy1 = gradient_4th(g1)
    stack = torch.cat([g2, gx2, gy2, gxx, gxy, gyy]).contiguous()
    u, v = u.contiguous(), v.contiguous()
    kw, pw = warp(stack, u, v), warp_bilinear_dense(stack, u, v)
    if not all(torch.equal(a, b) for a, b in zip(kw, pw)):
        raise AssertionError(f"fulldisk: warp {h}x{w} differs from its plain version")
    err = float((kw[0] - pw[0]).abs().max())
    report["warp_bilinear"]["max_abs_err"] = max(report["warp_bilinear"]["max_abs_err"], err)
    times = {"warp_bilinear": (cuda_ms(lambda: warp(stack, u, v)),
                               cuda_ms(lambda: warp_bilinear_dense(stack, u, v), n=3))}
    say("fulldisk", f"warp_bilinear {h}x{w}x6: bit-exact True, "
                    f"{times['warp_bilinear'][0]:.3f} ms (plain {times['warp_bilinear'][1]:.3f} ms)")

    # both PCG passes at every level's shape: at 5424^2 on systems assembled
    # around the final flow (timed), below on random systems
    rng = np.random.default_rng(3)
    for k in reversed(range(cfg.kiters)):
        factor = float(np.float32(cfg.scale_factor) ** (cfg.kiters - k - 1))
        lh, lw = zoom_size(h, factor), zoom_size(w, factor)
        for quad in (True, False):
            mode = "quad" if quad else "robust"
            ab = torch.tensor([0.5, 0.25], device=dev)
            if k == cfg.kiters - 1:
                sysm = assemble(g1, g2, gx1, gy1, gx2, gy2, gxx, gxy, gyy, u, v, z, z,
                                1.0 if quad else 0.0, 5.0, 0.2, 0.0, True,
                                warp_fn=warp, stack=stack)
                cf = coef_stack(sysm, quad)
                r = torch.stack([sysm.bu, sysm.bv])
                x = torch.zeros_like(r)
                p = (1.0 / cf[:2]) * r
                _, _, ap, _ = pcg_pass_a(x, r, p, cf, ab)
                state = (x, r, p, ap)
            else:
                cf = coef_stack(pcg_system(lh, lw, quad, dev), quad)
                state = state_planes(rng, lh, lw, dev)
            equal, ea, eb, part_rel = compare_passes(*state, cf, ab)
            report["pcg_pass_a"]["max_abs_err"] = max(report["pcg_pass_a"]["max_abs_err"], ea)
            report["pcg_pass_b"]["max_abs_err"] = max(report["pcg_pass_b"]["max_abs_err"], eb)
            line = f"{lh}x{lw} {mode}: passes A/B bit-exact {equal}"
            if k == cfg.kiters - 1:
                x, r, p, ap = state
                alpha = ab[:1].clone()
                ta = (cuda_ms(lambda: pcg_pass_a(x, r, p, cf, ab)),
                      cuda_ms(lambda: pcg_pass_a_plain(x, r, p, cf, ab), n=3))
                tb = (cuda_ms(lambda: pcg_pass_b(r, ap, cf, alpha)),
                      cuda_ms(lambda: pcg_pass_b_plain(r, ap, cf, alpha), n=3))
                times[f"pcg_pass_a_{mode}"], times[f"pcg_pass_b_{mode}"] = ta, tb
                line += (f", pcg_pass_a {ta[0]:.3f} ms (plain {ta[1]:.3f} ms), "
                         f"pcg_pass_b {tb[0]:.3f} ms (plain {tb[1]:.3f} ms)")
            say("fulldisk", line)
            if not equal:
                raise AssertionError(f"fulldisk: PCG passes {lh}x{lw} {mode} differ "
                                     f"from their plain versions (partial sums rel "
                                     f"{part_rel:.2e})")
    report["_times"] = times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    report = {}
    have = phase_env()
    if "build" in only:
        phase_build()
    if "warp" in only:
        phase_warp(dev, report)
    if "pcg" in only:
        phase_pcg(dev, report)
    if "main" in only:
        phase_main(dev, have["h5py"])
    if "golden" in only:
        phase_golden(dev)
    if "fulldisk" in only:
        phase_fulldisk(dev, report)

    if {"warp", "pcg", "fulldisk"} <= only:
        launches, times = report["_launches"], report["_times"]
        entries = []
        for name, src, replaces, tkey in (
                ("warp_bilinear", WARP_SRC,
                 "octane_tpu/ops/pallas/warp.py:80 _kernel + :284 _stats_kernel",
                 "warp_bilinear"),
                ("pcg_pass_a", PCG_SRC, "octane_tpu/ops/pallas/cg.py:94 _pass_a",
                 "pcg_pass_a_robust"),
                ("pcg_pass_b", PCG_SRC, "octane_tpu/ops/pallas/cg.py:141 _pass_b",
                 "pcg_pass_b_robust")):
            wrapper = "warp" if name == "warp_bilinear" else name
            entries.append({"name": name, "route": "cuda", "source": src,
                            "replaces": replaces, "launches": launches[wrapper][0],
                            "max_abs_err": report[name]["max_abs_err"],
                            "ms": times[tkey][0], "plain_ms": times[tkey][1]})
        print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
