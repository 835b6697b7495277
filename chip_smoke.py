"""Smoke run of the PyTorch/CUDA port (octane_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. environment: torch, CUDA, nvcc, which of triton/h5py/jax are installed
     (the port needs neither h5py nor jax: its files go through its own HDF5
     codec, octane_tpu_torch/io/hdf5.py), the card's name and power limit;
  2. build the CUDA kernels from octane_tpu_torch/csrc (one nvcc per source,
     in parallel);
 2b. io: (a) the codec reads the h5py-made files committed under
     tests/hdf5_fixtures equal to their .npz (tests/torch_fixtures.
     check_hdf5_fixture), timed; (b) the main path through files at full
     disk: the 5424^2 bench pair (truth (2.4, 0) px) as int16 counts,
     written by the codec as two L1b files with Rad chunked 226 x 226,
     shuffled and deflated; per relaxer cli.main(-i1, -i2, -o, --device
     cuda, -solver) (a key's first call: the pair runs eagerly), the
     product read back through the codec and U, V, U_raw, V_raw and Rad
     bit-identical to the in-memory route in this process (the same arrays
     through scene_from_goes_arrays -> compute_flow -> pix2uv, the key's
     second call: its capture and replay), the flow's median within 0.1 px
     of the truth; each stage's wall (read + navcal per image, the flow,
     pix2uv, the write; a device sync at each stage's end), the wall per
     product, the product's bytes, the read and write rates; (c) the 512^2
     fixture pair with codec-written CTH and first-guess files through
     cli.main -i1cth -firstguess -srsal -pd per relaxer, the bilateral
     kernel launched, U, V, Upix, Vpix and CTP bit-identical to the
     in-memory route;
  3. warp kernel vs its plain version: bit-exact samples and flags, exact
     tile statistics, smooth flow, a +-40 px jet and +-40 px noise;
  4. Jacobi-PCG passes vs their plain versions (bit-exact, block partials
     included: the plain versions sum in the kernels' order) and 30-iteration
     solves vs the reference loop flow.cg.pcg_solve (rel <= 5e-4), quad and
     robust; then passes A and B, quad and robust, bit-exact at every level
     shape of the full-disk pyramid (5424^2 .. 678^2) and of a sector's
     (500^2 .. 63^2), each timed from a CUDA graph of back-to-back launches
     (as the solver's replay runs them) beside its bound;
  5. the fused assembly vs its plain version (bit-exact, ||b||^2 partials
     included) at 512^2 and 500x372, GNC steps al1 = 1, 0.5, 0, in both
     layouts: the SOR stack (assemble_cf) and the PCG form (assemble_pcg:
     cf, b and the first-sum partials) on the whole image and on row
     ranges (three bands from their slabs, an unaligned range); torch's
     CUDA division probed (t / 5.0 as a product with the float reciprocal,
     tensor / tensor IEEE-rounded as on the CPU);
  6. the SOR pass kernel (8 sweeps, the 6-sweep remainder, 1 sweep) vs its
     plain version, iterate and residual partials bit-exact, and 30-sweep
     solves of sor_solve_fused with the kernel vs with the plain pass
     (bit-identical) and vs the reference loop flow.cg.sor_solve (rel <=
     2e-5), quad and robust;
 6b. pyramid: a level of the solver pyramid (ops.pyramid, csrc/pyramid.cu)
     vs its plain version, bit for bit (also as int32) at f = 1/2, 1/4,
     1/8, 1/32 on N = 4 and 8 planes of 1001 x 777 and on a 3-row image;
     at 5424^2, N = 4, each full-disk factor timed from a graph beside its
     bound (the rows and columns its windows reach, read once, and the
     level written) and its plain version; a 21696^2 band slab (the
     second of 4 bands, f = 1/32) bit-equal to its plain version and to
     the whole image's rows, timed the same way; then a JSON line
     {"pyramid_level": [rows of the kernel table]} (its launches a pair:
     phase 10's replayed 5424^2 pairs, kiters - 1 each, no plain call);
  7. the main path on the 512^2 product fixture pair (tests/golden/
     product_512.npz): codec-written L1b files through the CLI, the product
     read back through the codec; with the default PCG solver the
     shorts within 1 count and mostly exact (EXACT_SHARE), with the SOR
     solver the pixel-short medians within 5 counts of the true shift (300,
     -150); each path launched its kernels and called no plain version;
  8. the 256^2 oracle fixture (variational_256.npz), both solvers: mean EPE
     < 0.01 px, max < 0.1 px;
  9. SRSAL: the bilateral kernel vs its plain version within rel 1e-5
     (max |d| / max |plain|, each of u and v; docs/PARITY.md:91: its
     weights are one base-2 exponent on the card's approximate ex2, not
     bit-exact) at 512^2, 500x372 (ragged tiles), 64x80 (reflect edges in
     every tile, also with the 13-tap p = 6 window), each with a uniform
     CTH and one of 2-km steps; the CTH + first-guess + SRSAL product path on the
     512^2 fixture pair (scene_from_goes_arrays -> cth_onto_scene ->
     first_guess_onto_scene -> compute_flow with do_cth, do_firstguess and
     do_srsal), per solver: the bilateral kernel launched and no plain
     version called, u_pix equal to srsal_smooth of the unsmoothed flow
     (kernel against kernel), CTP the regridded CTH as int16; the CTH
     regrid of a band-2-like 2000^2 scene from a 500^2 field, bicubic and
     nearest, against the same call on the CPU (rel <= 1e-5);
 10. a GOES full-disk 5424^2 pair (kiters=4) through variational_flow (the
     timed call a replay of its captured program, which counts kiters - 1
     pyramid launches and no plain call) and
     pix2uv, per solver, timed with CUDA events with the kernels and with
     their plain versions (the solver's internal plain route); the two flows
     must be bit-identical and the median flow within 0.1 px of the truth.
     Every kernel is held bit-exact against its plain version at every
     pyramid level's shape (5424^2 .. 678^2) and timed beside it at 5424^2
     with its bound (bytes over 3.35 TB/s or operations over 67 TFLOP/s);
     the warp (with F.grid_sample's time as its yardstick) and the SOR pass
     (8 sweeps and the 6-sweep remainder, quad and robust) are timed with
     their bounds at every level's shape, and so is the PCG form of the
     assembly (quad and robust, its plain version at 5424^2); each
     solver's 5424^2 flow is
     smoothed by SRSAL with a synthetic 5424^2 CTH (band 13: no regrid),
     kernel vs plain within rel 1e-5, timed beside its bound and the floor
     of one ex2 per tap at the SFU's rate;
 11. hybrid (patch-match initialization + variational refinement): the
     zero-guess search kernel (ops.patch_match, csrc/patch_match.cu)
     torch.equal to its plain version on the card (u, v and the
     whole-pixel winners) at (rad, srad) = (2, 2), (1, 1), (2, 3) and,
     through the any-radius kernel, (3, 4) on the 5424^2 bench pair, the
     1024^2 sector, 97 x 131, a 3-row image and a band of rows 1357:2712
     of 5424^2, one launch each; at 5424^2 the kernel's ms beside its
     bound (octbench's roofline.patch_match_bound_s) and the plain
     version's ms (rad 2, srad 2 is the kernels line's entry); at
     1024^2 on the bench pair, patch_match_flow on the card equal to the
     same call on the CPU (whole-pixel offsets everywhere, u and v within
     1e-5 px), and per solver the refinement of its flow, replayed
     through its program, torch.equal to the first call and to the plain
     route; at 5424^2, kernels only, per solver, a
     hybrid pair through compute_flow (algorithm="hybrid"; the warm-up),
     then the same two calls (patch_match_flow, variational_flow) timed
     apart with CUDA events and counted (each kernel of the solver and
     one search kernel launched, no other kernel, no plain version
     called), their flow equal
     to compute_flow's and its interior median within 0.1 px of the truth
     (2.4, 0): the pair's ms, patch-match's share, peak memory; the
     first-guess gather path at a 2000^2
     mesoscale-sector shape with a constant guess (1.4, 0.6) px, timed,
     its median within 0.5 px (the parabola's pixel locking) of the truth;
 12. interp: interpolate_frame on the SOR 5424^2 hybrid flow and its pair
     at frac 1/3 and 2/3 (deltat 200 s of a 600-s pair), timed with CUDA
     events: no -999 hole left after the fill (its steps and time, one
     step's and one host check's time printed), the occlusion shares, the
     frames requantized to counts on the host as interpolate_sequence
     does; on a 1024^2 crop the card against the CPU: the splat (ut, vt)
     and the occlusion mask equal, the image within 1e-4.
 13. multichannel: (a) at C = 2 and 3 channels (the bench pair plus
     channels of other seeds) the warp (K = 6C planes) and the fused
     assembly (both layouts) bit-exact against their plain versions at
     every pyramid
     level's shape, 5424^2 .. 678^2, and at 1024^2 variational_flow's
     replay torch.equal to its first call and to the plain route, per
     relaxer; (b) a
     three-channel GOES full-disk pair through the array halves: channel 1
     the bench pair as band-13 counts at 5424^2 (scene_from_goes_arrays),
     channel 2 band-3-like 1-km counts at 10848^2 zoomed out onto it,
     channel 3 band-8-like counts at 5424^2 (channel_onto_scene); per
     relaxer compute_flow, kernels only, timed with CUDA events after a
     warm-up: each kernel of the relaxer launched, no plain version called,
     the interior median within 0.1 px of (2.4, 0), the pair's ms and peak
     memory; the warp (K = 18) and the assembly (C = 3, both layouts)
     timed at 5424^2 beside their bounds; (c) channel_onto_scene's zoom-in branch at a
     2000^2 mesoscale shape (a 500^2 channel onto a band-2-like channel 1)
     and the zoom-out branch of (b) against the same calls on the CPU: rel
     <= 1e-5, the pseudo-counts equal;
 14. flatgrid: polar pairs at the pole (lat1 90) and at lat1 60 and a
     mercator pair, 2048^2 (a correctness shape, not a published grid),
     through scene_from_flat_arrays -> compute_flow (SOR) -> u_ms/v_ms:
     the SOR kernels launched, no plain version called; lat/lon within
     1e-9 deg and u_ms/v_ms within 1e-9 m/s of the same functions on the
     CPU for the same flow;
 15. sequence: bench.py config 5 (12 frames of 500^2, kiters 3, lambdac
     0.05), per relaxer, the pairs chained through compute_flow(...,
     first_guess=previous flow) over in-memory scenes, as run_sequence's
     loop chains them: each pair torch.equal to the plain route's chain, ms
     per pair; then run_sequence over the frames as codec-written L1b files
     with a checkpoint, stopped after 2 pairs and resumed, its products
     equal (read through the codec) to an uninterrupted run's.
 16. mesh: (a) the band forms of the mesh path (warp_band, sor_pass_band at
     8 and 6 sweeps quad and robust, pcg_pass_a_band quad and robust,
     bilateral_band; the PCG form of the assembly on each band's slab,
     quad and robust) at 5424^2 on 4 bands of 1356 rows and on an uneven
     split (MESH_SPLIT), each against its plain version (bit-exact; the
     bilateral within rel 1e-5) and against the whole-image kernel's rows
     (bit-exact), timed on the 4 bands beside the bound of every band's
     slab, ghost rows included (the band warp also beside F.grid_sample
     on each band's slab); (b) the full-disk pair per relaxer through
     the banded program (parallel.sharded.sharded_flow_program: a key's
     first call eager, its second the capture) on a (1, 4) mesh of cuda:0
     and sharded_pix2uv, kernels only, the replay in turns with the eager
     banded route and the single-device replay (graph, eager, single,
     single, eager, graph; 3 pairs each): ms min / median, the first
     calls' and the capture's seconds, the pools' bytes, peaks, host reads
     (the solver's and the warp's reach test: 0 replayed, at most 144 /
     1080 + 36 eager), each band form of the relaxer launched and no plain
     version called, the replay's launches (from its device tallies) equal
     to the eager route's, the replay torch.equal to the eager banded flow
     and within 1e-3 px of the single-device flow (bit-identical printed),
     the interior median within 0.1 px of (2.4, 0), sharded_pix2uv's
     page-locked host planes equal to pix2uv's; (b') at 1024^2 per relaxer
     the replay torch.equal to the first call, the eager and the plain
     banded routes, launches equal, and a
     reach case (a 20-px first guess, halo_warp 4) whose wide body runs at
     every level, the same equalities held; (c) sharded_srsal of the banded
     SOR flow with the 5424^2 CTH within rel 1e-5 of srsal_smooth; (d)
     where the machine has several cards, the pair per relaxer on a (1, n)
     mesh with band i on cuda:i through the banded program (route "graph":
     one capture across the cards), its replay in turns with the eager
     banded route of the same mesh (graph, eager, eager, graph; 2 pairs
     each): ms min / median, the first calls' and the capture's seconds,
     pool bytes and peaks per card, with SOR each card's idle share
     (torch.profiler) replayed and eager, host reads (0 replayed), launches
     equal, the replay
     torch.equal to the eager route and to (b)'s one-card banded replay
     (else it says on its own line that it did not run).
 17. dist: the multi-process path (parallel.distributed, -nprocs).  (a) 2
     processes spawned on cuda:0 in a gloo group (their rows staged through
     pinned host memory), and where the machine has several cards one
     process per card over NCCL (else it says it did not run).  Each builds
     its row block of the 5424^2 bench pair through
     scene_from_goes_arrays(row_range=) (equal to the whole arrays' rows),
     then per relaxer runs distributed_variational_flow through the
     process's program (route "eager" over gloo, "graph" over NCCL: its
     first call eager, its second the capture), timed with CUDA events
     between barriers: over gloo one pair after two warm-ups; over NCCL the
     replay in turns with the program's eager route (graph, eager, eager,
     graph), the capture's seconds and pool bytes, gated on route "graph", 0 host reads
     replayed and launches and counts equal to the eager route's; its rows
     torch.equal to the single-device flow and to the single-process
     banded flow on a (1, n) mesh, each band kernel of the relaxer launched
     and no plain version called, ms, peak memory, host reads, the
     messages and bytes it sent and its collectives and the bytes they
     gathered from it (a replay's from its capture); pix2uv_bands equal to pix2uv's rows,
     srsal_bands within rel 1e-5 of srsal_smooth's rows, and on the SOR
     flow one interpolate_bands frame equal to interpolate_frame's rows.
     A process that fails or hangs fails the phase.  (b) At 5424^2 on a
     (1, 4) mesh of cuda:0, patch_match_flow_sharded equal to
     patch_match_flow (one search kernel launch for the image and one a
     band, no plain search) and sharded_interpolate_frame equal to
     interpolate_frame.  (c) -nprocs 2 through the CLI over gloo on one
     card (part files, process 0's merge) on the codec-written 512^2
     fixture, its product equal (read through the codec) to the
     single-process -mesh 2x1 product.
 18. program: the captured pair (flow.variational.flow_program; every
     variational_flow call on the card above goes through it: a key's
     first call runs the pair eagerly, its second captures the program,
     and it and later calls replay it, so the gates of phases 8, 10, 11,
     13 and 15 hold the replayed graph, and phase 7's single CLI pair the
     eager first call).  (a) At
     512^2 and 500x372 per relaxer, kiters 3, at the default tolerance and
     at one that stops the relaxer early, and for a second input of the
     same shape: the replay torch.equal to the eager kernel route
     (_coarse_to_fine) and to the plain route, the same device count of
     iterations (PCG) or passes (SOR), no host read (the drivers'
     counters, and torch.cuda.set_sync_debug_mode("error") around the
     replay).  (b) The 5424^2 pair per relaxer (kiters 4) in turns (eager,
     graph, graph, eager; 3 pairs each): pair ms (CUDA events and host
     wall, min and median), the first (eager) and second (capture +
     replay) calls' and the capture + instantiation's seconds, host syncs per pair, each kernel's launches
     (the graph's from its device count) equal to the eager route's, peaks
     and the bytes the programs' pools reserve, the flows equal to each
     other and to the plain route.  (c) Config 5's sequence per relaxer through the program
     against the eager chain: every pair torch.equal, ms per pair.
 19. tracer (utils.profiling; csrc/stamp.cu is instrumentation, not a
     ported kernel): per relaxer, a 512^2 program (kiters 3) captured with
     the tracer on and replayed once: its stamps in order, each on the
     host clock at or after the replay's enqueue less 20 us, the round
     counts summing to the pair's, the flow torch.equal to the untraced
     program's, whose replay launches no stamp.
Every phase's programs are dropped after it (clear_program_cache).
The line before the last is the kernels' JSON record (launches on the
5424^2 pairs and the SRSAL product path, launches on the 5424^2 hybrid
pair and on the three-channel 5424^2 pair, max |d|, ms, plain ms, bound ms
and what bounds it, library ms; the warp and the assembly also at C = 3;
the band forms with their launches on the banded pairs and banded SRSAL,
both assemblies and pass B also ``mesh_launches``, and with the dist phase
``dist_launches``, per process); the last line is
{"ok": true, "device": {...}}.  A phase that fails, a codec error
included, fails the run.  ``--only`` runs a subset,
e.g. ``--only build,warp,pcg,assemble,sor`` or ``--only
env,build,multichannel,flatgrid,sequence``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FULLDISK = 5424         # the GOES ABI full-disk band-13 grid
PHASES = ("env", "build", "io", "warp", "pcg", "assemble", "sor", "pyramid", "main", "golden",
          "srsal",
          "fulldisk", "hybrid", "interp", "multichannel", "flatgrid", "sequence", "mesh", "dist",
          "program", "tracer")
SECTOR = 1024           # the hybrid and interp phases' card-against-CPU checks
MESO = 2000             # a mesoscale-sector shape for the first-guess gather path
FLAT = 2048             # the flat-grid phase's correctness shape
KERNELS = (   # (JSON name, wrapper, source, TPU kernel, time key at 5424^2)
    ("warp_bilinear", "warp", "octane_tpu_torch/csrc/warp.cu",
     "octane_tpu/ops/pallas/warp.py:80 _kernel + :284 _stats_kernel", "warp_bilinear"),
    ("pcg_pass_a", "pcg_pass_a", "octane_tpu_torch/csrc/pcg.cu",
     "octane_tpu/ops/pallas/cg.py:94 _pass_a", "pcg_pass_a_robust"),
    ("pcg_pass_b", "pcg_pass_b", "octane_tpu_torch/csrc/pcg.cu",
     "octane_tpu/ops/pallas/cg.py:141 _pass_b", "pcg_pass_b_robust"),
    ("assemble_cf", "assemble_cf", "octane_tpu_torch/csrc/assemble.cu",
     "octane_tpu/ops/pallas/assemble.py:52 _kernel", "assemble_cf_robust"),
    ("assemble_pcg", "assemble_pcg", "octane_tpu_torch/csrc/assemble.cu",
     "octane_tpu/ops/pallas/assemble.py:52 _kernel (PCG layout: the XLA-fused assembly of "
     "octane_tpu/flow/variational.py:78-103)", "assemble_pcg_robust"),
    ("sor_pass", "sor_pass", "octane_tpu_torch/csrc/sor.cu",
     "octane_tpu/ops/pallas/sor.py:257 _kernel", "sor_pass_robust"),
    ("bilateral", "bilateral", "octane_tpu_torch/csrc/bilateral.cu",
     "octane_tpu/ops/pallas/bilateral.py:45 _kernel", "bilateral"),
    ("patch_match_search", "patch_match", "octane_tpu_torch/csrc/patch_match.cu",
     "XLA in octane_tpu/flow/patch_match.py:123 _patch_match_local, no Pallas kernel",
     "patch_match_search"),
)
MESH_KERNELS = (   # the band forms: (JSON name = wrapper, source, TPU kernel, path of
    # its launches: the banded pair of that relaxer, or banded SRSAL)
    ("warp_band", "octane_tpu_torch/csrc/warp.cu",
     "octane_tpu/parallel/sharded.py:68 make_sharded_warp (ops/pallas/warp.py:80 _kernel)", "sor"),
    ("pcg_pass_a_band", "octane_tpu_torch/csrc/pcg.cu",
     "octane_tpu/parallel/cg.py:59 make_sharded_fused_cg (ops/pallas/cg.py:94 _pass_a)", "pcg"),
    ("sor_pass_band", "octane_tpu_torch/csrc/sor.cu",
     "octane_tpu/parallel/sor.py:44 make_sharded_fused_sor (ops/pallas/sor.py:257 _kernel)",
     "sor"),
    ("bilateral_band", "octane_tpu_torch/csrc/bilateral.cu",
     "octane_tpu/parallel/post.py:104 sharded_srsal (ops/pallas/bilateral.py:45 _kernel)",
     "srsal"),
)
SIGPIX2 = -1.0 / (2.0 * 20.0 * 20.0)     # SRSAL's range weight, sigma 20
BILATERAL_REL = 1e-5     # the bilateral kernel vs its plain version (docs/PARITY.md:91)
HBM_BYTES_S = 3.35e12    # H100 SXM device memory rate (data sheet)
FP32_FLOP_S = 67e12      # H100 SXM float32 rate outside the tensor cores
SFU_CLOCK_HZ = 1.98e9    # the SM clock of that rate: 132 SMs x 128 lanes x 2 x 1.98 GHz


def bound(nbytes, flops):
    """(least ms the card could take, what bounds it): the bytes moved over
    the memory rate or the float32 operations over the peak rate."""
    t_mem, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / FP32_FLOP_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


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


def graph_ms(fn, n=40, reps=5):
    """Device milliseconds per call of ``fn``: n calls captured in one CUDA
    graph, launched back to back as the solver's replay launches them (no
    host time between), the median of ``reps`` replays after one warm-up."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return sorted(times)[reps // 2]


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
    say("env", "installed: " + ", ".join(f"{m}={'yes' if v else 'no'}" for m, v in have.items())
        + "; the port needs no h5py (its files go through octane_tpu_torch.io.hdf5) "
          "and no jax")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the flow program's capture: graph IF nodes of its own (csrc/graph.cu),
    # bodies allocating from a MemPool, programs sharing a graph pool
    missing = [name for name in ("MemPool", "use_mem_pool", "graph_pool_handle", "CUDAGraph")
               if not hasattr(torch.cuda, name)]
    if missing:
        raise RuntimeError(f"env: torch {torch.__version__} lacks torch.cuda."
                           f"{', torch.cuda.'.join(missing)}, which the flow program needs")
    say("env", "flow program: torch.cuda.MemPool, use_mem_pool, graph_pool_handle present; "
               "IF nodes from csrc/graph.cu (torch's own conditional-node helper "
               f"{'present' if importlib.util.find_spec('torch._higher_order_ops.cudagraph_conditional_nodes') else 'absent'}"
               ", not used)")


def phase_build():
    from octane_tpu_torch.ops import build

    t0 = time.perf_counter()
    info = build.load_kernels().build_info
    say("build", f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
                 f"(nvcc {info.get('seconds', 0.0):.2f} s)")
    for line in info.get("ptxas", "").splitlines():
        if any(key in line for key in ("registers", "Compiling entry", "spill")):
            say("build", line.strip())


HDF5_FIXTURES = ("earliest", "latest_tracked", "netcdf_l1b")   # tests/hdf5_fixtures
L1B_CHUNKS = (226, 226)  # the NOAA L1b files' Rad tiling at 5424^2


@contextlib.contextmanager
def stage_clock(targets):
    """While the block runs, every call of the functions ``targets``
    [(module, attribute, label)] is timed on the host's clock after a
    device sync at its start and end; yields the list of (label, seconds)
    that the calls append to."""
    times, saved = [], []

    def timed(fn, label):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times.append((label, time.perf_counter() - t0))
            return out
        return call

    for mod, attr, label in targets:
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, timed(getattr(mod, attr), label))
    try:
        yield times
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def phase_io(dev):
    """(a) the committed h5py-made fixtures through the codec; (b) the main
    path through codec-written L1b files at full disk, per relaxer."""
    from octane_tpu_torch import cli, ops, pipeline
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow import dispatcher
    from octane_tpu_torch.flow.dispatcher import compute_flow
    from octane_tpu_torch.io import hdf5
    from octane_tpu_torch.io.readers import read_scene, scene_from_goes_arrays

    fx = load_tests_module("torch_fixtures")
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    n = sum(fx.check_hdf5_fixture(name) for name in HDF5_FIXTURES)
    ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(os.path.getsize(os.path.join(fx.HDF5_FIXTURES, f"{name}.h5"))
                 for name in HDF5_FIXTURES)
    l1b = read_scene(os.path.join(fx.HDF5_FIXTURES, "netcdf_l1b.h5"), OFConfig(), device=dev)
    say("io", f"(a) {len(HDF5_FIXTURES)} h5py-made fixtures ({nbytes} bytes: superblocks 0, "
              f"2 and 3, object headers 1 and 2, symbol-table and dense groups, compact and "
              f"dense attributes, contiguous, compact and chunked storage with deflate, "
              f"shuffle, fletcher32, unwritten chunks) read by the codec equal to their .npz: "
              f"{n} datasets, row slices and attributes in {ms:.1f} ms; the netCDF-4 L1b "
              f"fixture through read_scene on the card: {tuple(l1b.data.shape)}, finite "
              f"{bool(torch.isfinite(l1b.data).all())}")
    if not torch.isfinite(l1b.data).all():
        raise AssertionError("io: the L1b fixture's scene is not finite")

    h = w = FULLDISK
    tmp = tempfile.mkdtemp(prefix="octane_io_")
    try:
        g1, g2 = bench_images(h, w, dev)
        _, x, y, nav, _, t_units, _ = fx.goes_arrays(np.zeros((h, w), np.int16),
                                                     fx.FIXTURE_T0)
        counts = [counts_for(g[0], 13, nav.rad_scale[0], nav.rad_offset[0]) for g in (g1, g2)]
        del g1, g2
        files, times = [], []
        for i, c in enumerate(counts):
            t0 = time.perf_counter()
            files.append(fx.make_goes_file(os.path.join(tmp, f"l1b_{i}.nc"), c, band=13,
                                           t=fx.FIXTURE_T0 + 60.0 * i, chunks=L1B_CHUNKS))
            times.append(time.perf_counter() - t0)
        sizes = [os.path.getsize(f) for f in files]
        say("io", f"(b) {h}x{w} bench pair as int16 counts written by the codec as L1b files "
                  f"(Rad chunked {L1B_CHUNKS[0]}x{L1B_CHUNKS[1]}, shuffle + deflate 1): "
                  f"{sizes[0]} and {sizes[1]} bytes in {times[0]:.2f} and {times[1]:.2f} s "
                  f"({h * w * 2 / 1e6 / times[0]:.1f} MB/s of counts)")
        t0 = time.perf_counter()
        with hdf5.File(files[0]) as f:
            back = f["Rad"][()]
        t_read = time.perf_counter() - t0
        say("io", f"Rad of {files[0].rsplit('/', 1)[1]} read back by the codec alone: "
                  f"{t_read:.3f} s, {h * w * 2 / 1e6 / t_read:.1f} MB/s of counts "
                  f"({sizes[0] / 1e6 / t_read:.1f} MB/s from the file), equal "
                  f"{bool(np.array_equal(back, counts[0]))}")
        if not np.array_equal(back, counts[0]):
            raise AssertionError("io: the codec's Rad differs from the counts written")
        del back
        stages = [(pipeline, "read_scene", "read + navcal"),
                  (dispatcher, "_variational", "flow"),
                  (dispatcher, "pix2uv", "pix2uv"),
                  (pipeline, "write_product", "write")]
        for solver in ("pcg", "sor"):
            out = os.path.join(tmp, f"out_{solver}")
            argv = ["-i1", files[0], "-i2", files[1], "-o", out, "--device", "cuda",
                    "-solver", solver]
            cfg = cli.args_to_config(cli.build_parser().parse_args(argv))
            ops.reset_counters()
            torch.cuda.synchronize()
            with stage_clock(stages) as spent:
                t0 = time.perf_counter()
                if cli.main(argv):
                    raise AssertionError(f"io: cli.main failed ({solver})")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            _check_counters("io", solver)
            product = os.path.join(out, "outfile.nc")
            pbytes = os.path.getsize(product)
            t0 = time.perf_counter()
            with hdf5.File(product) as f:
                got = {k: f[k][()] for k in ("U", "V", "U_raw", "V_raw", "Rad")}
            t_back = time.perf_counter() - t0
            # the in-memory route: the files' arrays, the key's second call
            s1 = scene_from_goes_arrays(counts[0], x, y, dataclasses.replace(nav), cfg, dev,
                                        donav=True, t=fx.FIXTURE_T0, t_units=t_units, band=13)
            s2 = scene_from_goes_arrays(counts[1], x, y, dataclasses.replace(nav), cfg, dev,
                                        donav=False, t=fx.FIXTURE_T0 + 60.0, t_units=t_units,
                                        band=13)
            s1.nav.g2x_offset, s1.nav.g2y_offset = s2.nav.x_offset, s2.nav.y_offset
            compute_flow(s1, s2, cfg.replace(nchannels=1))
            want = {"U": s1.u_wind, "V": s1.v_wind, "U_raw": s1.u_raw, "V_raw": s1.v_raw,
                    "Rad": s1.raw_counts[0]}
            same = {k: bool(np.array_equal(got[k], t.cpu().numpy())
                            and got[k].dtype == np.int16) for k, t in want.items()}
            m = min(512, h // 4)
            med = (float(s1.u_pix[m:-m, m:-m].median()), float(s1.v_pix[m:-m, m:-m].median()))
            by = {}
            for label, sec in spent:
                by.setdefault(label, []).append(sec)
                nth = f" (image {len(by[label])})" if label == "read + navcal" else ""
                say("io", f"{solver} stage {label}{nth}: {sec * 1e3:.1f} ms"
                          + (" (the CLI's single pair runs eagerly: a key captures on its "
                             "second call)" if label == "flow" else ""))
            t_w = sum(by["write"])
            t_r = by["read + navcal"]
            say("io", f"{solver}: wall per product (cli.main, files to product) "
                      f"{wall * 1e3:.1f} ms; product {pbytes} bytes, written at "
                      f"{pbytes / 1e6 / t_w:.1f} MB/s, read back by the codec in "
                      f"{t_back * 1e3:.1f} ms ({pbytes / 1e6 / t_back:.1f} MB/s); inputs read "
                      f"+ navcal at {sizes[0] / 1e6 / t_r[0]:.1f} and "
                      f"{sizes[1] / 1e6 / t_r[1]:.1f} MB/s of file; U, V, U_raw, V_raw, Rad "
                      f"bit-identical to the in-memory route {same}; median flow "
                      f"({med[0]:.4f}, {med[1]:.4f}) px, truth (2.4, 0)")
            if not (all(same.values()) and abs(med[0] - 2.4) < 0.1 and abs(med[1]) < 0.1):
                raise AssertionError(f"io: the {solver} product through files is off")
            del s1, s2, want, got
            shutil.rmtree(out, ignore_errors=True)
        io_cth_firstguess(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("io", f"phase wall {time.perf_counter() - t_phase:.1f} s")


def io_cth_firstguess(dev, tmp):
    """(c) The 512^2 fixture pair with codec-written CTH and first-guess
    files through cli.main -i1cth -firstguess -srsal -pd per relaxer (CTH
    read and regridded, the first guess through uv2pix, the bilateral
    kernel): U, V, Upix, Vpix and CTP bit-identical to the same arrays
    through scene_from_goes_arrays -> cth_onto_scene ->
    first_guess_onto_scene -> compute_flow."""
    from octane_tpu_torch import cli, ops
    from octane_tpu_torch.flow.dispatcher import compute_flow
    from octane_tpu_torch.io import hdf5
    from octane_tpu_torch.io.readers import (cth_onto_scene, first_guess_onto_scene,
                                             scene_from_goes_arrays)

    fx = load_tests_module("torch_fixtures")
    c1, c2 = fx.fixture_counts(0, 0), fx.fixture_counts(3.0, -1.5)
    cth = fx.cth_steps(512, 512)
    frng = np.random.default_rng(9)
    ufg = (100.0 + frng.normal(0, 5, (512, 512))).astype(np.float32)
    vfg = (50.0 + frng.normal(0, 5, (512, 512))).astype(np.float32)
    files = [fx.make_goes_file(os.path.join(tmp, "c1.nc"), c1, chunks=L1B_CHUNKS),
             fx.make_goes_file(os.path.join(tmp, "c2.nc"), c2, t=fx.FIXTURE_T0 + 60.0,
                               chunks=L1B_CHUNKS),
             fx.make_cth_file(os.path.join(tmp, "cth.nc"), cth),
             fx.make_firstguess_file(os.path.join(tmp, "fg.nc"), ufg, vfg)]
    for solver in ("pcg", "sor"):
        out = os.path.join(tmp, f"srsal_{solver}")
        argv = ["-i1", files[0], "-i2", files[1], "-i1cth", files[2], "-firstguess", files[3],
                "-srsal", "-pd", "-o", out, "--device", "cuda", "-solver", solver]
        cfg = cli.args_to_config(cli.build_parser().parse_args(argv)).replace(nchannels=1)
        ops.reset_counters()
        t0 = time.perf_counter()
        if cli.main(argv):
            raise AssertionError(f"io: cli.main -srsal failed ({solver})")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _check_counters("io", solver, "srsal")
        with hdf5.File(os.path.join(out, "outfile.nc")) as f:
            got = {k: f[k][()] for k in ("U", "V", "Upix", "Vpix", "CTP")}
        s1 = scene_from_goes_arrays(*fx.goes_arrays(c1, fx.FIXTURE_T0)[:4], cfg, dev,
                                    donav=True, t=fx.FIXTURE_T0)
        s2 = scene_from_goes_arrays(*fx.goes_arrays(c2, fx.FIXTURE_T0 + 60.0)[:4], cfg, dev,
                                    donav=False, t=fx.FIXTURE_T0 + 60.0)
        # as run_pipeline: uv2pix of the first guess reads image 2's offsets
        s1.nav.g2x_offset, s1.nav.g2y_offset = s2.nav.x_offset, s2.nav.y_offset
        cth_onto_scene(cth, s1, cfg, dev)
        first_guess_onto_scene(ufg, vfg, s1, dev)
        compute_flow(s1, s2, cfg)
        want = {"U": s1.u_wind, "V": s1.v_wind, "Upix": s1.u_pix, "Vpix": s1.v_pix,
                "CTP": s1.ctp}
        same = {k: bool(np.array_equal(got[k], t.cpu().numpy())) for k, t in want.items()}
        say("io", f"(c) {solver}: 512x512 fixture pair + codec-written CTH and first-guess "
                  f"files through cli.main -i1cth -firstguess -srsal -pd in {wall * 1e3:.1f} "
                  f"ms; U, V, Upix, Vpix, CTP bit-identical to the in-memory route {same}")
        if not all(same.values()):
            raise AssertionError(f"io: the {solver} CTH + first-guess + SRSAL product is off")


def phase_warp(dev, report):
    from octane_tpu_torch.ops.warp import warp, warp_bilinear_dense, warp_block_stats

    rng = np.random.default_rng(0)
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
            s, bx, by, stats = warp(fields, u, v, with_stats=True)
            ps, pbx, pby = warp_bilinear_dense(fields, u, v)
            pstats = warp_block_stats(u, v)
            torch.cuda.synchronize()
            err = float((s - ps).abs().max())
            ok = (torch.equal(s, ps) and torch.equal(bx, pbx) and torch.equal(by, pby)
                  and torch.equal(stats, pstats))
            worst = max(worst, err)
            say("warp", f"{h}x{w} {name}: max|d| {err:.3e}, flags/stats equal {ok}")
            if not ok:
                raise AssertionError(f"warp {h}x{w} {name}: kernel differs from plain")
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
    pcg_level_times(dev, report)


PCG_LEVELS = ((FULLDISK, 2712, 1356, 678), (500, 250, 125, 63))   # full disk, a sector


def pcg_pass_bounds(h, w, nc):
    """(bound ms, by) of passes A and B on an (h, w) image with nc
    coefficient planes: A reads x, r, p and the planes and writes x, p', ap;
    B reads r, ap and the diagonals and writes r."""
    plane = h * w * 4
    return (bound((12 + nc) * plane, (20 if nc == 3 else 30) * h * w),
            bound(8 * plane, 14 * h * w))


def pcg_level_times(dev, report):
    """Passes A and B, quad and robust, at every level shape of both
    pyramids: bit-exact to their plain versions, then timed from a graph."""
    from octane_tpu_torch.ops import pcg

    gen = torch.Generator(device=dev).manual_seed(4)

    def uniform(shape, lo, hi):
        return torch.empty(shape, device=dev).uniform_(lo, hi, generator=gen)

    rows = {}
    for side in (n for levels in PCG_LEVELS for n in levels):
        h = w = side
        for quad in (True, False):
            mode = "quad" if quad else "robust"
            nc = 3 if quad else 7
            cf = torch.cat([uniform((2, h, w), 4.5, 9.0), uniform((1, h, w), -0.2, 0.2),
                            uniform((nc - 3, h, w), -1.0, -0.3)])
            x, r, p, ap = (uniform((2, h, w), -10, 10) for _ in range(4))
            ab = torch.tensor([0.37, 0.81], device=dev)
            alpha = ab[:1].clone()
            equal, *_ = compare_passes(x, r, p, ap, cf, ab)
            if not equal:
                raise AssertionError(f"pcg {h}x{w} {mode}: a pass differs from its plain version")
            outs = tuple(torch.empty_like(x) for _ in range(3))
            r_out = torch.empty_like(r)
            ta = graph_ms(lambda: pcg.pcg_pass_a(x, r, p, cf, ab, out=outs))
            tb = graph_ms(lambda: pcg.pcg_pass_b(r, ap, cf, alpha, out=r_out))
            (ba, _), (bb, _) = pcg_pass_bounds(h, w, nc)
            say("pcg", f"{h}x{w} {mode}: bit-exact True; pass A {ta:.4f} ms ({100 * ba / ta:.1f} % "
                       f"of {ba:.4f}), pass B {tb:.4f} ms ({100 * bb / tb:.1f} % of {bb:.4f})")
            rows[f"{h}x{w}_{mode}"] = {"pass_a_ms": ta, "pass_b_ms": tb, "pass_a_bound_ms": ba,
                                       "pass_b_bound_ms": bb}
            del cf, x, r, p, ap, outs, r_out
    report["_pcg_levels"] = rows


def sample_stack(g2):
    """The warp's source stack [geo2, gx2, gy2, gxx, gxy, gyy] of a level."""
    from octane_tpu_torch.core.gradients import gradient_4th

    gx2, gy2 = gradient_4th(g2)
    gxx, _ = gradient_4th(gx2)
    gxy, gyy = gradient_4th(gy2)
    return torch.cat([g2, gx2, gy2, gxx, gxy, gyy]).contiguous()


def assembly_inputs(g1, stack, u, v):
    """One GNC round's assembly inputs at (u, v): the warp kernel's samples
    of the level's sample stack, the stack [geo1, gx1, gy1] and hint fields."""
    from octane_tpu_torch.core.gradients import gradient_4th
    from octane_tpu_torch.ops.warp import warp

    gx1, gy1 = gradient_4th(g1)
    u, v = u.contiguous(), v.contiguous()
    samples, bc_x, bc_y = warp(stack, u, v)
    return samples, bc_x, bc_y, torch.cat([g1, gx1, gy1]).contiguous(), u, v, 0.5 * u, 0.5 * v


ASM_SCALARS = (0.05, 5.0, 0.2)     # lambdac, alpha, lambda / alpha


def compare_assembly(inputs, al1):
    """The fused assembly, kernel vs plain version: (bit-equal, max |d|)."""
    from octane_tpu_torch.ops.assemble import assemble_cf, assemble_cf_plain

    args = (*inputs, al1, *ASM_SCALARS, True)
    kcf, kpart = assemble_cf(*args)
    pcf, ppart = assemble_cf_plain(*args)
    torch.cuda.synchronize()
    return (torch.equal(kcf, pcf) and torch.equal(kpart, ppart),
            float((kcf - pcf).abs().max()))


def compare_assembly_pcg(inputs, al1, rows=None):
    """The PCG form of the assembly, kernel vs plain version, on ``rows``:
    ((cf, b, partials) bit-equal, max |d| of cf and b)."""
    from octane_tpu_torch.ops.assemble import assemble_pcg, assemble_pcg_plain

    args = (*inputs, al1, *ASM_SCALARS, True, rows)
    k, q = assemble_pcg(*args), assemble_pcg_plain(*args)
    torch.cuda.synchronize()
    return (all(torch.equal(a, b) for a, b in zip(k, q)),
            max(float((a - b).abs().max()) for a, b in zip(k[:2], q[:2])))


def pcg_assembly_bound(nplanes_in, quad, h, w):
    """The PCG form's bound at (h, w): ``nplanes_in`` float planes (9C + 4)
    and the two flag bytes read, 5 (quad) or 9 planes written, ~150
    operations per pixel with the first sums; as the SOR layout's count."""
    return bound(((nplanes_in + (5 if quad else 9)) * 4 + 2) * h * w, 150 * h * w)


def compare_pass(x, cf, sweeps=(8, 6)):
    """The SOR pass kernel vs its plain version for each count of sweeps:
    (iterate and residual partials bit-equal, max |d|)."""
    from octane_tpu_torch.ops.sor import sor_pass, sor_pass_plain

    equal, err = True, 0.0
    for k in sweeps:
        kx, kpart = sor_pass(x, cf, k)
        px, ppart = sor_pass_plain(x, cf, k)
        torch.cuda.synchronize()
        equal = equal and torch.equal(kx, px) and torch.equal(kpart, ppart)
        err = max(err, float((kx - px).abs().max()))
    return equal, err


def bench_images(h, w, dev):
    """bench.py's synthetic pair (true flow u = 2.4 px, v = 0) on the card."""
    im1, im2 = load_tests_module("torch_fixtures").bench_pair(h, w)
    return torch.from_numpy(im1[None]).to(dev), torch.from_numpy(im2[None]).to(dev)


def noisy_flow(h, w, dev, seed):
    """The 2.4-px shift with +-3 px of noise: some samples leave the grid."""
    rng = np.random.default_rng(seed)
    u = 2.4 + rng.uniform(-3, 3, (h, w))
    v = rng.uniform(-3, 3, (h, w))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (u, v))


def phase_assemble(dev, report):
    t = torch.linspace(-4.0, 4.0, 4097, device=dev)
    probe = torch.equal(t / 5.0, t * float(np.float32(1.0) / np.float32(5.0)))
    say("assemble", f"torch CUDA t / 5.0 equals t * float32(1 / 5.0): {probe}")
    # the PCG form's bu / a1: a tensor-by-tensor division, IEEE-rounded on
    # the card as on the CPU
    rng = np.random.default_rng(7)
    num = torch.from_numpy((rng.normal(0, 1, 1 << 20) * 10.0 ** rng.uniform(-6, 6, 1 << 20))
                           .astype(np.float32))
    den = torch.from_numpy(rng.uniform(0.5, 4e3, 1 << 20).astype(np.float32))
    div = torch.equal((num.to(dev) / den.to(dev)).cpu(), num / den)
    say("assemble", f"torch CUDA tensor / tensor equals the CPU's IEEE division on 2^20 "
                    f"pairs: {div}")
    worst = worst_pcg = 0.0
    for (h, w) in ((512, 512), (500, 372)):
        g1, g2 = bench_images(h, w, dev)
        inputs = assembly_inputs(g1, sample_stack(g2), *noisy_flow(h, w, dev, 5))
        for al1 in (1.0, 0.5, 0.0):
            equal, err = compare_assembly(inputs, al1)
            worst = max(worst, err)
            say("assemble", f"{h}x{w} al1={al1}: cf and ||b||^2 partials bit-exact "
                            f"{equal} (max|d| {err:.3e})")
            if not equal:
                raise AssertionError(f"assemble {h}x{w} al1={al1}: kernel differs from plain")
            # the PCG form: the whole image, three bands aligned to the 8-row
            # blocks from their slabs (a ghost row beside each cut) and an
            # unaligned range
            cuts = sorted({0, 8 * -(-h // 24), 8 * -(-2 * h // 24), h})
            ok, err = compare_assembly_pcg(inputs, al1)
            for r0, r1 in list(zip(cuts[:-1], cuts[1:])) + [(3, h - 2)]:
                a0, a1 = max(0, r0 - 1), min(h, r1 + 1)
                slab = tuple(t[..., a0:a1, :].contiguous() for t in inputs)
                for part, rows in ((slab, (r0 - a0, r1 - a0)), (inputs, (r0, r1))):
                    eq, e = compare_assembly_pcg(part, al1, rows)
                    ok, err = ok and eq, max(err, e)
            worst_pcg = max(worst_pcg, err)
            say("assemble", f"{h}x{w} al1={al1}: assemble_pcg (cf, b, first-sum partials) "
                            f"bit-exact {ok} on the image and on rows {cuts} + [3, {h - 2}) "
                            f"(max|d| {err:.3e})")
            if not ok:
                raise AssertionError(f"assemble {h}x{w} al1={al1}: assemble_pcg differs "
                                     "from plain")
    report["assemble_cf"] = {"max_abs_err": worst}
    report["assemble_pcg"] = {"max_abs_err": worst_pcg}


def phase_sor(dev, report):
    from octane_tpu_torch.flow.cg import sor_solve
    from octane_tpu_torch.ops.sor import build_cf, sor_pass_plain, sor_solve_fused

    rng = np.random.default_rng(6)
    worst = 0.0
    for (h, w) in ((512, 512), (500, 372)):
        for quad in (True, False):
            s = pcg_system(h, w, quad, dev)
            x = torch.from_numpy(rng.normal(0, 3, (2, h, w)).astype(np.float32)).to(dev)
            equal, err = compare_pass(x, build_cf(s), (8, 6, 1))
            ku, kv = sor_solve_fused(s, 1e-8, 30)
            pu, pv = sor_solve_fused(s, 1e-8, 30, pass_fn=sor_pass_plain)
            tu, tv = sor_solve(s, 1e-8, 30)
            torch.cuda.synchronize()
            same = torch.equal(ku, pu) and torch.equal(kv, pv)
            ds = max(rel(ku, tu), rel(kv, tv))
            mode = "quad" if quad else "robust"
            say("sor", f"{h}x{w} {mode}: passes of 8, 6, 1 sweeps bit-exact {equal} "
                       f"(max|d| {err:.3e}), "
                       f"30-sweep driver kernel vs plain bit-identical {same}, "
                       f"vs sor_solve rel {ds:.2e}")
            if not (equal and same and ds <= 2e-5):
                raise AssertionError(f"sor {h}x{w} {mode}: outside the budget")
            worst = max(worst, err)
    report["sor_pass"] = {"max_abs_err": worst}


def pyramid_bound(img, s0, h, factor, rows):
    """(bound ms, by) of level rows ``rows`` of an h-row image from ``img``,
    its rows from ``s0``: the rows and columns of ``img`` that the level's
    windows reach, read once, and the level written; 2 fs multiplies and
    adds a horizontal sum (one a reached row and kept column) and an
    output."""
    from octane_tpu_torch.core.gaussian import solver_filtsize
    from octane_tpu_torch.core.zoom import pyramid_index, zoom_size

    fs = solver_filtsize(factor)
    n, hs, w = img.shape
    ridx = pyramid_index(*rows, h, factor, img.device) - s0
    cidx = pyramid_index(0, zoom_size(w, factor), w, factor, img.device)

    def reached(idx, size):
        lo = (idx - fs).clamp(0, size - 1)
        hit = torch.zeros(size + 1, dtype=torch.int32, device=idx.device)
        hit.index_add_(0, lo, torch.ones_like(lo, dtype=torch.int32))
        hit.index_add_(0, (idx + fs).clamp(max=size), -torch.ones_like(lo, dtype=torch.int32))
        return int((hit.cumsum(0)[:size] > 0).sum())

    nrows, ncols = reached(ridx, hs), reached(cidx, w)
    out = n * ridx.numel() * cidx.numel()
    return bound(4 * (n * nrows * ncols + out), 4 * fs * (n * nrows * cidx.numel() + out))


def phase_pyramid(dev):
    from octane_tpu_torch.core.zoom import pyramid_rows, zoom_size
    from octane_tpu_torch.ops.pyramid import pyramid_level, pyramid_level_plain

    def same(a, b):
        return torch.equal(a, b) and torch.equal(a.view(torch.int32), b.view(torch.int32))

    gen = torch.Generator(device=dev).manual_seed(23)
    for (n, h, w) in ((4, 1001, 777), (8, 1001, 777), (4, 3, 40)):
        img = torch.rand((n, h, w), generator=gen, device=dev) * 255
        for f in (0.5, 0.25, 0.125, 1 / 32):
            args = (img, 0, h, f, (0, zoom_size(h, f)))
            if not same(pyramid_level(*args), pyramid_level_plain(*args)):
                raise AssertionError(f"pyramid: {n}x{h}x{w} at f = {f} differs from plain")
    say("pyramid", "bit-exact (also as int32) at f = 1/2, 1/4, 1/8, 1/32 on 4 and 8 planes "
                   "of 1001x777 and 4 of 3x40")

    table = []

    def timed(label, args, check):
        k = pyramid_level(*args)
        if not check(k):
            raise AssertionError(f"pyramid: {label} differs")
        ms = graph_ms(lambda: pyramid_level(*args), n=20)
        plain_ms = cuda_ms(lambda: pyramid_level_plain(*args), n=2)
        b_ms, by = pyramid_bound(*args)
        row = {"level": label, "factor": args[3], "out": list(k.shape), "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
               "pct_of_bound": 100.0 * b_ms / ms}
        say("pyramid", f"{label}: {ms:.4f} ms, bound {b_ms:.4f} ms ({by}), "
                       f"{row['pct_of_bound']:.1f} % of it; plain {plain_ms:.3f} ms")
        table.append(row)

    img = torch.rand((4, FULLDISK, FULLDISK), generator=gen, device=dev) * 255
    for f in (0.5, 0.25, 0.125):
        args = (img, 0, FULLDISK, f, (0, zoom_size(FULLDISK, f)))
        timed(f"{FULLDISK}^2 x 4, f = {f}", args,
              lambda k, args=args: same(k, pyramid_level_plain(*args)))
    del img
    big, f = 4 * FULLDISK, 1 / 32
    img = torch.rand((4, big, big), generator=gen, device=dev) * 255
    nyy = zoom_size(big, f)
    rows = (nyy // 4 - 21, nyy // 2 + 21)       # band 1 of 4 and ~21 level rows of halo
    s0, s1 = pyramid_rows(big, f, rows)
    slab = img[:, s0:s1].contiguous()
    whole = pyramid_level(img, 0, big, f, (0, nyy))[:, rows[0]:rows[1]]
    del img
    args = (slab, s0, big, f, rows)
    timed(f"{big}^2 band slab rows [{s0}, {s1}) x 4, f = 1/32", args,
          lambda k: same(k, whole) and same(k, pyramid_level_plain(*args)))
    del slab, whole
    torch.cuda.empty_cache()
    # its launches a pair: the fulldisk phase's replayed pairs
    print(json.dumps({"pyramid_level": table}), flush=True)


def _check_counters(phase, *paths):
    """Every kernel of the paths ``paths`` (keys of ops.PATHS) launched, and
    no plain version was called."""
    from octane_tpu_torch import ops

    c = ops.counters()
    say(phase, f"{'+'.join(paths)} path launches (kernel, plain): " + json.dumps(c))
    wanted = {name for path in paths for name in ops.PATHS[path]}
    for name in ops.WRAPPERS:
        launches, plain = c[name]
        if plain != 0 or (name in wanted and launches <= 0):
            raise AssertionError(f"{phase}: {name} launched {launches} times, "
                                 f"plain version called {plain} times")
    return c


def run_fixture(solver, tmp):
    """The 512^2 product fixture pair through the main path: codec-written
    L1b files through cli.main, the product read back through the codec:
    (products as numpy arrays, the route taken)."""
    from octane_tpu_torch.cli import main as cli_main
    from octane_tpu_torch.io import hdf5

    fx = load_tests_module("torch_fixtures")
    out = os.path.join(tmp, f"main_{solver}")
    f1 = fx.make_goes_file(os.path.join(tmp, "g1.nc"), fx.fixture_counts(0, 0), band=13)
    f2 = fx.make_goes_file(os.path.join(tmp, "g2.nc"), fx.fixture_counts(3.0, -1.5), band=13,
                           t=fx.FIXTURE_T0 + 60.0)
    if cli_main(["-i1", f1, "-i2", f2, "-o", out, "--device", "cuda", "-solver", solver]):
        raise AssertionError(f"main: cli.main failed ({solver})")
    with hdf5.File(os.path.join(out, "outfile.nc")) as f:
        return ({k: f[k][()] for k in ("U", "V", "U_raw", "V_raw")},
                "codec-written L1b files -> cli.main -> product read through the codec")


def phase_main(dev):
    from octane_tpu_torch import ops

    fx = load_tests_module("torch_fixtures")
    want = np.load(os.path.join(ROOT, "tests", "golden", "product_512.npz"))
    tmp = tempfile.mkdtemp(prefix="octane_main_")
    for solver in ("pcg", "sor"):
        ops.reset_counters()
        t0 = time.perf_counter()
        got, how = run_fixture(solver, tmp)
        torch.cuda.synchronize()
        say("main", f"{solver}: 512x512 fixture pair via {how} in "
                    f"{time.perf_counter() - t0:.2f} s")
        _check_counters("main", solver)
        if solver == "pcg":
            for var in ("U", "V", "U_raw", "V_raw"):
                d = np.abs(got[var].astype(np.int32) - want[var].astype(np.int32))
                exact = float((d == 0).mean())
                say("main", f"{var}: max short diff {int(d.max())}, exact {exact:.5f}")
                if d.max() > 1 or exact <= fx.EXACT_SHARE[var]:
                    raise AssertionError(f"main: {var} differs from product_512.npz")
        else:
            med = (float(np.median(got["U_raw"])), float(np.median(got["V_raw"])))
            say("main", f"sor: pixel-short medians U_raw {med[0]}, V_raw {med[1]}, "
                        f"truth (300, -150)")
            if abs(med[0] - 300) > 5 or abs(med[1] + 150) > 5:
                raise AssertionError("main: the SOR flow misses the fixture's shift")
    shutil.rmtree(tmp, ignore_errors=True)


def phase_golden(dev):
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow.variational import variational_flow
    from octane_tpu_torch.io.native import epe_stats

    g = np.load(os.path.join(ROOT, "tests", "golden", "variational_256.npz"))
    z = torch.zeros(g["u"].shape, device=dev)
    im1, im2 = (torch.from_numpy(g[k]).to(dev) for k in ("im1", "im2"))
    for solver in ("pcg", "sor"):
        u, v = replayed(lambda: variational_flow(im1, im2, z, z,
                                                 OFConfig(kiters=4, solver=solver)))
        mean, mx, _ = epe_stats(u.cpu().numpy(), v.cpu().numpy(), g["u"], g["v"])
        say("golden", f"variational_256 (kiters=4, {solver}; first call and replay "
                      f"equal): mean EPE {mean:.3e} px, "
                      f"max {mx:.3e} px")
        if not (mean < 0.01 and mx < 0.1):
            raise AssertionError(f"golden: {solver} EPE outside the budget")


def compare_bilateral(u, v, cth, p=18):
    """The bilateral kernel vs its plain version with the 2p+1 taps of
    gaussian_kernel_1d(p / 2, p): (max over u and v of max |kernel - plain|
    / max |plain|, max |d| in px)."""
    from octane_tpu_torch.core.gaussian import gaussian_kernel_1d
    from octane_tpu_torch.ops.bilateral import bilateral, bilateral_plain

    gk = gaussian_kernel_1d(p / 2.0, p)
    k = bilateral(u, v, cth, gk, SIGPIX2)
    q = bilateral_plain(u, v, cth, gk, SIGPIX2)
    torch.cuda.synchronize()
    if not (k.shape == q.shape == (2, *u.shape) and torch.isfinite(k).all()):
        raise AssertionError(f"srsal: bilateral {tuple(u.shape)}: wrong shape or non-finite")
    return max(rel(k[i], q[i]) for i in (0, 1)), float((k - q).abs().max())


def phase_srsal(dev, report):
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow.dispatcher import compute_flow
    from octane_tpu_torch.io.datamodel import NavConstants, Scene
    from octane_tpu_torch.io.readers import (cth_onto_scene, first_guess_onto_scene,
                                             scene_from_goes_arrays, set_goes_grid)
    from octane_tpu_torch.post.srsal import srsal_smooth

    fx = load_tests_module("torch_fixtures")
    rng = np.random.default_rng(8)
    worst = 0.0
    for (h, w) in ((512, 512), (500, 372), (64, 80)):
        u, v = (torch.from_numpy(rng.normal(0, 2, (h, w)).astype(np.float32)).to(dev)
                for _ in range(2))
        for name, c in (("uniform", rng.uniform(0, 12000, (h, w)).astype(np.float32)),
                        ("2-km steps", fx.cth_steps(h, w))):
            for p in ((18, 6) if (h, w) == (64, 80) else (18,)):
                r, err = compare_bilateral(u, v, torch.from_numpy(c).to(dev), p)
                worst = max(worst, err)
                say("srsal", f"bilateral {h}x{w} cth {name} p={p}: rel {r:.3e} (budget "
                             f"{BILATERAL_REL:.0e}), max|d| {err:.3e} px")
                if not r <= BILATERAL_REL:
                    raise AssertionError(f"srsal: bilateral {h}x{w} p={p} outside the budget")
    report["bilateral"] = {"max_abs_err": worst}

    # the product path on the 512^2 fixture pair through the array halves
    c1, c2 = fx.fixture_counts(0, 0), fx.fixture_counts(3.0, -1.5)
    cth = fx.cth_steps(512, 512)
    frng = np.random.default_rng(9)
    ufg = (100.0 + frng.normal(0, 5, (512, 512))).astype(np.float32)
    vfg = (50.0 + frng.normal(0, 5, (512, 512))).astype(np.float32)
    def product(cfg):
        s1 = scene_from_goes_arrays(*fx.goes_arrays(c1, fx.FIXTURE_T0)[:4], cfg, dev,
                                    donav=True, t=fx.FIXTURE_T0)
        s2 = scene_from_goes_arrays(*fx.goes_arrays(c2, fx.FIXTURE_T0 + 60.0)[:4], cfg,
                                    dev, donav=False, t=fx.FIXTURE_T0 + 60.0)
        s1.nav.g2x_offset, s1.nav.g2y_offset = s2.nav.x_offset, s2.nav.y_offset
        cth_onto_scene(cth, s1, cfg, dev)
        first_guess_onto_scene(ufg, vfg, s1, dev)
        return compute_flow(s1, s2, cfg)

    launches = {}
    for solver in ("pcg", "sor"):
        cfg = OFConfig(solver=solver, do_cth=True, do_firstguess=True, do_srsal=True,
                       pixuv=True)
        flat = product(cfg.replace(do_srsal=False))       # the flow SRSAL smooths
        ops.reset_counters()
        t0 = time.perf_counter()
        s1 = product(cfg)
        torch.cuda.synchronize()
        say("srsal", f"{solver}: 512x512 fixture pair + CTH + first guess + SRSAL via "
                     f"scene_from_goes_arrays -> cth_onto_scene -> first_guess_onto_scene "
                     f"-> compute_flow in {time.perf_counter() - t0:.2f} s")
        launches[solver] = _check_counters("srsal", solver, "srsal")
        want = srsal_smooth(flat.u_pix, flat.v_pix, flat.cth)
        same = torch.equal(s1.u_pix, want[0]) and torch.equal(s1.v_pix, want[1])
        moved = float((s1.u_pix - flat.u_pix).abs().max())
        ctp_ok = torch.equal(s1.ctp, s1.cth.to(torch.int16).cpu())
        med = (float(s1.u_pix[64:-64, 64:-64].median()), float(s1.v_pix[64:-64, 64:-64].median()))
        say("srsal", f"{solver}: u_pix = srsal_smooth(unsmoothed flow) {same}, max |smoothed "
                     f"- unsmoothed| {moved:.4f} px, CTP == int16(cth) {ctp_ok}, median "
                     f"smoothed flow ({med[0]:.4f}, {med[1]:.4f}) px, truth (3.0, -1.5)")
        if not (same and moved > 0 and ctp_ok and torch.isfinite(s1.u_pix).all()
                and abs(med[0] - 3.0) < 0.05 and abs(med[1] + 1.5) < 0.05):
            raise AssertionError(f"srsal: the {solver} product path is off")
    report["_launches_srsal"] = launches["pcg"]

    # the CTH regrid of a band-2-like mesoscale scene: 2000^2 from 500^2
    h = w = 2000
    nav = set_goes_grid(NavConstants(grid="goes"), h, w, 2)
    field = fx.cth_steps(nav.max_yc, nav.max_xc, seed=10)
    for bicubic in (True, False):
        cfg = OFConfig(do_cth=True, interp_cth_bicubic=bicubic)
        scenes = {d: cth_onto_scene(field, Scene(nav=nav, data=torch.zeros((1, h, w), device=d)),
                                    cfg, d) for d in (dev, "cpu")}
        got, want = scenes[dev].cth, scenes["cpu"].cth
        r = rel(got.cpu(), want)
        say("srsal", f"CTH regrid {field.shape[0]}^2 -> {h}^2 "
                     f"({'bicubic' if bicubic else 'nearest'}): rel vs the CPU {r:.2e}")
        if not (got.shape == (h, w) and torch.isfinite(got).all() and r <= 1e-5):
            raise AssertionError("srsal: the CTH regrid differs from the CPU's")


def grid_sample_fn(stack, u, v, row0=0):
    """F.grid_sample on the warp's inputs (bilinear, border padding, corners
    aligned), the warp's yardstick: not the same function (no conditional
    clamp past n - 1, no flags), and the port never calls it.  With
    ``row0``, (u, v) are the rows [row0, row0 + rows) of ``stack`` (a
    band's rows in its slab, the band warp's yardstick)."""
    _, h, w = stack.shape
    cols = torch.arange(w, device=u.device, dtype=torch.float32)[None, :]
    rows = torch.arange(row0, row0 + u.shape[0], device=u.device,
                        dtype=torch.float32)[:, None]
    grid = torch.stack([(cols + u) * (2.0 / (w - 1)) - 1.0,
                        (rows + v) * (2.0 / (h - 1)) - 1.0], dim=-1)[None]
    return lambda: torch.nn.functional.grid_sample(
        stack[None], grid, mode="bilinear", padding_mode="border", align_corners=True)


def time_pair(run):
    """Two warm-ups (a flow program's first call runs the pair eagerly, its
    second captures it), then one pair timed with CUDA events after the
    counters are reset: (u, v, ms, peak GiB)."""
    from octane_tpu_torch import ops
    from octane_tpu_torch.parallel import sharded

    run()
    run()
    torch.cuda.synchronize()
    ops.reset_counters()
    sharded.guard_reads.reads = 0
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    u, v = run()
    end.record()
    torch.cuda.synchronize()
    return u, v, start.elapsed_time(end), torch.cuda.max_memory_allocated() / 2 ** 30


def replayed(run):
    """``run()`` twice: a key's first call, which runs the pair eagerly,
    then the capture and first replay of its program; the replay's (u, v),
    after both calls' flows are held torch.equal."""
    fu, fv_ = run()
    u, v = run()
    if not (torch.equal(u, fu) and torch.equal(v, fv_)):
        raise AssertionError("the replayed program's flow differs from the first call's")
    return u, v


def phase_fulldisk(dev, report):
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.core.gradients import gradient_4th
    from octane_tpu_torch.core.zoom import pyramid_downsample, zoom_size
    from octane_tpu_torch.flow.stencil import assemble
    from octane_tpu_torch.flow.program import program_pool_bytes
    from octane_tpu_torch.flow.variational import _coarse_to_fine, variational_flow
    from octane_tpu_torch.nav.winds import pix2uv
    from octane_tpu_torch.ops.assemble import (assemble_cf, assemble_cf_plain, assemble_pcg,
                                               assemble_pcg_plain)
    from octane_tpu_torch.ops.pcg import (pcg_pass_a, pcg_pass_a_plain, pcg_pass_b,
                                          pcg_pass_b_plain)
    from octane_tpu_torch.ops.sor import sor_pass, sor_pass_plain
    from octane_tpu_torch.ops.warp import warp, warp_bilinear_dense

    fx = load_tests_module("torch_fixtures")
    for name, *_ in KERNELS:
        report.setdefault(name, {"max_abs_err": 0.0})
    h = w = FULLDISK
    t0 = time.perf_counter()
    g1, g2 = bench_images(h, w, dev)
    z = torch.zeros((h, w), device=dev)
    _, _, _, nav, *_ = fx.goes_arrays(np.zeros((h, w), np.int16), fx.FIXTURE_T0)
    nav.g2x_offset, nav.g2y_offset = nav.x_offset, nav.y_offset
    say("fulldisk", f"{h}x{w} pair made in {time.perf_counter() - t0:.2f} s")
    mpix = h * w / 1e6
    flows, launches, pair_ms = {}, {}, {}
    for solver in ("pcg", "sor"):
        cfg = OFConfig(kiters=4, solver=solver)
        runs = {"kernels": lambda: variational_flow(g1, g2, z, z, cfg),
                "plain": lambda: _coarse_to_fine(g1, g2, z, z, cfg, plain=True)}
        results = {}
        for label, run in runs.items():
            u, v, ms, peak = time_pair(run)
            results[label] = (u, v)
            c = ops.counters()
            pools = (f" (a replay: the programs' pools reserve "
                     f"{program_pool_bytes(dev) / 2 ** 30:.2f} GiB)" if label == "kernels" else "")
            say("fulldisk", f"{solver} {label}: {ms:.1f} ms per pair, "
                            f"{mpix / (ms / 1e3):.3f} Mpix/s, peak {peak:.2f} GiB{pools}, "
                            f"host syncs {c[f'{solver}_host_syncs']}")
            if label == "kernels":
                pair_ms[solver] = ms
                launches[solver] = _check_counters("fulldisk", solver)
                # the pyramid: one launch a coarse level of the replayed pair
                if launches[solver]["pyramid_level"] != (cfg.kiters - 1, 0):
                    raise AssertionError(f"fulldisk: {solver} pyramid_level (launches, plain "
                                         f"calls) {launches[solver]['pyramid_level']}, not "
                                         f"{(cfg.kiters - 1, 0)}")
            else:
                say("fulldisk", f"{solver} plain route (kernel, plain): " + json.dumps(c))
                if (any(c[n][0] != 0 for n in ops.WRAPPERS)
                        or any(c[n][1] <= 0 for n in ops.PATHS[solver])):
                    raise AssertionError(f"fulldisk: the {solver} plain route launched a kernel")
        (u, v), (pu, pv) = results["kernels"], results["plain"]
        same = torch.equal(u, pu) and torch.equal(v, pv)
        diff = max(float((u - pu).abs().max()), float((v - pv).abs().max()))
        m = min(512, h // 4)
        med_u = float(u[m:-m, m:-m].median())
        med_v = float(v[m:-m, m:-m].median())
        say("fulldisk", f"{solver} kernels vs plain: bit-identical {same} (max |d| "
                        f"{diff:.3e} px); median flow ({med_u:.4f}, {med_v:.4f}) px, "
                        f"truth (2.4, 0)")
        if not (same and abs(med_u - 2.4) < 0.1 and abs(med_v) < 0.1):
            raise AssertionError(f"fulldisk: the {solver} flow differs from the plain "
                                 "route or the truth")
        uw, vw, ur, vr = pix2uv(u, v, nav, 60.0)
        torch.cuda.synchronize()
        if not (torch.isfinite(u).all() and torch.isfinite(v).all()
                and uw.shape == (h, w) and ur.shape == (h, w)):
            raise AssertionError(f"fulldisk: {solver}: non-finite flow or wrong product shape")
        flows[solver] = (u.contiguous(), v.contiguous())
    report["_launches"] = launches

    # the PCG passes' systems at 5424^2 are assembled around the final PCG flow
    u, v = flows["pcg"]
    gx2, gy2 = gradient_4th(g2)
    gxx, _ = gradient_4th(gx2)
    gxy, gyy = gradient_4th(gy2)
    gx1, gy1 = gradient_4th(g1)
    stack = torch.cat([g2, gx2, gy2, gxx, gxy, gyy]).contiguous()
    plane = h * w * 4
    times, bounds, library = {}, {}, {}

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
                bounds[f"pcg_pass_a_{mode}"], bounds[f"pcg_pass_b_{mode}"] = pcg_pass_bounds(
                    h, w, cf.shape[0])
                line += (f", pcg_pass_a {ta[0]:.3f} ms (plain {ta[1]:.3f} ms), "
                         f"pcg_pass_b {tb[0]:.3f} ms (plain {tb[1]:.3f} ms)")
            say("fulldisk", line)
            if not equal:
                raise AssertionError(f"fulldisk: PCG passes {lh}x{lw} {mode} differ "
                                     f"from their plain versions (partial sums rel "
                                     f"{part_rel:.2e})")

    # the SOR path's warp, assembly and pass kernel at every level's shape:
    # at 5424^2 around the final SOR flow, below on the pair downsampled the
    # solver's way with a noisy flow; the warp and the pass timed at each
    # level (their plain versions and the assembly at 5424^2)
    for k in reversed(range(cfg.kiters)):
        factor = float(np.float32(cfg.scale_factor) ** (cfg.kiters - k - 1))
        lh, lw = zoom_size(h, factor), zoom_size(w, factor)
        top = k == cfg.kiters - 1
        if top:
            lg1, lg2 = g1, g2
            lu, lv = flows["sor"]
        else:
            lvl = pyramid_downsample(torch.cat([g1, g2]), factor)
            lg1, lg2 = lvl[:1].contiguous(), lvl[1:].contiguous()
            lu, lv = noisy_flow(lh, lw, dev, k)
        lplane = lh * lw * 4
        lstack = sample_stack(lg2)
        kw, pw = warp(lstack, lu, lv), warp_bilinear_dense(lstack, lu, lv)
        if not all(torch.equal(a, b) for a, b in zip(kw, pw)):
            raise AssertionError(f"fulldisk: warp {lh}x{lw} differs from its plain version")
        err = float((kw[0] - pw[0]).abs().max())
        report["warp_bilinear"]["max_abs_err"] = max(report["warp_bilinear"]["max_abs_err"], err)
        tw = cuda_ms(lambda: warp(lstack, lu, lv))
        tg = cuda_ms(grid_sample_fn(lstack, lu, lv))
        # u, v and the six planes in, six samples and two flag bytes out
        bw = bound(14 * lplane + 2 * lh * lw, 52 * lh * lw)
        line = (f"{lh}x{lw} warp_bilinear x6: bit-exact True, {tw:.3f} ms (bound {bw[0]:.3f} "
                f"ms, F.grid_sample {tg:.3f} ms)")
        if top:
            times["warp_bilinear"] = (tw, cuda_ms(lambda: warp_bilinear_dense(lstack, lu, lv),
                                                  n=3))
            bounds["warp_bilinear"], library["warp_bilinear"] = bw, tg
            line += f", plain {times['warp_bilinear'][1]:.3f} ms"
        say("fulldisk", line)
        inputs = assembly_inputs(lg1, lstack, lu, lv)
        for al1 in (1.0, 0.5):
            mode = "quad" if al1 == 1.0 else "robust"
            equal, ea = compare_assembly(inputs, al1)
            cf, _ = assemble_cf(*inputs, al1, *ASM_SCALARS, True)
            x = 0.1 * torch.stack([lu, lv])
            s_equal, es = compare_pass(x, cf)
            report["assemble_cf"]["max_abs_err"] = max(report["assemble_cf"]["max_abs_err"], ea)
            report["sor_pass"]["max_abs_err"] = max(report["sor_pass"]["max_abs_err"], es)
            if not (equal and s_equal):
                raise AssertionError(f"fulldisk: the SOR path's kernels at {lh}x{lw} {mode} "
                                     "differ from their plain versions")
            nc = cf.shape[0]
            xo = torch.empty_like(x)
            # x and the nc planes in, x out; per sweep and pixel one residual
            # and block solve of 36 (robust) or 28 (quad) flops
            pb = {n: bound((4 + nc) * lplane, n * (28 if al1 == 1.0 else 36) * lh * lw)
                  for n in (8, 6)}
            ts = {n: cuda_ms(lambda: sor_pass(x, cf, n, out=xo)) for n in (8, 6)}
            line = (f"{lh}x{lw} {mode}: assemble_cf and sor_pass (8 and 6 sweeps) bit-exact "
                    f"True; sor_pass 8 sweeps {ts[8]:.3f} ms (bound {pb[8][0]:.3f} ms), "
                    f"6 sweeps {ts[6]:.3f} ms (bound {pb[6][0]:.3f} ms)")
            if top:
                args = (*inputs, al1, *ASM_SCALARS, True)
                ta = (cuda_ms(lambda: assemble_cf(*args)),
                      cuda_ms(lambda: assemble_cf_plain(*args), n=3))
                times[f"assemble_cf_{mode}"] = ta
                # samples, g1 stack, u, v and the hints in, flags as bytes
                bounds[f"assemble_cf_{mode}"] = bound(13 * plane + 2 * h * w + nc * plane,
                                                      150 * h * w)
                times[f"sor_pass_{mode}"] = (
                    ts[8], cuda_ms(lambda: sor_pass_plain(x, cf, 8, out=xo), n=1))
                bounds[f"sor_pass_{mode}"] = pb[8]
                line += (f"; plain 8 sweeps {times[f'sor_pass_{mode}'][1]:.3f} ms; "
                         f"assemble_cf {ta[0]:.3f} ms (plain {ta[1]:.3f} ms)")
            say("fulldisk", line)
            # the PCG form of the assembly at the same inputs, timed beside
            # its bound at every level (its plain version at 5424^2)
            p_equal, ep = compare_assembly_pcg(inputs, al1)
            report["assemble_pcg"]["max_abs_err"] = max(report["assemble_pcg"]["max_abs_err"],
                                                        ep)
            if not p_equal:
                raise AssertionError(f"fulldisk: assemble_pcg at {lh}x{lw} {mode} differs "
                                     "from its plain version")
            pargs = (*inputs, al1, *ASM_SCALARS, True)
            tp = cuda_ms(lambda: assemble_pcg(*pargs))
            bp = pcg_assembly_bound(13, al1 == 1.0, lh, lw)
            line = (f"{lh}x{lw} {mode}: assemble_pcg bit-exact True, {tp:.3f} ms (bound "
                    f"{bp[0]:.3f} ms by {bp[1]}, {100 * bp[0] / tp:.1f} %)")
            if top:
                times[f"assemble_pcg_{mode}"] = (
                    tp, cuda_ms(lambda: assemble_pcg_plain(*pargs), n=3))
                bounds[f"assemble_pcg_{mode}"] = bp
                line += f", plain {times[f'assemble_pcg_{mode}'][1]:.3f} ms"
            say("fulldisk", line)

    # SRSAL on each solver's 5424^2 flow with a synthetic full-disk CTH (band
    # 13: the CTH grid is the image grid, so there is no regrid)
    from octane_tpu_torch.core.gaussian import gaussian_kernel_1d
    from octane_tpu_torch.ops.bilateral import bilateral, bilateral_plain

    cth = torch.from_numpy(fx.cth_steps(h, w)).to(dev)
    for solver, (u, v) in flows.items():
        r, err = compare_bilateral(u, v, cth)
        report.setdefault("bilateral", {"max_abs_err": 0.0})
        report["bilateral"]["max_abs_err"] = max(report["bilateral"]["max_abs_err"], err)
        say("fulldisk", f"bilateral {h}x{w} on the {solver} flow: rel {r:.3e} (budget "
                        f"{BILATERAL_REL:.0e}), max|d| {err:.3e} px")
        if not r <= BILATERAL_REL:
            raise AssertionError(f"fulldisk: bilateral {h}x{w} outside the budget")
    gk = gaussian_kernel_1d(9.0, 18)
    u, v = flows["sor"]
    tb = (cuda_ms(lambda: bilateral(u, v, cth, gk, SIGPIX2), n=5),
          cuda_ms(lambda: bilateral_plain(u, v, cth, gk, SIGPIX2), n=1))
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True)
    times["bilateral"] = tb
    taps = h * w * 37 * 37
    # u, v, cth in, the smoothed pair out; per tap ten operations (a
    # difference, its square, the scale, exp, the weight, two products and
    # three sums); beside it the floor of one ex2 per tap at the SFU's 16 per
    # clock per SM and the 1.98-GHz clock of the 67-TFLOP/s figure
    bounds["bilateral"] = bound(5 * plane, 10 * taps)
    sfu_ms = taps / (16 * torch.cuda.get_device_properties(0).multi_processor_count
                     * SFU_CLOCK_HZ) * 1e3
    shares = ", ".join(f"{100 * tb[0] / (pair_ms[sv] + tb[0]):.1f} % of the {sv} product"
                       for sv in ("sor", "pcg"))
    say("fulldisk", f"bilateral {h}x{w}: {tb[0]:.3f} ms (plain {tb[1]:.3f} ms; bound "
                    f"{bounds['bilateral'][0]:.3f} ms, SFU floor {sfu_ms:.3f} ms; SM clock "
                    f"after timing, max: {clocks.stdout.strip()}); SRSAL is {shares} "
                    f"(pair + SRSAL)")
    report["_times"] = times
    report["_bounds"] = bounds
    report["_library"] = library


def search_block(g1, g2, rad, srad, rows=None):
    """patch_match_search's inputs for rows [r0, r1) of the (h, w) pair (all
    rows by default): the rows with rad / rad + srad + 1 rows beside them,
    the image's edge rows beyond its edges, padded as wide with its edge
    columns, as patch_match_flow_sharded builds a band's."""
    import torch.nn.functional as F

    h = g1.shape[0]
    r0, r1 = rows or (0, h)
    smax = rad + srad + 1
    blocks = []
    for g, p in ((g1, rad), (g2, smax)):
        idx = torch.arange(r0 - p, r1 + p, device=g.device).clamp(0, h - 1)
        blocks.append(F.pad(g[idx][None, None], (p, p, 0, 0), mode="replicate")[0, 0])
    return blocks[0], blocks[1], r0


def compare_patch_match(dev, report):
    """The search kernel against its plain version on the card, bit for bit
    (u, v and their whole-pixel winners), at every shape and radii; at
    5424^2 both timed, the kernel beside its bound (rad 2, srad 2 into the
    report's kernel times)."""
    from octane_tpu_torch.ops.patch_match import patch_match_search, patch_match_search_plain

    from octbench import roofline

    pair = load_tests_module("torch_fixtures").bench_pair
    cases = [("bench", FULLDISK, FULLDISK, None), ("sector", SECTOR, SECTOR, None),
             ("odd", 97, 131, None), ("3-row", 3, 131, None),
             ("band", FULLDISK, FULLDISK, (1357, 2712))]
    for name, h, w, rows in cases:
        im1, im2 = (torch.from_numpy(a).to(dev) for a in pair(h, w))
        for rad, srad in ((2, 2), (1, 1), (2, 3), (3, 4)):
            g1p, g2p, r0 = search_block(im1, im2, rad, srad, rows)
            before = patch_match_search.launches
            ku, kv = patch_match_search(g1p, g2p, rad, srad, h, w, r0)
            launched = patch_match_search.launches - before
            pu, pv = patch_match_search_plain(g1p, g2p, rad, srad, h, w, r0)
            torch.cuda.synchronize()
            err = report.setdefault("patch_match_search", {"max_abs_err": 0.0})
            err["max_abs_err"] = max(err["max_abs_err"], float((ku - pu).abs().max()),
                                     float((kv - pv).abs().max()))
            same = (torch.equal(ku, pu) and torch.equal(kv, pv)
                    and torch.equal(torch.round(ku), torch.round(pu))
                    and torch.equal(torch.round(kv), torch.round(pv)))
            msg = (f"{name} {h}x{w} rows {rows or (0, h)} rad {rad} srad {srad}: kernel "
                   f"({launched} launch) torch.equal to the plain version {same}")
            if name == "bench":
                bound_ms = 1e3 * roofline.patch_match_bound_s({"rad": rad, "srad": srad},
                                                              h, w, 1)
                k_ms = cuda_ms(lambda: patch_match_search(g1p, g2p, rad, srad, h, w), n=10)
                p_ms = cuda_ms(lambda: patch_match_search_plain(g1p, g2p, rad, srad, h, w), n=2)
                msg += (f"; kernel {k_ms:.3f} ms (bound {bound_ms:.4f} ms, "
                        f"{100 * bound_ms / k_ms:.2f} % of it), plain {p_ms:.1f} ms")
                if (rad, srad) == (2, 2):
                    report.setdefault("_times", {})["patch_match_search"] = (k_ms, p_ms)
                    report.setdefault("_bounds", {})["patch_match_search"] = (bound_ms,
                                                                              "operations")
            say("hybrid", msg)
            if not (same and launched == 1):
                raise AssertionError(f"hybrid: the patch-match kernel differs from its plain "
                                     f"version ({name}, rad {rad}, srad {srad})")
        del im1, im2, g1p, g2p, ku, kv, pu, pv


def phase_hybrid(dev, report):
    """Returns the SOR 5424^2 hybrid flow and its pair for the interp phase."""
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow.dispatcher import compute_flow
    from octane_tpu_torch.flow.patch_match import patch_match_flow
    from octane_tpu_torch.flow.variational import _coarse_to_fine, variational_flow
    from octane_tpu_torch.io.datamodel import Scene

    from octbench import roofline

    fx = load_tests_module("torch_fixtures")
    compare_patch_match(dev, report)

    # patch-match on the card against the CPU, and the refinement of its
    # flow with the kernels against the plain route, at 1024^2
    g1, g2 = bench_images(SECTOR, SECTOR, dev)
    pu, pv = patch_match_flow(g1[0], g2[0], None, None, 2, 2)
    cu, cv = patch_match_flow(g1[0].cpu(), g2[0].cpu(), None, None, 2, 2)
    whole = (torch.equal(torch.round(pu).cpu(), torch.round(cu))
             and torch.equal(torch.round(pv).cpu(), torch.round(cv)))
    err = max(float((pu.cpu() - cu).abs().max()), float((pv.cpu() - cv).abs().max()))
    say("hybrid", f"{SECTOR}x{SECTOR} patch_match_flow card vs CPU: whole-pixel offsets "
                  f"equal {whole}, max |d| {err:.3e} px (budget 1e-5)")
    if not (whole and err <= 1e-5):
        raise AssertionError("hybrid: patch-match on the card differs from the CPU")
    for solver in ("pcg", "sor"):
        cfg = OFConfig(kiters=4, solver=solver)
        ku, kv = replayed(lambda: variational_flow(g1, g2, pu, pv, cfg))
        qu, qv = _coarse_to_fine(g1, g2, pu, pv, cfg, plain=True)
        torch.cuda.synchronize()
        same = torch.equal(ku, qu) and torch.equal(kv, qv)
        m = SECTOR // 8
        say("hybrid", f"{SECTOR}x{SECTOR} {solver}: refinement of the patch-match flow, "
                      f"replayed program vs plain route torch.equal {same}; median "
                      f"({float(ku[m:-m, m:-m].median()):.4f}, "
                      f"{float(kv[m:-m, m:-m].median()):.4f}) px, truth (2.4, 0)")
        if not same:
            raise AssertionError(f"hybrid: the {solver} refinement differs from the plain route")

    # the full-disk hybrid pair, kernels only
    h = w = FULLDISK
    g1, g2 = bench_images(h, w, dev)
    _, _, _, nav, *_ = fx.goes_arrays(np.zeros((h, w), np.int16), fx.FIXTURE_T0)
    m = min(512, h // 4)
    # patch-match's bound: the benchmark's count of the search's least work
    # (octbench/rooflines.json "patch_match"), a lower bound on any form of it
    cfg = OFConfig()
    pm_bound_ms = 1e3 * roofline.patch_match_bound_s({"rad": cfg.rad, "srad": cfg.srad},
                                                     h, w, 1)
    launches, flows = {}, {}
    for solver in ("pcg", "sor"):
        cfg = OFConfig(kiters=4, solver=solver, algorithm="hybrid")

        def run():
            return compute_flow(Scene(nav=dataclasses.replace(nav), data=g1, t=fx.FIXTURE_T0),
                                Scene(nav=nav, data=g2, t=fx.FIXTURE_T0 + 60.0), cfg)

        # compute_flow's first call (eager) gives the flow the counted, timed
        # replay of its two calls must equal; its second captures the program
        s1 = run()
        run()
        torch.cuda.synchronize()
        ops.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        ev[0].record()
        u, v = patch_match_flow(g1[0], g2[0], None, None, cfg.rad, cfg.srad)
        ev[1].record()
        ru, rv = variational_flow(g1, g2, u, v, cfg)
        ev[2].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        c = launches[solver] = _check_counters("hybrid", solver, "patch_match")
        path = ops.PATHS[solver] + ops.PATHS["patch_match"]
        stray = {n: c[n][0] for n in ops.WRAPPERS if n not in path and c[n][0]}
        if stray or c["patch_match"] != (1, 0):
            raise AssertionError(f"hybrid: the {solver} pair launched kernels off its "
                                 f"path: {stray}, or not one search kernel: "
                                 f"{c['patch_match']}")
        pm_ms, ref_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        same = torch.equal(ru, s1.u_pix) and torch.equal(rv, s1.v_pix)
        med = (float(ru[m:-m, m:-m].median()), float(rv[m:-m, m:-m].median()))
        pm_med = (float(u[m:-m, m:-m].median()), float(v[m:-m, m:-m].median()))
        say("hybrid", f"{h}x{w} {solver}: patch_match_flow {pm_ms:.1f} ms (bound "
                      f"{pm_bound_ms:.4f} ms, {100 * pm_bound_ms / pm_ms:.3f} % of it) + "
                      f"variational_flow "
                      f"{ref_ms:.1f} ms = {pm_ms + ref_ms:.1f} ms per pair ({wall:.1f} ms "
                      f"wall), patch-match share {100 * pm_ms / (pm_ms + ref_ms):.1f} %, "
                      f"peak {peak:.2f} GiB; equal to compute_flow(hybrid)'s {same}; median "
                      f"({med[0]:.4f}, {med[1]:.4f}) px, truth (2.4, 0); patch-match alone "
                      f"({pm_med[0]:.4f}, {pm_med[1]:.4f}) px")
        if not (same and abs(med[0] - 2.4) < 0.1 and abs(med[1]) < 0.1
                and torch.isfinite(ru).all() and s1.u_wind.shape == (h, w)):
            raise AssertionError(f"hybrid: the {solver} 5424^2 pair is off")
        flows[solver] = (ru, rv)
    report["_launches_hybrid"] = launches

    # the first-guess gather path at a mesoscale-sector shape: the patches
    # centre on trunc(i + 1.4), trunc(j + 0.6), and the flow there is the
    # pair's (2.4, 0)
    g1m, g2m = bench_images(MESO, MESO, dev)
    guess = (torch.full((MESO, MESO), 1.4, device=dev), torch.full((MESO, MESO), 0.6, device=dev))
    ms = cuda_ms(lambda: patch_match_flow(g1m[0], g2m[0], *guess), n=2)
    u, v = patch_match_flow(g1m[0], g2m[0], *guess)
    mm = MESO // 8
    med = (float(u[mm:-mm, mm:-mm].median()), float(v[mm:-mm, mm:-mm].median()))
    say("hybrid", f"{MESO}x{MESO} patch_match_flow with a first guess (1.4, 0.6) px: "
                  f"{ms:.1f} ms, median ({med[0]:.4f}, {med[1]:.4f}) px, truth (2.4, 0)")
    if not (abs(med[0] - 2.4) < 0.5 and abs(med[1]) < 0.5 and torch.isfinite(u).all()):
        raise AssertionError("hybrid: the first-guess patch-match flow misses the truth")
    return (*flows["sor"], g1, g2, nav)


def phase_hybrid_interp(dev, report, interp):
    hybrid = phase_hybrid(dev, report)
    if interp:
        phase_interp(dev, hybrid)


def phase_interp(dev, hybrid):
    from octane_tpu_torch.io.native import requantize
    from octane_tpu_torch.post.temporal import (fill_holes, fill_step, forward_splat,
                                                interpolate_frame)

    u, v, g1, g2, nav = hybrid
    h, w = u.shape
    fracs = (1.0 / 3.0, 2.0 / 3.0)          # deltat 200 s of a 600-s pair
    interpolate_frame(u, v, g1, g2, fracs[0])
    for frac in fracs:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        img, occ = interpolate_frame(u, v, g1, g2, frac)
        ev[1].record()
        torch.cuda.synchronize()
        # the hole fill apart: its steps, its time, one step's and one host
        # check's time
        ut, vt = forward_splat(u, v, g1[0], g2[0],
                               torch.tensor(frac, dtype=torch.float32, device=dev))
        splat_holes = int((ut < -998.0).sum())
        uv, steps = torch.stack([ut, vt]), 0
        while bool((uv[0] < -998.0).any()):
            uv, steps = fill_step(uv), steps + 1
        fu, fv = fill_holes(ut, vt)
        holes = int((fu < -998.0).sum())
        fill_ms = cuda_ms(lambda: fill_holes(ut, vt), n=2)
        step_ms = cuda_ms(lambda: fill_step(uv), n=2)
        check_ms = cuda_ms(lambda: bool((uv[0] < -998.0).any()), n=10)
        share = (torch.bincount(occ.reshape(-1).to(torch.int64), minlength=3).double()
                 / (h * w)).tolist()
        counts = requantize(img[0].cpu().numpy(), 0.0, 255.0, nav.rad_scale[0],
                            nav.rad_offset[0])
        say("interp", f"{h}x{w} frac {frac:.4f}: interpolate_frame {ev[0].elapsed_time(ev[1]):.1f} "
                      f"ms; the splat left {splat_holes} holes, fill_holes closed them in "
                      f"{steps} steps, {fill_ms:.3f} ms (one step {step_ms:.3f} ms, one "
                      f"host check {check_ms:.3f} ms), holes left {holes}; occlusion shares "
                      f"both/only-1/only-2 {share[0]:.5f}/{share[1]:.5f}/{share[2]:.5f}; "
                      f"requantized {counts.dtype} {counts.shape}")
        if not (holes == 0 and torch.equal(fu, uv[0]) and torch.equal(fv, uv[1])
                and img.shape == (1, h, w) and torch.isfinite(img).all()
                and counts.shape == (h, w) and counts.dtype == np.int16):
            raise AssertionError(f"interp: the 5424^2 frame at {frac:.4f} is off")

    # a 1024^2 crop on the card against the CPU
    y0 = x0 = (h - SECTOR) // 2
    crop = (slice(y0, y0 + SECTOR), slice(x0, x0 + SECTOR))
    args = {d: (u[crop].contiguous().to(d), v[crop].contiguous().to(d),
                g1[(slice(None), *crop)].contiguous().to(d),
                g2[(slice(None), *crop)].contiguous().to(d)) for d in (dev, "cpu")}
    for frac in fracs:
        got = {}
        for d, (cu, cv, c1, c2) in args.items():
            t = torch.tensor(frac, dtype=torch.float32, device=d)
            got[d] = (*forward_splat(cu, cv, c1[0], c2[0], t),
                      *interpolate_frame(cu, cv, c1, c2, frac))
        (kut, kvt, kimg, kocc), (put, pvt, pimg, pocc) = [
            [x.cpu() for x in got[d]] for d in (dev, "cpu")]
        splat_eq = torch.equal(kut, put) and torch.equal(kvt, pvt)
        occ_eq = torch.equal(kocc, pocc)
        err = float((kimg - pimg).abs().max())
        say("interp", f"{SECTOR}x{SECTOR} crop frac {frac:.4f}, card vs CPU: splat equal "
                      f"{splat_eq}, occlusion equal {occ_eq}, image max |d| {err:.3e} "
                      f"(budget 1e-4)")
        if not (splat_eq and occ_eq and err <= 1e-4):
            raise AssertionError("interp: the card differs from the CPU")


# ----------------------------------------------------------------------------
# multichannel, flat grids and sequences
# ----------------------------------------------------------------------------

def bench_scene_cuda(h, w, shift, dev, seed, period=(9.0, 7.0)):
    """bench.py's scene (bench.py:62-75) evaluated on the card, with the
    noise from a CUDA generator seeded with ``seed`` and the texture's
    periods ``period``: the extra channels, and inputs too large to make on
    the host in the time."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    return (120.0 * torch.exp(-(((xx - shift - w / 3) ** 2 + (yy - h / 3) ** 2)
                                / (2 * (w / 8) ** 2)))
            + 60.0 * torch.sin((xx - shift) / period[0]) * torch.cos(yy / period[1]) + 50.0
            + 2.0 * torch.randn((h, w), generator=gen, device=dev))


def multichannel_pair(c, h, w, dev):
    """The bench pair (true flow (2.4, 0) px) with c - 1 channels of other
    seeds and textures: two (c, h, w) float32 stacks on the card."""
    g1, g2 = bench_images(h, w, dev)
    for k in range(1, c):
        period = (9.0 + 4 * k, 7.0 - 2 * k)
        g1 = torch.cat([g1, bench_scene_cuda(h, w, 0.0, dev, 2 * k, period)[None]])
        g2 = torch.cat([g2, bench_scene_cuda(h, w, 2.4, dev, 2 * k + 1, period)[None]])
    return g1.contiguous(), g2.contiguous()


def counts_for(img, band, scale, offset):
    """int16 counts (host) whose normalised radiance is ``img``: the
    inverse of the reader's RAW calibration and normalisation."""
    from octane_tpu_torch.core.normalize import band_min_max

    vmin, vmax = band_min_max(band)
    rad = img.double() / 255.0 * (vmax - vmin) + vmin
    return torch.round((rad - offset) / scale).clamp_(-32768, 32767).to(torch.int16).cpu().numpy()


def three_channel_scenes(nav, dev, t0):
    """The three-channel full-disk pair of phase 13 (b) through the array
    halves: (scene1, scene2, the inputs of channel 2 for the CPU check)."""
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.io.readers import channel_onto_scene, scene_from_goes_arrays

    h = w = FULLDISK
    cfg = OFConfig()
    f32 = lambda v: float(np.float32(v))          # noqa: E731
    g = bench_images(h, w, dev)
    band2 = (3, f32(0.02), f32(-1.0))      # band-3-like, 1 km: 10848^2
    band3 = (8, f32(0.0002), f32(3.0))     # band-8-like, 2 km: 5424^2
    x1 = np.arange(w, dtype=np.int16)
    y1 = np.arange(h, dtype=np.int16)
    # the 1-km grid's counts that the channel-1 scan scales map onto its
    # own scan angles (the reader navigates a channel through channel 1's)
    x2 = (np.arange(2 * w) // 2).astype(np.int16)
    y2 = (np.arange(2 * h) // 2).astype(np.int16)
    scenes, ch2 = [], None
    for i, shift in enumerate((0.0, 2.4)):
        t = t0 + 60.0 * i
        counts1 = counts_for(g[i][0], 13, nav.rad_scale[0], nav.rad_offset[0])
        sc = scene_from_goes_arrays(counts1, x1, y1, dataclasses.replace(nav), cfg, dev,
                                    donav=i == 0, t=t)
        img2 = bench_scene_cuda(2 * h, 2 * w, 2 * shift, dev, 10 + i, (11.0, 13.0))
        counts2 = counts_for(img2, *band2)
        del img2
        cal2 = dict(rad_scale=band2[1], rad_offset=band2[2], fk1=0.0, fk2=0.0, bc1=0.0,
                    bc2=0.0, kap1=0.0)
        channel_onto_scene(counts2, x2, y2, band2[0], sc, cfg, 2, cal2)
        if i == 0:
            ch2 = (counts1, counts2, x2, y2, cal2)
        counts3 = counts_for(bench_scene_cuda(h, w, shift, dev, 20 + i, (17.0, 5.0)), *band3)
        cal3 = dict(cal2, rad_scale=band3[1], rad_offset=band3[2])
        channel_onto_scene(counts3, x1, y1, band3[0], sc, cfg, 3, cal3)
        scenes.append(sc)
    scenes[0].nav.g2x_offset = scenes[1].nav.x_offset
    scenes[0].nav.g2y_offset = scenes[1].nav.y_offset
    return scenes[0], scenes[1], ch2


def phase_multichannel(dev, report):
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.core.zoom import pyramid_downsample, zoom_size
    from octane_tpu_torch.flow.dispatcher import compute_flow
    from octane_tpu_torch.flow.variational import _coarse_to_fine, variational_flow
    from octane_tpu_torch.io.readers import (channel_onto_scene, scene_from_goes_arrays,
                                             set_goes_grid)
    from octane_tpu_torch.ops.assemble import (assemble_cf, assemble_cf_plain, assemble_pcg,
                                               assemble_pcg_plain)
    from octane_tpu_torch.ops.warp import warp, warp_bilinear_dense

    fx = load_tests_module("torch_fixtures")
    for name, *_ in KERNELS:
        report.setdefault(name, {"max_abs_err": 0.0})
    t_phase = time.perf_counter()

    # (a) the warp and the assembly at C = 2 and 3 at every level's shape,
    # and the flow at 1024^2 against the plain route
    kiters, scale = 4, 0.5
    for c in (2, 3):
        g1, g2 = multichannel_pair(c, FULLDISK, FULLDISK, dev)
        for k in reversed(range(kiters)):
            factor = float(np.float32(scale) ** (kiters - k - 1))
            lh = lw = zoom_size(FULLDISK, factor)
            if k == kiters - 1:
                lg1, lg2 = g1, g2
            else:
                lvl = pyramid_downsample(torch.cat([g1, g2]), factor)
                lg1, lg2 = lvl[:c].contiguous(), lvl[c:].contiguous()
            lu, lv = noisy_flow(lh, lw, dev, 40 + k)
            stack = sample_stack(lg2)
            kw, pw = warp(stack, lu, lv), warp_bilinear_dense(stack, lu, lv)
            torch.cuda.synchronize()
            if not (stack.shape[0] == 6 * c and all(torch.equal(a, b) for a, b in zip(kw, pw))):
                raise AssertionError(f"multichannel: warp K={6 * c} {lh}x{lw} differs from "
                                     "its plain version")
            err = float((kw[0] - pw[0]).abs().max())
            report["warp_bilinear"]["max_abs_err"] = max(report["warp_bilinear"]["max_abs_err"],
                                                         err)
            inputs = assembly_inputs(lg1, stack, lu, lv)
            for al1 in (1.0, 0.5, 0.0):
                equal, ea = compare_assembly(inputs, al1)
                report["assemble_cf"]["max_abs_err"] = max(
                    report["assemble_cf"]["max_abs_err"], ea)
                p_equal, ep = compare_assembly_pcg(inputs, al1)
                report["assemble_pcg"]["max_abs_err"] = max(
                    report["assemble_pcg"]["max_abs_err"], ep)
                if not (equal and p_equal):
                    raise AssertionError(f"multichannel: the assembly C={c} {lh}x{lw} "
                                         f"al1={al1} differs from its plain version")
            say("multichannel", f"C={c} {lh}x{lw}: warp (K={6 * c}), assemble_cf and "
                                f"assemble_pcg (al1 1, 0.5, 0) bit-exact True")
            del kw, pw, inputs, stack
        del g1, g2
        s1, s2 = multichannel_pair(c, SECTOR, SECTOR, dev)
        z = torch.zeros((SECTOR, SECTOR), device=dev)
        for solver in ("pcg", "sor"):
            cfg = OFConfig(kiters=4, solver=solver, nchannels=c)
            ku, kv = replayed(lambda: variational_flow(s1, s2, z, z, cfg))
            qu, qv = _coarse_to_fine(s1, s2, z, z, cfg, plain=True)
            torch.cuda.synchronize()
            same = torch.equal(ku, qu) and torch.equal(kv, qv)
            m = SECTOR // 8
            say("multichannel", f"C={c} {SECTOR}x{SECTOR} {solver}: variational_flow's "
                                f"replayed program torch.equal to the plain route {same}; median "
                                f"({float(ku[m:-m, m:-m].median()):.4f}, "
                                f"{float(kv[m:-m, m:-m].median()):.4f}) px, truth (2.4, 0)")
            if not same:
                raise AssertionError(f"multichannel: the C={c} {solver} flow differs from "
                                     "the plain route")
    torch.cuda.empty_cache()

    # (b) the three-channel full-disk pair, kernels only
    h = w = FULLDISK
    _, _, _, nav, *_ = fx.goes_arrays(np.zeros((h, w), np.int16), fx.FIXTURE_T0)
    t0 = time.perf_counter()
    s1, s2, ch2 = three_channel_scenes(nav, dev, fx.FIXTURE_T0)
    torch.cuda.synchronize()
    say("multichannel", f"three-channel {h}x{w} pair made through scene_from_goes_arrays and "
                        f"channel_onto_scene (channel 2 from {2 * h}x{2 * w}) in "
                        f"{time.perf_counter() - t0:.2f} s; data {tuple(s1.data.shape)}, "
                        f"pseudo-counts {tuple(s1.raw_counts.shape)} {s1.raw_counts.dtype}")
    if not (s1.nchannels == s2.nchannels == 3 and s1.raw_counts.shape == (3, h, w)
            and all(torch.isfinite(sc.data).all() for sc in (s1, s2))):
        raise AssertionError("multichannel: the three-channel scenes are off")
    m = h // 4          # the centre of the disk: no limb ramp there
    launches, pair_ms, flows = {}, {}, {}
    for solver in ("pcg", "sor"):
        cfg = OFConfig(kiters=4, solver=solver, nchannels=3)
        compute_flow(s1, s2, cfg)              # the eager first call
        compute_flow(s1, s2, cfg)              # capture and first replay
        torch.cuda.synchronize()
        ops.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        compute_flow(s1, s2, cfg)
        ev[1].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        c = launches[solver] = _check_counters("multichannel", solver)
        stray = {n: c[n][0] for n in ops.WRAPPERS if n not in ops.PATHS[solver] and c[n][0]}
        if stray:
            raise AssertionError(f"multichannel: the {solver} pair launched kernels off its "
                                 f"path: {stray}")
        u, v = s1.u_pix, s1.v_pix
        med = (float(u[m:-m, m:-m].median()), float(v[m:-m, m:-m].median()))
        pair_ms[solver] = ev[0].elapsed_time(ev[1])
        say("multichannel", f"three-channel {h}x{w} {solver}: compute_flow {pair_ms[solver]:.1f} "
                            f"ms per pair ({wall:.1f} ms wall), peak {peak:.2f} GiB; median "
                            f"({med[0]:.4f}, {med[1]:.4f}) px, truth (2.4, 0)")
        if not (abs(med[0] - 2.4) < 0.1 and abs(med[1]) < 0.1 and torch.isfinite(u).all()
                and s1.u_wind.shape == (h, w)):
            raise AssertionError(f"multichannel: the three-channel {solver} pair is off")
        flows[solver] = (u.contiguous(), v.contiguous())
    report["_launches_c3"] = launches

    # rows 1 and 5 at C = 3 on the pair's data and its SOR flow
    u, v = flows["sor"]
    stack = sample_stack(s2.data)
    plane = h * w * 4
    tw = (cuda_ms(lambda: warp(stack, u, v)), cuda_ms(lambda: warp_bilinear_dense(stack, u, v),
                                                      n=3))
    tg = cuda_ms(grid_sample_fn(stack, u, v))
    # u, v and the 18 planes in, 18 samples and two flag bytes out; per
    # pixel 16 operations of the cell and 6 per plane
    bw = bound((2 + 2 * 18) * plane + 2 * h * w, (16 + 6 * 18) * h * w)
    inputs = assembly_inputs(s1.data, stack, u, v)
    args = (*inputs, 0.5, *ASM_SCALARS, True)
    ta = (cuda_ms(lambda: assemble_cf(*args)), cuda_ms(lambda: assemble_cf_plain(*args), n=3))
    # 9C + 4 planes and the two flag bytes in, 10 planes out; ~100
    # operations per pixel and ~50 per channel
    ba = bound((9 * 3 + 4 + 10) * plane + 2 * h * w, (100 + 50 * 3) * h * w)
    tp = (cuda_ms(lambda: assemble_pcg(*args)), cuda_ms(lambda: assemble_pcg_plain(*args), n=3))
    bp = pcg_assembly_bound(9 * 3 + 4, False, h, w)
    say("multichannel", f"{h}x{w} C=3: warp_bilinear x18 {tw[0]:.3f} ms (bound {bw[0]:.3f} ms, "
                        f"{bw[1]}; plain {tw[1]:.3f} ms; F.grid_sample {tg:.3f} ms); "
                        f"assemble_cf robust {ta[0]:.3f} ms (bound {ba[0]:.3f} ms, {ba[1]}; "
                        f"plain {ta[1]:.3f} ms); assemble_pcg robust {tp[0]:.3f} ms (bound "
                        f"{bp[0]:.3f} ms, {bp[1]}; plain {tp[1]:.3f} ms)")
    report["_c3"] = {"warp_bilinear": (tw, bw, tg), "assemble_cf": (ta, ba, None),
                     "assemble_pcg": (tp, bp, None)}
    del stack, inputs, args, flows
    torch.cuda.empty_cache()

    # (c) the regrid branches on the card against the CPU: the zoom out of
    # (b), and a zoom in at a mesoscale-sector shape
    counts1, counts2, x2, y2, cal2 = ch2
    got = {"zoom out": (s1.data[1], s1.raw_counts[1])}
    cfg = OFConfig()
    cpu = scene_from_goes_arrays(counts1, np.arange(w, dtype=np.int16),
                                 np.arange(h, dtype=np.int16), dataclasses.replace(nav), cfg,
                                 "cpu", donav=False, t=fx.FIXTURE_T0)
    channel_onto_scene(counts2, x2, y2, 3, cpu, cfg, 2, cal2)
    want = {"zoom out": (cpu.data[1], cpu.raw_counts[1])}
    del cpu
    # a band-2-like channel 1 (0.5 km) and a channel of a quarter its width
    mnav = set_goes_grid(dataclasses.replace(nav, rad_scale=(cal2["rad_scale"], 1.0, 1.0),
                                             rad_offset=(cal2["rad_offset"], 0.0, 0.0)),
                         MESO, MESO, 2)
    g = bench_images(MESO, MESO, dev)[0][0]
    c1 = counts_for(g, 2, cal2["rad_scale"], cal2["rad_offset"])
    small = counts_for(bench_scene_cuda(MESO // 4, MESO // 4, 0.0, dev, 30), 3, 0.02, -1.0)
    xs = np.arange(MESO // 4, dtype=np.int16)
    for d, out in ((dev, got), ("cpu", want)):
        sc = scene_from_goes_arrays(c1, np.arange(MESO, dtype=np.int16),
                                    np.arange(MESO, dtype=np.int16), dataclasses.replace(mnav),
                                    cfg, d, donav=False, t=fx.FIXTURE_T0, band=2)
        channel_onto_scene(small, xs, xs, 3, sc, cfg, 2, cal2)
        out["zoom in"] = (sc.data[1], sc.raw_counts[1])
    for branch, (gd, gc) in got.items():
        wd, wc = want[branch]
        r = rel(gd.cpu(), wd)
        eq = torch.equal(gc.cpu(), wc)
        say("multichannel", f"channel_onto_scene {branch} ({tuple(gd.shape)}) card vs CPU: "
                            f"rel {r:.2e} (budget 1e-5), pseudo-counts equal {eq}")
        if not (r <= 1e-5 and eq and torch.isfinite(gd).all()):
            raise AssertionError(f"multichannel: the {branch} regrid differs from the CPU's")
    say("multichannel", f"phase wall {time.perf_counter() - t_phase:.1f} s")


def flat_scene_arrays(grid, lat1, h, w):
    """A flat-grid pair: the bench pair as raw data on 2-km pixels, and the
    NavConstants of its file (x = y = 0 on the grid's centre pixel)."""
    from octane_tpu_torch.io.datamodel import NavConstants
    from octane_tpu_torch.io.readers import set_flat_grid

    im1, im2 = load_tests_module("torch_fixtures").bench_pair(h, w)
    nav = NavConstants(grid=grid, R=6371000.0)
    nav.x_scale = nav.y_scale = 2000.0
    nav.x_offset, nav.y_offset = -2000.0 * (w // 2), -2000.0 * (h // 2)
    if grid == "polar":
        nav.lat1, nav.lon0_deg = lat1, -45.0
    else:
        nav.lon1 = -75.0 * np.pi / 180.0
    return im1, im2, set_flat_grid(nav, h, w)


def phase_flatgrid(dev):
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow.dispatcher import compute_flow
    from octane_tpu_torch.io.readers import scene_from_flat_arrays
    from octane_tpu_torch.nav.winds import pix2uv_ms

    t_phase = time.perf_counter()
    h = w = FLAT
    x = np.arange(w, dtype=np.int16)
    y = np.arange(h, dtype=np.int16)
    m = h // 8
    for grid, lat1 in (("polar", 90.0), ("polar", 60.0), ("mercator", 0.0)):
        im1, im2, nav = flat_scene_arrays(grid, lat1, h, w)
        cfg = OFConfig(grid=grid, solver="sor")
        s1 = scene_from_flat_arrays(im1, x, y, dataclasses.replace(nav), cfg, dev, t=0.0)
        s2 = scene_from_flat_arrays(im2, x, y, dataclasses.replace(nav), cfg, dev,
                                    donav=False, t=600.0)
        ops.reset_counters()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        compute_flow(s1, s2, cfg)
        ev[1].record()
        torch.cuda.synchronize()
        _check_counters("flatgrid", "sor")
        cpu = scene_from_flat_arrays(im1, x, y, dataclasses.replace(nav), cfg, "cpu", t=0.0)
        ums, vms = pix2uv_ms(s1.u_pix.cpu(), s1.v_pix.cpu(), s1.nav, 600.0, grid=grid)
        dlat = float((s1.lat.cpu() - cpu.lat).abs().max())
        dlon = float((s1.lon.cpu() - cpu.lon).abs().max())
        dwind = max(float((s1.u_ms.cpu() - ums).abs().max()),
                    float((s1.v_ms.cpu() - vms).abs().max()))
        med = (float(s1.u_pix[m:-m, m:-m].median()), float(s1.v_pix[m:-m, m:-m].median()))
        say("flatgrid", f"{grid} lat1={lat1} {h}x{w}: scene_from_flat_arrays -> compute_flow "
                        f"(sor) {ev[0].elapsed_time(ev[1]):.1f} ms; card vs CPU: lat/lon max "
                        f"|d| {dlat:.2e} / {dlon:.2e} deg, u_ms/v_ms max |d| {dwind:.2e} m/s "
                        f"(budgets 1e-9); u_ms dtype {s1.u_ms.dtype}, median flow "
                        f"({med[0]:.4f}, {med[1]:.4f}) px, truth (2.4, 0)")
        if not (dlat <= 1e-9 and dlon <= 1e-9 and dwind <= 1e-9
                and s1.u_ms.dtype == torch.float64 and torch.isfinite(s1.u_ms).all()
                and abs(med[0] - 2.4) < 0.1 and abs(med[1]) < 0.1):
            raise AssertionError(f"flatgrid: the {grid} lat1={lat1} pair is off")
    say("flatgrid", f"phase wall {time.perf_counter() - t_phase:.1f} s")


def sequence_frames(dev, n=12, hw=500):
    """bench.py config 5's frames (bench.py:140-159): frame i is the bench
    scene with the noise of seed i."""
    fx = load_tests_module("torch_fixtures")
    return [torch.from_numpy(fx.bench_pair(hw, hw, seed=i)[0][None]).to(dev) for i in range(n)]


def run_chain(frames, nav, cfg, t0, plain=False, eager=False):
    """The frames' consecutive pairs, each warm-started from the previous
    pair's flow: through compute_flow(..., first_guess=...) over in-memory
    scenes (run_sequence's loop, whose pairs replay the flow program), or
    through the plain route, or (``eager``) through the eager kernel route."""
    from octane_tpu_torch.flow.dispatcher import compute_flow
    from octane_tpu_torch.flow.variational import _coarse_to_fine
    from octane_tpu_torch.io.datamodel import Scene

    flows, prev = [], None
    for i in range(len(frames) - 1):
        if plain or eager:
            z = torch.zeros(frames[i].shape[1:], device=frames[i].device)
            u0, v0 = prev if prev is not None else (z, z)
            prev = _coarse_to_fine(frames[i], frames[i + 1], u0, v0, cfg, plain=plain)
        else:
            s1 = Scene(nav=dataclasses.replace(nav), data=frames[i], t=t0 + 60.0 * i)
            s2 = Scene(nav=nav, data=frames[i + 1], t=t0 + 60.0 * (i + 1))
            compute_flow(s1, s2, cfg, first_guess=prev)
            prev = (s1.u_pix, s1.v_pix)
        flows.append(prev)
    return flows


def sequence_files_resume(frames, nav, cfg, dev, outdir):
    """run_sequence over the frames written as GOES files: uninterrupted,
    and stopped after 2 pairs then resumed from its checkpoint.  Returns
    whether every product of the two runs is equal, as the codec reads them."""
    from octane_tpu_torch.io import hdf5
    from octane_tpu_torch.sequence import run_sequence

    fx = load_tests_module("torch_fixtures")
    files = [fx.make_goes_file(os.path.join(outdir, f"f{i:02d}.nc"),
                            counts_for(f[0], 13, nav.rad_scale[0], nav.rad_offset[0]),
                            band=13, t=fx.FIXTURE_T0 + 60.0 * i) for i, f in enumerate(frames)]
    whole = run_sequence(files, cfg, outdir=os.path.join(outdir, "whole"), device=dev)
    ck = os.path.join(outdir, "ckpt.h5")
    part = os.path.join(outdir, "part")
    run_sequence(files[:3], cfg, outdir=part, checkpoint=ck, device=dev)
    resumed = run_sequence(files, cfg, outdir=part, checkpoint=ck, device=dev)
    if len(resumed) != len(files) - 3:
        return False
    for pw in whole:
        with hdf5.File(pw) as fw, hdf5.File(pw.replace("whole", "part")) as fp:
            if fw.keys() != fp.keys() or any(not np.array_equal(fw[k][()], fp[k][()])
                                             for k in fw.keys()):
                return False
    return True


def phase_sequence(dev):
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig

    fx = load_tests_module("torch_fixtures")
    t_phase = time.perf_counter()
    frames = sequence_frames(dev)
    _, _, _, nav, *_ = fx.goes_arrays(np.zeros((500, 500), np.int16), fx.FIXTURE_T0)
    nav.g2x_offset, nav.g2y_offset = nav.x_offset, nav.y_offset
    npairs = len(frames) - 1
    for solver in ("pcg", "sor"):
        cfg = OFConfig(kiters=3, alpha=5.0, lambda_=1.0, lambdac=0.05, solver=solver)
        run_chain(frames, nav, cfg, fx.FIXTURE_T0)           # warm-up
        torch.cuda.synchronize()
        ops.reset_counters()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        flows = run_chain(frames, nav, cfg, fx.FIXTURE_T0)
        ev[1].record()
        torch.cuda.synchronize()
        _check_counters("sequence", solver)
        plain = run_chain(frames, nav, cfg, fx.FIXTURE_T0, plain=True)
        same = all(torch.equal(a, b) for f, p in zip(flows, plain) for a, b in zip(f, p))
        ms = ev[0].elapsed_time(ev[1]) / npairs
        say("sequence", f"config 5 ({len(frames)} frames of 500x500, kiters 3, lambdac 0.05) "
                        f"{solver}: {npairs} warm-started pairs through compute_flow(..., "
                        f"first_guess=previous flow) over in-memory scenes (run_sequence's "
                        f"loop) "
                        f"{ms:.2f} ms per pair; every pair torch.equal to the plain chain "
                        f"{same}; last median ({float(flows[-1][0].median()):.4f}, "
                        f"{float(flows[-1][1].median()):.4f}) px, truth (0, 0)")
        if not same:
            raise AssertionError(f"sequence: the {solver} chain differs from the plain chain")
        out = tempfile.mkdtemp(prefix=f"octane_sequence_{solver}_")
        t0 = time.perf_counter()
        ok = sequence_files_resume(frames, nav, cfg, dev, out)
        shutil.rmtree(out, ignore_errors=True)
        say("sequence", f"{solver}: run_sequence over {len(frames)} codec-written L1b files "
                        f"({time.perf_counter() - t0:.1f} s, an uninterrupted run and one "
                        f"stopped after 2 pairs and resumed from its checkpoint): every "
                        f"product of the resumed run equals the uninterrupted run's {ok}")
        if not ok:
            raise AssertionError("sequence: the resumed run differs")
    say("sequence", f"phase wall {time.perf_counter() - t_phase:.1f} s")


PROGRAM_RUNS = 3        # pairs timed per route and turn in the program phase


def program_pair(run, n=PROGRAM_RUNS):
    """``run()`` n times, each timed with CUDA events and the host clock
    around it (synchronised): (u, v, [ms], [wall ms])."""
    ms, wall = [], []
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        u, v = run()
        ev[1].record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        ms.append(ev[0].elapsed_time(ev[1]))
    return u, v, ms, wall


def phase_program(dev, report):
    """The captured pair (flow.variational.flow_program) against the eager
    kernel route and the plain route."""
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow import variational as fv
    from octane_tpu_torch.flow.program import program_pool_bytes

    fx = load_tests_module("torch_fixtures")
    t_phase = time.perf_counter()
    key = {"pcg": "pcg_iterations", "sor": "sor_passes"}

    def replay_checked(prog, *args):
        """One replay under sync-debug "error", counted: (u, v, count)."""
        syncs = {s: ops.counters()[f"{s}_host_syncs"] for s in key}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            u, v = prog(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        c = ops.counters()
        if any(c[f"{s}_host_syncs"] != syncs[s] for s in key):
            raise AssertionError("program: a replayed pair read the host")
        return u, v, c[key[prog.cfg.solver]]

    def early_tol(g1, g2, z, solver):
        """The first of 1e-1, 1e1, 1e3, 1e5 at which the eager pair stops a
        relaxer early."""
        for tol in (1e-1, 1e1, 1e3, 1e5):
            fv._coarse_to_fine(g1, g2, z, z, OFConfig(kiters=3, solver=solver, cg_tol=tol))
            if ops.counters()[key[solver]] < most[solver]:
                return tol
        raise AssertionError(f"program: no tolerance stops the {solver} relaxer early")

    # (a) small shapes: the default tolerance and one that stops the
    # relaxer early, and a second replay with other inputs of the same shape
    most = {"pcg": 3 * 9 * 30, "sor": 3 * 9 * 4}     # kiters 3, 9 rounds, 30 its / 4 passes
    for (h, w) in ((512, 512), (500, 372)):
        g1, g2 = bench_images(h, w, dev)
        z = torch.zeros((h, w), device=dev)
        ua, va = noisy_flow(h, w, dev, seed=3)
        for solver in ("pcg", "sor"):
            for tol in (OFConfig().cg_tol, early_tol(g1, g2, z, solver)):
                cfg = OFConfig(kiters=3, solver=solver, cg_tol=tol)
                prog = fv.flow_program(cfg, (h, w), 1, dev)
                line = []
                for u0, v0 in ((z, z), (0.5 * ua, 0.5 * va)):
                    eu, ev = fv._coarse_to_fine(g1, g2, u0, v0, cfg)
                    e_count = ops.counters()[key[solver]]
                    pu, pv = fv._coarse_to_fine(g1, g2, u0, v0, cfg, plain=True)
                    while prog.graph is None:       # the eager call, then the capture
                        prog(g1, g2, u0, v0)
                    gu, gv, g_count = replay_checked(prog, g1, g2, u0, v0)
                    ok = (torch.equal(gu, eu) and torch.equal(gv, ev) and torch.equal(gu, pu)
                          and torch.equal(gv, pv) and g_count == e_count)
                    line.append(f"{key[solver]} {g_count} (eager {e_count}) equal {ok}")
                    if not ok:
                        raise AssertionError(f"program: {h}x{w} {solver} tol {tol}: the "
                                             "replay differs from the eager or plain route")
                say("program", f"{h}x{w} {solver} cg_tol {tol:g}: " + "; ".join(line)
                               + f"; capture {prog.capture_seconds:.2f} s")
        fv.clear_program_cache()

    # (b) the full-disk pair per relaxer, in turns: eager, graph, graph, eager
    h = w = FULLDISK
    g1, g2 = bench_images(h, w, dev)
    z = torch.zeros((h, w), device=dev)
    out = {}
    for solver in ("pcg", "sor"):
        cfg = OFConfig(kiters=4, solver=solver)
        prog = fv.flow_program(cfg, (h, w), 1, dev)
        torch.cuda.reset_peak_memory_stats()
        first_s = []
        for _ in range(2):             # the eager first call, then capture + replay
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prog(g1, g2, z, z)
            torch.cuda.synchronize()
            first_s.append(time.perf_counter() - t0)
        capture_peak = torch.cuda.max_memory_allocated()
        pool = program_pool_bytes(dev)
        times = {"eager": ([], []), "graph": ([], [])}
        flows, launched = {}, {}
        for route in ("eager", "graph", "graph", "eager"):
            if route == "eager":
                run = lambda: fv._coarse_to_fine(g1, g2, z, z, cfg)   # noqa: E731
            else:
                run = lambda: prog(g1, g2, z, z)                       # noqa: E731
            ops.reset_counters()
            u, v, ms, wall = program_pair(run)
            c = ops.counters()
            flows[route] = (u, v, c[key[solver]], c[f"{solver}_host_syncs"])
            launched[route] = {n: c[n][0] for n in ops.WRAPPERS if c[n][0]}
            times[route][0].extend(ms)
            times[route][1].extend(wall)
        gu, gv, g_count, g_syncs = flows["graph"]
        eu, ev, e_count, e_syncs = flows["eager"]
        torch.cuda.reset_peak_memory_stats()
        gu2, gv2, checked_count = replay_checked(prog, g1, g2, z, z)
        replay_peak = torch.cuda.max_memory_allocated()
        pu, pv = fv._coarse_to_fine(g1, g2, z, z, cfg, plain=True)
        same = (torch.equal(gu, eu) and torch.equal(gv, ev) and torch.equal(gu, pu)
                and torch.equal(gv, pv) and torch.equal(gu2, gu) and torch.equal(gv2, gv))
        m = 512
        med = (float(gu[m:-m, m:-m].median()), float(gv[m:-m, m:-m].median()))
        stat = {r: (min(t[0]), float(np.median(t[0])), min(t[1]), float(np.median(t[1])))
                for r, t in times.items()}
        say("program", f"{h}x{w} {solver} (kiters 4): graph {stat['graph'][0]:.1f} / "
                       f"{stat['graph'][1]:.1f} ms per pair (min / median of "
                       f"{len(times['graph'][0])}, CUDA events; host wall "
                       f"{stat['graph'][2]:.1f} / {stat['graph'][3]:.1f} ms), eager "
                       f"{stat['eager'][0]:.1f} / {stat['eager'][1]:.1f} ms (host wall "
                       f"{stat['eager'][2]:.1f} / {stat['eager'][3]:.1f} ms); first call "
                       f"(eager) {first_s[0]:.2f} s, second (capture + instantiate + "
                       f"replay) {first_s[1]:.2f} s, capture "
                       f"+ instantiate {prog.capture_seconds:.2f} s; host syncs per pair "
                       f"graph {g_syncs / PROGRAM_RUNS:g}, eager {e_syncs / PROGRAM_RUNS:g}; "
                       f"{key[solver]} graph "
                       f"{g_count} eager {e_count} checked replay {checked_count}; launches "
                       f"graph {json.dumps(launched['graph'])} eager "
                       f"{json.dumps(launched['eager'])}; peak "
                       f"{capture_peak / 2 ** 30:.2f} GiB over the first two calls, "
                       f"{replay_peak / 2 ** 30:.2f} GiB at a replay, pools reserve "
                       f"{pool / 2 ** 30:.2f} GiB; graph == eager == plain {same}; median "
                       f"({med[0]:.4f}, {med[1]:.4f}) px")
        if not (same and g_count == e_count == checked_count and g_syncs == 0
                and launched["graph"] == launched["eager"]
                and abs(med[0] - 2.4) < 0.1 and abs(med[1]) < 0.1):
            raise AssertionError(f"program: the {solver} full-disk replay differs from the "
                                 "eager or plain route, or read the host")
        out[solver] = {"graph_ms": stat["graph"][:2], "eager_ms": stat["eager"][:2],
                       "first_s": first_s, "capture_s": prog.capture_seconds,
                       "pool_bytes": pool}
        del flows, gu, gv, eu, ev, pu, pv, gu2, gv2
        fv.clear_program_cache()
    del g1, g2, z

    # (c) bench config 5's sequence through the program against the eager chain
    frames = sequence_frames(dev)
    _, _, _, nav, *_ = fx.goes_arrays(np.zeros((500, 500), np.int16), fx.FIXTURE_T0)
    nav.g2x_offset, nav.g2y_offset = nav.x_offset, nav.y_offset
    npairs = len(frames) - 1
    for solver in ("pcg", "sor"):
        cfg = OFConfig(kiters=3, alpha=5.0, lambda_=1.0, lambdac=0.05, solver=solver)
        timed = {}
        for label, eager in (("eager", True), ("graph", False)):
            run_chain(frames, nav, cfg, fx.FIXTURE_T0, eager=eager)    # warm-up / capture
            ops.reset_counters()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            flows = run_chain(frames, nav, cfg, fx.FIXTURE_T0, eager=eager)
            ev[1].record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / npairs
            timed[label] = (flows, ev[0].elapsed_time(ev[1]) / npairs, wall,
                            ops.counters()[f"{solver}_host_syncs"])
        same = all(torch.equal(a, b) for f, e in zip(timed["graph"][0], timed["eager"][0])
                   for a, b in zip(f, e))
        say("program", f"config 5 sequence {solver}: {npairs} pairs through the program "
                       f"{timed['graph'][1]:.2f} ms per pair (host wall {timed['graph'][2]:.2f}"
                       f", host syncs {timed['graph'][3]}), eager chain "
                       f"{timed['eager'][1]:.2f} ms (host wall {timed['eager'][2]:.2f}, host "
                       f"syncs {timed['eager'][3]}); every pair torch.equal {same}")
        if not same or timed["graph"][3] != 0:
            raise AssertionError(f"program: the {solver} sequence differs from the eager chain")
        out[f"seq_{solver}"] = (timed["graph"][1], timed["eager"][1])
        fv.clear_program_cache()
    report["_program"] = out
    say("program", f"phase wall {time.perf_counter() - t_phase:.1f} s")


MESH_BANDS = 4                      # the mesh phase's bands, all on cuda:0
MESH_SPLIT = (0, 1000, 2500, 4700, FULLDISK)   # its uneven split of 5424 rows
MESH_HALO = 16                      # rows beside a band in the band-form checks (halo_warp)


def phase_tracer(dev):
    """The tracer's device stamps inside a replayed program (phase 19)."""
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow import variational as fv
    from octane_tpu_torch.utils import profiling

    fx = load_tests_module("torch_fixtures")
    h = w = 512
    im1, im2 = (torch.from_numpy(a[None]).to(dev) for a in fx.bench_pair(h, w))
    z = torch.zeros((h, w), device=dev)
    for solver, key in (("pcg", "pcg_iterations"), ("sor", "sor_passes")):
        cfg = OFConfig(kiters=3, solver=solver)
        rounds = cfg.kiters * cfg.gnc_steps * cfg.liters
        flows, stamps = {}, {}
        try:
            for on in (False, True):
                if on:
                    profiling.enable()
                prog = fv.flow_program(cfg, (h, w), 1, dev)
                while prog.graph is None:
                    prog(im1, im2, z, z)
                torch.cuda.synchronize()
                ops.reset_counters()
                profiling.reset()
                t_enq = time.perf_counter_ns()
                flows[on] = prog(im1, im2, z, z)
                torch.cuda.synchronize()
                c = ops.counters()
                stamps[on] = c["stamp"][0]
                if on:
                    spans = [s for s in profiling.records()[None] if s.device_start is not None]
                    raw = prog.marks.stamps.tolist()
                    if raw != sorted(raw) or len(raw) != 2 + cfg.kiters + 2 * rounds:
                        raise AssertionError(f"tracer: {solver} stamps out of order or missing")
                    early = t_enq - min(s.device_start for s in spans)
                    if early > 20_000:
                        raise AssertionError(f"tracer: {solver} stamp {early} ns before its enqueue")
                    if sum(c[f"{key}_by_round"]) != c[key]:
                        raise AssertionError(f"tracer: {solver} round counts do not sum")
                    solve = next(s for s in spans if s.name == "octane.solve")
                    say("tracer", f"{h}x{w} {solver}: {len(raw)} stamps in order, first "
                        f"{(min(s.device_start for s in spans) - t_enq) / 1e3:.1f} us after the "
                        f"enqueue, solve {(solve.device_end - solve.device_start) / 1e6:.3f} ms, "
                        f"{c[key]} counted = sum of {rounds} rounds")
                profiling.disable()
        finally:
            profiling.disable()
            profiling.reset()
            fv.clear_program_cache()
        if stamps[False] != 0 or not all(torch.equal(a, b) for a, b in zip(flows[False], flows[True])):
            raise AssertionError(f"tracer: {solver} untraced replay stamped or flows differ")


def band_ranges(split):
    return list(zip(split[:-1], split[1:]))


def phase_mesh(dev, report):
    """The band forms of the warp, SOR pass, PCG pass A and bilateral kernels
    at 5424^2 (4 even bands and one uneven split), then the banded 5424^2
    pair per relaxer on a (1, 4) mesh of cuda:0, then banded SRSAL."""
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.core.gaussian import gaussian_kernel_1d
    from octane_tpu_torch.flow.variational import variational_flow
    from octane_tpu_torch.nav.winds import pix2uv
    from octane_tpu_torch.ops.assemble import assemble_cf, assemble_pcg
    from octane_tpu_torch.ops.bilateral import (band_slab, bilateral, bilateral_band,
                                                bilateral_band_plain)
    from octane_tpu_torch.ops.pcg import pcg_pass_a, pcg_pass_a_band, pcg_pass_a_band_plain
    from octane_tpu_torch.ops.sor import sor_pass, sor_pass_band, sor_pass_band_plain
    from octane_tpu_torch.ops.warp import warp, warp_band, warp_band_plain
    from octane_tpu_torch.flow.program import clear_program_cache, program_pool_bytes
    from octane_tpu_torch.parallel import LocalExchange, make_mesh, sharded_pix2uv, sharded_srsal
    from octane_tpu_torch.parallel import sharded
    from octane_tpu_torch.post.srsal import srsal_smooth

    fx = load_tests_module("torch_fixtures")
    t_phase = time.perf_counter()
    h = w = FULLDISK
    plane = h * w * 4
    even = band_ranges([min(i * -(-h // MESH_BANDS), h) for i in range(MESH_BANDS + 1)])
    splits = {"4 bands": even, "uneven": band_ranges(MESH_SPLIT)}
    errs = {k: 0.0 for k in ("warp_band", "sor_pass_band", "pcg_pass_a_band", "bilateral_band")}
    times, bounds = {}, {}

    def slab(r0, r1, g):
        return max(0, r0 - g), min(h, r1 + g)

    # (a) each band form against its plain version and the whole-image
    # kernel's rows; timed on the 4 even bands beside its bound (the bytes
    # of every band's slab, ghost rows included)
    g1, g2 = bench_images(h, w, dev)
    u, v = noisy_flow(h, w, dev, 61)
    stack = sample_stack(g2)
    whole = warp(stack, u, v)
    for name, bands in splits.items():
        ok = True
        for r0, r1 in bands:
            s0, s1 = slab(r0, r1, MESH_HALO)
            args = (stack[:, s0:s1].contiguous(), u[r0:r1], v[r0:r1], s0, r0, h)
            kw, pw = warp_band(*args), warp_band_plain(*args)
            ok = ok and all(torch.equal(a, b) and torch.equal(a, c[..., r0:r1, :])
                            for a, b, c in zip(kw, pw, whole))
            errs["warp_band"] = max(errs["warp_band"], float((kw[0] - pw[0]).abs().max()))
        say("mesh", f"warp_band {name}: bit-exact vs plain and vs the whole-image warp's rows {ok}")
        if not ok:
            raise AssertionError(f"mesh: warp_band ({name}) differs")
    wargs = []
    for r0, r1 in even:
        s0, s1 = slab(r0, r1, MESH_HALO)
        wargs.append((stack[:, s0:s1].contiguous(), u[r0:r1], v[r0:r1], s0, r0, h))
    times["warp_band"] = (cuda_ms(lambda: [warp_band(*a) for a in wargs]),
                          cuda_ms(lambda: [warp_band_plain(*a) for a in wargs], n=3))
    fns = [grid_sample_fn(sl, ub, vb, r0 - s0) for sl, ub, vb, s0, r0, _ in wargs]
    library = {"warp_band": cuda_ms(lambda: [f() for f in fns])}     # the yardstick
    del fns
    rows_in = sum(a[0].shape[1] for a in wargs)
    # u, v and 6 planes of each slab in, 6 samples and 2 flag bytes out
    bounds["warp_band"] = bound((2 * h * w + 6 * rows_in * w) * 4 + 6 * plane + 2 * h * w,
                                52 * h * w)
    del whole, wargs

    inputs = assembly_inputs(g1, stack, u, v)
    for al1 in (1.0, 0.5):
        mode = "quad" if al1 == 1.0 else "robust"
        # the PCG form on each band's slab (its rows and a ghost row beside
        # each cut), as the banded PCG round calls it
        whole = assemble_pcg(*inputs, al1, *ASM_SCALARS, True)
        for name, bands in splits.items():
            ok = True
            for r0, r1 in bands:
                a0, a1 = max(0, r0 - 1), min(h, r1 + 1)
                part = tuple(t[..., a0:a1, :].contiguous() for t in inputs)
                rows = (r0 - a0, r1 - a0)
                eq, _ = compare_assembly_pcg(part, al1, rows)
                k = assemble_pcg(*part, al1, *ASM_SCALARS, True, rows)
                ok = ok and eq and all(torch.equal(a, c[:, r0:r1])
                                       for a, c in zip(k[:2], whole[:2]))
                del part, k
            say("mesh", f"assemble_pcg {mode} {name}: bit-exact vs plain (partials included) "
                        f"and vs the whole image's rows {ok}")
            if not ok:
                raise AssertionError(f"mesh: assemble_pcg ({mode}, {name}) differs")
        del whole
        cf, _ = assemble_cf(*inputs, al1, *ASM_SCALARS, True)
        x = 0.1 * torch.stack([u, v])
        for sweeps in (8, 6):
            ref, _ = sor_pass(x, cf, sweeps)
            for name, bands in splits.items():
                ok = True
                for r0, r1 in bands:
                    t0, t1 = slab(r0, r1, 2 * sweeps)
                    args = (x[:, t0:t1].contiguous(), cf[:, t0:t1].contiguous(), sweeps, 1.9,
                            t0, h, r0 - t0, r1 - t0)
                    (kx, kp), (px, pp) = sor_pass_band(*args), sor_pass_band_plain(*args)
                    ok = ok and torch.equal(kx, px) and torch.equal(kp, pp) and torch.equal(
                        kx, ref[:, r0:r1])
                    errs["sor_pass_band"] = max(errs["sor_pass_band"],
                                                float((kx - px).abs().max()))
                say("mesh", f"sor_pass_band {mode} {sweeps} sweeps {name}: bit-exact vs plain "
                            f"(iterate and partials) and vs the whole-image pass's rows {ok}")
                if not ok:
                    raise AssertionError(f"mesh: sor_pass_band ({mode}, {sweeps}, {name}) differs")
        if al1 == 0.5:
            sargs = []
            for r0, r1 in even:
                t0, t1 = slab(r0, r1, 16)
                sargs.append((x[:, t0:t1].contiguous(), cf[:, t0:t1].contiguous(), 8, 1.9, t0,
                               h, r0 - t0, r1 - t0))
            times["sor_pass_band"] = (
                cuda_ms(lambda: [sor_pass_band(*a) for a in sargs]),
                cuda_ms(lambda: [sor_pass_band_plain(*a) for a in sargs], n=1))
            rows_in = sum(a[0].shape[1] for a in sargs)
            # x and the 10 planes of each slab in, the band's x out; per sweep
            # and pixel 36 flops
            bounds["sor_pass_band"] = bound(12 * rows_in * w * 4 + 2 * plane, 8 * 36 * h * w)
            del sargs
        del cf, x, ref
    del inputs

    rng = np.random.default_rng(62)
    for quad in (True, False):
        mode = "quad" if quad else "robust"
        cf = coef_stack(pcg_system(h, w, quad, dev), quad)
        xs, rs, ps, _ = state_planes(rng, h, w, dev)
        ab = torch.tensor([0.37, 0.81], dtype=torch.float32, device=dev)
        ref = pcg_pass_a(xs, rs, ps, cf, ab)

        def pargs(r0, r1):
            def ghost(t):
                return torch.stack([t[:, max(r0 - 1, 0)], t[:, min(r1, h - 1)]], dim=1).contiguous()
            return (xs[:, r0:r1].contiguous(), rs[:, r0:r1].contiguous(),
                    ps[:, r0:r1].contiguous(), cf[:, r0:r1].contiguous(), ab, ghost(rs),
                    ghost(ps), ghost(cf[0:2]), r0, h)

        for name, bands in splits.items():
            ok = True
            for r0, r1 in bands:
                args = pargs(r0, r1)
                kb, pb = pcg_pass_a_band(*args), pcg_pass_a_band_plain(*args)
                ok = ok and all(torch.equal(a, b) for a, b in zip(kb, pb)) and all(
                    torch.equal(a, c[:, r0:r1]) for a, c in zip(kb[:3], ref[:3]))
                errs["pcg_pass_a_band"] = max(errs["pcg_pass_a_band"],
                                              max(float((a - b).abs().max()) for a, b in zip(kb, pb)))
            say("mesh", f"pcg_pass_a_band {mode} {name}: bit-exact vs plain (partials included) "
                        f"and vs the whole-image pass A's rows {ok}")
            if not ok:
                raise AssertionError(f"mesh: pcg_pass_a_band ({mode}, {name}) differs")
        if not quad:
            pa = [pargs(r0, r1) for r0, r1 in even]
            times["pcg_pass_a_band"] = (cuda_ms(lambda: [pcg_pass_a_band(*a) for a in pa]),
                                        cuda_ms(lambda: [pcg_pass_a_band_plain(*a) for a in pa],
                                                n=3))
            # x, r, p and 7 coefficient planes in, x, p', ap out, and each
            # band's (2, 2, W) ghost rows of r, p and the diagonals
            bounds["pcg_pass_a_band"] = bound((12 + 7) * plane + len(pa) * 3 * 4 * w * 4,
                                              30 * h * w)
            del pa
        del cf, xs, rs, ps, ref

    cth = torch.from_numpy(fx.cth_steps(h, w)).to(dev)
    gk = gaussian_kernel_1d(9.0, 18)
    ref = bilateral(u, v, cth, gk, SIGPIX2)
    for name, bands in splits.items():
        ok, worst = True, 0.0
        for r0, r1 in bands:
            s0, s1 = band_slab(r0, r1, h, 18)
            args = (u[s0:s1], v[s0:s1], cth[s0:s1], gk, SIGPIX2, s0, r0, r1 - r0, h)
            kb, pb = bilateral_band(*args), bilateral_band_plain(*args)
            worst = max(worst, max(rel(kb[i], pb[i]) for i in (0, 1)))
            ok = ok and torch.equal(kb, ref[:, r0:r1])
            errs["bilateral_band"] = max(errs["bilateral_band"], float((kb - pb).abs().max()))
        say("mesh", f"bilateral_band {name}: rel vs plain {worst:.3e} (budget "
                    f"{BILATERAL_REL:.0e}), bit-exact vs the whole-image kernel's rows {ok}")
        if not (ok and worst <= BILATERAL_REL):
            raise AssertionError(f"mesh: bilateral_band ({name}) differs")
    bargs = []
    for r0, r1 in even:
        s0, s1 = band_slab(r0, r1, h, 18)
        bargs.append((u[s0:s1], v[s0:s1], cth[s0:s1], gk, SIGPIX2, s0, r0, r1 - r0, h))
    times["bilateral_band"] = (cuda_ms(lambda: [bilateral_band(*a) for a in bargs], n=3),
                               cuda_ms(lambda: [bilateral_band_plain(*a) for a in bargs], n=1))
    rows_in = sum(a[0].shape[0] for a in bargs)
    bounds["bilateral_band"] = bound(3 * rows_in * w * 4 + 2 * plane, 10 * h * w * 37 * 37)
    del bargs, ref
    for k, (ms, plain_ms) in times.items():
        lib = f", F.grid_sample {library[k]:.3f} ms" if k in library else ""
        say("mesh", f"{k} x{MESH_BANDS} bands at {h}x{w}: {ms:.3f} ms (bound "
                    f"{bounds[k][0]:.3f} ms by {bounds[k][1]}, {100 * bounds[k][0] / ms:.1f} %), "
                    f"plain {plain_ms:.3f} ms{lib}")
    torch.cuda.empty_cache()

    # (b) the GOES full-disk pair on a (1, 4) mesh of cuda:0 per relaxer,
    # kernels only: the banded program's replay in turns with the eager
    # banded route and the single-device replay
    mesh = make_mesh((1, MESH_BANDS), [dev] * MESH_BANDS)
    z = torch.zeros((h, w), device=dev)
    _, _, _, nav, *_ = fx.goes_arrays(np.zeros((h, w), np.int16), fx.FIXTURE_T0)
    nav.g2x_offset, nav.g2y_offset = nav.x_offset, nav.y_offset
    m = min(512, h // 4)
    key = {"pcg": "pcg_iterations", "sor": "sor_passes"}
    launches, flows = {}, {}
    for solver in ("sor", "pcg"):
        cfg = OFConfig(kiters=4, solver=solver)
        prog = sharded.sharded_flow_program(cfg, (h, w), 1, mesh)
        info = sharded.last_program_info
        if info["route"] != "graph":
            raise AssertionError(f"mesh: the (1, 4) mesh of {dev} runs {info['route']}: "
                                 f"{info['reason']}")
        torch.cuda.reset_peak_memory_stats()
        first_s = []
        for _ in range(2):             # the eager first call, then capture + replay
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prog(g1, g2, z, z)
            torch.cuda.synchronize()
            first_s.append(time.perf_counter() - t0)
        pool = program_pool_bytes(dev)
        capture_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs = {"graph": lambda: prog(g1, g2, z, z),
                "eager": lambda: sharded._coarse_to_fine_banded(g1, g2, z, z, cfg, mesh,
                                                                LocalExchange()),
                "single": lambda: variational_flow(g1, g2, z, z, cfg)}
        variational_flow(g1, g2, z, z, cfg)            # the single-device program's
        variational_flow(g1, g2, z, z, cfg)            # first call and its capture
        res, ms, counts = {}, {k: [] for k in runs}, {}
        for label in ("graph", "eager", "single", "single", "eager", "graph"):
            ops.reset_counters()
            sharded.guard_reads.reads = 0
            torch.cuda.reset_peak_memory_stats()
            uu, vv, t, _ = program_pair(runs[label])
            c = ops.counters()
            ms[label].extend(t)
            res[label] = (uu, vv)
            counts[label] = (c, (c[f"{solver}_host_syncs"] + sharded.guard_reads.reads)
                             / PROGRAM_RUNS, torch.cuda.max_memory_allocated() / 2 ** 30)
        c, g_reads, g_peak = counts["graph"]
        e, e_reads, e_peak = counts["eager"]
        _check_counters("mesh", f"mesh_{solver}")       # the last run: a replay
        launches[solver] = {n: (c[n][0] // PROGRAM_RUNS, 0) for n in ops.WRAPPERS}
        g_launch = {n: c[n][0] for n in ops.WRAPPERS if c[n][0]}
        e_launch = {n: e[n][0] for n in ops.WRAPPERS if e[n][0]}
        stray = {n: k for n, k in g_launch.items() if n not in ops.PATHS[f"mesh_{solver}"]}
        (bu, bv), (eu, ev), (su, sv) = res["graph"], res["eager"], res["single"]
        replay_eq = torch.equal(bu, eu) and torch.equal(bv, ev)
        same = torch.equal(bu, su) and torch.equal(bv, sv)
        diff = max(float((bu - su).abs().max()), float((bv - sv).abs().max()))
        med = (float(bu[m:-m, m:-m].median()), float(bv[m:-m, m:-m].median()))
        uw, vw, ur, vr = sharded_pix2uv(bu, bv, nav, 60.0, mesh)
        nav_equal = all(a.is_pinned() and torch.equal(a, b.cpu())
                        for a, b in zip((uw, vw, ur, vr), pix2uv(bu, bv, nav, 60.0)))
        limit = 144 if solver == "sor" else 1080
        stat = {k: (min(t), float(np.median(t))) for k, t in ms.items()}
        say("mesh", f"{solver} {h}x{w} on {MESH_BANDS} bands of cuda:0: banded replay "
                    f"{stat['graph'][0]:.1f} / {stat['graph'][1]:.1f} ms per pair (min / "
                    f"median of {len(ms['graph'])}, CUDA events), eager banded "
                    f"{stat['eager'][0]:.1f} / {stat['eager'][1]:.1f}, single-device replay "
                    f"{stat['single'][0]:.1f} / {stat['single'][1]:.1f} (in turns); first "
                    f"call (eager) {first_s[0]:.2f} s, second (capture + instantiate + "
                    f"replay) {first_s[1]:.2f} s, capture + instantiate "
                    f"{prog.capture_seconds:.2f} s; pools reserve {pool / 2 ** 30:.2f} GiB "
                    f"with the banded program alone; peak {capture_peak:.2f} GiB over its "
                    f"first two calls, {g_peak:.2f} at a replay, {e_peak:.2f} eager; host "
                    f"reads per pair replay {g_reads:g}, eager {e_reads:g} (at most "
                    f"{limit} + 36); {key[solver]} replay {c[key[solver]]} eager "
                    f"{e[key[solver]]}; launches replay {json.dumps(g_launch)} eager "
                    f"{json.dumps(e_launch)}; replay == eager banded {replay_eq}; vs the "
                    f"single-device flow bit-identical {same}, max |d| {diff:.3e} px; median "
                    f"({med[0]:.4f}, {med[1]:.4f}) px, truth (2.4, 0); sharded_pix2uv equal "
                    f"to pix2uv {nav_equal}")
        if (stray or not replay_eq or g_reads != 0 or e_reads > limit + 36
                or g_launch != e_launch or c[key[solver]] != e[key[solver]] or diff > 1e-3
                or not nav_equal or not (abs(med[0] - 2.4) < 0.1 and abs(med[1]) < 0.1
                                         and torch.isfinite(bu).all())):
            raise AssertionError(f"mesh: the banded {solver} pair is off (stray launches "
                                 f"{stray})")
        report.setdefault("_mesh_pairs", {})[solver] = {
            "graph_ms": stat["graph"], "eager_ms": stat["eager"], "single_ms": stat["single"],
            "first_s": first_s, "capture_s": prog.capture_seconds, "pool_bytes": pool,
            "diff": diff}
        flows[solver] = (bu, bv)
        del res, uu, vv, eu, ev, su, sv
        clear_program_cache()
    del z

    # (b') 1024^2 on the (1, 4) mesh, both relaxers: the replay torch.equal
    # to the first call and to the plain banded route; the reach case: a
    # first guess of 20 px downwards with halo_warp 4 (reach 2 px; the guess
    # is 2.5 px at the coarsest of 4 levels) and a hint weight (lambdac 5)
    # that holds v near it runs the wide body at every level, the replay
    # equal to the eager and plain banded routes
    n = SECTOR
    s1, s2 = bench_images(n, n, dev)
    zs = torch.zeros((n, n), device=dev)
    cases = [(solver, OFConfig(kiters=4, solver=solver), zs) for solver in ("sor", "pcg")]
    cases += [(solver, OFConfig(kiters=4, solver=solver, halo_warp=4, lambdac=5.0),
               torch.full((n, n), 20.0, device=dev)) for solver in ("sor", "pcg")]
    wide_fn = sharded._warp_wide
    for solver, cfg, v0 in cases:
        reach = cfg.halo_warp == 4
        prog = sharded.sharded_flow_program(cfg, (n, n), 1, mesh)
        fired = []

        def spy(bands, exchange, hl, warp_fn, tally):
            fired.append(hl)
            wide_fn(bands, exchange, hl, warp_fn, tally)

        sharded._warp_wide = spy           # the eager calls' wide bodies, level by level
        try:
            ops.reset_counters()
            eu, ev = sharded._coarse_to_fine_banded(s1, s2, zs, v0, cfg, mesh, LocalExchange())
            e = ops.counters()
            wide_bodies, levels = len(fired), sorted(set(fired))
            pu, pv = sharded._coarse_to_fine_banded(s1, s2, zs, v0, cfg, mesh, LocalExchange(),
                                                    plain=True)
            fu, fv_ = prog(s1, s2, zs, v0)
        finally:
            sharded._warp_wide = wide_fn
        prog(s1, s2, zs, v0)                    # capture
        ops.reset_counters()
        gu, gv = prog(s1, s2, zs, v0)
        c = ops.counters()
        same = all(torch.equal(a, b) for a, b in ((gu, fu), (gv, fv_), (gu, eu), (gv, ev),
                                                  (gu, pu), (gv, pv)))
        g_launch = {k: c[k][0] for k in ops.WRAPPERS if c[k][0]}
        e_launch = {k: e[k][0] for k in ops.WRAPPERS if e[k][0]}
        tag = " reach (v0 20 px, halo_warp 4, lambdac 5)" if reach else ""
        say("mesh", f"{n}x{n} {solver}{tag}: "
                    f"replay == first call == eager == plain banded {same}; wide bodies in "
                    f"the eager pair {wide_bodies} at level heights {levels}; launches "
                    f"replay {json.dumps(g_launch)} eager {json.dumps(e_launch)}")
        if not same or g_launch != e_launch or (
                reach and len(levels) != cfg.kiters) or (not reach and wide_bodies):
            raise AssertionError(f"mesh: the {n}^2 banded {solver} replay differs"
                                 f"{' (reach case)' if reach else ''}")
    del s1, s2, zs, eu, ev, pu, pv, fu, fv_, gu, gv
    clear_program_cache()

    # (c) banded SRSAL of the SOR flow
    bu, bv = flows["sor"]
    ops.reset_counters()
    ku, kv = sharded_srsal(bu, bv, cth, mesh)
    c = _check_counters("mesh", "mesh_srsal")
    launches["srsal"] = c
    su, sv = srsal_smooth(bu, bv, cth)
    r = max(rel(ku, su), rel(kv, sv))
    say("mesh", f"sharded_srsal {h}x{w}: rel vs srsal_smooth {r:.3e}, equal "
                f"{torch.equal(ku, su) and torch.equal(kv, sv)}")
    if not r <= BILATERAL_REL:
        raise AssertionError("mesh: sharded_srsal differs from srsal_smooth")

    # (d) one band per card, where the machine has several: the banded
    # program captured across the cards, its replay in turns with the eager
    # banded route of the same mesh
    n = torch.cuda.device_count()
    if n > 1:
        cards = [torch.device("cuda", i) for i in range(n)]
        mesh_n = make_mesh((1, n), cards)
        z = torch.zeros((h, w), device=dev)
        for solver in ("sor", "pcg"):
            report.setdefault("_cards_pairs", {})[solver] = cards_pair(
                g1, g2, z, OFConfig(kiters=4, solver=solver), mesh_n, flows[solver])
            clear_program_cache()
        del z
    else:
        say("mesh", "one card: the pair with one band per card (the banded program captured "
                    "across cards) is not run")
    report["_mesh"] = {"launches": launches, "times": times, "bounds": bounds, "errs": errs,
                       "library": library}
    say("mesh", f"phase wall {time.perf_counter() - t_phase:.1f} s")


def fmt_ms(ms):
    """min / median of a list of ms."""
    return f"{min(ms):.1f} / {float(np.median(ms)):.1f}"


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def idle_shares(run, devices):
    """[1 - device busy / wall] per card of ``devices`` for one ``run()``:
    the wall from a run without the profiler (host clock, every card
    synchronised), the busy time from the kernels and copies that
    torch.profiler saw on each card in a second run."""
    sync_all()
    t0 = time.perf_counter()
    run()
    sync_all()
    wall = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        sync_all()
    busy = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            busy[ev.device_index] = (busy.get(ev.device_index, 0.0)
                                     + ev.time_range.elapsed_us() / 1e3)
    return [1.0 - busy.get(d.index, 0.0) / wall for d in devices]


def cards_pair(g1, g2, z, cfg, mesh, want):
    """The mesh phase's (d): the full-disk pair on a (1, n) mesh with band i
    on cuda:i through the banded program (route "graph", one capture
    across the cards), its replay in turns with the eager banded route of
    the same mesh (graph, eager, eager, graph); gated: 0 host reads
    replayed, launches equal, the replay torch.equal to the eager route and
    to ``want`` (the one-card banded replay)."""
    from octane_tpu_torch import ops
    from octane_tpu_torch.flow.program import program_pool_bytes
    from octane_tpu_torch.parallel import LocalExchange, sharded

    solver = cfg.solver
    cards = list(dict.fromkeys(mesh.devices))
    h, w = z.shape
    prog = sharded.sharded_flow_program(cfg, (h, w), 1, mesh)
    info = sharded.last_program_info
    if info["route"] != "graph":
        raise AssertionError(f"mesh: {len(cards)} cards run {info['route']}: {info['reason']}")
    first_s = []
    for _ in range(2):                  # the eager first call, then capture + replay
        sync_all()
        t0 = time.perf_counter()
        prog(g1, g2, z, z)
        sync_all()
        first_s.append(time.perf_counter() - t0)
    pools = [program_pool_bytes(c) / 2 ** 30 for c in cards]
    runs = {"graph": lambda: prog(g1, g2, z, z),
            "eager": lambda: sharded._coarse_to_fine_banded(g1, g2, z, z, cfg, mesh,
                                                            LocalExchange())}
    res, ms, counts = {}, {k: [] for k in runs}, {}
    for label in ("graph", "eager", "eager", "graph"):
        ops.reset_counters()
        sharded.guard_reads.reads = 0
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        uu, vv, t, _ = program_pair(runs[label], n=2)
        c = ops.counters()
        ms[label].extend(t)
        res[label] = (uu, vv)
        counts[label] = (c, (c[f"{solver}_host_syncs"] + sharded.guard_reads.reads) / 2,
                         [torch.cuda.max_memory_allocated(d) / 2 ** 30 for d in cards])
    # each card's idle share, SOR only: under torch.profiler's device tracing
    # the PCG pair on four cards, replayed or eager alike, does not finish
    # within a minute (once it faulted), while runs without device tracing
    # do (tools/profile_torch_pair.py --cards 4 --solver pcg --replays 3
    # --host-first)
    idle = ({label: [round(x, 4) for x in idle_shares(runs[label], cards)] for label in runs}
            if solver == "sor" else None)
    c, g_reads, g_peaks = counts["graph"]
    e, e_reads, e_peaks = counts["eager"]
    key = "pcg_iterations" if solver == "pcg" else "sor_passes"
    g_launch = {k: c[k][0] for k in ops.WRAPPERS if c[k][0]}
    e_launch = {k: e[k][0] for k in ops.WRAPPERS if e[k][0]}
    (gu, gv), (eu, ev) = res["graph"], res["eager"]
    replay_eq = torch.equal(gu, eu) and torch.equal(gv, ev)
    one_card = torch.equal(gu, want[0]) and torch.equal(gv, want[1])
    stat = {k: (min(t), float(np.median(t))) for k, t in ms.items()}
    say("mesh", f"{solver} {h}x{w} on {len(cards)} cards, one band each, route "
                f"{info['route']} ({info['reason']}): replay {stat['graph'][0]:.1f} / "
                f"{stat['graph'][1]:.1f} ms per pair (min / median of {len(ms['graph'])}, "
                f"CUDA events, every card synchronised), eager banded {stat['eager'][0]:.1f} / "
                f"{stat['eager'][1]:.1f} (in turns); first call (eager) {first_s[0]:.2f} s, "
                f"second (capture + instantiate + replay) {first_s[1]:.2f} s, capture + "
                f"instantiate {prog.capture_seconds:.2f} s; pools per card "
                f"{[round(p, 2) for p in pools]} GiB; peaks per card replay "
                f"{[round(p, 2) for p in g_peaks]} eager {[round(p, 2) for p in e_peaks]} GiB; "
                + (f"idle share per card replay {idle['graph']} eager {idle['eager']}; "
                   if idle else "") + f"host reads per pair replay "
                f"{g_reads:g}, eager {e_reads:g}; {key} replay {c[key]} eager {e[key]}; "
                f"launches replay {json.dumps(g_launch)} eager {json.dumps(e_launch)}; replay "
                f"== eager {replay_eq}; == the one-card banded replay {one_card}")
    if (g_reads != 0 or not replay_eq or not one_card or g_launch != e_launch
            or c[key] != e[key]):
        raise AssertionError(f"mesh: the {solver} pair on {len(cards)} cards is off")
    return {"graph_ms": stat["graph"], "eager_ms": stat["eager"], "first_s": first_s,
            "capture_s": prog.capture_seconds, "pools_gib": pools, "idle": idle,
            "reads": (g_reads, e_reads), "launches": g_launch}


DIST_PROCS = 2                      # the dist phase's processes on one card
DIST_TIMEOUT = 480                  # seconds for one run of them, both relaxers


def _dist_scenes(rows, dev, fx):
    """bench.py config 3's 5424^2 pair as band-13 counts through
    scene_from_goes_arrays (the whole arrays as the file holds them; only
    ``rows`` read when given)."""
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.io.readers import scene_from_goes_arrays

    h = w = FULLDISK
    _, x, y, nav, *_ = fx.goes_arrays(np.zeros((h, w), np.int16), fx.FIXTURE_T0)
    g = bench_images(h, w, dev)
    scenes = []
    for i in range(2):
        counts = counts_for(g[i][0], 13, nav.rad_scale[0], nav.rad_offset[0])
        scenes.append(scene_from_goes_arrays(counts, x, y, dataclasses.replace(nav), OFConfig(),
                                             dev, donav=False, t=fx.FIXTURE_T0 + 60.0 * i,
                                             row_range=rows))
    return scenes


def dist_worker(rank, nprocs, url, backend, out):
    """Process ``rank`` of ``nprocs`` of the dist phase (spawned): its row block of the
    full-disk pair, per relaxer the distributed pair through its program
    (the first two calls untimed; over NCCL the replay then timed in turns
    with the eager route, over gloo one eager pair) against the
    single-device and single-process banded flows it computes itself, then
    pix2uv, SRSAL and one interpolated frame on its band; its report goes
    to ``out``.rank.json."""
    from octane_tpu_torch import ops
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow.program import program_pool_bytes
    from octane_tpu_torch.flow.variational import variational_flow
    from octane_tpu_torch.nav.winds import pix2uv
    from octane_tpu_torch.parallel import distributed as D
    from octane_tpu_torch.parallel import make_mesh, sharded, sharded_variational_flow
    from octane_tpu_torch.parallel.post import interpolate_bands, pix2uv_bands, srsal_bands
    from octane_tpu_torch.post.srsal import srsal_smooth
    from octane_tpu_torch.post.temporal import interpolate_frame

    torch.backends.cuda.matmul.allow_tf32 = False
    fx = load_tests_module("torch_fixtures")
    device = "cuda" if backend == "nccl" else "cuda:0"
    D.initialize_multihost(url, nprocs, rank, backend, device)
    rep = {"rank": rank}
    try:
        h = w = FULLDISK
        mesh = D.distributed_mesh(OFConfig(), device)      # one band per process
        dev = D.own_device(mesh)
        ex = D.distributed_exchange(mesh)
        r0, r1 = D.host_row_block(h, mesh)
        rep.update(device=str(dev), rows=[r0, r1], staged=ex.staged)
        t0 = time.perf_counter()
        b1, b2 = _dist_scenes((r0, r1), dev, fx)
        torch.cuda.synchronize()
        rep["ingest_s"] = time.perf_counter() - t0
        w1, w2 = _dist_scenes(None, dev, fx)
        rep["ingest_equal"] = (torch.equal(b1.data, w1.data[:, r0:r1])
                               and torch.equal(b2.data, w2.data[:, r0:r1]))
        z = torch.zeros((h, w), device=dev)
        cth = torch.from_numpy(fx.cth_steps(h, w)).to(dev)
        banded_mesh = make_mesh((1, nprocs), [dev] * nprocs)
        for solver in ("sor", "pcg"):
            cfg = OFConfig(kiters=4, solver=solver)
            su, sv = variational_flow(w1.data, w2.data, z, z, cfg)
            bu, bv = sharded_variational_flow(w1.data, w2.data, z, z, cfg, banded_mesh)
            prog = sharded.sharded_flow_program(cfg, (h, w), 1, mesh, exchange=ex)
            info = sharded.last_program_info
            zr = z[r0:r1].contiguous()
            runs = {"graph": lambda: D.distributed_variational_flow(
                        b1.data, b2.data, (h, w), cfg, mesh, exchange=ex),
                    "eager": lambda: prog._eager(b1.data, b2.data, zr, zr)}
            first_s = []
            for _ in range(2):      # the program's first call and (NCCL) its capture
                ex.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs["graph"]()
                torch.cuda.synchronize()
                first_s.append(time.perf_counter() - t0)
            ex.barrier()
            turns = ("graph", "eager", "eager", "graph") if info["route"] == "graph" else (
                "graph",)
            ms, stats, equal = {}, {}, []
            for label in turns:
                ex.barrier()
                torch.cuda.synchronize()
                ops.reset_counters()
                sharded.guard_reads.reads = 0
                ex.sent.update(dict.fromkeys(ex.sent, 0))
                torch.cuda.reset_peak_memory_stats(dev)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                u, v = runs[label]()
                ev[1].record()
                torch.cuda.synchronize()
                ex.barrier()
                ms.setdefault(label, []).append(ev[0].elapsed_time(ev[1]))
                equal.append([torch.equal(u, su[r0:r1]) and torch.equal(v, sv[r0:r1]),
                              torch.equal(u, bu[r0:r1]) and torch.equal(v, bv[r0:r1])])
                c = ops.counters()
                stats[label] = {
                    "launches": {k: c[k][0] for k in ops.WRAPPERS},
                    "plain": sum(c[k][1] for k in ops.WRAPPERS),
                    "host_reads": c[f"{solver}_host_syncs"] + sharded.guard_reads.reads,
                    "iterations": c["pcg_iterations" if solver == "pcg" else "sor_passes"],
                    "sent": dict(ex.sent),
                    "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
            rep[solver] = dict(
                stats["graph"], route=info["route"], reason=info["reason"],
                ms=min(ms["graph"]), ms_graph=ms["graph"], ms_eager=ms.get("eager", []),
                eager=stats.get("eager"), first_s=first_s, capture_s=prog.capture_seconds,
                pool_gib=program_pool_bytes(dev) / 2 ** 30,
                equal_single=all(e[0] for e in equal), equal_banded=all(e[1] for e in equal),
                median=[float(u.median()), float(v.median())])
            # navigation, SRSAL and one interpolated frame on the band
            _, _, _, nav, *_ = fx.goes_arrays(np.zeros((h, w), np.int16), fx.FIXTURE_T0)
            nav.g2x_offset, nav.g2y_offset = nav.x_offset, nav.y_offset
            winds = pix2uv_bands([(r0, u, v)], nav, 60.0)[0][1]
            rep[solver]["pix2uv_equal"] = all(
                torch.equal(a, b[r0:r1]) for a, b in zip(winds, pix2uv(bu, bv, nav, 60.0)))
            ops.reset_counters()
            smooth = D.local_rows(srsal_bands(D.local_parts(torch.stack([u, v, cth[r0:r1]]), r0,
                                                            mesh, h), mesh, exchange=ex))
            c = ops.counters()
            want = torch.stack(srsal_smooth(bu, bv, cth))[:, r0:r1]
            rep[solver]["srsal_rel"] = rel(smooth, want)
            rep[solver]["srsal_equal"] = torch.equal(smooth, want)
            rep[solver]["srsal_launches"] = (c["bilateral_band"][0],
                                             sum(c[k][1] for k in ops.WRAPPERS))
            if solver == "sor":
                peaks = [torch.maximum(u.abs().amax(), v.abs().amax()) if i == rank else None
                         for i in range(mesh.n)]
                max_disp = max(8, int(-(-max(ex.band_values(peaks).tolist()) // 8) * 8))
                field = D.local_parts(torch.cat([u[None], v[None], b1.data, b2.data]), r0,
                                      mesh, h)
                ex.barrier()
                t0 = time.perf_counter()
                (_, (img, occ)), = interpolate_bands(field, mesh, 1.0 / 3.0, max_disp, ex)
                torch.cuda.synchronize()
                rep["interp_ms"] = (time.perf_counter() - t0) * 1e3
                wi, wo = interpolate_frame(bu, bv, w1.data, w2.data, 1.0 / 3.0)
                rep["interp_equal"] = (torch.equal(img, wi[:, r0:r1])
                                       and torch.equal(occ, wo[r0:r1]))
                rep["max_disp"] = max_disp
            del su, sv, bu, bv
            torch.cuda.empty_cache()
    finally:
        with open(f"{out}.{rank}.json", "w") as f:
            json.dump(rep, f)
        D.shutdown_multihost()


def _spawn(target, argss, timeout):
    """tests/torch_dist_worker.spawn: the processes joined within
    ``timeout`` s; one that fails or hangs (killed) fails the phase."""
    load_tests_module("torch_dist_worker").spawn(target, argss, timeout)


def phase_dist(dev, report):
    """The multi-process path at full disk: 2 processes on cuda:0 over gloo
    (and one per card over NCCL where there are two), then the banded
    patch-match and interpolation at 5424^2 against the whole field, then
    the CLI's -nprocs 2 over gloo."""
    from octane_tpu_torch import ops
    from octane_tpu_torch.flow.patch_match import patch_match_flow, patch_match_flow_sharded
    from octane_tpu_torch.parallel import make_mesh
    from octane_tpu_torch.parallel.post import sharded_interpolate_frame
    from octane_tpu_torch.post.temporal import interpolate_frame

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="octane_dist_")
    try:
        cards = torch.cuda.device_count()
        runs = [("gloo", DIST_PROCS)]
        if cards >= 2:
            runs.append(("nccl", cards))
        else:
            say("dist", "one card: the run with one process per card over NCCL is not done")
        torch.cuda.empty_cache()
        for backend, nprocs in runs:
            out = os.path.join(tmp, backend)
            t0 = time.perf_counter()
            _spawn(dist_worker, [(r, nprocs, f"file://{out}.store", backend, out)
                                 for r in range(nprocs)], DIST_TIMEOUT)
            reps = []
            for r in range(nprocs):
                with open(f"{out}.{r}.json") as f:
                    reps.append(json.load(f))
            say("dist", f"{backend}: {nprocs} processes ran in "
                        f"{time.perf_counter() - t0:.1f} s")
            for rep in reps:
                where = (f"{backend} rank {rep['rank']} on {rep['device']} rows "
                         f"{rep['rows'][0]}:{rep['rows'][1]}")
                say("dist", f"{where}: row block through scene_from_goes_arrays(row_range=) in "
                            f"{rep['ingest_s']:.2f} s, equal to the whole arrays' rows "
                            f"{rep['ingest_equal']}; rows staged through host memory "
                            f"{rep['staged']}")
                ok = rep["ingest_equal"]
                for solver in ("sor", "pcg"):
                    s = rep[solver]
                    path = ops.PATHS[f"mesh_{solver}"]
                    launched = all(s["launches"][k] > 0 for k in path)
                    say("dist", f"{where} {solver}: route {s['route']} ({s['reason']}); "
                                f"{fmt_ms(s['ms_graph'])} ms per pair through the program "
                                f"(CUDA events between barriers, after its first call "
                                f"{s['first_s'][0]:.2f} s and second {s['first_s'][1]:.2f} s)"
                                + (f", eager banded loop {fmt_ms(s['ms_eager'])} ms in turns, "
                                   f"capture + instantiate {s['capture_s']:.2f} s, pools "
                                   f"{s['pool_gib']:.2f} GiB" if s["eager"] else "")
                                + f"; peak {s['peak_gib']:.2f} GiB; rows torch.equal to the "
                                f"single-device flow {s['equal_single']} and to the "
                                f"single-process banded flow {s['equal_banded']}; launches "
                                + json.dumps({k: s["launches"][k] for k in path})
                                + f", plain calls {s['plain']}; host reads {s['host_reads']}"
                                + (f" (eager {s['eager']['host_reads']})" if s["eager"] else "")
                                + f"; sent {s['sent']['messages']} messages of "
                                f"{s['sent']['bytes']} bytes, {s['sent']['collectives']} "
                                f"collectives gathering {s['sent']['gathered']} bytes; pix2uv "
                                f"equal {s['pix2uv_equal']}; SRSAL rel {s['srsal_rel']:.2e} "
                                f"(equal {s['srsal_equal']}, bilateral_band launches "
                                f"{s['srsal_launches'][0]}, plain {s['srsal_launches'][1]}); "
                                f"median ({s['median'][0]:.4f}, {s['median'][1]:.4f})")
                    ok = ok and (s["equal_single"] and s["equal_banded"] and launched
                                 and s["plain"] == 0 and s["pix2uv_equal"]
                                 and s["srsal_rel"] <= BILATERAL_REL
                                 and s["srsal_launches"][0] > 0 and s["srsal_launches"][1] == 0)
                    if backend == "nccl":
                        # the captured program: no host read, the eager route's launches
                        e = s["eager"]
                        ok = ok and (s["route"] == "graph" and e is not None
                                     and s["host_reads"] == 0
                                     and s["launches"] == e["launches"]
                                     and s["iterations"] == e["iterations"])
                    elif s["route"] != "eager":
                        ok = False          # gloo stays eager
                say("dist", f"{where}: one interpolated frame on the band (max_disp "
                            f"{rep['max_disp']}) in {rep['interp_ms']:.1f} ms, equal to "
                            f"interpolate_frame's rows {rep['interp_equal']}")
                if not (ok and rep["interp_equal"]):
                    raise AssertionError(f"dist: {where} is off")
            report.setdefault("_dist", {})[backend] = reps

        # the banded patch-match and interpolation at full disk on 4 bands
        h = w = FULLDISK
        mesh = make_mesh((1, 4), [dev] * 4)
        g1, g2 = bench_images(h, w, dev)
        ops.reset_counters()
        t0 = time.perf_counter()
        want = patch_match_flow(g1[0], g2[0])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = patch_match_flow_sharded(g1[0], g2[0], mesh)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        # one search kernel for the whole image, one a band
        pm_equal = (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                    and ops.counters()["patch_match"] == (5, 0))
        say("dist", f"patch_match_flow_sharded {h}x{w} on 4 bands of cuda:0 "
                    f"({t2 - t1:.2f} s) equal to patch_match_flow ({t1 - t0:.2f} s) {pm_equal}; "
                    f"search launches, plain searches {ops.counters()['patch_match']}")
        del got, want
        u, v = noisy_flow(h, w, dev, 71)
        max_disp = max(8, int(-(-float(max(u.abs().max(), v.abs().max())) // 8) * 8))
        want = interpolate_frame(u, v, g1, g2, 1.0 / 3.0)
        got = sharded_interpolate_frame(u, v, g1, g2, 1.0 / 3.0, mesh, max_disp=max_disp)
        interp_equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        say("dist", f"sharded_interpolate_frame {h}x{w} on 4 bands of cuda:0 (max_disp "
                    f"{max_disp}) equal to interpolate_frame {interp_equal}")
        if not (pm_equal and interp_equal):
            raise AssertionError("dist: the banded patch-match or frame differs")
        del got, want, u, v, g1, g2

        dist_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("dist", f"phase wall {time.perf_counter() - t_phase:.1f} s")


def dist_launches(report, name, path):
    """The launches of kernel ``name`` in each process of the gloo run of
    the dist phase: on its distributed pair of relaxer ``path``, or, for
    the bilateral, on its banded SRSAL of the SOR pair."""
    reps = report["_dist"]["gloo"]
    if path == "srsal":
        return [rep["sor"]["srsal_launches"][0] for rep in reps]
    return [rep[path]["launches"][name] for rep in reps]


def dist_cli_worker(argv):
    from octane_tpu_torch import cli

    if cli.main(argv):
        raise SystemExit(1)


def dist_cli(tmp):
    """-nprocs 2 through the CLI over gloo on one card on the codec-written
    512^2 product fixture files: each process writes its part file, process
    0 merges them; the product equal, as the codec reads it, to the
    single-process -mesh 2x1 product."""
    from octane_tpu_torch.io import hdf5

    fx = load_tests_module("torch_fixtures")
    f1 = fx.make_goes_file(os.path.join(tmp, "g1.nc"), fx.fixture_counts(0, 0), band=13)
    f2 = fx.make_goes_file(os.path.join(tmp, "g2.nc"), fx.fixture_counts(3.0, -1.5),
                           band=13, t=fx.FIXTURE_T0 + 60.0)
    argv = ["-i1", f1, "-i2", f2, "-mesh", "2x1", "-solver", "sor", "-pd", "--device", "cuda:0",
            "--dist-backend", "gloo"]
    multi, single = os.path.join(tmp, "multi"), os.path.join(tmp, "single")
    t0 = time.perf_counter()
    _spawn(dist_cli_worker, [(argv + ["-o", multi, "-nprocs", "2", "-procid", str(r),
                                      "-coordinator", f"file://{tmp}/cli.store"],)
                             for r in range(2)], 300)
    t1 = time.perf_counter()
    _spawn(dist_cli_worker, [(argv + ["-o", single],)], 300)
    parts = sorted(os.listdir(os.path.join(multi, ".parts")))
    with hdf5.File(os.path.join(multi, "outfile.nc")) as a, \
            hdf5.File(os.path.join(single, "outfile.nc")) as b:
        same = a.keys() == b.keys() and all(np.array_equal(a[k][()], b[k][()])
                                            for k in b.keys())
    say("dist", f"-nprocs 2 over gloo on cuda:0 through the CLI on the codec-written 512^2 "
                f"fixture ({t1 - t0:.1f} s, part files {parts}): product equal to the "
                f"single-process -mesh 2x1 product ({time.perf_counter() - t1:.1f} s) {same}")
    if not same:
        raise AssertionError("dist: the -nprocs product differs")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if "interp" in only and "hybrid" not in only:
        ap.error("the interp phase runs on the hybrid phase's flow: add hybrid")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    report = {}
    phase_env()
    from octane_tpu_torch.flow.variational import clear_program_cache

    if "build" in only:
        phase_build()
    phases = [("io", lambda: phase_io(dev)),
              ("warp", lambda: phase_warp(dev, report)),
              ("pcg", lambda: phase_pcg(dev, report)),
              ("assemble", lambda: phase_assemble(dev, report)),
              ("sor", lambda: phase_sor(dev, report)),
              ("pyramid", lambda: phase_pyramid(dev)),
              ("main", lambda: phase_main(dev)),
              ("golden", lambda: phase_golden(dev)),
              ("srsal", lambda: phase_srsal(dev, report)),
              ("fulldisk", lambda: phase_fulldisk(dev, report)),
              ("hybrid", lambda: phase_hybrid_interp(dev, report, "interp" in only)),
              ("multichannel", lambda: phase_multichannel(dev, report)),
              ("flatgrid", lambda: phase_flatgrid(dev)),
              ("sequence", lambda: phase_sequence(dev)),
              ("mesh", lambda: phase_mesh(dev, report)),
              ("dist", lambda: phase_dist(dev, report)),
              ("program", lambda: phase_program(dev, report)),
              ("tracer", lambda: phase_tracer(dev))]
    for name, phase in phases:
        if name in only:
            phase()
            clear_program_cache()        # each phase's programs leave the card

    if {"warp", "pcg", "assemble", "sor", "srsal", "fulldisk", "hybrid", "multichannel"} <= only:
        from octane_tpu_torch import ops

        # launches: each solver path's from the 5424^2 pair, the bilateral
        # kernel's from the SRSAL product path, the search kernel's from the
        # 5424^2 hybrid PCG pair
        hybrid_launches = report["_launches_hybrid"]
        launches = dict(report["_launches"], srsal=report["_launches_srsal"],
                        patch_match=hybrid_launches["pcg"])
        c3_launches = report["_launches_c3"]
        times, bounds, library = report["_times"], report["_bounds"], report["_library"]
        entries = []
        for name, wrapper, src, replaces, tkey in KERNELS:
            path = next(p for p in ("pcg", "sor", "srsal", "patch_match")
                        if wrapper in ops.PATHS[p])
            # on the hybrid pair of its relaxer; a kernel of neither relaxer
            # (the bilateral, held to 0 above; the search, once a pair) sums
            # both pairs' counts
            hybrid, c3 = (sum(c[wrapper][0] for s, c in counts.items()
                              if s == path or path not in counts)
                          for counts in (hybrid_launches, c3_launches))
            entry = {"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[path][wrapper][0],
                     "hybrid_launches": hybrid, "c3_launches": c3,
                     "max_abs_err": report[name]["max_abs_err"],
                     "ms": times[tkey][0], "plain_ms": times[tkey][1],
                     "bound_ms": bounds[tkey][0], "bound_by": bounds[tkey][1],
                     "library_ms": library.get(tkey)}
            if name in report["_c3"]:
                # the warp and the assembly at C = 3 on the three-channel pair
                (ms, plain_ms), (b_ms, b_by), lib = report["_c3"][name]
                entry.update(c3_ms=ms, c3_plain_ms=plain_ms, c3_bound_ms=b_ms,
                             c3_bound_by=b_by, c3_library_ms=lib)
            if "_mesh" in report and wrapper in ("assemble_cf", "assemble_pcg", "pcg_pass_b"):
                # kernels that the banded pair launches on each band as they are
                solver = "sor" if wrapper == "assemble_cf" else "pcg"
                entry["mesh_launches"] = report["_mesh"]["launches"][solver][wrapper][0]
                if "_dist" in report:
                    entry["dist_launches"] = dist_launches(report, wrapper, solver)
            entries.append(entry)
        if "_mesh" in report:
            mesh = report["_mesh"]
            for name, src, replaces, path in MESH_KERNELS:
                ms, plain_ms = mesh["times"][name]
                b_ms, b_by = mesh["bounds"][name]
                entry = {"name": name, "route": "cuda", "source": src,
                         "replaces": replaces, "launches": mesh["launches"][path][name][0],
                         "max_abs_err": mesh["errs"][name], "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": mesh["library"].get(name)}
                if "_dist" in report:
                    entry["dist_launches"] = dist_launches(report, name, path)
                entries.append(entry)
        print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
