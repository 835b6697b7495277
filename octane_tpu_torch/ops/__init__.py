"""Kernel wrappers: a level of the solver pyramid (``ops.pyramid``), the
bilinear warp (``ops.warp``), the two Jacobi-PCG passes (``ops.pcg``), the
fused assembly in the SOR and the PCG layouts (``ops.assemble``), the SOR
pass (``ops.sor``), the SRSAL bilateral smoother (``ops.bilateral``) and
patch-match's zero-guess search (``ops.patch_match``), built by
``ops.build``.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors, and counts both.  The solver's internal
plain route (flow.variational, parallel.sharded) adds its direct calls of
the plain versions to the same ``plain_calls`` counters.  ``PATHS`` names
the wrappers each relaxer's solve goes through, the one SRSAL smoothing
and the one a zero-guess patch-match search go through, on one device and
(``mesh_*``) on the row bands of the mesh path, which run the band forms
``warp_band``, ``sor_pass_band``, ``pcg_pass_a_band`` and
``bilateral_band`` (the assembly takes a band's
rows itself; a band's pyramid levels are still the plain composition,
``core.zoom.pyramid_downsample_rows``, though ``pyramid_level`` takes a
band's slab).  ``counted_plain`` makes such a counted direct call.

``stamp`` is the tracer's clock stamp (``ops.stamp``, csrc/stamp.cu),
launched only while utils.profiling's tracer is on.

A banded pair also reports, through ``record_wide_rounds``, the device
tally of its rounds whose band warp fell back to the whole level (the
reach test's body, parallel.sharded), which ``counters()`` gives as
``wide_warp_rounds``, the last pair's.  A pair reports its device count of
PCG iterations or SOR passes through ``record_pair``; a replayed pair (any
program of flow.program.CapturedPair: flow.variational.FlowProgram and
parallel.sharded's banded programs) also reports what its graph launches,
which the wrappers, called only at capture, do not count: the nodes that
every replay runs, and for each kind of guarded body the launches of one
body, which ran as often as that kind's device count says.
``counters()`` adds those to the wrappers' own counts, reading the device
counts there and nowhere else, and gives the last pair's count as
``pcg_iterations`` / ``sor_passes``.  A replay adds nothing to the
drivers' host syncs.  A traced pair (utils.profiling's ``Marks``) also
reports each GNC round's count; they are summed over pairs on the device
and given as ``pcg_iterations_by_round`` / ``sor_passes_by_round``, lists
of kiters x gnc_steps x liters counts in the order the rounds run (empty
where no traced pair ran since the last reset).

``record_host_planes`` notes the product planes that ``io.host.to_host``
delivered into page-locked host memory; ``counters()`` gives their number
and bytes since the last reset as ``host_planes`` / ``host_plane_bytes``
(0 where every plane was made on the CPU).

``counters()["patch_match"]`` is (search kernel launches, plain searches);
``flow.patch_match`` adds its first-guess searches and each search over
CPU bands as one plain search through ``counted_plain``.
"""

import torch

from octane_tpu_torch.ops import assemble as _assemble
from octane_tpu_torch.ops import bilateral as _bilateral
from octane_tpu_torch.ops import patch_match as _patch_match
from octane_tpu_torch.ops import pcg as _pcg
from octane_tpu_torch.ops import pyramid as _pyramid
from octane_tpu_torch.ops import sor as _sor
from octane_tpu_torch.ops import stamp as _stamp
from octane_tpu_torch.ops import warp as _warp

WRAPPERS = {"warp": _warp.warp, "pcg_pass_a": _pcg.pcg_pass_a,
            "pcg_pass_b": _pcg.pcg_pass_b, "assemble_cf": _assemble.assemble_cf,
            "assemble_pcg": _assemble.assemble_pcg,
            "sor_pass": _sor.sor_pass, "bilateral": _bilateral.bilateral,
            "warp_band": _warp.warp_band, "pcg_pass_a_band": _pcg.pcg_pass_a_band,
            "sor_pass_band": _sor.sor_pass_band, "bilateral_band": _bilateral.bilateral_band,
            "pyramid_level": _pyramid.pyramid_level, "stamp": _stamp.stamp,
            "patch_match": _patch_match.patch_match_search}
PATHS = {"pcg": ("pyramid_level", "warp", "assemble_pcg", "pcg_pass_a", "pcg_pass_b"),
         "sor": ("pyramid_level", "warp", "assemble_cf", "sor_pass"),
         "srsal": ("bilateral",), "patch_match": ("patch_match",),
         "mesh_pcg": ("warp_band", "assemble_pcg", "pcg_pass_a_band", "pcg_pass_b"),
         "mesh_sor": ("warp_band", "assemble_cf", "sor_pass_band"),
         "mesh_srsal": ("bilateral_band",)}


_last_count: dict = {}      # solver -> the last pair's device count
_graph_nodes: dict = {}     # wrapper -> launches of replayed unguarded nodes
_graph_bodies: dict = {}    # (wrapper, device) -> device sum of guarded launches
_by_round: dict = {}        # solver -> int64 device sums of the traced pairs' rounds
_wide: dict = {}            # "rounds" -> the last banded pair's device tally of wide warps
_host: dict = {}            # "planes", "bytes" -> product planes delivered to page-locked memory


def counted_plain(wrapper, plain_fn):
    """``plain_fn`` on any device, each call added to ``wrapper.plain_calls``."""
    def run(*args, **kwargs):
        wrapper.plain_calls += 1
        return plain_fn(*args, **kwargs)
    return run


def reset_counters() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        fn.plain_calls = 0
    for driver in (_pcg.pcg_solve_fused, _sor.sor_solve_cf):
        driver.host_syncs = 0
    for tally in (_last_count, _graph_nodes, _graph_bodies, _by_round, _wide, _host):
        tally.clear()


def record_pair(solver: str, count, nodes=None, guarded=(), rounds=None) -> None:
    """Note a pair of ``solver`` whose relaxer ran ``count`` (an int32
    device scalar) iterations or passes.  For a replayed graph, ``nodes``
    {wrapper: launches} are its nodes outside guarded bodies and
    ``guarded`` [({wrapper: launches of one body}, the device tally of the
    bodies that ran), ...] has one pair per kind of guarded body; the
    guarded launches are summed on the device, with no host read.  A
    traced pair gives ``rounds``, its int32 device count of each round."""
    _last_count[solver] = count
    if rounds is not None:
        total = _by_round.get(solver)
        _by_round[solver] = rounds.to(torch.int64) + (0 if total is None else total)
    for name, n in (nodes or {}).items():
        _graph_nodes[name] = _graph_nodes.get(name, 0) + n
    for body, ran in guarded:
        for name, n in body.items():
            key = (name, ran.device)
            _graph_bodies[key] = _graph_bodies.get(key, 0) + n * ran.to(torch.int64)


def record_wide_rounds(rounds) -> None:
    """Note a banded pair whose band warp fell back to the whole level in
    ``rounds`` rounds (an int32 device scalar, read in ``counters()``)."""
    _wide["rounds"] = rounds


def record_host_planes(planes) -> None:
    """Note ``planes``, delivered into page-locked host memory."""
    _host["planes"] = _host.get("planes", 0) + len(planes)
    _host["bytes"] = _host.get("bytes", 0) + sum(p.numel() * p.element_size() for p in planes)


def counters() -> dict:
    """{name: (kernel launches, plain calls)} plus the PCG and SOR drivers'
    host syncs, the last pair's iterations (PCG) and passes (SOR), the
    traced pairs' counts by round, the last banded pair's
    ``wide_warp_rounds``, read from the device, and ``host_planes`` /
    ``host_plane_bytes``.  A wrapper's launches include those of replayed
    graphs (see the module docstring)."""
    launches = {name: fn.launches + _graph_nodes.get(name, 0)
                for name, fn in WRAPPERS.items()}
    for (name, _), total in _graph_bodies.items():
        launches[name] += int(total)
    out = {name: (launches[name], fn.plain_calls) for name, fn in WRAPPERS.items()}
    out["pcg_host_syncs"] = _pcg.pcg_solve_fused.host_syncs
    out["sor_host_syncs"] = _sor.sor_solve_cf.host_syncs
    for key, solver in (("pcg_iterations", "pcg"), ("sor_passes", "sor")):
        out[key] = int(_last_count[solver]) if solver in _last_count else 0
        out[f"{key}_by_round"] = _by_round[solver].tolist() if solver in _by_round else []
    out["wide_warp_rounds"] = int(_wide["rounds"]) if _wide else 0
    out["host_planes"] = _host.get("planes", 0)
    out["host_plane_bytes"] = _host.get("bytes", 0)
    return out


__all__ = ["WRAPPERS", "PATHS", "counted_plain", "reset_counters", "record_pair",
           "record_wide_rounds", "record_host_planes", "counters"]
