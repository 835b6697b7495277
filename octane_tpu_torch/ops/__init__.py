"""Kernel wrappers: the bilinear warp (``ops.warp``), the two Jacobi-PCG
passes (``ops.pcg``), the fused assembly (``ops.assemble``), the SOR
pass (``ops.sor``) and the SRSAL bilateral smoother
(``ops.bilateral``), built by ``ops.build``.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors, and counts both.  The solver's internal
plain route (flow.variational, parallel.sharded) adds its direct calls of
the plain versions to the same ``plain_calls`` counters.  ``PATHS`` names
the wrappers each relaxer's solve goes through, and the one SRSAL
smoothing goes through, on one device and (``mesh_*``) on the row bands of
the mesh path, which run the band forms ``warp_band``, ``sor_pass_band``,
``pcg_pass_a_band`` and ``bilateral_band``.
"""

from octane_tpu_torch.ops import assemble as _assemble
from octane_tpu_torch.ops import bilateral as _bilateral
from octane_tpu_torch.ops import pcg as _pcg
from octane_tpu_torch.ops import sor as _sor
from octane_tpu_torch.ops import warp as _warp

WRAPPERS = {"warp": _warp.warp, "pcg_pass_a": _pcg.pcg_pass_a,
            "pcg_pass_b": _pcg.pcg_pass_b, "assemble_cf": _assemble.assemble_cf,
            "sor_pass": _sor.sor_pass, "bilateral": _bilateral.bilateral,
            "warp_band": _warp.warp_band, "pcg_pass_a_band": _pcg.pcg_pass_a_band,
            "sor_pass_band": _sor.sor_pass_band, "bilateral_band": _bilateral.bilateral_band}
PATHS = {"pcg": ("warp", "pcg_pass_a", "pcg_pass_b"),
         "sor": ("warp", "assemble_cf", "sor_pass"),
         "srsal": ("bilateral",),
         "mesh_pcg": ("warp_band", "pcg_pass_a_band", "pcg_pass_b"),
         "mesh_sor": ("warp_band", "assemble_cf", "sor_pass_band"),
         "mesh_srsal": ("bilateral_band",)}


def reset_counters() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        fn.plain_calls = 0
    _pcg.pcg_solve_fused.host_syncs = 0
    _sor.sor_solve_cf.host_syncs = 0


def counters() -> dict:
    """{name: (kernel launches, plain calls)} plus the PCG and SOR drivers'
    host syncs."""
    out = {name: (fn.launches, fn.plain_calls) for name, fn in WRAPPERS.items()}
    out["pcg_host_syncs"] = _pcg.pcg_solve_fused.host_syncs
    out["sor_host_syncs"] = _sor.sor_solve_cf.host_syncs
    return out


__all__ = ["WRAPPERS", "PATHS", "reset_counters", "counters"]
