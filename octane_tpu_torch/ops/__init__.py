"""Kernel wrappers: the bilinear warp (``ops.warp``) and the two Jacobi-PCG
passes (``ops.pcg``), built by ``ops.build``.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors, and counts both.  The solver's internal
plain route (flow.variational) adds its direct calls of the plain versions
to the same ``plain_calls`` counters.
"""

from octane_tpu_torch.ops import pcg as _pcg
from octane_tpu_torch.ops import warp as _warp

WRAPPERS = {"warp": _warp.warp, "pcg_pass_a": _pcg.pcg_pass_a,
            "pcg_pass_b": _pcg.pcg_pass_b}


def reset_counters() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        fn.plain_calls = 0
    _pcg.pcg_solve_fused.host_syncs = 0


def counters() -> dict:
    """{name: (kernel launches, plain calls)} plus the PCG host syncs."""
    out = {name: (fn.launches, fn.plain_calls) for name, fn in WRAPPERS.items()}
    out["pcg_host_syncs"] = _pcg.pcg_solve_fused.host_syncs
    return out


__all__ = ["WRAPPERS", "reset_counters", "counters"]
