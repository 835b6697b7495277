"""Variational flow: stencil assembly, PCG, the coarse-to-fine solver,
patch-match and the flow dispatcher (counterpart of octane_tpu.flow)."""

from octane_tpu_torch.flow.cg import pcg_solve
from octane_tpu_torch.flow.dispatcher import compute_flow
from octane_tpu_torch.flow.patch_match import patch_match_flow
from octane_tpu_torch.flow.stencil import StencilSystem, apply_stencil, assemble
from octane_tpu_torch.flow.variational import solve_level, variational_flow

__all__ = ["pcg_solve", "compute_flow", "patch_match_flow", "StencilSystem", "apply_stencil",
           "assemble", "solve_level", "variational_flow"]
