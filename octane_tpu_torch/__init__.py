"""OCTANE on PyTorch and CUDA: the dense variational optical-flow pair path
on GOES (channels 1-3), polar and mercator grids, with cloud-top height,
first-guess winds, SRSAL smoothing, patch-match and hybrid flow, temporal
interpolation and warm-started sequences with checkpoint/resume.

A port of the JAX/Pallas package ``octane_tpu`` to PyTorch, with every
Pallas kernel rewritten as a hand-written CUDA kernel for Hopper
(``sm_90a``).  The module layout follows ``octane_tpu`` so each
counterpart is found under the same name:

  core/         <- clamp/mirror shifts, blur, bicubic, pyramid and ingest
                   zooms, gradients
  nav/          <- GOES, polar and mercator navigation (float64),
                   pixel<->wind
  flow/         <- stencil assembly, PCG and SOR reference loops,
                   coarse-to-fine solver, dispatcher
  post/         <- SRSAL bilateral smoothing of the flow, temporal
                   interpolation
  io/           <- data model, GOES L1b (channels 1-3), polar/mercator,
                   CLAVR-x CTH and first-guess readers, product writers,
                   native helpers
  ops/          <- kernel wrappers (warp, Jacobi-PCG passes, fused assembly,
                   SOR pass, bilateral), the SOR solve loop and the
                   kernels' build
  csrc/         <- the CUDA sources
  pipeline/cli  <- the pair pipeline and its command line
  sequence      <- warm-started sequences with checkpoint/resume

  config        <- OFConfig: octane_tpu's options, names and defaults,
                   without its TPU execution options

The package imports ``torch`` and never ``jax``, nor anything of
``octane_tpu``.
"""

from octane_tpu_torch.config import OFConfig

__version__ = "0.1.0"

__all__ = ["OFConfig", "__version__"]
