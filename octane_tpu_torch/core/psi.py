"""Robust penalty derivative psi'(x) = 1/sqrt(x + 1e-6) (counterpart of
octane_tpu.core.psi; oct_variational_optical_flow.cu:72-108)."""

from __future__ import annotations

import torch

_EPS = 1e-6


def psi_deriv(x: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt(x + _EPS)
