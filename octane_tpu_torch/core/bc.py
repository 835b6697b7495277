"""Boundary-condition shifts (counterpart of octane_tpu.core.bc).

* clamp: out[i] = a[clip(i + offset, 0, n-1)], used by gradients, blurs
  and interpolation taps (include/oct_bc.h);
* mirror-at-1: the solver's edge fixup, out[0] (offset -1) = a[1] and
  out[n-1] (offset +1) = a[n-2] (oct_variational_optical_flow.cu:629-652);
* reflect: the SRSAL boundary map of indices, -k -> k and n-1+k -> n-k
  (oct_bc_cuda), for indices within n - 1 of the grid.

Both are slices concatenated along one axis: exact copies, and no index
tensor has to reach the device.
"""

from __future__ import annotations

import torch


def _edge(a: torch.Tensor, axis: int, index: int, reps: int) -> torch.Tensor:
    """``a``'s slice ``index`` along ``axis``, repeated ``reps`` times."""
    e = a.narrow(axis, index, 1)
    shape = list(e.shape)
    shape[axis] = reps
    return e.expand(shape)


def clamp_shift(a: torch.Tensor, offset: int, axis: int) -> torch.Tensor:
    """out[i] = a[clip(i + offset, 0, n-1)] along ``axis``."""
    if offset == 0:
        return a
    axis = axis % a.dim()
    n = a.shape[axis]
    k = min(abs(offset), n - 1)
    if offset > 0:
        return torch.cat([a.narrow(axis, k, n - k), _edge(a, axis, n - 1, k)], dim=axis)
    return torch.cat([_edge(a, axis, 0, k), a.narrow(axis, 0, n - k)], dim=axis)


def mirror_shift(a: torch.Tensor, offset: int, axis: int) -> torch.Tensor:
    """Distance-1 neighbour with the solver's mirror fixup (offset +-1)."""
    if offset not in (-1, 1):
        raise ValueError("mirror_shift only supports unit offsets")
    n = a.shape[axis]
    if offset == 1:
        return torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 2, 1)], dim=axis)
    return torch.cat([a.narrow(axis, 1, 1), a.narrow(axis, 0, n - 1)], dim=axis)


def reflect_index(i, n: int):
    """The reference's reflect map of an index (int or integer tensor) into
    [0, n): -k -> k, n-1+k -> n-k (oct_bc_cuda; one reflection)."""
    if torch.is_tensor(i):
        i = i.abs()
        return torch.where(i >= n, 2 * n - 1 - i, i)
    i = abs(i)
    return 2 * n - 1 - i if i >= n else i
