"""The device mesh of the row-banded path (counterpart of
octane_tpu.parallel.mesh).

A mesh is its (rows, cols) shape and one torch device per band: the
(ry, rx) grid of the JAX package runs here as n = ry * rx row bands, band i
on ``devices[i]``, rows split by ceiling division as ``host_row_block`` of
octane_tpu/parallel/distributed.py:42-52 splits them, rounded up to 8 rows
as octane_tpu/parallel/cg.py:79 rounds its bands to the block height: the
bands' 32 x 8 reduction blocks are then the whole image's, so the banded
solvers' sums equal one device's.  The list may name one
device many times (all bands on one card, or on the CPU).  ``image_sharding``
and ``flow_sharding`` have no counterpart: a band's tensors simply live on
its device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """(ry, rx) and the n = ry * rx devices of the bands, in band order."""

    shape: Tuple[int, int]
    devices: Tuple[torch.device, ...]

    @property
    def n(self) -> int:
        return len(self.devices)


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA card), shape
    (1, n) when none is given, as octane_tpu's make_mesh."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    if shape is None:
        shape = (1, n)
    shape = (int(shape[0]), int(shape[1]))
    if n == 0 or shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return Mesh(shape, devices)


BAND_ALIGN = 8      # rows of a reduction block (ops.pcg.BLOCK_Y)


def band_rows(h: int, n: int, i: int) -> Tuple[int, int]:
    """[r0, r1) of band i of n over h rows: ceil(h / n) rows rounded up to
    a multiple of 8 each, the last bands shorter or empty."""
    rows = -(-(-(-h // n)) // BAND_ALIGN) * BAND_ALIGN
    r0 = min(i * rows, h)
    return r0, min(r0 + rows, h)


def mesh_bands(mesh: Mesh, h: int):
    """[(device, r0, r1), ...] of the mesh's non-empty bands over h rows."""
    bands = [(dev, *band_rows(h, mesh.n, i)) for i, dev in enumerate(mesh.devices)]
    return [(dev, r0, r1) for dev, r0, r1 in bands if r1 > r0]
