"""Product planes into page-locked host memory: the last step of
``flow.dispatcher.compute_flow`` where its planes are on CUDA devices.

``to_host(bands, h)`` takes a product's row bands [(r0, (plane rows, ...))],
each on the card that computed it (one card's whole planes are one band at
row 0), and copies each band's rows from its own card into rows
[r0, r0 + rows) of fresh page-locked host planes of ``h`` rows: one DMA a
band and plane on the card's current stream, every card copying at once.
It returns once every plane is complete, so a caller may read them with
``.numpy()`` at once.

The planes come from torch's caching host allocator: once a pair's planes
are freed the next pair's reuse their blocks, and no two calls share
storage, so a caller may keep one pair's planes while the next runs.
``ops.counters()`` counts the planes and their bytes (``host_planes``,
``host_plane_bytes``); while the tracer is on each card's copies are a span
``octane.flow.to_host`` with device stamps on that card (utils.profiling).
CPU planes never come here: they are host memory already.
"""

from __future__ import annotations

import torch

from octane_tpu_torch import ops
from octane_tpu_torch.utils import profiling


def to_host(bands, h: int):
    """Whole page-locked host planes of the row bands [(r0, (rows, ...))]
    on CUDA devices; see the module docstring."""
    planes = tuple(torch.empty((h, *t.shape[1:]), dtype=t.dtype, pin_memory=True)
                   for t in bands[0][1])
    cards = []
    for r0, rows in bands:
        card = rows[0].device
        with profiling.span("octane.flow.to_host", card):
            for plane, t in zip(planes, rows):
                plane[r0:r0 + t.shape[0]].copy_(t, non_blocking=True)
        if card not in cards:
            cards.append(card)
    for card in cards:
        torch.cuda.current_stream(card).synchronize()
    ops.record_host_planes(planes)
    return planes
