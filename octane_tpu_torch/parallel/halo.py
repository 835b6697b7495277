"""Row exchange between the bands of a field (counterpart of
octane_tpu.parallel.halo).

A banded field is its list of parts ``[(r0, tensor (..., rows, W)), ...]``,
one per band in row order, each on its band's device.  ``fetch(parts, a, b,
out)`` fills ``out`` (..., b - a, W) with the field's rows [a, b), taking
each row from the band that owns it; rows beyond the field's edges come
from one of three fills:

* ``"edge"``: the edge row repeated (halo.py:16-43 of octane_tpu);
* ``"reflect"``: the reference's map, -k -> k and H-1+k -> H-k
  (octane_tpu/parallel/post.py:76-101, oct_bc_cuda);
* ``"constant"``: ``value``.

``LocalExchange`` moves the rows with ``copy_`` into ``out``, a buffer the
caller allocates once, so the same code serves a neighbour on the same
device and one on another card of the process.  A backend over processes
(``torch.distributed``) implements the same ``fetch``.
"""

from __future__ import annotations

import torch

from octane_tpu_torch.core.bc import reflect_index

FILLS = ("edge", "reflect", "constant")


def field_rows(parts) -> int:
    """The field's height: the end of its last part."""
    r0, t = parts[-1]
    return r0 + t.shape[-2]


class LocalExchange:
    """Rows of banded fields within one process, by ``copy_``."""

    @staticmethod
    def _copy(parts, a: int, b: int, out, at: int) -> None:
        """out rows [at, at + b - a) = field rows [a, b), all inside the field."""
        for r0, t in parts:
            s, e = max(a, r0), min(b, r0 + t.shape[-2])
            if s < e:
                out[..., at + s - a:at + e - a, :].copy_(t[..., s - r0:e - r0, :])

    def fetch(self, parts, a: int, b: int, out: torch.Tensor, fill: str = "edge",
              value: float = 0.0) -> torch.Tensor:
        """Fill ``out`` with rows [a, b) of the field ``parts``; see the
        module docstring.  Returns ``out``."""
        if fill not in FILLS:
            raise ValueError(f"fill must be one of {FILLS}, got {fill!r}")
        h = field_rows(parts)
        if out.shape[-2] != b - a:
            raise ValueError(f"out holds {out.shape[-2]} rows, not the {b - a} of [{a}, {b})")
        lo, hi = min(max(a, 0), h), max(min(b, h), 0)
        if lo < hi:
            self._copy(parts, lo, hi, out, lo - a)
        for r in [*range(a, min(b, 0)), *range(max(a, h), b)]:
            if fill == "constant":
                out[..., r - a, :].fill_(value)
                continue
            src = (0 if r < 0 else h - 1) if fill == "edge" else reflect_index(r, h)
            self._copy(parts, src, src + 1, out, r - a)
        return out

    def rows(self, parts, a: int, b: int, device, fill: str = "edge",
             value: float = 0.0) -> torch.Tensor:
        """A new tensor on ``device`` with rows [a, b) of the field."""
        r0, t = parts[0]
        out = torch.empty((*t.shape[:-2], b - a, t.shape[-1]), dtype=t.dtype, device=device)
        return self.fetch(parts, a, b, out, fill, value)
