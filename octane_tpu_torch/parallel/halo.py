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
device and one on another card of the process.

``ProcessExchange`` serves bands that live in several processes
(``torch.distributed``), each process holding tensors for its own bands
only.  A field's parts are then one per band of the mesh, in band order,
with a ``stub`` (its row count, no data) for a band of another process.
Its step is the collective ``fetch_bands(parts, reqs)``: ``reqs`` lists
every band's requests [(band, a, b, out)], ``out`` None for a band of
another process.  Every process passes the same bands and rows, computed
from values that all of them hold, so each knows what it sends and what it
receives without a request round; one step's transfers go out as one
batch (``dist.batch_isend_irecv``).  Both exchanges also provide the
collectives the banded solvers need: ``join`` (the bands' pieces of a
partial vector joined in band order on every process, so a sum of it is
one device's), ``band_values`` (one scalar per band, every band's on
every process) and ``barrier``.  ``LocalExchange`` implements them within
the process.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from octane_tpu_torch.core.bc import reflect_index

FILLS = ("edge", "reflect", "constant")


def stub(rows: int) -> torch.Tensor:
    """The part of a band that another process holds: its rows, no data."""
    return torch.empty((rows, 0), device="meta")


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

    # the collective forms (see the module docstring); every band is local

    @staticmethod
    def owner(band: int) -> int:
        return 0

    def fetch_bands(self, parts, reqs, fill: str = "edge", value: float = 0.0) -> None:
        for _, a, b, out in reqs:
            if out is not None:
                self.fetch(parts, a, b, out, fill, value)

    @staticmethod
    def join(pieces, device, dim: int = 0, key=None) -> torch.Tensor:
        """The bands' pieces joined along ``dim`` on ``device``, in band order."""
        return torch.cat([p.to(device) for p in pieces], dim=dim)

    @staticmethod
    def band_values(values) -> list:
        """One host read of a 0-d tensor per band."""
        dev = values[0].device
        return torch.stack([v.to(dev) for v in values]).tolist()

    @staticmethod
    def barrier() -> None:
        pass


def _segments(a: int, b: int, h: int, fill: str):
    """[(s0, s1, at)]: field rows [s0, s1) land in rows [at, at + s1 - s0)
    of a fetch of rows [a, b); s0 None marks a row of the constant fill."""
    lo, hi = min(max(a, 0), h), max(min(b, h), 0)
    out = [(lo, hi, lo - a)] if lo < hi else []
    for r in [*range(a, min(b, 0)), *range(max(a, h), b)]:
        if fill == "constant":
            out.append((None, None, r - a))
        else:
            src = (0 if r < 0 else h - 1) if fill == "edge" else reflect_index(r, h)
            out.append((src, src + 1, r - a))
    return out


class ProcessExchange:
    """Rows and collectives of banded fields over the processes of the
    default ``torch.distributed`` group; see the module docstring.

    ``ranks[i]`` is the process of band i; this process's tensors live on
    ``device``.  NCCL moves CUDA tensors; gloo moves CPU tensors only, so a
    card's rows go through pinned host buffers when the caller chose gloo.
    ``sent`` counts this process's messages and their bytes, its
    collectives and the bytes they gathered from it.
    """

    def __init__(self, ranks, device):
        self.ranks = tuple(int(r) for r in ranks)
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.device = torch.device(device)
        self.staged = dist.get_backend() == "gloo" and self.device.type == "cuda"
        self.wire = torch.device("cpu") if dist.get_backend() == "gloo" else self.device
        self._shapes = {}
        self.sent = {"messages": 0, "bytes": 0, "collectives": 0, "gathered": 0}

    def owner(self, band: int) -> int:
        return self.ranks[band]

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of ``t`` on the wire's device (pinned on the host
        when staged)."""
        if not self.staged:
            return t.contiguous()
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t)

    def _buffer(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device=self.wire, pin_memory=self.staged)

    def fetch_bands(self, parts, reqs, fill: str = "edge", value: float = 0.0) -> None:
        """Every band's requests of one exchange step; every process calls it
        with the same ``parts`` layout and the same (band, a, b) requests."""
        if fill not in FILLS:
            raise ValueError(f"fill must be one of {FILLS}, got {fill!r}")
        h = parts[-1][0] + parts[-1][1].shape[-2]
        ops, landing = [], []
        for band, a, b, out in reqs:
            dst = self.ranks[band]
            if (out is None) != (dst != self.rank):
                raise ValueError(f"band {band}: out must be given exactly by its process")
            for s0, s1, at in _segments(a, b, h, fill):
                if s0 is None:
                    if out is not None:
                        out[..., at, :].fill_(value)
                    continue
                for j, (r0, t) in enumerate(parts):
                    s, e = max(s0, r0), min(s1, r0 + t.shape[-2])
                    src = self.ranks[j]
                    if s >= e or self.rank not in (src, dst):
                        continue
                    if src == self.rank and t.is_meta:
                        raise ValueError(f"band {j} is this process's but its part is a stub")
                    rows = slice(at + s - s0, at + e - s0)
                    if src == dst:
                        out[..., rows, :].copy_(t[..., s - r0:e - r0, :])
                    elif dst == self.rank:
                        view = out[..., rows, :]
                        buf = self._buffer(view.shape, view.dtype)
                        ops.append(dist.P2POp(dist.irecv, buf, src))
                        landing.append((view, buf))
                    else:
                        buf = self._wire(t[..., s - r0:e - r0, :])
                        ops.append(dist.P2POp(dist.isend, buf, dst))
                        self.sent["messages"] += 1
                        self.sent["bytes"] += buf.numel() * buf.element_size()
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for view, buf in landing:
            view.copy_(buf)

    def join(self, pieces, device, dim: int = 0, key=None) -> torch.Tensor:
        """This process's pieces (its bands', in band order) and every other
        process's, joined along ``dim`` in band order on ``device``: the
        tensor LocalExchange.join gives on one process.  The processes'
        shapes are gathered once per ``key`` (a value that fixes every
        band's piece shape, such as a tag and the field's dims)."""
        local = torch.cat(list(pieces), dim=dim) if pieces else None
        shapes = self._shapes.get(key) if key is not None else None
        if shapes is None:
            shapes = [None] * self.world
            dist.all_gather_object(shapes, None if local is None else tuple(local.shape))
            self.sent["collectives"] += 1
            if key is not None:
                self._shapes[key] = shapes
        sizes = [math.prod(sh) if sh is not None else 0 for sh in shapes]
        n = max(sizes)
        dtype = local.dtype if local is not None else torch.float32
        buf = self._buffer((n,), dtype)
        if local is not None:
            buf[:sizes[self.rank]].copy_(local.reshape(-1))
        chunks = [self._buffer((n,), dtype) for _ in range(self.world)]
        dist.all_gather(chunks, buf)
        self.sent["collectives"] += 1
        self.sent["gathered"] += buf.numel() * buf.element_size()
        joined = torch.cat([c[:k].view(sh) for c, k, sh in zip(chunks, sizes, shapes)
                            if sh is not None], dim=dim)
        return joined.to(device)

    def band_values(self, values) -> list:
        """``values`` one 0-d tensor per band, None for another process's
        bands; returns every band's value, on every process (one all-reduce
        of a vector that is zero outside each process's bands: the sum is
        exact)."""
        dtype = next((v.dtype for v in values if v is not None), torch.float32)
        vec = torch.zeros(len(values), dtype=dtype, device=self.device)
        for i, v in enumerate(values):
            if v is not None:
                vec[i] = v
        vec = vec.to(self.wire)
        dist.all_reduce(vec)
        self.sent["collectives"] += 1
        return vec.tolist()

    def barrier(self) -> None:
        dist.barrier()
        self.sent["collectives"] += 1
