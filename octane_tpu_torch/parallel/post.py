"""Row-banded post-processing: pix2uv, pix2uv_ms, SRSAL and temporal
interpolation (counterpart of octane_tpu.parallel.post).

* ``sharded_pix2uv`` / ``sharded_pix2uv_ms``: elementwise per band, with
  the band's global rows (``nav.winds``' ``row0``), so the float64
  navigation equals the single-device call's bit for bit; on cards each
  band's rows go from its own card into page-locked host planes
  (``io.host.to_host``), with no plane gathered on a card;
* ``sharded_srsal``: each band smooths its rows with the band form of the
  bilateral kernel (``ops.bilateral.bilateral_band``) from a slab of its
  rows and the p = 18 rows beside them, the reference's reflect boundary
  taken in global coordinates; its rows equal the single-device call's.  A
  band thinner than p falls back to the single-device ``srsal_smooth``, as
  octane_tpu's does (post.py:116-119);
* ``sharded_interpolate_frame``: each band splats from a slab of its rows
  +- e = 4 * max_disp + 8 (every source that writes to a target within
  2 * max_disp + 3 rows of the band, and every row their costs read), with
  the global scan order breaking ties; the hole fill exchanges one ghost
  row beside each cut per Jacobi step (the constant hole at the image's
  edges) until no hole is left anywhere; the occlusion fields and the
  synthesis read the band's slabs.  Every row equals ``post.temporal``'s
  whole frame.  Where e reaches the band height the whole frame runs, as
  octane_tpu's does (post.py:287-289).

Each has a band form (``*_bands``) over a banded field's parts, which the
multi-process path (``parallel.distributed``) calls with a
``halo.ProcessExchange`` on the process's own bands; the ``sharded_*``
functions take and return whole tensors within one process (results on
the mesh's first device, but pix2uv's in host memory on cards).
"""

from __future__ import annotations

from typing import Tuple

import torch

from octane_tpu_torch.core.gaussian import gaussian_kernel_1d
from octane_tpu_torch.io.host import to_host
from octane_tpu_torch.nav.winds import pix2uv, pix2uv_ms
from octane_tpu_torch.ops.bilateral import band_slab, bilateral_band
from octane_tpu_torch.parallel.halo import LocalExchange, field_rows, stub
from octane_tpu_torch.parallel.mesh import mesh_bands
from octane_tpu_torch.parallel.sor import split_rows
from octane_tpu_torch.post.srsal import srsal_smooth
from octane_tpu_torch.post.temporal import (HOLE, fill_step, forward_splat,
                                            interpolate_frame, synthesize)


def _gather(outs, h: int, n_out: int):
    """Whole tensors of each of the ``n_out`` results of [(r0, results)] on
    the first band's device."""
    dev0 = outs[0][1][0].device
    return tuple(LocalExchange().rows([(r0, o[j]) for r0, o in outs], 0, h, dev0)
                 for j in range(n_out))


def _products(outs, h: int, n_out: int):
    """Whole planes of each of the ``n_out`` results of [(r0, results)]:
    page-locked host planes where the bands are on cards, else on the
    first band's device."""
    if outs[0][1][0].is_cuda:
        return to_host(outs, h)
    return _gather(outs, h, n_out)


def pix2uv_bands(parts, nav, dt: float, grid: str = "goes", pixuv: bool = False):
    """``nav.winds.pix2uv`` of each band [(r0, u rows, v rows)]:
    [(r0, (u_wind, v_wind, u_raw, v_raw))]."""
    return [(r0, pix2uv(u, v, nav, dt, grid=grid, pixuv=pixuv, row0=r0)) for r0, u, v in parts]


def pix2uv_ms_bands(parts, nav, dt: float, grid: str = "goes"):
    """``nav.winds.pix2uv_ms`` of each band: [(r0, (u m/s, v m/s))], float64."""
    return [(r0, pix2uv_ms(u, v, nav, dt, grid=grid, row0=r0)) for r0, u, v in parts]


def _split(mesh, fields):
    h = fields[0].shape[0]
    return [(r0, *(f[r0:r1].to(dev) for f in fields)) for dev, r0, r1 in mesh_bands(mesh, h)]


def sharded_pix2uv(u_pix, v_pix, nav, dt: float, mesh, grid: str = "goes",
                   pixuv: bool = False):
    """``nav.winds.pix2uv`` per band: (u_wind, v_wind, u_raw, v_raw), in
    page-locked host memory on cards."""
    outs = pix2uv_bands(_split(mesh, (u_pix, v_pix)), nav, dt, grid, pixuv)
    return _products(outs, u_pix.shape[0], 4)


def sharded_pix2uv_ms(u_pix, v_pix, nav, dt: float, mesh, grid: str = "goes"):
    """``nav.winds.pix2uv_ms`` per band: (u m/s, v m/s), float64, in
    page-locked host memory on cards."""
    outs = pix2uv_ms_bands(_split(mesh, (u_pix, v_pix)), nav, dt, grid)
    return _products(outs, u_pix.shape[0], 2)


def whole_field(parts, exchange) -> dict:
    """{band: the whole field} for this process's first band of ``parts``
    (one fetch of every row per process)."""
    h = field_rows(parts)
    reqs, seen = [], set()
    for i, (_, t) in enumerate(parts):
        if exchange.owner(i) in seen:
            continue
        seen.add(exchange.owner(i))
        out = None if t.is_meta else torch.empty((*t.shape[:-2], h, t.shape[-1]),
                                                 dtype=t.dtype, device=t.device)
        reqs.append((i, 0, h, out))
    exchange.fetch_bands(parts, reqs)
    return {i: out for i, _, _, out in reqs if out is not None}


def _own_rows(parts, whole, fn):
    """``fn(the whole field)`` once per process, then each of this process's
    bands' rows of its results."""
    if not whole:
        return []
    res = fn(next(iter(whole.values())))
    return [(r0, tuple(x[..., r0:r0 + t.shape[-2], :] for x in res))
            for r0, t in parts if not t.is_meta]


def srsal_bands(parts, mesh, filtsigma: float = 9.0, sigpix: float = 20.0, exchange=None):
    """SRSAL of a banded [u, v, cth] field: ``parts`` [(r0, (3, rows, W))]
    over every band, a ``halo.stub`` for another process's band.  Returns
    [(r0, (2, rows, W) smoothed u, v)] for this process's bands."""
    exchange = exchange or LocalExchange()
    p = int(2 * filtsigma)
    h = field_rows(parts)
    if -(-h // mesh.n) <= p:
        # a band thinner than the window's half-width: the single-program
        # path, on the whole field
        out = _own_rows(parts, whole_field(parts, exchange),
                        lambda f: srsal_smooth(f[0], f[1], f[2], filtsigma, sigpix))
        return [(r0, torch.stack(o)) for r0, o in out]
    gk = gaussian_kernel_1d(filtsigma, p)
    sigpix2 = -1.0 / (2.0 * sigpix * sigpix)
    reqs = []
    for i, (r0, t) in enumerate(parts):
        s0, s1 = band_slab(r0, r0 + t.shape[-2], h, p)
        slab = None if t.is_meta else torch.empty((3, s1 - s0, t.shape[-1]), dtype=t.dtype,
                                                  device=t.device)
        reqs.append((i, s0, s1, slab))
    exchange.fetch_bands(parts, reqs)
    return [(r0, bilateral_band(slab[0], slab[1], slab[2], gk, sigpix2, s0, r0,
                                t.shape[-2], h))
            for (r0, t), (_, s0, _, slab) in zip(parts, reqs) if not t.is_meta]


def sharded_srsal(u, v, cth, mesh, filtsigma: float = 9.0,
                  sigpix: float = 20.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """SRSAL on the mesh's bands; equals ``post.srsal.srsal_smooth``."""
    exchange = LocalExchange()
    h = u.shape[0]
    if -(-h // mesh.n) <= int(2 * filtsigma):
        return srsal_smooth(u, v, cth, filtsigma, sigpix)
    parts = split_rows(torch.stack([t.to(torch.float32) for t in (u, v, cth)]), mesh)
    out = exchange.rows(srsal_bands(parts, mesh, filtsigma, sigpix, exchange), 0, h,
                        parts[0][1].device)
    return out[0], out[1]


def splat_margin(max_disp: int) -> int:
    """e: the rows beside a band its splat reads (sources that write within
    2 * max_disp + 3 rows of it, max_disp + 1 rows away, and their cost
    reads another max_disp + 2 rows on)."""
    return 4 * int(max_disp) + 8


def _fill_bands(uv, parts, exchange, max_iters: int = 10000):
    """``post.temporal.fill_holes`` on bands: ``uv`` {band: (2, rows, W)} of
    this process's bands of the field laid out as ``parts``; one exchange of
    the rows beside each cut per step, and the steps run while any band of
    any process holds a hole."""
    def holes():
        return int(exchange.band_values([(uv[i][0] < -998.0).sum() if i in uv else None
                                         for i in range(len(parts))]).sum())

    done, left = 0, holes()
    while done < max_iters and left > 0:
        field, reqs, ghosts = [], [], {}
        for i, (r0, t) in enumerate(parts):
            rows = t.shape[-2]
            if i in uv:
                field.append((r0, uv[i]))
                ghosts[i] = g = torch.empty((2, 2, uv[i].shape[-1]), dtype=torch.float32,
                                            device=uv[i].device)
            else:
                field.append((r0, stub(rows)))
                g = None
            reqs += [(i, r0 - 1, r0, None if g is None else g[:, 0:1]),
                     (i, r0 + rows, r0 + rows + 1, None if g is None else g[:, 1:2])]
        exchange.fetch_bands(field, reqs, fill="constant", value=HOLE)
        uv = {i: fill_step(uv[i], ghosts[i]) for i in uv}
        done += 1
        left = holes()
    return uv


def interpolate_bands(parts, mesh, frac: float, max_disp: int, exchange=None):
    """``post.temporal.interpolate_frame`` of a banded [u, v, im1 (C),
    im2 (C)] field: ``parts`` [(r0, (2 + 2C, rows, W))] over every band, a
    ``halo.stub`` for another process's band; ``max_disp`` bounds |u| and
    |v|.  Returns [(r0, ((C, rows, W) image, (rows, W) int16 occlusion))]
    for this process's bands."""
    exchange = exchange or LocalExchange()
    h = field_rows(parts)
    e = splat_margin(max_disp)
    if e >= parts[0][1].shape[-2]:
        def whole(f):
            c = (f.shape[0] - 2) // 2
            return interpolate_frame(f[0], f[1], f[2:2 + c], f[2 + c:], frac)
        return _own_rows(parts, whole_field(parts, exchange), whole)
    t2, b = 2 * int(max_disp) + 3, int(max_disp) + 2
    reqs = []
    for i, (r0, t) in enumerate(parts):
        q0, q1 = max(0, r0 - e), min(h, r0 + t.shape[-2] + e)
        slab = None if t.is_meta else torch.empty((t.shape[0], q1 - q0, t.shape[-1]),
                                                  dtype=t.dtype, device=t.device)
        reqs.append((i, q0, q1, slab))
    exchange.fetch_bands(parts, reqs)
    mine = {i: (r0, r0 + t.shape[-2], q0, slab)
            for i, ((r0, t), (_, q0, _, slab)) in enumerate(zip(parts, reqs)) if slab is not None}

    def scalar(x, f):
        # float32 before any arithmetic, as interpolate_frame's
        return torch.tensor(x, dtype=torch.float32, device=f.device)

    def splat(f, q0, at, rows):
        c = (f.shape[0] - 2) // 2
        return forward_splat(f[0], f[1], f[2], f[2 + c], at, h, q0, rows)

    uv = {i: torch.stack(splat(f, q0, scalar(frac, f), (r0, r1)))
          for i, (r0, r1, q0, f) in mine.items()}
    uv = _fill_bands(uv, parts, exchange)
    out = []
    for i, (r0, r1, q0, f) in mine.items():
        c = (f.shape[0] - 2) // 2
        p0, b0, b1 = max(0, r0 - t2), max(0, r0 - b), min(h, r1 + b)
        ut2, vt2 = splat(f, q0, scalar(1.0, f), (p0, min(h, r1 + t2)))
        out.append((r0, synthesize(uv[i][0], uv[i][1], r0, f[0, b0 - q0:b1 - q0],
                                   f[1, b0 - q0:b1 - q0], b0, ut2, vt2, p0, f[2:2 + c],
                                   f[2 + c:], q0, scalar(frac, f), h)))
    return out


def sharded_interpolate_frame(u, v, im1, im2, frac: float, mesh, max_disp: int = 32):
    """Row-banded ``post.temporal.interpolate_frame``; ``max_disp`` must bound
    max(|u|, |v|).  Returns ((C, H, W) image, (H, W) int16 occlusion) on the
    mesh's first device."""
    h = u.shape[0]
    bands = mesh_bands(mesh, h)
    if splat_margin(max_disp) >= bands[0][2] - bands[0][1]:
        return interpolate_frame(u, v, im1, im2, frac)
    field = torch.cat([u[None], v[None], im1, im2]).to(torch.float32)
    return _gather(interpolate_bands(split_rows(field, mesh), mesh, frac, max_disp), h, 2)
