"""Temporal frame interpolation (counterpart of octane_tpu.post.temporal;
oct_interp.cc, Baker et al. 2011 style).

The reference's serial forward splat with colour-constancy conflict
resolution (oct_warpflow, :17-63) is three scatter-min passes, as in
octane_tpu: the least cost per target, then the least scan order among the
cost ties, then the one winner per target writes its flow.  ``amin`` does
not depend on the order of the scatter, so the splat is exact.  The hole
fill is octane_tpu's Jacobi fixed point of the masked 3x3 neighbour mean
(not the reference's serial outside-in sweep, :182-250).  Everything here
is plain PyTorch on the inputs' device: the JAX package has no Pallas
kernel under interpolation.

The splat, one fill step and the synthesis also take a slab of the
image's rows (``row0`` and the global height ``h``), so the row-banded
``parallel.post.sharded_interpolate_frame`` runs the same arithmetic on
each band; every row they give equals the whole frame's.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_HOLE = -999.0
_BIGCOST = 999999.0
_BIGORDER = 2 ** 31 - 1      # octane_tpu's int32 sentinel


def _round_half_up(x):
    return torch.floor(x + 0.5)


def _clamped_index(x, n):
    """round-half-up of x clamped to [0, n - 2], as int64."""
    return _round_half_up(x).clamp_(0, n - 2).to(torch.int64)


def forward_splat(u, v, im1, im2, time, h: int = None, row0: int = 0, rows=None):
    """Splat flow to ``time`` (a float32 scalar tensor); returns (ut, vt)
    with -999 holes.

    Each source pixel writes its flow to the 2x2 footprint at
    round(i + time*u) (clamped to [0, n-2]); conflicts resolve to the source
    with the smallest colour-constancy cost (im1[src] - im2[src +
    round(flow)])^2, ties to the first writer in scan order (oct_warpflow).

    ``u``, ``v``, ``im1``, ``im2`` may be the rows [row0, row0 + n) of an
    h-row image: they are the sources, and the result covers the target
    rows ``rows`` [t0, t1) (the whole image by default).  A target gets
    every source of the slab that writes to it; a source whose cost read
    leaves the slab reads the slab's edge row instead, which the caller's
    margin keeps off every target it asks for (``sharded_interpolate_frame``).
    """
    n_src, w = u.shape
    h = n_src if h is None else h
    t0, t1 = (0, h) if rows is None else rows
    n = (t1 - t0) * w
    ii = torch.arange(w, dtype=torch.float32, device=u.device)[None, :]
    jj = torch.arange(row0, row0 + n_src, dtype=torch.float32, device=u.device)[:, None]
    iv = _clamped_index(ii + time * u, w)
    jv = _clamped_index(jj + time * v, h)
    iv2 = _clamped_index(ii + u, w)
    jv2 = _clamped_index(jj + v, h)
    if (row0, n_src) != (0, h):
        jv2 = (jv2 - row0).clamp_(0, n_src - 2)

    src = (jj.to(torch.int64) * w + ii.to(torch.int64)).reshape(-1)
    tgts = []
    for l in range(2):
        for k in range(2):
            tgt = (jv + (l - t0)) * w + (iv + k)
            if (t0, t1) != (0, h):
                # targets beyond the rows asked for go to the spare slot n
                ty = jv + (l - t0)
                tgt = torch.where((ty >= 0) & (ty < t1 - t0), tgt, n)
            tgts.append(tgt.reshape(-1))
    tgt = torch.cat(tgts)
    cost = torch.cat([(im1 - im2[jv2 + l, iv2 + k]).square_().reshape(-1)
                      for l in range(2) for k in range(2)])
    order = torch.cat([src * 4 + (l * 2 + k) for l in range(2) for k in range(2)])

    best_cost = torch.full((n + 1,), _BIGCOST + 1.0, dtype=torch.float32, device=u.device)
    best_cost.scatter_reduce_(0, tgt, cost, "amin", include_self=True)
    tie = cost == best_cost[tgt]
    best_order = torch.full((n + 1,), _BIGORDER, dtype=torch.int64, device=u.device)
    best_order.scatter_reduce_(0, tgt, torch.where(tie, order, _BIGORDER), "amin",
                               include_self=True)
    win = tie & (order == best_order[tgt])

    # exactly one source wins each written target
    wt = tgt[win]
    ut = torch.full((n + 1,), _HOLE, dtype=torch.float32, device=u.device)
    vt = torch.full((n + 1,), _HOLE, dtype=torch.float32, device=u.device)
    ut[wt] = u.reshape(-1).repeat(4)[win]
    vt[wt] = v.reshape(-1).repeat(4)[win]
    return ut[:n].reshape(t1 - t0, w), vt[:n].reshape(t1 - t0, w)


def _fill_step(uv, ghosts=None):
    """One Jacobi step of the masked 3x3 neighbour mean on the stacked
    (2, H, W) (ut, vt); a cell stays a hole while no neighbour is filled.
    The neighbours are summed in octane_tpu's order (rows, then columns).
    ``ghosts`` (2, 2, W) are the rows above and below ``uv`` when it is a
    band of the image; by default the image's edges pad the constant hole."""
    _, h, w = uv.shape
    if ghosts is None:
        up = F.pad(uv, (1, 1, 1, 1), value=_HOLE)
    else:
        up = F.pad(torch.cat([ghosts[:, :1], uv, ghosts[:, 1:]], dim=1), (1, 1, 0, 0),
                   value=_HOLE)
    cnt = s = None
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            if dj == 0 and di == 0:
                continue
            x = up[:, 1 + dj:1 + dj + h, 1 + di:1 + di + w]
            ok = x > -998.0
            term = torch.where(ok, x, 0.0)
            if cnt is None:
                cnt, s = ok[0].to(torch.float32), term
            else:
                cnt.add_(ok[0])
                s.add_(term)
    can = (uv[0] < -998.0) & (cnt > 0)
    return torch.where(can, s / cnt.clamp_(min=1.0), uv)


def fill_holes(ut, vt, max_iters: int = 10000):
    """Fill -999 holes by iterated masked 3x3 neighbour means.

    The fixed point is octane_tpu's ``fill_holes``: it stops once no hole
    is left or after ``max_iters`` steps (an all-hole field keeps its
    sentinel).  The holes are counted on the host before every step.
    """
    uv = torch.stack([ut, vt])
    done = 0
    while done < max_iters and bool((uv[0] < -998.0).any()):
        uv = _fill_step(uv)
        done += 1
    return uv[0], uv[1]


def _bilinear(img, x, y, row0: int = 0):
    """Bilinear samples of ``img``, the image's rows from ``row0`` on."""
    x1 = torch.trunc(x).to(torch.int64)
    y1 = torch.trunc(y).to(torch.int64)
    fx = x - x1
    fy = y - y1
    y1 = y1 - row0
    f11 = img[..., y1, x1]
    f21 = img[..., y1, x1 + 1]
    f12 = img[..., y1 + 1, x1]
    f22 = img[..., y1 + 1, x1 + 1]
    return (1 - fy) * ((1 - fx) * f11 + fx * f21) + fy * ((1 - fx) * f12 + fx * f22)


def synthesize(ut, vt, r0: int, u_b, v_b, b0: int, ut2, vt2, p0: int, im1, im2, q0: int,
               time, h: int):
    """The frame's rows [r0, r0 + n) from the filled flow (ut, vt) on them:
    occlusion fields from the flow (u_b, v_b) on rows from ``b0`` and the
    splat at time 1 (ut2, vt2) on rows from ``p0``, then the backward
    blend of the images im1, im2 (C, rows, W) given from row ``q0``.
    Returns ((C, n, W) image, (n, W) int16 occlusion).  The caller's slabs
    must hold every row read (the whole image: all offsets 0)."""
    w = ut.shape[-1]
    ii = torch.arange(w, dtype=torch.float32, device=ut.device)[None, :]
    jb = torch.arange(b0, b0 + u_b.shape[0], dtype=torch.float32, device=ut.device)[:, None]
    o1a = ut2[b0 - p0:b0 - p0 + u_b.shape[0]] < -998.0
    iv = _clamped_index(ii + u_b, w)
    jv = _clamped_index(jb + v_b, h) - p0
    du = u_b - ut2[jv, iv]
    dv = v_b - vt2[jv, iv]
    o0a = ~o1a & (du * du + dv * dv > 0.25)

    jj = torch.arange(r0, r0 + ut.shape[0], dtype=torch.float32, device=ut.device)[:, None]
    x00 = (ii - time * ut).clamp_(0.0, w - 2)
    y00 = (jj - time * vt).clamp_(0.0, h - 2)
    x10 = (ii + (1.0 - time) * ut).clamp_(0.0, w - 2)
    y10 = (jj + (1.0 - time) * vt).clamp_(0.0, h - 2)

    i0 = _bilinear(im1, x00, y00, q0)       # (C, n, W)
    i1 = _bilinear(im2, x10, y10, q0)

    def nearest(x):
        return torch.trunc(x + 0.5).to(torch.int64)

    o0 = o0a[nearest(y00) - b0, nearest(x00)]
    o1 = o1a[nearest(y10) - b0, nearest(x10)]

    both = ~o0 & ~o1
    img = torch.where(both[None], (1.0 - time) * i0 + time * i1,
                      torch.where(o1[None], i0, i1))
    occ = torch.where(both, 0, torch.where(o1, 2, 1)).to(torch.int16)
    return img, occ


def interpolate_frame(u, v, im1, im2, frac: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Synthesize the frame at t1 + frac*(t2-t1).

    u/v: (H, W) float32 flow in pixels; im1/im2: (C, H, W) normalized
    images, all on one device.  Returns (img, occ): the interpolated
    (C, H, W) image in normalized units and the (H, W) int16 occlusion mask
    (0 both, 1 only-in-image-1, 2 only-in-image-2; oct_filewrite.cc:185).
    """
    h = u.shape[0]
    # float32 before any arithmetic, as octane_tpu's jnp.float32(frac):
    # 1 - time then rounds as a float32 subtraction
    time = torch.tensor(frac, dtype=torch.float32, device=u.device)
    ut, vt = forward_splat(u, v, im1[0], im2[0], time)
    ut, vt = fill_holes(ut, vt)
    ut2, vt2 = forward_splat(u, v, im1[0], im2[0],
                             torch.ones((), dtype=torch.float32, device=u.device))
    return synthesize(ut, vt, 0, u, v, 0, ut2, vt2, 0, im1, im2, 0, time, h)
