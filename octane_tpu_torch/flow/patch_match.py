"""Patch-match (sum-of-squared-error minimization) optical flow; counterpart
of octane_tpu.flow.patch_match (oct_patch_match_optical_flow.cc:56-156).

The spiral search is a Python loop over the spiral offset table carrying
the running (best cost, offset) per pixel, so a full-disk grid holds a
handful of planes instead of a cost volume.  Ties resolve to the first
offset in the reference's spiral visit order (strict ``<``).  The quadratic
sub-pixel refinement (jquad_interp, ref :35-55) probes the four offset
neighbours of the winner, evaluated fresh, in offset coordinates.

Two cost paths, as in octane_tpu:

* **zero first guess** (``u0 is None``): patch centres are the pixels, so
  each offset's cost is a sum of shifted windows of edge-padded images
  (slices, no gathers).  At or below ``FIRST_GUESS_MAX_PIXELS`` the cost is
  summed tap by tap and the refinement probes are per-pixel clamped
  gathers, so this path equals the gather path given a zero first guess
  bit for bit; above it every tap is a window of one squared-difference
  plane e^2 and the probes are selected per pixel from the costs of the
  (2*srad+3)^2 - 4 offsets around the search square (45 at srad 2).
* **first guess**: patch centres are ``clamp(trunc(i + u0))`` (ref :98-99)
  and every tap is a clamped gather; the displacement is measured from that
  centre (ref :138).  Sector scale only (``FIRST_GUESS_MAX_PIXELS``).

Every plane op accumulates in place (``add_``), so the loops hold a few
planes whatever the image size.  Everything here is plain PyTorch on the
inputs' device: the JAX package has no Pallas kernel under patch-match.
Costs are summed in octane_tpu's order (taps k-major, l-minor); eager
PyTorch does not contract a multiply and an add into an FMA, which XLA may
do, so the two packages can pick different offsets only at an exact tie.
The reference's spiral bounds check is always true (ref :102-104), so the
search set is the full (2*srad+1)^2 square in spiral order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# The first-guess path gathers (2*rad+1)^2 full-field taps per spiral probe
# (the guess bends the per-pixel patch origins, so the slices do not apply):
# fine at sector scale, hundreds of GB of gather traffic at full disk.  The
# zero-guess path is unaffected; its cost form switches at the same size.
FIRST_GUESS_MAX_PIXELS = 8_000_000    # > CONUS band-2 1 km (~3.8 Mpix)


def spiral_offsets(srad: int) -> np.ndarray:
    """Offsets (n, m) in the reference's spiral visit order (ref :93-131)."""
    n = m = 0
    dn, dm = 0, -1
    out = []
    for _ in range((2 * srad + 1) ** 2):
        out.append((n, m))
        if (n == m) or (n < 0 and n == -m) or (n > 0 and n == 1 - m):
            dn, dm = -dm, dn
        n += dn
        m += dm
    return np.asarray(out, np.int32)


def _sum_taps(taps):
    """sum of d^2 over the (a, b) plane pairs of ``taps`` (d = a - b), in
    their order: the first square is the accumulator, the rest add in place."""
    acc = d = None
    for a, b in taps:
        if acc is None:
            acc = torch.sub(a, b)
            acc.mul_(acc)
            continue
        d = torch.sub(a, b, out=d)
        acc.add_(d.mul_(d))
    return acc


def _clamped_flat(h, w, row0: int = 0, pad: int = 0):
    """The flat index of an image position (y, x) clamped into the (h, w)
    image, in a block of its rows from ``row0 - pad`` padded by ``pad``
    columns on each side (the whole image: row0 = pad = 0)."""
    wp = w + 2 * pad
    return lambda y, x: (y.clamp(0, h - 1) - row0 + pad) * wp + x.clamp(0, w - 1) + pad


def _cost_gather(g1f, g2f, ibc, jbc, n, m, rad, flat1, flat2):
    """SSD over the (2*rad+1)^2 patch with per-tap clamped indices
    (jsose, ref :12-33); ``n``/``m`` are ints or (H, W) int tensors,
    ``ibc``/``jbc`` int64 tensors and ``flat1``/``flat2`` the
    ``_clamped_flat`` of the flattened ``g1f``/``g2f``."""
    taps = ((g2f[flat2(jbc + (l + m), ibc + (k + n))], g1f[flat1(jbc + l, ibc + k)])
            for k in range(-rad, rad + 1) for l in range(-rad, rad + 1))
    return _sum_taps(taps)


def _refine(center, c0, c_plus, c_minus):
    """Parabola-vertex sub-pixel refinement (jquad_interp, ref :35-55)."""
    centre = center.to(torch.float32)
    denom = 2.0 * (c_plus + c_minus - 2.0 * c0)
    flat = denom == 0.0
    vertex = centre + torch.where(
        flat, 0.0, (c_minus - c_plus) / torch.where(flat, 1.0, denom))
    ok = (c0 < c_plus) & (c0 < c_minus)
    return torch.where(ok, vertex, centre)


def _spiral_argmin(cost_fn, srad: int):
    """The winning offsets (n, m) over the spiral offset table; the first
    strict minimum wins.  n and m are int32, as in octane_tpu."""
    order = spiral_offsets(srad).tolist()
    best = cost_fn(*order[0])                      # the spiral starts at (0, 0)
    nmin = torch.zeros(best.shape, dtype=torch.int32, device=best.device)
    mmin = torch.zeros_like(nmin)
    for n, m in order[1:]:
        c = cost_fn(n, m)
        upd = c < best
        torch.where(upd, c, best, out=best)
        nmin.masked_fill_(upd, n)
        mmin.masked_fill_(upd, m)
    return nmin, mmin


def _finish(nmin, mmin, probe_cost):
    """The winner's cost and its four neighbours through one code path (the
    strict gate of ``_refine`` must see the same rounding in all five)."""
    c0 = probe_cost(nmin, mmin)
    su1, su2 = probe_cost(nmin + 1, mmin), probe_cost(nmin - 1, mmin)
    sv1, sv2 = probe_cost(nmin, mmin + 1), probe_cost(nmin, mmin - 1)
    return _refine(nmin, c0, su1, su2), _refine(mmin, c0, sv1, sv2)


def _edge_pad(g, p):
    return F.pad(g[None, None], (p, p, p, p), mode="replicate")[0, 0]


def _patch_match_local(g1p, g2p, rad, srad, h: int, w: int, row0: int = 0):
    """Zero-guess patch match of one block (octane_tpu's ``_patch_match_local``).

    ``g1p``/``g2p`` are the block's rows of the two images padded by ``rad``
    and ``rad + srad + 1`` rows and columns with the image's edge values
    beyond its edges (the reference's clamped reads); the block is rows
    [row0, row0 + hl) of the (h, w) image, whole rows.  The branch at
    ``FIRST_GUESS_MAX_PIXELS`` is taken on the block's size, as octane_tpu
    takes it per shard.
    """
    smax = rad + srad + 1
    hl, wl = g1p.shape[0] - 2 * rad, g1p.shape[1] - 2 * rad
    taps = [(k, l) for k in range(-rad, rad + 1) for l in range(-rad, rad + 1)]
    sector = hl * wl <= FIRST_GUESS_MAX_PIXELS

    if sector:
        def cost_slices(n, m):
            return _sum_taps(
                (g2p[smax + l + m:smax + l + m + hl, smax + k + n:smax + k + n + wl],
                 g1p[rad + l:rad + l + hl, rad + k:rad + k + wl]) for k, l in taps)
    else:
        # every tap of the (n, m) cost plane is a shifted window of one
        # squared-difference plane e^2, e(y, x) = g2p[y + m + smax - rad,
        # x + n + smax - rad] - g1p[y, x]: each term equals the per-tap
        # difference squared, summed in the same k-major order
        e = None

        def cost_slices(n, m):
            nonlocal e
            y0, x0 = smax - rad + m, smax - rad + n
            e = torch.sub(g2p[y0:y0 + hl + 2 * rad, x0:x0 + wl + 2 * rad], g1p, out=e)
            e.mul_(e)
            wins = [e[rad + l:rad + l + hl, rad + k:rad + k + wl] for k, l in taps]
            acc = torch.add(wins[0], wins[1])
            for t in wins[2:]:
                acc.add_(t)
            return acc

    nmin, mmin = _spiral_argmin(cost_slices, srad)

    if sector:
        # per-pixel clamped gather probes, the same arithmetic as the
        # first-guess path's cost: the u0=None path equals the u0=zeros one
        ii = torch.arange(wl, device=g1p.device)[None, :]
        jj = torch.arange(row0, row0 + hl, device=g1p.device)[:, None]
        g1f, g2f = g1p.reshape(-1), g2p.reshape(-1)
        flat1, flat2 = _clamped_flat(h, w, row0, rad), _clamped_flat(h, w, row0, smax)

        def probe_cost(n, m):
            return _cost_gather(g1f, g2f, ii, jj, n, m, rad, flat1, flat2)

        return _finish(nmin, mmin, probe_cost)

    # full-disk scale: the probes only ever need the cost at the offsets
    # within one of the spiral's square, so evaluate each once through the
    # slice path and select it per pixel.  The corners (|n| = |m| = srad+1)
    # are never a probe of the cross-shaped pattern.
    probes = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1))   # c0, su1, su2, sv1, sv2
    s1 = srad + 1
    accs = [torch.zeros((hl, wl), dtype=torch.float32, device=g1p.device) for _ in probes]
    for n in range(-s1, s1 + 1):
        for m in range(-s1, s1 + 1):
            if abs(n) == s1 and abs(m) == s1:
                continue
            c = cost_slices(n, m)
            for a, (dn, dm) in zip(accs, probes):
                sel = (nmin == n - dn) & (mmin == m - dm)
                torch.where(sel, c, a, out=a)
    c0, su1, su2, sv1, sv2 = accs
    return _refine(nmin, c0, su1, su2), _refine(mmin, c0, sv1, sv2)


def _plane(x, device) -> torch.Tensor:
    """A float32 (H, W) tensor: a tensor stays on its device, an array goes
    to ``device``."""
    if torch.is_tensor(x):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def patch_match_flow(
    geo1,
    geo2,
    u0: Optional[torch.Tensor] = None,
    v0: Optional[torch.Tensor] = None,
    rad: int = 2,
    srad: int = 2,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense SSD minimization; returns (u, v) float32 pixel displacements.

    geo1/geo2: (H, W) float32 images.  ``u0``/``v0`` optionally give
    first-guess displacements; pass None (not zeros) to take the slice
    fast path.  The first-guess path is sector-scale only (see
    FIRST_GUESS_MAX_PIXELS).  Tensors are computed on their own device;
    arrays go to ``device``.
    """
    geo1 = _plane(geo1, device).contiguous()
    geo2 = _plane(geo2, geo1.device).contiguous()
    h, w = geo1.shape

    if u0 is None:
        return _patch_match_local(_edge_pad(geo1, rad), _edge_pad(geo2, rad + srad + 1), rad,
                                  srad, h, w)

    if h * w > FIRST_GUESS_MAX_PIXELS:
        raise ValueError(
            f"patch-match with a first guess is sector-scale only: "
            f"{h}x{w} = {h * w / 1e6:.1f} Mpix exceeds the "
            f"{FIRST_GUESS_MAX_PIXELS / 1e6:.0f} Mpix guard (the guessed "
            f"patch origins force {(2 * rad + 1) ** 2} full-field gathers "
            f"per spiral probe).  Use -hybrid (patch-match init + "
            f"variational refinement, which consumes the first guess) or "
            f"drop -firstguess for -sosm.")

    u0 = _plane(u0, geo1.device)
    v0 = _plane(v0, geo1.device)
    ii = torch.arange(w, dtype=torch.float32, device=geo1.device)[None, :]
    jj = torch.arange(h, dtype=torch.float32, device=geo1.device)[:, None]
    ibc = torch.trunc(ii + u0).to(torch.int32).clamp_(0, w - 1).to(torch.int64)
    jbc = torch.trunc(jj + v0).to(torch.int32).clamp_(0, h - 1).to(torch.int64)
    ibc, jbc = ibc.expand(h, w), jbc.expand(h, w)
    g1f, g2f = geo1.reshape(-1), geo2.reshape(-1)

    flat = _clamped_flat(h, w)

    def cost(n, m):
        return _cost_gather(g1f, g2f, ibc, jbc, n, m, rad, flat, flat)

    nmin, mmin = _spiral_argmin(cost, srad)
    return _finish(nmin, mmin, cost)


def patch_match_flow_sharded(geo1, geo2, mesh, rad: int = 2, srad: int = 2):
    """Zero-guess patch match on the row bands of ``mesh`` (octane_tpu's
    ``patch_match_flow_sharded``): each band takes its rows with ``rad`` /
    ``rad + srad + 1`` rows beside them (the image's edge rows beyond its
    edges) and runs ``_patch_match_local`` with its global first row; the
    result, on the mesh's first device, equals ``patch_match_flow``."""
    from octane_tpu_torch.parallel.halo import LocalExchange
    from octane_tpu_torch.parallel.mesh import mesh_bands

    exchange = LocalExchange()
    geo1 = _plane(geo1, mesh.devices[0])
    geo2 = _plane(geo2, geo1.device)
    h, w = geo1.shape
    smax = rad + srad + 1
    field = [(0, torch.stack([geo1, geo2]))]
    outs = []
    for dev, r0, r1 in mesh_bands(mesh, h):
        g1 = exchange.rows(field, r0 - rad, r1 + rad, dev)[0]
        g2 = exchange.rows(field, r0 - smax, r1 + smax, dev)[1]
        g1p = F.pad(g1[None, None], (rad, rad, 0, 0), mode="replicate")[0, 0]
        g2p = F.pad(g2[None, None], (smax, smax, 0, 0), mode="replicate")[0, 0]
        outs.append((r0, torch.stack(_patch_match_local(g1p, g2p, rad, srad, h, w, r0))))
    uv = exchange.rows(outs, 0, h, outs[0][1].device)
    return uv[0], uv[1]
