"""Row-banded Jacobi-PCG (counterpart of octane_tpu.parallel.cg).

Each band runs pass A's band form (``ops.pcg.pcg_pass_a_band``) with one
ghost row of r and p beside each cut, exchanged before every pass A, and
the diagonals' ghost rows, exchanged once per solve; pass B needs no ghost
rows and runs unchanged on each band.  The <p, Ap>, <r, M^-1 r> and <r, r>
partials of all bands, and the planes of the initial sums, are joined in
band order and summed once on the first band's device: on bands aligned to
the reduction blocks (parallel.mesh.band_rows) every sum is one device's,
so the iterates equal the single-device solve's bit for bit (a truncated
CG amplifies round-off: other sums moved a 5424^2 pair by 4e-2 px).  The
stopping test is read on the host once per iteration, as on one device
(``ops.pcg.pcg_solve_fused.host_syncs`` counts the reads).  The JAX
package's 8-row ghost strips were the TPU's tiling: the stencil needs one
row.
"""

from __future__ import annotations

import numpy as np
import torch

from octane_tpu_torch.ops.pcg import pcg_pass_a_band, pcg_pass_b, pcg_solve_fused
from octane_tpu_torch.parallel.halo import LocalExchange
from octane_tpu_torch.parallel.sor import cat_sum, split_rows


def _ghosts(exchange, parts, r0: int, r1: int, out) -> torch.Tensor:
    """out (..., 2, W) = rows r0 - 1 and r1 of the field (edge rows where
    they fall outside it: never read)."""
    exchange.fetch(parts, r0 - 1, r0, out[..., 0:1, :])
    exchange.fetch(parts, r1, r1 + 1, out[..., 1:2, :])
    return out


def solve_bands(bands, true_h: int, tol: float, iters: int, exchange=None,
                pass_a=pcg_pass_a_band, pass_b=pcg_pass_b):
    """PCG from x = 0 on banded systems; returns the bands' (2, hb, W)
    (du, dv) rows.

    ``bands`` is [(r0, cf, b), ...] in row order: the band's (3|7, hb, W)
    coefficient rows [a1, a4, a2(, a5, a6, a7, a8)] and its (2, hb, W)
    right-hand side, on its device.  The loop is ops.pcg.pcg_solve_fused's.
    """
    exchange = exchange or LocalExchange()
    dev0 = bands[0][1].device
    r0s = [r0 for r0, _, _ in bands]
    cfs = [cf for _, cf, _ in bands]
    hbs = [cf.shape[1] for cf in cfs]
    w = cfs[0].shape[2]

    def new_ghosts():
        return [torch.empty((2, 2, w), dtype=torch.float32, device=cf.device) for cf in cfs]

    gd = new_ghosts()
    diag = [(r0, cf[0:2]) for r0, cf in zip(r0s, cfs)]
    for r0, hb, g in zip(r0s, hbs, gd):
        _ghosts(exchange, diag, r0, r0 + hb, g)
    gr, gp = new_ghosts(), new_ghosts()

    b = [bb for _, _, bb in bands]
    # the single-device solve's sums of whole planes (ops.pcg.pcg_solve_fused)
    gamma = (cat_sum([bb[0] * (bb[0] / cf[0]) for bb, cf in zip(b, cfs)], dev0)
             + cat_sum([bb[1] * (bb[1] / cf[1]) for bb, cf in zip(b, cfs)], dev0))
    resid = cat_sum([bb * bb for bb in b], dev0, dim=1)
    x = [torch.zeros_like(bb) for bb in b]
    p = [torch.zeros_like(bb) for bb in b]
    r = list(b)
    alpha = torch.zeros((), dtype=torch.float32, device=dev0)
    beta = torch.zeros_like(alpha)
    tol32 = float(np.float32(tol))
    for _ in range(iters):
        pcg_solve_fused.host_syncs += 1
        if not float(resid) > tol32:
            break
        rp, pp = list(zip(r0s, r)), list(zip(r0s, p))
        for i, (r0, hb) in enumerate(zip(r0s, hbs)):
            _ghosts(exchange, rp, r0, r0 + hb, gr[i])
            _ghosts(exchange, pp, r0, r0 + hb, gp[i])
        ab = torch.stack([alpha, beta])
        pap = []
        for i, (r0, cf) in enumerate(zip(r0s, cfs)):
            x[i], p[i], ap, part = pass_a(x[i], r[i], p[i], cf, ab.to(cf.device), gr[i], gp[i],
                                          gd[i], r0, true_h)
            pap.append((ap, part))
        alpha = gamma / cat_sum([part for _, part in pap], dev0)
        parts = []
        for i, cf in enumerate(cfs):
            r[i], part = pass_b(r[i], pap[i][0], cf, alpha.reshape(1).to(cf.device))
            parts.append(part.to(dev0))
        part = torch.cat(parts)
        gamma_new = torch.sum(part[:, 0])
        resid = torch.sum(part[:, 1])
        beta = gamma_new / gamma
        gamma = gamma_new
    return [xi + alpha.to(xi.device) * pi for xi, pi in zip(x, p)]   # the deferred update


def system_bands(sysm, rows):
    """(cf, b) of a flow.stencil.StencilSystem's rows (a slice): the planes
    pcg_solve_fused stacks."""
    planes = [sysm.a1, sysm.a4, sysm.a2]
    if torch.is_tensor(sysm.a5):
        planes += [sysm.a5, sysm.a6, sysm.a7, sysm.a8]
    return (torch.stack([t[rows] for t in planes]),
            torch.stack([sysm.bu[rows], sysm.bv[rows]]))


def make_sharded_fused_cg(mesh, exchange=None):
    """cg_fn(sysm, tol, iters) -> (du, dv): the banded PCG of a whole
    flow.stencil.StencilSystem over the mesh's bands (octane_tpu's
    make_sharded_fused_cg); the result is on the first band's device."""
    exchange = exchange or LocalExchange()

    def cg_fn(sysm, tol, iters):
        h = sysm.bu.shape[0]
        cf, b = system_bands(sysm, slice(None))
        bands = [(r0, c, bb.to(c.device))
                 for (r0, c), (_, bb) in zip(split_rows(cf, mesh), split_rows(b, mesh))]
        x = solve_bands(bands, h, tol, iters, exchange)
        du = exchange.rows([(r0, t) for (r0, _, _), t in zip(bands, x)], 0, h,
                           bands[0][1].device)
        return du[0], du[1]

    return cg_fn
