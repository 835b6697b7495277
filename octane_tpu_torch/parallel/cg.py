"""Row-banded Jacobi-PCG (counterpart of octane_tpu.parallel.cg).

Each band runs pass A's band form (``ops.pcg.pcg_pass_a_band``) with one
ghost row of r and p beside each cut, exchanged before every pass A, and
the diagonals' ghost rows, exchanged once per solve; pass B needs no ghost
rows and runs unchanged on each band.  The <p, Ap>, <r, M^-1 r> and <r, r>
partials of all bands, and the block partials of the first sums, are
joined in band order and summed once (on the first band's device, or on
every process under a ``halo.ProcessExchange``): on bands aligned to the
reduction blocks (parallel.mesh.band_rows) every sum is one device's,
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

from octane_tpu_torch.ops.pcg import (initial_partials, pcg_pass_a_band, pcg_pass_b,
                                      pcg_solve_fused)
from octane_tpu_torch.parallel.halo import LocalExchange, stub
from octane_tpu_torch.parallel.sor import cat_sum, home, split_rows


def _ghost_reqs(bands, outs):
    """Requests of rows r0 - 1 and r1 for every band of ``bands`` into its
    (..., 2, W) ghost buffer (edge rows where they fall outside the field:
    never read)."""
    reqs = []
    for i, ((r0, t), g) in enumerate(zip(bands, outs)):
        r1 = r0 + t.shape[-2]
        reqs += [(i, r0 - 1, r0, None if g is None else g[..., 0:1, :]),
                 (i, r1, r1 + 1, None if g is None else g[..., 1:2, :])]
    return reqs


def solve_bands(bands, true_h: int, tol: float, iters: int, exchange=None,
                pass_a=pcg_pass_a_band, pass_b=pcg_pass_b):
    """PCG from x = 0 on banded systems; returns the bands' (2, hb, W)
    (du, dv) rows, None for another process's band.

    ``bands`` is [(r0, cf, b), ...] over every band in row order: the band's
    (3|7, hb, W) coefficient rows [a1, a4, a2(, a5, a6, a7, a8)] and its
    (2, hb, W) right-hand side, on its device, or ``halo.stub``s for a band
    of another process.  The loop is ops.pcg.pcg_solve_fused's.
    """
    exchange = exchange or LocalExchange()
    layout = [(r0, cf) for r0, cf, _ in bands]
    dev0 = home(layout, exchange)
    mine = [i for i, (_, cf, _) in enumerate(bands) if not cf.is_meta]
    cfs = [cf for _, cf, _ in bands]
    w = cfs[mine[0]].shape[2] if mine else 0
    key = (true_h, w)

    def new_ghosts():
        return [None if cf.is_meta else torch.empty((2, 2, w), dtype=torch.float32,
                                                    device=cf.device) for cf in cfs]

    def field(planes):
        return [(r0, stub(cf.shape[-2]) if t is None else t)
                for (r0, cf), t in zip(layout, planes)]

    gd = new_ghosts()
    exchange.fetch_bands(field([None if cf.is_meta else cf[0:2] for cf in cfs]),
                         _ghost_reqs(layout, gd))
    gr, gp = new_ghosts(), new_ghosts()

    b = [None if cf.is_meta else bb for _, cf, bb in bands]
    # the single-device solve's first sums (ops.pcg.pcg_solve_fused)
    part = exchange.join([initial_partials(cfs[i], b[i]) for i in mine], dev0, 0,
                         ("init", *key))
    gamma = torch.sum(part[:, 0]) + torch.sum(part[:, 1])
    resid = torch.sum(part[:, 2])
    x = [None if bb is None else torch.zeros_like(bb) for bb in b]
    p = [None if bb is None else torch.zeros_like(bb) for bb in b]
    r = list(b)
    alpha = torch.zeros((), dtype=torch.float32, device=dev0)
    beta = torch.zeros_like(alpha)
    tol32 = float(np.float32(tol))
    for _ in range(iters):
        pcg_solve_fused.host_syncs += 1
        if not float(resid) > tol32:
            break
        exchange.fetch_bands(field(r), _ghost_reqs(layout, gr))
        exchange.fetch_bands(field(p), _ghost_reqs(layout, gp))
        ab = torch.stack([alpha, beta])
        pap = {}
        for i in mine:
            r0, cf = layout[i]
            x[i], p[i], ap, part = pass_a(x[i], r[i], p[i], cf, ab.to(cf.device), gr[i], gp[i],
                                          gd[i], r0, true_h)
            pap[i] = (ap, part)
        alpha = gamma / cat_sum([pap[i][1] for i in mine], dev0, exchange, ("pap", *key))
        parts = []
        for i in mine:
            r[i], part = pass_b(r[i], pap[i][0], cfs[i], alpha.reshape(1).to(cfs[i].device))
            parts.append(part)
        part = exchange.join(parts, dev0, 0, ("rr", *key))
        gamma_new = torch.sum(part[:, 0])
        resid = torch.sum(part[:, 1])
        beta = gamma_new / gamma
        gamma = gamma_new
    # the deferred update
    return [None if xi is None else xi + alpha.to(xi.device) * pi for xi, pi in zip(x, p)]


def system_bands(sysm, rows):
    """(cf, b) of a flow.stencil.StencilSystem's rows (a slice): the planes
    pcg_solve_fused stacks."""
    planes = [sysm.a1, sysm.a4, sysm.a2]
    if torch.is_tensor(sysm.a5):
        planes += [sysm.a5, sysm.a6, sysm.a7, sysm.a8]
    return (torch.stack([t[rows] for t in planes]),
            torch.stack([sysm.bu[rows], sysm.bv[rows]]))


def make_sharded_fused_cg(mesh):
    """cg_fn(sysm, tol, iters) -> (du, dv): the banded PCG of a whole
    flow.stencil.StencilSystem over the mesh's bands (octane_tpu's
    make_sharded_fused_cg); the result is on the first band's device."""
    exchange = LocalExchange()

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
