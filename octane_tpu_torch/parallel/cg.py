"""Row-banded Jacobi-PCG (counterpart of octane_tpu.parallel.cg).

Each band runs pass A's band form (``ops.pcg.pcg_pass_a_band``) with one
ghost row of r and p beside each cut, exchanged before every pass A, and
the diagonals' ghost rows, exchanged once per solve; pass B needs no ghost
rows and runs unchanged on each band.  The <p, Ap>, <r, M^-1 r> and <r, r>
partials of all bands, and the block partials of the first sums, are
joined in band order and summed once on every device of the process's
bands (and on every process under a ``halo.ProcessExchange``): on bands
aligned to the reduction blocks (parallel.mesh.band_rows) every sum is one
device's, so the iterates equal the single-device solve's bit for bit (a
truncated CG amplifies round-off: other sums moved a 5424^2 pair by 4e-2
px), and every card holds the same bits.  The stopping test guards each
iteration as on one device (ops.guard.Guard): graph IF nodes on every card
when the banded program captures the pair, with the transfers between
them at the top level, else one host read per iteration
(``ops.pcg.pcg_solve_fused.host_syncs`` counts them).  The JAX
package's 8-row ghost strips were the TPU's tiling: the stencil needs one
row.
"""

from __future__ import annotations

import numpy as np
import torch

from octane_tpu_torch.ops.guard import Gate, Guard
from octane_tpu_torch.ops.pcg import (initial_partials, num_partials, pcg_pass_a_band,
                                      pcg_pass_b, pcg_solve_fused, stack_system)
from octane_tpu_torch.parallel.halo import LocalExchange, stub
from octane_tpu_torch.parallel.sor import homes, one_body, split_rows


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
                pass_a=pcg_pass_a_band, pass_b=pcg_pass_b, count=None, first=None):
    """PCG from x = 0 on banded systems; returns the bands' (2, hb, W)
    (du, dv) rows, None for another process's band.

    ``bands`` is [(r0, cf, b), ...] over every band in row order: the band's
    (3|7, hb, W) coefficient rows [a1, a4, a2(, a5, a6, a7, a8)] and its
    (2, hb, W) right-hand side, on its device, or ``halo.stub``s for a band
    of another process.  ``first`` gives each band's (n, 3) block partials
    of the first sums (ops.pcg.initial_partials of its rows; None for
    another process's band), as the PCG form of the assembly kernel
    returns them; without it they are computed here.  The loop is
    ops.pcg.pcg_solve_cf's, each iteration guarded by ||r||^2 > tol
    (ops.guard.Guard), and so is its state: each band's x, p and r
    ping-pong between two sets fixed before the loop (iteration k reads set
    k % 2 and writes the other), one Ap per band, and on every device of the process's bands
    (parallel.sor.homes) its own [alpha, beta] (``ab``), gamma between two
    scalars and ||r||^2, each computed there from the same joined partials;
    the iterations that ran, counted on the device, pick the final set,
    then the deferred update.  The right-hand sides serve as r's first set,
    so the solve overwrites them.  ``count``, an int32 device scalar, gains
    the iterations that ran and tallies the guarded bodies.

    An iteration is one decision (``Guard.gate``) on every device: the
    ghost rows of r and p fetched into one buffer per band (top level),
    each device's passes A (guarded), the <p, Ap> partials joined onto each
    device (top level), each device's alpha and passes B (guarded), the
    <r, M^-1 r> and <r, r> partials joined (top level), each device's
    gamma, ||r||^2 and beta (guarded).  Under capture every transfer runs
    whatever the test decides, and none runs in a guarded body; on the host
    route an iteration whose test was read and failed (``Gate.closed``)
    makes no transfer either.  Where the bands lie on one card of one
    process (parallel.sor.one_body) the whole iteration, its copies on the
    card included, is one guarded body instead.
    """
    exchange = exchange or LocalExchange()
    layout = [(r0, cf) for r0, cf, _ in bands]
    devs = homes(layout, exchange)
    dev0 = devs[0]
    mine = [i for i, (_, cf, _) in enumerate(bands) if not cf.is_meta]
    cfs = [cf for _, cf, _ in bands]
    on = {d: [i for i in mine if cfs[i].device == d] for d in devs}
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
    if first is None:       # the single-device solve's first sums (ops.pcg.pcg_solve_cf)
        first = [None if bb is None else initial_partials(cf, bb) for cf, bb in zip(cfs, b)]
    gammas, resids = {}, {}     # on every device
    for d in devs:
        part = exchange.join([first[i] for i in mine], d, 0, ("init", *key))
        gammas[d] = [torch.sum(part[:, 0]) + torch.sum(part[:, 1]), torch.empty((), device=d)]
        resids[d] = torch.sum(part[:, 2])

    def pair(first):
        return [None if bb is None else [first(bb), torch.empty_like(bb)] for bb in b]

    xs, ps, rs = pair(torch.zeros_like), pair(torch.zeros_like), pair(lambda bb: bb)
    ap = [None if bb is None else torch.empty_like(bb) for bb in b]
    ab = {d: torch.zeros(2, dtype=torch.float32, device=d) for d in devs}   # [alpha, beta]
    ran = torch.zeros((), dtype=torch.int32, device=dev0)
    fetches = [[(field([None if t is None else t[j] for t in planes]), _ghost_reqs(layout, g))
                for planes, g in ((rs, gr), (ps, gp))] for j in (0, 1)]
    # each band's partials: a body's, read by the join that follows it (the
    # shapes the kernels give, for a join before any body ran)
    paps = {i: torch.zeros(num_partials(cfs[i].shape[1], w), device=cfs[i].device) for i in mine}
    rrs = {i: torch.zeros((num_partials(cfs[i].shape[1], w), 2), device=cfs[i].device)
           for i in mine}

    def passes_a(d, i0, j):
        for i in on[d]:
            r0, cf = layout[i]
            *_, paps[i] = pass_a(xs[i][i0], rs[i][i0], ps[i][i0], cf, ab[d], gr[i], gp[i],
                                 gd[i], r0, true_h, out=(xs[i][j], ps[i][j], ap[i]))

    def passes_b(d, i0, j, joined):
        torch.div(gammas[d][i0], torch.sum(joined), out=ab[d][0])
        for i in on[d]:
            _, rrs[i] = pass_b(rs[i][i0], ap[i], cfs[i], ab[d][0:1], out=rs[i][j])

    def sums(d, i0, j, joined):
        torch.sum(joined[:, 0], 0, out=gammas[d][j])
        torch.sum(joined[:, 1], 0, out=resids[d])
        torch.div(gammas[d][j], gammas[d][i0], out=ab[d][1])
        if d == dev0:
            ran.add_(1)

    def iteration(k, gate):
        i0, j = k % 2, 1 - k % 2
        for step in fetches[i0]:
            exchange.fetch_bands(*step)
        for d in devs:
            gate(d, lambda d=d: passes_a(d, i0, j))
        joined = {d: exchange.join([paps[i] for i in mine], d, 0, ("pap", *key)) for d in devs}
        for d in devs:
            gate(d, lambda d=d: passes_b(d, i0, j, joined[d]))
        joined = {d: exchange.join([rrs[i] for i in mine], d, 0, ("rr", *key)) for d in devs}
        for d in devs:
            gate(d, lambda d=d: sums(d, i0, j, joined[d]))

    guard = Guard(pcg_solve_fused, count)
    tol32 = float(np.float32(tol))
    whole = one_body(devs, exchange)
    for k in range(iters):
        gate = guard.gate(resids, tol32)
        if gate.closed:
            continue
        if whole:
            gate(dev0, lambda k=k: iteration(k, Gate(open_=True)))
        else:
            iteration(k, gate)
    if count is not None:
        count.add_(ran)
    out = []
    for i, bb in enumerate(b):
        if bb is None:
            out.append(None)
            continue
        odd = (ran % 2 == 1).to(bb.device)
        x = torch.where(odd, xs[i][1], xs[i][0])
        # the deferred update
        out.append(x + ab[bb.device][0] * torch.where(odd, ps[i][1], ps[i][0]))
    return out


def make_sharded_fused_cg(mesh):
    """cg_fn(sysm, tol, iters) -> (du, dv): the banded PCG of a whole
    flow.stencil.StencilSystem over the mesh's bands (octane_tpu's
    make_sharded_fused_cg); the result is on the first band's device."""
    exchange = LocalExchange()

    def cg_fn(sysm, tol, iters):
        h = sysm.bu.shape[0]
        cf, b = stack_system(sysm)
        bands = [(r0, c, bb.to(c.device))
                 for (r0, c), (_, bb) in zip(split_rows(cf, mesh), split_rows(b, mesh))]
        x = solve_bands(bands, h, tol, iters, exchange)
        du = exchange.rows([(r0, t) for (r0, _, _), t in zip(bands, x)], 0, h,
                           bands[0][1].device)
        return du[0], du[1]

    return cg_fn
