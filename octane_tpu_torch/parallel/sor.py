"""Row-banded multi-sweep red-black SOR (counterpart of
octane_tpu.parallel.sor).

Each band keeps its iterate and its coefficients in a slab: its own rows
and 2S ghost rows beside each cut (S = the pass's sweeps, at most 8).  The
coefficient ghosts are exchanged once per solve and the iterate's once per
pass; then every band runs the band form of the pass kernel
(``ops.sor.sor_pass_band``), which writes the band's rows straight into
the other slab of the ping-pong pair.  The band's rows equal the
whole-image pass's bit for bit.  The residual partials of all bands are
joined in band order and summed once on every device of the process's
bands (and on every process under a ``halo.ProcessExchange``): the
stopping test is deterministic, one device's on bands aligned to the
reduction blocks, and the same bits on every card.  It guards each pass as
on one device (ops.guard.Guard): graph IF nodes on every card when the
banded program captures the pair, with the transfers between them at the
top level, else one host read per pass (``ops.sor.sor_solve_cf.host_syncs``
counts them).  ||b||^2 is summed the
same way from the bands' block partials of the coefficient planes, so no
process joins a whole plane.
"""

from __future__ import annotations

import numpy as np
import torch

from octane_tpu_torch.ops.guard import Gate, Guard
from octane_tpu_torch.ops.sor import (OMEGA, PASS_SWEEPS, build_cf, sor_pass_band,
                                      sor_solve_cf)
from octane_tpu_torch.ops.pcg import block_partials, num_partials
from octane_tpu_torch.parallel.halo import LocalExchange, stub
from octane_tpu_torch.parallel.mesh import mesh_bands


def cat_sum(parts, device, exchange=None, key=None) -> torch.Tensor:
    """``torch.sum`` of the bands' partial vectors joined on ``device``,
    in band order (``exchange.join``: this process's pieces, every band's on
    every process).  The pieces of bands aligned to the reduction blocks
    (parallel.mesh.band_rows) join into the whole image's partials, so the
    sum is one device's, bit for bit."""
    return torch.sum((exchange or LocalExchange()).join(parts, device, 0, key))


def home(bands, exchange) -> torch.device:
    """The device of this process's sums: its first band's, else the
    exchange's (a process whose bands are all empty at this level)."""
    return next((t.device for _, t in bands if not t.is_meta), None) or exchange.device


def homes(bands, exchange) -> list:
    """Every device that holds a copy of this process's sums and stopping
    tests: ``home`` first, then the devices of its other bands, in band
    order."""
    devs = [home(bands, exchange)]
    for _, t in bands:
        if not t.is_meta and t.device not in devs:
            devs.append(t.device)
    return devs


def one_body(devs, exchange) -> bool:
    """Whether an iteration's transfers run inside its guarded body, as one
    body per iteration: where the process's bands lie on one device
    (``devs``, from ``homes``) and no other process shares the solve, the
    transfers are copies on that device, which an IF body takes, and one IF
    node per iteration costs less than one per step.  Otherwise they run
    between the bodies."""
    return len(devs) == 1 and isinstance(exchange, LocalExchange)


def solve_bands(bands, true_h: int, resid0, tol: float, iters: int, omega: float = OMEGA,
                exchange=None, pass_fn=sor_pass_band, count=None):
    """SOR from x = 0 on a banded coefficient stack; returns the bands'
    (2, hb, W) (du, dv) rows, None for another process's band.

    ``bands`` is [(r0, cf), ...] over every band in row order, cf the band's
    (nc, hb, W) rows on its device (a view is fine) or a ``halo.stub`` for
    a band of another process; ``resid0`` is ||b||^2 on this process.  The
    loop is ``ops.sor.sor_solve_cf``'s: passes of S = min(8, iters) sweeps,
    each guarded by ||r||^2 > tol (ops.guard.Guard), then a remainder pass
    under the same guard.  ``count``, an int32 device scalar, gains the
    passes that ran and tallies the guarded bodies.

    A pass is one decision (``Guard.gate``) taken on every device of the
    process's bands (``homes``), each holding its own copy of ||r||^2: the
    ghost-row exchange of the iterate (top level), each device's band
    passes (guarded), the join of every band's residual partials onto each
    device (top level), each device's sum of them (guarded).  So under
    capture every transfer runs whatever the test decides, and none runs in
    a guarded body; on the host route a pass whose test was read and failed
    (``Gate.closed``) makes no transfer either.  Where the bands lie on one
    card of one process (``one_body``) the whole pass, its copies on the
    card included, is one guarded body instead.  Each band's iterate ping-pongs between two slabs fixed before
    the loop: pass k fetches the ghost rows of slab set k % 2 from the
    bands' rows in it and writes the band's rows of the other set; the
    passes that ran, counted on the device, pick each band's final slab by
    their parity.
    """
    exchange = exchange or LocalExchange()
    if iters < 1:
        raise ValueError(f"solve_bands: iters must be >= 1, got {iters}")
    s_main = min(PASS_SWEEPS, iters)
    n_main, s_rem = divmod(iters, s_main)
    ghost = 2 * s_main
    tol32 = float(np.float32(tol))
    devs = homes(bands, exchange)
    dev0 = devs[0]
    w = next((cf.shape[2] for _, cf in bands if not cf.is_meta), 0)
    slabs, reqs = [], []             # (r0, r1, t0, cf slab, [x slab, x slab])
    for i, (r0, cf) in enumerate(bands):
        r1 = r0 + cf.shape[-2]
        t0, t1 = max(0, r0 - ghost), min(true_h, r1 + ghost)
        cfs = xs = None
        if not cf.is_meta:
            cfs = torch.empty((cf.shape[0], t1 - t0, w), dtype=cf.dtype, device=cf.device)
            shape = (2, t1 - t0, w)
            xs = [torch.zeros(shape, dtype=torch.float32, device=cf.device),
                  torch.empty(shape, dtype=torch.float32, device=cf.device)]
        slabs.append((r0, r1, t0, t1, cfs, xs))
        reqs.append((i, t0, t1, cfs))
    exchange.fetch_bands(bands, reqs)

    def interior(r0, r1, t0, x):
        return x[:, r0 - t0:r1 - t0]

    def ghosts(j):
        """The field of slab set j's band rows and the requests of its ghost
        rows."""
        cur, reqs = [], []
        for i, (r0, r1, t0, t1, _, xs) in enumerate(slabs):
            x = xs[j] if xs else None
            cur.append((r0, stub(r1 - r0) if x is None else interior(r0, r1, t0, x)))
            reqs += [(i, t0, r0, None if x is None else x[:, :r0 - t0]),
                     (i, r1, t1, None if x is None else x[:, r1 - t0:])]
        return cur, reqs

    fetches = [ghosts(0), ghosts(1)]
    mine = [i for i, slab in enumerate(slabs) if slab[5] is not None]
    on = {d: [i for i in mine if slabs[i][4].device == d] for d in devs}
    # each band's residual partials: a body's, read by the join that follows
    # it (the shapes the kernel gives, for a join before any body ran)
    parts = {i: torch.zeros(num_partials(slabs[i][1] - slabs[i][0], w), device=slabs[i][4].device)
             for i in mine}
    resids = {d: resid0.to(d).clone() for d in devs}
    ran = torch.zeros((), dtype=torch.int32, device=dev0)
    key = ("sor", true_h, w)

    def passes(d, j, ns):
        for i in on[d]:
            r0, r1, t0, _, cfs, xs = slabs[i]
            _, parts[i] = pass_fn(xs[j], cfs, ns, omega, t0, true_h, r0 - t0, r1 - t0,
                                  out=interior(r0, r1, t0, xs[1 - j]))

    def total(d, joined):
        torch.sum(joined, 0, out=resids[d])
        if d == dev0:
            ran.add_(1)

    def iteration(k, ns, gate):
        exchange.fetch_bands(*fetches[k % 2])
        for d in devs:
            gate(d, lambda d=d: passes(d, k % 2, ns))
        local = [parts[i] for i in mine]
        joined = {d: exchange.join(local, d, 0, key) for d in devs}
        for d in devs:
            gate(d, lambda d=d: total(d, joined[d]))

    guard = Guard(sor_solve_cf, count)
    whole = one_body(devs, exchange)

    def step(k, ns):
        gate = guard.gate(resids, tol32)
        if gate.closed:
            return
        if whole:
            gate(dev0, lambda: iteration(k, ns, Gate(open_=True)))
        else:
            iteration(k, ns, gate)

    for k in range(n_main):
        step(k, s_main)
    if s_rem:
        step(n_main, s_rem)
    if count is not None:
        count.add_(ran)
    out = []
    for r0, r1, t0, _, _, xs in slabs:
        if xs is None:
            out.append(None)
            continue
        odd = (ran % 2 == 1).to(xs[0].device)
        out.append(torch.where(odd, interior(r0, r1, t0, xs[1]), interior(r0, r1, t0, xs[0])))
    return out


def resid0_of(bands, device, exchange=None) -> torch.Tensor:
    """||b||^2 of banded coefficient stacks (planes 3, 4) on ``device``: the
    sum of the bands' joined block partials, the assembly kernel's
    (``ops.pcg.block_partials``), so it is the single-device flow's."""
    local = [cf for _, cf in bands if not cf.is_meta]
    h = bands[-1][0] + bands[-1][1].shape[-2]
    w = local[0].shape[2] if local else 0
    return cat_sum([block_partials(cf[3] * cf[3] + cf[4] * cf[4]) for cf in local], device,
                   exchange, ("resid0", h, w))


def split_rows(t, mesh, dim: int = -2):
    """[(r0, rows of t on band i's device), ...] over the mesh's non-empty
    bands."""
    return [(r0, t.narrow(dim, r0, r1 - r0).to(dev).contiguous())
            for dev, r0, r1 in mesh_bands(mesh, t.shape[dim])]


def make_sharded_fused_sor(mesh, omega: float = OMEGA):
    """sor_fn(sysm, tol, iters) -> (du, dv): the banded SOR of a whole
    flow.stencil.StencilSystem over the mesh's bands (octane_tpu's
    make_sharded_fused_sor); the result is on the first band's device."""
    exchange = LocalExchange()

    def sor_fn(sysm, tol, iters):
        cf = build_cf(sysm)
        bands = split_rows(cf, mesh)
        dev0 = bands[0][1].device
        x = solve_bands(bands, cf.shape[1], resid0_of(bands, dev0), tol, iters, omega,
                        exchange)
        du = exchange.rows([(r0, t) for (r0, _), t in zip(bands, x)], 0, cf.shape[1], dev0)
        return du[0], du[1]

    return sor_fn
