"""Row-banded multi-sweep red-black SOR (counterpart of
octane_tpu.parallel.sor).

Each band keeps its iterate and its coefficients in a slab: its own rows
and 2S ghost rows beside each cut (S = the pass's sweeps, at most 8).  The
coefficient ghosts are exchanged once per solve and the iterate's once per
pass; then every band runs the band form of the pass kernel
(``ops.sor.sor_pass_band``), which writes the band's rows straight into
the other slab of the ping-pong pair.  The band's rows equal the
whole-image pass's bit for bit.  The residual partials of all bands are
joined in band order and summed once (on the first band's device, or on
every process under a ``halo.ProcessExchange``): the stopping test is
deterministic, one device's on bands aligned to the reduction blocks, and
the same on every process.  It guards each pass as on one device
(ops.guard.Guard): a graph IF node when the banded program captures the
pair, else one host read per pass (``ops.sor.sor_solve_cf.host_syncs``
counts them).  ||b||^2 is summed the
same way from the bands' block partials of the coefficient planes, so no
process joins a whole plane.
"""

from __future__ import annotations

import numpy as np
import torch

from octane_tpu_torch.ops.guard import Guard
from octane_tpu_torch.ops.sor import (OMEGA, PASS_SWEEPS, build_cf, sor_pass_band,
                                      sor_solve_cf)
from octane_tpu_torch.ops.pcg import block_partials
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


def solve_bands(bands, true_h: int, resid0, tol: float, iters: int, omega: float = OMEGA,
                exchange=None, pass_fn=sor_pass_band, count=None):
    """SOR from x = 0 on a banded coefficient stack; returns the bands'
    (2, hb, W) (du, dv) rows, None for another process's band.

    ``bands`` is [(r0, cf), ...] over every band in row order, cf the band's
    (nc, hb, W) rows on its device (a view is fine) or a ``halo.stub`` for
    a band of another process; ``resid0`` is ||b||^2 on this process.  The
    loop is ``ops.sor.sor_solve_cf``'s: passes of S = min(8, iters) sweeps,
    each a body guarded by ||r||^2 > tol (ops.guard.Guard), then a
    remainder pass under the same guard.  ``count``, an int32 device scalar,
    gains the passes that ran and tallies the guarded bodies.

    Each band's iterate ping-pongs between two slabs fixed before the loop:
    pass k fetches the ghost rows of slab set k % 2 from the bands' rows in
    it and writes the band's rows of the other set; the passes that ran,
    counted on the device, pick each band's final slab by their parity.
    """
    exchange = exchange or LocalExchange()
    if iters < 1:
        raise ValueError(f"solve_bands: iters must be >= 1, got {iters}")
    s_main = min(PASS_SWEEPS, iters)
    n_main, s_rem = divmod(iters, s_main)
    ghost = 2 * s_main
    tol32 = float(np.float32(tol))
    dev0 = home(bands, exchange)
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
    resid = resid0.clone()
    ran = torch.zeros((), dtype=torch.int32, device=dev0)

    def body(k, ns):
        j = k % 2
        exchange.fetch_bands(*fetches[j])
        parts = []
        for r0, r1, t0, _, cfs, xs in slabs:
            if xs is not None:
                _, part = pass_fn(xs[j], cfs, ns, omega, t0, true_h, r0 - t0, r1 - t0,
                                  out=interior(r0, r1, t0, xs[1 - j]))
                parts.append(part)
        torch.sum(exchange.join(parts, dev0, 0, ("sor", true_h, w)), 0, out=resid)
        ran.add_(1)

    guard = Guard(sor_solve_cf, count)
    for k in range(n_main):
        guard(resid, tol32, lambda k=k: body(k, s_main))
    if s_rem:
        guard(resid, tol32, lambda: body(n_main, s_rem))
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
