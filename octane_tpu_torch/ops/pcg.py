"""Jacobi-PCG iteration passes: CUDA kernels, plain versions and the driver.

One PCG iteration is two passes (the port of ``_pass_a``/``_pass_b`` of
octane_tpu/ops/pallas/cg.py):

* ``pcg_pass_a(x, r, p, cf, ab)``: x += alpha_prev p (lagged); p' = M^-1 r
  + beta p; ap = A p' with the mirror-at-1 edges; partials of <p', ap>;
* ``pcg_pass_b(r, ap, cf, alpha)``: r -= alpha ap; partials of <r, M^-1 r>
  and <r, r>.

x, r, p, ap are (2, h, w) float32 (u then v); ``cf`` is (3, h, w)
[a1, a4, a2] for the quadratic GNC step (off-diagonals are the scalar -1)
or (7, h, w) [a1, a4, a2, a5, a6, a7, a8]; ``ab`` = [alpha_prev, beta] and
``alpha`` stay on the device.  The partials are one per 32 x 8 block of
pixels, in the kernels' summation order (``block_partials``), so the plain
versions give the kernels' results bit for bit; the driver sums them with
``torch.sum``.

On a CUDA tensor a pass launches ``csrc/pcg.cu``; on a CPU tensor it runs
the plain version in this module.  ``pcg_pass_a.launches`` /
``.plain_calls`` (and the same on ``pcg_pass_b``) count them.  Each pass is
one launch.  Pass A computes p' once per pixel: a thread block computes p'
of its 64 x 16 tile and of the tile's frame into shared memory, and each
pixel reads its neighbours' from there.  At 5424^2 on an H100 80GB HBM3
pass A runs at 88 % / 86 % of its memory bound (robust / quad) and pass B
at 92 %.

``pcg_pass_a_band(x, r, p, cf, ab, gr, gp, gd, row0, true_h)`` is pass A's
band form for the mesh path (parallel.cg): x, r, p, cf are the band's rows
[row0, row0 + hb) of a true_h-row image, and gr, gp, gd (2, 2, w) hold r,
p and the diagonals [a1, a4] of the global rows row0 - 1 and row0 + hb
(where the band touches the image's edge, finite values that are not
read).  Its outputs equal the
whole-image pass's rows bit for bit; its partials are the band's blocks.
On a CUDA tensor it launches ``octane_pcg_pass_a_band`` of ``csrc/pcg.cu``,
on a CPU tensor ``pcg_pass_a_band_plain``.  Pass B needs no ghost rows and
runs unchanged on each band.

Passes A and B and pass A's band form take ``out=`` buffers for their
planes, which the drivers fix before their loops.

``pcg_solve_cf(cf, b, partials, tol, iters)`` is the driver (cg.py:271) on
a stacked system and its first sums (``initial_partials``, or the PCG form
of the assembly kernel, ``ops.assemble.assemble_pcg``): stop when ||r||^2
<= tol or after ``iters`` iterations, then the deferred x += alpha p.  Each
iteration is a body guarded by ``resid > tol`` (ops.guard.Guard): an IF
node of the graph while flow.variational's program captures the pair, a
host read otherwise (``pcg_solve_fused.host_syncs`` counts those).  The
loop walks all ``iters`` bodies and never breaks.  ``pcg_solve_fused(sysm,
...)`` is its front for a flow.stencil.StencilSystem: it stacks the system
(``stack_system``) and takes the first sums.
"""

from __future__ import annotations

import numpy as np
import torch

from octane_tpu_torch.core.bc import mirror_shift
from octane_tpu_torch.ops.build import check_status, load_kernels
from octane_tpu_torch.ops.guard import Guard


BLOCK_X, BLOCK_Y = 32, 8        # csrc/pcg.cu, assemble.cu, sor.cu: kBX, kBY


def num_partials(h: int, w: int) -> int:
    """Number of 32 x 8 blocks of an (h, w) plane: the kernels' partials."""
    return -(-h // BLOCK_Y) * -(-w // BLOCK_X)


def block_partials(part: torch.Tensor) -> torch.Tensor:
    """Sums of an (h, w) plane over 32 x 8 blocks, flattened row-major:
    the partials of csrc/pcg.cu, assemble.cu and sor.cu, added in their
    order.  A block row is one
    warp, reduced by the shuffle tree (lane l adds lane l + 16, then + 8,
    ..., + 1); the block adds its 8 warp sums in warp order.  The ragged
    edge is padded with zeros, as the kernel's idle threads add 0."""
    h, w = part.shape
    gh, gw = -(-h // BLOCK_Y), -(-w // BLOCK_X)
    x = torch.nn.functional.pad(part, (0, gw * BLOCK_X - w, 0, gh * BLOCK_Y - h))
    x = x.reshape(gh, BLOCK_Y, gw, BLOCK_X)
    n = BLOCK_X
    while n > 1:
        n //= 2
        x = x[..., :n] + x[..., n:2 * n]
    x = x[..., 0]                          # (gh, BLOCK_Y, gw) warp sums
    s = x[:, 0]
    for k in range(1, BLOCK_Y):
        s = s + x[:, k]
    return s.reshape(-1)


def stack_system(sysm, rows=slice(None)):
    """(cf, b) of a flow.stencil.StencilSystem's ``rows`` (a slice): cf the
    (3|7, rows, W) coefficient planes [a1, a4, a2(, a5, a6, a7, a8)] (a
    scalar a5 marks the quadratic GNC step), b the (2, rows, W) [bu, bv]."""
    planes = [sysm.a1, sysm.a4, sysm.a2]
    if torch.is_tensor(sysm.a5):
        planes += [sysm.a5, sysm.a6, sysm.a7, sysm.a8]
    return (torch.stack([t[rows] for t in planes]),
            torch.stack([sysm.bu[rows], sysm.bv[rows]]))


def initial_partials(cf, b: torch.Tensor) -> torch.Tensor:
    """(n, 3) block partials of the solve's first sums over a system's rows
    (cf: a1, a4 first; b: (2, h, w)): b_u^2 / a1 and b_v^2 / a4, whose sums
    add to <r, M^-1 r>, and ||b||^2.  A row band aligned to the blocks
    gives its rows of the whole system's partials, so the sums of bands'
    joined partials are one device's."""
    bu, bv = b[0], b[1]
    return torch.stack([block_partials(bu * (bu / cf[0])), block_partials(bv * (bv / cf[1])),
                        block_partials(bu * bu + bv * bv)], dim=1)


def _offdiag(f, cf, rows=slice(None)):
    """Off-diagonal part of A f for one (h, w) component, at ``rows`` of f
    (the rows of cf)."""
    wv, ev = mirror_shift(f, -1, -1)[rows], mirror_shift(f, 1, -1)[rows]
    nv, sv = mirror_shift(f, -1, -2)[rows], mirror_shift(f, 1, -2)[rows]
    if cf.shape[0] == 3:
        return -(wv + ev + nv + sv)
    return cf[3] * wv + cf[5] * ev + cf[4] * nv + cf[6] * sv


def _into(out, planes):
    """``planes``, or each copied into its buffer of ``out``."""
    if out is None:
        return planes
    return tuple(o.copy_(t) for o, t in zip(out, planes))


def pcg_pass_a_plain(x, r, p, cf, ab, out=None):
    """Plain pass A: (x + alpha_prev p, p', A p', block partials of <p', A p'>),
    the three planes in ``out`` when given."""
    alpha, beta = ab[0], ab[1]
    pn = (1.0 / cf[0:2]) * r + beta * p
    au = cf[0] * pn[0] + cf[2] * pn[1] + _offdiag(pn[0], cf)
    av = cf[2] * pn[0] + cf[1] * pn[1] + _offdiag(pn[1], cf)
    partials = block_partials(pn[0] * au + pn[1] * av)
    return (*_into(out, (x + alpha * p, pn, torch.stack([au, av]))), partials)


def pcg_pass_a_band_plain(x, r, p, cf, ab, gr, gp, gd, row0: int, true_h: int, out=None):
    """Plain band form: pass A's arithmetic on the band with its ghost rows,
    p' recomputed at the ghost rows, the outputs cropped to the band (the
    three planes in ``out`` when given)."""
    hb = x.shape[1]
    lo, hi = row0 > 0, row0 + hb < true_h

    def slab(band, ghost):
        return torch.cat(([ghost[:, :1]] if lo else []) + [band]
                         + ([ghost[:, 1:]] if hi else []), dim=1)

    alpha, beta = ab[0], ab[1]
    pn = (1.0 / slab(cf[0:2], gd)) * slab(r, gr) + beta * slab(p, gp)
    rows = slice(int(lo), int(lo) + hb)
    pb = pn[:, rows]
    au = cf[0] * pb[0] + cf[2] * pb[1] + _offdiag(pn[0], cf, rows)
    av = cf[2] * pb[0] + cf[1] * pb[1] + _offdiag(pn[1], cf, rows)
    partials = block_partials(pb[0] * au + pb[1] * av)
    return (*_into(out, (x + alpha * p, pb.contiguous(), torch.stack([au, av]))), partials)


def pcg_pass_b_plain(r, ap, cf, alpha, out=None):
    """Plain pass B: (r - alpha ap, (n, 2) block partials of
    [<r, M^-1 r>, <r, r>]), the new r in ``out`` when given."""
    rn = r - alpha[0] * ap
    z = (1.0 / cf[0:2]) * rn
    rz = rn[0] * z[0] + rn[1] * z[1]
    rr = rn[0] * rn[0] + rn[1] * rn[1]
    partials = torch.stack([block_partials(rz), block_partials(rr)], dim=1)
    if out is not None:
        rn = out.copy_(rn)
    return rn, partials


def _check(name, planes, cf, scalars, min_rows=2):
    ref = planes[0]
    if ref.dim() != 3 or ref.shape[0] != 2:
        raise ValueError(f"{name}: state planes must be (2, h, w), got {tuple(ref.shape)}")
    if cf.dim() != 3 or cf.shape[0] not in (3, 7) or cf.shape[1:] != ref.shape[1:]:
        raise ValueError(f"{name}: coefficients must be (3|7, h, w), got {tuple(cf.shape)}")
    if ref.shape[1] < min_rows or ref.shape[2] < 2:
        raise ValueError(f"{name}: the grid needs at least {min_rows} rows and 2 columns")
    for t in (*planes, cf, *scalars):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.device != ref.device:
            raise ValueError(f"{name}: inputs on different devices")
    for t in planes[1:]:
        if t.shape != ref.shape:
            raise ValueError(f"{name}: state planes differ in shape")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {ref.device}")


def _check_out(name, out, inputs):
    """``out`` buffers: each like ``inputs[0]``, none of them an input."""
    ref = inputs[0]
    for o in out:
        if (o.shape != ref.shape or o.dtype != torch.float32 or not o.is_contiguous()
                or o.device != ref.device):
            raise ValueError(f"{name}: out buffers must be contiguous float32 "
                             f"{tuple(ref.shape)} on the device of the inputs")
        if any(o.data_ptr() == t.data_ptr() for t in inputs):
            raise ValueError(f"{name}: an out buffer is an input")


def pcg_pass_a(x, r, p, cf, ab, out=None):
    """Pass A; returns (x_new, p_new, ap, block partials of <p_new, ap>),
    the three planes in ``out`` = (x_new, p_new, ap) buffers when given."""
    _check("pcg_pass_a", (x, r, p), cf, (ab,))
    if ab.numel() != 2:
        raise ValueError("pcg_pass_a: ab must hold [alpha_prev, beta]")
    if out is not None:
        _check_out("pcg_pass_a", out, (x, r, p))
    if x.device.type == "cpu":
        pcg_pass_a.plain_calls += 1
        return pcg_pass_a_plain(x, r, p, cf, ab, out)
    lib = load_kernels()
    _, h, w = x.shape
    x_new, p_new, ap = (torch.empty_like(x) for _ in range(3)) if out is None else out
    partials = torch.empty(num_partials(h, w), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.octane_pcg_pass_a(
            x.data_ptr(), r.data_ptr(), p.data_ptr(), cf.data_ptr(), ab.data_ptr(),
            x_new.data_ptr(), p_new.data_ptr(), ap.data_ptr(), partials.data_ptr(),
            h, w, int(cf.shape[0] == 3),
            torch.cuda.current_stream(x.device).cuda_stream)
    check_status(status, "octane_pcg_pass_a")
    pcg_pass_a.launches += 1
    return x_new, p_new, ap, partials


def pcg_pass_b(r, ap, cf, alpha, out=None):
    """Pass B; returns (r_new, (n, 2) block partials of [<r, M^-1 r>, <r, r>]),
    r_new in the ``out`` buffer when given."""
    _check("pcg_pass_b", (r, ap), cf, (alpha,), min_rows=1)   # no neighbours: any band
    if alpha.numel() != 1:
        raise ValueError("pcg_pass_b: alpha must be a one-element tensor")
    if out is not None:
        _check_out("pcg_pass_b", (out,), (r, ap))
    if r.device.type == "cpu":
        pcg_pass_b.plain_calls += 1
        return pcg_pass_b_plain(r, ap, cf, alpha, out)
    lib = load_kernels()
    _, h, w = r.shape
    r_new = torch.empty_like(r) if out is None else out
    partials = torch.empty((num_partials(h, w), 2), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        status = lib.octane_pcg_pass_b(
            r.data_ptr(), ap.data_ptr(), cf.data_ptr(), alpha.data_ptr(),
            r_new.data_ptr(), partials.data_ptr(), h, w,
            torch.cuda.current_stream(r.device).cuda_stream)
    check_status(status, "octane_pcg_pass_b")
    pcg_pass_b.launches += 1
    return r_new, partials


def pcg_pass_a_band(x, r, p, cf, ab, gr, gp, gd, row0: int, true_h: int, out=None):
    """Pass A on a band; returns (x_new, p_new, ap, block partials of
    <p_new, ap> over the band), the three planes in ``out`` = (x_new, p_new,
    ap) buffers when given.  See the module docstring."""
    _check("pcg_pass_a_band", (x, r, p), cf, (ab, gr, gp, gd), min_rows=1)
    _, hb, w = x.shape
    if ab.numel() != 2:
        raise ValueError("pcg_pass_a_band: ab must hold [alpha_prev, beta]")
    for name, g in (("gr", gr), ("gp", gp), ("gd", gd)):
        if g.shape != (2, 2, w):
            raise ValueError(f"pcg_pass_a_band: {name} must be (2, 2, {w}), got {tuple(g.shape)}")
    if not (row0 >= 0 and row0 + hb <= true_h and true_h >= 2):
        raise ValueError(f"pcg_pass_a_band: rows [{row0}, {row0 + hb}) do not fit an image "
                         f"of {true_h} rows")
    if out is not None:
        _check_out("pcg_pass_a_band", out, (x, r, p))
    if x.device.type == "cpu":
        pcg_pass_a_band.plain_calls += 1
        return pcg_pass_a_band_plain(x, r, p, cf, ab, gr, gp, gd, row0, true_h, out)
    lib = load_kernels()
    x_new, p_new, ap = (torch.empty_like(x) for _ in range(3)) if out is None else out
    partials = torch.empty(num_partials(hb, w), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.octane_pcg_pass_a_band(
            x.data_ptr(), r.data_ptr(), p.data_ptr(), cf.data_ptr(), ab.data_ptr(),
            gr.data_ptr(), gp.data_ptr(), gd.data_ptr(), x_new.data_ptr(), p_new.data_ptr(),
            ap.data_ptr(), partials.data_ptr(), hb, w, row0, true_h, int(cf.shape[0] == 3),
            torch.cuda.current_stream(x.device).cuda_stream)
    check_status(status, "octane_pcg_pass_a_band")
    pcg_pass_a_band.launches += 1
    return x_new, p_new, ap, partials


for _fn in (pcg_pass_a, pcg_pass_a_band, pcg_pass_b):
    _fn.launches = 0
    _fn.plain_calls = 0


def pcg_solve_cf(cf, b, partials, tol, iters: int, pass_a=pcg_pass_a, pass_b=pcg_pass_b,
                 count=None, round_count=None):
    """Solve A x = b from x = 0 with the two passes; returns (du, dv).

    ``cf`` is the (3|7, h, w) coefficient stack (3 planes: the quadratic
    GNC step, off-diagonals -1), ``b`` the (2, h, w) right-hand side, which
    serves as r's first set and is overwritten, and ``partials`` the (n, 3)
    block partials of the first sums (``initial_partials``).
    ``pass_a``/``pass_b`` default to the wrappers; the solver's plain route
    passes the plain versions.  ``count``, an int32 device scalar, gains
    the iterations that ran; ``round_count``, one of a traced solve
    (utils.profiling.Marks), is set to them.

    The state lives in buffers fixed before the loop, so that a skipped
    body leaves nothing stale: x, p and r ping-pong between two sets
    (iteration i reads set i % 2 and writes the other), gamma between two
    scalars, and alpha and beta stay in ``ab``, which pass A reads.  The
    iterations that ran, counted on the device, pick the final set by their
    parity.  Ping-pong rather than a copy back keeps each iteration's
    traffic that of its two passes.
    """
    gammas = [torch.sum(partials[:, 0]) + torch.sum(partials[:, 1]),
              torch.empty_like(partials[0, 0])]
    resid = torch.sum(partials[:, 2])
    xs = [torch.zeros_like(b), torch.empty_like(b)]
    ps = [torch.zeros_like(b), torch.empty_like(b)]
    rs = [b, torch.empty_like(b)]
    ap = torch.empty_like(b)
    ab = torch.zeros(2, dtype=torch.float32, device=b.device)      # [alpha, beta]
    ran = torch.zeros((), dtype=torch.int32, device=b.device)
    tol32 = float(np.float32(tol))

    def body(k):
        i, j = k % 2, 1 - k % 2
        _, _, _, pap = pass_a(xs[i], rs[i], ps[i], cf, ab, out=(xs[j], ps[j], ap))
        torch.div(gammas[i], torch.sum(pap), out=ab[0])
        _, part = pass_b(rs[i], ap, cf, ab[0:1], out=rs[j])
        torch.sum(part[:, 0], 0, out=gammas[j])
        torch.sum(part[:, 1], 0, out=resid)
        torch.div(gammas[j], gammas[i], out=ab[1])
        ran.add_(1)

    guard = Guard(pcg_solve_fused, count)
    for k in range(iters):
        guard(resid, tol32, lambda k=k: body(k))
    odd = ran % 2 == 1
    x = torch.where(odd, xs[1], xs[0])
    x = x + ab[0] * torch.where(odd, ps[1], ps[0])     # the final deferred update
    if count is not None:
        count.add_(ran)
    if round_count is not None:
        round_count.copy_(ran)
    return x[0], x[1]


def pcg_solve_fused(sysm, tol, iters: int, pass_a=pcg_pass_a, pass_b=pcg_pass_b,
                    count=None):
    """``pcg_solve_cf`` of a flow.stencil.StencilSystem ``sysm``: its planes
    stacked (``stack_system``) and the first sums taken
    (``initial_partials``); returns (du, dv).  Its ``host_syncs`` counts
    the host reads of every PCG driver's stopping test."""
    cf, b = stack_system(sysm)
    return pcg_solve_cf(cf, b, initial_partials(cf, b), tol, iters, pass_a, pass_b, count)


pcg_solve_fused.host_syncs = 0
