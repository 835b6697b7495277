"""Red-black SOR: the CUDA pass kernel, its plain version and the solve loop.

The port of octane_tpu/ops/pallas/sor.py.  The system is the coefficient
stack of ``build_cf``: (nc, h, w) float32 planes [a1, a4, a2, bu, bv, rdet]
for the quadratic GNC step (nc = 6, off-diagonals the scalar -1) or
[a1, a4, a2, bu, bv, a5, a6, a7, a8, rdet] (nc = 10), where rdet is the
hoisted reciprocal block determinant (flow.cg.sor_rdet).  The fused
assembly (ops.assemble) writes it directly.

``sor_sweep(x, cf, colour, omega, resid)`` is one colour half-sweep of the
(2, h, w) iterate x (u then v; colour 0 is red, (row + column) even) in
plain PyTorch, on any device: the residual r = b - A x under the
mirror-at-1 edges, then x += omega times the exact 2 x 2 block solve on
that colour's cells.  Without ``resid`` it updates x in place and returns
(x, None).  With ``resid`` it leaves x as it is and returns a new iterate
with the partials of the full-grid pre-update ||r||^2, one per 32 x 8
block in the kernels' summation order (``ops.pcg.block_partials``).

``sor_pass(x, cf, sweeps, omega, out)`` is one pass of ``sweeps`` (1 .. 8)
red+black sweeps: it returns the new iterate (in ``out`` when given, never
in x) and the residual partials of the incoming x.  On a CUDA tensor it
launches ``csrc/sor.cu`` (temporally blocked: one launch, x and the
coefficients read about once); on a CPU tensor it runs ``sor_pass_plain``,
2 * sweeps plain half-sweeps, which the kernel equals bit for bit.
``sor_pass.launches`` / ``.plain_calls`` count them.

``sor_pass_band(x, cf, sweeps, omega, row0, true_h, r_begin, r_end, out)``
is the band form for the mesh path (parallel.sor): x and cf are a slab of
global rows [row0, row0 + hs) of a true_h-row image, the band is its rows
[r_begin, r_end), and every slab edge that is not the image's carries at
least 2 * sweeps ghost rows.  It returns the band's new rows (in ``out``,
which may be a view with another plane stride) and the partials of the
band's rows; the colour parity is global, so the band equals the
whole-image pass's rows bit for bit.  On a CUDA tensor it launches
``octane_sor_pass_band`` of ``csrc/sor.cu``, on a CPU tensor
``sor_pass_band_plain``.

``sor_solve_cf`` is the driver (sor.py:482): passes of S = min(8, iters)
red+black sweeps, each a body guarded by ``resid > tol`` (ops.guard.Guard:
an IF node of the graph while flow.variational's program captures the
pair, else a host read, which ``sor_solve_cf.host_syncs`` counts), and a
remainder pass of iters mod S sweeps under the same guard.  Each pass
reports the residual of its incoming iterate, so the test after pass k
reads the residual at the start of pass k, as on the TPU.  The reference
loop flow.cg.sor_solve tests every sweep: the two agree bit for bit while
tol does not bind, and the driver runs at most 2S more sweeps when it does.

flow.stencil imports ops (the warp), so the flow modules are imported
inside the functions that use them.
"""

from __future__ import annotations

import numpy as np
import torch

from octane_tpu_torch.ops.build import check_status, load_kernels
from octane_tpu_torch.ops.guard import Guard
from octane_tpu_torch.ops.pcg import block_partials, num_partials

OMEGA = 1.9            # the SOR over-relaxation factor (config.sor_omega)
PASS_SWEEPS = 8        # red+black sweeps per pass (sor.py:499)
MAX_SWEEPS = 8         # sweeps one kernel launch may run (csrc/sor.cu)


def build_cf(sysm) -> torch.Tensor:
    """The (nc, h, w) coefficient stack of a flow.stencil.StencilSystem
    (octane_tpu's build_cf without the padding); a scalar ``a5`` marks the
    quadratic step."""
    from octane_tpu_torch.flow.cg import sor_rdet

    planes = [sysm.a1, sysm.a4, sysm.a2, sysm.bu, sysm.bv]
    if torch.is_tensor(sysm.a5):
        planes += [sysm.a5, sysm.a6, sysm.a7, sysm.a8]
    return torch.stack(planes + [sor_rdet(sysm)])


def _system(cf):
    """The StencilSystem view of a coefficient stack."""
    from octane_tpu_torch.flow.stencil import StencilSystem

    off = (-1.0,) * 4 if cf.shape[0] == 6 else tuple(cf[5:9])
    return StencilSystem(cf[0], cf[2], cf[1], *off, cf[3], cf[4])


def sor_sweep_plain(x, cf, colour: int, omega: float = OMEGA, resid: bool = False,
                    row0: int = 0, rows=None):
    """Plain half-sweep: the residual over the whole grid, the update masked
    to the colour (flow.cg.sor_solve's colour sweep).  ``row0`` is the
    global row of x's first row (the colour parity); ``rows`` = (a, b)
    limits the residual partials to rows [a, b)."""
    from octane_tpu_torch.flow.cg import checkerboard
    from octane_tpu_torch.flow.stencil import apply_stencil

    sysm = _system(cf)
    au, av = apply_stencil(sysm, x[0], x[1])
    ru = sysm.bu - au
    rv = sysm.bv - av
    rdet = cf[-1]
    ndu = (sysm.a4 * ru - sysm.a2 * rv) * rdet
    ndv = (sysm.a1 * rv - sysm.a2 * ru) * rdet
    mask = checkerboard(*x.shape[1:], x.device)
    if (colour + row0) % 2:
        mask = ~mask
    new = torch.stack([torch.where(mask, x[0] + omega * ndu, x[0]),
                       torch.where(mask, x[1] + omega * ndv, x[1])])
    if resid:
        a, b = (0, x.shape[1]) if rows is None else rows
        return new, block_partials((ru * ru + rv * rv)[a:b])
    x.copy_(new)
    return x, None


def sor_pass_plain(x, cf, sweeps: int, omega: float = OMEGA, out=None, row0: int = 0,
                   rows=None):
    """Plain pass: 2 * sweeps half-sweeps, red first, with the residual
    partials of the incoming x from the first (``row0``, ``rows``: see
    sor_sweep_plain)."""
    new, part = sor_sweep_plain(x, cf, 0, omega, resid=True, row0=row0, rows=rows)
    sor_sweep_plain(new, cf, 1, omega, row0=row0)
    for _ in range(sweeps - 1):
        sor_sweep_plain(new, cf, 0, omega, row0=row0)
        sor_sweep_plain(new, cf, 1, omega, row0=row0)
    if out is not None:
        new = out.copy_(new)
    return new, part


def sor_pass_band_plain(x, cf, sweeps: int, omega: float, row0: int, true_h: int,
                        r_begin: int, r_end: int, out=None):
    """Plain band form: the plain pass on the whole slab, cropped to the
    band (``sor_pass_band``'s arguments; true_h is not needed).  A slab
    edge that is a cut takes the mirror-at-1 neighbours too, but its error
    moves one row per half-sweep, so the 2 * sweeps ghost rows keep it out
    of the band."""
    new, part = sor_pass_plain(x, cf, sweeps, omega, row0=row0, rows=(r_begin, r_end))
    new = new[:, r_begin:r_end]
    if out is not None:
        new = out.copy_(new)
    return new, part


def _check_cf(name, cf):
    """Raise ValueError unless ``cf`` is an (6|10, h, w) float32 contiguous
    coefficient stack with h, w >= 2."""
    if cf.dim() != 3 or cf.shape[0] not in (6, 10):
        raise ValueError(f"{name}: the coefficient stack must be (6|10, h, w), "
                         f"got {tuple(cf.shape)}")
    if min(cf.shape[1:]) < 2:
        raise ValueError(f"{name}: the grid needs at least 2 rows and 2 columns")
    if cf.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {cf.dtype}")
    if not cf.is_contiguous():
        raise ValueError(f"{name}: the coefficient stack must be contiguous")
    if cf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {cf.device}")


def _check_iterate(name, x, cf):
    if x.shape != (2, *cf.shape[1:]):
        raise ValueError(f"{name}: x must be (2, h, w) = (2, {cf.shape[1]}, "
                         f"{cf.shape[2]}), got {tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.device != cf.device:
        raise ValueError(f"{name}: x must be contiguous float32 on the device of cf")


def sor_sweep(x, cf, colour: int, omega: float = OMEGA, resid: bool = False):
    """One plain half-sweep of ``colour`` with its inputs checked; see the
    module docstring.  The reference the pass kernel is held to."""
    _check_cf("sor_sweep", cf)
    _check_iterate("sor_sweep", x, cf)
    if colour not in (0, 1):
        raise ValueError(f"sor_sweep: colour must be 0 (red) or 1 (black), got {colour}")
    return sor_sweep_plain(x, cf, colour, omega, resid)


def sor_pass(x, cf, sweeps: int, omega: float = OMEGA, out=None):
    """One pass of ``sweeps`` red+black sweeps; returns (new iterate,
    partials of the incoming ||r||^2)."""
    _check_cf("sor_pass", cf)
    _check_iterate("sor_pass", x, cf)
    if not 1 <= sweeps <= MAX_SWEEPS:
        raise ValueError(f"sor_pass: sweeps must be in 1 .. {MAX_SWEEPS}, got {sweeps}")
    if out is not None:
        _check_iterate("sor_pass", out, cf)
        if out.data_ptr() == x.data_ptr():
            raise ValueError("sor_pass: out must not be x")
    if x.device.type == "cpu":
        sor_pass.plain_calls += 1
        return sor_pass_plain(x, cf, sweeps, omega, out)
    result = _launch_pass(x, cf, sweeps, omega, out)
    sor_pass.launches += 1
    return result


sor_pass.launches = 0
sor_pass.plain_calls = 0


def _launch_pass(x, cf, sweeps, omega, out=None, strip=0, seg=0):
    """Launch the pass kernel on checked CUDA inputs.  The kernel picks its
    block geometry (csrc/sor.cu default_geometry) unless ``strip`` and
    ``seg`` name one, as tuning and the card tests do."""
    nc, h, w = cf.shape
    lib = load_kernels()
    x_out = torch.empty_like(x) if out is None else out
    partials = torch.empty(num_partials(h, w), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.octane_sor_pass(
            x.data_ptr(), x_out.data_ptr(), cf.data_ptr(), partials.data_ptr(),
            h, w, int(nc == 6), sweeps, strip, seg, omega,
            torch.cuda.current_stream(x.device).cuda_stream)
    check_status(status, "octane_sor_pass")
    return x_out, partials


def sor_pass_band(x, cf, sweeps: int, omega: float, row0: int, true_h: int, r_begin: int,
                  r_end: int, out=None):
    """Band form of ``sor_pass``; returns (the band's new rows, the band's
    residual partials).  See the module docstring."""
    _check_cf("sor_pass_band", cf)
    _check_iterate("sor_pass_band", x, cf)
    if not 1 <= sweeps <= MAX_SWEEPS:
        raise ValueError(f"sor_pass_band: sweeps must be in 1 .. {MAX_SWEEPS}, got {sweeps}")
    _, hs, w = cf.shape
    ghost = 2 * sweeps
    if not (0 <= r_begin < r_end <= hs and row0 >= 0 and row0 + hs <= true_h
            and (row0 == 0 or r_begin >= ghost)
            and (row0 + hs == true_h or hs - r_end >= ghost)):
        raise ValueError(f"sor_pass_band: band rows [{r_begin}, {r_end}) of a slab of {hs} "
                         f"rows at global row {row0} of {true_h} need {ghost} ghost rows "
                         "beside each cut")
    hb = r_end - r_begin
    if out is None:
        out = torch.empty((2, hb, w), dtype=torch.float32, device=x.device)
    elif (out.shape != (2, hb, w) or out.dtype != torch.float32 or out.device != x.device
          or out.stride()[1:] != (w, 1)):
        raise ValueError(f"sor_pass_band: out must be (2, {hb}, {w}) float32 rows of stride "
                         f"{w} on the device of x")
    if x.device.type == "cpu":
        sor_pass_band.plain_calls += 1
        return sor_pass_band_plain(x, cf, sweeps, omega, row0, true_h, r_begin, r_end, out)
    lib = load_kernels()
    partials = torch.empty(num_partials(hb, w), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.octane_sor_pass_band(
            x.data_ptr(), out.data_ptr(), cf.data_ptr(), partials.data_ptr(), hs, w, row0,
            true_h, r_begin, r_end, out.stride(0), int(cf.shape[0] == 6), sweeps, 0, 0, omega,
            torch.cuda.current_stream(x.device).cuda_stream)
    check_status(status, "octane_sor_pass_band")
    sor_pass_band.launches += 1
    return out, partials


sor_pass_band.launches = 0
sor_pass_band.plain_calls = 0


def sor_solve_cf(cf, resid0, tol, iters: int, omega: float = OMEGA, pass_fn=sor_pass,
                 count=None, round_count=None):
    """Multi-sweep SOR from x = 0 on a coefficient stack; returns (du, dv).

    ``resid0`` is ||b||^2 (a device scalar, e.g. the sum of the assembly's
    partials); ``pass_fn`` defaults to the wrapper, and the solver's plain
    route passes the counted plain version.  ``count``, an int32 device
    scalar, gains the passes that ran; ``round_count``, one of a traced
    solve (utils.profiling.Marks), is set to them.  The passes ping-pong
    between two iterate buffers (pass k reads buffer k % 2), and the
    passes that ran, counted on the device, pick the final one by their
    parity.  The remainder pass runs under the main passes' guard: the
    residual exceeds tol after the loop only if no main pass was skipped.
    """
    _check_cf("sor_solve_cf", cf)
    if iters < 1:
        raise ValueError(f"sor_solve_cf: iters must be >= 1, got {iters}")
    _, h, w = cf.shape
    s_main = min(PASS_SWEEPS, iters)
    n_main, s_rem = divmod(iters, s_main)
    tol32 = float(np.float32(tol))
    bufs = [torch.zeros((2, h, w), dtype=torch.float32, device=cf.device),
            torch.empty((2, h, w), dtype=torch.float32, device=cf.device)]
    resid = resid0.clone()
    ran = torch.zeros((), dtype=torch.int32, device=cf.device)

    def body(k, ns):
        _, part = pass_fn(bufs[k % 2], cf, ns, omega, out=bufs[1 - k % 2])
        torch.sum(part, 0, out=resid)
        ran.add_(1)

    guard = Guard(sor_solve_cf, count)
    for k in range(n_main):
        guard(resid, tol32, lambda k=k: body(k, s_main))
    if s_rem:
        guard(resid, tol32, lambda: body(n_main, s_rem))
    x = torch.where(ran % 2 == 1, bufs[1], bufs[0])
    if count is not None:
        count.add_(ran)
    if round_count is not None:
        round_count.copy_(ran)
    return x[0], x[1]


sor_solve_cf.host_syncs = 0


def sor_solve_fused(sysm, tol, iters: int, omega: float = OMEGA, pass_fn=sor_pass):
    """Drop-in for flow.cg.sor_solve (octane_tpu's sor_solve_fused): the
    driver on ``build_cf(sysm)`` with resid0 = ||b||^2."""
    resid0 = torch.sum(sysm.bu * sysm.bu) + torch.sum(sysm.bv * sysm.bv)
    return sor_solve_cf(build_cf(sysm), resid0, tol, iters, omega, pass_fn)
