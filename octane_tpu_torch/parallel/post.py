"""Row-banded post-processing: pix2uv, pix2uv_ms and SRSAL (counterpart of
octane_tpu.parallel.post).

* ``sharded_pix2uv`` / ``sharded_pix2uv_ms``: elementwise per band, with
  the band's global rows (``nav.winds``' ``row0``), so the float64
  navigation equals the single-device call's bit for bit;
* ``sharded_srsal``: each band smooths its rows with the band form of the
  bilateral kernel (``ops.bilateral.bilateral_band``) from a slab of its
  rows and the p = 18 rows beside them, the reference's reflect boundary
  taken in global coordinates; its rows equal the single-device call's.  A
  band thinner than p falls back to the single-device ``srsal_smooth``, as
  octane_tpu's does (post.py:116-119).

The inputs and results are whole tensors; the results are on the mesh's
first device.  Temporal interpolation has no banded form yet: under a mesh
the dispatcher runs ``post.temporal`` on the whole field, which equals the
banded fixed point octane_tpu's ``sharded_interpolate_frame`` computes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from octane_tpu_torch.core.gaussian import gaussian_kernel_1d
from octane_tpu_torch.nav.winds import pix2uv, pix2uv_ms
from octane_tpu_torch.ops.bilateral import band_slab, bilateral_band
from octane_tpu_torch.parallel.halo import LocalExchange
from octane_tpu_torch.parallel.mesh import mesh_bands
from octane_tpu_torch.post.srsal import srsal_smooth


def _per_band(fn, mesh, fields, n_out, exchange):
    """``fn(band fields, r0)`` on each band; its ``n_out`` results gathered
    into whole tensors on the first band's device."""
    h = fields[0].shape[0]
    bands = mesh_bands(mesh, h)
    outs = [(r0, fn([f[r0:r1].to(dev) for f in fields], r0)) for dev, r0, r1 in bands]
    return tuple(exchange.rows([(r0, o[j]) for r0, o in outs], 0, h, bands[0][0])
                 for j in range(n_out))


def sharded_pix2uv(u_pix, v_pix, nav, dt: float, mesh, grid: str = "goes",
                   pixuv: bool = False, exchange=None):
    """``nav.winds.pix2uv`` per band: (u_wind, v_wind, u_raw, v_raw)."""
    return _per_band(lambda f, r0: pix2uv(*f, nav, dt, grid=grid, pixuv=pixuv, row0=r0),
                     mesh, (u_pix, v_pix), 4, exchange or LocalExchange())


def sharded_pix2uv_ms(u_pix, v_pix, nav, dt: float, mesh, grid: str = "goes",
                      exchange=None):
    """``nav.winds.pix2uv_ms`` per band: (u m/s, v m/s), float64."""
    return _per_band(lambda f, r0: pix2uv_ms(*f, nav, dt, grid=grid, row0=r0),
                     mesh, (u_pix, v_pix), 2, exchange or LocalExchange())


def sharded_srsal(u, v, cth, mesh, filtsigma: float = 9.0, sigpix: float = 20.0,
                  exchange=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """SRSAL on the mesh's bands; equals ``post.srsal.srsal_smooth``."""
    exchange = exchange or LocalExchange()
    p = int(2 * filtsigma)
    h = u.shape[0]
    if -(-h // mesh.n) <= p:
        # a band thinner than the window's half-width: the single-program path
        return srsal_smooth(u, v, cth, filtsigma, sigpix)
    gk = gaussian_kernel_1d(filtsigma, p)
    sigpix2 = -1.0 / (2.0 * sigpix * sigpix)
    parts = [(0, torch.stack([t.to(torch.float32) for t in (u, v, cth)]))]
    outs = []
    for dev, r0, r1 in mesh_bands(mesh, h):
        s0, s1 = band_slab(r0, r1, h, p)
        slab = exchange.rows(parts, s0, s1, dev)
        outs.append((r0, bilateral_band(slab[0], slab[1], slab[2], gk, sigpix2, s0, r0,
                                        r1 - r0, h)))
    out = exchange.rows(outs, 0, h, outs[0][1].device)
    return out[0], out[1]
