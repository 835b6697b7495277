"""Flow computation orchestration (counterpart of octane_tpu.flow.dispatcher;
oct_optical_flow.cc:21-111): first guess, the variational, patch-match or
hybrid engine, the CTP product, pixel -> wind navigation and SRSAL
smoothing.

Ported: the single-device branches on every grid, with the first-guess
winds (``nav.winds.uv2pix``) or a given first guess (a sequence's warm
start), the CTP product, the float64 m/s winds of polar and mercator
products and the SRSAL bilateral smoothing (``post.srsal``).  "hybrid" is
patch-match initialization (``flow.patch_match``) refined by
``variational_flow``.  The JAX package's post-hoc warp-reach audit has no
counterpart: the CUDA warp has no window, so its reach is unbounded.

Under a device mesh (``active_mesh``: cfg.mesh_shape of more than one
band) the variational solve and the hybrid refinement run on the mesh's
row bands (``parallel.sharded_variational_flow``), and so do pix2uv,
pix2uv_ms and SRSAL (``parallel.post``) and the zero-guess patch-match
(``flow.patch_match.patch_match_flow_sharded``, equal to the
single-device call, as octane_tpu's is, patch_match.py:293-300); the
first-guess patch-match is sector-scale and runs whole.  Temporal
interpolation (``pipeline.interpolate_sequence``) runs on the bands too
(``parallel.post.sharded_interpolate_frame``).
"""

from __future__ import annotations

import warnings

import torch

from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.flow.patch_match import patch_match_flow, patch_match_flow_sharded
from octane_tpu_torch.flow.variational import variational_flow
from octane_tpu_torch.io.datamodel import Scene
from octane_tpu_torch.nav.goes import F64
from octane_tpu_torch.nav.winds import pix2uv, pix2uv_ms, uv2pix
from octane_tpu_torch.post.srsal import srsal_smooth


def active_mesh(cfg: OFConfig, device="cuda"):
    """The mesh of ``cfg.mesh_shape`` when it asks for more than one band
    and enough devices exist, else None (octane_tpu's rule,
    dispatcher.py:23-31).  On the CPU every band lives on the CPU; on the
    card band i takes cuda:i, so a mesh of more bands than visible cards is
    None, with a warning, and the single-device path runs."""
    from octane_tpu_torch.parallel.mesh import make_mesh

    ry, rx = cfg.mesh_shape
    n = ry * rx
    if n <= 1:
        return None
    device = torch.device(device)
    if device.type == "cpu":
        return make_mesh((ry, rx), [device] * n)
    if torch.cuda.device_count() < n:
        warnings.warn(f"mesh {ry}x{rx} needs {n} CUDA devices, {torch.cuda.device_count()} "
                      "are visible: running on one device", RuntimeWarning)
        return None
    return make_mesh((ry, rx), [torch.device("cuda", i) for i in range(n)])


def _variational(data1, data2, u0, v0, cfg: OFConfig, mesh=None):
    """The dense solve, on the mesh's bands when one is active."""
    if mesh is not None:
        from octane_tpu_torch.parallel.sharded import sharded_variational_flow
        return sharded_variational_flow(data1, data2, u0, v0, cfg, mesh)
    return variational_flow(data1, data2, u0, v0, cfg)


def compute_flow(scene1: Scene, scene2: Scene, cfg: OFConfig,
                 first_guess=None) -> Scene:
    """Fill scene1's flow products from the (scene1, scene2) pair; returns
    scene1.  ``first_guess`` optionally gives (u0, v0) pixel displacements."""
    h, w = scene1.shape
    dev = scene1.data.device
    nav = scene1.nav
    dt = scene2.t - scene1.t

    # --- first guess (ref :37-53) -------------------------------------------
    have_guess = True
    if first_guess is not None:
        u0 = torch.as_tensor(first_guess[0], dtype=torch.float32, device=dev)
        v0 = torch.as_tensor(first_guess[1], dtype=torch.float32, device=dev)
    elif cfg.do_firstguess and scene1.ufg is not None:
        u0, v0 = uv2pix(scene1.ufg, scene1.vfg, scene1.lat, scene1.lon,
                        scene1.x, scene1.y, nav, dt, grid=cfg.grid)
    else:
        have_guess = False
        u0 = torch.zeros((h, w), dtype=torch.float32, device=dev)
        v0 = torch.zeros((h, w), dtype=torch.float32, device=dev)

    # --- flow engine (ref :54-68; "hybrid": patch-match initialization +
    # variational refinement) ------------------------------------------------
    mesh = active_mesh(cfg, dev)
    if cfg.algorithm in ("patch_match", "hybrid"):
        if scene1.nchannels > 1 and cfg.algorithm == "patch_match":
            raise ValueError("patch match supports single-channel input only")
        if have_guess:
            u, v = patch_match_flow(scene1.data[0], scene2.data[0], u0, v0,
                                    cfg.rad, cfg.srad)
        elif mesh is not None:
            u, v = patch_match_flow_sharded(scene1.data[0], scene2.data[0], mesh,
                                            cfg.rad, cfg.srad)
        else:
            # slice-based fast path (no per-pixel gathers)
            u, v = patch_match_flow(scene1.data[0], scene2.data[0], None, None,
                                    cfg.rad, cfg.srad)
        if cfg.algorithm == "hybrid":
            u, v = _variational(scene1.data, scene2.data, u, v, cfg, mesh)
    else:
        u, v = _variational(scene1.data, scene2.data, u0, v0, cfg, mesh)
    scene1.u_pix = u
    scene1.v_pix = v

    # --- CTP product (ref :71-88) -------------------------------------------
    if cfg.do_cth and scene1.cth is not None:
        cthv = scene1.cth
        scene1.ctp = ((cthv - 300.0) * 100.0 if cfg.ir else cthv).to(torch.int16)

    # --- navigate to winds (ref :91) ----------------------------------------
    nav.g2x_offset = scene2.nav.x_offset if cfg.grid == "goes" else nav.x_offset
    nav.g2y_offset = scene2.nav.y_offset if cfg.grid == "goes" else nav.y_offset
    if mesh is not None:
        from octane_tpu_torch.parallel.post import sharded_pix2uv, sharded_pix2uv_ms
        uw, vw, ur, vr = sharded_pix2uv(u, v, nav, dt, mesh, grid=cfg.grid, pixuv=cfg.pixuv)
    else:
        uw, vw, ur, vr = pix2uv(u, v, nav, dt, grid=cfg.grid, pixuv=cfg.pixuv)
    scene1.u_wind, scene1.v_wind = uw, vw
    scene1.u_raw, scene1.v_raw = ur, vr
    if cfg.grid != "goes" and not cfg.pixuv:
        # flat-grid products keep full-precision winds (oct_polarwrite
        # writes U/V as doubles, oct_filewrite.cc:401-402)
        if mesh is not None:
            ums, vms = sharded_pix2uv_ms(u, v, nav, dt, mesh, grid=cfg.grid)
        else:
            ums, vms = pix2uv_ms(u, v, nav, dt, grid=cfg.grid)
        scene1.u_ms, scene1.v_ms = ums.to(F64), vms.to(F64)
    scene1.dt = float(dt)

    # --- bilateral smoothing of the pixel flow (ref :100-105) ---------------
    if cfg.do_srsal and scene1.cth is not None:
        if mesh is not None:
            from octane_tpu_torch.parallel.post import sharded_srsal
            scene1.u_pix, scene1.v_pix = sharded_srsal(u, v, scene1.cth, mesh)
        else:
            scene1.u_pix, scene1.v_pix = srsal_smooth(u, v, scene1.cth)
    return scene1
