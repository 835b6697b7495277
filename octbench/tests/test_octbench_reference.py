"""The plain reference against the port on the CPU, at 64 x 64 with the
configuration's settings, and its control: the same reference in the
precision below the configuration's, which the limits must refuse."""

import numpy as np
import pytest
import torch

from octbench import grid, reference, spec, traffic
from octbench.tests.tiny import LIMITS


def _pairs(solver, n=64):
    from octane_tpu_torch.config import OFConfig
    from octane_tpu_torch.flow.dispatcher import compute_flow
    from octane_tpu_torch.io.datamodel import NavConstants
    from octane_tpu_torch.io.readers import scene_from_goes_arrays, set_goes_grid

    cfg = spec.load_json(f"{spec.HERE}/configs/goes-meso-b13.json")
    cfg["rows"] = cfg["cols"] = n
    tr = spec.traffic("meso-loop")
    tr.update(sequences=1, frames=3)
    st = traffic.make_stream(cfg, tr, 2 ** 32 + 5, "cpu")
    nav = grid.nav_constants(cfg)
    x, y = grid.scan_counts(cfg)
    ocfg = OFConfig(solver=solver, **cfg["settings"])
    fg = None
    for i in range(2):
        s1, s2 = (scene_from_goes_arrays(st.frames[0][j], x, y,
                                         set_goes_grid(NavConstants(**nav), n, n, 13), ocfg,
                                         "cpu", donav=j == i, t=st.times[0][j], band=13)
                  for j in (i, i + 1))
        compute_flow(s1, s2, ocfg, first_guess=fg)
        fg = (s1.u_pix, s1.v_pix)
        yield cfg, nav, st.frames[0][i], st.frames[0][i + 1], s1, s2


@pytest.mark.parametrize("solver", ["pcg", "sor"])
def test_reference_follows_the_port_and_the_control_does_not(solver):
    ref_fg = ctl_fg = None
    for cfg, nav, c1, c2, s1, s2 in _pairs(solver):
        lo, hi = cfg["norm_min"], cfg["norm_max"]
        d1, d2 = (reference.normalised(c, nav, lo, hi, "cpu") for c in (c1, c2))
        assert torch.equal(d1, s1.data[0]) and torch.equal(d2, s2.data[0])
        z = torch.zeros_like(d1)
        u0, v0 = ref_fg or (z, z)
        u, v, _ = reference.solve(d1[None], d2[None], u0, v0, cfg["settings"], solver,
                                  acc=reference.REFERENCE.accumulate)
        ref_fg = (u, v)
        assert float((u - s1.u_pix).abs().max()) < LIMITS["flow_gap_px"] / 10
        assert float((v - s1.v_pix).abs().max()) < LIMITS["flow_gap_px"] / 10
        for got, want in zip((s1.u_wind, s1.v_wind, s1.u_raw, s1.v_raw),
                             reference.winds(u, v, nav, 60.0)):
            assert int((got.int() - want.int()).abs().max()) <= 1
        # the control: navigation in float32, the solve in bfloat16
        e1, e2 = (reference.normalised(c, nav, lo, hi, "cpu", reference.CONTROL) for c in (c1, c2))
        assert float((e1 != d1).float().mean()) > LIMITS["ingest_mismatch"]
        cu0, cv0 = ctl_fg or (z, z)
        cu, cv, _ = reference.solve(e1[None], e2[None], cu0, cv0, cfg["settings"], solver,
                                    torch.bfloat16)
        ctl_fg = (cu, cv)
        assert float((cu - u).abs().max()) > LIMITS["flow_gap_px"]


def test_winds_zero_beyond_the_limb():
    cfg = spec.load_json(f"{spec.HERE}/configs/goes-fd-b13.json")
    cfg.update(rows=85, cols=85, x_scale=cfg["x_scale"] * 64, y_scale=cfg["y_scale"] * 64)
    nav = grid.nav_constants(cfg)
    u = torch.full((85, 85), 0.1)
    U, V, Ur, Vr = reference.winds(u, torch.zeros_like(u), nav, 600.0)
    x, y = grid.scan_angles(cfg, "cpu", torch.float64)
    limb = (x * x + y * y > 0.021).numpy()
    assert np.all(U.numpy()[limb] == 0) and np.all(U.numpy()[~limb] > 0)
    assert np.all(Ur.numpy() == 10)
