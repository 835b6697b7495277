"""GOES fixed-grid, polar and mercator navigation, radiance calibration and
pixel<->wind conversion in float64 (counterpart of octane_tpu.nav)."""

from octane_tpu_torch.nav.goes import (goes_latlon, goes_xy_from_latlon, kappa_reflectance,
                                       limb_ramp, navcal_goes, planck_temp)
from octane_tpu_torch.nav.mercator import mercator_latlon
from octane_tpu_torch.nav.polar import polar_latlon
from octane_tpu_torch.nav.winds import haversine_m, pix2uv, pix2uv_ms, uv2pix

__all__ = [
    "goes_latlon", "goes_xy_from_latlon", "limb_ramp", "navcal_goes", "planck_temp",
    "kappa_reflectance",
    "polar_latlon", "mercator_latlon", "pix2uv", "pix2uv_ms", "uv2pix", "haversine_m",
]
