"""GOES fixed-grid navigation, radiance calibration and pixel->wind conversion in
float64 (counterpart of octane_tpu.nav; polar and mercator are not ported
yet)."""

from octane_tpu_torch.nav.goes import (goes_latlon, goes_xy_from_latlon,
                                       limb_ramp, navcal_goes)
from octane_tpu_torch.nav.winds import haversine_m, pix2uv, pix2uv_ms

__all__ = [
    "goes_latlon", "goes_xy_from_latlon", "limb_ramp", "navcal_goes",
    "pix2uv", "pix2uv_ms", "haversine_m",
]
