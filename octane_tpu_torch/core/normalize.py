"""Per-band radiance normalisation (counterpart of octane_tpu.core.normalize;
band table of oct_normalize_geo.cc:9-88)."""

from __future__ import annotations

# band -> (min, max) radiance for normalisation (oct_normalize_geo.cc:9-88)
_BAND_MINMAX = {
    1: (-25.93664701, 804.03605737),
    2: (-20.28991094, 628.98723908),
    3: (-12.03764377, 373.16695681),
    4: (-4.52236858, 140.19342584),
    5: (-3.05961376, 94.84802665),
    6: (-0.96095066, 29.78947040),
    7: (0.0, 2.0),          # meteorological range (reference :36-42)
    8: (3.0, 6.0),          # experimental meteorological range (:43-50)
    9: (-0.2472, 44.998),
    10: (-0.2871, 79.831),
    11: (-0.3909, 134.93),
    12: (-0.4617, 108.44),
    13: (-1.6443, 185.5699),
    14: (-0.5154, 198.71),
    15: (-0.5262, 212.28),
    16: (-1.5726, 170.19),
}


def band_min_max(band: int):
    """(min, max) normalisation range for an ABI band (1-16)."""
    if band not in _BAND_MINMAX:
        raise ValueError(f"unknown ABI band {band}")
    return _BAND_MINMAX[band]


def normalize_image(img, vmin, vmax, out_min=0.0, out_max=255.0):
    """Linear rescale [vmin, vmax] -> [out_min, out_max], no clipping."""
    return (img - vmin) / (vmax - vmin) * (out_max - out_min) + out_min
