"""The general generator of GOES-R ABI scan streams.

A traffic file (``traffic/<name>.json``, resolved by ``spec.traffic``)
gives the parameters; the seed gives everything else.  Each stream is ``sequences`` loops of ``frames``
consecutive scans ``cadence_s`` apart (the configuration's cadence), int16
L1b counts on the configuration's fixed grid:

* space beyond the limb takes the configuration's space count;
* an emissive band (7-16) sees a brightness temperature: clear sky that
  cools with latitude, cloud tops colder than it (``clouds``), through
  the band's inverse Planck function into radiance;
* a reflective band (1-6) sees a reflectance factor (``clouds`` for the
  decks and the traffic's ``reflectance`` for the rest): a seeded
  land/ocean surface under the same cloud decks, brighter than it, all
  scaled by the cosine of the solar zenith angle from the subsolar point
  and 0 where the sun is down, into radiance through the band's kappa0;
* cloud decks carry multi-scale texture, power-law spectra made by FFT;
* the motion is smooth and non-uniform: zonal jets with meanders and
  vortices, damped to calm over part of the scene, capped at
  ``max_speed_ms`` (metres per second at the sub-satellite pixel size);
* scan k + 1 is scan k advected by one cadence of that steady motion
  (bicubic, backward), so consecutive scans are a pair of known motion.

Fields are made on the device from a ``torch.Generator`` seeded by the
seed (in a few whole-image calls); the handful of scalars that place
jets and vortices come from a numpy generator seeded by the seed and the
loop.  The stream walks the loops in turn, each from its first pair to its
last (a loop never pairs its last scan with its first), and starts again.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from octbench import grid

T0 = 650000000.0            # J2000 seconds of the first scan of loop 0
LOOP_GAP_S = 86400.0        # loops are a day apart


@dataclasses.dataclass
class Stream:
    """frames[s][i]: host int16 (H, W) counts of loop s, scan i; times[s][i]
    its time; pairs: the (loop, first scan) of each pair, in stream order;
    max_px: the largest displacement per cadence, in pixels."""

    frames: List[List[np.ndarray]]
    times: List[List[float]]
    pairs: List[tuple]
    max_px: float
    calm_share: float


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    return gen


def power_law_field(h: int, w: int, slope: float, gen, device) -> torch.Tensor:
    """(h, w) float32 Gaussian field of power spectrum k^-slope, zero mean,
    unit standard deviation."""
    noise = torch.randn((h, w), generator=gen, device=device, dtype=torch.float32)
    ky = torch.fft.fftfreq(h, device=device)[:, None]
    kx = torch.fft.rfftfreq(w, device=device)[None, :]
    k = torch.sqrt(kx * kx + ky * ky)
    kmin = 1.0 / max(h, w)
    amp = torch.where(k > 0, torch.clamp(k, min=kmin) ** (-slope / 2.0), torch.zeros_like(k))
    field = torch.fft.irfft2(torch.fft.rfft2(noise) * amp, s=(h, w))
    field = field - field.mean()
    return field / field.std()


def motion_px(cfg: dict, mot: dict, lat: torch.Tensor, rng, gen, device):
    """(d_col, d_row, calm share): the displacement of one cadence, in
    pixels, at every pixel."""
    h, w = lat.shape
    px_m = cfg["pixel_km"] * 1000.0
    rows = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    cols = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    u = torch.zeros((h, w), device=device)
    v = torch.zeros((h, w), device=device)
    for _ in range(mot["jets"]):
        if "jet_lat_offset_deg" in mot:     # a sector: the jet crosses it
            lat_j = float(lat.mean()) + rng.uniform(*mot["jet_lat_offset_deg"])
        else:
            lat_j = rng.uniform(*mot["jet_lat_deg"]) * rng.choice((-1.0, 1.0))
        speed = rng.uniform(*mot["jet_speed_ms"])
        env = torch.exp(-((lat - lat_j) / mot["jet_width_deg"]) ** 2)
        wavelength = rng.uniform(*mot["meander_px"])
        phase = rng.uniform(0.0, 2.0 * math.pi)
        u = u + speed * env
        v = v + mot["meander_share"] * speed * env * torch.sin(2 * math.pi * cols / wavelength
                                                               + phase)
    for _ in range(mot["vortices"]):
        r0, c0 = rng.uniform(0.1, 0.9) * h, rng.uniform(0.1, 0.9) * w
        radius = rng.uniform(*mot["vortex_radius_km"]) * 1000.0 / px_m
        speed = rng.uniform(*mot["vortex_speed_ms"]) * rng.choice((-1.0, 1.0))
        dy, dx = rows - r0, cols - c0
        rr = torch.sqrt(dx * dx + dy * dy) / radius
        vt = speed * rr * torch.exp(0.5 * (1.0 - rr * rr))
        norm = torch.clamp(torch.sqrt(dx * dx + dy * dy), min=1e-3)
        u = u - vt * dy / norm          # rows point south: -dy is north
        v = v - vt * dx / norm
    calm_field = power_law_field(h, w, mot["calm_slope"], gen, device)
    thr = float(torch.special.ndtri(torch.tensor(1.0 - mot["calm_share"])))
    calm = torch.sigmoid((calm_field - thr) / 0.2)
    damp = 1.0 - (1.0 - mot["calm_floor"]) * calm
    u, v = u * damp, v * damp
    speed = torch.sqrt(u * u + v * v)
    cap = torch.clamp(mot["max_speed_ms"] / torch.clamp(speed, min=1e-6), max=1.0)
    u, v = u * cap, v * cap
    dt = cfg["cadence_s"]
    return u * dt / px_m, -v * dt / px_m, float((calm > 0.5).float().mean())


def cloud_decks(cl: dict, h: int, w: int, gen, device):
    """(cover, depth, texture): the cloud cover in [0, 1] with edges of
    width ``edge``, the decks' depth in [0, 1], and the unit texture field
    that the scene's surface shares."""
    structure = power_law_field(h, w, cl["structure_slope"], gen, device)
    texture = power_law_field(h, w, cl["texture_slope"], gen, device)
    thr = float(torch.special.ndtri(torch.tensor(1.0 - cl["cloud_share"])))
    cover = torch.sigmoid((structure - thr) / cl["edge"])
    depth = torch.clamp(structure - thr, min=0.0, max=3.0) / 3.0
    return cover, depth, texture


def brightness_temperature(cl: dict, lat: torch.Tensor, gen, device) -> torch.Tensor:
    """(h, w) float32 kelvin: clear sky cooling with latitude, cloud decks
    of multi-scale texture."""
    h, w = lat.shape
    cover, depth, texture = cloud_decks(cl, h, w, gen, device)
    s = torch.sin(lat * (math.pi / 180.0))
    clear = cl["clear_equator_k"] - cl["clear_drop_k"] * s * s + cl["clear_texture_k"] * texture
    tops = cl["top_warm_k"] - cl["top_span_k"] * depth + cl["top_texture_k"] * texture
    return clear * (1.0 - cover) + tops * cover


def cos_solar_zenith(rf: dict, lat: torch.Tensor, lon: torch.Tensor) -> torch.Tensor:
    """The cosine of the solar zenith angle at (lat, lon) degrees for the
    subsolar point (``subsolar_lat_deg``, ``subsolar_lon_deg``), 0 where
    the sun is below the horizon."""
    d = math.pi / 180.0
    lat_s, lon_s = rf["subsolar_lat_deg"] * d, rf["subsolar_lon_deg"] * d
    mu = math.sin(lat_s) * torch.sin(lat * d) \
        + math.cos(lat_s) * torch.cos(lat * d) * torch.cos(lon * d - lon_s)
    return torch.clamp(mu, min=0.0)


def reflectance_factor(cl: dict, rf: dict, mu0: torch.Tensor, gen, device) -> torch.Tensor:
    """(h, w) float32 reflectance factor: a surface of ocean (``ocean``
    range) and land (``land`` range, over ``land_share`` of the scene with
    coasts of width ``coast_edge``) under the cloud decks of ``cl``, whose
    tops span ``cloud_top`` with depth, all times ``mu0``."""
    h, w = mu0.shape
    cover, depth, texture = cloud_decks(cl, h, w, gen, device)
    land_field = power_law_field(h, w, rf["land_slope"], gen, device)
    thr = float(torch.special.ndtri(torch.tensor(1.0 - rf["land_share"])))
    land = torch.sigmoid((land_field - thr) / rf["coast_edge"])
    shade = torch.sigmoid(texture)
    (o0, o1), (l0, l1), (t0, t1) = rf["ocean"], rf["land"], rf["cloud_top"]
    surface = (o0 + (o1 - o0) * shade) * (1.0 - land) + (l0 + (l1 - l0) * shade) * land
    tops = t0 + (t1 - t0) * depth + rf["top_texture"] * texture
    return (surface * (1.0 - cover) + tops * cover) * mu0


def advect(field: torch.Tensor, d_col: torch.Tensor, d_row: torch.Tensor) -> torch.Tensor:
    """field(p - d(p)): one cadence of the steady motion, bicubic, edges
    clamped."""
    h, w = field.shape
    rows = torch.arange(h, device=field.device, dtype=torch.float32)[:, None]
    cols = torch.arange(w, device=field.device, dtype=torch.float32)[None, :]
    gx = (cols - d_col) * (2.0 / (w - 1)) - 1.0
    gy = (rows - d_row) * (2.0 / (h - 1)) - 1.0
    g = torch.stack([gx, gy], dim=-1)[None]
    return torch.nn.functional.grid_sample(field[None, None], g, mode="bicubic",
                                           padding_mode="border", align_corners=True)[0, 0]


def reflective(cfg: dict) -> bool:
    """Bands 1-6 reflect sunlight; 7-16 are emissive."""
    return cfg["band"] <= 6


def to_counts(field: torch.Tensor, on_earth: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The scene -> band radiance -> int16 counts; space takes the space
    count.  An emissive band's scene is kelvin, through the inverse of the
    reader's Planck function; a reflective band's is a reflectance factor,
    over kappa0."""
    cal = cfg["calibration"]
    if reflective(cfg):
        rad = field / cal["kap1"]
    else:
        rad = cal["fk1"] / (torch.exp(cal["fk2"] / (cal["bc1"] + cal["bc2"] * field)) - 1.0)
    counts = torch.round((rad - cal["rad_offset"]) / cal["rad_scale"])
    counts = torch.clamp(counts, 0, cal["max_count"])
    counts = torch.where(on_earth, counts, torch.full_like(counts, cfg["space_count"]))
    return counts.to(torch.int16)


def make_stream(cfg: dict, traffic: dict, seed: int, device) -> Stream:
    """The stream of a configuration and traffic mix for ``seed``."""
    gen = _generator(seed, device)
    lat, on_earth = grid.earth_latlon(cfg, device)
    mu0 = (cos_solar_zenith(traffic["reflectance"], lat, grid.earth_lon(cfg, device))
           if reflective(cfg) else None)
    frames, times, max_px, calm = [], [], 0.0, []
    for s in range(traffic["sequences"]):
        rng = np.random.default_rng([seed % (1 << 63), s])
        d_col, d_row, calm_s = motion_px(cfg, traffic["motion"], lat, rng, gen, device)
        d_col = torch.where(on_earth, d_col, torch.zeros_like(d_col))
        d_row = torch.where(on_earth, d_row, torch.zeros_like(d_row))
        max_px = max(max_px, float(torch.sqrt(d_col * d_col + d_row * d_row).max()))
        calm.append(calm_s)
        if mu0 is None:
            scene = brightness_temperature(traffic["clouds"], lat, gen, device)
        else:
            scene = reflectance_factor(traffic["clouds"], traffic["reflectance"], mu0, gen,
                                       device)
        loop, t = [], []
        for i in range(traffic["frames"]):
            if i:
                scene = advect(scene, d_col, d_row)
            loop.append(to_counts(scene, on_earth, cfg).cpu().numpy())
            t.append(T0 + s * LOOP_GAP_S + i * cfg["cadence_s"])
        frames.append(loop)
        times.append(t)
    pairs = [(s, i) for s in range(traffic["sequences"]) for i in range(traffic["frames"] - 1)]
    return Stream(frames, times, pairs, max_px, float(np.mean(calm)))
