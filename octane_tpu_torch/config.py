"""Typed configuration of the port (counterpart of octane_tpu.config).

The same options, names and defaults as octane_tpu's ``OFConfig``
(include/offlags.h:4-72, src/main.cc:53-108), so a configuration means the
same thing in both packages and the product file echoes the same settings.
``mesh_shape`` and ``halo_warp`` are the JAX package's: a (rows, cols)
mesh of more than one device runs the row-banded mesh path
(octane_tpu_torch.parallel; rows x cols bands), and ``halo_warp`` is the
rows of a band's warp slab beyond its own.  The Pallas switch has no
counterpart: the kernels run wherever the tensors are on a CUDA device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class OFConfig:
    """Optical-flow engine options.

    Reference: include/offlags.h (fields) and src/main.cc:53-108 (defaults).
    """

    # --- algorithm selection -------------------------------------------------
    algorithm: str = "variational"      # "variational" | "patch_match" | "hybrid"
    dozim: bool = True                  # Zimmer data-term normalization (-brox turns off)
    # --- variational solver weights (main.cc:77-88) --------------------------
    alpha: float = 5.0                  # smoothness weight
    lambda_: float = 1.0                # gradient-constancy weight
    lambdac: float = 0.0                # first-guess hinting weight
    scale_factor: float = 0.5           # pyramid scale factor (scaleF)
    kiters: int = 4                     # pyramid levels
    liters: int = 3                     # inner (relinearization) iterations
    cgiters: int = 30                   # max CG iterations
    cg_tol: float = 1e-4 ** 2           # CG stop: ||r||^2 <= tol (oct_variational_optical_flow.cu:1353)
    gnc_steps: int = 3                  # graduated non-convexity steps (reference :604)
    # deprecated knobs no solver reads; echoed on optical_flow_settings
    # (oct_filewrite.cc:243, 247)
    filtsigma: float = 3.0
    miters: int = 5
    # --- patch match (main.cc:75-76) ----------------------------------------
    rad: int = 2                        # target patch radius
    srad: int = 2                       # search radius
    # --- channels ------------------------------------------------------------
    nchannels: int = 1                  # 1 + doc2 + doc3
    # --- grid / product selection -------------------------------------------
    grid: str = "goes"                  # "goes" | "polar" | "mercator"
    ir: bool = False                    # CTP stored as (T-300)*100 when True
    pixuv: bool = False                 # output raw pixel displacements only (-pd)
    do_cth: bool = False                # cloud-top-height ingest enabled
    do_firstguess: bool = False
    do_srsal: bool = False              # bilateral smoothing of the flow
    do_interp: bool = False             # temporal interpolation
    interp_cth_bicubic: bool = True     # -nncth switches CTH regrid to nearest neighbour
    deltat: float = 60.0                # interpolation frame period (seconds)
    # --- normalization overrides (-normmin/max[2|3]) -------------------------
    norm_min: Optional[float] = None
    norm_max: Optional[float] = None
    norm_min2: Optional[float] = None
    norm_max2: Optional[float] = None
    norm_min3: Optional[float] = None
    norm_max3: Optional[float] = None
    # --- output toggles (main.cc:98-101) -------------------------------------
    out_nav: bool = True
    out_raw: bool = True
    out_rad: bool = True
    out_ctp: bool = True
    # --- solver --------------------------------------------------------------
    solver: str = "pcg"                 # "pcg" (reference-exact) | "sor"
    sor_omega: float = 1.9              # SOR over-relaxation factor
    # --- device mesh (parallel/) ---------------------------------------------
    mesh_shape: Tuple[int, int] = (1, 1)  # (rows, cols); ry * rx > 1 runs the mesh path
    halo_warp: int = 16                 # warp slab rows beyond a band (reach halo_warp - 2)

    def __post_init__(self):
        if self.algorithm not in ("variational", "patch_match", "hybrid"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.grid not in ("goes", "polar", "mercator"):
            raise ValueError(f"unknown grid {self.grid!r}")
        if self.solver not in ("pcg", "sor"):
            raise ValueError(f"unknown solver {self.solver!r}")
        if not (0.0 < self.sor_omega < 2.0):
            raise ValueError("sor_omega must be in (0, 2)")
        if not (0.0 < self.scale_factor < 1.0):
            raise ValueError("scale_factor must be in (0, 1)")
        for name in ("kiters", "liters", "cgiters", "gnc_steps", "rad", "srad",
                     "nchannels"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        if len(self.mesh_shape) != 2 or min(self.mesh_shape) < 1:
            raise ValueError(f"mesh_shape must be two counts >= 1, got {self.mesh_shape}")
        if self.halo_warp < 4:
            raise ValueError("halo_warp must be >= 4")
        if self.nchannels > 3:
            raise ValueError("at most 3 channels are supported (doc2/doc3)")

    # The reference writes an integer algorithm code into the product file
    # (main.cc:362-379, key at oct_filewrite.cc:231).
    @property
    def oftype(self) -> int:
        if self.algorithm == "patch_match":
            return 4
        return 1 if self.dozim else 3   # hybrid products record the refiner

    @property
    def lambda_over_alpha(self) -> float:
        return self.lambda_ / self.alpha

    def replace(self, **kw) -> "OFConfig":
        return dataclasses.replace(self, **kw)
