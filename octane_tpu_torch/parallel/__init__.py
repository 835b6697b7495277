"""The row-banded mesh path (counterpart of octane_tpu.parallel).

One process drives n = ry * rx row bands of the image, each on a device of
the mesh (``mesh.make_mesh``; several bands may share one card).  A band's
work is the single-device work on its rows: the band forms of the warp,
SOR pass, PCG pass A and bilateral kernels take the global row of the
band's first row, the true height and ghost rows, which ``halo`` exchanges
between the bands.  ``sharded.sharded_variational_flow`` runs the
coarse-to-fine solve with either relaxer (``sor``, ``cg``), and ``post``
navigates, smooths and interpolates frames on the bands.  ``distributed``
runs the same bands in several processes (``-nprocs``), each holding its
own bands, over ``halo.ProcessExchange``.
"""

from octane_tpu_torch.parallel.halo import LocalExchange, ProcessExchange
from octane_tpu_torch.parallel.mesh import Mesh, band_rows, make_mesh
from octane_tpu_torch.parallel.post import (sharded_interpolate_frame, sharded_pix2uv,
                                            sharded_pix2uv_ms, sharded_srsal)
from octane_tpu_torch.parallel.sharded import make_sharded_warp, sharded_variational_flow

__all__ = [
    "Mesh", "make_mesh", "band_rows", "LocalExchange", "ProcessExchange",
    "make_sharded_warp", "sharded_variational_flow", "sharded_pix2uv", "sharded_pix2uv_ms",
    "sharded_srsal", "sharded_interpolate_frame",
]
