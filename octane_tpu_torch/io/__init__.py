"""Data model and file IO (counterpart of octane_tpu.io).  Files are read
and written through the port's own HDF5 / netCDF-4 codec, ``io.hdf5``."""

from octane_tpu_torch.io.datamodel import NavConstants, Scene, scene_from_numpy
from octane_tpu_torch.io.readers import (channel_onto_scene, read_cth, read_first_guess,
                                         read_scene, scene_from_flat_arrays,
                                         scene_from_goes_arrays)
from octane_tpu_torch.io.writers import write_product

__all__ = ["NavConstants", "Scene", "scene_from_numpy", "read_scene", "read_cth",
           "read_first_guess", "channel_onto_scene",
           "scene_from_flat_arrays", "scene_from_goes_arrays", "write_product"]
