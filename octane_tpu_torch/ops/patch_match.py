"""Patch-match's zero-guess search: CUDA kernel and plain version.

``patch_match_search(g1p, g2p, rad, srad, h, w, row0)`` is the zero-guess
search of rows [row0, row0 + hl) of an (h, w) image pair and its
sub-pixel fit: (u, v), each (hl, w) float32.  ``g1p`` holds those rows of
the first image padded by ``rad`` rows and columns, ``g2p`` those of the
second padded by ``rad + srad + 1``, both with the image's edge values
beyond its edges (the whole image: row0 = 0, hl = h; a band of a mesh:
its rows).

On a CUDA tensor it launches ``csrc/patch_match.cu``, one launch a
search (or a band), at any radius; octane_tpu has no Pallas kernel here
(its patch-match is plain XLA).  On a CPU tensor it runs
``patch_match_search_plain``, which is
``flow.patch_match._patch_match_local``, whose bits the kernel repeats.
``patch_match_search.launches`` / ``.plain_calls`` count them.
"""

from __future__ import annotations

import torch

from octane_tpu_torch.ops.build import check_status, load_kernels


def patch_match_search_plain(g1p, g2p, rad: int, srad: int, h: int, w: int, row0: int = 0):
    """The plain version, ``flow.patch_match._patch_match_local`` (imported on
    call: flow.patch_match imports this package)."""
    from octane_tpu_torch.flow.patch_match import _patch_match_local

    return _patch_match_local(g1p, g2p, rad, srad, h, w, row0)


def _check(g1p, g2p, rad, srad, h, w, row0):
    for name, t in (("g1p", g1p), ("g2p", g2p)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.dim() != 2:
            raise ValueError(f"patch_match_search: {name} must be a contiguous 2-D float32 "
                             f"tensor, got {t.dtype} of shape {tuple(t.shape)}"
                             f"{'' if t.is_contiguous() else ', not contiguous'}")
    if g1p.device != g2p.device:
        raise ValueError(f"patch_match_search: g1p on {g1p.device}, g2p on {g2p.device}")
    if rad < 0 or srad < 0:
        raise ValueError(f"patch_match_search: radii rad {rad}, srad {srad} are negative")
    smax = rad + srad + 1
    hl, wl = g1p.shape[0] - 2 * rad, g1p.shape[1] - 2 * rad
    if not (hl >= 1 and wl == w >= 1 and 0 <= row0 and row0 + hl <= h
            and tuple(g2p.shape) == (hl + 2 * smax, w + 2 * smax)):
        raise ValueError(f"patch_match_search: g1p {tuple(g1p.shape)} and g2p "
                         f"{tuple(g2p.shape)} are not rows [{row0}, {row0} + rows) of a "
                         f"({h}, {w}) image padded by {rad} and {smax}")
    return hl, wl


def patch_match_search(g1p: torch.Tensor, g2p: torch.Tensor, rad: int, srad: int, h: int,
                       w: int, row0: int = 0):
    """(u, v) of the block's rows; see the module docstring."""
    hl, wl = _check(g1p, g2p, rad, srad, h, w, row0)
    if g1p.device.type == "cpu":
        patch_match_search.plain_calls += 1
        return patch_match_search_plain(g1p, g2p, rad, srad, h, w, row0)
    if g1p.device.type != "cuda":
        raise ValueError(f"patch_match_search: unsupported device {g1p.device}")
    u = torch.empty((hl, wl), dtype=torch.float32, device=g1p.device)
    v = torch.empty_like(u)
    lib = load_kernels()
    with torch.cuda.device(g1p.device):
        status = lib.octane_patch_match(
            g1p.data_ptr(), g2p.data_ptr(), u.data_ptr(), v.data_ptr(), hl, wl, rad, srad,
            torch.cuda.current_stream(g1p.device).cuda_stream)
    check_status(status, "octane_patch_match")
    patch_match_search.launches += 1
    return u, v


patch_match_search.launches = 0
patch_match_search.plain_calls = 0


__all__ = ["patch_match_search", "patch_match_search_plain"]
