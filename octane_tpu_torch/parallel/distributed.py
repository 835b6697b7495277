"""Multi-process execution (counterpart of octane_tpu.parallel.distributed).

A full disk that does not fit one card runs as several processes, one per
card (or several CPU workers), joined by ``torch.distributed``:
``initialize_multihost`` (-nprocs, -procid, -coordinator) forms the
group.  The mesh's ry * rx row bands are split over the processes in
consecutive runs (``distributed_mesh``): each process holds tensors for
its own bands only, on its device, and a ``halo.ProcessExchange`` moves
their ghost rows and joins their partial sums, so every process computes
what the single-process mesh path computes for those bands.  Each process
reads only its row block of every input (``host_row_block``: the union of
its bands' rows; the readers' ``row_range``), solves it
(``distributed_variational_flow``, through the process's banded program of
``parallel.sharded``: captured and replayed under NCCL, eager over gloo),
navigates and smooths it on its bands
(``parallel.post``) and writes its rows of every product variable to a
part file; process 0 then streams the parts into the product
(``io.writers.RowBlockSource``), so no process holds the whole field.
Temporal interpolation (``-interp``) runs the banded frame on the same
bands, and ``run_sequence_distributed`` chains pairs with row-block
checkpoints.

As in octane_tpu (distributed.py:253-255), the pipeline always runs the
variational solve: ``-sosm`` and ``-hybrid`` do not apply under -nprocs.
With one process (-nprocs 1) no group is formed and the same code runs on
a ``halo.LocalExchange``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.io import hdf5
from octane_tpu_torch.parallel.halo import LocalExchange, ProcessExchange, stub
from octane_tpu_torch.parallel.mesh import Mesh, band_rows, mesh_bands

ELSEWHERE = torch.device("meta")     # the device of a band another process holds


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """This process's device: cuda:(rank % visible cards) for a bare
    "cuda", else ``device`` as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = process_index() if rank is None else rank
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None, device="cuda") -> None:
    """Join the group of ``num_processes`` processes as rank ``process_id``
    (nothing to do for one process).

    ``coordinator`` is "host:port" (a tcp:// rendezvous) or an init URL
    (tcp://..., file://...).  ``backend`` "nccl" moves CUDA tensors, one
    process per card; "gloo" moves CPU tensors, a card's rows staged
    through pinned host memory; the default is nccl for a card, gloo for
    the CPU.  An NCCL failure raises: gloo never stands in for it.
    """
    if num_processes in (None, 1):
        return
    if coordinator is None:
        raise ValueError("-nprocs > 1 needs -coordinator host:port")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"-procid must be in [0, {num_processes}), got {process_id}")
    dev = process_device(device, process_id)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend moves CUDA tensors: use --device cuda")
        torch.cuda.set_device(dev)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)
    # every rank's communicator exists before the first batch of sends
    if backend == "nccl":
        dist.barrier(device_ids=[dev.index])
    else:
        dist.barrier()


def shutdown_multihost() -> None:
    """Leave the group; the exchanges and programs over its processes go
    with it, their graphs first: NCCL does not tear down a communicator
    while a CUDA graph that captured its work lives (the processes hang
    on exit)."""
    from octane_tpu_torch.flow.program import drop_programs
    from octane_tpu_torch.parallel.sharded import ProcessFlowProgram

    _exchanges.clear()
    drop_programs(ProcessFlowProgram)
    if dist.is_initialized():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dist.destroy_process_group()


def band_ranks(n: int, p: int):
    """The process of each of n bands over p processes, in consecutive runs."""
    return tuple(i * p // n for i in range(n))


def distributed_mesh(cfg: OFConfig, device="cuda") -> Mesh:
    """The ry * rx bands of ``cfg.mesh_shape`` over the processes, each
    process's bands on its device (``process_device``) and the others'
    marked ``ELSEWHERE``; the default (1, 1) mesh gives one band per
    process.  ry must be a multiple of the process count (whole mesh rows
    per process, octane_tpu's rule)."""
    p, rank = process_count(), process_index()
    ry, rx = cfg.mesh_shape
    if (ry, rx) == (1, 1):
        ry = p
    if ry % p:
        raise ValueError(f"mesh rows {ry} must be a multiple of process count {p}")
    dev = process_device(device)
    return Mesh((ry, rx), tuple(dev if r == rank else ELSEWHERE
                                for r in band_ranks(ry * rx, p)))


def own_device(mesh: Mesh) -> torch.device:
    return next(d for d in mesh.devices if d.type != "meta")


_exchanges: dict = {}


def distributed_exchange(mesh: Mesh):
    """The exchange of the mesh's bands: over the processes of the group
    (one per band layout and device while the group lives, so its programs
    find the piece shapes it gathered), or within the process when there is
    no group."""
    if not dist.is_initialized():
        return LocalExchange()
    key = (band_ranks(mesh.n, process_count()), own_device(mesh))
    if key not in _exchanges:
        _exchanges[key] = ProcessExchange(*key)
    return _exchanges[key]


def host_row_block(h: int, mesh: Mesh):
    """[r0, r1) of an h-row grid that this process owns: its bands' rows
    (``mesh.band_rows``, 8-row aligned, so not octane_tpu's ceil(h / p)
    where that is not a multiple of 8)."""
    own = [i for i, d in enumerate(mesh.devices) if d.type != "meta"]
    return band_rows(h, mesh.n, own[0])[0], band_rows(h, mesh.n, own[-1])[1]


def local_parts(block: torch.Tensor, row0: int, mesh: Mesh, h: int):
    """The banded field of an h-row grid whose rows [row0, row0 + n) this
    process holds in ``block`` (..., n, W): views of its bands' rows, stubs
    for the other bands."""
    return [(r0, stub(r1 - r0) if dev.type == "meta" else block[..., r0 - row0:r1 - row0, :])
            for dev, r0, r1 in mesh_bands(mesh, h)]


def local_rows(parts, like: torch.Tensor = None) -> torch.Tensor:
    """This process's rows of a banded field: its bands' parts joined (an
    empty block shaped as ``like`` when it holds none); octane_tpu's
    ``local_rows2d`` of its row band."""
    own = [t for _, t in parts if not t.is_meta]
    if not own:
        return like[..., :0, :]
    return torch.cat(own, dim=-2)


def _tensor(a, device, dtype=torch.float32) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def distributed_variational_flow(geo1_local, geo2_local, global_shape, cfg: OFConfig,
                                 mesh: Mesh = None, first_guess=None, exchange=None,
                                 device="cuda"):
    """The variational flow of an (H, W) = ``global_shape`` pair from this
    process's row block: ``geo1_local``/``geo2_local`` (C, n, W) or
    (n, W) rows [r0, r1) of ``host_row_block``, ``first_guess`` optionally
    (u0, v0) on those rows (tensors on the device stay there: the sequence's
    device-resident warm start).  Returns this process's rows of (u, v) on
    its device; every process must call it.  It goes through the
    process's banded program (``parallel.sharded.sharded_flow_program``
    with the exchange, as octane_tpu's goes through
    ``sharded_variational_flow``), whose route ``last_program_info`` says."""
    mesh = mesh or distributed_mesh(cfg, device)
    exchange = exchange or distributed_exchange(mesh)
    dev = own_device(mesh)
    h, w = global_shape
    r0, r1 = host_row_block(h, mesh)
    geo1, geo2 = _tensor(geo1_local, dev), _tensor(geo2_local, dev)
    if geo1.dim() == 2:
        geo1, geo2 = geo1[None], geo2[None]
    if first_guess is None:
        u0 = v0 = torch.zeros((r1 - r0, w), dtype=torch.float32, device=dev)
    else:
        u0, v0 = (_tensor(t, dev) for t in first_guess)
    from octane_tpu_torch.parallel.sharded import sharded_flow_program

    program = sharded_flow_program(cfg, (h, w), geo1.shape[0], mesh, exchange=exchange)
    return program(geo1.contiguous(), geo2.contiguous(), u0.contiguous(), v0.contiguous())


def _write_part(path: str, fields: dict, r0: int, r1: int) -> None:
    with hdf5.File(path, "w") as f:
        f.attrs["row0"] = r0
        f.attrs["row1"] = r1
        for name, arr in fields.items():
            f.create_dataset(name, data=arr)


def _part_files(directory: str, stem: str, h: int, mesh: Mesh):
    """[(path, r0, r1)] of every process's part file (the processes whose
    block is not empty), from the band layout every process knows."""
    p = process_count()
    ranks = band_ranks(mesh.n, p)
    out = []
    for r in range(p):
        own = [i for i, k in enumerate(ranks) if k == r]
        r0, r1 = band_rows(h, mesh.n, own[0])[0], band_rows(h, mesh.n, own[-1])[1]
        if r0 < r1:
            out.append((os.path.join(directory, f"{stem}{r}.h5"), r0, r1))
    return out


def _part_sources(parts, h: int, w: int, names_dtypes):
    from octane_tpu_torch.io.writers import RowBlockSource

    return {name: RowBlockSource(parts, name, (h, w), dt) for name, dt in names_dtypes}


def _host(t, dtype) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype)


def run_pipeline_distributed(file1: str, file2: str, cfg: OFConfig, outdir: str = "./",
                             cth_file=None, firstguess_file=None, channel2=None,
                             channel3=None, interp_dir: str = "./interpolation",
                             first_guess_flow=None, out_index=None, return_flow=False,
                             device="cuda", mesh: Mesh = None, exchange=None):
    """The pair pipeline under -nprocs; every process calls it with the same
    arguments (see the module docstring).  On all three grids, with CTH,
    first guess, channels 2/3, SRSAL, CTP and interpolated frames, as
    octane_tpu's (distributed.py:171-339).  ``outdir`` (and ``interp_dir``)
    must be shared by the processes: each writes its part file there, and
    process 0 the product.  Returns the files written (process 0's list;
    the others' is empty), and with ``return_flow`` this process's rows of
    the (smoothed) pixel flow, on its device."""
    from octane_tpu_torch.io.readers import read_cth, read_first_guess, read_scene
    from octane_tpu_torch.io.writers import RowBlockStack, write_product
    from octane_tpu_torch.nav.winds import uv2pix
    from octane_tpu_torch.parallel.post import pix2uv_bands, pix2uv_ms_bands, srsal_bands
    from octane_tpu_torch.pipeline import SUFFIX

    goes = cfg.grid == "goes"
    if not goes and (cth_file is not None or channel2 is not None or channel3 is not None):
        # the reference's flat-grid products have no CTP/Rad2/Rad3
        # (oct_filewrite.cc:353-704), as the single-process writer
        raise ValueError("CTH / extra channels are GOES-grid products")
    mesh = mesh or distributed_mesh(cfg, device)
    exchange = exchange or distributed_exchange(mesh)
    dev = own_device(mesh)
    rank = process_index()

    with hdf5.File(file1, "r") as f:
        h, w = f["Rad"].shape
        x_full = np.asarray(f["x"][()], np.int16)
        y_full = np.asarray(f["y"][()], np.int16)
    r0, r1 = host_row_block(h, mesh)
    rows = (r0, r1)

    scene1 = read_scene(file1, cfg, donav=True, device=dev, row_range=rows)
    scene2 = read_scene(file2, cfg, donav=False, device=dev, row_range=rows)
    nav = scene1.nav
    nav.g2x_offset = scene2.nav.x_offset if goes else nav.x_offset
    nav.g2y_offset = scene2.nav.y_offset if goes else nav.y_offset
    if cth_file is not None:
        cfg = cfg.replace(do_cth=True)
        read_cth(cth_file, scene1, cfg, row_range=rows)
    if firstguess_file is not None:
        cfg = cfg.replace(do_firstguess=True)
        read_first_guess(firstguess_file, scene1, row_range=rows)
    for channel, files in ((2, channel2), (3, channel3)):
        if files is not None:
            read_scene(files[0], cfg, donav=False, channel=channel, scene=scene1, device=dev,
                       row_range=rows)
            read_scene(files[1], cfg, donav=False, channel=channel, scene=scene2, device=dev,
                       row_range=rows)
    cfg = cfg.replace(nchannels=scene1.nchannels)
    dt = scene2.t - scene1.t

    # a sequence's warm start first, else the first-guess winds on the block
    # (elementwise, oct_optical_flow.cc:52)
    first_guess = first_guess_flow
    if first_guess is None and cfg.do_firstguess and scene1.ufg is not None:
        first_guess = uv2pix(scene1.ufg, scene1.vfg, scene1.lat, scene1.lon, scene1.x,
                             scene1.y, nav, dt, grid=cfg.grid)
    u, v = distributed_variational_flow(scene1.data, scene2.data, (h, w), cfg, mesh,
                                        first_guess, exchange)

    def bands(*planes):
        """This process's bands' (r0, rows of each plane)."""
        parts = local_parts(torch.stack(planes), r0, mesh, h)
        return [(b0, *t) for b0, t in parts if not t.is_meta]

    def block(outs, j):
        return torch.cat([o[j] for _, o in outs], dim=-2) if outs else None

    winds = pix2uv_bands(bands(u, v), nav, dt, grid=cfg.grid, pixuv=cfg.pixuv)
    ms = None
    if not goes and not cfg.pixuv:
        # flat-grid products keep full-precision winds (oct_filewrite.cc:401-402)
        ms = pix2uv_ms_bands(bands(u, v), nav, dt, grid=cfg.grid)
    us, vs = u, v
    if cfg.do_srsal and scene1.cth is not None:
        smoothed = srsal_bands(local_parts(torch.stack([u, v, scene1.cth.to(torch.float32)]),
                                           r0, mesh, h), mesh, exchange=exchange)
        uv = local_rows(smoothed, torch.stack([u, v]))
        us, vs = uv[0], uv[1]

    # the part files: this process's rows of every 2-D variable
    os.makedirs(outdir, exist_ok=True)
    parts_dir = os.path.join(outdir, ".parts")
    os.makedirs(parts_dir, exist_ok=True)
    names = ["Rad", "Rad2", "Rad3"]
    rad_dtype = np.int16 if goes else np.float32
    fields = {"Upix": _host(us, np.float32), "Vpix": _host(vs, np.float32)}
    if goes:
        for j, name in enumerate(("U", "V", "U_raw", "V_raw")):
            fields[name] = (_host(block(winds, j), np.int16) if winds
                            else np.zeros((0, w), np.int16))
    elif ms is not None:
        for j, name in enumerate(("U_ms", "V_ms")):
            fields[name] = (_host(block(ms, j), np.float64) if ms
                            else np.zeros((0, w), np.float64))
    for c in range(scene1.raw_counts.shape[0]):
        fields[names[c]] = _host(scene1.raw_counts[c], rad_dtype)
    if cfg.do_cth and scene1.cth is not None:
        # CTP (elementwise on the block; oct_optical_flow.cc:71-88)
        cthv = scene1.cth
        fields["CTP"] = _host(((cthv - 300.0) * 100.0 if cfg.ir else cthv).to(torch.int16),
                              np.int16)
    if r0 < r1:
        _write_part(os.path.join(parts_dir, f"part{rank}.h5"), fields, r0, r1)
    exchange.barrier()

    written = []
    if rank == 0:
        src = _part_sources(_part_files(parts_dir, "part", h, mesh), h, w,
                            [(k, a.dtype) for k, a in fields.items()])
        scene1.x, scene1.y, scene1.dt = x_full, y_full, float(dt)
        scene1.u_pix, scene1.v_pix = src["Upix"], src["Vpix"]
        if goes:
            scene1.u_wind, scene1.v_wind = src["U"], src["V"]
            scene1.u_raw, scene1.v_raw = src["U_raw"], src["V_raw"]
        elif "U_ms" in src:
            scene1.u_ms, scene1.v_ms = src["U_ms"], src["V_ms"]
        saved = scene1.raw_counts
        scene1.raw_counts = RowBlockStack([src[names[c]] for c in range(saved.shape[0])])
        if "CTP" in src:
            scene1.ctp = src["CTP"]
        stem = (f"outfile{SUFFIX[cfg.grid]}.nc" if out_index is None
                else f"outfile{SUFFIX[cfg.grid]}_{out_index:03d}.nc")
        written.append(write_product(os.path.join(outdir, stem), scene1, cfg))
        scene1.raw_counts = saved
    exchange.barrier()

    scene1.dt = float(dt)
    if cfg.do_interp:
        written += _interpolate_sequence_distributed(scene1, scene2, us, vs, (h, w), rows, cfg,
                                                     interp_dir, mesh, exchange)
    if return_flow:
        return written, (us, vs)
    return written


def _interpolate_sequence_distributed(scene1, scene2, u, v, hw, row_range, cfg: OFConfig,
                                      interp_dir: str, mesh: Mesh, exchange) -> list:
    """Interpolated frames under -nprocs: ``parallel.post.interpolate_bands``
    on this process's bands, each process requantizing and writing its rows
    to a part file, process 0 merging them (the frame loop of
    ``pipeline.interpolate_sequence``, main.cc:450-480).  ``max_disp``
    comes from the largest |u|, |v| of every band."""
    from octane_tpu_torch.io.native import requantize
    from octane_tpu_torch.io.writers import RowBlockSource, RowBlockStack, write_product
    from octane_tpu_torch.parallel.post import interpolate_bands
    from octane_tpu_torch.pipeline import SUFFIX

    h, w = hw
    r0, r1 = row_range
    rank = process_index()
    os.makedirs(interp_dir, exist_ok=True)
    parts_dir = os.path.join(interp_dir, ".parts")
    os.makedirs(parts_dir, exist_ok=True)
    field = local_parts(torch.cat([u[None], v[None], scene1.data, scene2.data]), r0, mesh, h)
    peaks = [None if t.is_meta else torch.maximum(t[0].abs().amax(), t[1].abs().amax())
             for _, t in field]
    max_disp = max(8, int(-(-max(exchange.band_values(peaks).tolist()) // 8) * 8))
    nchan = scene1.data.shape[0]
    names = ["Rad", "Rad2", "Rad3"]
    rad_dtype = np.int16 if cfg.grid == "goes" else np.float32

    written = []
    step = cfg.deltat / scene1.dt
    frt = step
    idx = 1
    while frt < 1.0 and (1.0 - frt) >= step / 2.0:
        outs = interpolate_bands(field, mesh, frt, max_disp, exchange)
        if outs:
            img = torch.cat([o[0] for _, o in outs], dim=-2).cpu().numpy()
            fields = {"Occlusion": _host(torch.cat([o[1] for _, o in outs]), np.int16)}
            for c in range(nchan):
                vmin, vmax = scene1.norm_ranges[c]
                fields[names[c]] = requantize(img[c], vmin, vmax, scene1.nav.rad_scale[c],
                                              scene1.nav.rad_offset[c]).astype(rad_dtype)
            _write_part(os.path.join(parts_dir, f"f{idx}_part{rank}.h5"), fields, r0, r1)
        exchange.barrier()
        if rank == 0:
            parts = _part_files(parts_dir, f"f{idx}_part", h, mesh)
            saved = scene1.raw_counts
            scene1.occlusion = RowBlockSource(parts, "Occlusion", (h, w), np.int16)
            scene1.raw_counts = RowBlockStack([RowBlockSource(parts, names[c], (h, w), rad_dtype)
                                               for c in range(nchan)])
            scene1.frdt = float(frt)
            scene1.t_interp = scene1.t + scene1.dt * frt
            path = os.path.join(interp_dir, f"outfile_interp{SUFFIX[cfg.grid]}{idx}.nc")
            written.append(write_product(path, scene1, cfg, interp=True))
            scene1.raw_counts = saved
        exchange.barrier()
        idx += 1
        frt += step
    return written


# ---------------------------------------------------------------------------
# sequences across processes
# ---------------------------------------------------------------------------

def _seq_ckpt_path(checkpoint: str) -> str:
    return f"{checkpoint}.p{process_index()}.h5"


def _save_seq_checkpoint(checkpoint: str, index: int, u_blk, v_blk, r0: int, r1: int,
                         key: str, files_done) -> None:
    """This process's rows of the warm-start flow, written to a temporary
    file and moved over the checkpoint (a kill mid-save keeps the previous
    one)."""
    path = _seq_ckpt_path(checkpoint)
    tmp = path + ".tmp"
    with hdf5.File(tmp, "w") as f:
        f.create_dataset("pair_index", data=np.int64(index))
        f.create_dataset("u_pix", data=_host(u_blk, np.float32))
        f.create_dataset("v_pix", data=_host(v_blk, np.float32))
        f.attrs["row0"] = r0
        f.attrs["row1"] = r1
        f.attrs["nprocs"] = process_count()
        f.attrs["cfg_key"] = key
        f.attrs["files_done"] = "\n".join(files_done)
    os.replace(tmp, path)


def _load_seq_checkpoint(checkpoint: str, key: str, files, r0: int, r1: int):
    """(pair index, u rows, v rows) of this process's checkpoint, or None;
    refuses one of other settings, another process layout or a reordered
    frame list (octane_tpu's distributed.py:453-479)."""
    path = _seq_ckpt_path(checkpoint)
    if not os.path.exists(path):
        return None
    with hdf5.File(path, "r") as f:
        def _s(a):
            return a.decode() if isinstance(a, bytes) else str(a)

        if _s(f.attrs.get("cfg_key", "")) != key:
            raise ValueError(
                "checkpoint was written by a run with different solver settings; delete it "
                f"(or rerun with the original settings) to resume: {path}")
        if (int(f.attrs.get("nprocs", -1)) != process_count()
                or (int(f.attrs["row0"]), int(f.attrs["row1"])) != (r0, r1)):
            raise ValueError("checkpoint was written by a run with a different process "
                             f"layout; resume with the same -nprocs: {path}")
        done = _s(f.attrs.get("files_done", "")).split("\n")
        if done != list(files[:len(done)]):
            raise ValueError("checkpoint was written against a different frame list "
                             f"(appending new frames is fine; reordering is not): {path}")
        return (int(f["pair_index"][()]), np.asarray(f["u_pix"][()]),
                np.asarray(f["v_pix"][()]))


def run_sequence_distributed(files, cfg: OFConfig, outdir: str = "./",
                             checkpoint: Optional[str] = None, warm_start: bool = True,
                             interp_dir: str = "./interpolation", device="cuda") -> list:
    """``sequence.run_sequence`` under -nprocs (octane_tpu's
    distributed.py:482-540): consecutive pairs through
    ``run_pipeline_distributed``, each warm-started from the previous pair's
    flow rows, which stay on the device; with ``checkpoint``, each process
    saves its rows after every pair (``{checkpoint}.p{rank}.h5``) and a
    rerun resumes from the first pair not done.  Products are named as the
    single-process sequence's (outfile{suffix}_NNN.nc; frames in
    pair_NNN/)."""
    from octane_tpu_torch.sequence import cfg_key

    if len(files) < 2:
        raise ValueError("a sequence needs at least two frames")
    with hdf5.File(files[0], "r") as f:
        h, w = f["Rad"].shape
    mesh = distributed_mesh(cfg, device)
    exchange = distributed_exchange(mesh)
    r0, r1 = host_row_block(h, mesh)
    key = cfg_key(cfg)

    start, fg = 0, None
    if checkpoint:
        state = _load_seq_checkpoint(checkpoint, key, files, r0, r1)
        if state is not None:
            idx, u_blk, v_blk = state
            start = idx + 1
            if warm_start:
                fg = (u_blk, v_blk)

    written = []
    for i in range(start, len(files) - 1):
        out, (us, vs) = run_pipeline_distributed(
            files[i], files[i + 1], cfg, outdir=outdir,
            interp_dir=os.path.join(interp_dir, f"pair_{i:03d}"), first_guess_flow=fg,
            out_index=i, return_flow=True, device=device, mesh=mesh, exchange=exchange)
        written += out
        fg = (us, vs) if warm_start else None
        if checkpoint:
            _save_seq_checkpoint(checkpoint, i, us, vs, r0, r1, key, files[:i + 2])
    return written
