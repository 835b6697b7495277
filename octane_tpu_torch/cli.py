"""Command-line interface with the flags of octane_tpu.cli (src/main.cc:42-350),
plus ``--device`` (default ``cuda``).

Usage example:
    python -m octane_tpu_torch.cli -i1 img1.nc -i2 img2.nc -o ./out/

Every flag of the single-device pipeline is honoured: -Polar and -Merc,
channels 2 and 3 (-ic21/-ic22, -ic31/-ic32), -sosm, -hybrid and -interp
with -interploc included.  ``-mesh RxC`` runs the flow, pix2uv and SRSAL
on R*C row bands (octane_tpu_torch.parallel), band i on cuda:i, or all on
the CPU with ``--device cpu``; with fewer cards than bands it warns and
runs on one device, as octane_tpu does.  The multi-process flags
(-nprocs, -procid, -coordinator) are accepted and -nprocs raises
NotImplementedError.  The CLI has no
sequence mode, as octane_tpu's has none: ``sequence.run_sequence`` is the
API.
"""

from __future__ import annotations

import argparse
import sys

from octane_tpu_torch.config import OFConfig
from octane_tpu_torch.pipeline import run_pipeline


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="octane_tpu_torch",
        description=("OCTANE on PyTorch/CUDA: optical flow / atmospheric "
                     "motion vectors for GOES-R imagery"),
    )
    p.add_argument("-i1", required=True, help="first GOES-R netCDF file")
    p.add_argument("-i2", required=True, help="second GOES-R netCDF file")
    p.add_argument("-i1cth", default=None, help="cloud-top-height netCDF for image 1")
    p.add_argument("-i2cth", default=None, help="(accepted for compatibility)")
    p.add_argument("-o", dest="outdir", default="./", help="output directory")
    p.add_argument("-pd", action="store_true", help="output raw pixel displacements")
    p.add_argument("-srsal", action="store_true", help="bilateral-smooth the flow")
    p.add_argument("-Polar", action="store_true", help="polar orthonormal grid input")
    p.add_argument("-Merc", action="store_true", help="mercator grid input")
    p.add_argument("-ir", action="store_true", help="CTP stores IR temperatures")
    p.add_argument("-ahi", action="store_true",
                   help="deprecated (Himawari AHI); clears CTH ingest like the "
                        "reference (main.cc:200, 388-391)")
    p.add_argument("-sosm", action="store_true", help="patch-match tracking")
    p.add_argument("-hybrid", action="store_true",
                   help="patch-match initialization + variational refinement")
    p.add_argument("-rad", type=int, default=2, help="patch radius for -sosm")
    p.add_argument("-srad", type=int, default=2, help="search radius for -sosm")
    p.add_argument("-interp", action="store_true", help="temporal interpolation")
    p.add_argument("-interploc", default="./interpolation")
    p.add_argument("-deltat", type=float, default=60.0, help="interp frame period (s)")
    p.add_argument("-nncth", action="store_true", help="nearest-neighbour CTH regrid")
    p.add_argument("-ic21", default=None)
    p.add_argument("-ic22", default=None)
    p.add_argument("-ic31", default=None)
    p.add_argument("-ic32", default=None)
    p.add_argument("-alpha", type=float, default=5.0)
    p.add_argument("-lambda", dest="lambda_", type=float, default=1.0)
    p.add_argument("-lambdac", type=float, default=0.0)
    p.add_argument("-kiters", type=int, default=4)
    p.add_argument("-liters", type=int, default=3)
    p.add_argument("-cgiters", type=int, default=30,
                   help="max CG iterations / SOR sweeps")
    p.add_argument("-solver", default="pcg", choices=("pcg", "sor"),
                   help="pcg: reference-exact Jacobi-PCG (default); sor: "
                        "red-black SOR")
    p.add_argument("-omega", type=float, default=1.9,
                   help="SOR over-relaxation factor")
    p.add_argument("-brox", action="store_true", help="disable Zimmer normalization")
    p.add_argument("-firstguess", default=None)
    p.add_argument("-no_outnav", action="store_true")
    p.add_argument("-no_outraw", action="store_true")
    p.add_argument("-no_outrad", action="store_true")
    p.add_argument("-no_outctp", action="store_true")
    p.add_argument("-normmax", type=float, default=None)
    p.add_argument("-normmin", type=float, default=None)
    p.add_argument("-normmax2", type=float, default=None)
    p.add_argument("-normmin2", type=float, default=None)
    p.add_argument("-normmax3", type=float, default=None)
    p.add_argument("-normmin3", type=float, default=None)
    p.add_argument("-mesh", default=None,
                   help="device mesh ROWSxCOLS: ROWS*COLS row bands, e.g. 2x4")
    p.add_argument("-coordinator", default=None,
                   help="multi-host coordinator address host:port (not ported yet)")
    p.add_argument("-nprocs", type=int, default=None,
                   help="multi-host process count (not ported yet)")
    p.add_argument("-procid", type=int, default=None,
                   help="this process's id in [0, nprocs) (not ported yet)")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on (default: cuda)")
    return p


def args_to_config(a: argparse.Namespace) -> OFConfig:
    grid = "polar" if a.Polar else ("mercator" if a.Merc else "goes")
    mesh_shape = (1, 1)
    if a.mesh:
        ry, rx = a.mesh.lower().split("x")
        mesh_shape = (int(ry), int(rx))
    return OFConfig(
        algorithm=("hybrid" if a.hybrid
                   else "patch_match" if a.sosm else "variational"),
        dozim=not a.brox,
        alpha=a.alpha, lambda_=a.lambda_, lambdac=a.lambdac,
        kiters=a.kiters, liters=a.liters, cgiters=a.cgiters,
        rad=a.rad, srad=a.srad,
        grid=grid, ir=a.ir, pixuv=a.pd,
        # -ahi clears doCTH in the reference (main.cc:388-391)
        do_cth=a.i1cth is not None and not a.ahi,
        do_firstguess=a.firstguess is not None,
        do_srsal=a.srsal, do_interp=a.interp,
        interp_cth_bicubic=not a.nncth,
        deltat=a.deltat,
        norm_min=a.normmin, norm_max=a.normmax,
        norm_min2=a.normmin2, norm_max2=a.normmax2,
        norm_min3=a.normmin3, norm_max3=a.normmax3,
        out_nav=not a.no_outnav, out_raw=not a.no_outraw,
        out_rad=not a.no_outrad, out_ctp=not a.no_outctp,
        solver=a.solver, sor_omega=a.omega, mesh_shape=mesh_shape,
    )


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    cfg = args_to_config(a)
    if a.nprocs:
        raise NotImplementedError("multi-host runs (-nprocs) are not ported yet")
    ch2 = (a.ic21, a.ic22) if a.ic21 and a.ic22 else None
    ch3 = (a.ic31, a.ic32) if a.ic31 and a.ic32 else None
    written = run_pipeline(
        a.i1, a.i2, cfg, outdir=a.outdir,
        cth_file=a.i1cth, firstguess_file=a.firstguess,
        channel2=ch2, channel3=ch3, interp_dir=a.interploc, device=a.device,
    )
    for w in written:
        print(f"{w} written")
    return 0


if __name__ == "__main__":
    sys.exit(main())
