"""Time block geometries of the SRSAL bilateral kernel (csrc/bilateral.cu)
at 5424^2 on the card.

    python3 tools/bilateral_geometry.py [--geometries 6x8,8x8,...] [--sass]

A geometry R x BY is R rows per thread and BY rows of 32 threads in the
p = 18 instantiation.  Each is compiled from csrc/bilateral.cu alone, with
-DOCTANE_BILATERAL_R and -DOCTANE_BILATERAL_BY and the package's nvcc flags,
into a library of its own (one nvcc per geometry, all started together);
the package's own build is not touched.  Prints ptxas's registers and
spills of each, with ``--sass`` also the count of each SASS opcode of each
kernel (cuobjdump), then the ms of one launch of each (mean of 10 after a
warm-up, CUDA events) and of the package's kernel, on u, v ~ N(0, 2) and the
2-km-step CTH of ``tests/torch_fixtures.py`` cth_steps.  Every geometry must
give the package kernel's output bit for bit, since each pixel sums its
taps in one order whatever the geometry: exits 1 if one does not.
"""

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import cuda_ms, load_tests_module  # noqa: E402
from octane_tpu_torch.core.gaussian import gaussian_kernel_1d  # noqa: E402
from octane_tpu_torch.ops import bilateral as ob  # noqa: E402
from octane_tpu_torch.ops.build import _SIGNATURES, CSRC, NVCC_FLAGS, _nvcc  # noqa: E402

SIGPIX2 = -1.0 / (2.0 * 20.0 * 20.0)
GEOMETRIES = "6x8,8x8,8x4,4x8,6x4,12x4"


def build(geometries, tmp):
    """{(R, BY): path of its library}, ptxas's lines printed."""
    src = os.path.join(CSRC, "bilateral.cu")
    libs = {g: os.path.join(tmp, f"bilateral_{g[0]}x{g[1]}.so") for g in geometries}
    procs = {g: subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-shared", f"-DOCTANE_BILATERAL_R={g[0]}",
                                  f"-DOCTANE_BILATERAL_BY={g[1]}", "-o", lib, src],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for g, lib in libs.items()}
    for g, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {g[0]}x{g[1]}:\n{err}")
        for line in err.splitlines():
            if any(key in line for key in ("Compiling entry", "registers", "spill")):
                print(f"{g[0]}x{g[1]}: {line.replace('ptxas info    : ', '').strip()}",
                      flush=True)
    return libs


def sass_counts(lib):
    """{kernel: Counter of its SASS opcodes}."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = collections.defaultdict(collections.Counter), None
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and fn:
            counts[fn][m.group(1)] += 1
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--geometries", default=GEOMETRIES)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bilateral_geometry: no CUDA device is available")
    geometries = [tuple(int(x) for x in g.split("x")) for g in args.geometries.split(",")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)

    dev = torch.device("cuda", 0)
    h = w = 5424
    rng = np.random.default_rng(8)
    u, v = (torch.from_numpy(rng.normal(0, 2, (h, w)).astype(np.float32)).to(dev)
            for _ in range(2))
    c = torch.from_numpy(load_tests_module("torch_fixtures").cth_steps(h, w)).to(dev)
    gk = np.ascontiguousarray(gaussian_kernel_1d(9.0, 18), np.float32)
    want = ob.bilateral(u, v, c, gk, SIGPIX2)
    print(f"package kernel: {cuda_ms(lambda: ob.bilateral(u, v, c, gk, SIGPIX2)):.3f} ms",
          flush=True)

    same = True
    with tempfile.TemporaryDirectory() as tmp:
        for (rows, by), path in build(geometries, tmp).items():
            if args.sass:
                for fn, n in sass_counts(path).items():
                    print(f"{rows}x{by}: {fn}: {sum(n.values())} instructions, "
                          f"{dict(n.most_common(12))}", flush=True)
            fn = ctypes.CDLL(path).octane_bilateral
            fn.restype, fn.argtypes = _SIGNATURES["octane_bilateral"]
            out = torch.empty_like(want)

            def launch():
                status = fn(u.data_ptr(), v.data_ptr(), c.data_ptr(), out.data_ptr(),
                            gk.ctypes.data, h, w, 18, SIGPIX2,
                            torch.cuda.current_stream(dev).cuda_stream)
                if status:
                    sys.exit(f"{rows}x{by}: CUDA error {status}")

            t = cuda_ms(launch)
            equal = torch.equal(out, want)
            same &= equal
            print(f"{rows}x{by}: {t:.3f} ms, {'equal to' if equal else 'DIFFERS from'} "
                  f"the package kernel", flush=True)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True)
    print(f"SM clock after timing, max: {clocks.stdout.strip()}", flush=True)
    if not same:
        sys.exit(1)


if __name__ == "__main__":
    main()
