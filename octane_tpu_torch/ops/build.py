"""Build the CUDA kernels of ``octane_tpu_torch/csrc`` and load them.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain
C interface, on first use, into ``octane_tpu_torch/_build/`` (git-ignored;
the file name carries a hash of the sources and flags, so an edit
rebuilds).  The library is loaded with ctypes: pointers and the stream are
passed as ``c_void_p``, every entry point returns ``cudaGetLastError()``.

A missing ``nvcc`` or a failed build raises ``RuntimeError``; there is no
fallback to the plain PyTorch versions for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from octane_tpu_torch.utils import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# -fmad=false: no multiply-add contraction anywhere, so the kernels round
# exactly like PyTorch's separate elementwise kernels
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
L = ctypes.c_longlong
_SIGNATURES = {
    "octane_warp": (I, [P] * 7 + [I] * 4 + [P]),
    "octane_warp_band": (I, [P] * 6 + [I] * 8 + [P]),
    "octane_pcg_pass_a": (I, [P] * 9 + [I] * 3 + [P]),
    "octane_pcg_pass_a_band": (I, [P] * 12 + [I] * 5 + [P]),
    "octane_pcg_pass_b": (I, [P] * 6 + [I] * 2 + [P]),
    "octane_assemble_cf": (I, [P] * 10 + [I] * 5 + [F] * 5 + [P]),
    "octane_assemble_pcg": (I, [P] * 11 + [I] * 7 + [F] * 5 + [P]),
    "octane_sor_pass": (I, [P] * 4 + [I] * 6 + [F, P]),
    "octane_sor_pass_band": (I, [P] * 4 + [I] * 6 + [L] + [I] * 4 + [F, P]),
    "octane_bilateral": (I, [P] * 5 + [I] * 3 + [F, P]),
    "octane_bilateral_band": (I, [P] * 5 + [I] * 7 + [F, P]),
    "octane_pyramid_level": (I, [P] * 4 + [I] * 6 + [P] + [I] * 2 + [P]),
    "octane_patch_match": (I, [P] * 4 + [I] * 4 + [P]),
    "octane_if_begin": (I, [P] * 3),
    "octane_if_end": (I, [P]),
    "octane_stamp": (I, [P, I, P]),
    "octane_error_string": (ctypes.c_char_p, [I]),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of octane_tpu_torch "
                       "cannot be built on this machine")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def build_kernels():
    """Compile csrc/*.cu (once per content hash); returns the library path
    and a report of the build ({} when the library was already built)."""
    nvcc = _nvcc()
    srcs = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    lib_path = os.path.join(BUILD_DIR, f"liboctane_kernels_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path, {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    cus = [src for src in srcs if src.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in cus]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src] for obj, src in zip(objs, cus)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [proc.communicate() for proc in procs]
    results = [(cmd, proc.returncode, *out) for cmd, proc, out in zip(cmds, procs, outs)]
    if all(code == 0 for _, code, *_ in results):
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        results.append((link, proc.returncode, proc.stdout, proc.stderr))
    for cmd, code, out, err in results:
        if code != 0:
            raise RuntimeError(f"nvcc failed (exit {code}):\n{' '.join(cmd)}\n{out}{err}")
    os.replace(tmp, lib_path)
    for obj in objs:
        os.remove(obj)
    return lib_path, {"cmd": "\n".join(" ".join(cmd) for cmd, *_ in results),
                      "seconds": time.perf_counter() - t0,
                      "ptxas": "".join(err for *_, err in results)}


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use (the tracer's span
    ``octane.kernels.load``); ``.build_info`` holds the nvcc command, its
    seconds and the ptxas report."""
    global _lib
    with _lock:
        if _lib is None:
            with profiling.span("octane.kernels.load"):
                path, info = build_kernels()
                lib = ctypes.CDLL(path)
                for name, (res, args) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype = res
                    fn.argtypes = args
                lib.build_info = info
                _lib = lib
    return _lib


def check_status(status: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if status != 0:
        msg = _lib.octane_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
