"""Import hygiene and the no-fallback rule of octane_tpu_torch.

* importing the port (every module, and the CLI) loads no jax and nothing
  of octane_tpu; chip_smoke.py, the profile tool, the NCCL probe and the
  test modules chip_smoke.py loads name neither anywhere in their imports;
* the port reads and writes its files with its own HDF5 codec: no module
  of it names h5py, and neither chip_smoke.py nor the test modules it
  loads import it;
* ``ops.build.load_kernels`` raises where nvcc is missing instead of
  handing back the plain path;
* chip_smoke.py exits non-zero and prints no result without a CUDA device.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

from octane_tpu_torch.ops import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, cwd=ROOT):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_without_jax():
    code = (
        "import pkgutil, sys, importlib\n"
        "import octane_tpu_torch, octane_tpu_torch.cli\n"
        "names = [m.name for m in pkgutil.walk_packages(octane_tpu_torch.__path__,\n"
        "                                                 'octane_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'octane_tpu_torch.post.srsal', 'octane_tpu_torch.ops.bilateral',\n"
        "        'octane_tpu_torch.flow.patch_match', 'octane_tpu_torch.post.temporal',\n"
        "        'octane_tpu_torch.nav.polar', 'octane_tpu_torch.nav.mercator',\n"
        "        'octane_tpu_torch.sequence', 'octane_tpu_torch.parallel',\n"
        "        'octane_tpu_torch.parallel.sharded',\n"
        "        'octane_tpu_torch.parallel.post',\n"
        "        'octane_tpu_torch.parallel.distributed', 'octane_tpu_torch.ops.guard',\n"
        "        'octane_tpu_torch.utils', 'octane_tpu_torch.utils.profiling'} <= set(names)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'octane_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = _python(code)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("path", ["chip_smoke.py", "tools/profile_torch_pair.py",
                                  "tests/torch_fixtures.py", "tests/torch_dist_worker.py",
                                  "tools/nccl_one_card.py"])
def test_smoke_imports_neither_jax_nor_octane_tpu(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "octane_tpu")]
    assert not bad, f"{path} imports {bad}"


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return tree, names


def test_port_source_names_no_h5py():
    """No file of octane_tpu_torch imports h5py, defines an ``_h5py`` helper
    or names h5py at all: every file goes through io/hdf5.py."""
    pkg = os.path.join(ROOT, "octane_tpu_torch")
    files = [os.path.join(d, n) for d, _, ns in os.walk(pkg) for n in ns if n.endswith(".py")]
    assert os.path.join(pkg, "io", "hdf5.py") in files
    for path in files:
        tree, names = _imported(path)
        assert not [n for n in names if n.split(".")[0] == "h5py"], path
        assert not [node.name for node in ast.walk(tree)
                    if isinstance(node, ast.FunctionDef) and node.name == "_h5py"], path
        with open(path) as f:
            assert "h5py" not in f.read(), f"{path} names h5py"


def test_program_layer_imports_point_one_way():
    """flow/variational.py imports nothing of octane_tpu_torch.parallel (the
    captured programs' shared layer is flow/program.py), and no module under
    flow/ or parallel/ imports an underscore name from another module of
    the package."""
    pkg = os.path.join(ROOT, "octane_tpu_torch")
    tree, names = _imported(os.path.join(pkg, "flow", "variational.py"))
    names += [f"{node.module}.{a.name}" for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module for a in node.names]
    assert not [n for n in names if n.startswith("octane_tpu_torch.parallel")], names
    private = []
    for sub in ("flow", "parallel"):
        for d, _, ns in os.walk(os.path.join(pkg, sub)):
            for path in (os.path.join(d, n) for n in ns if n.endswith(".py")):
                tree, _ = _imported(path)
                private += [f"{path}:{node.lineno} {a.name}" for node in ast.walk(tree)
                            if isinstance(node, ast.ImportFrom)
                            and (node.level or (node.module or "").startswith("octane_tpu_torch"))
                            for a in node.names if a.name.startswith("_")]
    assert not private, private


@pytest.mark.parametrize("path", ["chip_smoke.py", "tests/torch_fixtures.py",
                                  "tests/torch_dist_worker.py"])
def test_smoke_does_not_import_h5py(path):
    _, names = _imported(os.path.join(ROOT, path))
    assert not [n for n in names if n.split(".")[0] == "h5py"], f"{path} imports h5py"


def test_load_kernels_raises_without_nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if shutil.which("nvcc") or os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
        pytest.skip("nvcc is installed here: the kernels would build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load_kernels()


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
