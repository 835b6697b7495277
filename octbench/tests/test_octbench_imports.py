"""What the benchmark loads: never jax, jaxlib, flax or the JAX package,
compared by whole top-level names (octane_tpu_torch begins with
octane_tpu and is not it); the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

from octbench import run, spec


def test_forbidden_compares_whole_top_level_names():
    assert run.forbidden_modules(["octane_tpu_torch", "octane_tpu_torch.ops", "jaxtyping",
                                  "numpy", "flaxen"]) == []
    assert run.forbidden_modules(["octane_tpu.flow", "jax._src.core", "jaxlib", "flax.linen"]) \
        == ["flax", "jax", "jaxlib", "octane_tpu"]


def test_a_run_of_the_harness_loads_none_of_them():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from octbench import run\n"
            "from octbench.tests.tiny import tiny_cell\n"
            "cell = tiny_cell('sor', 32)\n"
            "cell.traffic.update(compare_pairs=1)\n"
            "out, _, _ = run.run(cell, 99, 0.0, False, 'cpu')\n"
            "print(run.forbidden_modules())\n") % spec.ROOT
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=spec.ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_port():
    for name in ("reference.py", "grid.py", "traffic.py"):
        with open(os.path.join(spec.HERE, name)) as f:
            tree = ast.parse(f.read())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        assert not {m.split(".")[0] for m in mods} & {"octane_tpu", "octane_tpu_torch", "jax",
                                                       "jaxlib", "flax"}, name
