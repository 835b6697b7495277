"""The benchmark of octane_tpu_torch, the PyTorch and CUDA port.

    python3 -m octbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in ``configs/<config>.json``, its traffic in
``traffic/<traffic>.json`` (laid over the mix it names as ``base``, if
any), its limits in ``limits/<cell>.json`` and each
metric in ``metrics/<metric>.py``.  Nothing here imports jax or the JAX
package; ``reference.py`` imports nothing of the port either.
"""
