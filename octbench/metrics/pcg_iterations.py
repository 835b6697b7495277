"""pcg_iterations: PCG iterations a pair over the traced window, the
device count of pass A's launches (ops.counters(), read after the window)."""


def read(run):
    n = run.window_counters.get("pcg_pass_a", 0)
    return n / run.pairs if n and run.pairs else None
