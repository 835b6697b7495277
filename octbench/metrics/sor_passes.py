"""sor_passes: SOR passes (of up to 8 red+black sweeps) a pair over the
traced window, the device count of the pass kernel's launches
(ops.counters(), read after the window)."""


def read(run):
    n = run.window_counters.get("sor_pass", 0)
    return n / run.pairs if n and run.pairs else None
