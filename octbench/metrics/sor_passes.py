"""sor_passes: SOR passes (of up to 8 red+black sweeps) a pair over the
traced window, the device count of the pass kernel's launches
(ops.counters(), read after the window); on a mesh, the band form's
launches over the number of bands (roofline.work)."""

from octbench import roofline


def read(run):
    n = roofline.work(run.config["settings"], run.window_counters, "sor")
    return n / run.pairs if n and run.pairs else None
