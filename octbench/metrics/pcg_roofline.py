"""pcg_roofline: the PCG iterations' least time on the card over the device
time of the two pass kernels of ``ops.pcg`` (csrc/pcg.cu), in percent,
over the profiled slice (the traffic's ``trace_pairs`` first pairs of the
window).  The work is counted by rooflines.json's "pcg" entry; a fused or
renamed kernel leaves the metric out."""

from octbench import roofline

KERNELS = ("pcg_pass_a", "pcg_pass_b")


def read(run):
    return None if run.trace is None else roofline.share(run, "pcg", KERNELS)
