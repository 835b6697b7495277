"""sor_roofline: the SOR rounds' least time on the card over the device
time of the pass kernel of ``ops.sor`` (csrc/sor.cu), in percent, over the
profiled slice (the traffic's ``trace_pairs`` first pairs of the window).
The work is counted by rooflines.json's "sor" entry; a fused or renamed
kernel leaves the metric out."""

from octbench import roofline

KERNELS = ("sor_pass",)


def read(run):
    return None if run.trace is None else roofline.share(run, "sor", KERNELS)
