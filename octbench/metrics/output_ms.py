"""output_ms: mean milliseconds a pair in the benchmark's own span around
the copies of U, V, U_raw and V_raw to host memory.
Each span ends in a device sync; the pairs are those of the traced
window, after the profiled slice."""


def read(run):
    ms = run.spans["output"]
    return sum(ms) / len(ms) if ms else None
