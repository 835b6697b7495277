"""flow_ms: mean milliseconds a pair in the benchmark's own span around
compute_flow (the FlowProgram replay and nav.winds.pix2uv).
Each span ends in a device sync; the pairs are those of the traced
window, after the profiled slice."""


def read(run):
    ms = run.spans["flow"]
    return sum(ms) / len(ms) if ms else None
