"""ingest_ms: mean milliseconds a pair in the benchmark's own span around
both scans' scene_from_goes_arrays (host counts to the card, float64
navigation and calibration, normalisation).
Each span ends in a device sync; the pairs are those of the traced
window, after the profiled slice."""


def read(run):
    ms = run.spans["ingest"]
    return sum(ms) / len(ms) if ms else None
