"""Readings from which a cell's limits are set (not run by the benchmark).

    python3 -m octbench.calibrate --workload <cell> --seconds <s>
        --seeds <n> ... [--control-seeds <n> ...] [--witness-seeds <n> ...]

For each seed, in one process: a run of the cell with a short window
(``run.run``; the program key is built once and captured anew for each
seed), its numbers against the plain reference, and for the control
seeds also the control's numbers: the reference in the precision below
the configuration's (navigation in float32, the solve in bfloat16) put in
the program's place.  For the witness seeds the reference itself with its
dot products summed in float32 takes that place instead: a second sound
computation, which shows how far round-off alone moves each number.
Prints one JSON line per seed, with whether the control's numbers pass
the cell's limits (``run.within``), and, last, the largest number of the
program's runs, the smallest of the control's and the control seeds that
passed; writes the lines to chiprun_out/calibrate_<cell>.jsonl.  Exits 2
without a CUDA device (the readings are the card's), and 1 if a control
run passed the limits.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    a = ap.parse_args(argv)

    import torch

    from octbench import reference, run, spec

    cell = spec.cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"octbench.calibrate: {a.workload} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    out_dir = os.path.join(spec.ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    lines, worst, least, control_passed = [], {}, {}, []
    for seed in list(dict.fromkeys(a.seeds + a.control_seeds + a.witness_seeds)):
        t0 = time.perf_counter()
        ctl = (reference.CONTROL if seed in a.control_seeds
               else reference.Precision() if seed in a.witness_seeds else None)
        out, numbers, control = run.run(cell, seed, a.seconds, False, "cuda", t_start=t0,
                                        control=ctl)
        is_control = seed in a.control_seeds
        rec = {"seed": seed, "alt": None if ctl is None else "control" if is_control else "witness",
               "correct": out["correct"], "pairs": out["attempted"],
               "pair_ms": out["metrics"].get("pair_ms", {}).get("value"),
               "setup_s": out["metrics"].get("setup_s", {}).get("value"),
               "numbers": numbers, "control": control,
               "control_within_limits": run.within(control, cell.limits) if is_control else None,
               "seconds": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        lines.append(rec)
        if seed in a.seeds:
            for k, v in numbers.items():
                worst[k] = max(worst.get(k, v), v)
        if is_control:
            for k, v in control.items():
                least[k] = min(least.get(k, v), v)
            if rec["control_within_limits"]:
                control_passed.append(seed)
    with open(os.path.join(out_dir, f"calibrate_{a.workload}.jsonl"), "a") as f:
        for rec in lines:
            f.write(json.dumps(rec) + "\n")
    print(json.dumps({"workload": a.workload, "program_largest": worst,
                      "control_smallest": least, "control_passed_limits": control_passed}),
          flush=True)
    return 1 if control_passed else 0


if __name__ == "__main__":
    sys.exit(main())
