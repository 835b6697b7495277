"""Does NCCL take two processes on one card?

    python3 tools/nccl_one_card.py [--timeout SECONDS]

Spawns two processes, both on cuda:0, that form an NCCL group (a
``file://`` rendezvous in a temporary directory) and all-reduce one
tensor; prints what each process saw (the result, or the exception's
first line; NCCL's own warnings, NCCL_DEBUG=WARN, go to the output) and
the card's name and power limit.  A process still running
after the timeout is killed and reported as hung.  Exits 0 whatever NCCL
did: the outcome is the finding.  The multi-process path therefore runs
two processes on one card over gloo (``--dist-backend gloo``), which
stages their rows through host memory; NCCL needs one process per card.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import subprocess
import tempfile
import time


def rank_main(rank: int, url: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    os.environ["NCCL_DEBUG"] = "WARN"
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=url, world_size=2, rank=rank)
        t = torch.full((4,), float(rank + 1), device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        msg = f"all_reduce gave {t.tolist()}"
        dist.destroy_process_group()
    except Exception as exc:          # the outcome under test: report it
        msg = f"{type(exc).__name__}: {str(exc).strip().splitlines()[0]}"
    with open(f"{out}.{rank}", "w") as f:
        f.write(msg)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank")
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=rank_main, args=(r, f"file://{tmp}/store", out))
                 for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + args.timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for r, p in enumerate(procs):
            if p.is_alive():
                p.kill()
                p.join(10)
                print(f"rank {r}: hung, killed after {args.timeout:.0f} s")
            elif os.path.exists(f"{out}.{r}"):
                with open(f"{out}.{r}") as f:
                    print(f"rank {r} (exit {p.exitcode}): {f.read()}")
            else:
                print(f"rank {r}: exited {p.exitcode} without a report")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
