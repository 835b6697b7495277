"""Time the SOR pass kernel (csrc/sor.cu) of one checkout at every level
shape of the 5424^2 pair, after holding it bit for bit against its plain
version.

    python3 tools/sor_pass_ab.py [ROOT] [--label NAME] [--no-check] [--sweep] [--out FILE]

ROOT is a checkout of the repository (default: this one); its kernels are
built from its own csrc/.  One process serves one checkout, so an A/B of two
versions of the kernel runs this once per checkout, alternating, in one
call on the card:

    for t in old . . old; do python3 tools/sor_pass_ab.py $t; done

Prints whether every pass equalled ``sor_pass_plain`` (iterate and residual
partials; 1, 6 and 8 sweeps at small shapes, 8 and 6 at every level shape),
then one line per level shape and coefficient stack (nc = 10 robust, 6
quad): the ms of a pass of 8 and of 6 sweeps with the kernel's default
block geometry.  ``--sweep`` also times every strip width the kernel accepts
with the least segment height of each count of row segments (up to 48),
and prints the fastest beside the default; ``--out`` writes those timings
as JSON.  ``--no-check`` skips the comparison, for a deliberately altered
copy.
"""

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = (5424, 2712, 1356, 678)    # the 5424^2 pair's pyramid: kiters 4, scale 0.5


def system(nc, h, w, dev, gen):
    """A diagonally dominant random coefficient stack and an iterate."""
    cf = torch.empty((nc, h, w), device=dev).uniform_(-1, 1, generator=gen)
    cf[0:2] += 6.0
    x = torch.empty((2, h, w), device=dev).normal_(0, 0.3, generator=gen)
    return cf, x


def seg_heights(h, most=48):
    """The least segment height (a multiple of 8) of each count of row
    segments up to ``most``."""
    segs = []
    for n in range(1, most + 1):
        seg = (-(-h // n) + 7) // 8 * 8
        if -(-h // seg) == n and seg not in segs:
            segs.append(seg)
    return segs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=REPO)
    ap.add_argument("--label")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("sor_pass_ab: no CUDA device is available")
    sys.path.insert(0, REPO)
    from chip_smoke import cuda_ms
    sys.path.insert(0, os.path.abspath(args.root))
    from octane_tpu_torch.ops import sor

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    label = args.label or args.root
    exact = True

    def same(got, want):
        return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    if not args.no_check:
        for h, w in ((2, 2), (7, 20), (19, 40), (133, 257), (500, 372), (512, 512)):
            for nc in (6, 10):
                cf, x = system(nc, h, w, dev, gen)
                for k in (1, 6, 8):
                    exact &= same(sor.sor_pass(x, cf, k), sor.sor_pass_plain(x, cf, k))
    record = []
    for h in LEVELS:
        for nc in (10, 6):
            cf, x = system(nc, h, h, dev, gen)
            xo = torch.empty_like(x)
            line = f"{label} {h}x{h} nc={nc}:"
            for k in (8, 6):
                if not args.no_check:
                    got = sor.sor_pass(x, cf, k, out=xo)
                    exact &= same((got[0].clone(), got[1]), sor.sor_pass_plain(x, cf, k))
                t = cuda_ms(lambda: sor.sor_pass(x, cf, k, out=xo))
                line += f" {k} sweeps {t:.3f} ms"
                if not args.sweep:
                    continue
                want = sor.sor_pass(x, cf, k, out=xo)[0].clone()
                times = {}
                for strip in (128, 96, 64):
                    for seg in seg_heights(h):
                        try:
                            got, _ = sor._launch_pass(x, cf, k, sor.OMEGA, xo, strip, seg)
                        except RuntimeError:          # the ring does not fit
                            break
                        exact &= torch.equal(got, want)
                        times[(strip, seg)] = cuda_ms(
                            lambda: sor._launch_pass(x, cf, k, sor.OMEGA, xo, strip, seg), n=5)
                (bs, bg), best = min(times.items(), key=lambda kv: kv[1])
                line += f" (fastest {bs}x{bg} {best:.3f} ms, default/fastest {t / best:.3f});"
                record.append({"h": h, "nc": nc, "sweeps": k, "default_ms": t,
                               "ms": {f"{s}x{g}": v for (s, g), v in times.items()}})
            print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"label": label, "device": torch.cuda.get_device_name(0),
                       "passes": record}, f)
    print(f"{label}: " + ("not checked" if args.no_check else f"bit-exact {exact}"), flush=True)
    if not exact:
        sys.exit(1)


if __name__ == "__main__":
    main()
