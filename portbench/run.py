"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights made on the card from the seed, the program built and
warmed on every shape the cell's traffic uses), then a window of
``--seconds`` of the cell's traffic, then the check against the plain
reference.  The last line of standard output is the result as one JSON
object; the numbers compared, each beside its limit, are the last lines of
standard error.  ``--trace 1`` reports the per-layer metrics instead of the
end-to-end ones, from a profiled span of the window.

Exits with a code other than 0 and prints no result when no CUDA card (or
fewer than the cell asks for) is present, or when JAX or the JAX package
was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
os.environ.setdefault("USE_FLAX", "0")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench.harness import cell as cell_mod
    from portbench.harness import runner

    cell = cell_mod.load(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    run = runner.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=torch.device("cuda", 0),
                     t_start=T_START)
    out = runner.execute(run)
    found = runner.forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    runner.report(out, run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
