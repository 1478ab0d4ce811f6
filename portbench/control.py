"""The controls of a training cell's correctness check, run on the card:
the numbers the check compares, read from sound runs of the program, from
the control and from a planted fault, on several seeds, in one process, at
the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--sides program,fp8,half_batch]

Per seed, each side against the float32 reference's first three steps:

* ``program``: the program's own step object, driven as set-up drives it;
* ``fp8``: the control, the reference itself in the program's place with
  every convolution and linear layer in float8 e4m3 and the gradients
  flowing back into them in e5m2 (the precision below bf16);
* ``half_batch``: a planted fault, the reference in the program's place
  with half of every batch left out and the mean taken over the rest.

Each side is judged as a run is (``train_check.judge`` under the cell
file's limits).  One JSON line per seed goes to standard output: each
side's numbers, its ``correct``, and the numbers over their limits.  The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

SIDES = ("program", "fp8", "half_batch")


def readings(cell, seed: int, device, sides=SIDES) -> dict:
    """{side: {"numbers": {name: value}, "correct": bool, "over": [...]}}"""
    from portbench.harness import train_check
    from portbench.harness.runner import Run
    from portbench.reference import model as ref_model
    from portbench.traffic.gan_train import Training

    t = Training(cell, seed, device)
    try:
        prog = t.checked_steps()
    finally:
        t.close()
    reals = t.pool[:len(train_check.CHECK_VARIANTS)]
    ref = train_check.reference_readings(cell.config, seed, reals, device)
    make = {
        "program": lambda: prog,
        "fp8": lambda: train_check.reference_readings(
            cell.config, seed, reals, device,
            quant=ref_model.Quant(8, "all", "fp8")),
        "half_batch": lambda: train_check.reference_readings(
            cell.config, seed, reals, device, rows=slice(0, t.batch // 2)),
    }
    out = {}
    for side in sides:
        run = Run(cell=cell, seed=seed, seconds=0.0, trace=False,
                  device=device, t_start=time.perf_counter())
        nums = train_check.numbers(make[side](), ref)
        run.record(nums)                   # as train_check.judge does
        out[side] = {
            "numbers": {k: v[0] for k, v in nums.items()},
            "correct": run.correct,
            "over": sorted(k for k, c in run.compared.items()
                           if not c["value"] <= c["limit"])}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sides", default=",".join(SIDES))
    args = p.parse_args(argv)
    import torch

    from portbench.harness import cell as cell_mod

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = cell_mod.load(args.workload)
    device = torch.device("cuda", 0)
    sides = tuple(args.sides.split(","))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = readings(cell, seed, device, sides)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **got}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
