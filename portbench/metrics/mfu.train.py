"""mfu.train: the useful FLOPs of the training steps in the profiled cadence
period over (the period's length x 989 TFLOP/s, the bf16 peak).

Useful FLOPs: the plain reference's step at the configuration's widths and
batches, counted by ``torch.utils.flop_counter``'s rules on the meta device
(``harness/flops.py``): every convolution, linear layer and attention
product of the forwards, the backwards and the R1 / path-length double
backwards, and no recomputation.
"""

from portbench.harness import flops, peaks

VARIANTS = {"plain": (False, False), "r1+path": (True, True),
            "path": (False, True), "r1": (True, False)}


def read(run):
    steps = run.data.get("traced_steps")
    if run.traced is None or not steps:
        return None
    m, tc = run.cell.model, run.cell.config["train"]
    total = sum(n * flops.train_step_flops(
        m, tc, run.data["batch"], run.data["path_batch"], *VARIANTS[kind])
        for kind, n in steps.items() if n)
    return 100.0 * total / (run.traced.window_s * peaks.BF16_FLOPS)
