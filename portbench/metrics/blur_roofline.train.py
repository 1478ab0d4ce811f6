"""blur_roofline.train: the share of its bound that the up-convolutions' blur
kernels (``fused_blur4*``) reach over the profiled cadence period.

Work, from the model's shapes and the steps completed, not from launches.
One blur application over an up-conv reads its [2h+1, 2h+1, C] input and
writes its [2h, 2h, C] output (or, as the adjoint, the same two maps the
other way), once, in the configuration's compute dtype.  A step needs, at
its batch B and path batch Bp:

* every step: the fakes of the D step and of the G step (2 applications at
  B) and the G step's backward (1 adjoint at B);
* a path-length step besides: its forward, the adjoint of its first
  backward, and the second backward through both (4 at Bp).

Recomputation, float32 operands and padding are not work, so they lower the
share.  Bound = bytes / 3.35 TB/s; time = the device time of every
``fused_blur4`` kernel in the span.  No such kernel: nothing to read.
"""

from portbench.harness import arith, peaks


def read(run):
    steps = run.data.get("traced_steps")
    if run.traced is None or not steps:
        return None
    seconds, launches = run.traced.seconds("fused_blur4")
    if not launches:
        return None
    b, bp = run.data["batch"], run.data["path_batch"]
    n_steps = sum(steps.values())
    n_path = steps["path"] + steps["r1+path"]
    apps = 3 * b * n_steps + 4 * bp * n_path
    per = arith.blur_image_bytes(run.cell.model, run.cell.config["dtype"])
    return 100.0 * apps * per / peaks.HBM_BYTES / seconds
