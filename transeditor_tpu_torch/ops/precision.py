"""Conv/matmul precision policy.

The JAX package runs its float32 path at ``Precision.HIGHEST``.  On the
card cuDNN runs float32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about ten
mantissa bits, so a float32 forward turns TF32 off for convolutions and
matmuls.  bfloat16 paths leave the flags as they are.
"""

from __future__ import annotations

import torch


def conv_precision(dtype: torch.dtype) -> None:
    """Make float32 convs and matmuls true float32 (no TF32)."""
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
