"""TransEditor on PyTorch and CUDA: the port of ``transeditor_tpu``.

The JAX package stays the reference; this package mirrors its module
layout (``config``, ``ops/``, ``nn/``, ``models/``, ``io/``, ``serve``)
and imports nothing of it, nor JAX.  Images are NHWC and token tensors
[B, T, D], as in the JAX package.  The Pallas kernel of the JAX package
is a hand-written CUDA kernel here (``csrc/fused_blur4.cu``, wrapped by
``ops/fused_blur.py``), built for ``sm_90a`` at first use.

Entry points run on the card: they default to ``device="cuda"`` and
raise when CUDA is absent unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.models.generator import Generator, GeneratorOutput
