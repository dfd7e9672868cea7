"""royaltracer_dx_tpu_torch — the PyTorch/CUDA port of royaltracer_dx_tpu.

Same module layout and names as the JAX package (``config``, ``camera``,
``scene/``, ``ops/``, ``render/``, ``utils/``), written as plain functions
on tensors with an explicit ``device``.  Each trace batch takes the route
that the JAX package's dispatch decides (``ops/restir.py`` ``trace_mode``):
the stream, brute-force, LBVH or cluster kernels, hand-written for Hopper
in ``csrc/`` and built and bound by their ``ops/`` modules.  The TEA draws
and the light pick run hand-written kernels too; the rest is tensor code.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request they raise (``device.py``).

The package imports neither ``jax`` nor any module of
``royaltracer_dx_tpu``: it keeps its own copies of what it needs.
"""

import torch as _torch

# Geometry math must be full fp32 (royaltracer_dx_tpu/__init__.py:21-24
# forces "highest" matmul precision for the same reason): TF32 keeps ~10
# mantissa bits, which rounds e.g. a light plane at y=0.999 to 1.0 and
# makes shadow rays self-occlude.  Both switches are stated, not assumed.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from royaltracer_dx_tpu_torch.config import RenderConfig  # noqa: E402
from royaltracer_dx_tpu_torch.camera import Camera  # noqa: E402

__version__ = "0.1.0"

__all__ = ["RenderConfig", "Camera", "__version__"]
