"""PyTorch/CUDA port of speakingstyle_tpu for NVIDIA Hopper (H100).

The package mirrors the JAX package's module tree (``ops/``, ``models/``,
``serving/``, ``cli/``, ...) so each module has an obvious counterpart,
and keeps the JAX package's layouts at its public functions: channel-last
``[B, T, C]`` activations, attention q/k/v as ``[B, L, H, D]``, conv
kernels as ``[K, Cin, Cout]``, masks True at padding.

It imports nothing of JAX and nothing of ``speakingstyle_tpu``. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; the
hand-written kernels (``csrc/``) are built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"
