"""Device selection for the port's entry points.

Entry points run on the card by default. Only an explicit ``"cpu"``
request runs on the CPU (the tests do that); asking for the default
device on a machine without CUDA raises instead of quietly running on
the CPU.
"""

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or "
            "--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype spelling ("float32" | "bfloat16") -> torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def use_deterministic(on: bool = True) -> None:
    """Deterministic algorithms on (or off again): PyTorch's deterministic
    implementations of the ops that otherwise accumulate with atomics (the
    index and scatter backward passes) and deterministic cuDNN
    convolutions, so that a train step repeats bit for bit (the
    hand-written kernels always do). Slower; for reproducible runs and
    comparisons. Call before the first cuBLAS call of the process for
    ``CUBLAS_WORKSPACE_CONFIG`` to apply."""
    import os

    if on:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(on, warn_only=True)
    torch.backends.cudnn.deterministic = on
