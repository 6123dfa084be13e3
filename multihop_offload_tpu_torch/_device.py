"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for (explicitly or by default) and
    absent — there is no silent fall back to the CPU.

    On the card, TF32 is switched off for matmuls and cuDNN: the ChebNet
    products and the plain fixed point then run in full float32, as the
    JAX package's fp32 policy does, so card and CPU runs agree to fp32
    rounding."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the work queued on `dev`: the card's stream, or nothing on
    the CPU."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
