"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """The torch device an entry point runs on.  The default is the card;
    a caller that wants the CPU says so.  Raises when CUDA is asked for and
    missing, rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def no_tf32():
    """Context in which float32 convolutions run in full float32: cuDNN
    would otherwise use TF32 for them.  (Float32 matmuls already do:
    torch.backends.cuda.matmul.allow_tf32 is False by default.)"""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
