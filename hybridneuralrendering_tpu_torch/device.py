"""Device choice for the port's entry points."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# batch keys that stay on the host (frame and view ids)
HOST_KEYS = ("vid", "nearest_vids")


def resolve(device="cuda") -> torch.device:
    """The torch device an entry point runs on.  The default is the card;
    a caller that wants the CPU says so.  Raises when CUDA is asked for and
    missing, rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def device_batch(batch: Dict, device="cuda") -> Dict:
    """A host batch (numpy arrays, as data/scannet.ScannetScene.get_batch
    gives) as tensors on `device`, without HOST_KEYS."""
    dev = resolve(device)
    return {k: torch.as_tensor(np.asarray(v), device=dev)
            for k, v in batch.items() if k not in HOST_KEYS}


def no_tf32():
    """Context in which float32 convolutions run in full float32: cuDNN
    would otherwise use TF32 for them.  (Float32 matmuls already do:
    torch.backends.cuda.matmul.allow_tf32 is False by default.)"""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
