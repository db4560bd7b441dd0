"""Reference PyTorch checkpoints for the port
(JAX: hybridneuralrendering_tpu/io/torch_import.py).

The frame-weight tool loads a pretrained RAFT
(reference raft/demo_content_aware_weights.py:99-107: a plain state_dict,
`module.`-prefixed by DataParallel).  The port's RAFT (flow/raft.py) keeps
the reference's parameter names, so its weights load as they are, with no
layout conversion.  The pretrained MVSNet of the feed-forward bootstrap
comes with the MVS port (ROADMAP item 14).
"""

from __future__ import annotations

from typing import Dict

import torch

from hybridneuralrendering_tpu_torch.device import resolve
from hybridneuralrendering_tpu_torch.flow import raft as raft_mod

MVS_ITEM = 14


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a .pth / .ckpt file as {name: CPU tensor}: a
    {"model": ...} or {"state_dict": ...} container unwrapped and
    DataParallel's "module." prefix stripped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items() if torch.is_tensor(v)}


def load_raft(path: str, device="cuda") -> raft_mod.RAFT:
    """The RAFT of a reference-layout checkpoint, in eval mode on
    `device` (the card unless the caller asks for the CPU).  Every key
    must match: load_state_dict(strict=True)."""
    model = raft_mod.RAFT()
    model.load_state_dict(load_torch_state_dict(path), strict=True)
    return model.eval().to(resolve(device))


def import_mvsnet(*args, **kwargs):
    """The MVSNet importer is part of the MVS port, still to come."""
    raise NotImplementedError(
        f"import_mvsnet comes with the MVS port (ROADMAP item {MVS_ITEM})")
