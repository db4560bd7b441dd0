"""Reference PyTorch checkpoints for the port
(JAX: hybridneuralrendering_tpu/io/torch_import.py).

The frame-weight tool loads a pretrained RAFT
(reference raft/demo_content_aware_weights.py:99-107: a plain state_dict,
`module.`-prefixed by DataParallel).  The port's RAFT (flow/raft.py) keeps
the reference's parameter names, so its weights load as they are, with no
layout conversion.

The MVS bootstrap loads the official MVSNet's checkpoint
(checkpoints/MVSNet/model_000014.ckpt; reference
models/mvs/mvs_points_model.py:66-74: {"model": a `module.`-prefixed
state_dict}).  import_mvsnet maps it onto mvs/mvsnet.py's tree in JAX's
layouts:
  Conv2d w [O, I, kh, kw]            -> HWIO [kh, kw, I, O]
  Conv3d w [O, I, kd, kh, kw]        -> DHWIO [kd, kh, kw, I, O]
  ConvTranspose3d w [I, O, kd, ...]  -> spatially flipped, then DHWIO with
      I = the transpose conv's input channels
  BatchNorm (weight, bias, running_mean, running_var)
      -> {scale, bias, mean, var}
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from hybridneuralrendering_tpu_torch.device import resolve
from hybridneuralrendering_tpu_torch.flow import raft as raft_mod
from hybridneuralrendering_tpu_torch.train.state import tree_map

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


def _t(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                           dtype=torch.float32)


def _c2d(sd, name, bias=True) -> Dict:
    p = {"w": _t(sd[f"{name}.weight"]).permute(2, 3, 1, 0).contiguous()}
    if bias:
        p["b"] = _t(sd[f"{name}.bias"])
    return p


def _c3d(sd, name) -> torch.Tensor:
    return _t(sd[f"{name}.weight"]).permute(2, 3, 4, 1, 0).contiguous()


def _c3dT(sd, name) -> torch.Tensor:
    w = torch.flip(_t(sd[f"{name}.weight"]), dims=(2, 3, 4))
    return w.permute(2, 3, 4, 0, 1).contiguous()


def _bn(sd, name) -> Dict:
    return {"scale": _t(sd[f"{name}.weight"]),
            "bias": _t(sd[f"{name}.bias"]),
            "mean": _t(sd[f"{name}.running_mean"]),
            "var": _t(sd[f"{name}.running_var"])}


def import_mvsnet(sd: Dict[str, Union[torch.Tensor, np.ndarray]],
                  device="cuda") -> Dict:
    """The official MVSNet's state_dict ({name: tensor or array}, without
    the "module." prefix, as load_torch_state_dict gives it) -> the
    {"feature", "cost_reg"} tree of mvs/mvsnet.py as float32 tensors on
    `device` (the card unless the caller asks for the CPU).  A missing
    key raises KeyError."""
    dev = resolve(device)

    def cbn2(name):
        return {"conv": _c2d(sd, f"{name}.conv", bias=False),
                "bn": _bn(sd, f"{name}.bn")}

    def cbn3(name):
        return {"conv": {"w": _c3d(sd, f"{name}.conv")},
                "bn": _bn(sd, f"{name}.bn")}

    def dcbn3(name):
        # nn.Sequential(ConvTranspose3d, BatchNorm3d, ReLU): indices 0, 1
        return {"conv": {"w": _c3dT(sd, f"{name}.0")},
                "bn": _bn(sd, f"{name}.1")}

    feature = {f"conv{i}": cbn2(f"feature.conv{i}") for i in range(7)}
    feature["feature"] = _c2d(sd, "feature.feature")
    cr = "cost_regularization"
    cost_reg = {f"conv{i}": cbn3(f"{cr}.conv{i}") for i in range(7)}
    cost_reg.update({f"conv{i}": dcbn3(f"{cr}.conv{i}") for i in (7, 9, 11)})
    cost_reg["prob"] = {"w": _c3d(sd, f"{cr}.prob"),
                        "b": _t(sd[f"{cr}.prob.bias"])}
    return tree_map(lambda x: x.to(dev),
                    {"feature": feature, "cost_reg": cost_reg})
