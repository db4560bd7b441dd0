"""Training losses (JAX: hybridneuralrendering_tpu/models/losses.py).

Fixed-shape masked reductions: a loss over the rays of a mask is a
mask-weighted mean.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from hybridneuralrendering_tpu_torch.config import LossConfig


def masked_l2(pred: torch.Tensor, gt: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error over the rays where mask is set.  pred, gt
    [R, C]; mask [R]."""
    m = mask.to(pred.dtype)[:, None]
    num = torch.sum(torch.square(pred - gt) * m)
    den = torch.clamp(torch.sum(m) * pred.shape[-1], min=1.0)
    return num / den


def compute_losses(output: Dict, gt_image: torch.Tensor, cfg: LossConfig,
                   frame_weight: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total training loss and its items: masked-ray L2, miss-ray L2 scaled
    by the miss count, plain L2 (each weighted, plus 1e-6), all scaled by
    the frame weight; then the zero-one regulariser and the sparse
    confidence loss."""
    items: Dict[str, torch.Tensor] = {}
    ray_mask = output["ray_mask"].to(torch.float32)
    total = 0.0
    for name, w in zip(cfg.color_loss_items, cfg.color_loss_weights):
        if name.startswith("ray_masked"):
            base = name[len("ray_masked_"):]
            loss = masked_l2(output[base], gt_image, ray_mask > 0)
        elif name.startswith("ray_miss"):
            base = name[len("ray_miss_"):]
            miss = ray_mask == 0
            loss = masked_l2(output[base], gt_image, miss) * torch.sum(
                miss.to(torch.float32))
        else:
            loss = torch.mean(torch.square(output[name] - gt_image))
        items["loss_" + name] = loss
        total = total + loss * w + 1e-6

    if frame_weight is not None:
        total = total * frame_weight

    for name, w in zip(cfg.zero_one_loss_items, cfg.zero_one_loss_weights):
        if name not in output:
            continue
        val = torch.clamp(output[name], cfg.zero_epsilon,
                          1 - cfg.zero_epsilon)
        loss = torch.mean(torch.log(val) + torch.log(1 - val))
        items["loss_" + name] = loss
        total = total + loss * w

    if cfg.sparse_loss_weight > 0 and "weight" in output:
        wgt = output["weight"]
        conf = output["conf_coefficient"]
        loss = torch.sum(wgt * torch.abs(1 - torch.exp(-2 * conf))) / (
            torch.sum(wgt) + 1e-6)
        items["loss_sparse"] = loss
        total = total + loss * cfg.sparse_loss_weight

    items["loss_total"] = total
    return total, items


def psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
