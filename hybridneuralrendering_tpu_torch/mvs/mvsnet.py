"""The official MVSNet depth estimator: a plane-sweep variance cost volume
and a 3D U-Net (JAX: hybridneuralrendering_tpu/mvs/mvsnet.py; reference
models/depth_estimators/mvsnet.py, checkpoint
checkpoints/MVSNet/model_000014.ckpt).

The parameter tree mirrors the torch module layer for layer (ConvBnReLU
blocks with plain ReLU and bias-free convs, the U-Net's transpose-conv
upsampling, the biased 1-channel `prob` head), in JAX's layouts, so the
released checkpoint imports through io/torch_import.import_mvsnet.  The
views' warps are summed and summed in squares one view at a time, so the
variance volume is the only volume alive besides one view's warp.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from hybridneuralrendering_tpu_torch.models import mlp
from hybridneuralrendering_tpu_torch.mvs import warp as W
from hybridneuralrendering_tpu_torch.mvs.features import (
    bn_apply, bn_init, conv2d_nobias, crop_to, dhwio_to_oidhw, to_dhwc,
    to_ncdhw)


# ---------------------------------------------------------------------------
# ConvBnReLU blocks (depth_estimators/module.py:6-33)
# ---------------------------------------------------------------------------

def _conv_bn_init(gen: torch.Generator, cin: int, cout: int, k: int = 3,
                  device="cpu") -> Dict:
    return {"conv": {"w": mlp.conv2d_init(gen, cin, cout, k,
                                          device=device)["w"]},
            "bn": bn_init(cout, device)}


def _conv_bn_apply(p: Dict, x: torch.Tensor, stride: int = 1,
                   train: bool = False) -> torch.Tensor:
    return F.relu(bn_apply(p["bn"], conv2d_nobias(p["conv"]["w"], x, stride),
                           train))


def _conv3d_w(gen: torch.Generator, cin: int, cout: int,
              device) -> torch.Tensor:
    lim = math.sqrt(6.0 / (cin * 27 + cout * 27))
    return mlp._uniform(gen, (3, 3, 3, cin, cout), lim, device)


def _conv3d_bn_init(gen: torch.Generator, cin: int, cout: int,
                    device="cpu") -> Dict:
    return {"conv": {"w": _conv3d_w(gen, cin, cout, device)},
            "bn": bn_init(cout, device)}


def _conv3d_bn_apply(p: Dict, x: torch.Tensor, stride: int = 1,
                     train: bool = False) -> torch.Tensor:
    """Channels-first x [1, C, D, H, W]."""
    y = F.conv3d(x, dhwio_to_oidhw(p["conv"]["w"]), stride=stride, padding=1)
    return F.relu(bn_apply(p["bn"], y, train, axis=1))


def _deconv3d_bn_apply(p: Dict, x: torch.Tensor,
                       train: bool = False) -> torch.Tensor:
    """torch ConvTranspose3d(k=3, stride=2, padding=1, output_padding=1):
    x dilated by 2, padded (1, 2), correlated with the spatially flipped
    kernel.  The DHWIO weight holds that flipped kernel with I = the
    transpose conv's input channels (io/torch_import flips and permutes
    the checkpoint's), so flipping it back gives conv_transpose3d's own
    weight [I, O, kd, kh, kw]."""
    wt = torch.flip(p["conv"]["w"], dims=(0, 1, 2)).permute(3, 4, 0, 1, 2)
    y = F.conv_transpose3d(x, wt, stride=2, padding=1, output_padding=1)
    return F.relu(bn_apply(p["bn"], y, train, axis=1))


# ---------------------------------------------------------------------------
# FeatureNet (depth_estimators/mvsnet.py:7-27): 3 -> 8 -> 16 -> 32 at 1/4
# ---------------------------------------------------------------------------

def feature_init(gen: torch.Generator, device="cpu") -> Dict:
    def c(cin, cout, k):
        return _conv_bn_init(gen, cin, cout, k, device)
    return {
        "conv0": c(3, 8, 3), "conv1": c(8, 8, 3), "conv2": c(8, 16, 5),
        "conv3": c(16, 16, 3), "conv4": c(16, 16, 3), "conv5": c(16, 32, 5),
        "conv6": c(32, 32, 3),
        "feature": mlp.conv2d_init(gen, 32, 32, 3, device=device),
    }


def feature_apply(p: Dict, images: torch.Tensor,
                  train: bool = False) -> torch.Tensor:
    """images [V, H, W, 3] -> [V, H/4, W/4, 32]."""
    x = _conv_bn_apply(p["conv1"], _conv_bn_apply(p["conv0"], images, 1,
                                                  train), 1, train)
    x = _conv_bn_apply(p["conv2"], x, 2, train)
    x = _conv_bn_apply(p["conv4"], _conv_bn_apply(p["conv3"], x, 1, train),
                       1, train)
    x = _conv_bn_apply(p["conv5"], x, 2, train)
    x = _conv_bn_apply(p["conv6"], x, 1, train)
    return mlp.conv2d_apply(p["feature"], x)


# ---------------------------------------------------------------------------
# CostRegNet (depth_estimators/mvsnet.py:30-71): U-Net and 1-channel head
# ---------------------------------------------------------------------------

def cost_reg_init(gen: torch.Generator, device="cpu") -> Dict:
    def c(cin, cout):
        return _conv3d_bn_init(gen, cin, cout, device)
    return {
        "conv0": c(32, 8), "conv1": c(8, 16), "conv2": c(16, 16),
        "conv3": c(16, 32), "conv4": c(32, 32), "conv5": c(32, 64),
        "conv6": c(64, 64), "conv7": c(64, 32), "conv9": c(32, 16),
        "conv11": c(16, 8),
        "prob": {"w": mlp._uniform(gen, (3, 3, 3, 8, 1),
                                   math.sqrt(6.0 / (8 * 27 + 27)), device),
                 "b": torch.zeros(1, device=device)},
    }


def cost_reg_apply(p: Dict, vol: torch.Tensor,
                   train: bool = False) -> torch.Tensor:
    """vol [D, H, W, 32] -> cost scores [D, H, W]."""
    x = to_ncdhw(vol)
    c0 = _conv3d_bn_apply(p["conv0"], x, 1, train)
    c2 = _conv3d_bn_apply(p["conv2"], _conv3d_bn_apply(p["conv1"], c0, 2,
                                                       train), 1, train)
    c4 = _conv3d_bn_apply(p["conv4"], _conv3d_bn_apply(p["conv3"], c2, 2,
                                                       train), 1, train)
    x = _conv3d_bn_apply(p["conv6"], _conv3d_bn_apply(p["conv5"], c4, 2,
                                                      train), 1, train)
    x = c4 + crop_to(_deconv3d_bn_apply(p["conv7"], x, train), c4)
    x = c2 + crop_to(_deconv3d_bn_apply(p["conv9"], x, train), c2)
    x = c0 + crop_to(_deconv3d_bn_apply(p["conv11"], x, train), c0)
    y = F.conv3d(x, dhwio_to_oidhw(p["prob"]["w"]), padding=1)
    return to_dhwc(y)[..., 0] + p["prob"]["b"]


def init(gen: torch.Generator, device="cpu") -> Dict:
    return {"feature": feature_init(gen, device),
            "cost_reg": cost_reg_init(gen, device)}


def build_proj(intrinsic: torch.Tensor, w2c: torch.Tensor,
               scale: float = 0.25) -> torch.Tensor:
    """[4, 4] projection with the intrinsics scaled to the feature
    resolution (nerf_synth360_ft_dataset.py:497-501)."""
    k = intrinsic.clone()
    k[:2] = k[:2] * scale
    proj = torch.eye(4, dtype=intrinsic.dtype, device=intrinsic.device)
    proj[:3, :4] = k @ w2c[:3, :4]
    return proj


def variance_volume(feats: torch.Tensor, intrinsic: torch.Tensor,
                    w2cs: torch.Tensor,
                    depth_values: torch.Tensor) -> torch.Tensor:
    """The plane-sweep variance of the views' features feats [V, h, w, C]
    on the reference view's (view 0's) planes: E[warp^2] - E[warp]^2 over
    the views, the reference view warped too (its relative projection is
    the identity, mvsnet.py:113-121).  Returns [D, h, w, C]."""
    V = feats.shape[0]
    ref_inv = torch.linalg.inv(build_proj(intrinsic, w2cs[0]))
    s = s2 = None
    for feat_v, w2c_v in zip(feats, w2cs):
        proj = (build_proj(intrinsic, w2c_v) @ ref_inv)[:3]
        warped = W.plane_sweep_warp(feat_v, proj, depth_values)
        s = warped if s is None else s + warped
        s2 = warped ** 2 if s2 is None else s2 + warped ** 2
    return s2 / V - (s / V) ** 2


def regress(prob: torch.Tensor, depth_values: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(expected depth, photometric confidence) of prob [D, h, w]."""
    D = prob.shape[0]
    depth = W.depth_regression(prob, depth_values)
    idx = W.depth_regression(prob, torch.arange(D, dtype=prob.dtype,
                                                device=prob.device))
    return depth, W.photometric_confidence(prob, idx)


def depth_from_views(params: Dict, images: torch.Tensor,
                     intrinsic: torch.Tensor, w2cs: torch.Tensor,
                     depth_values: torch.Tensor, train: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference view's depth from V posed views (mvsnet.py:98-135).
    images [V, H, W, 3] (view 0 the reference); intrinsic [3, 3] at full
    resolution; w2cs [V, 4, 4]; depth_values [D].  Returns (depth
    [H/4, W/4], confidence [H/4, W/4])."""
    feats = feature_apply(params["feature"], images, train)
    variance = variance_volume(feats, intrinsic, w2cs, depth_values)
    score = cost_reg_apply(params["cost_reg"], variance, train)
    return regress(torch.softmax(score, dim=0), depth_values)


def depth_to_cam_xyz(depth: torch.Tensor,
                     intrinsic: torch.Tensor) -> torch.Tensor:
    """depth [H, W] -> camera-space points [H * W, 3] (depth2point,
    mvs_points_model.py:171-182)."""
    H, Wd = depth.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=depth.device),
                            torch.arange(Wd, device=depth.device),
                            indexing="ij")
    xs, ys = xs.to(depth.dtype), ys.to(depth.dtype)
    pix = torch.stack([xs * depth, ys * depth, depth], dim=-1)
    return (pix @ torch.linalg.inv(intrinsic).T).reshape(-1, 3)
