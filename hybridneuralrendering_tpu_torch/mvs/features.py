"""MVS feature networks: the FPN FeatureNet, the 3D cost-regularisation
U-Net and ProbNet (JAX: hybridneuralrendering_tpu/mvs/features.py;
reference models/mvs/models.py:685-822).

Parameters are JAX-layout dicts (conv weights HWIO / DHWIO), so the JAX
package's weights carry over (io/from_jax.mvs_params_from_numpy) and the
feed-forward Adam walks them as it walks the renderer's.  The reference's
InPlaceABN is batch norm then leaky ReLU 0.01.  Batch norm keeps its
running statistics `mean` and `var` in the tree, as parameters: the eval
mode reads them, so they take gradients and Adam updates them, as in JAX
(a torch BatchNorm buffer would not).  `train=True` normalises with the
batch's statistics instead.  Maps are NHWC / DHWC at the interfaces; the
3D convolutions run channels-first inside.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from hybridneuralrendering_tpu_torch.models import mlp

ABN_SLOPE = 0.01


def bn_init(ch: int, device="cpu") -> Dict:
    return {"scale": torch.ones(ch, device=device),
            "bias": torch.zeros(ch, device=device),
            "mean": torch.zeros(ch, device=device),
            "var": torch.ones(ch, device=device)}


def bn_apply(p: Dict, x: torch.Tensor, train: bool = False,
             eps: float = 1e-5, axis: int = -1) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * scale + bias over channel `axis`;
    the statistics of x itself (biased variance) when `train`."""
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    if train:
        dims = [d for d in range(x.dim()) if d != axis % x.dim()]
        mean = torch.mean(x, dim=dims).reshape(shape)
        var = torch.var(x, dim=dims, unbiased=False).reshape(shape)
    else:
        mean, var = p["mean"].reshape(shape), p["var"].reshape(shape)
    inv = torch.rsqrt(var + eps)
    return (x - mean) * inv * p["scale"].reshape(shape) \
        + p["bias"].reshape(shape)


def _abn(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, ABN_SLOPE)


def conv_bn_init(gen: torch.Generator, cin: int, cout: int, k: int = 3,
                 device="cpu") -> Dict:
    # the conv's bias `b` is kept, as JAX keeps it (conv_bn_apply never
    # reads it), so that the tree, its checkpoint order and Adam's are
    # JAX's
    return {"conv": mlp.conv2d_init(gen, cin, cout, k, device=device),
            "bn": bn_init(cout, device)}


def conv2d_nobias(w: torch.Tensor, x: torch.Tensor,
                  stride: int = 1) -> torch.Tensor:
    """x [B, H, W, C] through an HWIO weight, symmetric k//2 padding, no
    bias."""
    k = w.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=k // 2)
    return y.permute(0, 2, 3, 1)


def conv_bn_apply(p: Dict, x: torch.Tensor, stride: int = 1,
                  train: bool = False) -> torch.Tensor:
    """The bias-free conv (the batch norm's bias takes its place), batch
    norm, leaky ReLU."""
    return _abn(bn_apply(p["bn"], conv2d_nobias(p["conv"]["w"], x, stride),
                         train))


def conv3d_init(gen: torch.Generator, cin: int, cout: int, k: int = 3,
                device="cpu") -> Dict:
    fan_in, fan_out = cin * k ** 3, cout * k ** 3
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    w = mlp._uniform(gen, (k, k, k, cin, cout), lim, device)
    return {"w": w, "bn": bn_init(cout, device)}


def dhwio_to_oidhw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(4, 3, 0, 1, 2)


def conv_transpose_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """jax.lax.conv_transpose(x, w, (2, 2, 2), "SAME") with
    transpose_kernel=False, on channels-first x [1, C, D, H, W] and a
    k = 3 DHWIO weight: a stride-1 correlation of x dilated by 2, padded
    (2, 1) per axis, with the kernel as stored (not flipped); out extent
    2n.  conv_transpose3d with padding 0 correlates the dilated input
    padded (2, 2) with its weight flipped, so it gets the flipped kernel,
    and its trailing plane of each axis (2n + 1) is cut.  This is not
    nn.ConvTranspose3d(padding=1, output_padding=1): that one pads (1, 2)
    and flips the kernel (mvs/mvsnet.py's upsampling)."""
    wt = torch.flip(w, dims=(0, 1, 2)).permute(3, 4, 0, 1, 2)   # [I, O, ...]
    y = F.conv_transpose3d(x, wt, stride=2, padding=0)
    return y[:, :, :-1, :-1, :-1]


def conv3d_apply(p: Dict, x: torch.Tensor, stride: int = 1,
                 train: bool = False,
                 transpose: bool = False) -> torch.Tensor:
    """Channels-first x [1, C, D, H, W]: conv (k//2 padding, or the
    stride-2 "SAME" transpose), batch norm, leaky ReLU."""
    k = p["w"].shape[0]
    if transpose:
        y = conv_transpose_same(x, p["w"])
    else:
        y = F.conv3d(x, dhwio_to_oidhw(p["w"]), stride=stride,
                     padding=k // 2)
    return _abn(bn_apply(p["bn"], y, train, axis=1))


# ---------------------------------------------------------------------------
# FeatureNet (models.py:713-765)
# ---------------------------------------------------------------------------

def feature_net_init(gen: torch.Generator, device="cpu") -> Dict:
    def c(cin, cout, k):
        return conv_bn_init(gen, cin, cout, k, device)
    return {
        "c0a": c(3, 8, 3), "c0b": c(8, 8, 3),
        "c1a": c(8, 16, 5), "c1b": c(16, 16, 3), "c1c": c(16, 16, 3),
        "c2a": c(16, 32, 5), "c2b": c(32, 32, 3), "c2c": c(32, 32, 3),
        "top": mlp.conv2d_init(gen, 32, 32, 1, device=device),
    }


def feature_net_apply(p: Dict, images: torch.Tensor, train: bool = False,
                      intermediate: bool = True) -> List[torch.Tensor]:
    """images [V, H, W, 3] -> the pyramid [images, x1 (8, H), x2 (16,
    H/2), x3 (32, H/4)] (the 'imgfeat_0_0123' features of query_embedding,
    mvs_points_model.py:221-259), or [x3] without `intermediate`."""
    x1 = conv_bn_apply(p["c0b"], conv_bn_apply(p["c0a"], images, 1, train),
                       1, train)
    x2 = conv_bn_apply(p["c1a"], x1, 2, train)
    x2 = conv_bn_apply(p["c1b"], x2, 1, train)
    x2 = conv_bn_apply(p["c1c"], x2, 1, train)
    x3 = conv_bn_apply(p["c2a"], x2, 2, train)
    x3 = conv_bn_apply(p["c2b"], x3, 1, train)
    x3 = conv_bn_apply(p["c2c"], x3, 1, train)
    x3 = mlp.conv2d_apply(p["top"], x3)
    if intermediate:
        return [images, x1, x2, x3]
    return [x3]


# ---------------------------------------------------------------------------
# CostRegNet 3D U-Net (models.py:767-811) and ProbNet (:813-822)
# ---------------------------------------------------------------------------

def cost_reg_init(gen: torch.Generator, in_ch: int, device="cpu") -> Dict:
    def c(cin, cout):
        return conv3d_init(gen, cin, cout, 3, device)
    return {
        "c0": c(in_ch, 8), "c1": c(8, 16), "c2": c(16, 16),
        "c3": c(16, 32), "c4": c(32, 32), "c5": c(32, 64), "c6": c(64, 64),
        "c7": c(64, 32), "c9": c(32, 16), "c11": c(16, 8),
    }


def crop_to(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A stride-2 upsampling's output (2 * ceil(n / 2) per axis) cut to the
    skip connection's extent; channels-first [1, C, D, H, W]."""
    return x[:, :, :ref.shape[2], :ref.shape[3], :ref.shape[4]]


def to_ncdhw(vol: torch.Tensor) -> torch.Tensor:
    return vol.permute(3, 0, 1, 2)[None]


def to_dhwc(x: torch.Tensor) -> torch.Tensor:
    return x[0].permute(1, 2, 3, 0)


def cost_reg_apply(p: Dict, vol: torch.Tensor,
                   train: bool = False) -> torch.Tensor:
    """vol [D, H, W, C] -> regularised [D, H, W, 8]."""
    x = to_ncdhw(vol)
    c0 = conv3d_apply(p["c0"], x, 1, train)
    c2 = conv3d_apply(p["c2"], conv3d_apply(p["c1"], c0, 2, train), 1, train)
    c4 = conv3d_apply(p["c4"], conv3d_apply(p["c3"], c2, 2, train), 1, train)
    x = conv3d_apply(p["c6"], conv3d_apply(p["c5"], c4, 2, train), 1, train)
    x = c4 + crop_to(conv3d_apply(p["c7"], x, 2, train, transpose=True), c4)
    x = c2 + crop_to(conv3d_apply(p["c9"], x, 2, train, transpose=True), c2)
    x = c0 + crop_to(conv3d_apply(p["c11"], x, 2, train, transpose=True), c0)
    return to_dhwc(x)


def prob_net_init(gen: torch.Generator, in_ch: int, device="cpu") -> Dict:
    return {"c0": conv3d_init(gen, in_ch, 1, 3, device)}


def prob_net_apply(p: Dict, vol: torch.Tensor,
                   train: bool = False) -> torch.Tensor:
    """vol [D, H, W, C] -> the depth probability [D, H, W, 1], a softmax
    over D."""
    x = to_dhwc(conv3d_apply(p["c0"], to_ncdhw(vol), 1, train))
    return torch.softmax(x, dim=0)
