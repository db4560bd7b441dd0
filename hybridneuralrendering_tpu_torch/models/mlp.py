"""MLP and conv building blocks over plain parameter dicts
(JAX: hybridneuralrendering_tpu/models/mlp.py).

Parameters keep the JAX package's layouts, so the two packages share
weights unchanged: a Linear is {"w": [in, out], "b": [out]} applied as
x @ w + b, a conv is {"w": [kh, kw, in, out] (HWIO), "b": [out]} over NHWC
maps.  Initialisation follows the same xavier-uniform rule from a
torch.Generator.

`compute_dtype` (cfg.agg.compute_dtype = bfloat16) rounds a product's
operands: a Linear rounds x and w to bf16 and multiplies them in float32
(JAX: bf16 operands with preferred_element_type=f32), so its result is not
rounded; a conv runs in bf16 and its result is rounded to bf16 before the
bias, as JAX's is.  The caller keeps TF32 off (device.no_tf32), so the
float32 product of bf16-rounded operands is exact per term.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

LEAKY_SLOPE = 0.01


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "leaky_relu":
        return lambda x: F.leaky_relu(x, LEAKY_SLOPE)
    if name == "relu":
        return F.relu
    if name == "sigmoid":
        return torch.sigmoid
    if name == "tanh":
        return torch.tanh
    raise KeyError(f"unknown activation {name}")


def gain(act: str) -> float:
    if act == "relu":
        return math.sqrt(2.0)
    if act == "leaky_relu":
        return math.sqrt(2.0 / (1.0 + LEAKY_SLOPE ** 2))
    return 1.0


def _uniform(gen: torch.Generator, shape, limit: float, device):
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * limit).to(device)


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                g: float = 1.0, device="cpu") -> Dict:
    limit = g * math.sqrt(6.0 / (in_dim + out_dim))
    return {"w": _uniform(gen, (in_dim, out_dim), limit, device),
            "b": _uniform(gen, (out_dim,), 1.0 / math.sqrt(in_dim), device)}


def mlp_init(gen: torch.Generator, dims: Sequence[int], act: str,
             final_act: bool = False, device="cpu") -> List[Dict]:
    """Linear layers; those followed by an activation get its gain."""
    layers = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        has_act = final_act or i < len(dims) - 2
        layers.append(linear_init(gen, a, b, gain(act) if has_act else 1.0,
                                  device))
    return layers


def conv2d_init(gen: torch.Generator, in_ch: int, out_ch: int, ksize: int,
                g: float = 1.0, device="cpu") -> Dict:
    fan_in, fan_out = in_ch * ksize * ksize, out_ch * ksize * ksize
    limit = g * math.sqrt(6.0 / (fan_in + fan_out))
    return {"w": _uniform(gen, (ksize, ksize, in_ch, out_ch), limit, device),
            "b": _uniform(gen, (out_ch,), 1.0 / math.sqrt(fan_in), device)}


def _dot(x: torch.Tensor, w: torch.Tensor,
         compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """x @ w, the operands rounded to compute_dtype, the product float32."""
    if compute_dtype is None:
        return x @ w
    return x.to(compute_dtype).float() @ w.to(compute_dtype).float()


def linear_apply(p: Dict, x: torch.Tensor,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return _dot(x, p["w"], compute_dtype) + p["b"]


def mlp_apply(layers: List[Dict], x: torch.Tensor, act: str,
              final_act: bool = False,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    fn = activation(act)
    n = len(layers)
    for i, p in enumerate(layers):
        x = linear_apply(p, x, compute_dtype)
        if final_act or i < n - 1:
            x = fn(x)
    return x


def mlp_apply_split(layers: List[Dict], parts: List[torch.Tensor], act: str,
                    final_act: bool = False,
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """mlp_apply over concat(parts, -1) without building the concat: the
    first layer's weight splits by input rows.  Parts broadcast against each
    other over their leading dims."""
    w0, b0 = layers[0]["w"], layers[0]["b"]
    o = 0
    y = None
    for p in parts:
        t = _dot(p, w0[o:o + p.shape[-1]], compute_dtype)
        y = t if y is None else y + t
        o += p.shape[-1]
    if o != w0.shape[0]:
        raise ValueError(f"parts give {o} inputs, the layer takes "
                         f"{w0.shape[0]}")
    y = y + b0
    if final_act or len(layers) > 1:
        y = activation(act)(y)
    if len(layers) == 1:
        return y
    return mlp_apply(layers[1:], y, act, final_act, compute_dtype)


def conv2d_apply(p: Dict, x: torch.Tensor, stride: int = 1,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [B, H, W, C] NHWC, weight HWIO; symmetric k//2 padding.  With
    compute_dtype the conv runs in that type and its result is rounded to
    it, then cast back to x's type before the bias."""
    w = p["w"]
    kh, kw = w.shape[0], w.shape[1]
    xin = x if compute_dtype is None else x.to(compute_dtype)
    w = w if compute_dtype is None else w.to(compute_dtype)
    out = F.conv2d(xin.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   stride=stride, padding=(kh // 2, kw // 2))
    return out.permute(0, 2, 3, 1).to(x.dtype) + p["b"]


def bilinear_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, h, w, C] bilinear with half-pixel centres (for
    upsampling this is jax.image.resize's "bilinear")."""
    out = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)
