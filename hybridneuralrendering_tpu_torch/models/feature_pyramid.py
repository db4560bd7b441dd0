"""Image-feature pyramid of the hybrid branch
(JAX: hybridneuralrendering_tpu/models/feature_pyramid.py).

Three stride-2 conv stages with x2 channel expansion over each nearby view,
upsampled back to full resolution and concatenated with the RGB: a
45-channel per-pixel map.  NHWC throughout, as in the JAX package.  The
pyramid-cached training step keeps the pre-upsample stage maps per view
(train/pyramid_cache.py) and reads them through `materialize` or
`gather_staged`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from hybridneuralrendering_tpu_torch.models import mlp

EXPAND = 2
STAGES = ("s1a", "s1b", "s2a", "s2b", "s3a", "s3b")


def init(gen: torch.Generator, act: str = "leaky_relu", in_ch: int = 3,
         device="cpu") -> Dict:
    g = mlp.gain(act)
    c1, c2, c3 = 3 * EXPAND, 3 * EXPAND ** 2, 3 * EXPAND ** 3
    chans = [(in_ch, c1), (c1, c1), (c1, c2), (c2, c2), (c2, c3), (c3, c3)]
    return {name: mlp.conv2d_init(gen, a, b, 3, g, device)
            for name, (a, b) in zip(STAGES, chans)}


def apply_stages(params: Dict, images: torch.Tensor, act: str = "leaky_relu",
                 chain_dtype: Optional[torch.dtype] = None,
                 compute_dtype: Optional[torch.dtype] = None):
    """images [V, H, W, 3] -> stage maps (s1 [V,H/2,W/2,6],
    s2 [V,H/4,W/4,12], s3 [V,H/8,W/8,24]).  With `chain_dtype` the params
    and images are cast once and every map stays in that dtype; otherwise
    `compute_dtype` rounds each conv (mlp.conv2d_apply) and the maps stay
    float32, as in JAX feature_pyramid.apply_stages."""
    f = mlp.activation(act)
    cdt = compute_dtype
    if chain_dtype is not None:
        params = {k: {n: t.to(chain_dtype) for n, t in p.items()}
                  for k, p in params.items()}
        images = images.to(chain_dtype)
        cdt = None
    s1 = f(mlp.conv2d_apply(params["s1a"], images, 2, cdt))
    s1 = f(mlp.conv2d_apply(params["s1b"], s1, 1, cdt))
    s2 = f(mlp.conv2d_apply(params["s2a"], s1, 2, cdt))
    s2 = f(mlp.conv2d_apply(params["s2b"], s2, 1, cdt))
    s3 = f(mlp.conv2d_apply(params["s3a"], s2, 2, cdt))
    s3 = f(mlp.conv2d_apply(params["s3b"], s3, 1, cdt))
    return s1, s2, s3


def apply(params: Dict, images: torch.Tensor, act: str = "leaky_relu",
          chain_dtype: Optional[torch.dtype] = None,
          compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """images [V, H, W, 3] -> [V, H, W, 45] (in chain_dtype when given)."""
    V, H, W, _ = images.shape
    s1, s2, s3 = apply_stages(params, images, act, chain_dtype,
                              compute_dtype)
    img = images if chain_dtype is None else images.to(chain_dtype)
    return torch.cat([img, mlp.bilinear_resize(s1, H, W),
                      mlp.bilinear_resize(s2, H, W),
                      mlp.bilinear_resize(s3, H, W)], dim=-1)


def materialize(images: torch.Tensor, stages: Sequence[torch.Tensor],
                pad_to: int = 64,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Cached stage maps -> the full-resolution map [V, H, W, pad_to-multiple]
    (JAX feature_pyramid.materialize): the RGB and the three stage maps
    upsampled as `apply` does, in `dtype` (images' when None), zero-padded
    to a multiple of pad_to channels."""
    V, H, W, _ = images.shape
    td = images.dtype if dtype is None else dtype
    parts = [images.to(td)] + [mlp.bilinear_resize(s.to(td), H, W)
                               for s in stages]
    feat = torch.cat(parts, dim=-1)
    pad = (-feat.shape[-1]) % pad_to
    if pad:
        feat = torch.cat([feat, feat.new_zeros(feat.shape[:-1] + (pad,))],
                         dim=-1)
    return feat


def _bilinear_gather(stage: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                     H: int, W: int) -> torch.Tensor:
    """stage [V, h, w, C] sampled at full-resolution integer pixels (py, px)
    [V, ...] as bilinear_resize(stage, H, W) would give them: half-pixel
    centres, src = (dst + 0.5) * (h / H) - 0.5, edges clamped.  Float32
    weights, so a bf16 stage gives a float32 result, as in JAX."""
    V, h, w, _ = stage.shape
    sy = (py.to(torch.float32) + 0.5) * (h / H) - 0.5
    sx = (px.to(torch.float32) + 0.5) * (w / W) - 0.5
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = (sy - y0)[..., None]
    wx = (sx - x0)[..., None]
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y0i = torch.clamp(y0i, 0, h - 1)
    x0i = torch.clamp(x0i, 0, w - 1)
    vidx = torch.arange(V, device=stage.device).reshape(
        (V,) + (1,) * (py.dim() - 1))
    top = stage[vidx, y0i, x0i] * (1 - wx) + stage[vidx, y0i, x1i] * wx
    bot = stage[vidx, y1i, x0i] * (1 - wx) + stage[vidx, y1i, x1i] * wx
    return top * (1 - wy) + bot * wy


def gather_staged(images: torch.Tensor, stages: Sequence[torch.Tensor],
                  py: torch.Tensor, px: torch.Tensor,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Per-sample features from cached stage maps (JAX
    feature_pyramid.gather_staged): images [V, H, W, 3], py / px [V, ...]
    integer pixels inside the image -> [V, ..., 45], the RGB in `dtype` and
    the three bilinear samples in float32."""
    V, H, W, _ = images.shape
    td = images.dtype if dtype is None else dtype
    vidx = torch.arange(V, device=images.device).reshape(
        (V,) + (1,) * (py.dim() - 1))
    parts = [images.to(td)[vidx, py, px]]
    parts += [_bilinear_gather(s.to(td), py, px, H, W) for s in stages]
    return torch.cat(parts, dim=-1)
