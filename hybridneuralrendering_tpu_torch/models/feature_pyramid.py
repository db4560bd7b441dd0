"""Image-feature pyramid of the hybrid branch
(JAX: hybridneuralrendering_tpu/models/feature_pyramid.py).

Three stride-2 conv stages with x2 channel expansion over each nearby view,
upsampled back to full resolution and concatenated with the RGB: a
45-channel per-pixel map.  NHWC throughout, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

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
                 chain_dtype: Optional[torch.dtype] = None):
    """images [V, H, W, 3] -> stage maps (s1 [V,H/2,W/2,6],
    s2 [V,H/4,W/4,12], s3 [V,H/8,W/8,24]).  With `chain_dtype` the params
    and images are cast once and every map stays in that dtype."""
    f = mlp.activation(act)
    if chain_dtype is not None:
        params = {k: {n: t.to(chain_dtype) for n, t in p.items()}
                  for k, p in params.items()}
        images = images.to(chain_dtype)
    s1 = f(mlp.conv2d_apply(params["s1a"], images, stride=2))
    s1 = f(mlp.conv2d_apply(params["s1b"], s1))
    s2 = f(mlp.conv2d_apply(params["s2a"], s1, stride=2))
    s2 = f(mlp.conv2d_apply(params["s2b"], s2))
    s3 = f(mlp.conv2d_apply(params["s3a"], s2, stride=2))
    s3 = f(mlp.conv2d_apply(params["s3b"], s3))
    return s1, s2, s3


def apply(params: Dict, images: torch.Tensor, act: str = "leaky_relu",
          chain_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """images [V, H, W, 3] -> [V, H, W, 45] (in chain_dtype when given)."""
    V, H, W, _ = images.shape
    s1, s2, s3 = apply_stages(params, images, act, chain_dtype)
    img = images if chain_dtype is None else images.to(chain_dtype)
    return torch.cat([img, mlp.bilinear_resize(s1, H, W),
                      mlp.bilinear_resize(s2, H, W),
                      mlp.bilinear_resize(s3, H, W)], dim=-1)
