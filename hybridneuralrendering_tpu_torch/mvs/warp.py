"""Bilinear sampling of a feature map at pixel coordinates
(JAX: hybridneuralrendering_tpu/mvs/warp.py:17-40; the rest of that
module, the plane sweeps of the MVS initialiser, is not ported)."""

from __future__ import annotations

from typing import Optional

import torch


def bilinear_sample(feat: torch.Tensor, xy: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """feat [H, W, C] at pixel coordinates xy [..., 2] (x, y), bilinear,
    zero outside the map: grid_sample(align_corners=True) fed unnormalised
    pixel coordinates.  `mask` [...] zeroes samples."""
    H, W, _ = feat.shape
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1, y1 = x0 + 1, y0 + 1
    wx, wy = x - x0, y - y0

    def tap(yy, xx):
        ok = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        v = feat[torch.clamp(yy, 0, H - 1), torch.clamp(xx, 0, W - 1)]
        return v * ok[..., None].to(feat.dtype)

    out = (tap(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
           + tap(y0, x1) * (wx * (1 - wy))[..., None]
           + tap(y1, x0) * ((1 - wx) * wy)[..., None]
           + tap(y1, x1) * (wx * wy)[..., None])
    if mask is not None:
        out = out * mask[..., None].to(out.dtype)
    return out
