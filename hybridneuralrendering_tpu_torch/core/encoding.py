"""Positional encoding (JAX: hybridneuralrendering_tpu/core/encoding.py)."""

from __future__ import annotations

import torch


def positional_encoding(positions: torch.Tensor, freqs: int,
                        ori: bool = False) -> torch.Tensor:
    """sin/cos encoding with 2**k frequency bands.

    positions [..., D] -> [..., 2*freqs*D], or [..., D + 2*freqs*D] with
    `ori`.  The scaled values are ordered (d0*f0, d0*f1, ..., d1*f0, ...);
    without `ori` sin and cos interleave per element, with `ori` the layout
    is [raw, all-sin, all-cos]."""
    bands = 2.0 ** torch.arange(freqs, device=positions.device)
    bands = bands.to(positions.dtype)
    scaled = (positions[..., None] * bands).reshape(
        positions.shape[:-1] + (positions.shape[-1] * freqs,))
    if ori:
        return torch.cat([positions, torch.sin(scaled), torch.cos(scaled)],
                         dim=-1)
    enc = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-1)
    return enc.reshape(scaled.shape[:-1] + (scaled.shape[-1] * 2,))
