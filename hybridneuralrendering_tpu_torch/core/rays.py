"""Candidate samples along rays (JAX: hybridneuralrendering_tpu/core/rays.py).

Every generator returns fixed-size [R, S] tensors.  The jitter noise is an
input (uniform in [0, 1), shape [R, S]) rather than a random key, so a caller
chooses its generator and a test can feed both packages the same numbers.
"""

from __future__ import annotations

from typing import Optional

import torch


def linspace01(n: int, device=None) -> torch.Tensor:
    """n points from 0 to 1 inclusive: i * float32(1/(n-1)), then 1 (the
    float32 arithmetic jnp.linspace(0, 1, n) compiles to)."""
    if n == 1:
        return torch.zeros(1, device=device)
    t = torch.arange(n - 1, dtype=torch.float32, device=device) * (
        1.0 / (n - 1))
    return torch.cat([t, torch.ones(1, device=device)])


def near_far_linear(campos: torch.Tensor, raydir: torch.Tensor,
                    num_samples: int, near: float, far: float,
                    jitter: float = 0.0, noise: Optional[torch.Tensor] = None):
    """Uniform-in-depth candidates: midpoints of jittered segments.

    campos [3]; raydir [R, 3].  Returns (raypos [R, S, 3], segment length
    [R, S], t [R, S])."""
    R = raydir.shape[0]
    t = linspace01(num_samples + 1, raydir.device)
    edges = near * (1.0 - t) + far * t
    seg = (edges[1:] - edges[:-1])[None, :]
    if jitter > 0.0 and noise is not None:
        seg = seg * (1.0 + jitter * (noise - 0.5))
    else:
        seg = seg.expand(R, num_samples)
    end_ts = near + torch.cumsum(seg, dim=-1)
    end_ts = torch.cat([end_ts.new_full((R, 1), near), end_ts], dim=-1)
    mid_ts = 0.5 * (end_ts[:, :-1] + end_ts[:, 1:])
    raypos = campos[None, None, :] + raydir[:, None, :] * mid_ts[..., None]
    seg = seg * torch.linalg.norm(raydir, dim=-1, keepdim=True)
    return raypos, seg, mid_ts


def near_far_disparity_linear(campos: torch.Tensor, raydir: torch.Tensor,
                              num_samples: int, near: float, far: float,
                              jitter: float = 0.0,
                              noise: Optional[torch.Tensor] = None):
    """Uniform-in-disparity candidates."""
    R = raydir.shape[0]
    t = linspace01(num_samples + 1, raydir.device)
    edges = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    if jitter > 0.0 and noise is not None:
        mids = 0.5 * (edges[:-1] + edges[1:])
        lower = torch.cat([edges[:1], mids])
        upper = torch.cat([mids, edges[-1:]])
        mid_ts = lower[None, :-1] + (upper[None, 1:] - lower[None, :-1]) * noise
        mid_ts = torch.sort(mid_ts, dim=-1).values
    else:
        mid_ts = (0.5 * (edges[:-1] + edges[1:])).expand(R, num_samples)
    seg = torch.diff(torch.cat([mid_ts.new_full((R, 1), near), mid_ts],
                               dim=-1), dim=-1)
    raypos = campos[None, None, :] + raydir[:, None, :] * mid_ts[..., None]
    seg = seg * torch.linalg.norm(raydir, dim=-1, keepdim=True)
    return raypos, seg, mid_ts


RAY_GENERATORS = {
    "near_far_linear": near_far_linear,
    "near_far_disparity_linear": near_far_disparity_linear,
}
