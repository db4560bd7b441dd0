"""The local frame of the Gaussian distance kernel (`gau_intrp`)
(JAX: hybridneuralrendering_tpu/core/geometrics.py; reference
models/helpers/geometrics.py:15-70): roll-pitch-yaw to a rotation, scaled
by inverse radii, applied to neighbour offsets."""

from __future__ import annotations

import torch


def roll_pitch_yaw_to_rotation(rpy: torch.Tensor) -> torch.Tensor:
    """[..., 3] roll-pitch-yaw radians -> [..., 3, 3] rotations."""
    cx, cy, cz = torch.cos(rpy[..., 0]), torch.cos(rpy[..., 1]), \
        torch.cos(rpy[..., 2])
    sx, sy, sz = torch.sin(rpy[..., 0]), torch.sin(rpy[..., 1]), \
        torch.sin(rpy[..., 2])
    rot = torch.stack([
        cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
        sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
        -sy, cy * sx, cy * cx], dim=-1)
    return rot.reshape(rpy.shape[:-1] + (3, 3))


def compute_world2local_dist(dists: torch.Tensor, radii: torch.Tensor,
                             rotations: torch.Tensor) -> torch.Tensor:
    """Offsets in each element's scaled local frame: diag(1 / (radii +
    1e-8)) @ rot(rotations) @ dists.  dists, radii, rotations [..., 3]
    (rotations as roll-pitch-yaw) -> [..., 3]."""
    rot = roll_pitch_yaw_to_rotation(rotations)
    scale = 1.0 / (radii + 1e-8)
    tx = scale[..., :, None] * rot
    return torch.einsum("...ij,...j->...i", tx, dists)
