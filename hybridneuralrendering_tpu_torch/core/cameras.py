"""Camera projection math (JAX: hybridneuralrendering_tpu/core/cameras.py)."""

from __future__ import annotations

import torch


def w2pers(xyz_w: torch.Tensor, camrotc2w: torch.Tensor,
           campos: torch.Tensor) -> torch.Tensor:
    """World points [..., 3] -> perspective coords (x/z, y/z, z) of the
    camera with camera-to-world rotation camrotc2w [3, 3] at campos [3]."""
    xyz_c = (xyz_w - campos) @ camrotc2w
    z = xyz_c[..., 2]
    return torch.stack([xyz_c[..., 0] / z, xyz_c[..., 1] / z, z], dim=-1)


def w2iproject(xyz_w: torch.Tensor, intrinsic: torch.Tensor,
               c2w: torch.Tensor, eps: float = 1e-10):
    """World points [..., 3] -> (pixel xy [..., 2], depth [..., 1]) in the
    view with intrinsics [3, 3] and camera-to-world c2w [4, 4]."""
    xyz_h = torch.cat([xyz_w, torch.ones_like(xyz_w[..., :1])], dim=-1)
    w2c = torch.linalg.inv(c2w)
    xyz_c = xyz_h @ w2c.T
    xyz_i = xyz_c[..., :3] @ intrinsic.T
    depth = xyz_i[..., 2:3]
    return xyz_i[..., 0:2] / (depth + eps), depth


def delta_viewdirs(sample_loc_w: torch.Tensor, campos: torch.Tensor,
                   campos_other: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Unit view direction toward each sample from campos_other minus the
    one from campos.  sample_loc_w [..., 3]; campos, campos_other [3]."""
    cur = sample_loc_w - campos
    cur = cur / (torch.linalg.norm(cur, dim=-1, keepdim=True) + eps)
    other = sample_loc_w - campos_other
    other = other / (torch.linalg.norm(other, dim=-1, keepdim=True) + eps)
    return other - cur


def pers_delta(xyz_pers_pnt: torch.Tensor,
               loc_pers: torch.Tensor) -> torch.Tensor:
    """Perspective-space delta of neighbours [..., K, 3] from their sample
    [..., 3]: (x_p*z_p - x_s*z_s, y_p*z_p - y_s*z_s, z_p - z_s)."""
    xd = xyz_pers_pnt[..., 0] * xyz_pers_pnt[..., 2] - (
        loc_pers[..., None, 0] * loc_pers[..., None, 2])
    yd = xyz_pers_pnt[..., 1] * xyz_pers_pnt[..., 2] - (
        loc_pers[..., None, 1] * loc_pers[..., None, 2])
    zd = xyz_pers_pnt[..., 2] - loc_pers[..., None, 2]
    return torch.stack([xd, yd, zd], dim=-1)
