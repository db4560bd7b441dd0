"""Plane-background compositing, the reference's `bgmodel=...plane` path
(JAX: hybridneuralrendering_tpu/core/bg_plane.py; reference `set_bg`,
models/mvs_points_volumetric_model.py:290-328, and
models/mvs/mvs_utils.py:380-409).

Each ray's crossing of a plane behind the scene is projected into the
nearest views, the plane colour is read there where no foreground point
covers the pixel, and the per-ray colour composites under the background
transmission (models/renderer.render with `bg_ray`).  Shapes stay fixed:
invalid rays and pixels are masked, never compacted.  The foreground splat
is a scatter-max of every point into a dense [H, W] mask per view, whose
out-of-range points go to a dropped slot past the end.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hybridneuralrendering_tpu_torch.mvs.warp import bilinear_sample


def ray_plane_cross(campos: torch.Tensor, raydir: torch.Tensor,
                    plane_pnt: torch.Tensor, plane_normal: torch.Tensor,
                    epsilon: float = 1e-3
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """campos [3], raydir [R, 3], plane_pnt [3], plane_normal [3] (need not
    be unit) -> (crossings [R, 3], zero where the ray is parallel or faces
    away; valid [R] bool: dot(normal, dir) >= epsilon)."""
    dot = torch.sum(plane_normal * raydir, dim=-1)
    valid = dot >= epsilon
    w = campos - plane_pnt
    fac = -torch.sum(plane_normal * w) / torch.where(
        valid, dot, torch.ones_like(dot))
    cross = campos + raydir * fac[..., None]
    return torch.where(valid[..., None], cross,
                       torch.zeros_like(cross)), valid


def _project(xyz: torch.Tensor, w2c: torch.Tensor,
             intrinsic: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(camera coordinates [.., 4], pixel coordinates [.., 3]; a zero depth
    divides by one)."""
    ones = torch.ones_like(xyz[..., :1])
    cam = torch.cat([xyz, ones], dim=-1) @ w2c.T
    z = torch.where(cam[..., 2:3] == 0, torch.ones_like(cam[..., 2:3]),
                    cam[..., 2:3])
    return cam, (cam[..., :3] / z) @ intrinsic.T


def fg_pixel_mask(points_xyz: torch.Tensor, live_mask: torch.Tensor,
                  w2c: torch.Tensor, intrinsic: torch.Tensor,
                  H: int, W: int) -> torch.Tensor:
    """[H, W] float mask of the pixels that live points in front of the
    camera cover in one view: each point projected, ceil(pixel) set to 1
    (a scatter-max; out-of-range points go to slot H * W, dropped)."""
    cam, xy = _project(points_xyz, w2c, intrinsic)
    px = torch.ceil(xy[..., 0]).to(torch.int64)
    py = torch.ceil(xy[..., 1]).to(torch.int64)
    ok = (live_mask & (cam[..., 2] > 0) & (px >= 0) & (px <= W - 1)
          & (py >= 0) & (py <= H - 1))
    idx = torch.where(ok, py * W + px, torch.full_like(px, H * W))
    flat = torch.zeros(H * W + 1, dtype=torch.float32,
                       device=points_xyz.device)
    flat.scatter_reduce_(0, idx, torch.ones_like(idx, dtype=torch.float32),
                         reduce="amax")
    return flat[:H * W].reshape(H, W)


def bg_ray_colors(xyz_world: torch.Tensor, cross_valid: torch.Tensor,
                  images: torch.Tensor, w2cs: torch.Tensor,
                  intrinsic: torch.Tensor, plane_color: torch.Tensor,
                  fg_masks: Optional[torch.Tensor] = None,
                  thresh: float = 0.03) -> torch.Tensor:
    """Per-ray background colour [R, 3] from the plane crossings
    xyz_world [R, 3]: in each view of images [V, H, W, 3] (w2cs [V, 4, 4],
    intrinsic [3, 3]) the crossing's bilinear colour, zero off the image,
    off the plane, or (with fg_masks [V, H, W]) where ceil(pixel) is
    covered by foreground; then colours outside plane_color +- thresh are
    zeroed, and the maximum over the views taken."""
    V, H, W, _ = images.shape
    colors = []
    for v in range(V):
        _, xy = _project(xyz_world, w2cs[v], intrinsic)
        xy = xy[..., :2]
        m = ((xy[..., 0] >= 0) & (xy[..., 0] <= W - 1)
             & (xy[..., 1] >= 0) & (xy[..., 1] <= H - 1)) & cross_valid
        if fg_masks is not None:
            cx = torch.clamp(torch.ceil(xy[..., 0]).to(torch.int64), 0, W - 1)
            cy = torch.clamp(torch.ceil(xy[..., 1]).to(torch.int64), 0, H - 1)
            m = m & (fg_masks[v][cy, cx] < 1)
        colors.append(bilinear_sample(images[v], xy)
                      * m[..., None].to(images.dtype))
    colors = torch.stack(colors)                                  # [V, R, 3]
    fit = torch.all((colors >= plane_color - thresh)
                    & (colors <= plane_color + thresh), dim=-1)
    colors = colors * fit[..., None].to(colors.dtype)
    return torch.max(colors, dim=0).values


def compute_bg_ray(campos: torch.Tensor, raydir: torch.Tensor,
                   plane_pnt: torch.Tensor, plane_normal: torch.Tensor,
                   plane_color: torch.Tensor, images: torch.Tensor,
                   w2cs: torch.Tensor, intrinsic: torch.Tensor,
                   points_xyz: torch.Tensor, points_mask: torch.Tensor
                   ) -> torch.Tensor:
    """The plane crossings, each view's foreground splat and the
    per-ray background colours [R, 3] of a ray batch (reference
    run/train_ft.py:611-615 create_all_bg)."""
    xyz, valid = ray_plane_cross(campos, raydir, plane_pnt, plane_normal)
    H, W = images.shape[1], images.shape[2]
    fg = torch.stack([fg_pixel_mask(points_xyz, points_mask, w2c, intrinsic,
                                    H, W) for w2c in w2cs])
    return bg_ray_colors(xyz, valid, images, w2cs, intrinsic, plane_color,
                         fg_masks=fg)
