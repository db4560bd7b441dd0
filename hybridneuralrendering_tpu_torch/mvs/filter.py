"""Cross-view geometric consistency filtering of depth maps
(JAX: hybridneuralrendering_tpu/mvs/filter.py; reference
models/mvs/filter_utils.py:157-299).

Each reference pixel's depth is projected into a source view, the source
depth is sampled there, reprojected back, and the pixel is consistent
when it lands within 1 px of itself with a relative depth error below
1%.  The reference's boolean compactions are masks of fixed shape.
"""

from __future__ import annotations

from typing import Tuple

import torch

from hybridneuralrendering_tpu_torch.mvs.warp import bilinear_sample


def _pixel_grid(depth: torch.Tensor):
    H, W = depth.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=depth.device),
                            torch.arange(W, device=depth.device),
                            indexing="ij")
    return xs.to(depth.dtype), ys.to(depth.dtype)


def reproject_with_depth(depth_ref: torch.Tensor, k_ref: torch.Tensor,
                         e_ref: torch.Tensor, depth_src: torch.Tensor,
                         k_src: torch.Tensor, e_src: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """reproject_with_depth_gpu (filter_utils.py:157-201).  depth_* [H, W];
    k_* [3, 3] intrinsics; e_* [4, 4] world-to-camera.  Returns (the
    reprojected depth [H, W], the reprojected pixel xy [H, W, 2])."""
    H, W = depth_ref.shape
    xs, ys = _pixel_grid(depth_ref)
    inv = torch.linalg.inv
    pix1 = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    xyz_ref = (pix1 @ inv(k_ref).T) * depth_ref[..., None]
    ones = torch.ones_like(depth_ref[..., None])
    xyz_src = (torch.cat([xyz_ref, ones], -1)
               @ (e_src @ inv(e_ref)).T)[..., :3]
    k_xyz = xyz_src @ k_src.T
    xy_src = k_xyz[..., :2] / k_xyz[..., 2:3]

    sampled = bilinear_sample(depth_src[..., None],
                              xy_src.reshape(-1, 2)).reshape(H, W)
    xyz_src2 = (torch.cat([xy_src, torch.ones_like(sampled[..., None])], -1)
                @ inv(k_src).T) * sampled[..., None]
    xyz_rep = (torch.cat([xyz_src2, ones], -1)
               @ (e_ref @ inv(e_src)).T)[..., :3]
    k_rep = xyz_rep @ k_ref.T
    return xyz_rep[..., 2], k_rep[..., :2] / k_rep[..., 2:3]


def check_geometric_consistency(depth_ref, k_ref, e_ref, depth_src, k_src,
                                e_src) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask [H, W]: reprojection within 1 px and relative depth error
    below 1%; the reprojected depth, zero outside the mask)
    (filter_utils.py:203-220)."""
    xs, ys = _pixel_grid(depth_ref)
    depth_rep, xy_rep = reproject_with_depth(depth_ref, k_ref, e_ref,
                                             depth_src, k_src, e_src)
    dist = torch.sqrt((xy_rep[..., 0] - xs) ** 2 + (xy_rep[..., 1] - ys) ** 2)
    rel = torch.abs(depth_rep - depth_ref) / torch.clamp(depth_ref, min=1e-8)
    mask = (dist < 1.0) & (rel < 0.01)
    return mask, torch.where(mask, depth_rep, torch.zeros_like(depth_rep))


def filter_depths(depths: torch.Tensor, intrinsics: torch.Tensor,
                  extrinsics: torch.Tensor, confidences: torch.Tensor,
                  conf_thresh: float = 0.8, geo_cnsst_num: int = 0):
    """The all-pairs consistency filter (filter_by_masks_gpu, :222-291).
    depths, confidences [V, H, W]; intrinsics [V, 3, 3]; extrinsics
    [V, 4, 4] world-to-camera.  Returns (final mask [V, H, W]: confidence
    above conf_thresh and at least geo_cnsst_num other views consistent
    (the confidence alone for V <= 1); the depth averaged over the view
    and its consistent views [V, H, W]; the count of consistent views
    geo_sum [V, H, W] int32).  A view is not held against itself."""
    V = depths.shape[0]
    masks, avgs, sums = [], [], []
    for ref in range(V):
        geo_sum = torch.zeros(depths.shape[1:], dtype=torch.int32,
                              device=depths.device)
        depth_sum = torch.zeros_like(depths[ref])
        for src in range(V):
            if src == ref:
                continue
            mask, dep = check_geometric_consistency(
                depths[ref], intrinsics[ref], extrinsics[ref], depths[src],
                intrinsics[src], extrinsics[src])
            geo_sum = geo_sum + mask.to(torch.int32)
            depth_sum = depth_sum + dep
        avgs.append((depth_sum + depths[ref]) / (geo_sum + 1))
        final = confidences[ref] > conf_thresh
        if V > 1:
            final = final & (geo_sum >= geo_cnsst_num)
        masks.append(final)
        sums.append(geo_sum)
    return torch.stack(masks), torch.stack(avgs), torch.stack(sums)


def reassign_conf(conf: torch.Tensor, geo_mask_sum: torch.Tensor,
                  geo_cnsst_num: int) -> torch.Tensor:
    """The confidence raised by the count of consistent views
    (filter_utils.py:294-297)."""
    s = torch.clamp(geo_mask_sum - geo_cnsst_num + 1, 1, 10).to(conf.dtype)
    return conf * (1.0 - 1.0 / torch.pow(torch.tensor(
        1.14869, dtype=conf.dtype, device=conf.device), s))
