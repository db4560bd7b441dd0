"""Multi-view geometry of the MVS bootstrap: projections, bilinear
sampling, plane sweeps, depth regression and masks
(JAX: hybridneuralrendering_tpu/mvs/warp.py; reference
models/mvs/mvs_utils.py:299-606 and depth_estimators/module.py:36-99).

torch's grid_sample is the explicit four-tap gather of `bilinear_sample`
(align_corners=True, zeros outside), as in JAX; the reference's boolean
compactions are masks of fixed shape.  Every function is differentiable
where JAX's is: the MVS nets train through the plane sweep, the bilinear
weights and the confidence gather in feed-forward mode (train/step_ff).
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def _homogeneous(xyz: torch.Tensor) -> torch.Tensor:
    return torch.cat([xyz, torch.ones_like(xyz[..., :1])], dim=-1)


def project_to_view(ref_cam_xyz: torch.Tensor, ref_c2w: torch.Tensor,
                    src_w2c: torch.Tensor, intrinsic: torch.Tensor,
                    H: int, W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference-camera points [..., 3] into a source view's pixels
    (homo_warp_nongrid, mvs_utils.py:299-317): xyz1 @ c2w^T @ w2c^T, the
    perspective divide, the intrinsics.  Returns (pixel xy [..., 2], mask
    [...]: inside [0, W-1] x [0, H-1] and in front of the camera)."""
    src_cam = _homogeneous(ref_cam_xyz) @ ref_c2w.T @ src_w2c.T
    xy = ((src_cam[..., :3] / src_cam[..., 2:3]) @ intrinsic.T)[..., :2]
    mask = ((xy[..., 0] >= 0) & (xy[..., 0] <= W - 1)
            & (xy[..., 1] >= 0) & (xy[..., 1] <= H - 1)
            & (src_cam[..., 2] > 0))
    return xy, mask


def plane_sweep_warp(src_feat: torch.Tensor, proj_mat: torch.Tensor,
                     depth_values: torch.Tensor) -> torch.Tensor:
    """A source feature map [H, W, C] warped onto the reference camera's
    fronto-parallel planes at depth_values [D] (homo_warping,
    depth_estimators/module.py:36-71); proj_mat [3, 4] = src_proj @
    ref_proj_inv.  Returns [D, H, W, C], zero where the plane point lies
    behind the source camera."""
    H, W, C = src_feat.shape
    D = depth_values.shape[0]
    dev, dt = src_feat.device, src_feat.dtype
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    grid = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).to(dt)
    R, T = proj_mat[:, :3], proj_mat[:, 3]
    rot = grid @ R.T                                          # [H, W, 3]
    pos = rot[None] * depth_values[:, None, None, None] + T   # [D, H, W, 3]
    valid = pos[..., 2] > 1e-3
    # safe divide: a tap behind the camera must not give inf coordinates,
    # whose cotangents would turn the backward of feed-forward mode NaN
    safe_z = torch.where(valid[..., None], pos[..., 2:3],
                         torch.ones((), dtype=dt, device=dev))
    xy = pos[..., :2] / safe_z
    # the released checkpoint's sampling position: module.py normalises as
    # for align_corners=True while grid_sample samples with
    # align_corners=False, so the tap is x * W / (W - 1) - 0.5 per axis
    scale = torch.tensor([W / max(W - 1, 1), H / max(H - 1, 1)], dtype=dt,
                         device=dev)
    xy = xy * scale - 0.5
    out = bilinear_sample(src_feat, xy.reshape(-1, 2)).reshape(D, H, W, C)
    return out * valid[..., None].to(dt)


def depth_regression(prob: torch.Tensor,
                     depth_values: torch.Tensor) -> torch.Tensor:
    """Expected depth (soft argmin, module.py:73+): prob [D, H, W] over
    depth_values [D] -> [H, W]."""
    return torch.sum(prob * depth_values[:, None, None], dim=0)


def photometric_confidence(prob: torch.Tensor,
                           depth_index: torch.Tensor) -> torch.Tensor:
    """The probability mass of the four bins around the expected bin
    (MVSNet's confidence, depth_estimators/mvsnet.py:120-135): prob
    [D, H, W] summed over a window of 4 along D, padded (1, 2), read at
    the expected bin index depth_index [H, W], truncated to an integer as
    torch's .long() does, and clipped to [0, D - 1]."""
    D = prob.shape[0]
    pad = torch.nn.functional.pad(prob, (0, 0, 0, 0, 1, 2))
    summed = pad[:-3] + pad[1:-2] + pad[2:-1] + pad[3:]       # [D, H, W]
    idx = torch.clamp(depth_index.to(torch.int32), 0, D - 1).to(torch.int64)
    return torch.gather(summed, 0, idx[None])[0]


def occlusion_mask(ref_cam_xyz: torch.Tensor,
                   rel_c2w: Optional[torch.Tensor],
                   src_w2c: Optional[torch.Tensor], intrinsic: torch.Tensor,
                   H: int, W: int, tolerate: float = 0.1) -> torch.Tensor:
    """Z-buffer visibility of reference-camera points [N, 3] in a source
    view (homo_warp_nongrid_occ, mvs_utils.py:333-370).  The points fall
    into pixel buckets ceil(x) * H + ceil(y); per bucket the least camera
    depth wins (a scatter-min); a point is kept when it lands in bounds
    and its depth is within `tolerate` of its bucket's least.  Without
    src_w2c the points are already in the source camera.  Returns [N]
    bool."""
    if src_w2c is not None:
        src_cam = (_homogeneous(ref_cam_xyz) @ rel_c2w.T @ src_w2c.T)[..., :3]
    else:
        src_cam = ref_cam_xyz
    xy = ((src_cam / src_cam[..., 2:3]) @ intrinsic.T)[..., :2]
    cx, cy = torch.ceil(xy[..., 0]), torch.ceil(xy[..., 1])
    inb = ((xy[..., 0] >= 0) & (cx <= W - 1) & (xy[..., 1] >= 0)
           & (cy <= H - 1) & (src_cam[..., 2] > 0))
    hx, hy = cx.to(torch.int32), cy.to(torch.int32)
    idx = torch.where(inb, hx * H + hy, W * H).to(torch.int64)
    inf = torch.full((), float("inf"), dtype=src_cam.dtype,
                     device=src_cam.device)
    z = torch.where(inb, src_cam[..., 2], inf)
    zmin = torch.full((W * H + 1,), float("inf"), dtype=z.dtype,
                      device=z.device).scatter_reduce(0, idx, z, "amin")
    return inb & (src_cam[..., 2] <= zmin[idx] + tolerate)


def alpha_masking(xyz_w: torch.Tensor, alphas: torch.Tensor,
                  intrinsics: torch.Tensor, c2ws: Optional[torch.Tensor],
                  w2cs: torch.Tensor, near_far=None,
                  alpha_range: bool = False) -> torch.Tensor:
    """The visual hull of per-view alpha mattes (mvs_utils.alpha_masking,
    :573-606): a point [N, 3] survives where every view sees alpha > 0.1 at
    the floor of its projection (clipped into the image); with
    `alpha_range` a projection outside the image passes; with near_far
    the camera z must lie in [near - 1, far].  alphas [V, H, W];
    intrinsics [V, 3, 3] or [3, 3]; w2cs [V, 4, 4] (c2ws is unused, as in
    JAX).  Returns [N] bool."""
    V, H, W = alphas.shape
    xyz1 = _homogeneous(xyz_w)
    if intrinsics.dim() == 2:
        intrinsics = intrinsics.expand(V, 3, 3)
    keep = torch.ones(xyz_w.shape[0], dtype=torch.bool, device=xyz_w.device)
    for alpha, k, w2c in zip(alphas, intrinsics, w2cs):
        cam = xyz1 @ w2c.T
        pix = cam[..., :3] @ k.T
        img_xy = torch.floor(pix[:, :2] / pix[:, -1:]).to(torch.int32)
        xc = torch.clamp(img_xy[:, 0], 0, W - 1).long()
        yc = torch.clamp(img_xy[:, 1], 0, H - 1).long()
        a = alpha[yc, xc]
        if alpha_range:
            rng_m = ((img_xy[:, 0] >= 0) & (img_xy[:, 0] < W)
                     & (img_xy[:, 1] >= 0) & (img_xy[:, 1] < H))
            a = a + (~rng_m).to(a.dtype)
        m = a > 0.1
        if near_far is not None:
            m = m & (cam[..., 2] >= near_far[0] - 1.0) \
                & (cam[..., 2] <= near_far[1])
        keep = keep & m
    return keep
