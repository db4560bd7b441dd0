"""The perspective-space querier (JAX: hybridneuralrendering_tpu/ops/
query_pers.py; the reference querier's `wcoord_query=0` mode).

The voxel grid lives in one camera's frustum coordinates (x/z, y/z, z), so
it is rebuilt for every camera: the world-space grid build
(ops/voxel_grid.build_grid) and K-NN (ops/query.knn_over_grid) run
unchanged over perspective coordinates.  The frustum spans x/z in
[-cx/fx, (W-cx)/fx], y/z in [-cy/fy, (H-cy)/fy] and z in [near, far],
padded by half the dilation kernel, in voxels of cfg.query_vsize (those
units).  Training may jitter the shading locations along z
(`shpnt_jitter`).

Perspective coordinates are computed here by elementwise products and
sums in a fixed order rather than a matmul: each is then the same float32
on the card and on the CPU, so a point or a sample falls in the same voxel
on both.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hybridneuralrendering_tpu_torch.config import QuerierConfig
from hybridneuralrendering_tpu_torch.core import rays as ray_gen
from hybridneuralrendering_tpu_torch.core.cameras import pers2w
from hybridneuralrendering_tpu_torch.device import resolve
from hybridneuralrendering_tpu_torch.ops import query as Q
from hybridneuralrendering_tpu_torch.ops import voxel_grid as VG

SHPNT_JITTERS = ("passfunc", "gaussian", "uniform")


def to_pers(xyz_w: torch.Tensor, camrotc2w: torch.Tensor,
            campos: torch.Tensor) -> torch.Tensor:
    """World points [..., 3] -> (x/z, y/z, z) of the camera: core/cameras.
    w2pers with the rotation's dot products written out, so that every
    device rounds them alike."""
    s = xyz_w - campos
    c = [s[..., 0] * camrotc2w[0, j] + s[..., 1] * camrotc2w[1, j]
         + s[..., 2] * camrotc2w[2, j] for j in range(3)]
    return torch.stack([c[0] / c[2], c[1] / c[2], c[2]], dim=-1)


def frustum_geometry(intrinsic: np.ndarray, h: int, w: int, near: float,
                     far: float, cfg: QuerierConfig,
                     device="cuda") -> VG.GridGeometry:
    """The frustum grid's frame for a camera of `intrinsic` [3, 3] and
    h x w pixels; origin and voxel size on `device` (the card unless the
    caller asks for the CPU).  Raises if the z-padded grid exceeds
    cfg.grid_capacity."""
    dev = resolve(device)
    intrinsic = np.asarray(intrinsic)
    fx, fy = float(intrinsic[0, 0]), float(intrinsic[1, 1])
    cx, cy = float(intrinsic[0, 2]), float(intrinsic[1, 2])
    mn = np.asarray([-cx / fx, -cy / fy, near], np.float32)
    mx = np.asarray([(w - cx) / fx, (h - cy) / fy, far], np.float32)
    svsize = np.asarray(cfg.query_vsize, np.float32)
    pad = svsize * np.asarray(cfg.kernel_size, np.float32) / 2.0
    mn -= pad
    mx += pad
    dims = np.maximum(np.ceil((mx - mn) / svsize).astype(np.int32), 1)
    total = int(dims[0]) * int(dims[1]) * (int(dims[2]) + 2)
    if total > cfg.grid_capacity:
        raise ValueError(
            f"frustum grid {tuple(int(d) for d in dims)} exceeds capacity "
            f"{cfg.grid_capacity}")
    return VG.GridGeometry(
        origin=torch.as_tensor(mn, dtype=torch.float32, device=dev),
        dims=tuple(int(d) for d in dims),
        vsize=torch.as_tensor(svsize, dtype=torch.float32, device=dev))


def build_frustum_grid(xyz_w: torch.Tensor, point_mask: torch.Tensor,
                       camrotc2w: torch.Tensor, campos: torch.Tensor,
                       geom: VG.GridGeometry,
                       cfg: QuerierConfig) -> VG.PointGrid:
    """The query tables of the live points xyz_w [N, 3] in this camera's
    perspective coordinates.  Points at z <= 1e-6 (behind the camera) are
    masked out; those outside the frustum fall outside the grid."""
    xyz_pers = to_pers(xyz_w, camrotc2w, campos)
    mask = point_mask & (xyz_pers[..., 2] > 1e-6)
    return VG.build_grid(xyz_pers, mask, geom, cfg)


def query_points_pers(grid: VG.PointGrid, xyz_w: torch.Tensor,
                      camrotc2w: torch.Tensor, campos: torch.Tensor,
                      raydir: torch.Tensor, cfg: QuerierConfig, near: float,
                      far: float, train: bool = False,
                      shpnt_jitter: str = "passfunc",
                      noise: Optional[torch.Tensor] = None,
                      shpnt_noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Q.QueryResult:
    """Query rays raydir [R, 3] of the camera at campos [3] in its
    frustum grid; the K-NN distances are perspective-space and the
    returned shading locations world-space.

    Candidates are uniform in depth (core/rays.near_far_linear).  In
    training the candidates take `noise` [R, z_depth_dim] in [0, 1) and,
    unless shpnt_jitter is "passfunc", the shading points move along z by
    `shpnt_noise` [R, SR] * vsize_z ("gaussian": standard normal draws) or
    (shpnt_noise - 0.5) * vsize_z ("uniform": draws in [0, 1)); either
    missing one is drawn from `generator`, and without a generator that
    jitter is off (the JAX package's key=None)."""
    if shpnt_jitter not in SHPNT_JITTERS:
        raise ValueError(f"shpnt_jitter {shpnt_jitter!r} not in "
                         f"{SHPNT_JITTERS}")
    R = raydir.shape[0]
    D, SR = cfg.z_depth_dim, cfg.SR
    dev = raydir.device

    def draw(given, shape, normal):
        if given is not None or generator is None:
            return given
        fn = torch.randn if normal else torch.rand
        return fn(shape, generator=generator, device=generator.device).to(dev)

    jitter = cfg.sample_jitter if train else 0.0
    if train:
        noise = draw(noise, (R, D), False)
    raypos_w, _, _ = ray_gen.near_far_linear(campos, raydir, D, near, far,
                                             jitter, noise)
    raypos = to_pers(raypos_w, camrotc2w, campos)               # [R, D, 3]

    cand_vid = VG.linearize(VG.voxel_coords(raypos, grid.geom), grid.geom,
                            cfg.grid_capacity)
    word = Q._get_fill(grid.occ_bits, cand_vid >> 5, 0).to(torch.int64)
    occ_hit = ((word >> (cand_vid & 31)) & 1) > 0               # [R, D]

    # hit s is the first candidate whose running hit count reaches s+1
    cum = torch.cumsum(occ_hit, dim=-1)
    targets = torch.arange(1, SR + 1, device=dev)
    first = torch.searchsorted(cum, targets.expand(R, SR).contiguous())
    sample_mask = first < D
    # an empty slot keeps the last candidate, finite in frustum coordinates
    idx = first.clamp(max=D - 1)[..., None].expand(R, SR, 3)
    sample_loc = torch.gather(raypos, 1, idx)                   # [R, SR, 3]

    if train and shpnt_jitter != "passfunc":
        dz = draw(shpnt_noise, (R, SR), shpnt_jitter == "gaussian")
        if dz is not None:
            vz = grid.geom.vsize[2]
            dz = dz * vz if shpnt_jitter == "gaussian" else (dz - 0.5) * vz
            sample_loc = torch.cat([sample_loc[..., :2],
                                    sample_loc[..., 2:] + dz[..., None]],
                                   dim=-1)

    best_d, best_i = Q.knn_over_grid(grid, sample_loc, sample_mask, cfg)
    pnt_mask = (best_d < 1e29) & sample_mask[..., None]
    sample_pidx = torch.where(pnt_mask, best_i, -1).to(torch.int32)
    ray_mask = pnt_mask.any(dim=2).any(dim=1)
    return Q.QueryResult(sample_pidx=sample_pidx,
                         sample_loc_w=pers2w(sample_loc, camrotc2w, campos),
                         sample_mask=sample_mask, ray_mask=ray_mask,
                         pnt_mask=pnt_mask)
