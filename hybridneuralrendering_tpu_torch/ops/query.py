"""Ray -> shading point -> neighbour point query over a PointGrid
(JAX: hybridneuralrendering_tpu/ops/query.py).

All R rays stay in the batch; rays that miss are masked (`ray_mask`).  Each
ray keeps its first SR candidates inside the dilated occupancy, and each of
those shading points its K nearest grid points within the radius limit:
from one supervoxel bucket of Ps candidates (`supervoxel`, the default), or
from the P-point buckets of the kernel_size voxels around it (the
per-voxel path, the reference querier's own search).  Both end in the K-min
select (ops/select.k_smallest).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hybridneuralrendering_tpu_torch.config import QuerierConfig
from hybridneuralrendering_tpu_torch.core import rays as ray_gen
from hybridneuralrendering_tpu_torch.ops.select import BIG, k_smallest
from hybridneuralrendering_tpu_torch.ops.voxel_grid import (
    PointGrid, linearize, linearize_padz, voxel_coords)


def _get_fill(table: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """table[idx] with `fill` where idx lies outside the table (JAX's gather
    mode="fill")."""
    inb = (idx >= 0) & (idx < table.shape[0])
    vals = table[torch.where(inb, idx, 0)]
    return torch.where(inb, vals, torch.full_like(vals, fill))


def _knn_supervoxel(grid: PointGrid, sample_loc: torch.Tensor,
                    sample_mask: torch.Tensor, cfg: QuerierConfig):
    """K nearest points of each shading sample [R, SR, 3]: one coor2node
    lookup, one packed bucket row of Ps candidates, then the K-min select
    (ops/select.py).  Returns (best_d2 [R, SR, K], BIG in empty slots,
    best_pid [R, SR, K])."""
    R, SR, _ = sample_loc.shape
    K, Ps = cfg.K, cfg.Ps
    radius2 = float(np.float32(cfg.radius_limit ** 2)) \
        if cfg.radius_limit > 0 else 1e18
    loc_s = sample_loc.reshape(R * SR, 3)
    vid = linearize(voxel_coords(loc_s, grid.geom), grid.geom,
                    cfg.grid_capacity)
    node = _get_fill(grid.coor2node, vid, -1)
    valid_node = (node >= 0)[:, None]
    bucket = grid.node_bucket[torch.where(valid_node[:, 0], node, 0).long()]
    px = bucket[:, 0 * Ps:1 * Ps]
    py = bucket[:, 1 * Ps:2 * Ps]
    pz = bucket[:, 2 * Ps:3 * Ps]
    pids = bucket[:, 3 * Ps:4 * Ps].contiguous().view(torch.int32)
    pids = torch.where(valid_node, pids, -1).to(torch.int32)
    d2 = ((px - loc_s[:, 0:1]) ** 2 + (py - loc_s[:, 1:2]) ** 2
          + (pz - loc_s[:, 2:3]) ** 2)
    d2 = torch.where((d2 <= radius2) & valid_node, d2, BIG)
    best_d, best_i = k_smallest(d2.contiguous(), pids.contiguous(), K)
    return best_d.reshape(R, SR, K), best_i.reshape(R, SR, K)


def _window_gather_1d(table: torch.Tensor, starts: torch.Tensor, w: int,
                      fill) -> torch.Tensor:
    """Windows table[s:s+w] [..., w] of a 1-D table at starts [...]; a
    window that starts below 0 or runs past the table's end, even partly,
    is `fill` throughout (JAX's windowed gather in mode FILL_OR_DROP)."""
    ok = (starts >= 0) & (starts <= table.shape[0] - w)
    idx = torch.where(ok, starts, 0)[..., None] + torch.arange(
        w, device=starts.device)
    return torch.where(ok[..., None], table[idx],
                       torch.full((), fill, dtype=table.dtype,
                                  device=table.device))


def _knn_per_voxel(grid: PointGrid, sample_loc: torch.Tensor,
                   sample_mask: torch.Tensor, cfg: QuerierConfig):
    """K nearest points of each shading sample [R, SR, 3] over the P-point
    buckets of its kernel_size voxel neighbourhood.  In coor2occ's z-padded
    layout each xy offset's kz voxels are one window; each occupied voxel
    gives one packed bucket row [x|y|z|pid].  The xy offsets go in three
    chunks, which bound the [S, q*kz, BW] bucket gathers; the K smallest of
    the C = kx*ky*kz*P candidates come from the K-min select.  Returns
    (best_d2 [R, SR, K], BIG in empty slots, best_pid [R, SR, K])."""
    R, SR, _ = sample_loc.shape
    K, P = cfg.K, cfg.P
    cap = cfg.grid_capacity
    radius2 = float(np.float32(cfg.radius_limit ** 2)) \
        if cfg.radius_limit > 0 else 1e18
    S = R * SR
    loc_s = sample_loc.reshape(S, 3)
    svox = voxel_coords(loc_s, grid.geom)                     # [S, 3]
    kx, ky, kz = cfg.kernel_size
    xy_offsets = [(dx, dy)
                  for dx in range(-(kx // 2), (kx + 1) // 2)
                  for dy in range(-(ky // 2), (ky + 1) // 2)]
    chunk_xy = max(len(xy_offsets) // 3, 1)
    last = grid.occ_bucket.shape[0] - 1
    lx, ly, lz = (loc_s[:, None, None, a] for a in range(3))
    d2_parts, pid_parts = [], []
    for c0 in range(0, len(xy_offsets), chunk_xy):
        offs = torch.as_tensor(
            [[dx, dy, -(kz // 2)] for dx, dy in xy_offsets[c0:c0 + chunk_xy]],
            device=svox.device)                               # [q, 3]
        starts = linearize_padz(svox[:, None, :] + offs, grid.geom, cap)
        occ = _window_gather_1d(grid.coor2occ, starts, kz, -1).reshape(
            S, -1)                                            # [S, q*kz]
        valid_vox = (occ >= 0)[..., None]
        bucket = grid.occ_bucket[torch.where(occ >= 0, occ, last).long()]
        px = bucket[..., 0 * P:1 * P]                         # [S, q*kz, P]
        py = bucket[..., 1 * P:2 * P]
        pz = bucket[..., 2 * P:3 * P]
        pids = bucket[..., 3 * P:4 * P].contiguous().view(torch.int32)
        pids = torch.where(valid_vox, pids, -1)
        d2 = (px - lx) ** 2 + (py - ly) ** 2 + (pz - lz) ** 2
        d2 = torch.where((d2 <= radius2) & valid_vox, d2, BIG)
        d2_parts.append(d2.reshape(S, -1))
        pid_parts.append(pids.reshape(S, -1))
    cand_d = torch.cat(d2_parts, dim=-1)                      # [S, C]
    cand_i = torch.cat(pid_parts, dim=-1)
    del d2_parts, pid_parts
    best_d, best_i = k_smallest(cand_d, cand_i, K)
    return best_d.reshape(R, SR, K), best_i.reshape(R, SR, K)


def knn_over_grid(grid: PointGrid, sample_loc: torch.Tensor,
                  sample_mask: torch.Tensor, cfg: QuerierConfig):
    """The supervoxel K-NN where the grid has its tables, else the
    per-voxel one."""
    if cfg.supervoxel and grid.node_bucket is not None:
        return _knn_supervoxel(grid, sample_loc, sample_mask, cfg)
    return _knn_per_voxel(grid, sample_loc, sample_mask, cfg)


class QueryResult(NamedTuple):
    sample_pidx: torch.Tensor   # [R, SR, K] i32 point ids, -1 = empty
    sample_loc_w: torch.Tensor  # [R, SR, 3] world-space shading locations
    sample_mask: torch.Tensor   # [R, SR] bool, shading point exists
    ray_mask: torch.Tensor      # [R] bool, ray has a point with neighbours
    pnt_mask: torch.Tensor      # [R, SR, K] bool, neighbour slot valid


def query_points(grid: PointGrid, xyz: torch.Tensor, campos: torch.Tensor,
                 raydir: torch.Tensor, cfg: QuerierConfig, near: float,
                 far: float, noise: Optional[torch.Tensor] = None,
                 train: bool = False) -> QueryResult:
    """Query for one camera at campos [3] with rays raydir [R, 3].  `noise`
    [R, z_depth_dim] in [0, 1) jitters the candidates when `train`."""
    D, SR = cfg.z_depth_dim, cfg.SR
    cap = cfg.grid_capacity

    # 1. candidate samples along the rays
    jitter = cfg.sample_jitter if train else 0.0
    gen = (ray_gen.near_far_disparity_linear if cfg.sample_mode == "disparity"
           else ray_gen.near_far_linear)
    raypos, _, tvals = gen(campos, raydir, D, near, far, jitter, noise)

    # 2. cull candidates by the bit-packed dilated occupancy
    cand_vid = linearize(voxel_coords(raypos, grid.geom), grid.geom, cap)
    word = _get_fill(grid.occ_bits, cand_vid >> 5, 0).to(torch.int64)
    occ_hit = ((word >> (cand_vid & 31)) & 1) > 0                # [R, D]

    # 3. keep the first SR hits of each ray: hit s is the first candidate
    #    whose running hit count reaches s+1 (the JAX package's one-hot
    #    reduction picks the same candidate)
    cum = torch.cumsum(occ_hit, dim=-1)                          # [R, D]
    targets = torch.arange(1, SR + 1, device=raydir.device)
    first = torch.searchsorted(cum, targets.expand(cum.shape[0], SR)
                               .contiguous())                    # [R, SR]
    sample_mask = first < D
    t_sel = torch.gather(tvals, 1, first.clamp(max=D - 1))
    # empty slots keep the last candidate, a finite point on the ray
    t_sel = torch.where(sample_mask, t_sel, tvals[:, -1:])
    sample_loc_w = campos[None, None, :] + \
        raydir[:, None, :] * t_sel[..., None]                    # [R, SR, 3]

    # 4. K nearest points around each shading point
    best_d, best_i = knn_over_grid(grid, sample_loc_w, sample_mask, cfg)
    pnt_mask = (best_d < 1e29) & sample_mask[..., None]
    sample_pidx = torch.where(pnt_mask, best_i, -1).to(torch.int32)

    # 5. a ray keeps its mask only if a shading point found neighbours
    ray_mask = pnt_mask.any(dim=2).any(dim=1)
    return QueryResult(sample_pidx=sample_pidx, sample_loc_w=sample_loc_w,
                       sample_mask=sample_mask, ray_mask=ray_mask,
                       pnt_mask=pnt_mask)
