"""Deterministic voxel-grid construction over the neural point cloud
(JAX: hybridneuralrendering_tpu/ops/voxel_grid.py).

The tables are built with a stable sort and segment arithmetic, so they are
deterministic and equal to the JAX package's bit for bit:
  - coor2occ    [grid_capacity] i32: z-padded linear voxel id -> occupied
    voxel index, or -1;
  - occ_pnts    [max_o, P] i32: the first P point ids of each occupied voxel;
  - occ_dilated [grid_capacity] i8: occupancy dilated by query_size, and its
    bit-packed form occ_bits [ceil(grid_capacity/32)] i32 (bit v&31 of word
    v>>5) that the ray-sample cull reads;
  - coor2node / node_bucket: the supervoxel tables, one packed bucket of
    every point of a voxel's kernel_size neighbourhood.

JAX's `.at[].set(mode="drop")` drops out-of-range indices silently; torch
raises on them, so every scatter here masks its indices first.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from hybridneuralrendering_tpu_torch.config import QuerierConfig
from hybridneuralrendering_tpu_torch.device import resolve
from hybridneuralrendering_tpu_torch.ops.scan import cumsum_rows

# coordinate of empty bucket slots: its distance overflows any radius limit
XYZ_SENTINEL = 1e9


class GridGeometry(NamedTuple):
    origin: torch.Tensor          # [3] f32, world coords of voxel (0,0,0)
    dims: Tuple[int, int, int]    # voxels per axis
    vsize: torch.Tensor           # [3] f32, scaled (query) voxel size


class PointGrid(NamedTuple):
    geom: GridGeometry
    coor2occ: torch.Tensor        # [grid_capacity] i32, -1 = empty
    occ_dilated: torch.Tensor     # [grid_capacity] i8
    occ_pnts: torch.Tensor        # [max_o, P] i32, -1 = empty slot
    occ_pnt_xyz: torch.Tensor     # [max_o, P, 3] f32, sentinel when empty
    occ_bucket: torch.Tensor      # [max_o, BW] f32 planar x|y|z|pid|pad
    occ_numpnts: torch.Tensor     # [max_o] i32
    num_occ: torch.Tensor         # [] i64
    coor2node: Optional[torch.Tensor] = None    # [grid_capacity] i32
    node_bucket: Optional[torch.Tensor] = None  # [max_nodes, BWs] f32
    num_nodes: Optional[torch.Tensor] = None    # [] i64
    occ_bits: Optional[torch.Tensor] = None     # [ceil(cap/32)] i32


def bucket_width(P: int) -> int:
    """Packed bucket row width: 4 planes of P floats, rounded up to 128."""
    return -(-(4 * P) // 128) * 128


def compute_grid_geometry(xyz: np.ndarray, point_mask: np.ndarray,
                          cfg: QuerierConfig, device="cuda") -> GridGeometry:
    """AABB of the live points clipped to cfg.ranges, padded by half the
    dilation kernel; dims = ceil(extent / vsize / vscale).  Host numpy; the
    origin and voxel size land on `device` (the card unless the caller asks
    for the CPU).  Raises if the z-padded grid exceeds cfg.grid_capacity."""
    device = resolve(device)
    xyz = np.asarray(xyz)
    mask = np.asarray(point_mask).astype(bool)
    if mask.any():
        pts = xyz[mask]
        mn, mx = pts.min(axis=0), pts.max(axis=0)
    else:
        mn = np.asarray(cfg.ranges[:3], np.float32)
        mx = np.asarray(cfg.ranges[3:], np.float32)
    mn = np.maximum(mn, np.asarray(cfg.ranges[:3]))
    mx = np.minimum(mx, np.asarray(cfg.ranges[3:]))
    svsize = np.asarray(cfg.query_vsize, np.float32)
    pad = svsize * np.asarray(cfg.kernel_size, np.float32) / 2.0
    mn = mn.astype(np.float32) - pad
    mx = mx.astype(np.float32) + pad
    vdim = (mx - mn) / np.asarray(cfg.vsize, np.float32)
    dims = np.ceil(vdim / np.asarray(cfg.vscale, np.float32)).astype(np.int32)
    dims = np.maximum(dims, 1)
    total = int(dims[0]) * int(dims[1]) * (int(dims[2]) + 2)
    if total > cfg.grid_capacity:
        raise ValueError(
            f"voxel grid {tuple(dims)} = {total} z-padded voxels exceeds "
            f"grid_capacity={cfg.grid_capacity}; enlarge capacity or vsize")
    return GridGeometry(
        origin=torch.as_tensor(mn, dtype=torch.float32, device=device),
        dims=tuple(int(d) for d in dims),
        vsize=torch.as_tensor(svsize, dtype=torch.float32, device=device))


def voxel_coords(xyz: torch.Tensor, geom: GridGeometry) -> torch.Tensor:
    """World position -> integer voxel coords [..., 3] (may be out of
    bounds)."""
    return torch.floor((xyz - geom.origin) / geom.vsize).to(torch.int64)


def linearize(coords: torch.Tensor, geom: GridGeometry,
              capacity: int) -> torch.Tensor:
    """Voxel coords -> linear id; out of bounds -> `capacity`."""
    d0, d1, d2 = geom.dims
    inb = ((coords[..., 0] >= 0) & (coords[..., 0] < d0)
           & (coords[..., 1] >= 0) & (coords[..., 1] < d1)
           & (coords[..., 2] >= 0) & (coords[..., 2] < d2))
    lin = (coords[..., 0] * d1 + coords[..., 1]) * d2 + coords[..., 2]
    return torch.where(inb, lin, capacity)


def linearize_padz(coords: torch.Tensor, geom: GridGeometry,
                   capacity: int) -> torch.Tensor:
    """Voxel coords -> linear id in coor2occ's z-padded layout: one pad
    slot at each end of every z column (stride d2+2, offset +1), so the
    3-wide z window around any in-bounds voxel is one contiguous slice.
    z may lie in [-1, d2]; x or y out of bounds, or z beyond that ->
    `capacity`."""
    d0, d1, d2 = geom.dims
    inb = ((coords[..., 0] >= 0) & (coords[..., 0] < d0)
           & (coords[..., 1] >= 0) & (coords[..., 1] < d1)
           & (coords[..., 2] >= -1) & (coords[..., 2] <= d2))
    lin = ((coords[..., 0] * d1 + coords[..., 1]) * (d2 + 2)
           + coords[..., 2] + 1)
    return torch.where(inb, lin, capacity)


def neighbor_offsets(size3) -> np.ndarray:
    """Integer offsets of a centred size3 window: [-s//2, (s+1)//2) per
    axis, x slowest."""
    axes = [np.arange(-(s // 2), (s + 1) // 2) for s in size3]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).astype(np.int64)


def _set_drop(target: torch.Tensor, idx, values) -> None:
    """target[idx] = values, skipping indices outside target's first axis
    (JAX's scatter mode="drop").  idx is one index tensor or a tuple of
    them, one per leading axis."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    keep = torch.ones_like(idx[0], dtype=torch.bool)
    for ax, ix in enumerate(idx):
        keep &= (ix >= 0) & (ix < target.shape[ax])
    if torch.is_tensor(values) and values.dim() > 0:
        values = values[keep]
    target[tuple(ix[keep] for ix in idx)] = values


def _segments(keys: torch.Tensor, cap: int):
    """Stable sort of linear ids -> (sorted ids, source positions, head
    flags, segment index, rank within segment) for the live (< cap) ids.
    The segment index is the int32 rank scan of the head flags (the
    cumsum_rows kernel on the card)."""
    skeys, order = torch.sort(keys, stable=True)
    valid = skeys < cap
    head = torch.cat([valid[:1], (skeys[1:] != skeys[:-1]) & valid[1:]])
    seg_idx = cumsum_rows(head.to(torch.int32)).long() - 1
    pos = torch.arange(keys.shape[0], device=keys.device)
    seg_start = torch.cummax(torch.where(head, pos, -1), dim=0).values
    return skeys, order, valid, head, seg_idx, pos - seg_start


def _pack_bits(occ: torch.Tensor) -> torch.Tensor:
    """[cap] 0/1 int8 -> [ceil(cap/32)] i32 with bit v&31 of word v>>5."""
    cap = occ.shape[0]
    cap32 = -(-cap // 32) * 32
    od = torch.cat([occ, occ.new_zeros(cap32 - cap)]).to(torch.int64)
    shifts = torch.arange(32, device=occ.device)
    words = torch.sum(od.reshape(-1, 32) << shifts, dim=1)
    # two's-complement wrap into int32, as the JAX int32 sum gives
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _build_supervoxel(xyz: torch.Tensor, point_mask: torch.Tensor,
                      coords: torch.Tensor, geom: GridGeometry,
                      cfg: QuerierConfig):
    """Supervoxel tables: every point goes to the |kernel_size| voxels whose
    window holds it (reflected offsets); the (voxel, point) pairs sort by
    voxel and fill one bucket of at most Ps points per node."""
    N = xyz.shape[0]
    cap, Ps, max_nodes = cfg.grid_capacity, cfg.Ps, cfg.max_nodes
    dev = xyz.device
    offs = torch.as_tensor(-neighbor_offsets(cfg.kernel_size), device=dev)
    dest = coords[None, :, :] + offs[:, None, :]                # [Q, N, 3]
    dvid = linearize(dest, geom, cap)
    dvid = torch.where(point_mask[None, :], dvid, cap).reshape(-1)

    sdv, order, valid, head, node_idx, rank = _segments(dvid, cap)
    num_nodes = head.sum()
    in_cap = valid & (node_idx < max_nodes)
    src_pid = order % N
    keep = in_cap & (rank < Ps)
    kn, kr, kp = node_idx[keep], rank[keep], src_pid[keep]

    BWs = bucket_width(Ps)
    node_bucket = torch.zeros((max_nodes, BWs), dtype=torch.float32,
                              device=dev)
    node_bucket[:, :3 * Ps] = XYZ_SENTINEL
    sxyz = xyz[kp].to(torch.float32)
    for a in range(3):
        node_bucket[kn, a * Ps + kr] = sxyz[:, a]
    node_pid = torch.full((max_nodes, Ps), -1, dtype=torch.int32, device=dev)
    node_pid[kn, kr] = kp.to(torch.int32)
    node_bucket[:, 3 * Ps:4 * Ps] = node_pid.view(torch.float32)

    coor2node = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    first = head & in_cap
    _set_drop(coor2node, sdv[first], node_idx[first].to(torch.int32))
    return coor2node, node_bucket, torch.clamp(num_nodes, max=max_nodes)


def build_grid(xyz: torch.Tensor, point_mask: torch.Tensor,
               geom: GridGeometry, cfg: QuerierConfig) -> PointGrid:
    """All query tables from the live point cloud xyz [N, 3] (padded
    capacity) with point_mask [N] bool.  Points sort stably by (voxel id,
    point id); the first P of each voxel fill its bucket."""
    cap, max_o, P = cfg.grid_capacity, cfg.max_o, cfg.P
    dev = xyz.device
    d0, d1, d2 = geom.dims

    coords = voxel_coords(xyz, geom)
    vid = torch.where(point_mask, linearize(coords, geom, cap), cap)
    svid, spid, valid, head, occ_idx, rank = _segments(vid, cap)
    num_occ = head.sum()
    in_cap = valid & (occ_idx < max_o)
    first = head & in_cap

    # coor2occ in the z-padded layout (linearize_padz)
    coor2occ = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    _set_drop(coor2occ, linearize_padz(coords[spid[first]], geom, cap),
              occ_idx[first].to(torch.int32))

    keep = in_cap & (rank < P)
    ko, kr, kp = occ_idx[keep], rank[keep], spid[keep]
    occ_pnts = torch.full((max_o, P), -1, dtype=torch.int32, device=dev)
    occ_pnts[ko, kr] = kp.to(torch.int32)
    occ_pnt_xyz = torch.full((max_o, P, 3), XYZ_SENTINEL,
                             dtype=torch.float32, device=dev)
    occ_pnt_xyz[ko, kr] = xyz[kp].to(torch.float32)
    occ_numpnts = torch.bincount(ko, minlength=max_o).to(torch.int32)

    # coords of each occupied voxel, then dilation by query_size
    occ_vid = torch.full((max_o,), cap, dtype=torch.int64, device=dev)
    occ_vid[occ_idx[first]] = svid[first]
    occ_coords = torch.stack(
        [occ_vid // (d1 * d2), (occ_vid // d2) % d1, occ_vid % d2], dim=-1)
    occ_live = occ_vid < cap
    offsets = torch.as_tensor(neighbor_offsets(cfg.query_size), device=dev)
    nb_lin = linearize(occ_coords[None, :, :] + offsets[:, None, :], geom,
                       cap)
    nb_lin = torch.where(occ_live[None, :], nb_lin, cap)
    occ_dilated = torch.zeros((cap,), dtype=torch.int8, device=dev)
    _set_drop(occ_dilated, nb_lin.reshape(-1), 1)
    occ_bits = _pack_bits(occ_dilated)

    BW = bucket_width(P)
    occ_bucket = torch.cat([
        occ_pnt_xyz[..., 0], occ_pnt_xyz[..., 1], occ_pnt_xyz[..., 2],
        occ_pnts.view(torch.float32),
        torch.zeros((max_o, BW - 4 * P), dtype=torch.float32, device=dev)],
        dim=-1)

    coor2node = node_bucket = num_nodes = None
    if cfg.supervoxel:
        coor2node, node_bucket, num_nodes = _build_supervoxel(
            xyz, point_mask, coords, geom, cfg)

    return PointGrid(
        geom=geom, coor2occ=coor2occ, occ_dilated=occ_dilated,
        occ_pnts=occ_pnts, occ_pnt_xyz=occ_pnt_xyz, occ_bucket=occ_bucket,
        occ_numpnts=occ_numpnts, num_occ=torch.clamp(num_occ, max=max_o),
        coor2node=coor2node, node_bucket=node_bucket, num_nodes=num_nodes,
        occ_bits=occ_bits)


def grid_of(xyz: torch.Tensor, point_mask: torch.Tensor,
            cfg: QuerierConfig) -> PointGrid:
    """The query grid of the live points: the geometry from host copies of
    xyz [N, 3] and point_mask [N], the tables built on xyz's device."""
    geom = compute_grid_geometry(xyz.cpu().numpy(), point_mask.cpu().numpy(),
                                 cfg, device=xyz.device)
    return build_grid(xyz, point_mask, geom, cfg)
