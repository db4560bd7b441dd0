"""Point-cloud initialization utilities, host-side numpy
(JAX: hybridneuralrendering_tpu/data/point_init.py, a copy).

Ports of the reference's point bootstrap path:
  - depth-map unprojection over all frames
    (the reference's data/scannet_ft_dataset.py:616-647)
  - voxel downsampling keeping the point closest to each occupied voxel's
    centroid (`construct_vox_points_closest`,
    the reference's models/mvs/mvs_utils.py:537-562) and the centroid variant
    (`construct_vox_points_xyz`, :503-518)
  - PLY loading with range clipping (scannet_ft_dataset.py:591-607)

These run once per scene on the host — they gate no training-step shapes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def unproject_depth(depth: np.ndarray, intrinsic: np.ndarray,
                    c2w: np.ndarray, min_d: float = 0.3,
                    max_d: float = 8.0) -> np.ndarray:
    """depth [H, W] (meters) -> world points [M, 3] for valid pixels."""
    h, w = depth.shape
    d = depth.copy()
    d[(d > max_d) | (d < min_d)] = 0
    py, px = np.mgrid[0:h, 0:w].astype(np.float32)
    inv_k = np.linalg.inv(intrinsic)
    cam = np.stack([px * d, py * d, d], axis=-1) @ inv_k.T
    cam = cam[cam[..., 2] > 0]
    cam_h = np.concatenate([cam, np.ones_like(cam[:, :1])], axis=-1)
    return (cam_h @ c2w.T)[:, :3].astype(np.float32)


def _vox_ids(xyz: np.ndarray, vox_res: int,
             space_min: Optional[np.ndarray] = None,
             space_edge: Optional[np.ndarray] = None):
    if space_min is None:
        mn, mx = xyz.min(0), xyz.max(0)
        edge = np.max(mx - mn) * 1.05
        mid = (mx + mn) / 2
        space_min = mid - edge / 2
        space_edge = np.full(3, edge)
    vox_sz = space_edge / vox_res
    ids = np.floor((xyz - space_min) / vox_sz).astype(np.int64)
    key = (ids[:, 0] * (vox_res + 2) + ids[:, 1]) * (vox_res + 2) + ids[:, 2]
    return key


def voxel_downsample_centroid(xyz: np.ndarray, vox_res: int) -> np.ndarray:
    """Mean position per occupied voxel (construct_vox_points_xyz)."""
    key = _vox_ids(xyz, vox_res)
    uniq, inv = np.unique(key, return_inverse=True)
    sums = np.zeros((len(uniq), 3))
    np.add.at(sums, inv, xyz)
    counts = np.bincount(inv, minlength=len(uniq))
    return (sums / counts[:, None]).astype(np.float32)


def voxel_downsample_closest(xyz: np.ndarray, vox_res: int
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Keep, per occupied voxel, the input point nearest the voxel centroid
    (construct_vox_points_closest).  Returns (points, indices-into-xyz)."""
    key = _vox_ids(xyz, vox_res)
    uniq, inv = np.unique(key, return_inverse=True)
    sums = np.zeros((len(uniq), 3))
    np.add.at(sums, inv, xyz)
    counts = np.bincount(inv, minlength=len(uniq))
    centroid = sums / counts[:, None]
    resid = np.linalg.norm(xyz - centroid[inv], axis=-1)
    # argmin residual per voxel: sort by (voxel, residual), keep first
    order = np.lexsort((resid, inv))
    first = np.ones(len(order), bool)
    first[1:] = inv[order][1:] != inv[order][:-1]
    min_idx = order[first]
    return xyz[min_idx].astype(np.float32), min_idx


def clip_to_ranges(xyz: np.ndarray, ranges) -> np.ndarray:
    lo = np.asarray(ranges[:3])
    hi = np.asarray(ranges[3:])
    m = ((xyz >= lo) & (xyz <= hi)).all(axis=-1)
    return xyz[m]


def load_ply_points(path: str, ranges=None) -> np.ndarray:
    """Minimal PLY reader for xyz vertices (ascii or binary_little_endian),
    replacing plydata (scannet_ft_dataset.py:591-607)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n_vert = int(next(l.split()[2] for l in header
                          if l.startswith("element vertex")))
        props = []
        in_vertex = False
        for l in header:
            if l.startswith("element"):
                in_vertex = l.startswith("element vertex")
            elif l.startswith("property") and in_vertex:
                _, typ, name = l.split()[:3]
                props.append((name, typ))
        np_types = {"float": "f4", "float32": "f4", "double": "f8",
                    "uchar": "u1", "uint8": "u1", "int": "i4", "uint": "u4",
                    "short": "i2", "ushort": "u2", "char": "i1"}
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n_vert)
            names = [p[0] for p in props]
            xyz = data[:, [names.index("x"), names.index("y"),
                           names.index("z")]]
        else:
            dtype = np.dtype([(name, "<" + np_types[typ])
                              for name, typ in props])
            data = np.frombuffer(f.read(n_vert * dtype.itemsize), dtype=dtype)
            xyz = np.stack([data["x"], data["y"], data["z"]], axis=-1)
    xyz = xyz.astype(np.float32)
    if ranges is not None and ranges[0] > -99.0:
        xyz = clip_to_ranges(xyz, ranges)
    return xyz
