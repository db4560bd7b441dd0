"""Synthetic scene and ray requests at the ScanNet workload's shapes
(JAX: hybridneuralrendering_tpu/data/synthetic.py).

Points lie on six random wall/floor-like planes; rays aim from a camera at
(0, 0, -2.5) into the cloud; the nearest-view stack holds random images.
Everything is drawn from one numpy generator in the JAX package's order, so
a seed gives both packages the same points, attributes and rays; only the
point embeddings differ (the JAX package draws them with jax.random).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hybridneuralrendering_tpu_torch.config import Config
from hybridneuralrendering_tpu_torch.device import resolve
from hybridneuralrendering_tpu_torch.models import neural_points as npts
from hybridneuralrendering_tpu_torch.ops import voxel_grid as VG


def scene_arrays(cfg: Config, num_points: int, seed: int = 0) -> Dict:
    """Host arrays of the synthetic scene: xyz, conf, color, dirs and the
    embedding (normal * 0.1), drawn in that order."""
    rng = np.random.default_rng(seed)
    lo = np.maximum(np.asarray(cfg.querier.ranges[:3]), -3.0)
    hi = np.minimum(np.asarray(cfg.querier.ranges[3:]), 3.0)
    pts = []
    n_planes = 6
    for i in range(n_planes):
        m = num_points // n_planes
        axis = i % 3
        level = rng.uniform(lo[axis], hi[axis])
        p = rng.uniform(lo, hi, (m, 3))
        p[:, axis] = level + rng.normal(0, 0.01, m)
        pts.append(p)
    xyz = np.concatenate(pts)[:num_points].astype(np.float32)
    n = len(xyz)
    return {
        "xyz": xyz,
        "conf": rng.uniform(0.5, 1.0, (n, 1)),
        "color": rng.uniform(0, 1, (n, 3)),
        "dirs": rng.normal(size=(n, 3)),
        "embedding": rng.standard_normal((n, cfg.points.feature_dim)) * 0.1,
    }


def make_synthetic_scene(cfg: Config, num_points: int, seed: int = 0,
                         device="cuda"
                         ) -> Tuple[npts.NeuralPoints, VG.PointGrid]:
    """The synthetic point cloud and its query grid, built on `device`."""
    dev = resolve(device)
    a = scene_arrays(cfg, num_points, seed)
    points = npts.init_from_arrays(
        a["xyz"], cfg.points, embedding=a["embedding"], conf=a["conf"],
        color=a["color"], dirs=a["dirs"], device=dev)
    geom = VG.compute_grid_geometry(a["xyz"], np.ones(len(a["xyz"]), bool),
                                    cfg.querier, device=dev)
    grid = VG.build_grid(points.xyz, points.mask, geom, cfg.querier)
    return points, grid


def batch_arrays(cfg: Config, seed: int = 1,
                 num_rays: Optional[int] = None) -> Dict:
    """Host arrays of one request or training batch: rays aimed into the
    cloud, their ground-truth colours, the frame's loss weight (1.0) and
    the nearest-view stack.  num_rays defaults to the training batch
    size."""
    rng = np.random.default_rng(seed)
    R = num_rays or cfg.sampling.rays_per_batch
    V = max(cfg.agg.use_nearest, 1)
    H, W = cfg.image_hw
    campos = np.array([0.0, 0.0, -2.5], np.float32)
    targets = rng.uniform(-1.0, 1.0, (R, 3)).astype(np.float32)
    dirs = targets - campos
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    intr = np.array([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1]],
                    np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = campos
    batch = {
        "campos": campos,
        "camrotc2w": np.eye(3, dtype=np.float32),
        "raydir": dirs,
        "pixel_idx": rng.integers(0, min(H, W), (R, 2)).astype(np.int32),
        "bg_color": np.ones(3, np.float32),
        "gt_image": rng.uniform(0, 1, (R, 3)).astype(np.float32),
        "frame_weight": np.float32(1.0),
    }
    if cfg.agg.use_nearest > 0:
        batch.update({
            "images_nearest": rng.uniform(0, 1, (V, H, W, 3)).astype(
                np.float32),
            "c2w_nearest": np.stack([c2w] * V),
            "campos_nearest": np.stack([campos] * V),
            "intrinsic_nearest": intr,
            "frame_weight_nearest": np.ones(V, np.float32),
        })
    return batch


def make_synthetic_batch(cfg: Config, seed: int = 1,
                         num_rays: Optional[int] = None,
                         device="cuda") -> Dict:
    """batch_arrays as tensors on `device`."""
    dev = resolve(device)
    return {k: torch.as_tensor(v, device=dev)
            for k, v in batch_arrays(cfg, seed, num_rays).items()}
