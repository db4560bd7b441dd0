"""Synthetic scene and ray requests at the ScanNet workload's shapes
(JAX: hybridneuralrendering_tpu/data/synthetic.py).

Points lie on six random wall/floor-like planes; rays aim from a camera at
(0, 0, -2.5) into the cloud; the nearest-view stack holds random images.
Everything is drawn from one numpy generator in the JAX package's order, so
a seed gives both packages the same points, attributes and rays; only the
point embeddings differ (the JAX package draws them with jax.random).
`write_scannet_scene` writes frames of that camera in the ScanNet layout
that data/scannet.py reads; `write_blender_scene` an object scene in the
Blender layout that data/nerf_synth.py reads.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hybridneuralrendering_tpu_torch.config import Config
from hybridneuralrendering_tpu_torch.device import resolve
from hybridneuralrendering_tpu_torch.io import png
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


# the requests' camera: at (0, 0, -2.5), looking down +z, focal 0.9 W
CAMPOS = np.array([0.0, 0.0, -2.5], np.float32)
# write_scannet_scene: metres along x between frames, and its colour seed
STEP_X = 0.1
SCENE_SEED = 0


def intrinsic(H: int, W: int) -> np.ndarray:
    return np.array([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1]],
                    np.float32)


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
    campos = CAMPOS
    targets = rng.uniform(-1.0, 1.0, (R, 3)).astype(np.float32)
    dirs = targets - campos
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    intr = intrinsic(H, W)
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


def write_scannet_scene(root: str, cfg: Config, scan: str = "synth",
                        n_frames: int = 20) -> str:
    """Frames of the requests' camera stepped STEP_X along x per frame,
    in the layout data/scannet.ScannetScene reads
    (`root/scan/exported/{color,pose,depth,intrinsic}`): colour as seeded
    noise in 8-bit PNGs at cfg.image_hw, depth a constant 2.5 m in 16-bit
    PNGs, the intrinsics of batch_arrays.  Returns the scene's directory."""
    rng = np.random.default_rng(SCENE_SEED)
    H, W = cfg.image_hw
    base = os.path.join(root, scan, "exported")
    for sub in ("color", "pose", "depth", "intrinsic"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    k4 = np.eye(4)
    k4[:3, :3] = intrinsic(H, W)
    for name in ("intrinsic_color", "intrinsic_depth"):
        np.savetxt(os.path.join(base, "intrinsic", f"{name}.txt"), k4)
    depth = np.full((H, W), 2500, np.uint16)
    for i in range(n_frames):
        c2w = np.eye(4)
        c2w[:3, 3] = CAMPOS
        c2w[0, 3] += STEP_X * (i - (n_frames - 1) / 2)
        np.savetxt(os.path.join(base, "pose", f"{i}.txt"), c2w)
        png.write(os.path.join(base, "color", f"{i}.png"),
                  rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        png.write(os.path.join(base, "depth", f"{i}.png"), depth)
    return os.path.join(root, scan)


# write_blender_scene's object: a sphere on a box, inside +-1 m, orbited at
# BLENDER_RADIUS by cameras of lego's camera_angle_x (the camera convention
# of tools/make_fixture_scene.py --layout blender)
SPHERE_C, SPHERE_R = np.array([0.0, 0.0, 0.25]), 0.45
BOX_LO, BOX_HI = np.array([-0.55, -0.55, -0.6]), np.array([0.55, 0.55, -0.25])
BLENDER_RADIUS = 4.0
LEGO_CAMERA_ANGLE_X = 0.6911112070083618


def _object_hit(campos: np.ndarray, dirs: np.ndarray):
    """(hit distance, inf on a miss; surface normal) of rays from `campos`
    along unit `dirs` [..., 3] against the sphere and the box."""
    oc = campos - SPHERE_C
    b = dirs @ oc
    disc = b * b - (oc @ oc - SPHERE_R ** 2)
    ts = -b - np.sqrt(np.maximum(disc, 0.0))
    ts = np.where((disc > 0) & (ts > 1e-3), ts, np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        t0, t1 = (BOX_LO - campos) / dirs, (BOX_HI - campos) / dirs
    tmin = np.max(np.minimum(t0, t1), axis=-1)
    tmax = np.min(np.maximum(t0, t1), axis=-1)
    tb = np.where(tmax >= np.maximum(tmin, 1e-3), tmin, np.inf)
    t = np.minimum(ts, tb)
    p = campos + dirs * np.where(np.isfinite(t), t, 0.0)[..., None]
    rel = (p - (BOX_LO + BOX_HI) / 2) / ((BOX_HI - BOX_LO) / 2)
    ax = np.argmax(np.abs(rel), axis=-1)
    n_box = np.eye(3)[ax] * np.sign(np.take_along_axis(rel, ax[..., None],
                                                       -1))
    normal = np.where((ts < tb)[..., None], (p - SPHERE_C) / SPHERE_R, n_box)
    return t, p, normal


def _object_rgba(c2w: np.ndarray, intr: np.ndarray, H: int,
                 W: int) -> np.ndarray:
    """[H, W, 4] uint8 render of the object from OpenCV-convention `c2w`:
    a smooth positional texture under one light, alpha 1 on the object and
    0 (white) elsewhere."""
    ys, xs = np.mgrid[0:H, 0:W]
    pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], -1).astype(
        np.float64)
    dirs = (pix @ np.linalg.inv(intr).T) @ c2w[:3, :3].T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    t, p, normal = _object_hit(c2w[:3, 3], dirs)
    hit = np.isfinite(t)
    base = 0.5 + 0.45 * np.stack([
        np.sin(6.0 * p[..., 0]) * np.cos(4.0 * p[..., 1]),
        np.sin(5.0 * p[..., 1] + 1.0) * np.cos(3.0 * p[..., 2]),
        np.sin(4.0 * p[..., 2] + 2.0) * np.cos(5.0 * p[..., 0])], -1)
    lam = 0.55 + 0.45 * np.clip(normal @ np.array([0.4, 0.3, 0.85]), 0, 1)
    rgb = np.where(hit[..., None], np.clip(base * lam[..., None], 0, 1), 1.0)
    rgba = np.concatenate([rgb, hit[..., None].astype(np.float64)], -1)
    return (rgba * 255).astype(np.uint8)


def object_surface(n: int, rng: np.random.Generator) -> np.ndarray:
    """[n, 3] float32 points on the object's surface: half on the sphere,
    half on the box's faces."""
    ns = n // 2
    v = rng.normal(size=(ns, 3))
    sph = SPHERE_C + SPHERE_R * v / np.linalg.norm(v, axis=-1,
                                                   keepdims=True)
    face = rng.integers(0, 6, n - ns)
    box = BOX_LO + rng.uniform(0, 1, (n - ns, 3)) * (BOX_HI - BOX_LO)
    axis = face // 2
    box[np.arange(n - ns), axis] = np.where(face % 2, BOX_HI[axis],
                                            BOX_LO[axis])
    return np.concatenate([sph, box]).astype(np.float32)


def write_blender_scene(root: str, scan: str = "objsim", n_train: int = 20,
                        n_test: int = 4, hw: Tuple[int, int] = (400, 400),
                        num_points: int = 60_000, seed: int = 0) -> str:
    """An object scene in the Blender layout that data/nerf_synth reads
    (`root/scan/{train,test}/r_i.png`, `transforms_{train,test}.json`,
    `fused.ply`): RGBA frames of the sphere-on-box object at `hw` from
    cameras orbiting at BLENDER_RADIUS (pose_spherical; the test views
    between the train views), and `num_points` surface points as a binary
    PLY.  Returns the scene's directory."""
    from hybridneuralrendering_tpu_torch.data.nerf_synth import (
        BLENDER2OPENCV, pose_spherical)
    H, W = hw
    scene = os.path.join(root, scan)
    focal = 0.5 * W / np.tan(0.5 * LEGO_CAMERA_ANGLE_X)
    intr = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]])
    for split, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(scene, split), exist_ok=True)
        off = 0.5 if split == "test" else 0.0
        frames = []
        for i in range(n):
            theta = -180 + 360.0 * (i + off) / n
            phi = -30.0 + 12.0 * np.sin(2.1 * i + 2 * off)
            c2w_b = pose_spherical(theta, phi, BLENDER_RADIUS).astype(
                np.float64)
            png.write(os.path.join(scene, split, f"r_{i}.png"),
                      _object_rgba(c2w_b @ BLENDER2OPENCV, intr, H, W))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w_b.tolist()})
        with open(os.path.join(scene, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": LEGO_CAMERA_ANGLE_X,
                       "frames": frames}, f)
    xyz = object_surface(num_points, np.random.default_rng(seed))
    with open(os.path.join(scene, "fused.ply"), "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(xyz)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "end_header\n").encode())
        f.write(np.ascontiguousarray(xyz, "<f4").tobytes())
    return scene
