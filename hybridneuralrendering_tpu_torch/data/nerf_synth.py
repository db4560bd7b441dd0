"""NeRF-synthetic per-scene dataset (JAX: hybridneuralrendering_tpu/data/
nerf_synth.py; reference data/nerf_synth360_ft_dataset.py and
data/load_blender.py).

Reads the Blender layout (`<root>/<scan>/transforms_{train,test}.json` and
the RGBA frames they name), composites each frame onto cfg.render.bg_color
(the background the renderer fills misses with), takes the intrinsics
from camera_angle_x, and makes the spherical render path.  Batches are
numpy arrays with the JAX package's keys and dtypes; the nearest views
(use_nearest > 0) are picked by direction, then position.

PNG frames go through io/png.py.  A frame whose size differs from
cfg.image_hw is resized with PIL's LANCZOS (imported where it is used,
raising ImportError without it), as the JAX package resizes every frame;
at equal size PIL's resize is a copy, so the pixels equal the JAX
package's without PIL.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from hybridneuralrendering_tpu_torch.config import Config
from hybridneuralrendering_tpu_torch.data import nearest_views, sampling
from hybridneuralrendering_tpu_torch.data.point_init import load_ply_points
from hybridneuralrendering_tpu_torch.data.scannet import _np_raydir, _pil
from hybridneuralrendering_tpu_torch.io import png

BLENDER2OPENCV = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], np.float64)


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Blender-convention camera-to-world pose on a sphere of `radius`,
    azimuth `theta` and elevation `phi` in degrees
    (nerf_synth360_ft_dataset.py:77-105)."""
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = radius
    p = phi / 180.0 * np.pi
    rot_phi = np.array([[1, 0, 0, 0], [0, np.cos(p), -np.sin(p), 0],
                        [0, np.sin(p), np.cos(p), 0], [0, 0, 0, 1]],
                       np.float32)
    t = theta / 180.0 * np.pi
    rot_theta = np.array([[np.cos(t), 0, -np.sin(t), 0], [0, 1, 0, 0],
                          [np.sin(t), 0, np.cos(t), 0], [0, 0, 0, 1]],
                         np.float32)
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1]], np.float32)
    return flip @ rot_theta @ rot_phi @ trans


class NerfSynthScene:
    """One NeRF-synthetic scene in the Blender layout."""

    def __init__(self, data_root: str, scan: str, cfg: Config,
                 split: str = "train"):
        self.root = os.path.join(data_root, scan)
        self.scan = scan
        self.cfg = cfg
        self.split = split
        self.bg = np.asarray(cfg.render.bg_color, np.float32)
        h, w = cfg.image_hw
        self.height, self.width = h, w

        with open(os.path.join(self.root,
                               f"transforms_{split}.json")) as f:
            self.meta = json.load(f)
        with open(os.path.join(self.root, "transforms_train.json")) as f:
            self.train_meta = json.load(f)

        # the Blender scenes' 800-pixel focal, scaled to the frame width
        focal = 0.5 * 800 / np.tan(0.5 * self.meta["camera_angle_x"])
        focal *= w / 800.0
        self.focal = focal
        self.intrinsic = np.array(
            [[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)

        self.id_list = list(range(len(self.meta["frames"])))
        self.train_ids = np.arange(len(self.train_meta["frames"]))
        self._img_cache: Dict[int, np.ndarray] = {}
        self._train_img_cache: Dict[int, np.ndarray] = {}

        self.train_c2w = np.stack([
            np.array(f["transform_matrix"]) @ BLENDER2OPENCV
            for f in self.train_meta["frames"]]).astype(np.float32)
        self.train_pos = self.train_c2w[:, :3, 3]
        # each training camera's central view direction (its z axis)
        self.train_dirs = self.train_c2w[:, :3, 2]
        self.train_dirs = self.train_dirs / np.linalg.norm(
            self.train_dirs, axis=-1, keepdims=True)

    def c2w(self, idx: int, meta=None) -> np.ndarray:
        meta = meta or self.meta
        return (np.array(meta["frames"][idx]["transform_matrix"])
                @ BLENDER2OPENCV).astype(np.float32)

    def _rgba(self, path: str) -> np.ndarray:
        """The frame's pixels at cfg.image_hw as float32 in [0, 1]."""
        raw = png.read(path)
        if raw.shape[:2] != (self.height, self.width):
            image = _pil(path)
            raw = np.asarray(image.fromarray(raw).resize(
                (self.width, self.height), image.LANCZOS))
        return np.asarray(raw, np.float32) / 255.0

    def _load(self, idx: int, meta, cache) -> np.ndarray:
        if idx in cache:
            return cache[idx]
        arr = self._rgba(os.path.join(
            self.root, meta["frames"][idx]["file_path"] + ".png"))
        rgb, a = arr[..., :3], arr[..., 3:4]
        # on white (1 * (1 - a)) and on black (0 * (1 - a)) these are the
        # JAX package's floats, bit for bit
        out = rgb * a + self.bg * (1 - a)
        cache[idx] = out.astype(np.float32)
        return cache[idx]

    def image(self, idx: int) -> np.ndarray:
        """[H, W, 3] float32 of frame `idx` of the split, composited."""
        return self._load(idx, self.meta, self._img_cache)

    def train_image(self, idx: int) -> np.ndarray:
        return self._load(idx, self.train_meta, self._train_img_cache)

    def train_alpha(self, idx: int) -> np.ndarray:
        """[H, W] alpha matte of a training view (ones without alpha)."""
        arr = self._rgba(os.path.join(
            self.root, self.train_meta["frames"][idx]["file_path"] + ".png"))
        return arr[..., 3] if arr.shape[-1] == 4 else np.ones(
            arr.shape[:2], np.float32)

    def load_init_points(self) -> np.ndarray:
        """The COLMAP fused.ply cloud (load_points=1,
        nerf_synth360_ft_dataset.py:458-475), clipped to the grid's
        ranges."""
        for name in ("colmap_results/dense/fused.ply", "fused.ply"):
            p = os.path.join(self.root, name)
            if os.path.exists(p):
                return load_ply_points(p, self.cfg.querier.ranges)
        raise FileNotFoundError(f"no fused.ply under {self.root}")

    def render_path(self, n: int = 40, phi: float = -30.0,
                    radius: float = 4.0) -> List[np.ndarray]:
        """n spherical orbit poses in the OpenCV convention (+z toward the
        object), flipped as the loader flips the dataset's poses."""
        return [(pose_spherical(th, phi, radius)
                 @ BLENDER2OPENCV).astype(np.float32)
                for th in np.linspace(-180, 180, n + 1)[:-1]]

    def __len__(self):
        return len(self.id_list)

    def get_batch(self, idx: int, rng: Optional[np.random.Generator] = None,
                  pixelcoords: Optional[np.ndarray] = None) -> Dict:
        """One training/eval batch of frame `idx` as numpy arrays, with the
        JAX package's keys and dtypes: sampled pixels (train) or all of
        them (test), and with use_nearest > 0 the nearest training
        views."""
        rng = rng or np.random.default_rng()
        c2w = self.c2w(idx)
        camrot, campos = c2w[:3, :3], c2w[:3, 3]
        img = self.image(idx)

        if pixelcoords is None:
            if self.split == "train":
                pixelcoords = sampling.sample_pixels(
                    self.cfg.sampling, self.height, self.width, rng)
            else:
                pixelcoords = sampling.full_image_grid(self.height,
                                                       self.width)
        raydir = _np_raydir(pixelcoords, self.intrinsic, camrot).reshape(-1, 3)
        px = pixelcoords[..., 0].astype(np.int32)
        py = pixelcoords[..., 1].astype(np.int32)
        gt = img[py, px].reshape(-1, 3)

        batch = {
            "campos": campos.astype(np.float32),
            "camrotc2w": camrot.astype(np.float32),
            "raydir": raydir.astype(np.float32),
            "pixel_idx": np.stack([px, py], -1).reshape(-1, 2),
            "gt_image": gt.astype(np.float32),
            "bg_color": np.asarray(self.cfg.render.bg_color, np.float32),
            "vid": idx,
        }

        V = self.cfg.agg.use_nearest
        if V > 0:
            dir_c = camrot[:, 2] / np.linalg.norm(camrot[:, 2])
            near = nearest_views.nearest_by_dir_then_pos(
                campos, dir_c, idx if self.split == "train" else -1,
                self.train_pos, self.train_dirs, self.train_ids, V,
                exclude_self=self.split == "train")
            imgs = np.stack([self.train_image(int(i)) for i in near])
            c2ws = np.stack([self.c2w(int(i), self.train_meta)
                             for i in near])
            batch.update({
                "images_nearest": imgs.astype(np.float32),
                "c2w_nearest": c2ws,
                "campos_nearest": c2ws[:, :3, 3].astype(np.float32),
                "intrinsic_nearest": self.intrinsic,
                "frame_weight_nearest": np.ones(V, np.float32),
                "nearest_vids": np.asarray(near, np.int64),
            })
        return batch
