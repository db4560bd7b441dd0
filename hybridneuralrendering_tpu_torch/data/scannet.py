"""ScanNet per-scene dataset (JAX: hybridneuralrendering_tpu/data/scannet.py).

Reads the reference's exported layout
(`<root>/<scan>/exported/{color,pose,depth,intrinsic}`), keeps the frames
with a valid pose, splits them nsvf-style (every `step`-th frame trains,
the others test), loads the quality frame weights and the blur list, and
assembles batches as numpy arrays with the JAX package's keys and dtypes:
rays of sampled (train) or all (test) pixels, their ground-truth colours
and the nearest training views' stack.  `device_batch` (from device.py)
turns a batch into tensors on a device.

PNG frames and depth maps go through io/png.py.  A `.jpg` frame, or one
whose size differs from cfg.image_hw, needs PIL (imported where it is
used): JPEG decoding and the LANCZOS resize are PIL's, as in the JAX
package.  A frame already at image_hw skips the resize, where PIL's resize
to the same size returns a copy, so the pixels equal the JAX package's.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from hybridneuralrendering_tpu_torch.config import Config
from hybridneuralrendering_tpu_torch.data import nearest_views, sampling
from hybridneuralrendering_tpu_torch.data.point_init import (
    clip_to_ranges, load_ply_points, unproject_depth,
    voxel_downsample_centroid)
from hybridneuralrendering_tpu_torch.device import (  # noqa: F401
    HOST_KEYS, device_batch)
from hybridneuralrendering_tpu_torch.io import png

def _np_raydir(pixelcoords, intrinsic, camrot, norm=True):
    x = (pixelcoords[..., 0] + 0.5 - intrinsic[0, 2]) / intrinsic[0, 0]
    y = (pixelcoords[..., 1] + 0.5 - intrinsic[1, 2]) / intrinsic[1, 1]
    dirs = np.stack([x, y, np.ones_like(x)], axis=-1)
    if norm:
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs @ camrot.T


def _pil(path: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: decoding a JPEG frame or resizing a "
                          "frame to cfg.image_hw needs PIL, which is not "
                          "installed") from e
    return Image


class ScannetScene:
    """One ScanNet scene in the reference's exported layout."""

    def __init__(self, data_root: str, scan: str, cfg: Config,
                 split: str = "train", step: int = 5):
        self.root = os.path.join(data_root, scan)
        self.scan = scan
        self.cfg = cfg
        self.split = split
        self.step = step
        self._img_cache: Dict[int, np.ndarray] = {}
        h, w = cfg.image_hw
        self.height, self.width = h, w

        self.intrinsic = np.loadtxt(os.path.join(
            self.root, "exported/intrinsic/intrinsic_color.txt")
        ).astype(np.float32)[:3, :3]
        self.depth_intrinsic = np.loadtxt(os.path.join(
            self.root, "exported/intrinsic/intrinsic_depth.txt")
        ).astype(np.float32)[:3, :3]

        color_dir = os.path.join(self.root, "exported/color")
        n_imgs = len([f for f in os.listdir(color_dir)
                      if f.endswith((".jpg", ".png"))])
        # rescale intrinsics from the native resolution to cfg.image_hw
        oh, ow = self._load_raw_image(0).shape[:2]
        self.intrinsic[0, :] *= (w / ow)
        self.intrinsic[1, :] *= (h / oh)

        # pose-validity filter + nsvf split (scannet_ft_dataset.py:497-520)
        self.all_id_list = [i for i in range(n_imgs)
                            if np.max(np.abs(self._pose(i))) < 30]
        self.train_id_list = self.all_id_list[::step]
        self.test_id_list = [self.all_id_list[i]
                             for i in range(len(self.all_id_list))
                             if i % step != 0]
        self.id_list = (self.train_id_list if split == "train"
                        else self.test_id_list)

        # quality frame weights (frame_weights_step5/<scan>_...npy)
        fw_path = os.path.join(data_root, "frame_weights_step5",
                               f"{scan}_frame_weight_step{step}.npy")
        if os.path.exists(fw_path):
            self.train_weight_list = np.load(fw_path)
        else:
            self.train_weight_list = np.ones(len(self.train_id_list))

        # blur-list frame removal (scannet_ft_dataset.py:473-486)
        blur_path = os.path.join(self.root, "exported/blur_list.txt")
        if os.path.exists(blur_path):
            with open(blur_path) as f:
                bad = {int(l.strip()) for l in f if l.strip()}
            keep = [i for i, v in enumerate(self.train_id_list)
                    if v not in bad]
            self.train_id_list = [self.train_id_list[i] for i in keep]
            self.train_weight_list = self.train_weight_list[keep]

    # -- IO ---------------------------------------------------------------

    def _pose(self, vid: int) -> np.ndarray:
        return np.loadtxt(os.path.join(
            self.root, "exported/pose", f"{vid}.txt")).astype(np.float32)

    def _color_path(self, vid: int) -> str:
        p = os.path.join(self.root, "exported/color", f"{vid}.jpg")
        if not os.path.exists(p):
            p = os.path.join(self.root, "exported/color", f"{vid}.png")
        return p

    def _load_raw_image(self, vid: int) -> np.ndarray:
        p = self._color_path(vid)
        if p.endswith(".png"):
            return png.read(p)
        return np.asarray(_pil(p).open(p))

    def image(self, vid: int) -> np.ndarray:
        """[H, W, 3] float32 in [0, 1] at cfg.image_hw (a LANCZOS resize
        where the frame's size differs, as the reference)."""
        if vid in self._img_cache:
            return self._img_cache[vid]
        raw = self._load_raw_image(vid)
        if raw.shape[:2] != (self.height, self.width):
            image = _pil(self._color_path(vid))
            raw = np.asarray(image.fromarray(raw).resize(
                (self.width, self.height), image.LANCZOS))
        arr = np.asarray(raw, np.float32)[..., :3] / 255.0
        self._img_cache[vid] = arr
        return arr

    def depth(self, vid: int) -> np.ndarray:
        """[H, W] float32 metres; 0 outside [0.3, 8]."""
        d = png.read(os.path.join(
            self.root, "exported/depth", f"{vid}.png")).astype(np.float32)
        d /= 1000.0
        d[(d > 8.0) | (d < 0.3)] = 0
        return d

    # -- point init -------------------------------------------------------

    def load_init_points(self) -> np.ndarray:
        """Mesh-vertex cloud from exported/pcd.ply (load_points=1)."""
        return load_ply_points(os.path.join(self.root, "exported/pcd.ply"),
                               self.cfg.querier.ranges)

    def load_init_depth_points(self, vox_res: int = 0,
                               frame_stride: int = 1) -> np.ndarray:
        """Unproject all sensor depth maps (load_points=2,
        scannet_ft_dataset.py:616-647); optional per-frame voxel
        downsample."""
        clouds: List[np.ndarray] = []
        for vid in self.all_id_list[::frame_stride]:
            pts = unproject_depth(self.depth(vid), self.depth_intrinsic,
                                  self._pose(vid))
            if vox_res > 0:
                pts = voxel_downsample_centroid(pts, vox_res)
            clouds.append(pts)
        xyz = np.concatenate(clouds)
        return clip_to_ranges(xyz, self.cfg.querier.ranges)

    # -- batches ----------------------------------------------------------

    def __len__(self):
        return len(self.id_list)

    def get_batch(self, idx: int, rng: Optional[np.random.Generator] = None,
                  pixelcoords: Optional[np.ndarray] = None) -> Dict:
        """One training/eval batch for frame `id_list[idx]` as numpy arrays,
        with the JAX package's keys and dtypes."""
        rng = rng or np.random.default_rng()
        vid = self.id_list[idx]
        c2w = self._pose(vid)
        camrot, campos = c2w[:3, :3], c2w[:3, 3]
        img = self.image(vid)

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
            "vid": vid,
        }

        if self.cfg.loss.use_frame_weight and self.split == "train":
            widx = self.train_id_list.index(vid)
            # weight_exp sharpens/flattens the quality weighting
            # (scannet_ft_dataset.py:756-758)
            batch["frame_weight"] = np.float32(
                self.train_weight_list[widx] ** self.cfg.loss.weight_exp)

        V = self.cfg.agg.use_nearest
        if V > 0 and self.cfg.agg.dynamic_nearest:
            # the reference re-selects V ~ randint(2, 8) views per train
            # batch; the stack stays `dynamic_nearest_pool` views and
            # view_mask masks the unused tail out of the fusion
            pool = self.cfg.agg.dynamic_nearest_pool
            n_used = int(rng.integers(2, 8)) if self.split == "train" else V
            n_used = min(n_used, pool)
            batch["view_mask"] = (np.arange(pool) < n_used).astype(np.float32)
            V = pool
        if V > 0:
            near_ids = nearest_views.nearest_by_frame_id(
                self.train_id_list, vid, V,
                frame_weights=self.train_weight_list,
                select_high_quality=self.cfg.agg.select_high_quality,
                exclude_self=self.split == "train")
            if len(near_ids) < V:   # short scene: cycle to the static V
                near_ids = np.resize(near_ids, V)
            imgs, c2ws, poss, fws = [], [], [], []
            for nv in near_ids:
                imgs.append(self.image(nv))
                p = self._pose(nv)
                c2ws.append(p)
                poss.append(p[:3, 3])
                if self.cfg.agg.downweight_blurry_feats:
                    fws.append(self.train_weight_list[
                        self.train_id_list.index(nv)])
                else:
                    fws.append(1.0)
            batch.update({
                "images_nearest": np.stack(imgs).astype(np.float32),
                "c2w_nearest": np.stack(c2ws).astype(np.float32),
                "campos_nearest": np.stack(poss).astype(np.float32),
                "intrinsic_nearest": self.intrinsic,
                "frame_weight_nearest": np.asarray(fws, np.float32),
                "nearest_vids": np.asarray(near_ids, np.int64),
            })
        return batch
