"""Point lifecycle: probe holes -> grow, prune, ray-miss ranking
(JAX: hybridneuralrendering_tpu/train/lifecycle.py; reference
run/train_ft.py:450-569 `probe_hole`, :572-581 `bloat_inds`, and the
ray-miss ranking of models/mvs_points_volumetric_model.py:154-172).

Growth writes into free capacity slots (models/neural_points.grow), the
voxel grid is rebuilt, and the caller resets the optimizers, all in
process.  A probe renders whole training frames with the point-growing
outputs (serve.render_rays with prob=True) and scatters them into [H, W, .]
maps on the host, where the hole logic runs in numpy as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hybridneuralrendering_tpu_torch import serve
from hybridneuralrendering_tpu_torch.config import Config
from hybridneuralrendering_tpu_torch.data import sampling
from hybridneuralrendering_tpu_torch.device import device_batch
from hybridneuralrendering_tpu_torch.models import neural_points as npts
from hybridneuralrendering_tpu_torch.ops import voxel_grid as VG

# the outputs a probe scatters into image maps
PROBE_KEYS = ("coarse_raycolor", "ray_mask", "ray_max_sample_loc_w",
              "ray_max_far_dist", "ray_max_shading_opacity",
              "shading_avg_color", "shading_avg_dir", "shading_avg_conf",
              "shading_avg_embedding")


class RayMissTracker:
    """Top-miss-loss frame ranking (mvs_points_volumetric_model.py:
    154-172): which training frames have the largest miss-ray colour loss,
    so that the prober visits them first."""

    def __init__(self, top_k: int = 10):
        self.top_k = top_k
        self.loss: Dict[int, float] = {}

    def update(self, frame_idx: int, miss_loss: float):
        self.loss[frame_idx] = max(self.loss.get(frame_idx, 0.0), miss_loss)

    def top_ids(self) -> List[int]:
        ranked = sorted(self.loss.items(), key=lambda kv: -kv[1])
        return [i for i, l in ranked[: self.top_k] if l > 1e-5]

    def reset(self):
        self.loss.clear()


def bloat_mask(mask: np.ndarray, radius: int = 1) -> np.ndarray:
    """Dilate a boolean [H, W] mask by a square (2r+1) kernel
    (bloat_inds, run/train_ft.py:572-581)."""
    out = mask.copy()
    H, W = mask.shape
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx == 0 and dy == 0:
                continue
            shifted = np.zeros_like(mask)
            shifted[max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = \
                mask[max(-dy, 0):H + min(-dy, 0), max(-dx, 0):W + min(-dx, 0)]
            out |= shifted
    return out


def probe_frame(params, points: npts.NeuralPoints, grid: VG.PointGrid,
                dataset, frame_idx: int, cfg: Config
                ) -> Dict[str, np.ndarray]:
    """Render the pixels of full_image_grid(H, W, edge_filter) of one frame
    with the point-growing outputs, in chunks of cfg.sampling.eval_rays
    (one request: the views' pyramid runs once), and scatter them into
    [H, W, C] host maps, zero where no pixel was rendered; 'gt_image' is
    the frame's image (probe_hole's chunked loop, train_ft.py:507-526)."""
    H, W = dataset.height, dataset.width
    pix = sampling.full_image_grid(H, W, cfg.sampling.edge_filter)
    flat = pix.reshape(-1, 2)
    batch = dataset.get_batch(frame_idx, pixelcoords=flat[:, None, :])
    out = serve.render_rays(params, points, grid,
                            device_batch(batch, points.table.device), cfg,
                            prob=True)
    px = flat[:, 0].astype(int)
    py = flat[:, 1].astype(int)
    maps: Dict[str, np.ndarray] = {}
    for k in PROBE_KEYS:
        v = out[k].cpu().numpy()
        if v.ndim == 1:
            v = v[:, None]
        maps[k] = np.zeros((H, W, v.shape[-1]), v.dtype)
        maps[k][py, px] = v
    maps["gt_image"] = dataset.image(dataset.id_list[frame_idx])
    return maps


def holes_from_maps(maps: Dict[str, np.ndarray], bg_color: np.ndarray,
                    cfg: Config) -> Tuple[np.ndarray, ...]:
    """Miss-mask logic (train_ft.py:528-551): rays that missed but whose GT
    is not background, dilated 3x3; the candidates are the neighbouring
    *hit* rays with opacity above prob_thresh, and their max-opacity sample
    locations become new points with conf scaled by prob_mul.  Returns
    (xyz, embedding, color, dirs, conf) of the candidates."""
    gt = maps["gt_image"]
    ray_mask = maps["ray_mask"][..., 0] > 0
    miss = (~ray_mask) & (
        np.linalg.norm(gt - bg_color[None, None], axis=-1) > 0.002)
    neighboring = bloat_mask(miss, 1)
    if cfg.probe.far_thresh > 0:
        far = (ray_mask
               & (maps["ray_max_far_dist"][..., 0] > cfg.probe.far_thresh)
               & (np.linalg.norm(gt - maps["coarse_raycolor"], axis=-1)
                  < 0.1))
        neighboring |= far
    cand = (ray_mask & neighboring
            & (maps["ray_max_shading_opacity"][..., 0]
               > cfg.probe.prob_thresh))
    sel = np.nonzero(cand)
    return (maps["ray_max_sample_loc_w"][sel],
            maps["shading_avg_embedding"][sel],
            maps["shading_avg_color"][sel],
            maps["shading_avg_dir"][sel],
            maps["shading_avg_conf"][sel] * cfg.probe.prob_mul)


def probe_and_grow(params, points: npts.NeuralPoints, grid: VG.PointGrid,
                   dataset, cfg: Config,
                   tracker: Optional[RayMissTracker] = None,
                   max_frames: Optional[int] = None,
                   rng: Optional[np.random.Generator] = None,
                   query_size_override=None):
    """A probe-hole pass over chosen training frames -> grown points and a
    fresh grid.

    query_size_override: the tier's probe dilation width (the reference
    overrides opt.query_size from prob_kernel_size while probing,
    run/train_ft.py:458-463): where it differs from the querier's, the
    probe renders through a grid built with it, and training goes on with
    the normal one.  The frames are the tracker's top ids (prob_top = 1
    with a tracker), else every frame in an `rng` shuffle, cut to
    max_frames or len(dataset) // prob_num_step (at least 1).  Returns
    (new_points, new_grid, num_added); the input points and grid when
    nothing is added."""
    rng = rng or np.random.default_rng(0)
    cfg_probe, grid_probe = cfg, grid
    if query_size_override is not None and \
            tuple(query_size_override) != tuple(cfg.querier.query_size):
        cfg_probe = cfg.replace(querier=dataclasses.replace(
            cfg.querier, query_size=tuple(query_size_override)))
        grid_probe = VG.grid_of(points.xyz, points.mask, cfg_probe.querier)
    if tracker is not None and cfg.probe.prob_top == 1:
        frame_ids = tracker.top_ids()
    else:
        frame_ids = list(range(len(dataset)))
        rng.shuffle(frame_ids)
    limit = max_frames or max(len(dataset) // cfg.probe.prob_num_step, 1)
    frame_ids = frame_ids[:limit]

    adds = []
    bg = np.asarray(cfg.render.bg_color, np.float32)
    for fi in frame_ids:
        maps = probe_frame(params, points, grid_probe, dataset, fi, cfg_probe)
        adds.append(holes_from_maps(maps, bg, cfg))
    if not adds or sum(len(a[0]) for a in adds) == 0:
        return points, grid, 0

    xyz, emb, col, dirs, conf = (np.concatenate([a[j] for a in adds])
                                 for j in range(5))
    n_add = min(len(xyz), points.capacity - int(points.num_live))
    dev = points.table.device
    new_mask = torch.as_tensor(np.arange(len(xyz)) < n_add, device=dev)
    new_points = npts.grow(
        points, *(torch.as_tensor(a, device=dev)
                  for a in (xyz, emb, conf, col, dirs)), new_mask)
    new_grid = VG.grid_of(new_points.xyz, new_points.mask, cfg.querier)
    if tracker is not None:
        tracker.reset()
    return new_points, new_grid, n_add


def prune_and_rebuild(points: npts.NeuralPoints, cfg: Config):
    """Conf-threshold prune + grid rebuild (neural_points.py:350-373).
    Returns (pruned points, their grid)."""
    new_points = npts.prune(points, cfg.probe.prune_thresh)
    return new_points, VG.grid_of(new_points.xyz, new_points.mask,
                                  cfg.querier)
