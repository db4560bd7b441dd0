"""Nearest-training-view selection for hybrid rendering, host-side numpy
(JAX: hybridneuralrendering_tpu/data/nearest_views.py, a copy).

Two strategies from the reference:
  - ScanNet: nearest by *frame-id distance* (consecutive video frames), with
    optional quality re-ranking of 1.5x candidates by precomputed frame
    weights, excluding the frame itself during training
    (the reference's data/scannet_ft_dataset.py:771-812).
  - NeRF-synthetic: two-stage — filter by view-direction similarity, then pick
    nearest camera positions (scannet_ft_dataset.py:92-117 /
    nerf_synth360_ft_dataset.py:49-74).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def nearest_by_frame_id(train_ids: Sequence[int], vid: int, num: int,
                        frame_weights: Optional[np.ndarray] = None,
                        select_high_quality: bool = False,
                        exclude_self: bool = True) -> np.ndarray:
    """Pick `num` nearest training frames by |id - vid|.

    With `select_high_quality`, take 1.5x candidates and keep the `num` with
    the highest frame weights.  `exclude_self` drops the exact frame (train
    mode; find_nearest_mode in {0,1})."""
    train_ids = np.asarray(train_ids)
    id_dist = np.abs(train_ids - vid)
    order = np.argsort(id_dist, kind="stable")
    self_first = id_dist[order[0]] == 0

    if select_high_quality and frame_weights is not None:
        n_cand = int(num * 1.5)
        sl = slice(1, n_cand + 1) if (exclude_self and self_first) else \
            slice(0, n_cand)
        cand = train_ids[order[sl]]
        cand_w = np.asarray(frame_weights)[order[sl]]
        best = np.argsort(-cand_w, kind="stable")[:num]
        return cand[best]

    sl = slice(1, num + 1) if (exclude_self and self_first) else slice(0, num)
    return train_ids[order[sl]]


def nearest_by_dir_then_pos(cam_pos: np.ndarray, cam_dir: np.ndarray,
                            cam_id: int, train_poses: np.ndarray,
                            train_dirs: np.ndarray, train_ids: np.ndarray,
                            num: int, num_times: int = 3,
                            exclude_self: bool = False) -> np.ndarray:
    """Two-stage selection: (1) `num_times * num` most direction-aligned
    training cams (capped at 10% of the pool), (2) nearest positions among
    them.  Mirrors get_nearest_cam_id (scannet_ft_dataset.py:92-117), with the
    direction sort fixed to *descending* similarity (the reference sorts
    ascending dot product — a latent bug on its dead path)."""
    train_ids = np.asarray(train_ids)
    n1 = min(num_times * num, max(int(len(train_ids) * 0.1), num + 1))
    sim = train_dirs @ cam_dir
    step1 = np.argsort(-sim, kind="stable")[:n1]
    ids1 = train_ids[step1]
    pos1 = train_poses[step1]
    d = np.linalg.norm(pos1 - cam_pos, axis=-1)
    order = np.argsort(d, kind="stable")
    if exclude_self and len(order) > num and ids1[order[0]] == cam_id:
        return ids1[order[1:num + 1]]
    return ids1[order[:num]]
