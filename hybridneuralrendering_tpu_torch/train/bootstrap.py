"""The feed-forward point-cloud bootstrap (JAX:
hybridneuralrendering_tpu/train/bootstrap.py; reference
gen_points_filter_embeddings, run/train_ft.py:60-197).

Per view triplet: the reference view's depth (the MVSNet plane sweep, or
the sensor's), filtered by confidence and, with MVSNet, by geometric
consistency across the groups' reference views; the survivors unprojected
to the world, clipped to the querier's ranges, optionally cut to the
alpha mattes' visual hull, voxel-downsampled, and given per-point
embeddings, colours, directions and confidences by query_embedding of
their own group.  The networks run on the MVS parameters' device; the
host does the masking and the world transforms in numpy, as JAX does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hybridneuralrendering_tpu_torch.config import Config
from hybridneuralrendering_tpu_torch.data.paths import build_view_triplets
from hybridneuralrendering_tpu_torch.data.point_init import (
    voxel_downsample_closest)
from hybridneuralrendering_tpu_torch.device import no_tf32, resolve
from hybridneuralrendering_tpu_torch.mvs import filter as geo_filter
from hybridneuralrendering_tpu_torch.mvs import mvsnet, point_gen
from hybridneuralrendering_tpu_torch.mvs import warp as warp_mod


def _to_world(xyz_cam: np.ndarray, w2c: np.ndarray) -> np.ndarray:
    c2w = np.linalg.inv(w2c)
    ones = np.ones((len(xyz_cam), 1), np.float32)
    return (np.concatenate([xyz_cam, ones], -1) @ c2w.T)[:, :3]


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@torch.no_grad()
def bootstrap_from_groups(
        mvs_params: point_gen.MvsPointsParams,
        images_by_group: List[np.ndarray],       # each [3, H, W, 3]
        intrinsic: np.ndarray,
        w2cs_by_group: List[np.ndarray],         # each [3, 4, 4]
        near: float, far: float, cfg: Config,
        depth_gt_by_group: Optional[List[np.ndarray]] = None,
        conf_thresh: float = 0.8, geo_cnsst_num: int = 0,
        vox_res: int = 900, num_depths: int = 96,
        alphas: Optional[np.ndarray] = None,       # [V, H, W] mattes
        alpha_w2cs: Optional[np.ndarray] = None,   # [V, 4, 4]
        alpha_intrinsic: Optional[np.ndarray] = None,
        device="cuda") -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Returns (xyz_world [M, 3], {"embedding", "color", "dirs", "conf"}).

    MVSNet mode (no depth_gt_by_group): the groups' depth maps are filtered
    by consistency across the groups' reference views
    (filter_by_masks_gpu, run/train_ft.py:107-120) and their confidence
    raised by the match count; GT-depth mode keeps the sensor's
    (train_ft.py:122-126).  `alphas` adds the visual hull
    (train_ft.py:152-159).  Runs on `device` (the card unless the caller
    asks for the CPU), where mvs_params must lie."""
    dev = resolve(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    intr = t(intrinsic)
    all_xyz, all_conf, group_of = [], [], []
    with no_tf32():
        if depth_gt_by_group is None:
            depths, confs, k_q = [], [], None
            for imgs, w2cs in zip(images_by_group, w2cs_by_group):
                d, c, k_q = point_gen.gen_depth(mvs_params, t(imgs), intr,
                                                t(w2cs), near, far,
                                                num_depths)
                depths.append(d)
                confs.append(c)
            depths, confs = torch.stack(depths), torch.stack(confs)
            exts = torch.stack([t(w[0]) for w in w2cs_by_group])
            ks = k_q.expand(len(depths), 3, 3)
            masks, _, geo_sums = geo_filter.filter_depths(
                depths, ks, exts, confs, conf_thresh, geo_cnsst_num)
            confs = geo_filter.reassign_conf(confs, geo_sums, geo_cnsst_num)
            for gi in range(len(images_by_group)):
                cam_xyz = _np(mvsnet.depth_to_cam_xyz(depths[gi], k_q))
                m = _np(masks[gi]).reshape(-1) \
                    & (_np(depths[gi]).reshape(-1) > 0)
                all_xyz.append(_to_world(cam_xyz[m],
                                         np.asarray(w2cs_by_group[gi])[0]))
                all_conf.append(_np(confs[gi]).reshape(-1)[m])
                group_of.append(np.full(int(m.sum()), gi))
        else:
            for gi, (imgs, w2cs) in enumerate(zip(images_by_group,
                                                  w2cs_by_group)):
                cam_xyz, conf, mask = point_gen.gen_points(
                    mvs_params, t(imgs), intr, t(w2cs), near, far,
                    num_depths=num_depths, depth_gt=t(depth_gt_by_group[gi]),
                    conf_thresh=conf_thresh)
                m = _np(mask)
                all_xyz.append(_to_world(_np(cam_xyz)[m],
                                         np.asarray(w2cs)[0]))
                all_conf.append(_np(conf)[m])
                group_of.append(np.full(int(m.sum()), gi))

    xyz = np.concatenate(all_xyz).astype(np.float32)
    conf = np.concatenate(all_conf).astype(np.float32)
    group_of = np.concatenate(group_of)

    # clip and downsample (construct_vox_points_closest, train_ft.py:163-168)
    lo = np.asarray(cfg.querier.ranges[:3])
    hi = np.asarray(cfg.querier.ranges[3:])
    inb = ((xyz >= lo) & (xyz <= hi)).all(-1)
    xyz, conf, group_of = xyz[inb], conf[inb], group_of[inb]
    if alphas is not None and len(xyz):
        hull = _np(warp_mod.alpha_masking(
            t(xyz), t(alphas),
            t(alpha_intrinsic if alpha_intrinsic is not None else intrinsic),
            None, t(alpha_w2cs), near_far=(near, far)))
        xyz, conf, group_of = xyz[hull], conf[hull], group_of[hull]
    if vox_res > 0 and len(xyz):
        xyz_ds, keep = voxel_downsample_closest(xyz, vox_res)
        conf, group_of = conf[keep], group_of[keep]
        xyz = xyz_ds

    # each group's points get its embeddings (train_ft.py:174-197)
    F = cfg.points.feature_dim
    emb = np.zeros((len(xyz), F), np.float32)
    col = np.zeros((len(xyz), 3), np.float32)
    drs = np.zeros((len(xyz), 3), np.float32)
    cnf = conf.reshape(-1, 1).copy()
    for gi, (imgs, w2cs) in enumerate(zip(images_by_group, w2cs_by_group)):
        sel = np.nonzero(group_of == gi)[0]
        if len(sel) == 0:
            continue
        w2cs = np.asarray(w2cs)
        ones = np.ones((len(sel), 1), np.float32)
        cam_xyz = (np.concatenate([xyz[sel], ones], -1) @ w2cs[0].T)[:, :3]
        c2ws = np.stack([np.linalg.inv(w) for w in w2cs])
        with no_tf32():
            e, c, d, _ = point_gen.query_embedding(
                mvs_params, t(cam_xyz), t(imgs), t(c2ws), t(w2cs), intr, 0,
                confidence=t(cnf[sel, 0]))
        emb[sel] = _np(e)[:, :F]
        col[sel] = _np(c)
        drs[sel] = _np(d)
    return xyz, {"embedding": emb, "color": col, "dirs": drs, "conf": cnf}


def groups_from_dataset(dataset, num_views: int = 3,
                        max_groups: int = 0) -> List[Tuple[int, int, int]]:
    """View triplets of a dataset's training cameras, as positions in its
    training list: ScanNet's train_id_list (poses from _pose), or a
    Blender scene's frames 0..len-1 (poses from c2w)."""
    poses = []
    for vid in dataset.train_id_list if hasattr(dataset, "train_id_list") \
            else range(len(dataset)):
        c2w = dataset._pose(vid) if hasattr(dataset, "_pose") else \
            dataset.c2w(vid)
        poses.append(c2w[:3, 3])
    return build_view_triplets(np.stack(poses), max_groups)
