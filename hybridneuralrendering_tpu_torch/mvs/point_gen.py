"""Neural points from posed images: depth per view group, unprojection and
per-point embeddings (JAX: hybridneuralrendering_tpu/mvs/point_gen.py;
reference models/mvs/mvs_points_model.py).

The depth of a group's reference view comes from the sensor, from the
pretrained MVSNet's plane sweep (mvs/mvsnet.py), or from the learned
ProbNet volume over the FPN features (manual_depth_view = -1, trained in
feed-forward mode).  `query_embedding` samples view 0's FeatureNet
pyramid ('imgfeat_0_0123'), the direction to view 0's camera in world
coordinates ('dir_0') and the confidence ('point_conf') at each point,
and compresses them to point_features_dim with the pre-MLP
(mvs_points_model.py:225-259).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from hybridneuralrendering_tpu_torch.models import mlp
from hybridneuralrendering_tpu_torch.mvs import features as F
from hybridneuralrendering_tpu_torch.mvs import mvsnet
from hybridneuralrendering_tpu_torch.mvs.warp import (bilinear_sample,
                                                      project_to_view)
from hybridneuralrendering_tpu_torch.train.state import tree_map


class MvsPointsParams(NamedTuple):
    feature: Dict            # FeatureNet
    mvsnet: Optional[Dict]   # pretrained depth estimator (None with GT depth)
    premlp: Optional[List]   # embedding compressor
    # manual_depth_view = -1 (learned depth, mvs_points_model.py:282-296):
    # the cost-volume U-Net and ProbNet over the FPN features
    cost_reg: Optional[Dict] = None
    prob_net: Optional[Dict] = None


def map_params(fn: Callable, params: MvsPointsParams,
               *rest: MvsPointsParams) -> MvsPointsParams:
    """fn over every tensor of the present parts; absent parts stay None."""
    return MvsPointsParams(*(
        None if part is None else tree_map(fn, part, *(r[i] for r in rest))
        for i, part in enumerate(params)))


# imgfeat_0_0123: RGB (the colours) and 8 + 16 + 32 feature channels
IMGFEAT_CHANNELS = 8 + 16 + 32


def init(gen: torch.Generator, point_features_dim: int = 32,
         use_mvsnet: bool = True, use_premlp: bool = True,
         act: str = "leaky_relu", use_probnet: bool = False,
         device="cpu") -> MvsPointsParams:
    """Fresh MVS networks from `gen`, with JAX's tree and shapes."""
    feature = F.feature_net_init(gen, device)
    net = mvsnet.init(gen, device) if use_mvsnet else None
    prem = None
    if use_premlp:
        # the pre-MLP's input: features, colour (3), direction (3), conf (1)
        in_dim = IMGFEAT_CHANNELS + 3 + 3 + 1
        prem = mlp.mlp_init(gen, [in_dim, point_features_dim], act,
                            device=device)
    return MvsPointsParams(
        feature=feature, mvsnet=net, premlp=prem,
        cost_reg=F.cost_reg_init(gen, 32, device) if use_probnet else None,
        prob_net=F.prob_net_init(gen, 8, device) if use_probnet else None)


def query_embedding(params: MvsPointsParams, cam_xyz: torch.Tensor,
                    images: torch.Tensor, c2ws: torch.Tensor,
                    w2cs: torch.Tensor, intrinsic: torch.Tensor,
                    cam_vid: int, confidence: Optional[torch.Tensor] = None,
                    act: str = "leaky_relu"
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Per-point (embedding, colour, direction, conf) from view 0's
    features.  cam_xyz [N, 3] in view cam_vid's camera; images
    [V, H, W, 3]; c2ws, w2cs [V, 4, 4].  The feature spec is the
    canonical 'imgfeat_0_0123 dir_0 point_conf' (scene241_full.sh:36)."""
    H, W = images.shape[1:3]
    dev = cam_xyz.device
    pyr = F.feature_net_apply(params.feature, images, intermediate=True)
    vid = 0
    if vid == cam_vid:
        eye = torch.eye(4, dtype=cam_xyz.dtype, device=dev)
        xy, mask = project_to_view(cam_xyz, eye, eye, intrinsic, H, W)
    else:
        xy, mask = project_to_view(cam_xyz, c2ws[cam_vid], w2cs[vid],
                                   intrinsic, H, W)
    feats, colors = [], None
    for lid, fmap in enumerate(pyr):
        # JAX point_gen.py:81 scales by fmap.shape[0] / H, the view count
        # over the height, where the level's height over H was meant; the
        # port keeps JAX's arithmetic (ROADMAP Queue 3)
        scale = fmap.shape[0] / H
        sampled = bilinear_sample(fmap[vid], xy * scale, mask)
        if lid == 0:
            colors = sampled
        else:
            feats.append(sampled)
    embedding = torch.cat(feats, dim=-1)                       # [N, 56]

    # dir_0: the unit vector from view 0's camera to the point, in world
    cam_pos = torch.cat([c2ws[vid, :3, 3],
                         torch.ones(1, dtype=c2ws.dtype, device=dev)])
    cam_pos_cam = (cam_pos @ w2cs[cam_vid].T)[:3]
    dirs = cam_xyz - cam_pos_cam
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-6)
    dirs = dirs @ c2ws[cam_vid, :3, :3].T

    if confidence is None:
        conf = torch.ones_like(embedding[..., :1])
    else:
        conf = confidence.reshape(-1, 1)
    if params.premlp is not None:
        embedding = mlp.mlp_apply(
            params.premlp, torch.cat([embedding, colors, dirs, conf], -1),
            act)
    return embedding, colors, dirs, conf


def depth_planes(near: float, far: float, num_depths: int,
                 device) -> torch.Tensor:
    """The sweep's planes, float32 (jnp.linspace's, within one ulp: the
    two round some planes differently)."""
    return torch.linspace(near, far, num_depths, dtype=torch.float32,
                          device=device)


def quarter(intrinsic: torch.Tensor) -> torch.Tensor:
    k = intrinsic.clone()
    k[:2] = k[:2] * 0.25
    return k


def gen_depth(params: MvsPointsParams, images: torch.Tensor,
              intrinsic: torch.Tensor, w2cs: torch.Tensor, near: float,
              far: float, num_depths: int = 192):
    """The pretrained MVSNet's depth and confidence of the group's
    reference view at 1/4 resolution.  Returns (depth [h, w], conf
    [h, w], the quarter-scale intrinsics [3, 3])."""
    depth, conf = mvsnet.depth_from_views(
        params.mvsnet, images, intrinsic, w2cs,
        depth_planes(near, far, num_depths, images.device))
    return depth, conf, quarter(intrinsic)


def gen_depth_learned(params: MvsPointsParams, images: torch.Tensor,
                      intrinsic: torch.Tensor, w2cs: torch.Tensor,
                      near: float, far: float, num_depths: int = 128,
                      train: bool = False):
    """manual_depth_view = -1 (mvs_points_model.py:282-296): the FPN
    FeatureNet's 1/4 features build the plane-sweep variance volume, the
    U-Net regularises it to 8 channels, ProbNet turns it into a
    probability over depth; expected depth and confidence as in MVSNet.
    Returns (depth [h, w], conf [h, w], the quarter-scale intrinsics)."""
    feats = F.feature_net_apply(params.feature, images, train,
                                intermediate=False)[0]       # [V, h, w, 32]
    dv = depth_planes(near, far, num_depths, images.device)
    variance = mvsnet.variance_volume(feats, intrinsic, w2cs, dv)
    reg = F.cost_reg_apply(params.cost_reg, variance, train)
    prob = F.prob_net_apply(params.prob_net, reg, train)[..., 0]
    depth, conf = mvsnet.regress(prob, dv)
    return depth, conf, quarter(intrinsic)


def gen_points(params: MvsPointsParams, images: torch.Tensor,
               intrinsic: torch.Tensor, w2cs: torch.Tensor, near: float,
               far: float, num_depths: int = 192,
               depth_gt: Optional[torch.Tensor] = None,
               conf_thresh: float = 0.8, learned: bool = False):
    """The reference view's points in its camera (gen_points,
    mvs_points_model.py:262-341): from the sensor depth `depth_gt` at full
    resolution (conf 1), the learned ProbNet volume (`learned`) or the
    pretrained MVSNet at 1/4.  Returns (cam_xyz [M, 3], conf [M], mask
    [M]: depth > 0 and conf > conf_thresh), M = the depth map's pixels."""
    if depth_gt is not None:
        depth, conf, k = depth_gt, torch.ones_like(depth_gt), intrinsic
    elif learned:
        depth, conf, k = gen_depth_learned(params, images, intrinsic, w2cs,
                                           near, far, num_depths)
    else:
        depth, conf, k = gen_depth(params, images, intrinsic, w2cs, near,
                                   far, num_depths)
    cam_xyz = mvsnet.depth_to_cam_xyz(depth, k)
    mask = (depth.reshape(-1) > 0) & (conf.reshape(-1) > conf_thresh)
    return cam_xyz, conf.reshape(-1), mask
