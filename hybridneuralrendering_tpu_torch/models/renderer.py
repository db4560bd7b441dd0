"""End-to-end hybrid point-based renderer
(JAX: hybridneuralrendering_tpu/models/renderer.py).

query voxel grid -> gather point attributes -> reproject shading points into
the nearest views -> aggregate (viewmlp + hybrid fusion) -> ray distances ->
alpha compositing.  Miss rays stay masked (`ray_mask`) and composite to the
background colour.  Each stage runs inside a torch.profiler range named
"render.<stage>", so a profile of a request attributes device time by stage
(chip_smoke.py --profile).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from hybridneuralrendering_tpu_torch.config import Config
from hybridneuralrendering_tpu_torch.core import march
from hybridneuralrendering_tpu_torch.core.cameras import (
    delta_viewdirs, w2iproject, w2pers)
from hybridneuralrendering_tpu_torch.device import resolve
from hybridneuralrendering_tpu_torch.models import aggregator as agg
from hybridneuralrendering_tpu_torch.models import feature_pyramid
from hybridneuralrendering_tpu_torch.models import neural_points as npts
from hybridneuralrendering_tpu_torch.ops import query as Q
from hybridneuralrendering_tpu_torch.ops.voxel_grid import PointGrid


def init_params(cfg: Config, seed: int = 0, device="cuda") -> Dict:
    """Random full-width parameters from a seeded torch.Generator."""
    gen = torch.Generator().manual_seed(seed)
    return {"aggregator": agg.init(gen, cfg.agg, device=resolve(device))}


def _pyramid_dtypes(cfg: Config
                    ) -> Tuple[Optional[torch.dtype], Optional[torch.dtype]]:
    """(compute dtype, chain dtype) of the pyramid CNN, as JAX
    renderer._pyramid_dtypes: bf16 where compute_dtype / pyramid_dtype
    say so, else None (float32)."""
    bf = torch.bfloat16
    return (bf if cfg.agg.compute_dtype == "bfloat16" else None,
            bf if cfg.agg.pyramid_dtype == "bfloat16" else None)


def compute_image_features(params: Dict, cfg: Config,
                           images_nearest: torch.Tensor) -> torch.Tensor:
    """[V, H, W, 3] -> [V, H, W, 45] pyramid features of the nearest views
    (in pyramid_dtype)."""
    cdt, chain = _pyramid_dtypes(cfg)
    with record_function("render.pyramid"):
        return feature_pyramid.apply(params["aggregator"]["pyramid"],
                                     images_nearest, cfg.agg.act_type,
                                     chain_dtype=chain, compute_dtype=cdt)


def compute_image_feature_stages(params: Dict, cfg: Config,
                                 images_nearest: torch.Tensor):
    """[V, H, W, 3] -> the pre-upsample stage maps (s1, s2, s3) of the
    nearest views (in pyramid_dtype): the form the pyramid cache keeps."""
    cdt, chain = _pyramid_dtypes(cfg)
    with record_function("render.pyramid"):
        return feature_pyramid.apply_stages(
            params["aggregator"]["pyramid"], images_nearest,
            cfg.agg.act_type, chain_dtype=chain, compute_dtype=cdt)


def render(params: Dict, points: npts.NeuralPoints, grid: PointGrid,
           batch: Dict, cfg: Config,
           img_feat_n: Optional[torch.Tensor] = None, train: bool = False,
           noise: Optional[torch.Tensor] = None,
           img_feat_staged=None, prob: bool = False,
           drop_mask: Optional[torch.Tensor] = None) -> Dict:
    """Render one batch of rays.  Deterministic unless `train`: then
    `noise` [R, z_depth_dim] in [0, 1) jitters the candidate samples and
    the rays of `drop_mask` [R] lose their image features (by default
    aggregator.drop_ray_mask over this batch's R rays; a ray shard of a
    larger batch passes its rows of the larger batch's mask).

    batch: 'campos' [3], 'camrotc2w' [3,3], 'raydir' [R,3], 'bg_color' [3]
    (or 'bg_ray' [R,3], the plane background of train/step.maybe_add_bg_ray,
    which replaces it);
    the hybrid branch adds 'images_nearest' [V,H,W,3], 'c2w_nearest'
    [V,4,4], 'campos_nearest' [V,3], 'intrinsic_nearest' [3,3] and
    optionally 'frame_weight_nearest' [V] and 'view_mask' [V].
    `img_feat_n` passes precomputed pyramid features of the nearest views,
    `img_feat_staged` = (images_nearest, (s1, s2, s3)) cached stage maps
    (train/pyramid_cache.py); with either the pyramid CNN does not run.
    The point gather goes through its unique rows (cfg.agg.dedup_gather)
    when stage maps are given or cfg.agg.dedup_uncached is set, as in
    JAX renderer.py:87-93.  `prob` adds the point-growing outputs
    (prob_outputs)."""
    acfg, qcfg, rcfg = cfg.agg, cfg.querier, cfg.render
    campos, raydir = batch["campos"], batch["raydir"]
    R = raydir.shape[0]

    with record_function("render.query"):
        qres = Q.query_points(grid, points.xyz, campos, raydir, qcfg,
                              rcfg.near_plane, rcfg.far_plane, noise=noise,
                              train=train)
    dedup = acfg.dedup_gather if (img_feat_staged is not None
                                  or acfg.dedup_uncached) else 0
    with record_function("render.gather"):
        sampled = npts.gather(points, qres.sample_pidx, dedup)
    with record_function("render.project"):
        sample_loc = w2pers(qres.sample_loc_w, batch["camrotc2w"], campos)
        sampled_xyz_pers = w2pers(sampled.xyz, batch["camrotc2w"], campos)
        sample_ray_dirs = raydir[:, None, :].expand(R, qcfg.SR, 3)
        sample_loc_i_n = delta_vd_n = frame_w_n = None
        hybrid = acfg.use_nearest > 0 and "c2w_nearest" in batch
        if hybrid:
            intr_n = batch["intrinsic_nearest"]
            sample_loc_i_n = torch.stack(
                [w2iproject(qres.sample_loc_w, intr_n, c2w)[0]
                 for c2w in batch["c2w_nearest"]])             # [V,R,SR,2]
            delta_vd_n = torch.stack(
                [delta_viewdirs(qres.sample_loc_w, campos, cn)
                 for cn in batch["campos_nearest"]])           # [V,R,SR,3]
            frame_w_n = batch.get("frame_weight_nearest")
    if not hybrid:
        img_feat_n = img_feat_staged = None
    elif img_feat_n is None and img_feat_staged is None:
        img_feat_n = compute_image_features(params, cfg,
                                            batch["images_nearest"])

    if not train:
        drop_mask = None
    elif drop_mask is None and acfg.drop_ratio > 0:
        drop_mask = torch.as_tensor(agg.drop_ray_mask(
            acfg, R, cfg.sampling.dilation_patch_num,
            cfg.sampling.dilation_patch_size), device=raydir.device)

    with record_function("render.aggregate"):
        out = agg.apply(
            params["aggregator"], acfg,
            sampled_xyz=sampled.xyz, sampled_xyz_pers=sampled_xyz_pers,
            sampled_embedding=sampled.embedding,
            sampled_color=sampled.color, sampled_dir=sampled.dirs,
            sampled_conf=sampled.conf, pnt_mask=qres.pnt_mask,
            sample_loc=sample_loc, sample_loc_w=qres.sample_loc_w,
            sample_ray_dirs=sample_ray_dirs, vsize=qcfg.query_vsize,
            img_feat_n=img_feat_n, img_feat_staged=img_feat_staged,
            sample_loc_i_n=sample_loc_i_n,
            delta_viewdir_n=delta_vd_n, frame_weight_n=frame_w_n,
            view_mask=batch.get("view_mask"), drop_mask=drop_mask,
            sampled_rw2c=sampled.rw2c, train=train)

    with record_function("render.march"):
        ray_dist = march.ray_dist_from_depth(
            sample_loc[..., 2], out.ray_valid, qcfg.query_vsize[2],
            rcfg.raydist_mode_unit)
        bg_color = batch.get("bg_color")
        if bg_color is None:
            bg_color = torch.tensor(rcfg.bg_color, device=raydir.device)
        bg_ray = batch.get("bg_ray")
        if bg_ray is not None:
            # the plane background: no constant background in the march,
            # the per-ray plane colour under the background transmission
            bg_color = None
        (ray_color, _, opacity, _, blend_weight, bg_trans,
         _) = march.ray_march(
            ray_dist, out.ray_valid, out.features,
            march.RENDER_FUNCS[rcfg.which_render_func],
            march.BLEND_FUNCS[rcfg.which_blend_func], bg_color)
        if bg_ray is not None:
            ray_color = ray_color + bg_trans * bg_ray
        ray_color = march.TONEMAP_FUNCS[rcfg.which_tonemap_func](ray_color)
    output = {
        "coarse_raycolor": ray_color,              # [R, 3]
        "coarse_point_opacity": opacity,           # [R, SR]
        "coarse_is_background": bg_trans,          # [R, 1]
        "ray_mask": qres.ray_mask,                 # [R]
        "ray_valid": out.ray_valid,                # [R, SR]
        # no gradient flows through these two, as in the JAX package
        "weight": out.weight.detach(),
        "blend_weight": blend_weight.detach(),
        "conf_coefficient": out.conf_coefficient,
        "queried_shading": ~out.ray_valid.any(dim=-1, keepdim=True),
    }
    if prob:
        output.update(prob_outputs(opacity, qres.sample_loc_w, sampled,
                                   out.weight * out.conf_coefficient))
    return output


def prob_outputs(opacity: torch.Tensor, sample_loc_w: torch.Tensor,
                 sampled: npts.SampledPoints,
                 wconf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The point-growing outputs at each ray's max-opacity sample (JAX
    renderer.py:178-194; reference :394-425): that sample's opacity
    [R, 1] and world location [R, 3], its distance to the nearest of its K
    neighbours [R, 1], and the neighbours' colour, direction, conf and
    embedding summed with the weights `wconf` = weight * conf_coefficient
    [R, SR, K].  The argmax takes the first maximum, as jnp.argmax does."""
    R = opacity.shape[0]
    # the first index of the row maximum (torch.argmax does not promise
    # which of tied maxima it returns)
    SR = opacity.shape[1]
    idx = torch.arange(SR, device=opacity.device)
    is_max = opacity == opacity.max(dim=-1, keepdim=True).values
    op_ind = torch.where(is_max, idx, SR).min(dim=-1).values
    r_ix = torch.arange(R, device=opacity.device)
    max_loc = sample_loc_w[r_ix, op_ind]                       # [R, 3]
    wsel = wconf[r_ix, op_ind][..., None]                      # [R, K, 1]
    xyz_sel = sampled.xyz[r_ix, op_ind]                        # [R, K, 3]
    out = {
        "ray_max_shading_opacity": opacity[r_ix, op_ind][:, None],
        "ray_max_sample_loc_w": max_loc,
        "ray_max_far_dist": torch.linalg.vector_norm(
            xyz_sel - max_loc[:, None, :], dim=-1).min(
            dim=-1, keepdim=True).values,
    }
    for nm, arr in (("color", sampled.color), ("dir", sampled.dirs),
                    ("conf", sampled.conf[..., None]),
                    ("embedding", sampled.embedding)):
        out[f"shading_avg_{nm}"] = torch.sum(arr[r_ix, op_ind] * wsel,
                                             dim=-2)
    return out
