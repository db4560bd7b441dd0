"""The viewmlp point aggregator with hybrid image-feature fusion
(JAX: hybridneuralrendering_tpu/models/aggregator.py).

Every MLP runs over the full [R, SR, K] neighbour block with `pnt_mask`
zeroing the empty slots.  The per-neighbour chain runs as the fused chain
of ops/shading_chain (the port of tools/pallas_shading.py's kernel) in
shading_chain.chain_dtype(cfg): in bf16 the operands of its products are
bf16 and its sums, bias and activations f32, where the JAX package's
shipped shading_dtype chain is bf16 end to end; the K-sum accumulates in
float32.  `chain_chunks` runs the chain and its K-sum over that many ray
chunks one after another (when they divide R, as JAX's lax.scan), and
`remat_chain` wraps each chunk in torch.utils.checkpoint, so that the
backward recomputes it and no [rows, F] feature is kept between the
passes (jax.checkpoint with nothing_saveable).  `compute_dtype` rounds
the colour branch's, fusion's and mixup's products.  In training
(`train=True`) the rays of drop_ray_mask lose their image feature, and
with `separate_color_decoder` take their colour from color_final_2 on the
point feature alone.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from hybridneuralrendering_tpu_torch.config import AggregatorConfig
from hybridneuralrendering_tpu_torch.core.cameras import pers_delta
from hybridneuralrendering_tpu_torch.core.encoding import positional_encoding
from hybridneuralrendering_tpu_torch.core.geometrics import (
    compute_world2local_dist)
from hybridneuralrendering_tpu_torch.core.sh import sh_basis
from hybridneuralrendering_tpu_torch.models import (attention,
                                                   feature_pyramid, fusion,
                                                   mlp)
from hybridneuralrendering_tpu_torch.ops import shading_chain


def dist_weight(name: str, dists: torch.Tensor,
                pnt_mask: torch.Tensor) -> torch.Tensor:
    """dists [R, SR, K, C]; pnt_mask [R, SR, K] -> weights [R, SR, K].
    Norms clamp under the sqrt, so masked (zero) slots stay finite."""
    m = pnt_mask.to(dists.dtype)
    if name == "linear":
        return m * (1.0 / torch.sqrt(torch.clamp(
            torch.sum(dists[..., :3] ** 2, dim=-1), min=1e-12)))
    if name == "numlinear":
        w = m / torch.sqrt(torch.clamp(torch.sum(dists ** 2, dim=-1),
                                       min=1e-12))
        return w / torch.clamp(torch.sum(m, dim=-1, keepdim=True), min=1.0)
    if name == "quadric":
        return m / torch.clamp(torch.sum(dists[..., :3] ** 2, dim=-1),
                               min=1e-8)
    if name == "numquadric":
        return m / torch.clamp(torch.sum(dists ** 2, dim=-1), min=1e-8)
    if name == "avg":
        return m
    if name == "trilinear":
        d = 1.0 - torch.abs(dists[..., :3])
        w = m * d[..., 0] * d[..., 1] * d[..., 2]
        return w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-8)
    raise KeyError(f"unknown distance kernel {name}")


SH_DEGREE = 4   # sh_intrp's bands (JAX dist_weight_ex's sh_degree)


def dist_weight_ex(name: str, dists: torch.Tensor, pnt_mask: torch.Tensor,
                   embedding: torch.Tensor, vsize, grid_vox_sz: float,
                   sh_degree: int = SH_DEGREE):
    """The distance kernels that consume leading embedding channels (JAX
    aggregator.py:72-101): (weights [R, SR, K], the remaining embedding).
    sh_intrp reads sh_degree**2 SH coefficients per point, gau_intrp a
    scale, three radii and three roll-pitch-yaw angles (clipped to
    +-pi/4); the others leave the embedding whole.  The remaining
    embedding is a contiguous copy (the fused chain takes contiguous
    inputs); gradients reach the consumed channels through the weights."""
    m = pnt_mask.to(dists.dtype)
    if name == "trilinear":
        scaled = dists * m[..., None] / grid_vox_sz
        return dist_weight("trilinear", scaled, pnt_mask), embedding
    if name == "sh_intrp":
        dist_norm = torch.sqrt(torch.clamp(torch.sum(dists ** 2, dim=-1),
                                           min=1e-16))
        dirs = dists / torch.clamp(dist_norm[..., None], min=1e-8)
        nb = sh_degree ** 2
        shall = sh_basis(dirs, sh_degree, flip_dir=False)
        w = m * torch.sum(torch.sigmoid(shall * embedding[..., :nb]),
                          dim=-1) * (1.0 / torch.clamp(dist_norm, min=1e-8))
        return w, embedding[..., nb:].contiguous()
    if name == "gau_intrp":
        scale = torch.abs(embedding[..., 0])
        radii = vsize[2] * 20.0 * torch.sigmoid(embedding[..., 1:4])
        rot = torch.clamp(embedding[..., 4:7], -np.pi / 4, np.pi / 4)
        gau = compute_world2local_dist(dists[..., :3], radii, rot)
        w = m * scale * torch.exp(-0.5 * torch.sum(gau ** 2, dim=-1))
        return w, embedding[..., 7:].contiguous()
    return dist_weight(name, dists, pnt_mask), embedding


def consumed_channels(cfg: AggregatorConfig) -> int:
    """Leading embedding channels the distance kernel reads (JAX
    aggregator.py:128-139)."""
    if cfg.agg_distance_kernel == "sh_intrp":
        return SH_DEGREE ** 2
    if cfg.agg_distance_kernel == "gau_intrp":
        return 7
    return 0


def gradient_clamp(conf: torch.Tensor, lo=0.0001, hi=1.0) -> torch.Tensor:
    """Clamped value forward, identity gradient."""
    return conf - (conf - torch.clamp(conf, lo, hi)).detach()


def raw2density(raw: torch.Tensor, act_super: bool) -> torch.Tensor:
    return F.softplus(raw - 1.0) if act_super else F.relu(raw)


def raw2color(raw: torch.Tensor, act_super: bool) -> torch.Tensor:
    c = torch.sigmoid(raw)
    if act_super:
        c = c * (1 + 2 * 0.001) - 0.001
    return c


def block1_in_dim(cfg: AggregatorConfig) -> int:
    dist_xyz_dim = (cfg.dist_dim if cfg.dist_xyz_freq == 0
                    else 2 * abs(cfg.dist_xyz_freq) * cfg.dist_dim)
    in_ch = cfg.point_features_dim - consumed_channels(cfg)
    in_ch += 2 * cfg.num_feat_freqs * in_ch if cfg.num_feat_freqs > 0 else 0
    in_ch += dist_xyz_dim if cfg.agg_intrp_order > 0 else 0
    return in_ch


def viewdir_channels(cfg: AggregatorConfig) -> int:
    return 2 * cfg.num_viewdir_freqs * 3 if cfg.num_viewdir_freqs > 0 else 3


def _check_supported(cfg: AggregatorConfig) -> None:
    """Raise for a chain the fused kernels do not take (no JAX preset sets
    either knob)."""
    unported = {
        "a chain without block3 or an alpha head "
        "(shading_feature_mlp_layer3 == 0)":
            cfg.shading_feature_mlp_layer3 == 0,
        "act_type != leaky_relu in the shading chain":
            cfg.act_type != "leaky_relu",
    }
    missing = [k for k, v in unported.items() if v]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")


def init(gen: torch.Generator, cfg: AggregatorConfig,
         device="cuda") -> Dict:
    """Random parameters of the shapes the JAX package's aggregator.init
    makes (xavier-uniform from `gen`)."""
    _check_supported(cfg)
    act = cfg.act_type
    F_ = cfg.shading_feature_num
    half = F_ // 2
    aux_c = cfg.aux_feature_channels

    def stack(dims, final_act=False):
        return mlp.mlp_init(gen, dims, act, final_act, device)

    params: Dict = {}
    if cfg.shading_feature_mlp_layer1 > 0:
        params["block1"] = stack([block1_in_dim(cfg)]
                                 + [F_] * cfg.shading_feature_mlp_layer1,
                                 True)
    if cfg.shading_feature_mlp_layer2 > 0:
        params["block2"] = stack([F_] * (cfg.shading_feature_mlp_layer2 + 1),
                                 True)
    if cfg.shading_feature_mlp_layer3 > 0:
        in3 = F_ + (3 if "1" in cfg.point_color_mode else 0) + (
            4 if "1" in cfg.point_dir_mode else 0)
        params["block3"] = stack([in3] + [F_] * cfg.shading_feature_mlp_layer3,
                                 True)
    params["alpha"] = stack([F_] + [half] * (cfg.shading_alpha_mlp_layer - 1)
                            + [1])
    c_in = F_ + viewdir_channels(cfg)
    params["color"] = stack([c_in] + [half] * (cfg.shading_color_mlp_layer - 1)
                            + [3])
    params["color_feature"] = stack(
        [c_in] + [half] * (cfg.shading_color_mlp_layer - 1), True)
    if cfg.use_nearest >= 0:
        if cfg.tradition_attention:
            # the colour feature queries the per-view image features and
            # delta view directions (JAX aggregator.py:180-186)
            ctx = aux_c + (3 if cfg.use_delta_view else 0)
            params["attention"] = attention.init(gen, half, ctx,
                                                 inner_channels=16,
                                                 device=device)
        else:
            fin = aux_c + half + (3 if cfg.use_delta_view else 0)
            params["fusion_weight"] = stack([fin] + [half // 2] * 3 + [1])
        params["pyramid"] = feature_pyramid.init(
            gen, act, in_ch=3 + (2 if cfg.add_idx else 0), device=device)
    if cfg.mixup_mode == "partial":
        if half <= aux_c:
            raise ValueError(f"partial mixup needs shading_feature_num/2 "
                             f"({half}) > aux channels ({aux_c})")
        mix_in, mix_out = 2 * aux_c, aux_c
    else:
        mix_in, mix_out = half + aux_c, half
    mdims = [mix_in] + [mix_out] * 3 + ([1] if cfg.dynamic_weight else [])
    params["mixup"] = stack(mdims, not cfg.learn_residuals
                            and not cfg.dynamic_weight)
    final_in = half if cfg.feature_guidance else aux_c
    params["color_final"] = stack(
        [final_in, final_in, 3] if cfg.large_color_final_block
        else [final_in, 3])
    if cfg.separate_color_decoder:
        params["color_final_2"] = stack([final_in, 3])
    if cfg.learnable_blur_kernel:
        # the blur-kernel MLP (models/blur.learnable_blur_update): grey GT
        # and render patches in, K*K kernel weights (+ the identity's mix
        # weight in modes 2 and 4) out
        bout = cfg.learnable_blur_kernel_size ** 2
        if cfg.learnable_blur_kernel_mode in (2, 4):
            bout += 1
        params["blur_kernel"] = stack(
            [2 * cfg.learnable_blur_patch_size ** 2, 128, 128, 128, bout])
    return params


def drop_ray_mask(cfg: AggregatorConfig, num_rays: int, patch_num: int,
                  patch_size: int) -> np.ndarray:
    """Rays whose image features are dropped in training: with the patch
    layout [patch_num*patch_size]^2 row-major, the first
    floor(patch_num^2 * drop_ratio) patches.  A static bool [num_rays]."""
    if cfg.drop_ratio <= 0:
        return np.zeros(num_rays, bool)
    side = patch_num * patch_size
    if cfg.drop_patch and side * side == num_rays:
        flag = np.zeros((side, side), bool)
        n_drop = int(patch_num * patch_num * cfg.drop_ratio)
        row, col = n_drop // patch_num, n_drop % patch_num
        flag[: row * patch_size, :] = True
        flag[row * patch_size: (row + 1) * patch_size,
             : col * patch_size] = True
        return flag.reshape(-1)
    flag = np.zeros(num_rays, bool)
    flag[: int(num_rays * cfg.drop_ratio)] = True
    return flag


class AggOutput(NamedTuple):
    features: torch.Tensor          # [R, SR, 1+3] (sigma, rgb)
    ray_valid: torch.Tensor         # [R, SR] bool
    weight: torch.Tensor            # [R, SR, K]
    conf_coefficient: torch.Tensor  # [R, SR, K]


def build_dists(cfg: AggregatorConfig, sampled_xyz, sampled_xyz_pers,
                sample_loc, sample_loc_w, sample_ray_dirs) -> torch.Tensor:
    """Neighbour offsets by agg_dist_pers: world and/or perspective."""
    p = cfg.agg_dist_pers
    wd = sampled_xyz - sample_loc_w[..., None, :]
    if p == 0:
        return wd
    if p == 1:
        return sampled_xyz_pers - sample_loc[..., None, :]
    if p == 2:
        return pers_delta(sampled_xyz_pers, sample_loc)
    if p == 10:
        return torch.cat([wd, sampled_xyz_pers - sample_loc[..., None, :]],
                         dim=-1)
    if p == 20:
        return torch.cat([wd, pers_delta(sampled_xyz_pers, sample_loc)],
                         dim=-1)
    if p == 30:
        proj = torch.sum(wd * sample_ray_dirs[..., None, :], dim=-1,
                         keepdim=True)
        return torch.cat([proj, wd], dim=-1)
    raise ValueError(f"illegal agg_dist_pers {p}")


def _shading_chain(p: Dict, cfg: AggregatorConfig, emb, dflat, extras,
                   mask_w):
    """Per-neighbour MLP chain through the K-aggregation: returns
    (density [R, SR, 1], aggregated feature [R, SR, F]).  The chain itself
    (positional encodings, block1 [+ block2], block3, alpha head) is
    ops/shading_chain.fused_feat_alpha: the hand-written kernels on the
    card, their plain versions on the CPU.  On the card the weights are
    packed once for every chunk and recompute."""
    extra = (torch.cat(extras, dim=-1) if extras
             else emb.new_zeros(emb.shape[:-1] + (0,)))
    packed = None
    if emb.is_cuda:
        packed = shading_chain.pack_for(p, cfg, emb.shape[-1],
                                        dflat.shape[-1], extra.shape[-1])

    def chain_fn(emb_c, dflat_c, extra_c, mw_c):
        lead = emb_c.shape[:-1]
        n = int(np.prod(lead))
        ft, a_raw = shading_chain.fused_feat_alpha(
            p, cfg, emb_c.reshape(n, -1), dflat_c.reshape(n, -1),
            extra_c.reshape(n, -1), packed)
        ft = ft.reshape(lead + (-1,))
        a_raw = a_raw.reshape(lead)
        return (torch.sum(raw2density(a_raw, cfg.act_super) * mw_c,
                          dim=-1)[..., None],
                torch.sum(ft * mw_c[..., None], dim=-2))

    def run(*xs):
        if cfg.remat_chain and torch.is_grad_enabled():
            return checkpoint(chain_fn, *xs, use_reentrant=False)
        return chain_fn(*xs)

    xs = (emb, dflat, extra, mask_w)
    nc, R = cfg.chain_chunks, emb.shape[0]
    if nc <= 1 or R % nc:
        return run(*xs)
    return join_chunks([run(*c) for c in zip(*(torch.chunk(x, nc)
                                                for x in xs))])


def join_chunks(outs):
    """The ray chunks' (density, feature) pairs joined in ray order."""
    return tuple(torch.cat(parts) for parts in zip(*outs))


def apply(params: Dict, cfg: AggregatorConfig, *,
          sampled_xyz, sampled_xyz_pers, sampled_embedding, sampled_color,
          sampled_dir, sampled_conf, pnt_mask, sample_loc, sample_loc_w,
          sample_ray_dirs, vsize,
          img_feat_n: Optional[torch.Tensor] = None,
          img_feat_staged=None,
          sample_loc_i_n: Optional[torch.Tensor] = None,
          delta_viewdir_n: Optional[torch.Tensor] = None,
          frame_weight_n: Optional[torch.Tensor] = None,
          view_mask: Optional[torch.Tensor] = None,
          drop_mask: Optional[torch.Tensor] = None,
          train: bool = False) -> AggOutput:
    """Shade all [R, SR] samples from their K gathered neighbours.

    img_feat_n [V, H, W, 45] pyramid features of the nearest views, or
    img_feat_staged = (images, (s1, s2, s3)) their cached stage maps
    (fusion.image_fusion); sample_loc_i_n [V, R, SR, 2] reprojected pixel positions; drop_mask [R]
    bool, rays whose image features are dropped (read only when `train`)."""
    _check_supported(cfg)
    cdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    f32 = sampled_xyz.dtype
    ray_valid = pnt_mask.any(dim=-1)
    dists = build_dists(cfg, sampled_xyz, sampled_xyz_pers, sample_loc,
                        sample_loc_w, sample_ray_dirs)
    dists = dists * pnt_mask[..., None].to(f32)

    weight, sampled_embedding = dist_weight_ex(
        cfg.agg_distance_kernel, dists, pnt_mask, sampled_embedding, vsize,
        grid_vox_sz=vsize[2])
    if (cfg.agg_weight_norm and cfg.agg_distance_kernel != "trilinear"
            and not cfg.agg_distance_kernel.startswith("num")):
        weight = weight / torch.clamp(torch.sum(weight, dim=-1, keepdim=True),
                                      min=1e-8)
    conf_coefficient = gradient_clamp(sampled_conf)
    w = weight * conf_coefficient

    dists_flat = dists
    if cfg.dist_xyz_deno > 0:
        dists_flat = dists_flat / (cfg.dist_xyz_deno
                                   * float(np.linalg.norm(vsize)))
    vdirs = positional_encoding(sample_ray_dirs, cfg.num_viewdir_freqs,
                                ori=True)
    ori_viewdirs, vdirs_enc = vdirs[..., :3], vdirs[..., 3:]

    extras = []
    if cfg.shading_feature_mlp_layer3 > 0:
        if "1" in cfg.point_color_mode:
            extras.append(sampled_color)
        if "1" in cfg.point_dir_mode:
            extras += [sampled_dir - ori_viewdirs[..., None, :],
                       torch.sum(sampled_dir * ori_viewdirs[..., None, :],
                                 dim=-1, keepdim=True)]
    mask_w = pnt_mask.to(f32) * w
    chain_params = {k: params[k] for k in ("block1", "block2", "block3",
                                           "alpha") if k in params}
    with record_function("agg.chain"):
        alpha, feat_agg = _shading_chain(chain_params, cfg,
                                         sampled_embedding, dists_flat,
                                         extras, mask_w)

    vd = torch.zeros_like(vdirs_enc) if cfg.disable_viewdirs else vdirs_enc
    color_feature = mlp.mlp_apply(params["color_feature"],
                                  torch.cat([feat_agg, vd], dim=-1),
                                  cfg.act_type, final_act=True,
                                  compute_dtype=cdt)
    if cfg.disable_color_feature:
        color_feature = color_feature * 0.0

    with record_function("agg.fusion"):
        merged = fusion.image_fusion(params, cfg, color_feature, img_feat_n,
                                     sample_loc_i_n, delta_viewdir_n,
                                     frame_weight_n, view_mask,
                                     drop_mask if train else None,
                                     img_feat_staged, compute_dtype=cdt)
    color_feature_mix = fusion.mixup(params, cfg, color_feature, merged,
                                     compute_dtype=cdt)
    if cfg.separate_color_decoder and train and drop_mask is not None:
        # the dropped rays' colour from the point feature alone, through
        # the second decoder (JAX aggregator.py:481-491; both heads
        # float32 there)
        rgb_mix = raw2color(mlp.mlp_apply(params["color_final"],
                                          color_feature_mix, cfg.act_type),
                            cfg.act_super)
        rgb_pnt = raw2color(mlp.mlp_apply(params["color_final_2"],
                                          color_feature, cfg.act_type),
                            cfg.act_super)
        dm = drop_mask[:, None, None].to(f32)
        rgb = rgb_pnt * dm + rgb_mix * (1 - dm)
    else:
        rgb = raw2color(mlp.mlp_apply(params["color_final"],
                                      color_feature_mix, cfg.act_type,
                                      compute_dtype=cdt), cfg.act_super)
    out = torch.cat([alpha, rgb], dim=-1) * ray_valid[..., None].to(f32)
    return AggOutput(features=out, ray_valid=ray_valid, weight=weight,
                     conf_coefficient=conf_coefficient)
