"""Hybrid image-feature fusion and mixup
(JAX: hybridneuralrendering_tpu/models/fusion.py).

Per-view pyramid features are read at each shading point's reprojection,
merged across views by a learned weight MLP (or, with
cfg.tradition_attention, by the QKV attention of models/attention.py), and
mixed with the 3D colour feature.  In training, the rays of `drop_mask`
lose their merged image feature after the fusion (the JAX package always
drops after fusion, which is `random_position=1`; it does not read the
knob, and neither does the port).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from hybridneuralrendering_tpu_torch.config import AggregatorConfig
from hybridneuralrendering_tpu_torch.models import (attention,
                                                   feature_pyramid, mlp)
from hybridneuralrendering_tpu_torch.models import neural_points as npts


def image_fusion(params: Dict, cfg: AggregatorConfig,
                 color_feature: torch.Tensor,
                 img_feat_n: Optional[torch.Tensor],
                 sample_loc_i_n: Optional[torch.Tensor],
                 delta_viewdir_n: Optional[torch.Tensor],
                 frame_weight_n: Optional[torch.Tensor] = None,
                 view_mask: Optional[torch.Tensor] = None,
                 drop_mask: Optional[torch.Tensor] = None,
                 img_feat_staged: Optional[Tuple] = None,
                 compute_dtype: Optional[torch.dtype] = None
                 ) -> torch.Tensor:
    """Merged per-sample image feature [R, SR, aux_c], zeros when the image
    branch is off.  img_feat_n [V, H, W, C]; sample_loc_i_n [V, R, SR, 2]
    pixel positions; delta_viewdir_n [V, R, SR, 3]; drop_mask [R] bool,
    rays whose merged feature is zeroed (training only).

    img_feat_staged = (images [V, H, W, 3], (s1, s2, s3)) are cached stage
    maps (JAX fusion.py:36-60): with cfg.staged_materialize they are
    upsampled to a full map (feature_pyramid.materialize) and read by the
    flat row gather, otherwise sampled per sample (gather_staged).  A
    cached map carries no gradient, so its gather records no backward.
    `compute_dtype` rounds the fusion-weight MLP's hidden products (its
    head stays float32, as in JAX fusion.py:137-142)."""
    f32 = color_feature.dtype
    aux_c = cfg.aux_feature_channels
    has_img = img_feat_n is not None or img_feat_staged is not None
    if not (cfg.use_nearest > 0 and has_img):
        return color_feature.new_zeros(color_feature.shape[:-1] + (aux_c,))
    chain_dt = torch.bfloat16 if cfg.pyramid_dtype == "bfloat16" else None
    if img_feat_staged is not None and cfg.staged_materialize:
        images_n, stages = img_feat_staged
        img_feat_n = feature_pyramid.materialize(images_n, stages,
                                                 dtype=chain_dt)
        img_feat_staged = None
    if img_feat_staged is not None:
        images_n, stages = img_feat_staged
        V, H, W, _ = images_n.shape
    else:
        V, H, W, C = img_feat_n.shape
    px = sample_loc_i_n[..., 0].to(torch.int32)                 # [V, R, SR]
    py = sample_loc_i_n[..., 1].to(torch.int32)
    valid = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    if view_mask is not None:
        valid = valid & (view_mask > 0)[:, None, None]
    if img_feat_staged is not None:
        img_feat = feature_pyramid.gather_staged(
            images_n, stages, torch.clamp(py, 0, H - 1).long(),
            torch.clamp(px, 0, W - 1).long(), dtype=chain_dt)[..., :aux_c]
    else:
        # a flat row gather; off-image samples read row 0, are zeroed
        # below, and their (zero) cotangent goes to row 0
        # (neural_points.gather_rows; a cached map requires no gradient,
        # so autograd records no backward for it)
        vidx = torch.arange(V, device=px.device)[:, None, None]
        fid = torch.where(valid, (vidx * H + py) * W + px, -1)
        img_feat = npts.gather_rows(img_feat_n.reshape(V * H * W, C),
                                    fid)[..., :aux_c]
    img_feat = img_feat * valid[..., None].to(f32)

    if cfg.tradition_attention:
        merged = _attention_merge(params, cfg, color_feature, img_feat,
                                  delta_viewdir_n, valid)
    else:
        parts = [img_feat, color_feature[None]]
        if cfg.use_delta_view:
            parts.append(delta_viewdir_n)
        layers = params["fusion_weight"]
        h = mlp.mlp_apply_split(layers[:-1], parts, cfg.act_type,
                                final_act=True, compute_dtype=compute_dtype)
        head = layers[-1]
        fusion_w = torch.sigmoid(h @ head["w"][:, 0] + head["b"][0])
        fusion_w = fusion_w * valid.to(f32)                      # [V, R, SR]
        if cfg.downweight_blurry_feats and frame_weight_n is not None:
            fusion_w = fusion_w * frame_weight_n[:, None, None]
        merged = torch.sum(img_feat * fusion_w[..., None], dim=0) / (
            torch.sum(fusion_w, dim=0)[..., None] + 1e-6)
    if drop_mask is not None:
        merged = merged * (1.0 - drop_mask[:, None, None].to(f32))
    return merged


def _attention_merge(params: Dict, cfg: AggregatorConfig,
                     color_feature: torch.Tensor, img_feat: torch.Tensor,
                     delta_viewdir_n: Optional[torch.Tensor],
                     valid: torch.Tensor) -> torch.Tensor:
    """The attention fusion (JAX fusion.py:79-94): the context [img_feat,
    delta_viewdir] goes from [V, R, SR, C] to [R*SR, V, C], the colour
    feature is the query, and the first aux_c channels of the fused
    result are the merged feature [R, SR, aux_c].  JAX passes no key, so
    the Gumbel selection is the hard one-hot in training too."""
    V, R, SR = valid.shape
    ctx = img_feat
    if cfg.use_delta_view:
        ctx = torch.cat([img_feat, delta_viewdir_n], dim=-1)
    ctx_b = ctx.permute(1, 2, 0, 3).reshape(R * SR, V, ctx.shape[-1])
    valid_b = valid.permute(1, 2, 0).reshape(R * SR, V)
    fused = attention.apply(params["attention"],
                            color_feature.reshape(R * SR, -1), ctx_b,
                            valid=valid_b, use_gumbel=cfg.use_gumbel_softmax)
    return fused.reshape(R, SR, -1)[..., :cfg.aux_feature_channels]


def mixup(params: Dict, cfg: AggregatorConfig, color_feature: torch.Tensor,
          merged: torch.Tensor,
          compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Mix the 3D colour feature with the merged image feature;
    `compute_dtype` rounds the mixup MLP's products (not the
    dynamic-weight head's, as in JAX)."""
    aux_c = cfg.aux_feature_channels
    if cfg.mixup_mode == "partial":
        intrinsic = color_feature[..., :aux_c]
        view_part = color_feature[..., aux_c:]
        mix_in = torch.cat([intrinsic, merged], dim=-1)
        if cfg.dynamic_weight:
            bw = torch.sigmoid(mlp.mlp_apply(params["mixup"], mix_in,
                                             cfg.act_type))
            mixed = (1 - bw) * intrinsic + bw * merged
        else:
            mixed = mlp.mlp_apply(params["mixup"], mix_in, cfg.act_type,
                                  final_act=not cfg.learn_residuals,
                                  compute_dtype=compute_dtype)
        if cfg.learn_residuals:
            mixed = mixed + intrinsic
        return torch.cat([mixed, view_part], dim=-1)
    mix_in = torch.cat([color_feature, merged], dim=-1)
    if cfg.dynamic_weight:
        bw = torch.sigmoid(mlp.mlp_apply(params["mixup"], mix_in,
                                         cfg.act_type))
        return (1 - bw) * color_feature + bw * merged
    out = mlp.mlp_apply(params["mixup"], mix_in, cfg.act_type,
                        final_act=not cfg.learn_residuals,
                        compute_dtype=compute_dtype)
    if cfg.learn_residuals:
        out = out + color_feature
    return out
