"""Alpha compositing along rays and its function registries
(JAX: hybridneuralrendering_tpu/core/march.py)."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def radiance_render(ray_feature: torch.Tensor) -> torch.Tensor:
    return ray_feature[..., 1:]


def white_color(ray_feature: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(ray_feature[..., 1:4])


def alpha_blend(opacity, acc_transmission):
    return opacity * acc_transmission


def alpha2_blend(opacity, acc_transmission):
    return opacity * acc_transmission * acc_transmission


def simple_tone_map(color: torch.Tensor, gamma: float = 2.2,
                    exposure: float = 1.0) -> torch.Tensor:
    return torch.clamp(torch.pow(color * exposure + 1e-5, 1.0 / gamma),
                       0.0, 1.0)


def no_tone_map(color: torch.Tensor) -> torch.Tensor:
    return color


def normalize_tone_map(color: torch.Tensor) -> torch.Tensor:
    color = color / (torch.linalg.norm(color, dim=-1, keepdim=True) + 1e-12)
    return color * 0.5 + 0.5


RENDER_FUNCS = {"radiance": radiance_render, "white": white_color}
BLEND_FUNCS = {"alpha": alpha_blend, "alpha2": alpha2_blend}
TONEMAP_FUNCS = {"gamma": simple_tone_map, "off": no_tone_map,
                 "normalize": normalize_tone_map}


def ray_march(ray_dist: torch.Tensor, ray_valid: torch.Tensor,
              ray_features: torch.Tensor, render_func: Callable,
              blend_func: Callable, bg_color: Optional[torch.Tensor] = None):
    """Alpha-composite per-sample features [R, S, 1+C] (channel 0 is raw
    sigma) along each ray.

    Returns (ray_color [R, C], point_color [R, S, C], opacity [R, S],
    acc_transmission [R, S], blend_weight [R, S, 1],
    background_transmission [R, 1], background_blend_weight [R, 1])."""
    point_color = render_func(ray_features)
    sigma = ray_features[..., 0] * ray_valid.to(ray_features.dtype)
    opacity = 1.0 - torch.exp(-sigma * ray_dist)
    full_trans = torch.cumprod(1.0 - opacity + 1e-10, dim=-1)
    background_transmission = full_trans[..., -1:]
    acc_transmission = torch.cat(
        [torch.ones_like(full_trans[..., :1]), full_trans[..., :-1]], dim=-1)
    blend_weight = blend_func(opacity, acc_transmission)[..., None]
    ray_color = torch.sum(point_color * blend_weight, dim=-2)
    if bg_color is not None:
        C = ray_color.shape[-1]
        bg = bg_color.reshape(1, 3).to(ray_color.dtype)
        if C != 3:
            bg = bg.repeat(1, C // 3)
        ray_color = ray_color + bg * background_transmission
    background_blend_weight = blend_func(1.0, background_transmission)
    return (ray_color, point_color, opacity, acc_transmission, blend_weight,
            background_transmission, background_blend_weight)


def ray_dist_from_depth(sample_depth: torch.Tensor, ray_valid: torch.Tensor,
                        vsize_z: float, mode_unit: bool = True
                        ) -> torch.Tensor:
    """Marching distance per sample: differences of the running maximum of
    the depths, the last slot vsize_z; gaps below 1e-8 (or, with
    `mode_unit`, above 2*vsize_z) reset to vsize_z; invalid samples get 0."""
    run_max = torch.cummax(sample_depth, dim=-1).values
    dist = torch.cat(
        [run_max[..., 1:] - run_max[..., :-1],
         run_max.new_full(run_max.shape[:-1] + (1,), vsize_z)], dim=-1)
    bad = dist < 1e-8
    if mode_unit:
        bad = bad | (dist > 2.0 * vsize_z)
    dist = torch.where(bad, torch.full_like(dist, vsize_z), dist)
    return dist * ray_valid.to(dist.dtype)
