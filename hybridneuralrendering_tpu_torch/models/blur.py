"""Blur-aware training: degrade the rendered patches before the loss
(JAX: hybridneuralrendering_tpu/models/blur.py).

Pre-defined kernels: the kernel bank is numpy (linear-motion streaks
rotated bilinearly), built once on the host.  In each step every rendered
patch is convolved with every bank kernel (normalised against the zero
padding), the identity joins as one more candidate, and each patch keeps
the candidate nearest its ground truth in L1.  The choice is a hard select;
gradients flow through the chosen convolution.

Learnable kernels (`learnable_blur_update`): an MLP reads each patch's grey
ground truth and render and predicts its K x K kernel, which degrades the
render's three channels in one grouped convolution.  Both convolutions are
cross-correlations with zero padding K//2, as JAX's "SAME"
conv_general_dilated, and run without TF32 (device.no_tf32).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from hybridneuralrendering_tpu_torch.config import (AggregatorConfig,
                                                    BlurConfig)
from hybridneuralrendering_tpu_torch.device import no_tf32
from hybridneuralrendering_tpu_torch.models import mlp


def _rotate_bilinear(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """Rotate a small 2D array counterclockwise about its centre, bilinear,
    zero padding (imutils.rotate / cv2.warpAffine semantics)."""
    h, w = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    a = np.deg2rad(angle_deg)
    cos_a, sin_a = np.cos(a), np.sin(a)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    # inverse map: rotate output coordinates by -angle around the centre
    x0 = cos_a * (xs - cx) - sin_a * (ys - cy) + cx
    y0 = sin_a * (xs - cx) + cos_a * (ys - cy) + cy
    x_f, y_f = np.floor(x0).astype(int), np.floor(y0).astype(int)
    dx, dy = x0 - x_f, y0 - y_f

    def sample(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = np.zeros_like(img, dtype=np.float64)
        v[ok] = img[yy[ok], xx[ok]]
        return v

    return (sample(y_f, x_f) * (1 - dx) * (1 - dy)
            + sample(y_f, x_f + 1) * dx * (1 - dy)
            + sample(y_f + 1, x_f) * (1 - dx) * dy
            + sample(y_f + 1, x_f + 1) * dx * dy)


def generate_kernel_bank(cfg: BlurConfig) -> np.ndarray:
    """[num_kernels, k, k] float32 normalised linear-motion kernels.

    Version 1 (asymmetric): a streak of length dist ending at the centre,
    rotated over num_move_dirs directions; version 2 (symmetric): a streak
    of 2*dist+1 through the centre over half the directions; 3: both.  All
    zeros when blur simulation is off."""
    k = cfg.blur_kernel_size
    c = k // 2
    kernels = []

    def add(base: np.ndarray, dirs):
        for ang in dirs:
            rot = _rotate_bilinear(base, ang)
            s = rot.sum()
            kernels.append(rot / s if s > 0 else rot)

    n_dir = cfg.num_move_dirs
    dirs_full = list(np.linspace(0, 360, n_dir + 1)[:n_dir])
    dirs_half = list(np.linspace(0, 360, n_dir + 1)[: n_dir // 2])
    if cfg.blur_kernel_version in (1, 3):
        for dist in cfg.move_dists:
            base = np.zeros((k, k))
            base[c - dist: c + 1, c] = 255.0
            add(base, dirs_full)
    if cfg.blur_kernel_version in (2, 3):
        for dist in cfg.move_dists:
            base = np.zeros((k, k))
            base[c - dist: c + dist + 1, c] = 255.0
            add(base, dirs_half)
    bank = np.stack(kernels).astype(np.float32)
    if not cfg.add_blur_sim:
        bank = bank * 0.0
    return bank


def to_patches(img_flat: torch.Tensor, patch_num: int,
               patch_size: int) -> torch.Tensor:
    """[R, 3] ray colours (row-major over the sample grid) ->
    [patch_num^2, patch_size, patch_size, 3]."""
    img = img_flat.reshape(patch_num, patch_size, patch_num, patch_size, 3)
    return img.permute(0, 2, 1, 3, 4).reshape(
        patch_num * patch_num, patch_size, patch_size, 3)


def from_patches(patches: torch.Tensor, patch_num: int,
                 patch_size: int) -> torch.Tensor:
    """Inverse of to_patches -> [R, 3]."""
    p = patches.reshape(patch_num, patch_num, patch_size, patch_size, 3)
    return p.permute(0, 2, 1, 3, 4).reshape(-1, 3)


def _conv_same(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, 1]; kernels [N, k, k] -> [B, H, W, N]: cross-correlation
    with zero padding k//2 on every side (JAX's "SAME" for odd k)."""
    k = kernels.shape[-1]
    out = F.conv2d(x.permute(0, 3, 1, 2), kernels[:, None], padding=k // 2)
    return out.permute(0, 2, 3, 1)


def blur_bank_update(rendered: torch.Tensor, gt: torch.Tensor,
                     kernels: torch.Tensor, patch_num: int,
                     patch_size: int) -> torch.Tensor:
    """Degrade `rendered` [R, 3] by the best-matching bank kernel per patch.

    Candidates are every bank kernel [N, k, k] (normalised against the zero
    padding) plus the identity; each patch takes the argmin of its L1
    distance to `gt` (ties to the first candidate, as jnp.argmin)."""
    N = kernels.shape[0]
    rp = to_patches(rendered, patch_num, patch_size)      # [P, ps, ps, 3]
    gp = to_patches(gt, patch_num, patch_size)
    P = rp.shape[0]
    ps = patch_size
    x = rp.permute(0, 3, 1, 2).reshape(P * 3, ps, ps, 1)
    norm = _conv_same(torch.ones_like(x), kernels)        # [P*3, ps, ps, N]
    blurred = _conv_same(x, kernels) / norm
    cand = torch.cat([blurred.reshape(P, 3, ps, ps, N),
                      x.reshape(P, 3, ps, ps, 1)], dim=-1)  # [P,3,ps,ps,N+1]
    diff = torch.sum(torch.abs(cand - gp.permute(0, 3, 1, 2)[..., None]),
                     dim=(1, 2, 3))                       # [P, N+1]
    sel = torch.argmin(diff, dim=-1)                      # [P]
    best = torch.take_along_dim(
        cand, sel[:, None, None, None, None], dim=-1)[..., 0]
    return from_patches(best.permute(0, 2, 3, 1), patch_num, patch_size)


def _conv_grouped(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """x [1, C, H, W]; kernels [C, K, K] -> [1, C, H, W]: channel c
    cross-correlated with kernel c, zero padding K//2."""
    K = kernels.shape[-1]
    return F.conv2d(x, kernels[:, None], padding=K // 2,
                    groups=kernels.shape[0])


def learnable_blur_update(params: dict, cfg: AggregatorConfig,
                          rendered: torch.Tensor, gt: torch.Tensor,
                          patch_num: int, patch_size: int) -> torch.Tensor:
    """Degrade `rendered` [R, 3] with per-patch MLP-predicted kernels (JAX
    blur.learnable_blur_update, the reference's `faster_version` path).

    params["blur_kernel"] maps the grey GT and render patches
    [P, 2 * patch_size^2] to sigmoid outputs: kernel norm 0 divides the
    K x K kernel by its sum, any other norm takes a softmax; kernel mode 4
    mixes in the identity kernel by the last output, other modes do not.
    Boundary mode 0 divides by the kernel's mass inside the patch, 1 adds
    the missing mass times the pixel, 2 as 1 with the mass taken from the
    detached kernel; other modes raise NotImplementedError, as in JAX."""
    if cfg.boundary_mode not in (0, 1, 2):
        raise NotImplementedError(f"boundary_mode {cfg.boundary_mode}")
    K = cfg.learnable_blur_kernel_size
    ps = patch_size
    rp = to_patches(rendered, patch_num, ps)              # [P, ps, ps, 3]
    gp = to_patches(gt, patch_num, ps)
    P = rp.shape[0]
    gray = torch.cat([gp.mean(dim=-1).reshape(P, -1),
                      rp.mean(dim=-1).reshape(P, -1)], dim=-1)
    pred = torch.sigmoid(mlp.mlp_apply(params["blur_kernel"], gray,
                                       cfg.act_type))     # [P, K*K(+1)]
    if cfg.learnable_blur_kernel_norm == 0:
        kern = pred[:, :K * K].reshape(P, K, K)
        kern = kern / kern.sum(dim=(1, 2), keepdim=True)
    else:
        kern = torch.softmax(pred[:, :K * K], dim=-1).reshape(P, K, K)
    if cfg.learnable_blur_kernel_mode == 4:
        wmix = pred[:, -1][:, None, None]
        ident = torch.zeros((K, K), dtype=kern.dtype, device=kern.device)
        ident[K // 2, K // 2] = 1.0
        kern = wmix * kern + (1.0 - wmix) * ident
        kern = kern / kern.sum(dim=(1, 2), keepdim=True)

    # patch i's three channels take patch i's kernel (jnp.repeat's order)
    kern_g = kern.repeat_interleave(3, dim=0)             # [P*3, K, K]
    x = rp.permute(0, 3, 1, 2).reshape(1, P * 3, ps, ps)
    ones = torch.ones_like(x)
    with no_tf32():
        conv = _conv_grouped(x, kern_g)
        if cfg.boundary_mode == 0:
            blurred = conv / (_conv_grouped(ones, kern_g) + 1e-10)
        else:
            mass = _conv_grouped(ones, kern_g.detach()
                                 if cfg.boundary_mode == 2 else kern_g)
            blurred = conv + (1.0 - mass) * x
    blurred = blurred.reshape(P, 3, ps, ps).permute(0, 2, 3, 1)
    return from_patches(blurred, patch_num, ps)
