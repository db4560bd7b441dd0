"""Pixel samplers for training batches, host-side numpy
(JAX: hybridneuralrendering_tpu/data/sampling.py, a copy).

The sampler block of the reference's data/scannet_ft_dataset.py:893-950:
`patch`, `random`,
`random2`, and the paper's `dilated` sampler (a patch_num x patch_num grid of
patch_size x patch_size patches, each placed at a random image location with a
random integer dilation), plus the full-image grid used at eval.
All samplers return float32 pixel coords [S, S, 2] (x, y).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from hybridneuralrendering_tpu_torch.config import SamplingConfig


def sample_pixels(cfg: SamplingConfig, height: int, width: int,
                  rng: np.random.Generator) -> np.ndarray:
    margin = cfg.edge_filter
    s = cfg.random_sample_size
    mode = cfg.random_sample
    if mode == "patch":
        ix = rng.integers(margin, width - margin - s + 1)
        iy = rng.integers(margin, height - margin - s + 1)
        px, py = np.meshgrid(np.arange(ix, ix + s, dtype=np.float32),
                             np.arange(iy, iy + s, dtype=np.float32))
    elif mode == "random":
        px = rng.integers(margin, width - margin, (s, s)).astype(np.float32)
        py = rng.integers(margin, height - margin, (s, s)).astype(np.float32)
    elif mode == "random2":
        px = rng.uniform(margin, width - margin - 1e-5, (s, s)).astype(np.float32)
        py = rng.uniform(margin, height - margin - 1e-5, (s, s)).astype(np.float32)
    elif mode == "dilated":
        pn, ps = cfg.dilation_patch_num, cfg.dilation_patch_size
        assert pn * ps == s, "dilation grid must match random_sample_size"
        dilations = np.arange(cfg.dilation_min, cfg.dilation_max + 1)
        px = np.zeros((s, s), np.float32)
        py = np.zeros((s, s), np.float32)
        base_x, base_y = np.meshgrid(np.arange(ps, dtype=np.float32),
                                     np.arange(ps, dtype=np.float32))
        for i in range(pn):
            for j in range(pn):
                d = int(rng.choice(dilations))
                ix = rng.integers(margin, width - margin - (ps - 1) * d)
                iy = rng.integers(margin, height - margin - (ps - 1) * d)
                px[i * ps:(i + 1) * ps, j * ps:(j + 1) * ps] = ix + d * base_x
                py[i * ps:(i + 1) * ps, j * ps:(j + 1) * ps] = iy + d * base_y
    else:
        raise KeyError(f"unknown sampler {mode}")
    return np.stack([px, py], axis=-1)


def full_image_grid(height: int, width: int, margin: int = 0) -> np.ndarray:
    px, py = np.meshgrid(np.arange(margin, width - margin, dtype=np.float32),
                         np.arange(margin, height - margin, dtype=np.float32))
    return np.stack([px, py], axis=-1)


def chunk_pixels(pixels: np.ndarray, chunk: int) -> Tuple[np.ndarray, int]:
    """Flatten [H, W, 2] -> padded [n_chunks, chunk, 2] for fixed-shape eval
    (the reference's pixel-chunked full-image render, run/test_ft.py:165-198)."""
    flat = pixels.reshape(-1, 2)
    n = len(flat)
    n_chunks = (n + chunk - 1) // chunk
    pad = n_chunks * chunk - n
    flat = np.concatenate([flat, np.tile(flat[-1:], (pad, 1))])
    return flat.reshape(n_chunks, chunk, 2), n
