"""Real spherical harmonics up to degree 5
(JAX: hybridneuralrendering_tpu/core/sh.py; reference
utils/spherical.py:153-236)."""

from __future__ import annotations

import math

import torch


def sh_basis(dirs: torch.Tensor, total_deg: int,
             flip_dir: bool = True) -> torch.Tensor:
    """The real SH basis of unit directions: dirs [..., 3] ->
    [..., total_deg**2], bands l = 0 .. total_deg - 1 for total_deg in
    1..5.  `flip_dir` negates x and y, as the reference does by default."""
    if not 1 <= total_deg <= 5:
        raise ValueError("sh_basis supports total_deg in 1..5")
    x = -dirs[..., 0] if flip_dir else dirs[..., 0]
    y = -dirs[..., 1] if flip_dir else dirs[..., 1]
    z = dirs[..., 2]
    pi = math.pi
    out = [0.5 * math.sqrt(1 / pi) * torch.ones_like(x)]
    if total_deg >= 2:
        c = math.sqrt(3 / (4 * pi))
        out += [c * y, c * z, c * x]
    if total_deg >= 3:
        c15 = 0.5 * math.sqrt(15 / pi)
        out += [c15 * x * y, c15 * z * y,
                0.25 * math.sqrt(5 / pi) * (-x * x - y * y + 2 * z * z),
                c15 * x * z,
                0.25 * math.sqrt(15 / pi) * (x * x - y * y)]
    if total_deg >= 4:
        out += [
            0.25 * math.sqrt(35.0 / 2 / pi) * (3 * x * x - y * y) * y,
            0.5 * math.sqrt(105 / pi) * x * y * z,
            0.25 * math.sqrt(21 / 2 / pi) * (4 * z * z - x * x - y * y) * y,
            0.25 * math.sqrt(7 / pi) * (2 * z * z - 3 * x * x - 3 * y * y)
            * z,
            0.25 * math.sqrt(21 / 2 / pi) * (4 * z * z - x * x - y * y) * x,
            0.25 * math.sqrt(105 / pi) * (x * x - y * y) * z,
            0.25 * math.sqrt(35.0 / 2 / pi) * (x * x - 3 * y * y) * x,
        ]
    if total_deg >= 5:
        out += [
            0.75 * math.sqrt(35.0 / pi) * x * y * (x * x - y * y),
            0.75 * math.sqrt(35.0 / 2 / pi) * (3 * x * x - y * y) * y * z,
            0.75 * math.sqrt(5 / pi) * x * y * (7 * z * z - 1),
            0.75 * math.sqrt(5 / 2 / pi) * z * y * (7 * z * z - 3),
            3 / 16 * math.sqrt(1 / pi) * (35 * z ** 4 - 30 * z * z + 3),
            0.75 * math.sqrt(5 / 2 / pi) * x * z * (7 * z * z - 3),
            3 / 8 * math.sqrt(5 / pi) * (x * x - y * y) * (7 * z * z - 1),
            0.75 * math.sqrt(35.0 / 2 / pi) * (x * x - 3 * y * y) * x * z,
            3 / 16 * math.sqrt(35.0 / pi) * (
                x * x * (x * x - 3 * y * y) - y * y * (3 * x * x - y * y)),
        ]
    return torch.stack(out, dim=-1)
