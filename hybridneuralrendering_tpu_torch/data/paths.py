"""Camera paths through key poses (JAX: hybridneuralrendering_tpu/data/
paths.py; reference utils/util.py:34-63).

Host-side numpy: euler-angle and position interpolation between key
cameras, with the angles unwrapped against the first key's, giving a
closed fly-through; and the view triplets of the MVS bootstrap
(`build_view_triplets`).  The arithmetic is the JAX package's, so the
poses and the triplets agree bit for bit.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _euler_xyz_from_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> intrinsic xyz euler angles (degrees)."""
    sy = -m[2, 0]
    cy = np.sqrt(max(1.0 - sy * sy, 0.0))
    if cy > 1e-6:
        x = np.arctan2(m[2, 1], m[2, 2])
        y = np.arcsin(np.clip(sy, -1, 1))
        z = np.arctan2(m[1, 0], m[0, 0])
    else:
        x = np.arctan2(-m[1, 2], m[1, 1])
        y = np.arcsin(np.clip(sy, -1, 1))
        z = 0.0
    return np.degrees([x, y, z])


def _matrix_from_euler_xyz(deg: np.ndarray) -> np.ndarray:
    x, y, z = np.radians(deg)
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def gen_render_path(c2ws: np.ndarray, n_views: int = 30) -> np.ndarray:
    """A closed path through the key poses c2ws [N, 4, 4]: n_views // 3
    (at least 1) poses per segment, key i to key i + 1 and the last back
    to the first -> [N * segment, 4, 4] float64 poses."""
    n = len(c2ws)
    seg = max(n_views // 3, 1)
    weight = np.linspace(1.0, 0.0, seg, endpoint=False).reshape(-1, 1)
    rotvec, positions = [], []
    for i in range(n):
        ang = _euler_xyz_from_matrix(c2ws[i, :3, :3]).reshape(1, 3)
        if i:
            wrap = np.abs(ang - rotvec[0]) > 180
            ang[wrap] += 360.0
        rotvec.append(ang)
        positions.append(c2ws[i, :3, 3].reshape(1, 3))

    angs, poss = [], []
    for i in range(1, n):
        angs.append(weight * rotvec[i - 1] + (1 - weight) * rotvec[i])
        poss.append(weight * positions[i - 1] + (1 - weight) * positions[i])
    angs.append(weight * rotvec[-1] + (1 - weight) * rotvec[0])
    poss.append(weight * positions[-1] + (1 - weight) * positions[0])
    angs = np.concatenate(angs)
    poss = np.concatenate(poss)

    out = []
    for a, p in zip(angs, poss):
        c2w = np.eye(4)
        c2w[:3, :3] = _matrix_from_euler_xyz(a)
        c2w[:3, 3] = p
        out.append(c2w)
    return np.stack(out)


def build_view_triplets(cam_positions: np.ndarray,
                        max_groups: int = 0) -> List[Tuple[int, int, int]]:
    """Groups of 3 nearby cameras for the MVS bootstrap (JAX
    data/paths.py:82-104): each camera with its two nearest neighbours, as
    sorted triplets in camera order, each triplet once; at most
    `max_groups` of them when it is > 0.  [] for fewer than 3 cameras."""
    n = len(cam_positions)
    if n < 3:
        return []
    d = np.linalg.norm(cam_positions[:, None] - cam_positions[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    seen = set()
    groups: List[Tuple[int, int, int]] = []
    for i in range(n):
        nb = np.argsort(d[i])[:2]
        tri = tuple(sorted((i, int(nb[0]), int(nb[1]))))
        if tri not in seen:
            seen.add(tri)
            groups.append(tri)
        if max_groups and len(groups) >= max_groups:
            break
    return groups
