"""Weights and points of the JAX package as tensors of the port.

The port keeps the JAX package's layouts, so conversion is a walk over the
tree with checks and no reshuffling:
  - a Linear `w` is [in, out], applied as x @ w (models/mlp.py);
  - a conv `w` is HWIO over NHWC maps;
  - the point table is [N, table_width] f32 with columns
    xyz | embedding | conf | color | dirs | zero pad.
Inputs are numpy arrays (np.asarray of the JAX leaves), so this module
needs no JAX.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from hybridneuralrendering_tpu_torch.device import resolve
from hybridneuralrendering_tpu_torch.models import neural_points as npts
from hybridneuralrendering_tpu_torch.train import state as state_mod


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dicts/lists of float arrays -> the same nesting of float32
    tensors on `device`.  An integer scalar (attention's num_heads, a
    Python int in the JAX tree) stays a Python int; any other leaf that is
    not float raises TypeError."""
    dev = resolve(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        arr = np.asarray(node)
        if arr.dtype.kind in "iu" and arr.ndim == 0:
            return int(arr)
        if arr.dtype.kind != "f":
            raise TypeError(f"parameter leaf of dtype {arr.dtype}")
        return torch.tensor(arr, dtype=torch.float32, device=dev)

    return walk(tree)


def points_from_numpy(table: np.ndarray, mask: np.ndarray, feature_dim: int,
                      trainable: Tuple[bool, ...] = (False, True, True, True,
                                                     True),
                      device="cuda") -> npts.NeuralPoints:
    """The JAX NeuralPoints' stacked table [N, W] and mask [N] -> the
    port's NeuralPoints."""
    table = np.asarray(table, np.float32)
    mask = np.asarray(mask).astype(bool)
    width = npts.table_width(feature_dim)
    if table.ndim != 2 or table.shape[1] != width:
        raise ValueError(f"point table {table.shape} is not [N, {width}] "
                         f"for feature_dim={feature_dim}")
    if mask.shape != (table.shape[0],):
        raise ValueError(f"mask {mask.shape} does not match the table")
    dev = resolve(device)
    return npts.NeuralPoints(
        table=torch.tensor(table, device=dev),
        mask=torch.tensor(mask, device=dev), num_live=int(mask.sum()),
        feature_dim=feature_dim, trainable=tuple(trainable))


def train_state_from_numpy(params: Any, table: np.ndarray, mask: np.ndarray,
                           step: int, net_adam: Tuple[Any, Any, int],
                           pts_adam: Optional[Tuple[Any, Any, int]],
                           feature_dim: int,
                           trainable: Tuple[bool, ...] = (False, True, True,
                                                          True, True),
                           device="cuda") -> state_mod.TrainState:
    """The JAX TrainState as the port's.

    params: the network parameter tree; table, mask: the NeuralPoints'
    stacked table and mask; step: TrainState.step; net_adam, pts_adam:
    (mu, nu, count) of the two optax ScaleByAdamState (opt_state[0]), the
    point one with mu and nu as the [N, W] table (its {"table": ...} leaf),
    or None when no point attribute trains."""
    points = points_from_numpy(table, mask, feature_dim, trainable, device)
    mu, nu, count = net_adam
    opt_net = state_mod.AdamState(params_from_numpy(mu, device),
                                  params_from_numpy(nu, device), int(count))
    opt_pts = None
    if pts_adam is not None:
        pmu, pnu, pcount = pts_adam
        dev = points.table.device
        opt_pts = state_mod.AdamState(
            torch.tensor(np.asarray(pmu, np.float32), device=dev),
            torch.tensor(np.asarray(pnu, np.float32), device=dev),
            int(pcount))
    return state_mod.TrainState(step=int(step),
                                params=params_from_numpy(params, device),
                                points=points, opt_net=opt_net,
                                opt_pts=opt_pts)
