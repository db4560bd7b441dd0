"""Weights and points of the JAX package as tensors of the port.

The port keeps the JAX package's layouts, so conversion is a walk over the
tree with checks and no reshuffling:
  - a Linear `w` is [in, out], applied as x @ w (models/mlp.py);
  - a conv `w` is HWIO over NHWC maps;
  - the point table is [N, table_width] f32 with columns
    xyz | embedding | conf | color | dirs | zero pad.
The MVS networks' MvsPointsParams carry over field by field, an absent
part (None) staying None.  RAFT is the exception: the port's RAFT is the
reference's nn.Module, so raft_from_numpy renames JAX's leaves and turns
its HWIO convs to OIHW.
Inputs are numpy arrays (np.asarray of the JAX leaves), so this module
needs no JAX.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from hybridneuralrendering_tpu_torch.device import resolve
from hybridneuralrendering_tpu_torch.flow import raft as raft_mod
from hybridneuralrendering_tpu_torch.models import neural_points as npts
from hybridneuralrendering_tpu_torch.mvs import point_gen
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


def mvs_params_from_numpy(params, device="cuda") -> point_gen.MvsPointsParams:
    """JAX's MvsPointsParams (feature, mvsnet, premlp, cost_reg, prob_net;
    numpy leaves, absent parts None) -> the port's, tensors on
    `device`."""
    if len(params) != len(point_gen.MvsPointsParams._fields):
        raise ValueError(f"{len(params)} parts, MvsPointsParams has "
                         f"{len(point_gen.MvsPointsParams._fields)}")
    return point_gen.MvsPointsParams(*(
        None if part is None else params_from_numpy(part, device)
        for part in params))


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


# JAX flow/raft.py leaf names -> the reference RAFT's module names
_RAFT_BLOCKS = {"l1a": "layer1.0", "l1b": "layer1.1", "l2a": "layer2.0",
                "l2b": "layer2.1", "l3a": "layer3.0", "l3b": "layer3.1"}
_RAFT_BLOCK_LEAVES = {"c1": "conv1", "c2": "conv2", "down": "downsample.0",
                      "bn1": "norm1", "bn2": "norm2", "bn3": "norm3"}
_RAFT_UPDATE = {"mc1": "encoder.convc1", "mc2": "encoder.convc2",
                "mf1": "encoder.convf1", "mf2": "encoder.convf2",
                "mout": "encoder.conv", "gz1": "gru.convz1",
                "gr1": "gru.convr1", "gq1": "gru.convq1",
                "gz2": "gru.convz2", "gr2": "gru.convr2",
                "gq2": "gru.convq2", "fh1": "flow_head.conv1",
                "fh2": "flow_head.conv2", "mk1": "mask.0", "mk2": "mask.2"}
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def _raft_leaf(name: str, p, sd) -> None:
    """One conv {w HWIO, b} or batch norm {scale, bias, mean, var} of the
    JAX tree into `sd` under `name`."""
    if "w" in p:
        sd[f"{name}.weight"] = np.transpose(np.asarray(p["w"]), (3, 2, 0, 1))
        sd[f"{name}.bias"] = np.asarray(p["b"])
    else:
        for k, v in _BN.items():
            sd[f"{name}.{v}"] = np.asarray(p[k])


def raft_from_numpy(params, device="cuda") -> raft_mod.RAFT:
    """JAX's RaftParams (fnet, cnet, update; numpy leaves) -> the port's
    RAFT in eval mode on `device`; every module parameter and buffer is
    set (load_state_dict strict, the batch norms' batch counts zero)."""
    sd = {}
    for enc in ("fnet", "cnet"):
        tree = getattr(params, enc)
        for k, p in tree.items():
            if k in _RAFT_BLOCKS:
                block = f"{enc}.{_RAFT_BLOCKS[k]}"
                for leaf, q in p.items():
                    _raft_leaf(f"{block}.{_RAFT_BLOCK_LEAVES[leaf]}", q, sd)
                    if leaf == "bn3":
                        _raft_leaf(f"{block}.downsample.1", q, sd)
            else:
                _raft_leaf(f"{enc}.{'norm1' if k == 'bn0' else k}", p, sd)
    for k, p in params.update.items():
        _raft_leaf(f"update_block.{_RAFT_UPDATE[k]}", p, sd)
    model = raft_mod.RAFT()
    state = {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
             for k, v in sd.items()}
    state.update({k: torch.zeros((), dtype=torch.long)
                  for k in model.state_dict() if
                  k.endswith("num_batches_tracked")})
    model.load_state_dict(state, strict=True)
    return model.eval().to(resolve(device))
