"""Training state: parameters, neural points, two Adams and their schedule
(JAX: hybridneuralrendering_tpu/train/state.py).

One Adam for the network parameters at `lr`, one for the point table at
`plr`, both under `lr_schedule`.  The Adam moments are explicit tensors with
an integer count, laid out like optax's ScaleByAdamState, so a JAX state
carries over (io/from_jax.train_state_from_numpy) and a resumed step
matches.  The training step updates the state's tensors in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from hybridneuralrendering_tpu_torch.config import Config, OptimConfig
from hybridneuralrendering_tpu_torch.device import resolve
from hybridneuralrendering_tpu_torch.models import neural_points as npts


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the tensors of nested dicts and lists, keeping the nesting.
    A leaf that is not a tensor (attention's int num_heads) is kept as it
    is, as the static part of the tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    if not torch.is_tensor(tree):
        return tree
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The tensors of a tree, in tree_map's order."""
    out = []
    tree_map(out.append, tree)
    return out


@dataclasses.dataclass
class AdamState:
    """optax ScaleByAdamState: first and second moments shaped like the
    parameters, and the number of steps taken."""

    mu: Any
    nu: Any
    count: int = 0


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict                  # network parameters
    points: npts.NeuralPoints     # the point table holds the trainable attrs
    opt_net: AdamState
    opt_pts: Optional[AdamState]  # None when no point attribute trains


def lr_schedule(base_lr: float,
                cfg: OptimConfig) -> Callable[[int], torch.Tensor]:
    """step -> learning rate, a float32 scalar tensor:
    base * decay_exp ** (step / decay_iters) for iter_exponential_decay."""
    base = torch.tensor(base_lr, dtype=torch.float32)
    if cfg.lr_policy == "iter_exponential_decay":
        decay = torch.tensor(cfg.lr_decay_exp, dtype=torch.float32)
        iters = torch.tensor(cfg.lr_decay_iters, dtype=torch.float32)
        return lambda step: base * torch.pow(
            decay, torch.tensor(step, dtype=torch.float32) / iters)
    if cfg.lr_policy == "constant":
        return lambda step: base
    raise KeyError(f"unknown lr policy {cfg.lr_policy}")


def _zeros_like_tree(tree: Any) -> Any:
    return tree_map(torch.zeros_like, tree)


def fresh_adams(params: Dict, points: npts.NeuralPoints):
    """Zero moments at count 0 for the network and (when any attribute
    trains) the point table."""
    opt_pts = (AdamState(torch.zeros_like(points.table),
                         torch.zeros_like(points.table))
               if any(points.trainable) else None)
    return AdamState(_zeros_like_tree(params), _zeros_like_tree(params)), \
        opt_pts


def create_train_state(params: Dict, points: npts.NeuralPoints, cfg: Config,
                       device="cuda") -> TrainState:
    """A state at step 0 on `device` (params and points are moved there)."""
    dev = resolve(device)
    params = tree_map(lambda t: t.to(dev, torch.float32), params)
    points = dataclasses.replace(points, table=points.table.to(dev),
                                 mask=points.mask.to(dev))
    opt_net, opt_pts = fresh_adams(params, points)
    return TrainState(step=0, params=params, points=points, opt_net=opt_net,
                      opt_pts=opt_pts)


def reset_optimizers(state: TrainState, cfg: Config) -> TrainState:
    """Fresh Adam moments (after grow/prune), the rest kept."""
    opt_net, opt_pts = fresh_adams(state.params, state.points)
    return dataclasses.replace(state, opt_net=opt_net, opt_pts=opt_pts)
