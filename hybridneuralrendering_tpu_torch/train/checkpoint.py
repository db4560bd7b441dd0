"""Checkpoints in the JAX package's file format
(JAX: hybridneuralrendering_tpu/train/checkpoint.py).

`<dir>/<step>_state.npz` holds the flat TrainState: `step` (int32),
`params/<path>`, `points/{table,mask,num_live}` (and `points/rw2c` where
the points carry edit mode's rotations: written as JAX writes it, left
out on load as JAX's loader leaves it), for each of
`opt_state_net` and `opt_state_pts` optax's `(ScaleByAdamState,
ScaleByScheduleState)` tuple as `0/count`, `0/mu/<path>`, `0/nu/<path>`
and `1/count`, and `__best_psnr__` (float64).  A list in the parameter tree
is keyed by its index; an int leaf (attention's num_heads) is saved as
JAX saves it, the value under `params/` and int32 zeros in the moments.
The point Adam's moments are the table's (`0/mu/table`); optax keeps one
schedule count beside each Adam, which counts the same updates, so the
port writes the Adam's count there.

Files of the round-2 layout keep the point attributes and their moments
per attribute (`points/{xyz,embedding,conf,color,dirs}`); they are stacked
into the table on load, zeros for an absent attribute and the pad, as the
JAX loader does.  Saved by one package, a file loads in the other
(tests/test_torch_port_checkpoint.py).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from hybridneuralrendering_tpu_torch.config import Config
from hybridneuralrendering_tpu_torch.device import resolve
from hybridneuralrendering_tpu_torch.models import neural_points as npts
from hybridneuralrendering_tpu_torch.models import renderer
from hybridneuralrendering_tpu_torch.train import state as state_mod

PTS_ATTRS = ("xyz", "embedding", "conf", "color", "dirs")


def _flat(tree: Any, prefix: str, out: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dicts and lists -> {prefix + 'a/0/b': leaf}."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}{i}/", out)
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _count(n: int) -> np.ndarray:
    return np.asarray(n, np.int32)


def _adam_keys(prefix: str, adam: Optional[state_mod.AdamState],
               count: int, table: bool) -> Dict[str, Any]:
    """optax's (ScaleByAdamState, ScaleByScheduleState) keys of one Adam;
    the point Adam's moments are the table's."""
    out = {f"{prefix}/0/count": _count(count),
           f"{prefix}/1/count": _count(count)}
    if adam is not None:
        for name, m in (("mu", adam.mu), ("nu", adam.nu)):
            moments = _flat({"table": m} if table else m,
                            f"{prefix}/0/{name}/", {})
            # an int leaf of the parameters (num_heads) has the int32 zero
            # that optax's zeros_like gives it
            out.update({k: v if torch.is_tensor(v) else _count(0)
                        for k, v in moments.items()})
    return out


def flatten_state(state: state_mod.TrainState,
                  best_psnr: float = 0.0) -> Dict[str, np.ndarray]:
    """The flat numpy arrays of a checkpoint file, keyed as the JAX
    package keys them."""
    pts = state.points
    flat: Dict[str, Any] = {"step": _count(state.step)}
    _flat(state.params, "params/", flat)
    flat["points/table"] = pts.table
    flat["points/mask"] = pts.mask
    flat["points/num_live"] = _count(pts.num_live)
    if pts.rw2c is not None:
        # edit mode's rotations, written as JAX writes them; a load leaves
        # them out, as JAX's template (rw2c None) does
        flat["points/rw2c"] = pts.rw2c
    flat.update(_adam_keys("opt_state_net", state.opt_net,
                           state.opt_net.count, table=False))
    pts_count = (state.opt_pts.count if state.opt_pts is not None
                 else state.opt_net.count)
    flat.update(_adam_keys("opt_state_pts", state.opt_pts, pts_count,
                           table=True))
    flat["__best_psnr__"] = np.asarray(float(best_psnr))
    return {k: _np(v) for k, v in flat.items()}


def save_checkpoint(ckpt_dir: str, state: state_mod.TrainState,
                    best_psnr: float = 0.0) -> str:
    """Write `<ckpt_dir>/<step>_state.npz` (np.savez_compressed to a
    temporary file, then renamed) and return its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{int(state.step)}_state.npz")
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **flatten_state(state, best_psnr))
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint with the largest integer step prefix, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = []
    for f in os.listdir(ckpt_dir):
        if f.endswith("_state.npz"):
            try:
                cands.append((int(f.split("_")[0]), f))
            except ValueError:
                continue
    if not cands:
        return None
    return os.path.join(ckpt_dir, max(cands)[1])


def _template(cfg: Config) -> Dict[str, Tuple[int, ...]]:
    """Key -> shape of every array a checkpoint of `cfg` holds (what the
    JAX package's create_train_state makes at capacity shapes)."""
    params = renderer.init_params(cfg, device="cpu")
    width = npts.table_width(cfg.points.feature_dim)
    cap = cfg.points.num_points
    shapes = {"step": ()}
    leaves = {k: tuple(v.shape) if torch.is_tensor(v) else ()
              for k, v in _flat(params, "", {}).items()}
    shapes.update({f"params/{k}": v for k, v in leaves.items()})
    shapes.update({"points/table": (cap, width), "points/mask": (cap,),
                   "points/num_live": ()})
    for k, v in leaves.items():
        shapes[f"opt_state_net/0/mu/{k}"] = v
        shapes[f"opt_state_net/0/nu/{k}"] = v
    if any(_trainable(cfg)):
        shapes["opt_state_pts/0/mu/table"] = (cap, width)
        shapes["opt_state_pts/0/nu/table"] = (cap, width)
    for opt in ("opt_state_net", "opt_state_pts"):
        shapes[f"{opt}/0/count"] = ()
        shapes[f"{opt}/1/count"] = ()
    return shapes


def _trainable(cfg: Config) -> Tuple[bool, ...]:
    p = cfg.points
    return (p.xyz_grad, p.feat_grad, p.conf_grad, p.color_grad, p.dir_grad)


def _stacked_table(data, path: str, base: str, width: int
                   ) -> Optional[np.ndarray]:
    """The round-2 per-attribute arrays under `base` stacked into a table
    [n, width]: zeros for an absent attribute and the pad (JAX
    load_checkpoint's migration).  None when the file has none of them."""
    if f"{base}xyz" not in data and f"{base}embedding" not in data:
        return None
    parts = [data[f"{base}{nm}"] if f"{base}{nm}" in data else None
             for nm in PTS_ATTRS]
    n = next(p.shape[0] for p in parts if p is not None)
    parts = [None if p is None else p.reshape(n, -1) for p in parts]
    fdim = parts[1].shape[1] if parts[1] is not None else 32
    widths = npts.attr_widths(fdim)
    parts = [np.zeros((n, w), np.float32) if p is None else p
             for p, w in zip(parts, widths)]
    used = sum(widths)
    if width < used:
        raise ValueError(f"checkpoint {path}: {base}* holds {used} columns, "
                         f"more than the table's {width}")
    return np.concatenate(parts + [np.zeros((n, width - used), np.float32)],
                          axis=1)


def _load_arrays(path: str, cfg: Config) -> Tuple[Dict[str, np.ndarray],
                                                 float]:
    """The arrays of a checkpoint file that a TrainState of `cfg` holds,
    keyed as flatten_state keys them, with the round-2 attributes stacked
    into tables; raises naming the key when one is missing or has another
    shape than `cfg` gives it.  Returns (arrays, best PSNR)."""
    shapes = _template(cfg)
    out: Dict[str, np.ndarray] = {}
    with np.load(path) as data:
        best = (float(data["__best_psnr__"]) if "__best_psnr__" in data
                else 0.0)
        for key, shape in shapes.items():
            if key in data:
                arr = data[key]
            elif key.endswith("/table"):
                arr = _stacked_table(data, path, key[:-len("table")],
                                     shape[1])
            else:
                arr = None
            if arr is None:
                raise KeyError(f"checkpoint {path} missing {key}")
            if tuple(arr.shape) != shape:
                raise ValueError(f"checkpoint {path}: {key} has shape "
                                 f"{tuple(arr.shape)}, the config gives "
                                 f"{shape}")
            out[key] = arr
    return out, best


def _tensor(arr: np.ndarray, dtype, dev: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(arr, dtype), device=dev)


def _unflat(flat: Dict[str, np.ndarray], prefix: str, like: Any,
            dev: torch.device) -> Any:
    """The float32 tensors under `prefix` nested as `like` (dicts and
    lists); where `like` has an int leaf (num_heads), the file's value as
    an int."""
    if isinstance(like, dict):
        return {k: _unflat(flat, f"{prefix}{k}/", v, dev)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_unflat(flat, f"{prefix}{i}/", v, dev)
                for i, v in enumerate(like)]
    if not torch.is_tensor(like):
        return int(flat[prefix.rstrip("/")])
    return _tensor(flat[prefix.rstrip("/")], np.float32, dev)


def load_checkpoint(path: str, cfg: Config, device="cuda"
                    ) -> Tuple[state_mod.TrainState, float]:
    """The TrainState saved in `path`, at the capacity shapes of `cfg`, on
    `device` (the card unless the caller asks for the CPU); returns
    (state, best PSNR)."""
    dev = resolve(device)
    arrs, best = _load_arrays(path, cfg)
    like = renderer.init_params(cfg, device="cpu")
    points = npts.NeuralPoints(
        table=_tensor(arrs["points/table"], np.float32, dev),
        mask=_tensor(arrs["points/mask"], bool, dev),
        num_live=int(arrs["points/num_live"]),
        feature_dim=cfg.points.feature_dim, trainable=_trainable(cfg))
    opt_net = state_mod.AdamState(
        _unflat(arrs, "opt_state_net/0/mu/", like, dev),
        _unflat(arrs, "opt_state_net/0/nu/", like, dev),
        int(arrs["opt_state_net/0/count"]))
    opt_pts = None
    if "opt_state_pts/0/mu/table" in arrs:
        opt_pts = state_mod.AdamState(
            _tensor(arrs["opt_state_pts/0/mu/table"], np.float32, dev),
            _tensor(arrs["opt_state_pts/0/nu/table"], np.float32, dev),
            int(arrs["opt_state_pts/0/count"]))
    state = state_mod.TrainState(
        step=int(arrs["step"]), params=_unflat(arrs, "params/", like, dev),
        points=points, opt_net=opt_net, opt_pts=opt_pts)
    return state, best
