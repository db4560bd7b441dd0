"""QKV cross-attention fusion (JAX: hybridneuralrendering_tpu/models/
attention.py; reference models/aggregators/attention.py).

The alternative to the fusion-weight MLP (cfg.agg.tradition_attention):
each shading sample's 3D colour feature queries the per-view image
features, K and V over the nearest views, invalid views masked out, with
an optional hard (Gumbel) selection.  `num_heads` is a Python int in the
parameter tree, as in JAX; the port's tree walks (train/state.tree_map,
the checkpoint) keep such a leaf as it is.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from hybridneuralrendering_tpu_torch.models.mlp import _uniform


def _group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm with one group over the channel axis."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def init(gen: torch.Generator, query_channels: int, context_channels: int,
         inner_channels: int = 16, num_heads: int = 1,
         device="cpu") -> Dict:
    """Parameters of the shapes JAX attention.init makes: unit norms, Q
    and KV weights uniform in +-1/sqrt(fan-in) from `gen`, zero biases,
    and the output projection `proj` zero (the block starts at zero)."""
    lim_q = 1.0 / math.sqrt(query_channels)
    lim_kv = 1.0 / math.sqrt(context_channels)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    return {
        "num_heads": num_heads,
        "norm_q": {"scale": torch.ones(query_channels, device=device),
                   "bias": zeros(query_channels)},
        "norm_c": {"scale": torch.ones(context_channels, device=device),
                   "bias": zeros(context_channels)},
        "q": {"w": _uniform(gen, (query_channels, inner_channels), lim_q,
                            device),
              "b": zeros(inner_channels)},
        "kv": {"w": _uniform(gen, (context_channels, inner_channels * 2),
                             lim_kv, device),
               "b": zeros(inner_channels * 2)},
        "proj": {"w": zeros(inner_channels, context_channels),
                 "b": zeros(context_channels)},
    }


def apply(params: Dict, pt_feat: torch.Tensor, img_feats: torch.Tensor,
          valid: Optional[torch.Tensor] = None,
          use_gumbel: bool = False) -> torch.Tensor:
    """pt_feat [B, Cq], img_feats [B, T, Cc] (T views), valid [B, T] bool
    -> fused [B, Cc].  Logits of invalid views are -1e9 before the
    softmax.  With `use_gumbel` the views are picked hard, by the one-hot
    of the largest weight, which passes no gradient to Q or K: JAX's
    fusion calls its apply without a key, so its Gumbel-softmax draw never
    runs, in training either (models/fusion.py)."""
    nh = params["num_heads"]
    q_in = _group_norm(pt_feat, params["norm_q"]["scale"],
                       params["norm_q"]["bias"])
    c_in = _group_norm(img_feats, params["norm_c"]["scale"],
                       params["norm_c"]["bias"])
    q = q_in @ params["q"]["w"] + params["q"]["b"]              # [B, Ci]
    kv = c_in @ params["kv"]["w"] + params["kv"]["b"]           # [B, T, 2Ci]
    k, v = torch.chunk(kv, 2, dim=-1)
    B, T, Ci = k.shape
    ch = Ci // nh
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    qh = (q * scale).reshape(B, nh, ch)
    kh = (k * scale).reshape(B, T, nh, ch)
    logits = torch.einsum("bhc,bthc->bht", qh, kh)
    if valid is not None:
        logits = torch.where(valid[:, None, :], logits,
                             torch.full_like(logits, -1e9))
    weight = torch.softmax(logits, dim=-1)                      # [B, nh, T]
    vh = v.reshape(B, T, nh, ch)
    if use_gumbel:
        weight = (weight == weight.max(dim=-1, keepdim=True).values
                  ).to(weight.dtype)
    a = torch.einsum("bht,bthc->bhc", weight, vh)
    return a.reshape(B, Ci) @ params["proj"]["w"] + params["proj"]["b"]
