"""Cache of per-view image-pyramid stage maps, and the burst schedule
(JAX: hybridneuralrendering_tpu/train/pyramid_cache.py and the schedule of
cli/train.py).

The hybrid branch reads the pyramid CNN's features of each nearest view.
Views repeat across steps, so the trainer keeps each view's pre-upsample
stage maps (feature_pyramid.apply_stages, 16x smaller than the full map)
on the device, keyed by view id, and assembles the [V, ...] stack for a
batch with one single-view CNN call per miss.  A step that reads cached
maps sends no gradient into the CNN, so the CNN trains in bursts: the
first `pyramid_burst_steps` of every `pyramid_cycle_steps` steps run
uncached, and the cache is emptied when a burst begins (the CNN is about to
change).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from hybridneuralrendering_tpu_torch.config import Config, OptimConfig
from hybridneuralrendering_tpu_torch.device import no_tf32
from hybridneuralrendering_tpu_torch.models import renderer


def in_burst(step: int, optim: OptimConfig) -> bool:
    """Whether `step` runs uncached (the CNN in the step, JAX
    cli/train.py:438-441): always without the cache, else the first
    pyramid_burst_steps of each cycle."""
    if not optim.pyramid_cache:
        return True
    return step % optim.pyramid_cycle_steps < optim.pyramid_burst_steps


def burst_begins(step: int, optim: OptimConfig) -> bool:
    """Whether the cache is emptied before `step` (JAX cli/train.py:523-525,
    which invalidates when a burst step follows a cached one)."""
    return (optim.pyramid_cache and step > 0 and in_burst(step, optim)
            and not in_burst(step - 1, optim))


class PyramidCache:
    """view id -> (s1, s2, s3) of that view, [h, w, C] each, in `dtype`."""

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.bfloat16):
        self.cfg = cfg
        self.dtype = dtype
        self._store: Dict[int, Tuple[torch.Tensor, ...]] = {}
        self.hits = 0
        self.misses = 0

    def invalidate(self) -> None:
        self._store.clear()

    @torch.no_grad()
    def get_stack(self, params: Dict, images_nearest: torch.Tensor,
                  vids: Sequence[int]) -> Tuple[torch.Tensor, ...]:
        """images_nearest [V, H, W, 3] on the device; vids the V view ids.
        Returns (s1 [V, ...], s2, s3) in the cache dtype, computing and
        keeping any view not held yet (one CNN call per miss)."""
        per_view = []
        for i, v in enumerate(vids):
            v = int(v)
            entry = self._store.get(v)
            if entry is None:
                self.misses += 1
                with no_tf32():
                    stages = renderer.compute_image_feature_stages(
                        params, self.cfg, images_nearest[i:i + 1])
                entry = tuple(s[0].to(self.dtype) for s in stages)
                self._store[v] = entry
            else:
                self.hits += 1
            per_view.append(entry)
        return tuple(torch.stack([e[j] for e in per_view])
                     for j in range(3))

    def __len__(self) -> int:
        return len(self._store)
