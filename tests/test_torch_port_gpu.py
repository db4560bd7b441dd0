"""Tests of the port that need an NVIDIA GPU: the CUDA kernels against their
plain PyTorch versions, and a render on the card against the same render
on the CPU.  They skip where torch.cuda.is_available() is false.

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest -q --noconftest -m gpu tests/test_torch_port_gpu.py
"""

import pytest
import torch

from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch import serve
from hybridneuralrendering_tpu_torch.data import synthetic
from hybridneuralrendering_tpu_torch.models import renderer
from hybridneuralrendering_tpu_torch.ops import select as TS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("S,C,k", [(393_216, 32, 8), (75_264, 64, 8),
                                   (4_096, 702, 8), (1_000, 5, 8),
                                   (333, 1024, 3)])
def test_k_smallest_kernel_equals_plain(cuda, S, C, k):
    g = torch.Generator(device=cuda).manual_seed(0)
    d = torch.rand(S, C, generator=g, device=cuda)
    d = torch.round(d * 64) / 64          # many exact ties
    d[torch.rand(S, C, generator=g, device=cuda) < 0.3] = TS.BIG
    ids = torch.randint(0, 1 << 30, (S, C), generator=g, device=cuda,
                        dtype=torch.int32)
    before = TS.k_smallest.launches
    kd, ki = TS.k_smallest(d, ids, k)
    pd, pi = TS.k_smallest_plain(d, ids, k)
    torch.cuda.synchronize()
    assert TS.k_smallest.launches == before + 1
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


@pytest.mark.gpu
def test_k_smallest_kernel_rejects_too_many_columns(cuda):
    d = torch.zeros(4, 1025, device=cuda)
    with pytest.raises(ValueError):
        TS.k_smallest(d, torch.zeros_like(d, dtype=torch.int32), 8)


@pytest.mark.gpu
def test_render_on_card_matches_cpu(cuda):
    """tiny_test (float32 chains): card and CPU renders of the same scene
    agree to rtol 1e-4 / atol 1e-5 (sums in another order; no TF32)."""
    cfg = TC.tiny_test()
    out = {}
    for dev in (cuda, torch.device("cpu")):
        points, grid = synthetic.make_synthetic_scene(cfg, 1500, device=dev)
        params = renderer.init_params(cfg, seed=0, device=dev)
        req = synthetic.make_synthetic_batch(cfg, num_rays=200, device=dev)
        out[dev.type] = serve.render_rays(params, points, grid, req, cfg)
    for key, ref in out["cpu"].items():
        got = out["cuda"][key].cpu()
        if ref.dtype == torch.bool:
            assert torch.equal(got, ref), key
        else:
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
