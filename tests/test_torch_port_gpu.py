"""Tests of the port that need an NVIDIA GPU: the CUDA kernels against their
plain PyTorch versions, and a render and a training step on the card
against the same on the CPU.  They skip where torch.cuda.is_available() is
false.

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest -q --noconftest -m gpu tests/test_torch_port_gpu.py
"""

import copy
import dataclasses

import pytest
import torch

from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch import serve
from hybridneuralrendering_tpu_torch.data import synthetic
from hybridneuralrendering_tpu_torch.models import blur, renderer
from hybridneuralrendering_tpu_torch.models import neural_points as npts
from hybridneuralrendering_tpu_torch.ops import adam as TA
from hybridneuralrendering_tpu_torch.ops import segment_sum as TSS
from hybridneuralrendering_tpu_torch.ops import select as TS
from hybridneuralrendering_tpu_torch.train import state as tstate
from hybridneuralrendering_tpu_torch.train import step as tstep


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


def _segments(cuda, M, C, n, ids=None, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    if ids is None:
        ids = torch.randint(0, max(n, 1), (M,), generator=g, device=cuda)
    si = torch.sort(ids.to(torch.int32)).values
    sg = torch.randn(M, C, generator=g, device=cuda)
    return sg, npts.segment_ends(si, n), si


def _integer_rows(cuda, M, C, seed=1):
    """Rows of integers in +-[1, 8]: every float32 partial sum of up to 2**21
    of them is exact, so the kernel must equal the plain version bit for
    bit, and a row summed twice, dropped or given to the neighbouring id
    changes the result."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    mag = torch.randint(1, 9, (M, C), generator=g, device=cuda)
    sign = torch.randint(0, 2, (M, C), generator=g, device=cuda) * 2 - 1
    return (mag * sign).float()


@pytest.mark.gpu
@pytest.mark.parametrize("M,C,n,kind", [
    (602_112, 64, 600_000, "random"), (1, 3, 5, "random"),
    (1, 64, 1, "random"), (0, 64, 100, "random"), (4_000, 3, 7, "random"),
    (50_000, 64, 1_000, "one_segment"), (20_000, 64, 600, "few_ids"),
    (1_000, 130, 2_000, "random"), (30_000, 45, 9_000, "with_empty")])
def test_segment_sum_kernel_matches_plain(cuda, M, C, n, kind):
    """Normal rows within the kernel's float32 summation bound
    (segment_sum.tolerance); integer rows bit for bit.  `with_empty` puts
    a third of the rows after the last id, as the gather backward sorts
    its empty slots."""
    ids = None
    if kind == "one_segment":
        ids = torch.full((M,), n // 2, device=cuda)
    elif kind == "few_ids":
        ids = torch.randint(0, 6, (M,), device=cuda) * 97
    elif kind == "with_empty":
        ids = torch.randint(0, n, (M,), device=cuda)
        ids[torch.rand(M, device=cuda) < 1 / 3] = n
    sg, end_pos, _ = _segments(cuda, M, C, n, ids)
    before = TSS.segment_sum.launches
    got = TSS.segment_sum(sg, end_pos, n)
    want = TSS.segment_sum_plain(sg, end_pos, n)
    torch.cuda.synchronize()
    assert TSS.segment_sum.launches == before + 1
    assert got.shape == (n, C)
    assert ((got - want).abs() <= TSS.tolerance(sg, end_pos, n)).all()
    assert torch.isfinite(got).all()
    sq = _integer_rows(cuda, M, C)
    got_q = TSS.segment_sum(sq, end_pos, n)
    want_q = TSS.segment_sum_plain(sq, end_pos, n)
    assert torch.equal(got_q, want_q)
    lens = torch.diff(end_pos.long(), prepend=end_pos.new_full((1,), -1))
    if M and n and lens.max() > 0:
        # the comparison sees one boundary row counted twice
        p = int(lens.argmax())
        got_q[p] += sq[int(end_pos[p]) - int(lens[p]) + 1]
        assert not torch.equal(got_q, want_q)


@pytest.mark.gpu
def test_segment_sum_kernel_is_deterministic(cuda):
    ids = torch.randint(0, 68_000, (602_112,), device=cuda) * 8
    ids[torch.rand(602_112, device=cuda) < 2 / 3] = 600_000
    sg, end_pos, _ = _segments(cuda, 602_112, 64, 600_000, ids)
    a = TSS.segment_sum(sg, end_pos, 600_000)
    b = TSS.segment_sum(sg, end_pos, 600_000)
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,offset", [((600_000, 64), 0), ((1, 3), 0),
                                          ((7, 3), 0), ((1000, 64), 1)])
def test_adam_table_kernel_equals_plain(cuda, shape, offset):
    """Bit for bit over three accumulating steps, including a scalar tail
    (21 values) and a table that is not 16-byte aligned (offset 1)."""
    g0 = torch.Generator(device=cuda).manual_seed(1)
    numel = shape[0] * shape[1]

    def place(x):
        """x copied into a buffer `offset` floats past an allocation."""
        buf = torch.empty(numel + offset, device=cuda)
        out = buf[offset:].view(shape)
        out.copy_(x)
        return out

    def make():
        return place(torch.randn(shape, generator=g0, device=cuda))

    p = make()
    zero = torch.zeros(shape, device=cuda)
    k = [place(p), place(zero), place(zero)]
    q = [place(p), place(zero), place(zero)]
    sched = tstate.lr_schedule(0.002, TC.OptimConfig())
    before = TA.adam_table.launches
    for step in range(3):
        g = make()
        s = TA.adam_scalars(step, step, sched, 0.9, 0.999)
        TA.adam_table(k[0], g, k[1], k[2], s)
        TA.adam_table_plain(q[0], g, q[1], q[2], s)
    torch.cuda.synchronize()
    assert TA.adam_table.launches == before + 3
    for a, b in zip(k, q):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda):
    """tiny_test (float32 chains): one training step on the card and on the
    CPU from one state, with the same jitter noise.  Loss items and
    gradients agree to rtol 1e-4 / atol 1e-5 * max|g| (sums in another
    order, no TF32); after the step the table agrees where |g| clears
    1e-3 * max|g| (Adam's first step is about +-lr per element, so a
    gradient within the rounding noise may flip an element's direction)."""
    cfg = TC.tiny_test()
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss,
                                               use_frame_weight=True))
    res = {}
    for dev in (cuda, torch.device("cpu")):
        points, grid = synthetic.make_synthetic_scene(cfg, 1500, device=dev)
        params = renderer.init_params(cfg, seed=0, device=dev)
        st = tstate.create_train_state(params, points, cfg, device=dev)
        batch = synthetic.make_synthetic_batch(cfg, device=dev)
        bank = torch.as_tensor(blur.generate_kernel_bank(cfg.blur),
                               device=dev)
        noise = torch.rand((cfg.sampling.rays_per_batch,
                            cfg.querier.z_depth_dim),
                           generator=torch.Generator().manual_seed(3)).to(dev)
        items, g_net, g_table = tstep.loss_and_grads(st, grid, batch, bank,
                                                     cfg, noise=noise)
        before = copy.deepcopy(st.points.table)
        st, _ = tstep.train_step(st, grid, batch, bank, cfg, noise=noise)
        res[dev.type] = (items, g_table, before, st.points.table)
    (ki, kg, kb, kt), (ci, cg, cb, ct) = res["cuda"], res["cpu"]
    for k, v in ci.items():
        torch.testing.assert_close(ki[k].cpu(), v, rtol=1e-4, atol=1e-6)
    kg, kt = kg.cpu(), kt.cpu()
    tol = 1e-5 * cg.abs().max()
    torch.testing.assert_close(kg, cg, rtol=1e-4, atol=float(tol))
    sel = cg.abs() > 1e-3 * cg.abs().max()
    torch.testing.assert_close(kt[sel], ct[sel], rtol=1e-5, atol=1e-6)
    assert torch.equal(kt[:, :3], cb[:, :3])
