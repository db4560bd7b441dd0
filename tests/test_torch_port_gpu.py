"""Tests of the port that need an NVIDIA GPU: the CUDA kernels against their
plain PyTorch versions (K-min bit for bit, also on the edge rows of
torch_port_select_rows.py; the shading chain within
ops/shading_chain.tolerance, a relative L2 error; the row scan bit for bit
on int32 and within ops/scan.tolerance on float32), the voxel grid, a
render and a training step (uncached and cached; also with the learnable
blur kernel) on the card against the same on the CPU, the per-voxel K-NN
against the CPU and the supervoxel path, the native batch sampler built
on this machine, the frustum query, the edit render with rw2c and RAFT
against the CPU.  They skip where torch.cuda.is_available() is false.

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
from hybridneuralrendering_tpu_torch.ops import scan as TSCAN
from hybridneuralrendering_tpu_torch.ops import segment_sum as TSS
from hybridneuralrendering_tpu_torch.ops import shading_chain as TSC
from hybridneuralrendering_tpu_torch.ops import query as tq
from hybridneuralrendering_tpu_torch.ops import select as TS
from hybridneuralrendering_tpu_torch.ops import voxel_grid as TVG
from hybridneuralrendering_tpu_torch.train import pyramid_cache as TPC
from hybridneuralrendering_tpu_torch.train import state as tstate
from hybridneuralrendering_tpu_torch.train import step as tstep
from torch_port_select_rows import edge_rows


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


def _kernel_equals_plain(d, ids, k):
    """One kernel call against the plain version: bit for bit, one launch
    (none for an empty batch)."""
    before = TS.k_smallest.launches
    kd, ki = TS.k_smallest(d, ids, k)
    pd, pi = TS.k_smallest_plain(d, ids, k)
    torch.cuda.synchronize()
    assert TS.k_smallest.launches == before + (d.shape[0] > 0)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    return kd, ki


def _edge_rows(cuda, S, C, k):
    """S rows cycling through the edge rows of torch_port_select_rows."""
    d, i = edge_rows(C, k, seed=C * 100 + k)
    reps = -(-S // d.shape[0])
    d = torch.from_numpy(d).to(cuda).repeat(reps, 1)[:S].contiguous()
    i = torch.from_numpy(i).to(cuda).repeat(reps, 1)[:S].contiguous()
    return d, i


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3, 4, 8, 16, 17])
@pytest.mark.parametrize("C", [1, 5, 31, 32, 33, 63, 64, 65, 702, 1024])
def test_k_smallest_kernel_on_edge_rows(cuda, C, k):
    """All-BIG and all-+inf rows, +inf and 3e30 beside BIG, 1..k-1 entries
    below BIG among BIG columns before and after them, exact ties, k > C:
    both paths (thread per row to C = 64 and k = 16, warp per row past)."""
    d, ids = _edge_rows(cuda, 1_000, C, k)
    _kernel_equals_plain(d, ids, k)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [0, 1, TS.TILE_ROWS - 1, TS.TILE_ROWS,
                               TS.TILE_ROWS + 1, 393_216])
@pytest.mark.parametrize("C", [5, 32])
def test_k_smallest_kernel_at_tile_edges(cuda, S, C):
    """Batches around one tile and a serving chunk's; at C = 5 a ragged
    last tile is not a multiple of 16 bytes and is copied by the threads."""
    d, ids = _edge_rows(cuda, S, C, 8)
    _kernel_equals_plain(d, ids, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("C,k,shift", [(33, 8, "row"), (5, 4, "row"),
                                       (63, 16, "row"), (32, 8, "word"),
                                       (64, 8, "word")])
def test_k_smallest_kernel_takes_a_misaligned_view(cuda, C, k, shift):
    """A contiguous view one row (odd C) or one word into its storage is
    4-byte but not 16-byte aligned: the kernel reads it as it is."""
    S = 3 * TS.TILE_ROWS + 7
    d, ids = _edge_rows(cuda, S + 1, C, k)
    if shift == "row":
        d, ids = d[1:], ids[1:]
    else:
        d = d.reshape(-1)[1:1 + S * C].view(S, C)
        ids = ids.reshape(-1)[1:1 + S * C].view(S, C)
    assert d.is_contiguous() and d.data_ptr() % 16 and ids.data_ptr() % 16
    _kernel_equals_plain(d, ids, k)


@pytest.mark.gpu
def test_k_smallest_kernel_is_bit_repeatable_on_two_streams(cuda):
    """Launches on two streams in flight together, and repeated launches,
    give the first launch's bits."""
    d, ids = _edge_rows(cuda, 393_216, 32, 8)
    one = _kernel_equals_plain(d, ids, 8)
    side = [torch.cuda.Stream(), torch.cuda.Stream()]
    out = []
    for st in side:
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            out += [TS.k_smallest(d, ids, 8) for _ in range(2)]
    torch.cuda.synchronize()
    for od, oi in out:
        assert torch.equal(od, one[0]) and torch.equal(oi, one[1])


@pytest.mark.gpu
def test_k_smallest_kernel_refuses_a_strided_view(cuda):
    d = torch.zeros(8, 64, device=cuda)[:, ::2]
    with pytest.raises(ValueError):
        TS.k_smallest(d, torch.zeros(8, 32, dtype=torch.int32,
                                     device=cuda), 8)


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
    (1_000, 130, 2_000, "random"), (30_000, 45, 9_000, "with_empty"),
    (301_056, 45, 1_228_800, "pyramid_map"),
    (602_112, 64, 600_000, "sixteen_ids"),
    (40_000, 45, 3, "one_segment"), (40_000, 64, 3, "one_segment"),
    (5_000, 45, 60, "tile_edges"), (5_000, 64, 60, "tile_edges")])
def test_segment_sum_kernel_matches_plain(cuda, M, C, n, kind):
    """Normal rows within the kernel's float32 summation bound
    (segment_sum.tolerance); integer rows bit for bit; ten launches bit
    for bit.  `with_empty` puts a third of the rows after the last id, as
    the gather backward sorts its empty slots; `pyramid_map` and
    `sixteen_ids` are the shapes of a step's pyramid-map backward (about
    11k of 1.2M pixel ids touched, 45 columns) and the smoke's
    duplicate-heavy case (16 ids, segments of ~38k rows); `one_segment` at
    40,000 rows spans 313 row tiles of the kernel; `tile_edges` makes
    segments of 128 and 64 rows in turn, so ends fall on tile edges and
    next to them."""
    ids = None
    if kind == "one_segment":
        ids = torch.full((M,), n // 2, device=cuda)
    elif kind == "few_ids":
        ids = torch.randint(0, 6, (M,), device=cuda) * 97
    elif kind == "with_empty":
        ids = torch.randint(0, n, (M,), device=cuda)
        ids[torch.rand(M, device=cuda) < 1 / 3] = n
    elif kind == "pyramid_map":
        touched = torch.sort(torch.randperm(n, device=cuda)[:11_368]).values
        ids = touched[torch.randint(0, 11_368, (M,), device=cuda)]
    elif kind == "sixteen_ids":
        ids = torch.randint(0, 16, (M,), device=cuda) * 37_501
    elif kind == "tile_edges":
        lens = torch.tensor([128, 64], device=cuda).repeat(n // 2)
        ids = torch.repeat_interleave(torch.arange(n, device=cuda), lens)[:M]
    sg, end_pos, _ = _segments(cuda, M, C, n, ids)
    before = TSS.segment_sum.launches
    got = TSS.segment_sum(sg, end_pos, n)
    want = TSS.segment_sum_plain(sg, end_pos, n)
    torch.cuda.synchronize()
    assert TSS.segment_sum.launches == before + 1
    assert got.shape == (n, C)
    assert ((got - want).abs() <= TSS.tolerance(sg, end_pos, n)).all()
    assert torch.isfinite(got).all()
    for _ in range(10):
        assert torch.equal(TSS.segment_sum(sg, end_pos, n), got)
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


def _chain_case(cuda, F, ce, n, dtype, seed=0):
    """scannet_full's chain shapes at feature width F (block1 from the
    32-wide embedding and 6 dists with 3 and 5 PE bands) on n rows."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    cfg = dataclasses.replace(TC.scannet_full().agg, shading_feature_num=F,
                              shading_dtype=dtype)
    c1 = TSC.pe_width(32, 6, cfg.num_feat_freqs, cfg.dist_xyz_freq)

    def stack(dims):
        return [{"w": (torch.rand(a, b, generator=g, device=cuda) * 2 - 1)
                 * (6.0 / (a + b)) ** 0.5,
                 "b": (torch.rand(b, generator=g, device=cuda) * 2 - 1) * 0.1}
                for a, b in zip(dims[:-1], dims[1:])]
    params = {"block1": stack([c1, F, F]), "block3": stack([F + ce, F, F]),
              "alpha": stack([F, 1])}
    r = lambda *s: torch.randn(*s, generator=g, device=cuda)   # noqa: E731
    x = dict(emb=0.5 * r(n, 32), dists=0.5 * r(n, 6), extra=r(n, ce),
             dfeat=r(n, F), dalpha=r(n, 1))
    return cfg, params, x


@pytest.mark.gpu
@pytest.mark.parametrize("F,ce,n,dtype", [
    (256, 7, 3_000, "bfloat16"), (256, 7, 1_000, "float32"),
    (128, 0, 777, "bfloat16"), (128, 7, 130, "float32"),
    (256, 7, 4_096 + 64 * 3, "bfloat16"), (128, 0, 64, "float32"),
    (256, 7, 1, "bfloat16"), (256, 7, 127, "bfloat16"),
    (256, 7, 128, "bfloat16"), (256, 7, 129, "bfloat16"),
    (256, 7, 128 * 132 + 1, "bfloat16"),
    (256, 7, 128 * 132 * 3 + 77, "bfloat16")])
def test_shading_chain_kernels_match_plain(cuda, F, ce, n, dtype):
    """Forward and the two backward kernels against chain_plain and
    chain_backward_plain on the card, within ops/shading_chain.tolerance;
    ragged row counts (not a multiple of the 64-row tile or of the 4,096-row
    dW chunk) and no extra columns included.  The bf16 kernels walk 128-row
    tiles with at most one block per SM: less than a tile, one tile, a row
    past it, one tile more than the 132 blocks of an H100, and three tiles
    a block with a ragged last one."""
    cfg, params, x = _chain_case(cuda, F, ce, n, dtype)
    layout = TSC.chain_layout(params, cfg, 32, 6, ce)
    w, b = TSC.pack_chain(params, layout, TSC.COMPUTE_DTYPES[dtype])
    before = dict(TSC.LAUNCHES)
    feat, alpha = TSC.chain_forward(layout, w, b, x["emb"], x["dists"],
                                    x["extra"])
    d_emb, d_dists, d_extra, packed = TSC.backward_on_card(
        layout, w, b, x["emb"], x["dists"], x["extra"], x["dfeat"],
        x["dalpha"])
    torch.cuda.synchronize()
    assert TSC.LAUNCHES == {k: v + 1 for k, v in before.items()}
    want_f, want_a = TSC.chain_plain(x["emb"], x["dists"], x["extra"],
                                     params, cfg, dtype)
    got_g = TSC.unpack_chain(packed, layout)
    want = TSC.chain_backward_plain(x["emb"], x["dists"], x["extra"], params,
                                    cfg, dtype, x["dfeat"], x["dalpha"])
    bwd_tol = TSC.tolerance(dtype, "grad")
    assert TSC.rel_l2(feat, want_f) <= TSC.tolerance(dtype, "feat")
    assert TSC.rel_l2(alpha, want_a) <= TSC.tolerance(dtype, "alpha")
    for got, ref in zip([d_emb, d_dists, d_extra], want[:3]):
        assert got.shape == ref.shape
        if ref.numel():
            assert TSC.rel_l2(got, ref) <= bwd_tol
    for got, ref in zip(got_g, TSC._layer_list(want[3])):
        assert TSC.rel_l2(got["w"], ref["w"]) <= bwd_tol
        assert TSC.rel_l2(got["b"], ref["b"]) <= bwd_tol


@pytest.mark.gpu
@pytest.mark.parametrize("n", [128 * 132 + 1, 20_000])
def test_shading_chain_forward_is_bit_repeatable(cuda, n):
    cfg, params, x = _chain_case(cuda, 256, 7, n, "bfloat16", seed=1)
    layout = TSC.chain_layout(params, cfg, 32, 6, 7)
    w, b = TSC.pack_chain(params, layout, torch.bfloat16)
    args = (layout, w, b, x["emb"], x["dists"], x["extra"])
    one, two = TSC.chain_forward(*args), TSC.chain_forward(*args)
    for a, b_ in zip(one, two):
        assert torch.equal(a, b_)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [129, 20_000])
def test_shading_chain_db_partials_sum_to_plain_db(cuda, n):
    """chain_bwd's db partials (one row per 64 rows, what chain_dw reads),
    summed over their rows, equal the plain version's db within the
    gradient tolerance; rows past the padded count are never written."""
    cfg, params, x = _chain_case(cuda, 256, 7, n, "bfloat16", seed=3)
    layout = TSC.chain_layout(params, cfg, 32, 6, 7)
    w, b = TSC.pack_chain(params, layout, torch.bfloat16)
    *_, dbpart = TSC.chain_backward(layout, w, b, x["emb"], x["dists"],
                                    x["extra"], x["dfeat"], x["dalpha"])
    want = TSC.chain_backward_plain(x["emb"], x["dists"], x["extra"], params,
                                    cfg, "bfloat16", x["dfeat"], x["dalpha"])
    torch.cuda.synchronize()
    assert dbpart.shape == (-(-n // 64), layout.btot)
    db = dbpart.sum(0)
    for s, ref in zip(layout.layers, TSC._layer_list(want[3])):
        got = db[s.boff:s.boff + s.nout]
        assert TSC.rel_l2(got, ref["b"]) <= TSC.tolerance("bfloat16", "grad")
        assert not db[s.boff + s.nout:s.boff + s.np].any()


@pytest.mark.gpu
def test_shading_chain_backward_is_bit_repeatable(cuda):
    cfg, params, x = _chain_case(cuda, 256, 7, 20_000, "bfloat16", seed=1)
    layout = TSC.chain_layout(params, cfg, 32, 6, 7)
    w, b = TSC.pack_chain(params, layout, torch.bfloat16)
    args = (layout, w, b, x["emb"], x["dists"], x["extra"], x["dfeat"],
            x["dalpha"])
    one, two = TSC.backward_on_card(*args), TSC.backward_on_card(*args)
    for a, b_ in zip(one, two):
        assert torch.equal(a, b_)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_feat_alpha_autograd_on_card_matches_cpu(cuda, dtype):
    """Through torch autograd: the card's kernels against the CPU's plain
    versions, outputs and gradients of every input and parameter."""
    cfg, params, x = _chain_case(cuda, 128, 7, 500, dtype, seed=2)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        p = tstate.tree_map(
            lambda t: t.detach().to(dev).requires_grad_(True), params)
        xs = [x[k].to(dev).requires_grad_(True)
              for k in ("emb", "dists", "extra")]
        feat, alpha = TSC.fused_feat_alpha(p, cfg, *xs)
        loss = ((feat * x["dfeat"].to(dev)).sum()
                + (alpha * x["dalpha"].to(dev)).sum())
        grads = torch.autograd.grad(loss, xs + tstate.tree_leaves(p))
        res[dev.type] = [t.detach().cpu() for t in (feat, alpha, *grads)]
    outputs = ["feat", "alpha"] + ["grad"] * (len(res["cpu"]) - 2)
    for i, (k, c, o) in enumerate(zip(res["cuda"], res["cpu"], outputs)):
        assert TSC.rel_l2(k, c) <= TSC.tolerance(dtype, o), i


@pytest.mark.gpu
@pytest.mark.parametrize("F,dtype", [(272, "bfloat16"), (512, "float32")])
def test_shading_chain_kernels_refuse_layers_too_wide(cuda, F, dtype):
    """A layer wider than the kernels' 256-column pass is refused by the C
    function itself (cudaErrorInvalidValue), which the wrapper raises:
    chain_fwd, and chain_dw on scratch of the layout."""
    cfg, params, x = _chain_case(cuda, F, 7, 100, dtype)
    layout = TSC.chain_layout(params, cfg, 32, 6, 7)
    dt = TSC.COMPUTE_DTYPES[dtype]
    w, b = TSC.pack_chain(params, layout, dt)
    before = dict(TSC.LAUNCHES)
    with pytest.raises(RuntimeError, match="chain_fwd"):
        TSC.chain_forward(layout, w, b, x["emb"], x["dists"], x["extra"])
    z = lambda *s, dt=dt: torch.zeros(*s, dtype=dt, device=cuda)  # noqa
    with pytest.raises(RuntimeError, match="chain_dw"):
        TSC.chain_dw(layout, z(128, layout.atot), z(128, layout.gtot),
                     z(2, layout.btot, dt=torch.float32))
    assert TSC.LAUNCHES == before


def _dw_case(cuda, npad, F=256, seed=4):
    """The chain layout at feature width F (scannet_full's at 256) and
    random scratch of npad rows as chain_bwd leaves it: A and G bf16 (G at
    a cotangent's scale), the db partials float32."""
    cfg, params, _ = _chain_case(cuda, F, 7, 1, "bfloat16", seed)
    layout = TSC.chain_layout(params, cfg, 32, 6, 7)
    g = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda)   # noqa: E731
    ascr = r(npad, layout.atot).to(torch.bfloat16)
    gscr = (1e-2 * r(npad, layout.gtot)).to(torch.bfloat16)
    return layout, ascr, gscr, r(npad // 64, layout.btot)


def _dw_plain(layout, ascr, gscr, dbpart):
    """The packed gradient [wtot + btot] in float64: each A_l^T G_l of the
    bf16 scratch, then db."""
    parts = [(ascr[:, s.aoff:s.aoff + s.kp].double().t()
              @ gscr[:, s.goff:s.goff + s.np].double()).reshape(-1)
             for s in layout.layers]
    return torch.cat(parts + [dbpart.double().sum(0)])


@pytest.mark.gpu
@pytest.mark.parametrize("npad,F", [
    (64, 256), (128, 256), (64 * 13, 256), (64 * 1_000, 256),
    (602_112, 256), (64 * 50, 128)])
def test_chain_dw_matches_plain(cuda, npad, F):
    """The bf16 chain_dw against A^T G and the db sum in float64, per layer
    and for db.  Both read the same bf16 scratch; only the sums differ.
    The tensor cores add each k-step of 16 rows into the f32 accumulator
    with the bits below its last place cut, not rounded (an error of up to
    2**-23 of the running sum, toward zero, a step), so an item's sum over
    a split of R rows can be off by up to R / 16 * 2**-23 relative: the
    limit for dW, 4.1e-4 at 602,112 rows (3,424 k-steps a split), at least
    2**-16 (the float32 order tolerance) for short splits.  db is summed on
    the CUDA cores, rounded: 2**-16.  A stage of 64 rows lost or read
    twice moves the result by about 1 / sqrt(stages), 1e-2 at 602,112
    rows.  npad 64 and 128 are one and two splits of one stage, 64 * 13
    splits of one or two stages, 64 * 1,000 splits of 90 or 91; F = 128
    runs 128-column layers in 256-column wgmmas and block3's 144 inputs as
    an item of 128 rows and one of 16."""
    layout, ascr, gscr, dbpart = _dw_case(cuda, npad, F)
    before = TSC.LAUNCHES["shading_chain_dw"]
    got = TSC.chain_dw(layout, ascr, gscr, dbpart)
    want = _dw_plain(layout, ascr, gscr, dbpart)
    torch.cuda.synchronize()
    assert TSC.LAUNCHES["shading_chain_dw"] == before + 1
    plan = TSC.dw_plan(layout, npad)
    bounds = plan[2 + 8 * plan[0]:]
    ksteps = 4 * max(b - a for a, b in zip(bounds, bounds[1:]))
    f32 = TSC.tolerance("float32", "grad")
    tol = max(f32, ksteps * 2.0 ** -23)
    errs = {f"{s.key[0]}/{s.key[1]}": TSC.rel_l2(
        got[s.woff:s.woff + s.kp * s.np], want[s.woff:s.woff + s.kp * s.np])
        for s in layout.layers}
    db_err = TSC.rel_l2(got[layout.wtot:], want[layout.wtot:])
    print(f"chain_dw npad={npad} F={F} limit {tol:.3g} rel_l2 {errs} db "
          f"{db_err:.3g}")
    assert max(errs.values()) <= tol, errs
    assert db_err <= f32


@pytest.mark.gpu
def test_chain_dw_is_bit_repeatable_on_two_streams(cuda):
    """The same sums in the same order on any stream, with two launches on
    two streams in flight together: no state outside the launch."""
    layout, ascr, gscr, dbpart = _dw_case(cuda, 64 * 1_000)
    one = TSC.chain_dw(layout, ascr, gscr, dbpart)
    side = [torch.cuda.Stream(), torch.cuda.Stream()]
    out = []
    for st in side:
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            out.append(TSC.chain_dw(layout, ascr, gscr, dbpart))
    torch.cuda.synchronize()
    for x in out:
        assert torch.equal(x, one)


@pytest.mark.gpu
@pytest.mark.parametrize("field,value", [(2, 129), (3, 128), (1, 1_100),
                                         (-2, 0)])
def test_chain_dw_refuses_a_plan_outside_its_tiles(cuda, field, value):
    """The C function checks the plan it is given: an item of more than
    128 dW rows, a wgmma width other than 64 or 256, G columns past the
    scratch, or a row split with no rows return cudaErrorInvalidValue (1)
    before any launch."""
    import ctypes
    layout, ascr, gscr, dbpart = _dw_case(cuda, 128)
    plan = list(TSC.dw_plan(layout, 128))
    plan[2 + field if field >= 0 else field] = value
    grad = torch.empty(layout.wtot + layout.btot, device=cuda)
    partial = torch.empty((plan[1], grad.numel()), device=cuda)
    err = TSC._lib().chain_dw_launch(
        TSC._meta(layout), 1, ascr.data_ptr(), gscr.data_ptr(),
        dbpart.data_ptr(), 128, (ctypes.c_int * len(plan))(*plan), len(plan),
        plan[1], partial.data_ptr(), grad.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert err == 1


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (602_112,), (16_200_000,), (1,), (4_096,), (4_097,), (1_048_576 + 5,),
    (602_112, 64), (1, 64), (257, 3), (5_000, 45), (300, 130),
    (8_191,), (8_192,), (8_193,), (32 * 8_192 + 1,), (33 * 8_192 + 1,)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_cumsum_rows_kernel_matches_plain(cuda, shape, dtype):
    """int32 0/1 flags (the ranks' input) and signed integers bit for bit;
    float32 normal rows within ops/scan.tolerance and integer-valued rows
    (every partial sum exact) bit for bit; an exclusive scan is rejected.
    Shapes from the main path and ragged ones: at and next to the edges of
    the 8,192-element (F == 1) or 256-row tile, more than 256 tiles (a
    carry across scan chunks), tiles whose look-back crosses a window of
    32 predecessors (33 and 34 tiles; 16.2M has 1,978), widths not a
    multiple of 32 columns."""
    g = torch.Generator(device=cuda).manual_seed(len(shape) * 7 + shape[0])
    if dtype == "int32":
        flags = (torch.rand(shape, generator=g, device=cuda) < 0.1).int()
        flags.view(-1)[0] = 1          # a rank scan's first flag is set
        signed = torch.randint(-1000, 1000, shape, generator=g, device=cuda,
                               dtype=torch.int32)
        cases = [(flags, None), (signed, None)]
    else:
        x = torch.randn(shape, generator=g, device=cuda)
        q = _integer_rows(cuda, shape[0], shape[1] if len(shape) > 1 else 1,
                          seed=3).reshape(shape)
        cases = [(x, TSCAN.tolerance(x)), (q, None)]
    for x, tol in cases:
        before = TSCAN.cumsum_rows.launches
        got = TSCAN.cumsum_rows(x)
        want = TSCAN.cumsum_rows_plain(x)
        torch.cuda.synchronize()
        assert TSCAN.cumsum_rows.launches == before + 1
        assert got.dtype == x.dtype and got.shape == x.shape
        exclusive = got - x
        if tol is None:
            assert torch.equal(got, want)
            assert not torch.equal(exclusive, want)
        else:
            err = (got.double() - want.double()).abs()
            assert (err <= tol).all(), float((err - tol).max())
            assert not ((exclusive.double() - want.double()).abs()
                        <= tol).all()


@pytest.mark.gpu
@pytest.mark.parametrize("M", [602_112, 33 * 8_192 + 1])
def test_cumsum_rows_lookback_state_resets(cuda, M):
    """The int32 look-back's status words and ticket belong to one call:
    back-to-back calls on different inputs, and calls on a second stream
    while the first stream runs, each equal the plain version bit for
    bit."""
    g = torch.Generator(device=cuda).manual_seed(M)
    xs = [(torch.rand(M, generator=g, device=cuda) < p).int()
          for p in (0.1, 0.5, 0.9)]
    xs.append(torch.randint(-1000, 1000, (M,), generator=g, device=cuda,
                            dtype=torch.int32))
    ys = [TSCAN.cumsum_rows(x) for x in xs[:2]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ys_side = [TSCAN.cumsum_rows(x) for x in xs[2:]]
    ys.append(TSCAN.cumsum_rows(xs[0]))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for x, y in zip(xs[:2] + xs[2:] + xs[:1], ys[:2] + ys_side + ys[2:]):
        assert torch.equal(y, TSCAN.cumsum_rows_plain(x))


@pytest.mark.gpu
def test_cumsum_rows_kernel_is_deterministic_and_launches_nothing_empty(cuda):
    x = torch.randn(602_112, 64, device=cuda)
    assert torch.equal(TSCAN.cumsum_rows(x), TSCAN.cumsum_rows(x))
    before = TSCAN.cumsum_rows.launches
    assert TSCAN.cumsum_rows(torch.zeros(0, 64, device=cuda)).shape == (0, 64)
    assert TSCAN.cumsum_rows.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("num", [1_500, 60_000])
def test_build_grid_on_card_equals_cpu(cuda, num):
    """tiny_test's grid, every table bit for bit; the card's build ranks its
    segments through the row-scan kernel, twice with supervoxels.  At
    60,000 points the supervoxel build ranks 1.6M keys (more than 256
    scan tiles) and overflows the node capacity."""
    cfg = TC.tiny_test()
    a = synthetic.scene_arrays(cfg, num, 0)
    mask = torch.ones(len(a["xyz"]), dtype=torch.bool)
    grids = {}
    for dev in (cuda, torch.device("cpu")):
        geom = TVG.compute_grid_geometry(a["xyz"], mask.numpy(), cfg.querier,
                                         device=dev)
        before = TSCAN.cumsum_rows.launches
        grids[dev.type] = TVG.build_grid(torch.as_tensor(a["xyz"],
                                                         device=dev),
                                         mask.to(dev), geom, cfg.querier)
        launched = TSCAN.cumsum_rows.launches - before
        assert launched == (2 if cfg.querier.supervoxel else 1) * (
            dev.type == "cuda")
    for name in grids["cpu"]._fields:
        ref, got = getattr(grids["cpu"], name), getattr(grids["cuda"], name)
        if torch.is_tensor(ref):
            got = got.cpu()
            if ref.dtype == torch.float32:   # id lanes hold int32 bits
                ref, got = ref.view(torch.int32), got.view(torch.int32)
            assert torch.equal(got, ref), name


@pytest.mark.gpu
def test_cached_train_step_on_card_matches_cpu(cuda):
    """tiny_test (float32 chains and maps): an uncached step, then a cached
    step from PyramidCache maps, on the card and on the CPU from one state.
    The cached step launches one K-min, one segment sum (no pyramid map
    gradient), one table Adam, each chain kernel once and one row scan (the
    dedup ranks).  Loss items and gradients agree as in
    test_train_step_on_card_matches_cpu; the CNN's gradient is zero."""
    cfg = TC.tiny_test()
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss,
                                               use_frame_weight=True))
    counters = {"k_smallest": TS.k_smallest, "segment_sum": TSS.segment_sum,
                "adam_table": TA.adam_table,
                "cumsum_rows": TSCAN.cumsum_rows}
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
        st, _ = tstep.train_step(st, grid, batch, bank, cfg, noise=noise)
        cache = TPC.PyramidCache(cfg, dtype=torch.float32)
        views = batch["images_nearest"]
        staged = (views, cache.get_stack(st.params, views,
                                         range(len(views))))
        before = {k: f.launches for k, f in counters.items()}
        chain_before = dict(TSC.LAUNCHES)
        items, g_net, g_table = tstep.loss_and_grads(
            st, grid, batch, bank, cfg, noise=noise, img_feat_staged=staged)
        tstep.apply_updates(st, g_net, g_table, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert {k: f.launches - before[k]
                    for k, f in counters.items()} == dict.fromkeys(counters,
                                                                   1)
            assert {k: v - chain_before[k] for k, v in
                    TSC.LAUNCHES.items()} == dict.fromkeys(TSC.LAUNCHES, 1)
        assert not any(bool(g.any()) for g in tstate.tree_leaves(
            g_net["aggregator"]["pyramid"]))
        res[dev.type] = (items, g_table, torch.cat([
            x.reshape(-1) for x in tstate.tree_leaves(g_net)]))
    (ki, kg, kn), (ci, cg, cn) = res["cuda"], res["cpu"]
    for k, v in ci.items():
        torch.testing.assert_close(ki[k].cpu(), v, rtol=1e-4, atol=1e-6)
    for got, ref in ((kg, cg), (kn, cn)):
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-4,
                                   atol=float(1e-5 * ref.abs().max()))


# ------------------------------------------------ the evaluation CLI's I/O

@pytest.mark.gpu
def test_png_and_metrics_on_card_tensors(cuda, tmp_path):
    from hybridneuralrendering_tpu_torch.io import png
    from hybridneuralrendering_tpu_torch.utils import metrics, visualizer
    g = torch.Generator(device=cuda).manual_seed(0)
    img = torch.rand(48, 64, 3, generator=g, device=cuda)
    ref = torch.rand(48, 64, 3, generator=g, device=cuda)
    p = str(tmp_path / "a.png")
    png.write(p, visualizer.to8b(img))
    got = torch.as_tensor(png.read(p))
    assert torch.equal(got, torch.as_tensor(visualizer.to8b(img.cpu())))
    for fn in (metrics.psnr, metrics.ssim, metrics.rmse):
        assert fn(img, ref) == pytest.approx(fn(img.cpu(), ref.cpu()),
                                             rel=1e-12)


def _tiny_state(dev):
    cfg = TC.tiny_test()
    points, grid = synthetic.make_synthetic_scene(cfg, 1500, device=dev)
    params = renderer.init_params(cfg, seed=0, device=dev)
    st = tstate.create_train_state(params, points, cfg, device=dev)
    st.opt_pts.mu.normal_(generator=torch.Generator(device=dev)
                          .manual_seed(1))
    st.step = st.opt_net.count = st.opt_pts.count = 7
    return cfg, st, grid


@pytest.mark.gpu
def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    import numpy as np
    from hybridneuralrendering_tpu_torch.train import checkpoint as ck
    cfg, st, _ = _tiny_state(cuda)
    path = ck.save_checkpoint(str(tmp_path), st, best_psnr=20.5)
    back, best = ck.load_checkpoint(path, cfg)       # the card by default
    assert best == 20.5 and back.points.table.device.type == "cuda"
    assert back.params["aggregator"]["alpha"][0]["w"].device.type == "cuda"
    saved, loaded = ck.flatten_state(st), ck.flatten_state(back)
    assert sorted(saved) == sorted(loaded)
    for k in saved:
        assert saved[k].dtype == loaded[k].dtype, k
        assert np.array_equal(saved[k], loaded[k]), k


@pytest.mark.gpu
def test_render_full_frame_equals_render_rays_on_card(cuda, tmp_path):
    from hybridneuralrendering_tpu_torch.data import scannet
    cfg, st, grid = _tiny_state(cuda)
    cfg = cfg.replace(sampling=dataclasses.replace(cfg.sampling,
                                                   eval_chunk_rays=1000))
    synthetic.write_scannet_scene(str(tmp_path), cfg, "synth", n_frames=8)
    ds = scannet.ScannetScene(str(tmp_path), "synth", cfg, "test")
    before = TS.k_smallest.launches
    img = serve.render_full_frame(st.params, st.points, grid,
                                  ds.get_batch(0), cfg)
    assert TS.k_smallest.launches - before == 4     # 3,072 rays by 1,000
    ref = serve.render_rays(st.params, st.points, grid,
                            scannet.device_batch(ds.get_batch(0)), cfg)
    assert img.device.type == "cuda"
    assert torch.equal(img, ref["coarse_raycolor"].reshape(48, 64, 3))


# ------------------------------------------------------ the trainer's parts

def _holed_points(cfg, dev, n=1500, seed=0):
    """tiny_test's synthetic cloud with scattered free slots: a conf
    prune at 0.5 of conf uniform in [0, 1]."""
    a = synthetic.scene_arrays(cfg, n, seed)
    conf = torch.rand(len(a["xyz"]), 1,
                      generator=torch.Generator().manual_seed(seed)).numpy()
    pts = npts.init_from_arrays(a["xyz"], cfg.points,
                                embedding=a["embedding"], conf=conf,
                                color=a["color"], dirs=a["dirs"], device=dev)
    return npts.prune(pts, 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("M,share", [(300, 0.5), (3000, 1.0)])
def test_grow_and_prune_on_card_equal_cpu(cuda, M, share):
    """prune and grow on the card equal the CPU's bit for bit; grow ranks
    the new points and the free slots through the row-scan kernel (two
    launches)."""
    cfg = TC.tiny_test()
    g = torch.Generator().manual_seed(M)
    new = [torch.randn(M, w, generator=g) for w in (3, 8, 1, 3, 3)]
    keep = torch.rand(M, generator=g) < share
    out = {}
    for dev in (cuda, torch.device("cpu")):
        pts = _holed_points(cfg, dev)
        before = TSCAN.cumsum_rows.launches
        grown = npts.grow(pts, *(x.to(dev) for x in new), keep.to(dev))
        assert TSCAN.cumsum_rows.launches - before == 2 * (dev.type == "cuda")
        pruned = npts.prune(grown, 0.3)
        out[dev.type] = (grown, pruned)
    for got, ref in zip(out["cuda"], out["cpu"]):
        assert got.table.device.type == "cuda"
        assert torch.equal(got.table.cpu(), ref.table)
        assert torch.equal(got.mask.cpu(), ref.mask)
        assert got.num_live == ref.num_live
    assert out["cpu"][0].num_live > out["cpu"][1].num_live


def _first_max(op):
    """Index of each row's first maximum (jnp.argmax's rule)."""
    idx = torch.arange(op.shape[-1])
    is_max = op == op.max(dim=-1, keepdim=True).values
    return torch.where(is_max, idx, op.shape[-1]).min(dim=-1).values


@pytest.mark.gpu
def test_prob_outputs_on_card_match_cpu(cuda):
    """The point-growing outputs of a render on the card against the CPU's
    within the smoke's 5e-3 on the rays where both devices pick the same
    max-opacity sample; where they pick another, its opacity ties the
    CPU's pick within 5e-3 (random weights leave many near-ties)."""
    cfg = TC.tiny_test()
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        points, grid = synthetic.make_synthetic_scene(cfg, 1500, device=dev)
        params = renderer.init_params(cfg, seed=0, device=dev)
        batch = synthetic.make_synthetic_batch(cfg, seed=5, num_rays=512,
                                               device=dev)
        outs[dev.type] = {k: v.cpu() for k, v in serve.render_rays(
            params, points, grid, batch, cfg, prob=True).items()}
    got, ref = outs["cuda"], outs["cpu"]
    assert torch.equal(got["ray_mask"], ref["ray_mask"])
    op = ref["coarse_point_opacity"]
    ig, ir = _first_max(got["coarse_point_opacity"]), _first_max(op)
    same = ig == ir
    r = torch.arange(op.shape[0])
    assert (op[r, ir] - op[r, ig]).abs().max() <= 5e-3
    assert same.float().mean() > 0.9
    for k in serve.PROB_OUTPUTS:
        torch.testing.assert_close(got[k][same], ref[k][same], rtol=0,
                                   atol=5e-3, msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("cached", [False, True])
def test_train_step_multi_on_card_equals_accumulated_frames(cuda, cached):
    """train_step_multi at F = 2 on the card: its gradients are the mean of
    the two frames' single-frame gradients, and it launches each frame's
    kernels once per frame and the table Adam once."""
    cfg = TC.tiny_test()
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss,
                                               use_frame_weight=True))
    points, grid = synthetic.make_synthetic_scene(cfg, 1500, device=cuda)
    params = renderer.init_params(cfg, seed=0, device=cuda)
    st = tstate.create_train_state(params, points, cfg, device=cuda)
    frames = [synthetic.make_synthetic_batch(cfg, seed=s, device=cuda)
              for s in (1, 2)]
    batches = tstep.stack_batches(frames)
    bank = torch.as_tensor(blur.generate_kernel_bank(cfg.blur), device=cuda)
    noise = torch.rand((2, cfg.sampling.rays_per_batch,
                        cfg.querier.z_depth_dim),
                       generator=torch.Generator(device=cuda).manual_seed(4),
                       device=cuda)
    staged = None
    if cached:
        cache = TPC.PyramidCache(cfg, dtype=torch.float32)
        maps = [cache.get_stack(st.params, f["images_nearest"],
                                range(2 * i, 2 * i + 2))
                for i, f in enumerate(frames)]
        staged = (batches["images_nearest"],
                  tuple(torch.stack([m[j] for m in maps]) for j in range(3)))
    before = TS.k_smallest.launches, TSS.segment_sum.launches
    items, g_net, g_table = tstep.multi_loss_and_grads(
        st, grid, batches, bank, cfg, noise=noise, img_feat_staged=staged)
    torch.cuda.synchronize()
    assert TS.k_smallest.launches - before[0] == 2
    assert TSS.segment_sum.launches - before[1] == (2 if cached else 4)
    singles = [tstep.loss_and_grads(
        st, grid, frames[f], bank, cfg, noise=noise[f],
        img_feat_staged=None if staged is None else
        (staged[0][f], tuple(s[f] for s in staged[1]))) for f in range(2)]
    for k, v in items.items():
        torch.testing.assert_close(v, (singles[0][0][k] + singles[1][0][k])
                                   / 2, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(g_table, (singles[0][2] + singles[1][2]) / 2,
                               rtol=1e-5, atol=1e-6 * float(
                                   g_table.abs().max()))
    for got, a, b in zip(tstate.tree_leaves(g_net),
                         tstate.tree_leaves(singles[0][1]),
                         tstate.tree_leaves(singles[1][1])):
        torch.testing.assert_close(got, (a + b) / 2, rtol=1e-5,
                                   atol=1e-6 * float(got.abs().max()) + 1e-12)
    adam = TA.adam_table.launches
    tstep.train_step_multi(st, grid, batches, bank, cfg, noise=noise,
                           img_feat_staged=staged)
    torch.cuda.synchronize()
    assert TA.adam_table.launches - adam == 1 and st.step == 1


@pytest.mark.gpu
def test_probe_and_grow_and_prune_on_card(cuda, tmp_path):
    """probe_and_grow and prune_and_rebuild on a small written scene on the
    card: the frames rendered through the kernels, the points grown into
    free slots (two row scans) and the grid rebuilt; the same counts and
    masks as on the CPU, the grids equal bit for bit."""
    import numpy as np
    from hybridneuralrendering_tpu_torch.data import scannet
    from hybridneuralrendering_tpu_torch.train import lifecycle
    cfg = TC.tiny_test()
    cfg = cfg.replace(probe=dataclasses.replace(cfg.probe, prob_thresh=0.0,
                                                prune_thresh=0.45))
    synthetic.write_scannet_scene(str(tmp_path), cfg, "synth", n_frames=12)
    ds = scannet.ScannetScene(str(tmp_path), "synth", cfg, "train")
    rng = np.random.default_rng(0)
    n = 1200
    xyz = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                    rng.normal(0, 0.005, n)], -1).astype(np.float32)
    xyz = xyz[~((np.abs(xyz[:, 0]) < 0.4) & (np.abs(xyz[:, 1]) < 0.3))]
    res = {}
    for dev in (cuda, torch.device("cpu")):
        pts = npts.init_from_arrays(xyz, cfg.points, device=dev)
        grid = TVG.grid_of(pts.xyz, pts.mask, cfg.querier)
        params = renderer.init_params(cfg, seed=0, device=dev)
        k0, s0 = TS.k_smallest.launches, TSCAN.cumsum_rows.launches
        grown, g1, added = lifecycle.probe_and_grow(
            params, pts, grid, ds, cfg, max_frames=2,
            rng=np.random.default_rng(1))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            chunks = -(-cfg.image_hw[0] * cfg.image_hw[1]
                       // cfg.sampling.eval_rays)
            assert TS.k_smallest.launches - k0 == 2 * chunks
            assert TSCAN.cumsum_rows.launches - s0 == 2 + 2
        pruned, g2 = lifecycle.prune_and_rebuild(grown, cfg)
        res[dev.type] = (added, grown, g1, pruned, g2)
    (ka, kgr, kg1, kpr, kg2), (ca, cgr, cg1, cpr, cg2) = (res["cuda"],
                                                          res["cpu"])
    assert ka == ca > 0
    assert kpr.num_live == cpr.num_live < kgr.num_live
    for got, ref in ((kgr, cgr), (kpr, cpr)):
        assert torch.equal(got.mask.cpu(), ref.mask)
    for got, ref in ((kg2, cg2),):
        for name in ("coor2occ", "occ_pnts", "occ_numpnts", "occ_bits"):
            assert torch.equal(getattr(got, name).cpu(),
                               getattr(ref, name)), name


# ------------------------------------- learnable blur, native sampler, K-NN

def _learnable_tiny():
    cfg = TC.tiny_test()
    return cfg.replace(
        agg=dataclasses.replace(cfg.agg, learnable_blur_kernel=True,
                                learnable_blur_patch_size=4),
        blur=dataclasses.replace(cfg.blur, learnable=True),
        loss=dataclasses.replace(cfg.loss, use_frame_weight=True))


@pytest.mark.gpu
@pytest.mark.parametrize("cached", [False, True])
def test_learnable_train_step_on_card_matches_cpu(cuda, cached):
    """tiny_test with the learnable blur kernel (9 x 9, mode 4, patches of
    4): one step on the card and on the CPU from one state, uncached or
    cached, with the launches of test_cached_train_step_on_card_matches_cpu
    (a row scan on the cached step only).  Loss items rtol 1e-4 / atol
    1e-6; gradients, the blur MLP's among them, rtol 1e-4 / atol 1e-5 *
    max|g| (the grouped convolution runs without TF32)."""
    cfg = _learnable_tiny()
    counters = {"k_smallest": TS.k_smallest, "segment_sum": TSS.segment_sum,
                "adam_table": TA.adam_table,
                "cumsum_rows": TSCAN.cumsum_rows}
    want = {"k_smallest": 1, "segment_sum": 1 if cached else 2,
            "adam_table": 1, "cumsum_rows": int(cached)}
    res = {}
    for dev in (cuda, torch.device("cpu")):
        points, grid = synthetic.make_synthetic_scene(cfg, 1500, device=dev)
        params = renderer.init_params(cfg, seed=0, device=dev)
        assert "blur_kernel" in params["aggregator"]
        st = tstate.create_train_state(params, points, cfg, device=dev)
        batch = synthetic.make_synthetic_batch(cfg, device=dev)
        noise = torch.rand((cfg.sampling.rays_per_batch,
                            cfg.querier.z_depth_dim),
                           generator=torch.Generator().manual_seed(3)).to(dev)
        staged = None
        if cached:
            views = batch["images_nearest"]
            staged = (views, TPC.PyramidCache(cfg, dtype=torch.float32)
                      .get_stack(st.params, views, range(len(views))))
        before = {k: f.launches for k, f in counters.items()}
        items, g_net, g_table = tstep.loss_and_grads(
            st, grid, batch, None, cfg, noise=noise, img_feat_staged=staged)
        tstep.apply_updates(st, g_net, g_table, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert {k: f.launches - before[k]
                    for k, f in counters.items()} == want
        g_blur = tstate.tree_leaves(g_net["aggregator"]["blur_kernel"])
        assert all(bool(g.any()) for g in g_blur)
        res[dev.type] = (items, g_table, torch.cat([
            x.reshape(-1) for x in tstate.tree_leaves(g_net)]),
            torch.cat([g.reshape(-1) for g in g_blur]))
    (ki, *kg), (ci, *cg) = res["cuda"], res["cpu"]
    for k, v in ci.items():
        torch.testing.assert_close(ki[k].cpu(), v, rtol=1e-4, atol=1e-6)
    for got, ref in zip(kg, cg):
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-4,
                                   atol=float(1e-5 * ref.abs().max()))


@pytest.mark.gpu
def test_native_sampler_builds_and_feeds_the_card(cuda):
    """The native sampler builds on this machine; its pipeline gives
    assemble_batch's batches seed for seed at the training preset's
    sampling, and the batch lands on the card unchanged."""
    import numpy as np

    from hybridneuralrendering_tpu_torch.data import native_sampler as NS
    s = TC.train_config().sampling
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (480, 640, 3)).astype(np.float32)
    intr = np.array([[577.9, 0, 319.5], [0, 577.9, 239.5], [0, 0, 1]],
                    np.float32)
    rot = np.eye(3, dtype=np.float32)
    args = (img, s.edge_filter, s.dilation_patch_num, s.dilation_patch_size,
            s.dilation_min, s.dilation_max, intr, rot)
    with NS.PrefetchPipeline(2) as pipe:
        seeds = {pipe.submit(*args, seed): seed for seed in range(4)}
        popped = [pipe.pop() for _ in seeds]
    for ticket, xy, rgb, dirs in popped:
        wxy, wrgb, wdirs = NS.assemble_batch(*args, seeds[ticket])
        assert np.array_equal(xy, wxy.reshape(-1, 2))
        assert np.array_equal(rgb, wrgb) and np.array_equal(dirs, wdirs)
        flat = xy.astype(int)
        assert np.array_equal(rgb, img[flat[:, 1], flat[:, 0]])
        card = torch.as_tensor(dirs, device=cuda)
        assert torch.equal(card.cpu(), torch.as_tensor(dirs))
        assert torch.allclose(card.norm(dim=-1), torch.ones(
            len(dirs), device=cuda), atol=1e-6)


@pytest.mark.gpu
def test_per_voxel_knn_on_card_equals_cpu_and_supervoxel(cuda):
    """query_points with supervoxel off on tiny_test's scene: the card's
    masks and ids equal the CPU's, one K-min launch at C = 27 * P; and
    equal to the supervoxel path's masks and neighbour sets on a scene
    where no voxel or node overflows."""
    cfg = TC.tiny_test()
    pv = dataclasses.replace(cfg.querier, supervoxel=False)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        points, grid = synthetic.make_synthetic_scene(cfg, 1500, device=dev)
        batch = synthetic.make_synthetic_batch(cfg, device=dev)
        near, far = cfg.render.near_plane, cfg.render.far_plane
        before = TS.k_smallest.launches
        out = tq.query_points(grid, points.xyz, batch["campos"],
                              batch["raydir"], pv, near, far)
        sv = tq.query_points(grid, points.xyz, batch["campos"],
                             batch["raydir"], cfg.querier, near, far)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert TS.k_smallest.launches - before == 2
        res[dev.type] = (out, sv)
    (kout, ksv), (cout, csv) = res["cuda"], res["cpu"]
    for k in ("sample_mask", "ray_mask", "pnt_mask", "sample_pidx"):
        assert torch.equal(getattr(kout, k).cpu(), getattr(cout, k)), k
        if k != "sample_pidx":
            assert torch.equal(getattr(kout, k), getattr(ksv, k)), k
    assert kout.pnt_mask.any()
    assert torch.equal(torch.sort(kout.sample_pidx, dim=-1).values,
                       torch.sort(ksv.sample_pidx, dim=-1).values)


def _nerf_tiny(**agg):
    """tiny_test shaped as fixture_nerf_points (no fusion, no drop, no
    blur, 8 x 8 random rays, the chain in 4 rematerialised chunks), with
    aggregator overrides."""
    c = TC.tiny_test()
    agg = {"use_nearest": 0, "drop_ratio": 0.0, "remat_chain": True,
           "chain_chunks": 4, **agg}
    return c.replace(
        agg=dataclasses.replace(c.agg, **agg),
        sampling=dataclasses.replace(c.sampling, random_sample="random",
                                     random_sample_size=8),
        blur=dataclasses.replace(c.blur, add_blur_sim=False),
        loss=dataclasses.replace(c.loss, use_frame_weight=False))


def _grads_of_step(cfg, dev):
    points, grid = synthetic.make_synthetic_scene(cfg, 1500, device=dev)
    st = tstate.create_train_state(renderer.init_params(cfg, seed=0,
                                                        device=dev),
                                   points, cfg, device=dev)
    batch = synthetic.make_synthetic_batch(cfg, device=dev)
    noise = torch.rand((cfg.sampling.rays_per_batch,
                        cfg.querier.z_depth_dim),
                       generator=torch.Generator().manual_seed(3)).to(dev)
    items, g_net, g_table = tstep.loss_and_grads(st, grid, batch, None, cfg,
                                                 noise=noise)
    return items, g_table, torch.cat([x.reshape(-1)
                                      for x in tstate.tree_leaves(g_net)])


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True])
def test_chunked_chain_step_on_card_matches_cpu(cuda, remat):
    """The NeRF-shaped step with 4 chain chunks, remat on or off: on the
    card the chain launches per chunk (twice forward with remat's
    recompute), the gradients equal the card's remat-off step bit for bit
    and agree with the CPU's (loss items rtol 1e-4 / atol 1e-6, gradients
    rtol 1e-4 / atol 1e-5 * max|g|, float32 chains)."""
    cfg = _nerf_tiny(remat_chain=remat)
    before = dict(TSC.LAUNCHES)
    card = _grads_of_step(cfg, cuda)
    torch.cuda.synchronize()
    assert {k: TSC.LAUNCHES[k] - before[k] for k in before} == {
        "shading_chain_fwd": 8 if remat else 4, "shading_chain_bwd": 4,
        "shading_chain_dw": 4}
    off = _grads_of_step(_nerf_tiny(remat_chain=False), cuda)
    for a, b in zip(card[1:], off[1:]):
        assert torch.equal(a, b)
    cpu = _grads_of_step(cfg, torch.device("cpu"))
    for k, v in cpu[0].items():
        torch.testing.assert_close(card[0][k].cpu(), v, rtol=1e-4, atol=1e-6)
    for got, ref in zip(card[1:], cpu[1:]):
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-4,
                                   atol=float(1e-5 * ref.abs().max()))


@pytest.mark.gpu
def test_compute_dtype_bf16_step_on_card_matches_cpu(cuda):
    """compute_dtype = bfloat16 (shading_dtype float32): the chain takes the
    bf16 kernels and the colour branch rounds its operands; the card's
    network gradient within ops/shading_chain.tolerance's bf16 gradient
    limit (relative L2) of the CPU's, the loss items within 1e-3."""
    cfg = _nerf_tiny(compute_dtype="bfloat16")
    assert TSC.chain_dtype(cfg.agg) == "bfloat16"
    card = _grads_of_step(cfg, cuda)
    cpu = _grads_of_step(cfg, torch.device("cpu"))
    for k, v in cpu[0].items():
        torch.testing.assert_close(card[0][k].cpu(), v, rtol=1e-3, atol=1e-5)
    assert TSC.rel_l2(card[2].cpu(), cpu[2]) < TSC.tolerance("bfloat16",
                                                             "grad")


def _knob_tiny(name):
    """tiny_test with one knob of the aggregator's other model code (32
    point features where the distance kernel consumes channels)."""
    c = TC.tiny_test()
    if name in ("sh_intrp", "gau_intrp"):
        return c.replace(
            points=dataclasses.replace(c.points, feature_dim=32),
            agg=dataclasses.replace(c.agg, agg_distance_kernel=name,
                                    point_features_dim=32))
    return c.replace(agg=dataclasses.replace(
        c.agg, tradition_attention=True,
        use_gumbel_softmax=name == "attention_gumbel"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sh_intrp", "gau_intrp", "attention",
                                  "attention_gumbel"])
def test_knob_step_on_card_matches_cpu(cuda, name):
    """One training step with the SH or Gaussian distance kernel or
    attention fusion: the card's loss items and gradients against the
    CPU's (float32 chains: items rtol 1e-4 / atol 1e-6, gradients rtol
    1e-4 / atol 1e-5 * max|g|); the chain launches once forward and once
    backward."""
    cfg = _knob_tiny(name)
    before = dict(TSC.LAUNCHES)
    card = _grads_of_step(cfg, cuda)
    torch.cuda.synchronize()
    assert {k: TSC.LAUNCHES[k] - before[k] for k in before} == {
        "shading_chain_fwd": 1, "shading_chain_bwd": 1,
        "shading_chain_dw": 1}
    cpu = _grads_of_step(cfg, torch.device("cpu"))
    for k, v in cpu[0].items():
        torch.testing.assert_close(card[0][k].cpu(), v, rtol=1e-4, atol=1e-6)
    for got, ref in zip(card[1:], cpu[1:]):
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-4,
                                   atol=float(1e-5 * ref.abs().max()))


@pytest.mark.gpu
def test_plane_background_on_card_matches_cpu(cuda):
    """The plane background on the card: each view's foreground splat
    against the CPU's (at most 1e-3 of the pixels may differ: points
    within float32 rounding of a pixel's edge), and a request of three
    chunks with its bg_ray equal to the CPU's render within 1e-5 on the
    rays whose bg_ray agrees."""
    from hybridneuralrendering_tpu_torch.core import bg_plane
    cfg = TC.tiny_test()
    cfg = cfg.replace(render=dataclasses.replace(cfg.render,
                                                 bgmodel="img_plane"),
                      sampling=dataclasses.replace(cfg.sampling,
                                                   eval_chunk_rays=64))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        points, grid = synthetic.make_synthetic_scene(cfg, 1500, device=dev)
        params = renderer.init_params(cfg, seed=0, device=dev)
        b = synthetic.make_synthetic_batch(cfg, num_rays=160, device=dev)
        b["images_nearest"] = torch.full_like(b["images_nearest"], 0.5)
        b.update(plane_pnt=torch.tensor([0.0, 0.0, 2.5], device=dev),
                 plane_normal=torch.tensor([0.0, 0.1, 1.0], device=dev),
                 plane_color=torch.tensor([0.5, 0.5, 0.5], device=dev))
        H, W = cfg.image_hw
        fg = bg_plane.fg_pixel_mask(points.xyz, points.mask,
                                    torch.linalg.inv(b["c2w_nearest"][0]),
                                    b["intrinsic_nearest"], H, W)
        req = tstep.maybe_add_bg_ray(b, points, cfg)
        out[dev.type] = (fg.cpu(), req["bg_ray"].cpu(), serve.render_rays(
            params, points, grid, req, cfg)["coarse_raycolor"].cpu())
    (fg_d, bg_d, col_d), (fg_c, bg_c, col_c) = out["cuda"], out["cpu"]
    assert (fg_d != fg_c).float().mean() <= 1e-3
    same = (bg_d - bg_c).abs().max(-1).values <= 1e-5
    assert same.float().mean() > 0.9 and bg_c.any()
    torch.testing.assert_close(col_d[same], col_c[same], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.gpu
def test_compute_dtype_alpha_head_on_card(cuda):
    """compute_dtype = bfloat16 with shading_dtype float32: on the card the
    chain's alpha is the float32 head of chain_fwd's feature (the bf16
    kernels' own alpha dropped)."""
    cfg = TC.tiny_test()
    cfg = cfg.replace(agg=dataclasses.replace(cfg.agg,
                                              compute_dtype="bfloat16"))
    params = renderer.init_params(cfg, seed=0, device=cuda)["aggregator"]
    chain = {k: params[k] for k in ("block1", "block3", "alpha")}
    g = torch.Generator(device=cuda).manual_seed(1)
    emb = torch.randn(4096, 8, generator=g, device=cuda)
    dists = torch.randn(4096, 6, generator=g, device=cuda) * 0.05
    extra = torch.randn(4096, 7, generator=g, device=cuda)
    feat, alpha = TSC.fused_feat_alpha(chain, cfg.agg, emb, dists, extra)
    assert torch.equal(alpha, TSC.alpha_head_f32(feat, chain["alpha"][0]))
    cfeat, calpha = TSC.fused_feat_alpha(
        tstate.tree_map(lambda t: t.cpu(), chain), cfg.agg, emb.cpu(),
        dists.cpu(), extra.cpu())
    assert TSC.rel_l2(feat.cpu(), cfeat) < TSC.tolerance("bfloat16", "feat")
    assert TSC.rel_l2(alpha.cpu(), calpha) < TSC.tolerance("bfloat16",
                                                           "alpha")


@pytest.mark.gpu
def test_frustum_query_on_card_equals_cpu(cuda):
    """ops/query_pers on tiny_test's scene from the requests' camera: the
    frustum grid's tables and the query's ids and masks on the card equal
    the CPU's (perspective coordinates are written-out products, which
    round alike on both); one K-min a query, two row scans a build."""
    from hybridneuralrendering_tpu_torch.ops import query_pers as QP
    cfg = TC.tiny_test()
    qc = dataclasses.replace(cfg.querier, vsize=(0.01, 0.01, 0.05))
    res = {}
    for dev in (cuda, torch.device("cpu")):
        points, _ = synthetic.make_synthetic_scene(cfg, 1500, device=dev)
        b = synthetic.make_synthetic_batch(cfg, num_rays=200, device=dev)
        H, W = cfg.image_hw
        near, far = cfg.render.near_plane, cfg.render.far_plane
        geom = QP.frustum_geometry(synthetic.intrinsic(H, W), H, W, near,
                                   far, qc, device=dev)
        k0, s0 = TS.k_smallest.launches, TSCAN.cumsum_rows.launches
        grid = QP.build_frustum_grid(points.xyz, points.mask,
                                     b["camrotc2w"], b["campos"], geom, qc)
        out = QP.query_points_pers(grid, points.xyz, b["camrotc2w"],
                                   b["campos"], b["raydir"], qc, near, far)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert TS.k_smallest.launches - k0 == 1
            assert TSCAN.cumsum_rows.launches - s0 == 2
        res[dev.type] = (grid, out)
    (kg, ko), (cg, co) = res["cuda"], res["cpu"]
    for k in ("coor2occ", "occ_pnts", "coor2node", "occ_bits", "num_occ"):
        assert torch.equal(getattr(kg, k).cpu(), getattr(cg, k)), k
    for k in ("sample_pidx", "sample_mask", "pnt_mask", "ray_mask"):
        assert torch.equal(getattr(ko, k).cpu(), getattr(co, k)), k
    assert co.pnt_mask.any()
    torch.testing.assert_close(ko.sample_loc_w.cpu(), co.sample_loc_w,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_edit_render_with_rw2c_on_card_matches_cpu(cuda):
    """A merged scene of tiny_test's points, a second copy turned 30
    degrees about z with rw2c = R^T, rendered on the card and on the CPU
    through render_rays: masks equal, colours within 5e-3; the card's
    render without rw2c must differ by more."""
    from hybridneuralrendering_tpu_torch.cli import edit
    cfg = TC.tiny_test()
    a = synthetic.scene_arrays(cfg, 900, seed=0)
    c, s = 0.8660254, 0.5
    R = torch.tensor([[c, -s, 0], [s, c, 0], [0, 0, 1]]).numpy()
    moved = dict(a, xyz=(a["xyz"] @ R.T + [0.3, -0.2, 0.1]).astype(
        "float32"))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        parts = []
        for arrs, rot in ((a, None), (moved, R)):
            p = {k: arrs[k] for k in edit.PART_ATTRS}
            rw = torch.eye(3) if rot is None else torch.as_tensor(rot.T)
            p["rw2c"] = rw.expand(len(p["xyz"]), 3, 3).numpy().astype(
                "float32")
            parts.append(p)
        points = edit.merge_parts(parts, cfg, device=dev)
        grid = TVG.grid_of(points.xyz, points.mask, cfg.querier)
        params = renderer.init_params(cfg, seed=0, device=dev)
        params["aggregator"]["alpha"][-1]["b"] += 4.0
        b = synthetic.make_synthetic_batch(cfg, num_rays=300, device=dev)
        b = {k: v for k, v in b.items() if "nearest" not in k}
        out[dev.type] = serve.render_rays(params, points, grid, b, cfg)
        if dev.type == "cuda":
            fault = serve.render_rays(
                params, dataclasses.replace(points, rw2c=None), grid, b,
                cfg)
    kout, cout = out["cuda"], out["cpu"]
    assert torch.equal(kout["ray_mask"].cpu(), cout["ray_mask"])
    assert cout["ray_mask"].float().mean() > 0.3
    err = (kout["coarse_raycolor"].cpu() - cout["coarse_raycolor"]).abs()
    assert float(err.max()) <= 5e-3
    ferr = (fault["coarse_raycolor"].cpu() - cout["coarse_raycolor"]).abs()
    assert float(ferr.max()) > 5e-3


@pytest.mark.gpu
def test_raft_one_iteration_on_card_matches_cpu(cuda):
    """RAFT with seeded weights at 128x128, iters=1: the card's flow
    (float32 convolutions without TF32) against the CPU's within rtol
    1e-3 / atol 5e-2 (tests/test_torch_port_flow.py's limit against
    JAX)."""
    from hybridneuralrendering_tpu_torch.flow import raft
    g = torch.Generator().manual_seed(3)
    im1, im2 = (torch.rand(128, 128, 3, generator=g) * 255 for _ in range(2))
    flows = {}
    for dev in (cuda, torch.device("cpu")):
        model = raft.init(seed=0, device=dev)
        flows[dev.type] = raft.estimate_flow(model, im1.to(dev),
                                             im2.to(dev), iters=1).cpu()
    assert torch.isfinite(flows["cuda"]).all()
    torch.testing.assert_close(flows["cuda"], flows["cpu"], rtol=1e-3,
                               atol=5e-2)
