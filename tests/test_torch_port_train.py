"""The port's training step and its parts against the JAX package, on the CPU.

Same numpy inputs and weights (through hybridneuralrendering_tpu_torch.io.
from_jax) go to both packages; the JAX Pallas kernels run in interpret mode,
imported from tools/ as tools/test_pallas_*.py do.  Tolerances:

- segment sum: the port's plain version is float64 cumsum differencing,
  exact to float32 rounding; against a float64 oracle rtol 1e-6 / atol 1e-6
  (inputs of order 1).  The JAX XLA twin differences a float32 cumsum and the
  banded kernel splits rows into bf16 hi/lo halves; both carry ~3e-5 of the
  running sum, so they are held at atol 2e-4 (2e-3 for the duplicate-heavy
  case), as tools/test_pallas_gather.py holds the kernel.
- gather backward: against jax.vjp of _gather_rows (cumsum differencing,
  ~3e-5 relative error of the running sum): atol 1e-5 * max|g|, rtol 1e-4.
- Adam: the same float32 formula in another order of evaluation on XLA (and
  b**t from another pow): rtol 2e-6 / atol 2e-7 on the table and moments
  against optax, as tools/test_pallas_adam.py holds the TPU kernel; atol
  1e-6 against the TPU kernel, whose c2*g*g associates the other way.
- blur, losses: float32, rtol 1e-5 / atol 1e-6; the selected kernels and the
  kernel bank exactly.
- whole training step, float32 chains (tiny_test): loss items rtol 1e-4 /
  atol 1e-6; gradients rtol 1e-3 / atol 1e-4 * max|g| of the leaf (XLA
  reorders the matmul, cumsum and K-sum reductions; the errors pass through
  the backward of a few MLP layers).  The state after a step: Adam's first
  step moves each element by about +-lr whatever the gradient's size, so an
  element whose gradient lies within the two packages' rounding noise can
  move the other way.  Parameters are compared only where |g| exceeds
  1e-3 * max|g| of the leaf (rtol 1e-4 / atol 1e-3 * lr; after the second
  step, where both steps' gradients do), and the moments everywhere with
  the gradient tolerance.
- the pyramid map's gradient through the fusion: float32 rtol 1e-5 / atol
  1e-6 * max|g|; a bf16 map within one bf16 rounding (2**-7 relative).
- the segment-sum kernel's order of float32 additions, modelled here in
  float32 torch ops (_segment_sum_order_model): within
  ops/segment_sum.tolerance of the float64 plain version on normal,
  cancelling and long segments, and equal to it on integer rows.
"""

import copy
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hybridneuralrendering_tpu.data import synthetic as jsyn
from hybridneuralrendering_tpu.models import aggregator as jagg
from hybridneuralrendering_tpu.models import blur as jblur
from hybridneuralrendering_tpu.models import fusion as jfusion
from hybridneuralrendering_tpu.models import losses as jlosses
from hybridneuralrendering_tpu.models import neural_points as jnpts
from hybridneuralrendering_tpu.train import state as jstate_mod
from hybridneuralrendering_tpu.train import step as jstep
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch.data import synthetic as tsyn
from hybridneuralrendering_tpu_torch.io import from_jax
from hybridneuralrendering_tpu_torch.models import aggregator as tagg
from hybridneuralrendering_tpu_torch.models import blur as tblur
from hybridneuralrendering_tpu_torch.models import fusion as tfusion
from hybridneuralrendering_tpu_torch.models import losses as tlosses
from hybridneuralrendering_tpu_torch.models import neural_points as tnpts
from hybridneuralrendering_tpu_torch.models import renderer as trenderer
from hybridneuralrendering_tpu_torch.ops import adam as tadam
from hybridneuralrendering_tpu_torch.ops import build as tbuild
from hybridneuralrendering_tpu_torch.ops import scan as tscan
from hybridneuralrendering_tpu_torch.ops import segment_sum as tseg
from hybridneuralrendering_tpu_torch.train import state as tstate
from hybridneuralrendering_tpu_torch.train import step as tstep
from torch_port_common import configs, make_params, make_scene, n, t

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)
import pallas_adam as PA     # noqa: E402
import pallas_gather as PG   # noqa: E402

ALPHA_BIAS = 4.0


# ---------------------------------------------------------------- segment sum

def _segment_case(rng, M, N, C, ids=None):
    """Sorted ids, rows and inclusive segment ends, as _gather_rows_bwd
    builds them."""
    if ids is None:
        ids = rng.integers(0, N, M)
    si = np.sort(ids).astype(np.int32)
    sg = rng.normal(size=(M, C)).astype(np.float32)
    end_pos = np.full(N, -1, np.int64)
    for j, p in enumerate(si):
        end_pos[p] = j
    end_pos = np.maximum.accumulate(end_pos).astype(np.int32)
    return si, sg, end_pos


def _oracle(si, sg, N):
    out = np.zeros((N, sg.shape[1]), np.float64)
    np.add.at(out, si, sg.astype(np.float64))
    return out


SEGMENT_CASES = {
    # name: (M, N, C, ids)
    "uniform": (3000, 2000, 64, None),
    "mostly_empty_ids": (512, 4096, 64, None),
    "one_id_only": (700, 1000, 64, np.full(700, 417)),
    "n_not_multiple_of_512": (4096, 1537, 64, "skew"),
    "last_id_only": (300, 777, 64, np.full(300, 776)),
}


def _segment_inputs(name):
    M, N, C, ids = SEGMENT_CASES[name]
    rng = np.random.default_rng(sorted(SEGMENT_CASES).index(name))
    if isinstance(ids, str):    # duplicate-heavy: few ids, long segments
        ids = rng.choice(np.arange(0, N, 97), size=M)
    return (N,) + _segment_case(rng, M, N, C, ids)


@pytest.mark.parametrize("name", sorted(SEGMENT_CASES))
def test_segment_sum_plain_matches_oracle_and_pallas(name):
    N, si, sg, end_pos = _segment_inputs(name)
    got = n(tseg.segment_sum(t(sg), t(end_pos), N))
    np.testing.assert_allclose(got, _oracle(si, sg, N), rtol=1e-6,
                               atol=1e-6)
    pallas = np.asarray(PG.banded_segment_sum(
        jnp.asarray(sg), jnp.asarray(end_pos), N, interpret=True))
    xla = np.asarray(PG.banded_segment_sum_xla(
        jnp.asarray(sg), jnp.asarray(end_pos), N))
    atol = 2e-3 if name == "n_not_multiple_of_512" else 2e-4
    np.testing.assert_allclose(got, pallas, atol=atol)
    np.testing.assert_allclose(got, xla, atol=atol)
    absent = np.setdiff1d(np.arange(N), si)
    assert not got[absent].any()


def test_segment_sum_no_rows():
    end_pos = torch.full((10,), -1, dtype=torch.int32)
    got = tseg.segment_sum(torch.zeros((0, 64)), end_pos, 10)
    assert got.shape == (10, 64) and not got.any()


def _segment_sum_order_model(sg, end_pos, n):
    """csrc/segment_sum.cu's order of float32 additions, in float32 torch
    ops: a segment is cut at multiples of ROWS rows (the row tiles); the
    rows of a piece go to PARTIALS running sums by row index mod 4 (a
    tile-relative slot, so a piece laid into a zero-padded [ROWS, C] tile
    sums the same), added as (s0 + s1) + (s2 + s3); a segment of more than
    one piece sums its pieces in FIXUP_WARPS running sums by piece index
    mod 8, added as a tree of three levels."""
    R, C = tseg.ROWS, sg.shape[1]
    out = torch.zeros((n, C), dtype=torch.float32)
    lo = 0
    for p, e in enumerate(end_pos.tolist()):
        hi = e + 1
        if hi <= lo:
            continue
        first = lo // R
        tiles = torch.zeros(((hi - 1) // R - first + 1) * R, C)
        tiles[lo - first * R:hi - first * R] = sg[lo:hi]
        tiles = tiles.reshape(-1, R, C)
        acc = [torch.zeros(tiles.shape[0], C) for _ in range(tseg.PARTIALS)]
        # the zero padding adds nothing: a one-piece segment walks its rows
        slots = (range(R) if tiles.shape[0] > 1
                 else range(lo - first * R, hi - first * R))
        for i in slots:
            acc[i % 4] = acc[i % 4] + tiles[:, i]
        pieces = (acc[0] + acc[1]) + (acc[2] + acc[3])
        if pieces.shape[0] == 1:
            out[p] = pieces[0]
        else:
            w = [torch.zeros(C) for _ in range(tseg.FIXUP_WARPS)]
            for j in range(pieces.shape[0]):
                w[j % 8] = w[j % 8] + pieces[j]
            out[p] = (((w[0] + w[1]) + (w[2] + w[3]))
                      + ((w[4] + w[5]) + (w[6] + w[7])))
        lo = hi
    return out


def _order_case(kind, rng):
    """(ids [M], rows [M, C], n) for the order model's checks."""
    if kind == "normal":
        ids = rng.integers(0, 900, 6000)
        return ids, rng.normal(size=(6000, 45)), 1000
    if kind == "cancelling":
        # +-1e4 in turn with noise of order 1: the sums are small, the
        # partial sums large
        M = 5000
        ids = np.sort(rng.integers(0, 40, M))
        big = np.where(np.arange(M) % 2 == 0, 1e4, -1e4)[:, None]
        return ids, big + rng.normal(size=(M, 8)), 40
    if kind == "one_segment_40k":
        return (np.full(40_000, 3), rng.normal(size=(40_000, 4)) * 10.0 ** (
            rng.integers(-3, 4, (40_000, 4))), 7)
    # segments of 128 rows and of 64: every end on or next to a tile edge
    ids = np.repeat(np.arange(20), [128, 64] * 10)
    return ids, rng.normal(size=(ids.shape[0], 64)), 20


@pytest.mark.parametrize("kind", ["normal", "cancelling", "one_segment_40k",
                                  "tile_edges"])
def test_segment_sum_order_model_within_tolerance(kind):
    """The kernel's float32 order, modelled on the CPU, within the restated
    ops/segment_sum.tolerance of the float64 plain version; on integer
    rows (every partial sum exact) the model equals the plain version."""
    rng = np.random.default_rng(11)
    ids, rows, N = _order_case(kind, rng)
    M, C = rows.shape
    _, _, end_pos = _segment_case(rng, M, N, C, ids)
    sg, ep = t(rows.astype(np.float32)), t(end_pos)
    err = (_segment_sum_order_model(sg, ep, N).double()
           - tseg.segment_sum_plain(sg, ep, N).double()).abs()
    tol = tseg.tolerance(sg, ep, N)
    assert (err <= tol).all(), float((err / tol.clamp(min=1e-30)).max())
    q = t(rng.integers(-8, 9, (M, C)).astype(np.float32))
    assert torch.equal(_segment_sum_order_model(q, ep, N),
                       tseg.segment_sum_plain(q, ep, N))


def test_segment_ends_match_jax_construction():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 300, 1000)
    si, _, end_pos = _segment_case(rng, 1000, 300, 1, ids)
    got = tnpts.segment_ends(torch.as_tensor(si), 300)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(n(got), end_pos)


@pytest.mark.parametrize("kind", ["entry_point", "segment_sum", "adam_table",
                                  "cumsum_rows"])
def test_kernel_wrappers_never_fall_back(kind):
    """Only a CPU tensor takes the plain version: any other device raises,
    and asking for the card on a machine without one raises too."""
    meta = torch.empty((8, 64), device="meta")
    if kind == "segment_sum":
        with pytest.raises(ValueError):
            tseg.segment_sum(meta, torch.empty(8, dtype=torch.int32,
                                               device="meta"), 8)
    elif kind == "cumsum_rows":
        for dtype in (torch.float32, torch.int32):
            with pytest.raises(ValueError):
                tscan.cumsum_rows(torch.empty((8, 64), dtype=dtype,
                                              device="meta"))
    elif kind == "adam_table":
        s = tadam.AdamScalars(0.9, 0.999, 0.1, 0.001, 0.1, 0.001, -1e-3,
                              1e-8)
        with pytest.raises(ValueError):
            tadam.adam_table(meta, meta, meta, meta, s)
    else:
        if torch.cuda.is_available():
            pytest.skip("this machine has a card")
        jc, tc = configs()
        params = trenderer.init_params(tc, device="cpu")
        pts = tnpts.init_from_arrays(np.zeros((4, 3)), tc.points,
                                     device="cpu")
        with pytest.raises(RuntimeError):
            tstate.create_train_state(params, pts, tc, device="cuda")


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(tbuild.shutil, "which", lambda name: None)
    monkeypatch.setattr(tbuild.os.path, "exists", lambda path: False)
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tbuild, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        tseg._kernel()


# ------------------------------------------------------------ gather backward

@pytest.mark.parametrize("trainable", [(False, True, True, True, True),
                                       (True, True, False, True, True)])
def test_gather_rows_gradient_matches_jax_vjp(trainable):
    jc, tc = configs()
    rng = np.random.default_rng(7)
    N, F = 500, tc.points.feature_dim
    W = tnpts.table_width(F)
    table = rng.normal(size=(N, W)).astype(np.float32)
    table[:, sum(tnpts.attr_widths(F)):] = 0.0
    # duplicate-heavy ids with -1 slots, like a query's [R, SR, K]
    pidx = rng.integers(-1, 60, (16, 6, 4)).astype(np.int32)
    parts_ct = [rng.normal(size=pidx.shape + ((w,) if i != 2 else ()))
                .astype(np.float32)
                for i, w in enumerate(tnpts.attr_widths(F))]

    jpts = jnpts.NeuralPoints(
        table=jnp.asarray(table), mask=jnp.ones(N, bool), num_live=N,
        feature_dim=F, trainable=trainable)

    def jfn(tab):
        s = jnpts.gather(dataclasses.replace(jpts, table=tab),
                         jnp.asarray(pidx))
        return sum(jnp.sum(x * c) for x, c in zip(
            (s.xyz, s.embedding, s.conf, s.color, s.dirs), parts_ct))

    ref = np.asarray(jax.grad(jfn)(jnp.asarray(table)))

    tpts = from_jax.points_from_numpy(table, np.ones(N, bool), F,
                                      trainable=trainable, device="cpu")
    leaf = tpts.table.clone().requires_grad_(True)
    s = tnpts.gather(dataclasses.replace(tpts, table=leaf),
                     torch.as_tensor(pidx))
    loss = sum(torch.sum(x * t(c)) for x, c in zip(
        (s.xyz, s.embedding, s.conf, s.color, s.dirs), parts_ct))
    loss.backward()
    got = n(leaf.grad)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())
    # frozen lanes and the zero pad get exact zeros
    o = 0
    for w, tr in zip(tnpts.attr_widths(F), trainable):
        if not tr:
            assert not got[:, o:o + w].any()
        o += w
    assert not got[:, o:].any()


def test_gather_rows_backward_uses_no_scatter_add(monkeypatch):
    """The gather's backward reduces through segment_sum, never through
    index_add_ / scatter_add_."""
    def refuse(*a, **k):
        raise AssertionError("scatter-add called")
    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    monkeypatch.setattr(torch.Tensor, "scatter_add_", refuse)
    calls = []
    real = tnpts.segment_sum
    monkeypatch.setattr(tnpts, "segment_sum",
                        lambda *a: calls.append(1) or real(*a))
    table = torch.randn(50, 64, requires_grad=True)
    idx = torch.randint(0, 50, (7, 3))
    tnpts.gather_rows(table, idx).sum().backward()
    assert calls == [1]
    np.testing.assert_allclose(
        n(table.grad[:, 0]), np.bincount(n(idx).ravel(), minlength=50))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_image_fusion_map_gradient_matches_jax(monkeypatch, dtype):
    """The pyramid map's gradient goes through gather_rows (one segment
    sum; off-image samples included) and equals JAX's, which sums in
    float32 and rounds once: float32 rtol 1e-5 / atol 1e-6 * max|g|; a
    bf16 map within one bf16 rounding (2**-7 relative) of JAX's."""
    jc, tc = configs()
    jp, tp = make_params(jc)
    rng = np.random.default_rng(13)
    V, H, W, R, SR = 2, 5, 6, 12, 4
    C = tc.agg.aux_feature_channels
    fmap = rng.normal(size=(V, H, W, C)).astype(np.float32)
    fmap = np.asarray(jnp.asarray(fmap, dtype).astype(jnp.float32))
    loc = np.stack([rng.uniform(-3, W + 3, (V, R, SR)),
                    rng.uniform(-3, H + 3, (V, R, SR))], -1).astype(
                        np.float32)
    cf = rng.normal(size=(R, SR, tc.agg.shading_feature_num // 2)).astype(
        np.float32)
    dv = rng.normal(size=(V, R, SR, 3)).astype(np.float32)
    fw = rng.random(V).astype(np.float32)
    ct = rng.normal(size=(R, SR, C)).astype(np.float32)

    def jfn(m):
        out = jfusion.image_fusion(
            jp["aggregator"], jc.agg, jnp.asarray(cf), m, None,
            jnp.asarray(loc), jnp.asarray(dv), jnp.asarray(fw), None, None,
            train=True)
        return jnp.sum(out * ct)

    ref = np.asarray(jax.grad(jfn)(jnp.asarray(fmap, dtype)).astype(
        jnp.float32))

    calls = []
    real = tnpts.segment_sum
    monkeypatch.setattr(tnpts, "segment_sum",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    m = t(fmap).to(getattr(torch, dtype)).requires_grad_(True)
    out = tfusion.image_fusion(tp["aggregator"], tc.agg, t(cf), m, t(loc),
                               t(dv), t(fw))
    torch.sum(out * t(ct)).backward()
    got = n(m.grad.float())
    assert m.grad.dtype == m.dtype
    assert calls == [(V * R * SR, C)]
    assert np.abs(ref).max() > 0
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=1e-30)


# ----------------------------------------------------------------------- Adam

def test_adam_table_matches_pallas_and_optax_over_three_steps():
    o = TC.tiny_test().optim
    jo = jax_optim()
    N, F = 2048, 64
    rng = np.random.default_rng(11)
    p0 = rng.normal(size=(N, F)).astype(np.float32)
    sched_t = tstate.lr_schedule(o.plr, o)
    sched_j = jstate_mod.lr_schedule(jo.plr, jo)
    opt = optax.adam(sched_j, b1=jo.beta1, b2=jo.beta2)
    ref_p = {"table": jnp.asarray(p0)}
    ref_st = opt.init(ref_p)
    kp, kmu, knu = (jnp.asarray(p0), jnp.zeros((N, F)), jnp.zeros((N, F)))
    tp, tmu, tnu = t(p0), torch.zeros(N, F), torch.zeros(N, F)
    for step in range(3):
        g = rng.normal(size=(N, F)).astype(np.float32)
        g[0] = 0.0                            # a row with no gradient
        up, ref_st = opt.update({"table": jnp.asarray(g)}, ref_st, ref_p)
        ref_p = optax.apply_updates(ref_p, up)
        scal = PA.adam_scalars(jnp.int32(step), jnp.int32(step), sched_j,
                               jo.beta1, jo.beta2)
        kp, kmu, knu = PA.adam_table_update(kp, jnp.asarray(g), kmu, knu,
                                            scal, interpret=True)
        s = tadam.adam_scalars(step, step, sched_t, o.beta1, o.beta2)
        np.testing.assert_allclose(np.asarray(s, np.float32),
                                   np.asarray(scal), rtol=2e-7)
        tadam.adam_table(tp, t(g), tmu, tnu, s)
        for got, want in ((tp, ref_p["table"]), (tmu, ref_st[0].mu["table"]),
                          (tnu, ref_st[0].nu["table"]), (tmu, kmu)):
            np.testing.assert_allclose(n(got), np.asarray(want), rtol=2e-6,
                                       atol=2e-7)
        # the TPU kernel forms (c2*g)*g where optax and the port form
        # c2*(g*g): one rounding apart in nu, up to 6e-7 in p after 3 steps
        for got, want in ((tp, kp), (tnu, knu)):
            np.testing.assert_allclose(n(got), np.asarray(want), rtol=2e-6,
                                       atol=1e-6)
    assert (n(tp)[0] == p0[0]).all()


def jax_optim():
    from hybridneuralrendering_tpu import config as JC
    return JC.tiny_test().optim


@pytest.mark.parametrize("step", [0, 1, 999, 123_456])
def test_lr_schedule_matches_jax(step):
    o = TC.tiny_test().optim
    got = float(tstate.lr_schedule(o.lr, o)(step))
    want = float(jstate_mod.lr_schedule(o.lr, jax_optim())(jnp.int32(step)))
    assert got == pytest.approx(want, rel=2e-7)


# ------------------------------------------------------------- blur and losses

@pytest.mark.parametrize("preset", ["scannet_full", "tiny_test"])
def test_kernel_bank_equals_jax(preset):
    from hybridneuralrendering_tpu import config as JC
    np.testing.assert_array_equal(
        tblur.generate_kernel_bank(getattr(TC, preset)().blur),
        jblur.generate_kernel_bank(getattr(JC, preset)().blur))


def test_blur_bank_update_matches_jax():
    jc, tc = configs()
    pn, ps = tc.sampling.dilation_patch_num, tc.sampling.dilation_patch_size
    R = (pn * ps) ** 2
    rng = np.random.default_rng(13)
    rendered = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    # the patch that matches its blurred self best picks a bank kernel
    bank = tblur.generate_kernel_bank(tc.blur)
    ct = rng.normal(size=(R, 3)).astype(np.float32)

    jf = lambda r: jnp.sum(jblur.blur_bank_update(    # noqa: E731
        r, jnp.asarray(gt), jnp.asarray(bank), pn, ps) * ct)
    jval, jgrad = jax.value_and_grad(jf)(jnp.asarray(rendered))
    jout = jblur.blur_bank_update(jnp.asarray(rendered), jnp.asarray(gt),
                                  jnp.asarray(bank), pn, ps)

    r = t(rendered).requires_grad_(True)
    out = tblur.blur_bank_update(r, t(gt), t(bank), pn, ps)
    (out * t(ct)).sum().backward()
    np.testing.assert_allclose(n(out), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(n(r.grad), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-6)
    # the same candidate per patch: identity patches are unchanged in both
    same = np.all(np.isclose(n(out), rendered), axis=-1)
    np.testing.assert_array_equal(
        same, np.all(np.isclose(np.asarray(jout), rendered), axis=-1))


def test_blur_selects_the_generating_kernel():
    """A patch blurred by bank kernel j and given as ground truth selects
    kernel j (argmin ties to the first candidate)."""
    _, tc = configs()
    pn, ps = tc.sampling.dilation_patch_num, tc.sampling.dilation_patch_size
    bank = t(tblur.generate_kernel_bank(tc.blur))
    rng = np.random.default_rng(17)
    x = t(rng.uniform(0, 1, ((pn * ps) ** 2, 3)).astype(np.float32))
    xp = tblur.to_patches(x, pn, ps).permute(0, 3, 1, 2).reshape(-1, ps, ps,
                                                                1)
    blurred = tblur._conv_same(xp, bank) / tblur._conv_same(
        torch.ones_like(xp), bank)
    P = pn * pn
    pick = [3, 0, 11, 7][:P]
    gt_p = torch.stack([blurred.reshape(P, 3, ps, ps, -1)[i, ..., j]
                        for i, j in enumerate(pick)])
    gt = tblur.from_patches(gt_p.permute(0, 2, 3, 1), pn, ps)
    out = tblur.blur_bank_update(x, gt, bank, pn, ps)
    np.testing.assert_allclose(n(out), n(gt), rtol=0, atol=0)


def test_compute_losses_match_jax():
    jc, tc = configs()
    lc = dataclasses.replace(tc.loss, sparse_loss_weight=0.3,
                             color_loss_weights=(1.0, 0.5, 0.25))
    rng = np.random.default_rng(19)
    R, SR, K = 64, 6, 4
    out_np = {
        "coarse_raycolor": rng.uniform(0, 1, (R, 3)).astype(np.float32),
        "ray_mask": rng.uniform(size=R) < 0.7,
        "conf_coefficient": rng.uniform(0, 1.2, (R, SR, K)).astype(
            np.float32),
        "weight": rng.uniform(0, 1, (R, SR, K)).astype(np.float32),
    }
    gt = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    fw = np.float32(0.7)
    diff_keys = ("coarse_raycolor", "conf_coefficient")

    def jf(*xs):
        o = dict(out_np, **{k: x for k, x in zip(diff_keys, xs)})
        o = {k: jnp.asarray(v) for k, v in o.items()}
        return jlosses.compute_losses(o, jnp.asarray(gt), lc,
                                      jnp.asarray(fw))

    (jtot, jitems), jg = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(
        *[jnp.asarray(out_np[k]) for k in diff_keys])
    xs = [t(out_np[k]).requires_grad_(True) for k in diff_keys]
    o = {k: t(v) for k, v in out_np.items()}
    o.update(zip(diff_keys, xs))
    tot, items = tlosses.compute_losses(o, t(gt), lc, t(fw))
    tot.backward()
    assert set(items) == set(jitems)
    for k in items:
        np.testing.assert_allclose(n(items[k]), np.asarray(jitems[k]),
                                   rtol=1e-5, atol=1e-6)
    for x, g in zip(xs, jg):
        np.testing.assert_allclose(n(x.grad), np.asarray(g), rtol=1e-5,
                                   atol=1e-6)
    mse = torch.tensor([0.01, 0.0])
    np.testing.assert_allclose(n(tlosses.psnr(mse)),
                               np.asarray(jlosses.psnr(jnp.asarray(n(mse)))))


# ------------------------------------------------------ model code in training

def test_drop_ray_mask_matches_jax():
    jc, tc = configs()
    for R, pn, ps in ((64, 2, 4), (3136, 7, 8), (100, 2, 4)):
        for ratio in (0.0, 0.5, 0.3):
            ja = dataclasses.replace(jc.agg, drop_ratio=ratio)
            ta = dataclasses.replace(tc.agg, drop_ratio=ratio)
            np.testing.assert_array_equal(
                tagg.drop_ray_mask(ta, R, pn, ps),
                jagg.drop_ray_mask(ja, R, pn, ps))


@pytest.mark.parametrize("knob", [{"act_type": "relu"}])
def test_unported_training_knobs_raise(knob):
    """A chain the fused kernels do not take raises in training (the
    chain's remat, chunk and fused-VJP knobs run:
    tests/test_torch_port_chain_knobs.py; the distance kernels and
    attention: test_training_knobs_match_jax)."""
    jc, tc = configs(**knob)
    tp = trenderer.init_params(configs()[1], device="cpu")
    kw = {k: torch.zeros(1) for k in (
        "sampled_xyz", "sampled_xyz_pers", "sampled_embedding",
        "sampled_color", "sampled_dir", "sampled_conf", "pnt_mask",
        "sample_loc", "sample_loc_w", "sample_ray_dirs")}
    with pytest.raises(NotImplementedError):
        tagg.apply(tp["aggregator"], tc.agg, vsize=(0.1,) * 3, train=True,
                   **kw)


@pytest.mark.parametrize("knob", [
    {"agg_distance_kernel": "sh_intrp", "point_features_dim": 32},
    {"tradition_attention": True}], ids=["sh_intrp", "tradition_attention"])
def test_training_knobs_match_jax(knob):
    """The call the port refused before it ported ROADMAP Queue 1 item 10:
    aggregator.apply in training with the SH distance kernel or attention
    fusion, its features against JAX's (float32 rtol 1e-4 / atol 1e-5).
    Every gradient: tests/test_torch_port_knobs.py."""
    from test_torch_port_render import F32, _agg_inputs
    jc, tc = configs(**knob)
    if "point_features_dim" in knob:
        jc, tc = (c.replace(points=dataclasses.replace(c.points,
                                                       feature_dim=32))
                  for c in (jc, tc))
    jp, tp = make_params(jc, alpha_bias=ALPHA_BIAS)
    a = _agg_inputs(tc)
    a["drop_mask"] = np.arange(12) % 3 == 0
    vs = tc.querier.query_vsize
    want = jagg.apply(jp["aggregator"], jc.agg, vsize=vs, train=True,
                      **{k: jnp.asarray(v) for k, v in a.items()})
    got = tagg.apply(tp["aggregator"], tc.agg, vsize=vs, train=True,
                     **{k: t(v) for k, v in a.items()})
    np.testing.assert_allclose(n(got.features), np.asarray(want.features),
                               **F32)


def test_synthetic_batch_has_frame_weight():
    """The port's batch carries the JAX batch's scalar frame_weight."""
    jc, tc = configs()
    b = tsyn.batch_arrays(tc)
    jb = jsyn.make_synthetic_batch(jc)
    assert np.asarray(b["frame_weight"]).shape == ()
    assert float(b["frame_weight"]) == float(jb["frame_weight"]) == 1.0
    assert torch.is_tensor(tsyn.make_synthetic_batch(
        tc, device="cpu")["frame_weight"])


def test_render_detaches_weight_and_blend_weight():
    """No gradient flows through 'weight' and 'blend_weight', as in JAX."""
    jc, tc = configs()
    (_, _), (tpts, tgrid) = make_scene(jc, tc)
    _, tp = make_params(jc, alpha_bias=ALPHA_BIAS)
    tp = tstate.tree_map(lambda x: x.requires_grad_(True), tp)
    b = {k: t(v) for k, v in tsyn.batch_arrays(tc, num_rays=32).items()}
    out = trenderer.render(tp, tpts, tgrid, b, tc)
    assert out["coarse_raycolor"].requires_grad
    assert not out["weight"].requires_grad
    assert not out["blend_weight"].requires_grad


# --------------------------------------------------------- whole training step

def _train_setup():
    jc, tc = configs()
    loss = dict(use_frame_weight=True)
    jc = jc.replace(loss=dataclasses.replace(jc.loss, **loss))
    tc = tc.replace(loss=dataclasses.replace(tc.loss, **loss))
    (jpts, jgrid), (tpts, tgrid) = make_scene(jc, tc)
    jp, _ = make_params(jc, alpha_bias=ALPHA_BIAS)
    arrays = tsyn.batch_arrays(tc, seed=1)
    arrays["frame_weight"] = np.float32(0.8)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: t(v) for k, v in arrays.items()}
    bank = jblur.generate_kernel_bank(jc.blur)
    jst = jstate_mod.create_train_state(jp, jpts, jc)
    return jc, tc, jst, jgrid, jb, tgrid, tb, bank


def _port_state(jst, tc):
    net, pts = jst.opt_state_net[0], jst.opt_state_pts[0]
    np_tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    return from_jax.train_state_from_numpy(
        np_tree(jst.params), np.asarray(jst.points.table),
        np.asarray(jst.points.mask), int(jst.step),
        (np_tree(net.mu), np_tree(net.nu), int(net.count)),
        (np.asarray(pts.mu["table"]), np.asarray(pts.nu["table"]),
         int(pts.count)),
        tc.points.feature_dim, trainable=jst.points.trainable, device="cpu")


def _noise(key, tc):
    R = tc.sampling.rays_per_batch
    return np.asarray(jax.random.uniform(key, (R, tc.querier.z_depth_dim)))


_jax_value_and_grad = jax.jit(
    jax.value_and_grad(jstep.loss_fn, argnums=(0, 1), has_aux=True),
    static_argnames=("cfg",))


def _jax_grads(jst, jgrid, jb, jc, key, bank):
    pts_tree = jstate_mod.point_param_tree(jst.points, jc)
    (_, items), (g_net, g_pts) = _jax_value_and_grad(
        jst.params, pts_tree, jst.points, jgrid, jb, cfg=jc, key=key,
        blur_kernels=jnp.asarray(bank))
    return items, g_net, g_pts["table"]


def _close_grad(got, want):
    got, want = n(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-4 * max(np.abs(want).max(), 1e-30))


def _close_update(p_got, p_want, p_before, g, lr):
    """Parameters after an Adam step where |g| clears the noise (module
    docstring)."""
    p_got, p_want, g = n(p_got), np.asarray(p_want), np.asarray(g)
    sel = np.abs(g) > 1e-3 * np.abs(g).max()
    np.testing.assert_allclose(p_got[sel], p_want[sel], rtol=1e-4,
                               atol=1e-3 * lr)
    # elsewhere each element moved by at most one learning rate
    assert (np.abs(p_got - np.asarray(p_before)) <= lr * (1 + 1e-5)
            + 1e-6 * np.abs(p_got)).all()


@pytest.fixture(scope="module")
def two_steps():
    """Both packages from one state through two steps; the gradients of
    each step and the state after each."""
    jc, tc, jst, jgrid, jb, tgrid, tb, bank = _train_setup()
    tst = _port_state(jst, tc)
    tbank = t(bank)
    keys = [jax.random.PRNGKey(21), jax.random.PRNGKey(22)]
    steps = []
    for key in keys:
        before = _port_state(jst, tc)
        jitems, jg_net, jg_table = _jax_grads(jst, jgrid, jb, jc, key, bank)
        noise = t(_noise(key, tc))
        titems, tg_net, tg_table = tstep.loss_and_grads(
            tst, tgrid, tb, tbank, tc, noise=noise)
        jst, _ = jstep.train_step(jst, jgrid, jb, key, jnp.asarray(bank), jc)
        tst, items2 = tstep.train_step(tst, tgrid, tb, tbank, tc,
                                       noise=noise)
        steps.append(dict(before=before, jitems=jitems, titems=titems,
                          items2=items2, jg_net=jg_net, tg_net=tg_net,
                          jg_table=jg_table, tg_table=tg_table,
                          jst=_port_state(jst, tc), tst=copy.deepcopy(tst)))
    return tc, steps


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_loss_items(two_steps, step):
    tc, steps = two_steps
    s = steps[step]
    assert set(s["titems"]) == set(s["jitems"]) == set(s["items2"])
    for k, v in s["jitems"].items():
        np.testing.assert_allclose(n(s["titems"][k]), np.asarray(v),
                                   rtol=1e-4, atol=1e-6)
        assert float(s["items2"][k]) == float(s["titems"][k])
    assert 0.2 < float(s["titems"]["ray_hit_frac"]) <= 1.0


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_network_gradients(two_steps, step):
    tc, steps = two_steps
    s = steps[step]
    jl = jax.tree_util.tree_leaves(s["jg_net"])
    tl = tstate.tree_leaves(s["tg_net"])
    assert len(jl) == len(tl) > 20
    for got, want in zip(tl, jl):
        assert tuple(got.shape) == tuple(want.shape)
        _close_grad(got, want)
    assert sum(float(np.abs(np.asarray(w)).max()) > 0 for w in jl) > 20


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_table_gradient(two_steps, step):
    tc, steps = two_steps
    s = steps[step]
    _close_grad(s["tg_table"], s["jg_table"])
    g = n(s["tg_table"])
    assert not g[:, :3].any()                 # xyz_grad=False
    assert np.abs(g[:, 3:]).max() > 0


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_state_after(two_steps, step):
    tc, steps = two_steps
    s = steps[step]
    got, want, before = s["tst"], s["jst"], s["before"]
    assert got.step == want.step == step + 1
    assert got.opt_net.count == want.opt_net.count == step + 1
    assert got.opt_pts.count == want.opt_pts.count == step + 1
    o = tc.optim
    if step == 0:
        # the moments after one step are the gradient's, exactly scaled
        _close_grad(got.opt_pts.mu, want.opt_pts.mu)
        _close_update(got.points.table, n(want.points.table),
                      n(before.points.table), n(s["jg_table"]), o.plr)
        for gp, wp, bp, g in zip(
                tstate.tree_leaves(got.params),
                tstate.tree_leaves(want.params),
                tstate.tree_leaves(before.params),
                jax.tree_util.tree_leaves(s["jg_net"])):
            _close_update(gp, n(wp), n(bp), g, o.lr)
    else:
        # after two steps the moments carry both steps' gradients; the
        # table agrees where both steps' gradients clear the noise
        _close_grad(got.opt_pts.mu, want.opt_pts.mu)
        _close_grad(got.opt_pts.nu, want.opt_pts.nu)
        g0, g1 = n(steps[0]["jg_table"]), n(s["jg_table"])
        sel = ((np.abs(g0) > 1e-3 * np.abs(g0).max())
               & (np.abs(g1) > 1e-3 * np.abs(g1).max()))
        assert sel.sum() > 100
        np.testing.assert_allclose(n(got.points.table)[sel],
                                   n(want.points.table)[sel], rtol=1e-4,
                                   atol=1e-3 * o.plr)
    assert (n(got.points.table)[:, :3] == n(before.points.table)[:, :3]).all()
