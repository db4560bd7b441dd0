"""The port's pyramid-cached training step and its parts against the JAX
package, on the CPU.

Same numpy inputs and weights (through hybridneuralrendering_tpu_torch.io.
from_jax) go to both packages; tools/pallas_scan.py runs in interpret mode,
imported from tools/ as tools/test_pallas_scan.py does.  Tolerances:

- cumsum_rows_plain (float64 sums rounded once) against the Pallas scan
  (block matmuls plus a float32 carry): |diff| <= 1e-5 * cumsum(|x|) per
  element, a bound on the sum, since random prefix sums pass near zero;
  int32 against np.cumsum exactly.
- the row-scan kernel's float32 order for F == 1, modelled here in float32
  torch ops (_scan_order_model): within ops/scan.tolerance of the float64
  plain version on normal, cancelling and long inputs, and equal to it on
  integer-valued ones.
- the dedup gather copies rows: its forward equals JAX's and table[idx]
  bit for bit; its table gradient is the gather backward's, held to
  jax.grad at the training step's gradient tolerance (_close_grad).
- materialize / gather_staged / the stage-map cache: float32 within
  REORDERED (the limit of test_torch_port_core.py::test_feature_pyramid);
  bfloat16 within one bf16 rounding of the larger value (2**-7 relative).
  materialize's bf16 upsampling is the exception: JAX's bf16 resize rounds
  its width pass to bf16 before the height pass, where torch rounds once,
  so the values there may differ by three roundings of at most 2**-8 of the
  summands' magnitude (the upsampled |stage map|), not of the result.
- image_fusion with cached maps: float32 rtol 1e-5 / atol 1e-6.
- the whole cached step: the tolerances of test_torch_port_train.py's
  two_steps tests (loss items rtol 1e-4 / atol 1e-6, gradients
  _close_grad, the state after _close_update); the pyramid CNN's gradient
  exactly zero.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu.models import feature_pyramid as jfp
from hybridneuralrendering_tpu.models import fusion as jfusion
from hybridneuralrendering_tpu.models import neural_points as jnpts
from hybridneuralrendering_tpu.train import pyramid_cache as jpc
from hybridneuralrendering_tpu.train import step as jstep
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch.models import feature_pyramid as tfp
from hybridneuralrendering_tpu_torch.models import fusion as tfusion
from hybridneuralrendering_tpu_torch.models import neural_points as tnpts
from hybridneuralrendering_tpu_torch.ops import scan as tscan
from hybridneuralrendering_tpu_torch.train import pyramid_cache as tpc
from hybridneuralrendering_tpu_torch.train import state as tstate
from hybridneuralrendering_tpu_torch.train import step as tstep
from test_torch_port_train import (_close_grad, _close_update,
                                   _jax_value_and_grad, _noise, _port_state,
                                   _train_setup)
from torch_port_common import REORDERED, configs, make_params, n, t

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)
import pallas_scan as PS     # noqa: E402

BF16_ROUNDING = 2.0 ** -7


def _within_bf16_rounding(got, want, bound=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if bound is None:
        bound = BF16_ROUNDING * np.maximum(np.abs(got), np.abs(want))
    assert (np.abs(got - want) <= bound).all(), float(
        (np.abs(got - want) - bound).max())


# ----------------------------------------------------------------- row scan

@pytest.mark.parametrize("F", [1, 64])
@pytest.mark.parametrize("M", [1, 511, 1300])
def test_cumsum_rows_plain_matches_pallas(M, F):
    x = np.random.default_rng(M * F).normal(size=(M, F)).astype(np.float32)
    want = np.asarray(PS.cumsum_rows(jnp.asarray(x), interpret=True))
    got = tscan.cumsum_rows(t(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, F)
    bound = 1e-5 * np.cumsum(np.abs(x).astype(np.float64), axis=0)
    assert (np.abs(n(got) - want) <= bound).all()


@pytest.mark.parametrize("shape", [(0,), (1,), (4_097,), (300, 3), (0, 5)])
def test_cumsum_rows_int32_exact(shape):
    rng = np.random.default_rng(3)
    x = rng.integers(-50, 50, shape).astype(np.int32)
    x[::3] = rng.integers(0, 2, x[::3].shape)        # 0/1 flags, as ranked
    got = tscan.cumsum_rows(t(x))
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(n(got), np.cumsum(x, axis=0))


def _kogge_stone(v):
    """Inclusive scan over the last axis (32 lanes) as the kernel's
    warp_inclusive adds: lane l += lane l - d for d = 1, 2, 4, 8, 16."""
    for d in (1, 2, 4, 8, 16):
        if d < v.shape[-1]:
            v = torch.cat([v[..., :d], v[..., d:] + v[..., :-d]], dim=-1)
    return v


def _exclusive(incl):
    return torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], -1)


def _scan_totals_model(agg):
    """scan_totals on the tile totals [nb]: a block scan (THREADS threads
    in warps of 32; the warp totals scanned by one warp, then added to the
    later warps' exclusive prefixes) per chunk of THREADS tiles, plus a
    carry from chunk to chunk."""
    T, nb = tscan.THREADS, agg.shape[0]
    offs, carry = torch.empty(nb), torch.zeros(())
    for t0 in range(0, nb, T):
        v = torch.zeros(T)
        v[:min(T, nb - t0)] = agg[t0:t0 + T]
        incl = _kogge_stone(v.reshape(T // 32, 32))
        excl = _exclusive(incl)
        winc = _kogge_stone(incl[:, 31])
        excl[1:] = winc[:-1, None] + excl[1:]
        offs[t0:t0 + T] = (carry + excl.reshape(-1))[:min(T, nb - t0)]
        carry = carry + winc[-1]
    return offs


def _scan_order_model(x):
    """csrc/cumsum_rows.cu's float32 order for x [M] (F == 1), in float32
    torch ops: tiles of THREADS * VECS * VEC elements; warp w of a tile owns
    VECS * 32 consecutive vectors of VEC elements, step k's lane l vector
    k * 32 + l; the prefixes inside a vector, a Kogge-Stone scan of the
    vector totals over the lanes, a running sum over the steps and one over
    the warps (tile_scan); the tile totals through scan_totals; and
    y = ((tile offset + warp offset) + step base) + vector prefix."""
    W, K, V = tscan.WARPS, tscan.VECS, tscan.VEC
    M, tile = x.shape[0], tscan.tile_rows(1)
    nb = -(-M // tile)
    xp = torch.zeros(nb * tile)
    xp[:M] = x
    v = xp.reshape(nb, W, K, 32, V)
    s = [v[..., 0]]
    for j in range(1, V):
        s.append(s[-1] + v[..., j])
    incl = _kogge_stone(s[-1])
    excl = _exclusive(incl)
    run, base = torch.zeros(nb, W), torch.empty(nb, W, K, 32)
    for k in range(K):
        base[:, :, k] = run[..., None] + excl[:, :, k]
        run = run + incl[:, :, k, 31]
    acc, woff = torch.zeros(nb), torch.empty(nb, W)
    for w in range(W):
        woff[:, w] = acc
        acc = acc + run[:, w]
    off = _scan_totals_model(acc)[:, None] + woff
    b = off[:, :, None, None] + base
    return torch.stack([b + sj for sj in s], dim=-1).reshape(-1)[:M]


@pytest.mark.parametrize("kind", ["normal", "cancelling", "carry_chunks"])
def test_scan_order_model_within_tolerance(kind):
    """The kernel's float32 order for F == 1, modelled on the CPU, within
    ops/scan.tolerance of the float64 plain version; on integer values
    (every partial sum exact) the model equals it.  carry_chunks has more
    than THREADS tiles, so the tile sums cross scan_totals' chunks."""
    rng = np.random.default_rng(21)
    if kind == "normal":
        x = rng.normal(size=50_001)
    elif kind == "cancelling":
        x = np.where(np.arange(70_000) % 2 == 0, 1e4, -1e4) + rng.normal(
            size=70_000)
    else:
        x = rng.normal(size=tscan.THREADS * tscan.tile_rows(1) + 4_099)
    x = t(x.astype(np.float32))
    err = (_scan_order_model(x).double()
           - tscan.cumsum_rows_plain(x).double()).abs()
    tol = tscan.tolerance(x)
    assert (err <= tol).all(), float((err / tol).max())
    q = t(rng.integers(-8, 9, x.shape[0]).astype(np.float32))
    assert torch.equal(_scan_order_model(q), tscan.cumsum_rows_plain(q))


def test_cumsum_rows_refuses_other_types():
    with pytest.raises(TypeError):
        tscan.cumsum_rows(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        tscan.cumsum_rows(torch.zeros(2, 2, 2))


# -------------------------------------------------------------- dedup gather

def _dedup_case(seed=5):
    """A [400, 64] table and [R, SR, K] ids with empty (-1) slots,
    duplicate-heavy like a step's neighbour ids (at most 58 unique ids
    among 288 slots), and the unique count after clamping."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(400, 64)).astype(np.float32)
    idx = rng.choice(np.arange(-1, 400, 7), size=(12, 6, 4)).astype(np.int32)
    return table, idx, len(np.unique(np.clip(idx, 0, None)))


@pytest.mark.parametrize("cap", ["above", "below"])
def test_dedup_gather_forward_bitwise(cap):
    table, idx, uniq = _dedup_case()
    u_cap = uniq + 3 if cap == "above" else uniq - 1
    want = np.asarray(jnpts._dedup_gather_impl(
        jnp.asarray(table), jnp.clip(jnp.asarray(idx), 0), u_cap))
    got = n(tnpts.gather_rows(t(table), t(idx), dedup=u_cap))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, table[np.clip(idx, 0, None)])


def test_dedup_gather_ranks_through_cumsum_rows(monkeypatch):
    """The unique ranks come from one int32 row scan; a scan that is
    exclusive instead of inclusive breaks the gather."""
    table, idx, uniq = _dedup_case(6)
    calls = []
    real = tnpts.cumsum_rows
    monkeypatch.setattr(tnpts, "cumsum_rows",
                        lambda x: calls.append(x.dtype) or real(x))
    tnpts.dedup_gather(t(table), t(idx), uniq)
    assert calls == [torch.int32]
    monkeypatch.setattr(tnpts, "cumsum_rows", lambda x: real(x) - x)
    got = n(tnpts.dedup_gather(t(table), t(idx), uniq + 1))
    assert (got != table[np.clip(idx, 0, None)]).any()


@pytest.mark.parametrize("cap", ["above", "below"])
def test_dedup_gather_gradient_matches_jax(cap):
    table, idx, uniq = _dedup_case(7)
    u_cap = uniq + 3 if cap == "above" else uniq - 1
    ct = np.random.default_rng(8).normal(
        size=idx.shape + (table.shape[1],)).astype(np.float32)
    ref = np.asarray(jax.grad(lambda tab: jnp.sum(jnpts._gather_rows_dedup(
        tab, jnp.clip(jnp.asarray(idx), 0), u_cap) * ct))(
            jnp.asarray(table)))
    leaf = t(table).requires_grad_(True)
    torch.sum(tnpts.gather_rows(leaf, t(idx), dedup=u_cap)
              * t(ct)).backward()
    _close_grad(leaf.grad, ref)


# ------------------------------------------------------------ pyramid pieces

def _staged_inputs(seed=9, V=2, H=16, W=24):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (V, H, W, 3)).astype(np.float32)
    stages = tuple(rng.normal(size=(V, H // s, W // s, c)).astype(np.float32)
                   for s, c in ((2, 6), (4, 12), (8, 24)))
    return images, stages


def _cast(a, dtype):
    """(JAX array, port tensor) of the same values in `dtype`."""
    j = jnp.asarray(a).astype(dtype)
    return j, t(np.asarray(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _compare(got, want, dtype, bound=None):
    got, want = n(got.float()), np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **REORDERED)
    else:
        _within_bf16_rounding(got, want, bound)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_materialize_matches_jax(dtype):
    images, stages = _staged_inputs()
    ji, ti = _cast(images, dtype)
    js, ts = zip(*(_cast(s, dtype) for s in stages))
    want = jfp.materialize(ji, js, dtype=getattr(jnp, dtype))
    got = tfp.materialize(ti, ts, dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape[-1] == 64
    assert not n(got.float())[..., 45:].any()
    # the summands' magnitude: the RGB and the upsampled |stage maps|
    mag = n(tfp.materialize(ti.float().abs(), [x.float().abs() for x in ts]))
    _compare(got, want, dtype, 3 * 2.0 ** -8 * mag)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_staged_matches_jax(dtype):
    images, stages = _staged_inputs(10)
    V, H, W, _ = images.shape
    rng = np.random.default_rng(11)
    py = rng.integers(0, H, (V, 7, 5))
    px = rng.integers(0, W, (V, 7, 5))
    py[:, 0, 0], px[:, 0, 0] = 0, 0                 # the clamped edges
    py[:, 0, 1], px[:, 0, 1] = H - 1, W - 1
    ji, ti = _cast(images, dtype)
    js, ts = zip(*(_cast(s, dtype) for s in stages))
    want = jfp.gather_staged(ji, js, jnp.asarray(py), jnp.asarray(px),
                             dtype=getattr(jnp, dtype))
    got = tfp.gather_staged(ti, ts, t(py), t(px),
                            dtype=getattr(torch, dtype))
    # float32 weights: the bilinear samples come out in float32 in both
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _compare(got, want, dtype)
    if dtype == "float32":
        # nearest-pixel reads of the materialized map, as the JAX package
        # promises (to bilinear-interpolation rounding)
        full = n(tfp.materialize(ti, ts))
        np.testing.assert_allclose(
            n(got), full[np.arange(V)[:, None, None], py, px][..., :45],
            **REORDERED)


@pytest.mark.parametrize("materialize", [True, False])
def test_image_fusion_with_staged_maps_matches_jax(monkeypatch, materialize):
    """Cached maps through both readings against JAX; the map carries no
    gradient, so the backward runs no segment sum."""
    jc, tc = configs(staged_materialize=materialize)
    jp, tp = make_params(jc)
    images, stages = _staged_inputs(12)
    V, H, W, _ = images.shape
    rng = np.random.default_rng(13)
    R, SR = 10, 4
    loc = np.stack([rng.uniform(-3, W + 3, (V, R, SR)),
                    rng.uniform(-3, H + 3, (V, R, SR))], -1).astype(
                        np.float32)
    cf = rng.normal(size=(R, SR, tc.agg.shading_feature_num // 2)).astype(
        np.float32)
    dv = rng.normal(size=(V, R, SR, 3)).astype(np.float32)
    fw = rng.random(V).astype(np.float32)
    drop = np.zeros(R, bool)
    drop[:3] = True
    want = jfusion.image_fusion(
        jp["aggregator"], jc.agg, jnp.asarray(cf), None,
        (jnp.asarray(images), tuple(map(jnp.asarray, stages))),
        jnp.asarray(loc), jnp.asarray(dv), jnp.asarray(fw), None,
        jnp.asarray(drop), train=True)
    calls = []
    real = tnpts.segment_sum
    monkeypatch.setattr(tnpts, "segment_sum",
                        lambda *a: calls.append(1) or real(*a))
    cf_t = t(cf).requires_grad_(True)
    got = tfusion.image_fusion(
        tp["aggregator"], tc.agg, cf_t, None, t(loc), t(dv), t(fw),
        drop_mask=t(drop), img_feat_staged=(t(images), tuple(map(t, stages))))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert np.abs(np.asarray(want)).max() > 0
    got.sum().backward()
    assert calls == [] and cf_t.grad is not None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pyramid_cache_matches_jax(dtype):
    jc, tc = configs()
    jp, tp = make_params(jc)
    images = np.random.default_rng(14).uniform(
        0, 1, (3,) + tuple(tc.image_hw) + (3,)).astype(np.float32)
    jcache = jpc.PyramidCache(jc, dtype=getattr(jnp, dtype))
    tcache = tpc.PyramidCache(tc, dtype=getattr(torch, dtype))
    for vids, rows in (([7, 9], [0, 1]), ([9, 4, 7], [1, 2, 0])):
        js = jcache.get_stack(jp, images[rows], vids)
        ts = tcache.get_stack(tp, t(images[rows]), vids)
        assert (tcache.hits, tcache.misses, len(tcache)) == (
            jcache.hits, jcache.misses, len(jcache))
        for a, b in zip(ts, js):
            assert a.dtype == getattr(torch, dtype) and not a.requires_grad
            _compare(a, b, dtype)
    assert (tcache.hits, tcache.misses) == (2, 3)
    tcache.invalidate()
    jcache.invalidate()
    assert len(tcache) == len(jcache) == 0
    tcache.get_stack(tp, t(images[:1]), [7])
    assert tcache.misses == 4


def test_burst_schedule_matches_jax_rule():
    """in_burst and burst_begins against the JAX trainer's loop
    (cli/train.py:438-441, :523-525) over two cycles of a 4/10 schedule,
    and with the cache off."""
    for cache in (True, False):
        o = dataclasses.replace(TC.OptimConfig(), pyramid_cache=cache,
                                pyramid_cycle_steps=10,
                                pyramid_burst_steps=4)
        was_burst = True
        for step in range(20):
            burst = (not cache) or (step % 10) < 4
            invalidate = cache and burst and not was_burst
            was_burst = burst
            assert tpc.in_burst(step, o) == burst, step
            assert tpc.burst_begins(step, o) == invalidate, step
    o = TC.OptimConfig()
    assert [tpc.burst_begins(s, o) for s in (0, 40, 400, 401)] == [
        False, False, True, False]


# ---------------------------------------------------- whole cached step

def _port_cached(st, tc, tb):
    """(images, stage maps) of the batch's views from st's parameters."""
    return (tb["images_nearest"], tpc.PyramidCache(
        tc, dtype=torch.float32).get_stack(st.params, tb["images_nearest"],
                                           range(len(tb["images_nearest"]))))


@pytest.fixture(scope="module")
def cached_step():
    """Both packages from one state: an uncached step, then stage maps from
    the new parameters through each package's PyramidCache (float32) and
    one cached step; the cached step's gradients and the states before and
    after it.  Also the port's cached step from the fresh state."""
    jc, tc, jst, jgrid, jb, tgrid, tb, bank = _train_setup()
    tbank = t(bank)
    fresh = _port_state(jst, tc)
    pyr0 = [x.clone() for x in tstate.tree_leaves(
        fresh.params["aggregator"]["pyramid"])]
    fresh, _ = tstep.train_step(fresh, tgrid, tb, tbank, tc,
                                noise=t(_noise(jax.random.PRNGKey(30), tc)),
                                img_feat_staged=_port_cached(fresh, tc, tb))
    tst = _port_state(jst, tc)
    k1, k2 = jax.random.PRNGKey(31), jax.random.PRNGKey(32)
    jst, _ = jstep.train_step(jst, jgrid, jb, k1, jnp.asarray(bank), jc)
    tst, _ = tstep.train_step(tst, tgrid, tb, tbank, tc,
                              noise=t(_noise(k1, tc)))
    before = _port_state(jst, tc)
    jstaged = (jb["images_nearest"], jpc.PyramidCache(
        jc, dtype=jnp.float32).get_stack(jst.params, jb["images_nearest"],
                                         [0, 1]))
    tstaged = _port_cached(tst, tc, tb)
    pts_tree = {"table": jst.points.table}
    (_, jitems), (jg_net, jg_pts) = _jax_value_and_grad(
        jst.params, pts_tree, jst.points, jgrid, jb, cfg=jc, key=k2,
        blur_kernels=jnp.asarray(bank), img_feat_staged=jstaged)
    noise = t(_noise(k2, tc))
    titems, tg_net, tg_table = tstep.loss_and_grads(
        tst, tgrid, tb, tbank, tc, noise=noise, img_feat_staged=tstaged)
    jst, _ = jstep.train_step(jst, jgrid, jb, k2, jnp.asarray(bank), jc,
                              jstaged)
    tst, items2 = tstep.train_step(tst, tgrid, tb, tbank, tc, noise=noise,
                                   img_feat_staged=tstaged)
    return dict(tc=tc, before=before, jitems=jitems, titems=titems,
                items2=items2, jg_net=jg_net, tg_net=tg_net,
                jg_table=jg_pts["table"], tg_table=tg_table,
                jst=_port_state(jst, tc), tst=tst, fresh_pyr=(pyr0, [
                    x.clone() for x in tstate.tree_leaves(
                        fresh.params["aggregator"]["pyramid"])]))


def test_cached_step_loss_items(cached_step):
    s = cached_step
    assert set(s["titems"]) == set(s["jitems"]) == set(s["items2"])
    for k, v in s["jitems"].items():
        np.testing.assert_allclose(n(s["titems"][k]), np.asarray(v),
                                   rtol=1e-4, atol=1e-6)
        assert float(s["items2"][k]) == float(s["titems"][k])
    assert 0.2 < float(s["titems"]["ray_hit_frac"]) <= 1.0


def test_cached_step_network_gradients(cached_step):
    """Every leaf as JAX's; the pyramid CNN's exactly zero in both."""
    s = cached_step
    jl = jax.tree_util.tree_leaves(s["jg_net"])
    tl = tstate.tree_leaves(s["tg_net"])
    assert len(jl) == len(tl) > 20
    for got, want in zip(tl, jl):
        assert tuple(got.shape) == tuple(want.shape)
        _close_grad(got, want)
    pyr = tstate.tree_leaves(s["tg_net"]["aggregator"]["pyramid"])
    assert len(pyr) == 12
    assert not any(bool(g.any()) for g in pyr)
    assert not any(np.asarray(g).any() for g in jax.tree_util.tree_leaves(
        s["jg_net"]["aggregator"]["pyramid"]))
    others = [g for k, v in s["tg_net"]["aggregator"].items()
              if k != "pyramid" for g in tstate.tree_leaves(v)]
    assert sum(float(g.abs().max()) > 0 for g in others) > 20


def test_cached_step_table_gradient(cached_step):
    s = cached_step
    _close_grad(s["tg_table"], s["jg_table"])
    g = n(s["tg_table"])
    assert not g[:, :3].any() and np.abs(g[:, 3:]).max() > 0


def test_cached_step_state_after(cached_step):
    """The moments as JAX's; the table and the network parameters where
    both steps' gradients clear the noise (the first step's read from its
    first moment, (1 - beta1) * g).  The pyramid CNN has no gradient on the
    cached step and moves by its first moment alone, as JAX's does."""
    s = cached_step
    got, want, before = s["tst"], s["jst"], s["before"]
    assert got.step == want.step == 2
    assert got.opt_net.count == want.opt_net.count == 2
    o = s["tc"].optim
    _close_grad(got.opt_pts.mu, want.opt_pts.mu)
    _close_grad(got.opt_pts.nu, want.opt_pts.nu)
    g0, g1 = n(before.opt_pts.mu), np.asarray(s["jg_table"])
    sel = ((np.abs(g0) > 1e-3 * np.abs(g0).max())
           & (np.abs(g1) > 1e-3 * np.abs(g1).max()))
    assert sel.sum() > 100
    np.testing.assert_allclose(n(got.points.table)[sel],
                               n(want.points.table)[sel], rtol=1e-4,
                               atol=1e-3 * o.plr)
    leaves = zip(tstate.tree_leaves(got.params["aggregator"]["pyramid"]),
                 tstate.tree_leaves(want.params["aggregator"]["pyramid"]),
                 tstate.tree_leaves(before.params["aggregator"]["pyramid"]),
                 tstate.tree_leaves(before.opt_net.mu["aggregator"]
                                    ["pyramid"]))
    moved = 0
    for gp, wp, bp, mu in leaves:
        _close_update(gp, n(wp), n(bp), n(mu), o.lr)
        moved += int((n(gp) != n(bp)).sum())
    assert moved > 0
    for gm, wm in zip(tstate.tree_leaves(got.opt_net.mu),
                      tstate.tree_leaves(want.opt_net.mu)):
        _close_grad(gm, wm)


def test_cached_step_from_fresh_state_freezes_pyramid(cached_step):
    """From zero moments a cached step moves the CNN by exactly 0 (JAX
    test_train.py::TestPyramidCache::test_cached_step_freezes_pyramid)."""
    pyr0, pyr1 = cached_step["fresh_pyr"]
    assert all(torch.equal(a, b) for a, b in zip(pyr0, pyr1))
