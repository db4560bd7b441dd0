"""The shading chain's knobs in the port's aggregator against the JAX
package's: remat_chain, chain_chunks, fused_leaky_vjp, compute_dtype and
separate_color_decoder, on tiny_test (float32 unless stated), with one and
two whole NeRF-shaped training steps.

Tolerances:
- float32 forward: rtol 1e-4 / atol 1e-5 (tests/test_torch_port_render.py:
  XLA and torch sum in other orders);
- float32 gradients: rtol 1e-3 / atol 1e-4 * max|grad| (the training
  step's).  With chunks the weights' gradient is the sum of the chunks'
  in autograd's order, where lax.scan accumulates its own; both are
  float32 sums of the same terms;
- remat on against off in the port: bit for bit (the chain draws no random
  numbers, so checkpoint's RNG stash changes nothing);
- compute_dtype = bfloat16 against JAX's: a Linear's operands round to
  bf16 alike and the f32 products differ only in order (rtol 1e-5); a bf16
  conv's rounded output may differ by one bf16 step, 2**-8 relative; the
  aggregator's outputs within a relative L2 error of 2**-8 (sound 1.2e-3
  and below before the chain's single-Linear alpha head was computed in
  float32 as JAX's is; that head is held to 1e-6 in
  tests/test_torch_port_knobs_step.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu.models import aggregator as jagg
from hybridneuralrendering_tpu.models import feature_pyramid as jfp
from hybridneuralrendering_tpu.models import mlp as jmlp
from hybridneuralrendering_tpu.train import state as jstate_mod
from hybridneuralrendering_tpu.train import step as jstep
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch.data import synthetic as tsyn
from hybridneuralrendering_tpu_torch.models import aggregator as tagg
from hybridneuralrendering_tpu_torch.models import feature_pyramid as tfp
from hybridneuralrendering_tpu_torch.models import mlp as tmlp
from hybridneuralrendering_tpu_torch.ops import shading_chain as SC
from hybridneuralrendering_tpu_torch.train import state as tstate
from hybridneuralrendering_tpu_torch.train import step as tstep
from test_torch_port_render import ALPHA_BIAS, F32, _agg_inputs
from test_torch_port_train import (_close_grad, _close_update, _jax_grads,
                                   _noise, _port_state)
from test_torch_port_checkpoint import (assert_flat_equal, jax_flat,
                                       jax_state, jax_template)
from torch_port_common import (  # noqa: F401  (one_torch_thread: fixture)
    configs, make_params, make_scene, n, one_torch_thread, t)

# the inputs whose gradients the test reads, besides the network's
INPUT_GRADS = ("sampled_embedding", "sampled_conf", "sampled_color",
               "sampled_dir")
R = 12          # _agg_inputs' rays: 4 chunks divide them, 5 do not


def _case(**agg):
    jc, tc = configs(**agg)
    jp, tp = make_params(jc, alpha_bias=ALPHA_BIAS)
    a = _agg_inputs(tc)
    a["drop_mask"] = np.arange(R) % 3 == 0
    cot = np.random.default_rng(7).normal(
        size=(R, tc.querier.SR, 4)).astype(np.float32)
    return jc, tc, jp["aggregator"], tp["aggregator"], a, cot


def _jax_apply(jc, jp, a, cot):
    """JAX features and the gradients of <features, cot> by the network
    and INPUT_GRADS."""
    vs = jc.querier.query_vsize
    fixed = {k: jnp.asarray(v) for k, v in a.items()
             if k not in INPUT_GRADS}

    def f(p, ins):
        out = jagg.apply(p, jc.agg, vsize=vs, train=True, **fixed, **ins)
        return out.features

    ins = {k: jnp.asarray(a[k]) for k in INPUT_GRADS}
    feats, vjp = jax.vjp(jax.jit(f), jp, ins)
    g_net, g_in = vjp(jnp.asarray(cot))
    return np.asarray(feats), g_net, g_in


def _port_apply(tc, tp, a, cot):
    tp = tstate.tree_map(lambda x: x.detach().clone().requires_grad_(True),
                         tp)
    kw = {k: t(v) for k, v in a.items()}
    for k in INPUT_GRADS:
        kw[k].requires_grad_(True)
    out = tagg.apply(tp, tc.agg, vsize=tc.querier.query_vsize, train=True,
                     **kw)
    (out.features * t(cot)).sum().backward()
    return (out.features.detach(),
            tstate.tree_map(lambda x: torch.zeros_like(x) if x.grad is None
                            else x.grad, tp),
            {k: kw[k].grad for k in INPUT_GRADS})


def _check_against_jax(jres, tres):
    jf, jg_net, jg_in = jres
    tf, tg_net, tg_in = tres
    np.testing.assert_allclose(n(tf), jf, **F32)
    jl = jax.tree_util.tree_leaves(jg_net)
    tl = tstate.tree_leaves(tg_net)
    assert len(jl) == len(tl)
    for got, want in zip(tl, jl):
        _close_grad(got, want)
    for k in INPUT_GRADS:
        _close_grad(tg_in[k], jg_in[k])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("chunks", [1, 4, 5])
@pytest.mark.parametrize("remat", [False, True])
def test_chain_knobs_match_jax(remat, chunks, fused):
    """Forward and every gradient (network, embedding, conf, colour, dir)
    under each knob setting, against JAX aggregator.apply in training."""
    jc, tc, jp, tp, a, cot = _case(remat_chain=remat, chain_chunks=chunks,
                                   fused_leaky_vjp=fused)
    jres = _jax_apply(jc, jp, a, cot)
    tres = _port_apply(tc, tp, a, cot)
    _check_against_jax(jres, tres)
    # the chain's weights get a gradient from every chunk's rows
    assert all(float(np.abs(np.asarray(g)).max()) > 0
               for g in jax.tree_util.tree_leaves(jres[1]["block1"]))


@pytest.mark.parametrize("chunks", [1, 4])
def test_remat_equals_no_remat_bitwise(chunks):
    jc, tc, jp, tp, a, cot = _case(chain_chunks=chunks)
    off = _port_apply(tc, tp, a, cot)
    tc_on = tc.replace(agg=dataclasses.replace(tc.agg, remat_chain=True))
    on = _port_apply(tc_on, tp, a, cot)
    assert torch.equal(off[0], on[0])
    for x, y in zip(tstate.tree_leaves(off[1]), tstate.tree_leaves(on[1])):
        assert torch.equal(x, y)
    for k in INPUT_GRADS:
        assert torch.equal(off[2][k], on[2][k])


def test_chunks_equal_one_pass_forward():
    """Chunked and one-pass features agree to float32 order; chunking is
    not silently skipped (the chain runs once per chunk)."""
    jc, tc, jp, tp, a, cot = _case(chain_chunks=4)
    calls = []
    real = SC.chain_plain
    try:
        SC.chain_plain = lambda *x, **k: (calls.append(x[0].shape[0]),
                                          real(*x, **k))[1]
        got = _port_apply(tc, tp, a, cot)[0]
    finally:
        SC.chain_plain = real
    K, SR = tc.querier.K, tc.querier.SR
    assert calls == [R // 4 * SR * K] * 4
    tc1 = tc.replace(agg=dataclasses.replace(tc.agg, chain_chunks=1))
    one = _port_apply(tc1, tp, a, cot)[0]
    np.testing.assert_allclose(n(got), n(one), rtol=1e-6, atol=1e-7)


def test_one_chunk_dw_fault_is_caught(monkeypatch):
    """A planted fault keeps only the last chunk's weight gradient (the
    other chunks' dW zeroed): the comparison with JAX must reject it."""
    jc, tc, jp, tp, a, cot = _case(chain_chunks=4, remat_chain=True)
    jres = _jax_apply(jc, jp, a, cot)
    real = SC.chain_backward_plain
    seen = []

    def last_chunk_only(*args, **kw):
        d_emb, d_dists, d_extra, g = real(*args, **kw)
        seen.append(1)
        if len(seen) > 1:       # autograd runs the last chunk first
            g = tstate.tree_map(torch.zeros_like, g)
        return d_emb, d_dists, d_extra, g

    monkeypatch.setattr(SC, "chain_backward_plain", last_chunk_only)
    tres = _port_apply(tc, tp, a, cot)
    assert len(seen) == 4
    with pytest.raises(AssertionError):
        _check_against_jax(jres, tres)


def test_separate_color_decoder_in_training():
    """color_final_2 colours the dropped rays from the point feature
    alone; forward and gradients against JAX, color_final_2 among them."""
    jc, tc, jp, tp, a, cot = _case(separate_color_decoder=True)
    assert "color_final_2" in jp and "color_final_2" in tp
    jres = _jax_apply(jc, jp, a, cot)
    tres = _port_apply(tc, tp, a, cot)
    _check_against_jax(jres, tres)
    g2 = np.asarray(jres[1]["color_final_2"][0]["w"])
    assert np.abs(g2).max() > 0
    # without the drop mask the second decoder is unused
    b = dict(a, drop_mask=np.zeros(R, bool))
    tres0 = _port_apply(tc, tp, b, cot)
    assert float(tres0[1]["color_final_2"][0]["w"].abs().max()) == 0.0
    assert float(tres0[1]["color_final"][0]["w"].abs().max()) > 0.0


def test_init_shapes_with_separate_decoder():
    jc, tc = configs(separate_color_decoder=True)
    jp, _ = make_params(jc)
    from hybridneuralrendering_tpu_torch.models import renderer as trenderer
    tp = trenderer.init_params(tc, device="cpu")
    shapes = lambda tree: [tuple(np.shape(x)) for x in   # noqa: E731
                           jax.tree_util.tree_leaves(
                               jax.tree_util.tree_map(np.asarray, tree))]
    assert sorted(tuple(x.shape) for x in tstate.tree_leaves(tp)) == \
        sorted(shapes(jp))
    assert tuple(tp["aggregator"]["color_final_2"][0]["w"].shape) == \
        np.shape(jp["aggregator"]["color_final_2"][0]["w"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_separate_decoder_checkpoint_both_ways(tmp_path, writer):
    """A NeRF-shaped run's state with the separate colour decoder:
    color_final_2 and its Adam moments go from a JAX file into the port and
    from a port file into JAX, leaf for leaf."""
    from hybridneuralrendering_tpu import config as JC
    from hybridneuralrendering_tpu.train import checkpoint as jck
    from hybridneuralrendering_tpu_torch.train import checkpoint as tck
    jc, tc = [c.replace(agg=dataclasses.replace(
        c.agg, separate_color_decoder=True)) for c in (nerf_tiny(JC),
                                                       nerf_tiny(TC))]
    ts = jax_state(jc, seed=4)
    path = jck.save_checkpoint(str(tmp_path / "jax"), ts, best_psnr=3.5)
    st, _ = tck.load_checkpoint(path, tc, device="cpu")
    want = jax_flat(ts)
    assert len([k for k in want if "color_final_2" in k]) == 3 * 2
    if writer == "port":
        path = tck.save_checkpoint(str(tmp_path / "port"), st, 3.5)
        back, _ = jck.load_checkpoint(path, jax_template(jc))
        assert_flat_equal(jax_flat(back), want)
    else:
        flat = tck.flatten_state(st)
        del flat["__best_psnr__"]
        assert_flat_equal(flat, want)


def _rel(got, want):
    got, want = n(got).astype(np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_compute_dtype_bf16_linear_and_conv():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 40)).astype(np.float32)
    p = {"w": rng.normal(size=(40, 24)).astype(np.float32),
         "b": rng.normal(size=24).astype(np.float32)}
    want = jmlp.linear_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), jnp.bfloat16)
    got = tmlp.linear_apply({k: t(v) for k, v in p.items()}, t(x),
                            torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # not rounded to bf16 after the product
    assert not np.array_equal(n(got), n(got.to(torch.bfloat16).float()))
    img = rng.uniform(size=(2, 16, 20, 3)).astype(np.float32)
    cp = {"w": rng.normal(size=(3, 3, 3, 6)).astype(np.float32),
          "b": rng.normal(size=6).astype(np.float32)}
    want = jmlp.conv2d_apply({k: jnp.asarray(v) for k, v in cp.items()},
                             jnp.asarray(img), 2,
                             compute_dtype=jnp.bfloat16)
    got = tmlp.conv2d_apply({k: t(v) for k, v in cp.items()}, t(img), 2,
                            torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got) - cp["b"], np.asarray(want) - cp["b"],
                               rtol=2.0 ** -8, atol=1e-6)


def test_compute_dtype_bf16_pyramid():
    jc, tc = configs(compute_dtype="bfloat16")
    jp, tp = make_params(jc)
    img = np.random.default_rng(1).uniform(
        size=(2,) + tc.image_hw + (3,)).astype(np.float32)
    want = jfp.apply(jp["aggregator"]["pyramid"], jnp.asarray(img),
                     compute_dtype=jnp.bfloat16)
    got = tfp.apply(tp["aggregator"]["pyramid"], t(img),
                    compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    assert _rel(got, want) < 2.0 ** -8


@pytest.mark.parametrize("shading", ["float32", "bfloat16"])
def test_compute_dtype_bf16_aggregator(shading):
    """compute_dtype = bfloat16 (and with it the bf16 chain) against JAX's
    bf16: the features within a relative L2 error of 2**-8 (module
    docstring).  With shading_dtype float32 JAX's chain rounds as the
    port's (bf16 operands, float32 sums), and each network gradient agrees
    within 2**-5, the bf16 chain kernels' gradient limit
    (ops/shading_chain.tolerance); with shading_dtype bfloat16 JAX's chain
    is bf16 end to end (a stated difference, ROADMAP Queue 3), so only the
    features are held."""
    jc, tc, jp, tp, a, cot = _case(compute_dtype="bfloat16",
                                   shading_dtype=shading)
    assert SC.chain_dtype(tc.agg) == "bfloat16"
    jf, jg_net, _ = _jax_apply(jc, jp, a, cot)
    tf, tg_net, _ = _port_apply(tc, tp, a, cot)
    assert _rel(tf, jf) < 2.0 ** -8
    if shading == "bfloat16":
        return
    jl = jax.tree_util.tree_leaves(jg_net)
    tl = tstate.tree_leaves(tg_net)
    errs = [_rel(g, w) for g, w in zip(tl, jl)
            if float(np.abs(np.asarray(w)).max()) > 0]
    assert len(errs) > 20 and max(errs) < 2.0 ** -5
    # the f32 run differs from the bf16 one by more than the tolerance
    tc32 = tc.replace(agg=dataclasses.replace(
        tc.agg, compute_dtype="float32", shading_dtype="float32"))
    assert _rel(_port_apply(tc32, tp, a, cot)[0], jf) > 1e-5


def test_chain_dtype_rule():
    base = TC.AggregatorConfig()
    cases = {("float32", "float32"): "float32",
             ("float32", "bfloat16"): "bfloat16",
             ("bfloat16", "float32"): "bfloat16",
             ("bfloat16", "bfloat16"): "bfloat16"}
    for (cdt, sdt), want in cases.items():
        cfg = dataclasses.replace(base, compute_dtype=cdt, shading_dtype=sdt)
        assert SC.chain_dtype(cfg) == want


# ------------------------------------------------ NeRF-shaped training step

def nerf_tiny(pkg):
    """tiny_test shaped as fixture_nerf_points: no fusion, no drop, no
    blur, no frame weight, random rays, a white background, and the chain
    in 4 rematerialised chunks."""
    c = pkg.tiny_test()
    return c.replace(
        agg=dataclasses.replace(c.agg, use_nearest=0, drop_ratio=0.0,
                                remat_chain=True, chain_chunks=4),
        sampling=dataclasses.replace(c.sampling, random_sample="random",
                                     random_sample_size=8),
        blur=dataclasses.replace(c.blur, add_blur_sim=False),
        loss=dataclasses.replace(c.loss, use_frame_weight=False))


@pytest.fixture(scope="module")
def nerf_steps():
    from hybridneuralrendering_tpu import config as JC
    jc, tc = nerf_tiny(JC), nerf_tiny(TC)
    (jpts, jgrid), (tpts, tgrid) = make_scene(jc, tc)
    jp, _ = make_params(jc, alpha_bias=ALPHA_BIAS)
    arrays = tsyn.batch_arrays(tc, seed=1)
    assert "images_nearest" not in arrays
    assert np.array_equal(arrays["bg_color"], np.ones(3, np.float32))
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: t(v) for k, v in arrays.items()}
    jst = jstate_mod.create_train_state(jp, jpts, jc)
    tst = _port_state(jst, tc)
    steps = []
    for key in (jax.random.PRNGKey(31), jax.random.PRNGKey(32)):
        before = _port_state(jst, tc)
        jitems, jg_net, jg_table = _jax_grads(jst, jgrid, jb, jc, key,
                                              np.zeros((1, 1, 1)))
        noise = t(_noise(key, tc))
        jst, _ = jstep.train_step(jst, jgrid, jb, key, None, jc)
        tst, titems = tstep.train_step(tst, tgrid, tb, None, tc, noise=noise)
        steps.append(dict(before=before, jitems=jitems, titems=titems,
                          jg_net=jg_net, jg_table=jg_table,
                          jst=_port_state(jst, tc)))
        steps[-1]["tst_table"] = tst.points.table.clone()
        steps[-1]["tst_params"] = tstate.tree_map(torch.clone, tst.params)
    return tc, steps


@pytest.mark.parametrize("step", [0, 1])
def test_nerf_train_step_matches_jax(nerf_steps, step):
    """One and two train_steps of the NeRF-shaped config against JAX's,
    within tests/test_torch_port_train.py's tolerances: loss items rtol
    1e-4, the table after the step where its gradient clears the noise."""
    tc, steps = nerf_steps
    s = steps[step]
    assert set(s["titems"]) == set(s["jitems"])
    for k, v in s["jitems"].items():
        np.testing.assert_allclose(n(s["titems"][k]), np.asarray(v),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert 0.2 < float(s["titems"]["ray_hit_frac"]) <= 1.0
    o = tc.optim
    want = s["jst"]
    g = np.asarray(s["jg_table"])
    if step == 0:
        _close_update(s["tst_table"], n(want.points.table),
                      n(s["before"].points.table), g, o.plr)
        for gp, wp, bp, gg in zip(
                tstate.tree_leaves(s["tst_params"]),
                tstate.tree_leaves(want.params),
                tstate.tree_leaves(s["before"].params),
                jax.tree_util.tree_leaves(s["jg_net"])):
            _close_update(gp, n(wp), n(bp), gg, o.lr)
    else:
        g0 = np.asarray(steps[0]["jg_table"])
        sel = ((np.abs(g0) > 1e-3 * np.abs(g0).max())
               & (np.abs(g) > 1e-3 * np.abs(g).max()))
        assert sel.sum() > 100
        np.testing.assert_allclose(n(s["tst_table"])[sel],
                                   n(want.points.table)[sel], rtol=1e-4,
                                   atol=1e-3 * o.plr)
