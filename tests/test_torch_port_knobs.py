"""The aggregator's other model code in the port against the JAX package:
the SH and Gaussian distance kernels (sh_intrp, gau_intrp) and attention
fusion (tradition_attention, with and without the Gumbel selection), from
the kernels up to a render; float32 on tiny_test (point features widened
to 32 for the embedding-consuming kernels).  The plane background, one
training step with each knob, checkpoints with attention parameters and
the float32 alpha head of the compute_dtype chain are in
tests/test_torch_port_knobs_step.py, under the tolerances below.

Tolerances:
- elementwise maps (sh_basis, the rotations, bilinear samples, the plane
  crossings): rtol 1e-6 / atol 1e-6, the same float32 operations in the
  same order up to XLA's fusion;
- the distance kernels' weights and their gradients: rtol 1e-5 / atol
  1e-6 (REORDERED: sums in another order);
- the aggregator, fusion and renders: forward rtol 1e-4 / atol 1e-5,
  gradients rtol 1e-3 / atol 1e-4 * max|grad| (the training step's);
- the foreground splat and the plane colours: exact masks.  The splat and
  the colour lookup take ceil (and bilinear_sample floor) of projected
  float32 pixel coordinates, which torch and XLA may round to opposite
  sides of an integer; the inputs drop every point and ray whose float64
  projection lies within 1e-3 pixel of an integer or of the image's edge
  (float32 coordinates of a 64-pixel image err by about 1e-5 pixel), so
  no pixel may flip;
- the alpha head of compute_dtype = bfloat16: 1e-6 relative (float32
  products of the same operands); the bf16-operand head it replaces errs
  by about 2**-9 and must fail the same check.

JAX's jitted entry points cannot take attention's int num_heads leaf
(jax.grad and jit turn it into a traced array, which reshape refuses), so
its reference gradients come from a function that closes over that leaf;
the port keeps it as a Python int, as JAX's attention.init makes it.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu.core import geometrics as jgeo
from hybridneuralrendering_tpu.core import sh as jsh
from hybridneuralrendering_tpu.models import aggregator as jagg
from hybridneuralrendering_tpu.models import attention as jatt
from hybridneuralrendering_tpu.models import fusion as jfusion
from hybridneuralrendering_tpu.models import renderer as jrenderer
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch.core import geometrics as tgeo
from hybridneuralrendering_tpu_torch.core import sh as tsh
from hybridneuralrendering_tpu_torch.data import synthetic as tsyn
from hybridneuralrendering_tpu_torch.io import from_jax
from hybridneuralrendering_tpu_torch.models import aggregator as tagg
from hybridneuralrendering_tpu_torch.models import attention as tatt
from hybridneuralrendering_tpu_torch.models import fusion as tfusion
from hybridneuralrendering_tpu_torch.models import renderer as trenderer
from hybridneuralrendering_tpu_torch.train import state as tstate
from test_torch_port_render import ALPHA_BIAS, F32, _agg_inputs
from test_torch_port_train import _close_grad
from torch_port_common import (  # noqa: F401  (one_torch_thread: fixture)
    REORDERED, configs, make_params, make_scene, n, one_torch_thread, t)

ELEMENTWISE = dict(rtol=1e-6, atol=1e-6)
# the knobs of the aggregator's other model code, by test id
KNOBS = {
    "sh_intrp": dict(agg_distance_kernel="sh_intrp"),
    "gau_intrp": dict(agg_distance_kernel="gau_intrp"),
    "attention": dict(tradition_attention=True),
    "attention_gumbel": dict(tradition_attention=True,
                             use_gumbel_softmax=True),
}
WIDE_FEATURES = 32      # point features of the embedding-consuming kernels
NEAR_INTEGER = 1e-3     # pixels: the ceil / floor margin (module docstring)


def knob_configs(**agg):
    """(JAX, port) tiny_test with aggregator overrides; 32 point feature
    channels where a distance kernel consumes embedding channels."""
    jc, tc = configs(**agg)
    if agg.get("agg_distance_kernel") in ("sh_intrp", "gau_intrp"):
        def widen(c):
            return c.replace(
                points=dataclasses.replace(c.points,
                                           feature_dim=WIDE_FEATURES),
                agg=dataclasses.replace(c.agg,
                                        point_features_dim=WIDE_FEATURES))
        jc, tc = widen(jc), widen(tc)
    return jc, tc


def split_heads(tree):
    """(a copy of the JAX tree without attention's num_heads, the value or
    None)."""
    tree = copy.copy(tree)
    for k, v in list(tree.items()):
        if k == "attention":
            v = dict(v)
            heads = int(v.pop("num_heads"))
            tree[k] = v
            return tree, heads
        if isinstance(v, dict):
            sub, heads = split_heads(v)
            if heads is not None:
                tree[k] = sub
                return tree, heads
    return tree, None


def grad_of(x):
    """x.grad, zeros where autograd left it None (no path to x)."""
    return x.grad if x.grad is not None else torch.zeros_like(x)


def with_heads(tree, heads):
    """The tree with num_heads put back into its attention dict."""
    if heads is None:
        return tree
    tree = dict(tree)
    for k, v in tree.items():
        if k == "attention":
            tree[k] = dict(v, num_heads=heads)
        elif isinstance(v, dict):
            tree[k] = with_heads(v, heads)
    return tree


# ------------------------------------------------------- SH and local frame

@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("deg", [1, 2, 3, 4, 5])
def test_sh_basis(deg, flip):
    rng = np.random.default_rng(deg)
    d = rng.normal(size=(7, 5, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = np.asarray(jsh.sh_basis(jnp.asarray(d), deg, flip_dir=flip))
    got = tsh.sh_basis(t(d), deg, flip_dir=flip)
    assert tuple(got.shape) == want.shape == (7, 5, deg * deg)
    np.testing.assert_allclose(n(got), want, **ELEMENTWISE)
    with pytest.raises(ValueError):
        tsh.sh_basis(t(d), 6)


def test_world2local_dist():
    rng = np.random.default_rng(1)
    rpy = rng.uniform(-np.pi, np.pi, (6, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        n(tgeo.roll_pitch_yaw_to_rotation(t(rpy))),
        np.asarray(jgeo.roll_pitch_yaw_to_rotation(jnp.asarray(rpy))),
        **ELEMENTWISE)
    d = rng.normal(size=(6, 4, 3)).astype(np.float32)
    radii = rng.uniform(0.05, 2.0, (6, 4, 3)).astype(np.float32)
    want = np.asarray(jgeo.compute_world2local_dist(
        jnp.asarray(d), jnp.asarray(radii), jnp.asarray(rpy)))
    got = tgeo.compute_world2local_dist(t(d), t(radii), t(rpy))
    np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["sh_intrp", "gau_intrp", "trilinear",
                                  "linear"])
def test_dist_weight_ex(name):
    """Weights, the remaining embedding, and the gradients of <weights,
    cot> by the offsets and the whole embedding (the consumed channels
    get theirs through the weights)."""
    rng = np.random.default_rng(2)
    R, SR, K, C, Fd = 3, 4, 5, 6, WIDE_FEATURES
    dists = rng.normal(0, 0.05, (R, SR, K, C)).astype(np.float32)
    mask = rng.random((R, SR, K)) > 0.3
    dists *= mask[..., None]
    emb = rng.normal(size=(R, SR, K, Fd)).astype(np.float32)
    emb[..., 4:7] *= 3.0          # rotations past the +-pi/4 clip
    cot_w = rng.normal(size=(R, SR, K)).astype(np.float32)
    vs = (0.05, 0.05, 0.05)

    def f(d, e):
        w, rest = jagg.dist_weight_ex(name, d, jnp.asarray(mask), e, vs,
                                      0.05)
        return w, rest

    (jw, jrest), vjp = jax.vjp(f, jnp.asarray(dists), jnp.asarray(emb))
    jgd, jge = vjp((jnp.asarray(cot_w), jnp.zeros_like(jrest)))
    td = t(dists).requires_grad_(True)
    te = t(emb).requires_grad_(True)
    w, rest = tagg.dist_weight_ex(name, td, t(mask), te, vs, 0.05)
    assert rest.is_contiguous()
    assert tuple(rest.shape) == jrest.shape
    assert rest.shape[-1] == Fd - tagg.consumed_channels(
        TC.AggregatorConfig(agg_distance_kernel=name))
    np.testing.assert_allclose(n(w), np.asarray(jw), **REORDERED)
    np.testing.assert_array_equal(n(rest), np.asarray(jrest))
    (w * t(cot_w)).sum().backward()
    np.testing.assert_allclose(n(td.grad), np.asarray(jgd), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jgd)).max())
    ge = te.grad if te.grad is not None else torch.zeros_like(te)
    np.testing.assert_allclose(n(ge), np.asarray(jge), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jge)).max())
    if name in ("sh_intrp", "gau_intrp"):
        assert np.abs(n(ge)[..., :7]).max() > 0
        assert not n(ge)[..., 16:].any()


@pytest.mark.parametrize("name", ["sh_intrp", "gau_intrp", "attention"])
def test_block1_in_dim_and_init_shapes(name):
    jc, tc = knob_configs(**KNOBS[name])
    assert tagg.block1_in_dim(tc.agg) == jagg.block1_in_dim(jc.agg)
    want = jax.eval_shape(lambda k: jrenderer.init_params(k, jc),
                          jax.random.PRNGKey(0))
    got = trenderer.init_params(tc, device="cpu")
    wl, jtree = jax.tree_util.tree_flatten(want)
    jshapes = sorted(str(tuple(x.shape)) for x in wl if x.shape)
    tshapes = sorted(str(tuple(x.shape)) for x in tstate.tree_leaves(got))
    assert tshapes == jshapes
    if name == "attention":
        att = got["aggregator"]["attention"]
        assert att["num_heads"] == 1 and "fusion_weight" not in \
            got["aggregator"]
        assert not att["proj"]["w"].any()
        # the context: 45 image channels + 3 delta view; query: F / 2
        assert tuple(att["kv"]["w"].shape) == (48, 32)
        assert tuple(att["q"]["w"].shape) == (64, 16)


# ------------------------------------------------------- the aggregator

def _case(name):
    jc, tc = knob_configs(**KNOBS[name])
    jp, tp = make_params(jc, alpha_bias=ALPHA_BIAS)
    a = _agg_inputs(tc)
    a["drop_mask"] = np.arange(12) % 3 == 0
    cot = np.random.default_rng(7).normal(
        size=(12, tc.querier.SR, 4)).astype(np.float32)
    return jc, tc, jp["aggregator"], tp["aggregator"], a, cot


INPUT_GRADS = ("sampled_embedding", "sampled_conf", "sampled_color",
               "sampled_dir", "sampled_xyz")


def _jax_apply(jc, jp, a, cot, train=True):
    vs = jc.querier.query_vsize
    fixed = {k: jnp.asarray(v) for k, v in a.items()
             if k not in INPUT_GRADS}
    p0, heads = split_heads(jp)

    def f(p, ins):
        return jagg.apply(with_heads(p, heads), jc.agg, vsize=vs,
                          train=train, **fixed, **ins).features

    ins = {k: jnp.asarray(a[k]) for k in INPUT_GRADS}
    feats, vjp = jax.vjp(jax.jit(f), p0, ins)
    g_net, g_in = vjp(jnp.asarray(cot))
    return np.asarray(feats), g_net, g_in


def _port_apply(tc, tp, a, cot, train=True):
    tp = tstate.tree_map(lambda x: x.detach().clone().requires_grad_(True),
                         tp)
    kw = {k: t(v) for k, v in a.items()}
    for k in INPUT_GRADS:
        kw[k].requires_grad_(True)
    out = tagg.apply(tp, tc.agg, vsize=tc.querier.query_vsize, train=train,
                     **kw)
    (out.features * t(cot)).sum().backward()
    return (out.features.detach(),
            tstate.tree_map(lambda x: torch.zeros_like(x) if x.grad is None
                            else x.grad, tp),
            {k: kw[k].grad for k in INPUT_GRADS})


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", list(KNOBS))
def test_aggregator_apply_matches_jax(name, train):
    """Forward and every gradient (network, embedding, conf, colour, dir,
    xyz) with each knob, in training and eval."""
    jc, tc, jp, tp, a, cot = _case(name)
    jf, jg_net, jg_in = _jax_apply(jc, jp, a, cot, train)
    tf, tg_net, tg_in = _port_apply(tc, tp, a, cot, train)
    np.testing.assert_allclose(n(tf), jf, **F32)
    jl = jax.tree_util.tree_leaves(jg_net)
    tl = tstate.tree_leaves(tg_net)
    assert len(jl) == len(tl) > 20
    for got, want in zip(tl, jl):
        assert tuple(got.shape) == want.shape
        _close_grad(got, want)
    for k in INPUT_GRADS:
        _close_grad(tg_in[k], jg_in[k])
    if name.startswith("attention"):
        g = tg_net["attention"]
        # the zero proj passes no gradient to Q, K or V at init
        assert float(g["proj"]["w"].abs().max()) > 0
    else:
        # the consumed channels learn through the weights
        assert float(tg_in["sampled_embedding"][..., :7].abs().max()) > 0


# ------------------------------------------------------- attention

def _attention_inputs(seed=4, B=9, T=4, Cq=64, Cc=48):
    rng = np.random.default_rng(seed)
    pt = rng.normal(size=(B, Cq)).astype(np.float32)
    ctx = rng.normal(size=(B, T, Cc)).astype(np.float32)
    valid = rng.random((B, T)) < 0.7
    valid[0] = False                       # a sample that sees no view
    valid[1] = [True] + [False] * (T - 1)
    return pt, ctx, valid


def _attention_params(seed=5, Cq=64, Cc=48):
    """JAX attention params with a non-zero projection, and the port's."""
    jp = jatt.init(jax.random.PRNGKey(seed), Cq, Cc)
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["proj"]["w"] = rng.normal(0, 0.2, tree["proj"]["w"].shape).astype(
        np.float32)
    tree["norm_q"]["bias"] = rng.normal(0, 0.1, Cq).astype(np.float32)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            from_jax.params_from_numpy(tree, device="cpu"))


@pytest.mark.parametrize("mode", ["soft", "hard_eval", "hard_train"])
def test_attention_apply_matches_jax(mode):
    """Soft weights, and the hard one-hot in eval and in training without
    a key (JAX's fusion gives none): outputs and every gradient."""
    jp, tp = _attention_params()
    pt, ctx, valid = _attention_inputs()
    gumbel, train = mode != "soft", mode == "hard_train"
    cot = np.random.default_rng(6).normal(size=(9, 48)).astype(np.float32)
    p0, heads = split_heads({"attention": jp})

    def f(p, q, c):
        return jatt.apply(with_heads(p, heads)["attention"], q, c,
                          valid=jnp.asarray(valid), use_gumbel=gumbel,
                          train=train)

    want, vjp = jax.vjp(f, p0, jnp.asarray(pt), jnp.asarray(ctx))
    jg_p, jg_q, jg_c = vjp(jnp.asarray(cot))
    tp = tstate.tree_map(lambda x: x.requires_grad_(True), tp)
    q, c = t(pt).requires_grad_(True), t(ctx).requires_grad_(True)
    got = tatt.apply(tp, q, c, valid=t(valid), use_gumbel=gumbel)
    np.testing.assert_allclose(n(got), np.asarray(want), **F32)
    (got * t(cot)).sum().backward()
    _close_grad(grad_of(q), jg_q)
    _close_grad(grad_of(c), jg_c)
    jl = jax.tree_util.tree_leaves(jg_p["attention"])
    tl = tstate.tree_leaves(tstate.tree_map(grad_of, tp))
    assert len(jl) == len(tl) == 10
    for g, w in zip(tl, jl):
        _close_grad(g, w)
    if gumbel:
        # the one-hot passes no gradient to Q (nor to the query)
        assert not grad_of(q).any() and not grad_of(tp["q"]["w"]).any()
        assert not np.asarray(jg_q).any()


def test_attention_masks_invalid_views():
    _, tp = _attention_params()
    pt, ctx, valid = _attention_inputs()
    out = tatt.apply(tp, t(pt), t(ctx), valid=t(valid))
    ctx2 = ctx.copy()
    ctx2[~valid] += 100.0
    out2 = tatt.apply(tp, t(pt), t(ctx2), valid=t(valid))
    # rows with a valid view do not see the invalid ones
    some = valid.any(-1)
    np.testing.assert_allclose(n(out2)[some], n(out)[some], rtol=1e-5,
                               atol=1e-5)
    # the hard pick takes a valid view's value
    hard = tatt.apply(tp, t(pt), t(ctx2), valid=t(valid), use_gumbel=True)
    hard0 = tatt.apply(tp, t(pt), t(ctx), valid=t(valid), use_gumbel=True)
    np.testing.assert_allclose(n(hard)[some], n(hard0)[some], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("route", ["uncached", "materialised", "staged"])
def test_attention_fusion_routes(route):
    """image_fusion with attention over each pyramid route: a full map,
    cached stage maps upsampled to one (staged_materialize), and the
    stage maps sampled per sample; the merged feature and the gradient
    by the colour feature and the attention parameters."""
    jc, tc = configs(tradition_attention=True,
                     staged_materialize=route == "materialised")
    jp, tp = make_params(jc)
    rng = np.random.default_rng(13)
    V, H, W, R, SR = 2, 16, 24, 10, 4
    images = rng.uniform(0, 1, (V, H, W, 3)).astype(np.float32)
    stages = tuple(rng.normal(size=(V, H // s, W // s, c)).astype(np.float32)
                   for s, c in ((2, 6), (4, 12), (8, 24)))
    full = rng.normal(size=(V, H, W, 45)).astype(np.float32)
    loc = np.stack([rng.uniform(-3, W + 3, (V, R, SR)),
                    rng.uniform(-3, H + 3, (V, R, SR))], -1).astype(
                        np.float32)
    cf = rng.normal(size=(R, SR, 64)).astype(np.float32)
    dv = rng.normal(size=(V, R, SR, 3)).astype(np.float32)
    drop = np.arange(R) < 3
    jp = jax.tree_util.tree_map(lambda x: x, jp)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["aggregator"]["attention"]["proj"]["w"] = rng.normal(
        0, 0.2, (16, 48)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = from_jax.params_from_numpy(tree, device="cpu")
    staged = route != "uncached"
    p0, heads = split_heads(jp["aggregator"])

    def f(p, c):
        return jfusion.image_fusion(
            with_heads(p, heads), jc.agg, c,
            None if staged else jnp.asarray(full),
            (jnp.asarray(images), tuple(map(jnp.asarray, stages)))
            if staged else None, jnp.asarray(loc), jnp.asarray(dv), None,
            None, jnp.asarray(drop), train=True)

    want, vjp = jax.vjp(f, p0, jnp.asarray(cf))
    cot = rng.normal(size=want.shape).astype(np.float32)
    jg_p, jg_c = vjp(jnp.asarray(cot))
    ta = tstate.tree_map(lambda x: x.requires_grad_(True), tp["aggregator"])
    c = t(cf).requires_grad_(True)
    got = tfusion.image_fusion(
        ta, tc.agg, c, None if staged else t(full), t(loc), t(dv),
        drop_mask=t(drop),
        img_feat_staged=(t(images), tuple(map(t, stages))) if staged
        else None)
    np.testing.assert_allclose(n(got), np.asarray(want), **F32)
    assert np.abs(np.asarray(want)).max() > 0
    assert not n(got)[:3].any()
    (got * t(cot)).sum().backward()
    _close_grad(c.grad, jg_c)
    for g, w in zip(tstate.tree_leaves(tstate.tree_map(
            grad_of, ta["attention"])),
            jax.tree_util.tree_leaves(jg_p["attention"])):
        _close_grad(g, w)


@pytest.mark.parametrize("name", ["attention", "sh_intrp"])
def test_render_matches_jax(name):
    """A whole render (query, gather, aggregate, march) in eval."""
    jc, tc = knob_configs(**KNOBS[name])
    (jpts, jgrid), (tpts, tgrid) = make_scene(jc, tc)
    b = tsyn.batch_arrays(tc, 1, 96)
    jp, tp = make_params(jc, alpha_bias=ALPHA_BIAS)
    want = jrenderer.render(jp, jpts, jgrid,
                            {k: jnp.asarray(v) for k, v in b.items()}, jc)
    got = trenderer.render(tp, tpts, tgrid, {k: t(v) for k, v in b.items()},
                           tc)
    for k in ("coarse_raycolor", "coarse_is_background",
              "coarse_point_opacity"):
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), **F32,
                                   err_msg=k)
    np.testing.assert_array_equal(n(got["ray_mask"]),
                                  np.asarray(want["ray_mask"]))
    assert n(got["ray_mask"]).mean() > 0.3
