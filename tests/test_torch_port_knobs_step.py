"""The plane background (bgmodel = img_plane), one training step with each
knob of the aggregator's other model code, the float32 alpha head of the
compute_dtype chain and checkpoints with attention parameters, in the
port against the JAX package (float32 on tiny_test).  The tolerances,
the ceil / floor margin of the plane's inputs and the way JAX's
gradients are taken with attention's int num_heads leaf are those of
tests/test_torch_port_knobs.py (its module docstring).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu.core import bg_plane as jbg
from hybridneuralrendering_tpu.models import blur as jblur
from hybridneuralrendering_tpu.models import neural_points as jnpts
from hybridneuralrendering_tpu.models import renderer as jrenderer
from hybridneuralrendering_tpu.mvs import warp as jwarp
from hybridneuralrendering_tpu.ops import voxel_grid as JVG
from hybridneuralrendering_tpu.train import checkpoint as jck
from hybridneuralrendering_tpu.train import pyramid_cache as jpc
from hybridneuralrendering_tpu.train import state as jstate_mod
from hybridneuralrendering_tpu.train import step as jstep
from hybridneuralrendering_tpu_torch.core import bg_plane as tbg
from hybridneuralrendering_tpu_torch.data import synthetic as tsyn
from hybridneuralrendering_tpu_torch.io import from_jax
from hybridneuralrendering_tpu_torch.models import renderer as trenderer
from hybridneuralrendering_tpu_torch.mvs import warp as twarp
from hybridneuralrendering_tpu_torch.ops import shading_chain as SC
from hybridneuralrendering_tpu_torch.ops import voxel_grid as TVG
from hybridneuralrendering_tpu_torch.train import checkpoint as tck
from hybridneuralrendering_tpu_torch.train import pyramid_cache as tpc
from hybridneuralrendering_tpu_torch.train import state as tstate
from hybridneuralrendering_tpu_torch.train import step as tstep
from test_torch_port_checkpoint import assert_flat_equal, jax_flat
from test_torch_port_knobs import (ELEMENTWISE, KNOBS, NEAR_INTEGER,
                                   knob_configs, split_heads, with_heads)
from test_torch_port_render import ALPHA_BIAS, F32
from test_torch_port_train import _close_grad, _close_update, _noise, \
    _port_state
from torch_port_common import (  # noqa: F401  (one_torch_thread: fixture)
    REORDERED, configs, make_params, make_scene, n, one_torch_thread, t)


# ------------------------------------------------------- plane background

PLANE = dict(plane_pnt=np.array([0.0, 0.0, 2.5], np.float32),
             plane_normal=np.array([0.0, 0.2, 1.0], np.float32),
             plane_color=np.array([0.2, 0.6, 0.4], np.float32))


def _far_from_integers(xy, H, W):
    """Rows of xy [..., 2] (float64 pixels) farther than NEAR_INTEGER from
    every integer and from the image's edges."""
    frac = np.abs(xy - np.round(xy))
    edge = np.minimum(np.abs(xy[..., 0]), np.abs(xy[..., 0] - (W - 1)))
    edge = np.minimum(edge, np.minimum(np.abs(xy[..., 1]),
                                       np.abs(xy[..., 1] - (H - 1))))
    return (frac > NEAR_INTEGER).all(-1) & (edge > NEAR_INTEGER)


def _project64(xyz, c2w, intr):
    cam = (np.concatenate([xyz, np.ones_like(xyz[..., :1])], -1)
           @ np.linalg.inv(c2w.astype(np.float64)).T)
    z = np.where(cam[..., 2:3] == 0, 1.0, cam[..., 2:3])
    return ((cam[..., :3] / z) @ intr.astype(np.float64).T)[..., :2]


def plane_case(jc, tc, num_rays=96, num_points=1500, seed=1):
    """(JAX points, grid; port points, grid; batch arrays with the plane
    keys): the synthetic scene and batch with the points and rays whose
    projections lie near an integer pixel dropped (module docstring), and
    view images near the plane colour (noise +-0.05, so that some samples
    fit its +-0.03 window and some do not)."""
    b = tsyn.batch_arrays(tc, seed, 4 * num_rays)
    H, W = tc.image_hw
    c2w, intr = b["c2w_nearest"][0], b["intrinsic_nearest"]
    a = tsyn.scene_arrays(tc, 2 * num_points, 0)
    keep = _far_from_integers(_project64(a["xyz"].astype(np.float64), c2w,
                                         intr), H, W)
    keep &= np.cumsum(keep) <= num_points
    a = {k: v[keep] for k, v in a.items()}
    cross = (b["campos"] + b["raydir"] * (
        (PLANE["plane_pnt"] - b["campos"]) @ PLANE["plane_normal"]
        / (b["raydir"] @ PLANE["plane_normal"]))[:, None]).astype(np.float64)
    ok = _far_from_integers(_project64(cross, c2w, intr), H, W)
    rays = np.flatnonzero(ok)[:num_rays]
    for k in ("raydir", "pixel_idx", "gt_image"):
        b[k] = b[k][rays]
    rng = np.random.default_rng(seed)
    b["images_nearest"] = np.clip(
        PLANE["plane_color"] + rng.uniform(-0.05, 0.05,
                                           b["images_nearest"].shape),
        0, 1).astype(np.float32)
    b.update(PLANE)
    jpts = jnpts.init_from_arrays(
        a["xyz"], jc.points, embedding=a["embedding"], conf=a["conf"],
        color=a["color"], dirs=a["dirs"])
    mask = np.ones(len(a["xyz"]), bool)
    jgrid = JVG.build_grid_jit(
        jpts.xyz, jpts.mask,
        JVG.compute_grid_geometry(a["xyz"], mask, jc.querier), jc.querier)
    tpts = from_jax.points_from_numpy(np.asarray(jpts.table),
                                      np.asarray(jpts.mask),
                                      tc.points.feature_dim, device="cpu")
    tgrid = TVG.build_grid(
        tpts.xyz, tpts.mask,
        TVG.compute_grid_geometry(a["xyz"], mask, tc.querier, device="cpu"),
        tc.querier)
    return (jpts, jgrid), (tpts, tgrid), b


def plane_configs():
    jc, tc = configs()
    return tuple(c.replace(render=dataclasses.replace(
        c.render, bgmodel="img_plane")) for c in (jc, tc))


def test_bilinear_sample():
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(9, 11, 4)).astype(np.float32)
    xy = rng.uniform(-2, 12, (50, 2)).astype(np.float32)
    xy[:3] = [[0, 0], [10, 8], [10.5, 8.5]]      # corners, half outside
    mask = rng.random(50) < 0.8
    want = jwarp.bilinear_sample(jnp.asarray(feat), jnp.asarray(xy),
                                 jnp.asarray(mask))
    got = twarp.bilinear_sample(t(feat), t(xy), t(mask))
    np.testing.assert_allclose(n(got), np.asarray(want), **ELEMENTWISE)


def test_ray_plane_cross():
    rng = np.random.default_rng(4)
    d = rng.normal(size=(40, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0] = [1.0, 0.0, 0.0]                       # parallel to the plane
    campos = np.array([0.1, -0.2, -2.5], np.float32)
    want = jbg.ray_plane_cross(jnp.asarray(campos), jnp.asarray(d),
                               jnp.asarray(PLANE["plane_pnt"]),
                               jnp.asarray(PLANE["plane_normal"]))
    got = tbg.ray_plane_cross(t(campos), t(d), t(PLANE["plane_pnt"]),
                              t(PLANE["plane_normal"]))
    np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    assert 0 < n(got[1]).sum() < 40
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), rtol=1e-6,
                               atol=1e-5)


def test_fg_pixel_mask_and_bg_colors():
    """The splat of every point into each view (exact), and the per-ray
    plane colours with and without the foreground masks."""
    jc, tc = plane_configs()
    (jpts, _), (tpts, _), b = plane_case(jc, tc)
    H, W = tc.image_hw
    w2c = np.linalg.inv(b["c2w_nearest"][0]).astype(np.float32)
    want = jbg.fg_pixel_mask(jpts.xyz, jpts.mask, jnp.asarray(w2c),
                             jnp.asarray(b["intrinsic_nearest"]), H, W)
    got = tbg.fg_pixel_mask(tpts.xyz, tpts.mask, t(w2c),
                            t(b["intrinsic_nearest"]), H, W)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert 0.05 < n(got).mean() < 0.95
    xyz, valid = tbg.ray_plane_cross(t(b["campos"]), t(b["raydir"]),
                                     t(PLANE["plane_pnt"]),
                                     t(PLANE["plane_normal"]))
    w2cs = np.stack([w2c] * len(b["c2w_nearest"]))
    fg = np.stack([np.asarray(want)] * len(w2cs))
    for masks in (None, fg):
        jcol = jbg.bg_ray_colors(
            jnp.asarray(n(xyz)), jnp.asarray(n(valid)),
            jnp.asarray(b["images_nearest"]), jnp.asarray(w2cs),
            jnp.asarray(b["intrinsic_nearest"]),
            jnp.asarray(PLANE["plane_color"]),
            None if masks is None else jnp.asarray(masks))
        tcol = tbg.bg_ray_colors(
            xyz, valid, t(b["images_nearest"]), t(w2cs),
            t(b["intrinsic_nearest"]), t(PLANE["plane_color"]),
            None if masks is None else t(masks))
        np.testing.assert_allclose(n(tcol), np.asarray(jcol), **ELEMENTWISE)
        hit = n(tcol).any(-1)
        assert 0 < hit.sum() < len(hit)


def test_maybe_add_bg_ray_matches_jax():
    """The plane keys become bg_ray, from numpy and from tensor batches;
    without the knob or the keys the batch is returned as it is."""
    jc, tc = plane_configs()
    (jpts, _), (tpts, _), b = plane_case(jc, tc)
    want = jstep.maybe_add_bg_ray(b, jpts, jc)
    for batch in (b, {k: t(v) for k, v in b.items()}):
        got = tstep.maybe_add_bg_ray(batch, tpts, tc)
        assert set(got) == set(want)
        assert not any(k.startswith("plane_") for k in got)
        np.testing.assert_allclose(n(got["bg_ray"]),
                                   np.asarray(want["bg_ray"]), rtol=1e-5,
                                   atol=1e-5)
    assert 0 < n(got["bg_ray"]).any(-1).mean() < 1
    assert tstep.maybe_add_bg_ray(b, tpts, configs()[1]) is b
    no_views = {k: v for k, v in b.items() if k != "images_nearest"}
    assert tstep.maybe_add_bg_ray(no_views, tpts, tc) is no_views


def test_render_with_bg_ray_matches_jax():
    """The renderer composites bg_ray under the background transmission in
    place of the constant background; miss rays come out as bg_ray."""
    jc, tc = plane_configs()
    (jpts, jgrid), (tpts, tgrid), b = plane_case(jc, tc)
    jb = jstep.maybe_add_bg_ray(b, jpts, jc)
    tb = tstep.maybe_add_bg_ray({k: t(v) for k, v in b.items()}, tpts, tc)
    jp, tp = make_params(jc, alpha_bias=1.0)
    want = jrenderer.render(jp, jpts, jgrid,
                            {k: jnp.asarray(v) for k, v in jb.items()}, jc)
    got = trenderer.render(tp, tpts, tgrid, tb, tc)
    np.testing.assert_allclose(n(got["coarse_raycolor"]),
                               np.asarray(want["coarse_raycolor"]), **F32)
    miss = ~n(got["ray_mask"])
    assert 0 < miss.sum() < len(miss)
    np.testing.assert_allclose(n(got["coarse_raycolor"])[miss],
                               n(tb["bg_ray"])[miss], atol=1e-6)
    plain = trenderer.render(tp, tpts, tgrid, {k: t(v) for k, v in b.items()},
                             tc)
    assert not np.allclose(n(plain["coarse_raycolor"])[miss],
                           n(tb["bg_ray"])[miss])


def test_render_rays_cuts_bg_ray_into_chunks():
    """serve.render_rays cuts bg_ray with the rays: a request of three
    chunks renders as one render of all its rays (float32 rtol 1e-5 /
    atol 1e-6: the same operations on fewer rows)."""
    from hybridneuralrendering_tpu_torch import serve
    jc, tc = plane_configs()
    (_, _), (tpts, tgrid), b = plane_case(jc, tc)
    tb = tstep.maybe_add_bg_ray({k: t(v) for k, v in b.items()}, tpts, tc)
    _, tp = make_params(jc, alpha_bias=1.0)
    chunked = tc.replace(sampling=dataclasses.replace(tc.sampling,
                                                      eval_chunk_rays=40))
    got = serve.render_rays(tp, tpts, tgrid, tb, chunked)
    want = trenderer.render(tp, tpts, tgrid, tb, tc)
    np.testing.assert_allclose(n(got["coarse_raycolor"]),
                               n(want["coarse_raycolor"]), **REORDERED)


# ------------------------------------------------------- one training step

def _step_case(name):
    """(jc, tc, JAX state, JAX grid, JAX batch, port grid, port batch,
    bank): the training-step setup of test_torch_port_train with a knob;
    "plane" puts the plane keys into the batch (maybe_add_bg_ray)."""
    if name == "plane":
        jc, tc = plane_configs()
    else:
        jc, tc = knob_configs(**KNOBS[name.replace("_cached", "")])
    loss = dict(use_frame_weight=True)
    jc = jc.replace(loss=dataclasses.replace(jc.loss, **loss))
    tc = tc.replace(loss=dataclasses.replace(tc.loss, **loss))
    if name == "plane":
        (jpts, jgrid), (tpts, tgrid), arrays = plane_case(
            jc, tc, num_rays=tc.sampling.rays_per_batch)
        jarr = jstep.maybe_add_bg_ray(arrays, jpts, jc)
        tarr = tstep.maybe_add_bg_ray(arrays, tpts, tc)
    else:
        (jpts, jgrid), (tpts, tgrid) = make_scene(jc, tc)
        jarr = tarr = tsyn.batch_arrays(tc, seed=1)
    jarr, tarr = dict(jarr, frame_weight=np.float32(0.8)), dict(
        tarr, frame_weight=np.float32(0.8))
    jp, _ = make_params(jc, alpha_bias=ALPHA_BIAS)
    jb = {k: jnp.asarray(v) for k, v in jarr.items()}
    tb = {k: t(v) if not torch.is_tensor(v) else v for k, v in tarr.items()}
    bank = jblur.generate_kernel_bank(jc.blur)
    jst = jstate_mod.create_train_state(jp, jpts, jc)
    return jc, tc, jst, jgrid, jb, tgrid, tb, bank


@pytest.mark.parametrize("name", list(KNOBS) + ["attention_cached",
                                                "plane"])
def test_train_step_matches_jax(name):
    """One train_step with each knob: loss items, every network gradient
    and the table's against JAX's loss_fn (with attention's num_heads
    closed over), and the state after the port's step against JAX's
    train_step where JAX's jit takes the tree (not with attention).
    "attention_cached" is the cached step: stage maps from each
    package's PyramidCache."""
    jc, tc, jst, jgrid, jb, tgrid, tb, bank = _step_case(name)
    tst = _port_state(jst, tc)
    key = jax.random.PRNGKey(41)
    jstaged = tstaged = None
    if name.endswith("_cached"):
        jstaged = (jb["images_nearest"], jpc.PyramidCache(
            jc, dtype=jnp.float32).get_stack(jst.params, jb["images_nearest"],
                                             [0, 1]))
        tstaged = (tb["images_nearest"], tpc.PyramidCache(
            tc, dtype=torch.float32).get_stack(
                tst.params, tb["images_nearest"], range(2)))
    p0, heads = split_heads(jst.params)
    pts_tree = jstate_mod.point_param_tree(jst.points, jc)

    def loss(p, pts):
        return jstep.loss_fn(with_heads(p, heads), pts, jst.points, jgrid, jb,
                             jc, key, jnp.asarray(bank),
                             img_feat_staged=jstaged)

    (_, jitems), (jg_net, jg_pts) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p0, pts_tree)
    noise = t(_noise(key, tc))
    titems, tg_net, tg_table = tstep.loss_and_grads(
        tst, tgrid, tb, t(bank), tc, noise=noise, img_feat_staged=tstaged)
    assert set(titems) == set(jitems)
    for k, v in jitems.items():
        np.testing.assert_allclose(n(titems[k]), np.asarray(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    jl = jax.tree_util.tree_leaves(jg_net)
    tl = tstate.tree_leaves(tg_net)
    assert len(jl) == len(tl) > 20
    for got, want in zip(tl, jl):
        _close_grad(got, want)
    _close_grad(tg_table, jg_pts["table"])
    before = _port_state(jst, tc)
    tst, _ = tstep.train_step(tst, tgrid, tb, t(bank), tc, noise=noise,
                              img_feat_staged=tstaged)
    assert tst.step == 1
    if heads is not None:
        assert tst.params["aggregator"]["attention"]["num_heads"] == heads
        return
    jst, _ = jstep.train_step(jst, jgrid, jb, key, jnp.asarray(bank), jc,
                              jstaged)
    want = _port_state(jst, tc)
    lr = tc.optim.lr
    for got, w, b0, g in zip(tstate.tree_leaves(tst.params),
                             tstate.tree_leaves(want.params),
                             tstate.tree_leaves(before.params), jl):
        _close_update(got, w, b0, g, lr)


# ------------------------------------------------------- float32 alpha head

def test_compute_dtype_alpha_head_is_float32():
    """compute_dtype = bfloat16 with shading_dtype float32: on the same
    block3 output, the port's alpha head equals JAX's float32 einsum head
    within 1e-6 relative, for alpha, the head's dW and its dfeat
    contribution; the bf16-operand head the kernels compute fails the
    same check."""
    jc, tc = configs(compute_dtype="bfloat16")
    jp, tp = make_params(jc)
    assert SC.alpha_head_is_f32(tp["aggregator"], tc.agg)
    assert not SC.alpha_head_is_f32(tp["aggregator"], dataclasses.replace(
        tc.agg, shading_dtype="bfloat16"))
    head = tp["aggregator"]["alpha"][0]
    rng = np.random.default_rng(8)
    ft = np.maximum(rng.normal(size=(500, 128)), 0).astype(np.float32)
    cot = rng.normal(size=(500,)).astype(np.float32)
    jw, jb = jp["aggregator"]["alpha"][0]["w"], jp["aggregator"]["alpha"][0][
        "b"]

    def jhead(f, w):
        return jnp.einsum("...c,c->...", f, w[:, 0]) + jb[0]

    want, vjp = jax.vjp(jhead, jnp.asarray(ft), jw)
    jdf, jdw = vjp(jnp.asarray(cot))

    def rel(a, b):
        return float(np.linalg.norm(n(a).ravel() - np.asarray(b).ravel())
                     / np.linalg.norm(np.asarray(b).ravel()))

    def check(head_fn):
        f = t(ft).requires_grad_(True)
        w = head["w"].detach().clone().requires_grad_(True)
        a = head_fn(f, {"w": w, "b": head["b"]})[:, 0]
        (a * t(cot)).sum().backward()
        return max(rel(a.detach(), want), rel(f.grad, jdf),
                   rel(w.grad, jdw))

    assert check(SC.alpha_head_f32) < 1e-6

    def bf16_operands(f, p):            # the kernels' head in the bf16 chain
        return SC._mm(f, p["w"], torch.bfloat16) + p["b"]

    assert check(bf16_operands) > 1e-6


def test_compute_dtype_chain_uses_float32_head():
    """fused_feat_alpha's alpha under compute_dtype is alpha_head_f32 of its
    feature output (the CPU path; the card's is the same code after
    chain_fwd)."""
    jc, tc = configs(compute_dtype="bfloat16")
    _, tp = make_params(jc)
    chain = {k: tp["aggregator"][k] for k in ("block1", "block3", "alpha")}
    rng = np.random.default_rng(9)
    N = 64
    emb = t(rng.normal(size=(N, 8)).astype(np.float32))
    d = t(rng.normal(size=(N, 6)).astype(np.float32))
    ex = t(rng.normal(size=(N, 7)).astype(np.float32))
    feat, alpha = SC.fused_feat_alpha(chain, tc.agg, emb, d, ex)
    np.testing.assert_array_equal(
        n(alpha), n(SC.alpha_head_f32(feat, chain["alpha"][0])))
    _, bf_alpha = SC.chain_plain(emb, d, ex, chain, tc.agg, "bfloat16")
    assert not np.array_equal(n(alpha), n(bf_alpha))


# ------------------------------------------------------- checkpoints

def _attention_state(jc, seed=0):
    """A JAX TrainState with attention parameters: every float leaf seeded
    noise, num_heads as attention.init makes it (int 1 in the params, int32
    zeros in the moments)."""
    rng = np.random.default_rng(seed)
    pts = jnpts.init_from_arrays(np.zeros((5, 3), np.float32), jc.points)
    params = jrenderer.init_params(jax.random.PRNGKey(0), jc)
    ts = jstate_mod.create_train_state(params, pts, jc)

    def fill(x):
        if isinstance(x, int):
            return x
        a = np.asarray(x)
        if a.dtype == np.int32 and a.shape == () and not a.any():
            return x                          # a moment of num_heads
        if a.dtype == bool:
            return jnp.asarray(rng.random(a.shape) < 0.6)
        if a.dtype.kind == "f":
            return jnp.asarray(rng.normal(size=a.shape).astype(np.float32))
        return x

    ts = jax.tree_util.tree_map(fill, ts)
    return ts._replace(points=ts.points._replace(
        num_live=jnp.sum(ts.points.mask.astype(jnp.int32))))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_attention_checkpoint_both_ways(tmp_path, writer):
    """A state with attention parameters: JAX save -> port load, and port
    save -> JAX load, leaf for leaf (num_heads carried as an int)."""
    jc, tc = configs(tradition_attention=True)
    ts = _attention_state(jc, seed=5)
    path = jck.save_checkpoint(str(tmp_path / "jax"), ts, best_psnr=2.5)
    st, _ = tck.load_checkpoint(path, tc, device="cpu")
    att = st.params["aggregator"]["attention"]
    assert att["num_heads"] == 1 and isinstance(att["num_heads"], int)
    want = jax_flat(ts)
    assert want["params/aggregator/attention/num_heads"].dtype == np.int64
    if writer == "port":
        # the port's file holds JAX's arrays, dtypes included
        port = tck.save_checkpoint(str(tmp_path / "port"), st, 2.5)
        with np.load(path) as a, np.load(port) as b:
            assert_flat_equal({k: b[k] for k in b.files},
                              {k: a[k] for k in a.files})
        # and loads in JAX (whose loader makes the int64 leaf int32: jax
        # runs without x64)
        back, _ = jck.load_checkpoint(port, jck_template(jc))
        got = jax_flat(back)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    else:
        flat = tck.flatten_state(st)
        del flat["__best_psnr__"]
        assert_flat_equal(flat, want)


def jck_template(jc):
    pts = jnpts.init_from_arrays(np.zeros((1, 3), np.float32), jc.points)
    return jstate_mod.create_train_state(
        jrenderer.init_params(jax.random.PRNGKey(0), jc), pts, jc)
