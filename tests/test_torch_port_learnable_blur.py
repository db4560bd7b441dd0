"""The port's learnable blur kernel (models/blur.learnable_blur_update, the
blur MLP of aggregator.init and the training steps that run it) against
the JAX package, on the CPU.

Same numpy inputs and weights go to both packages.  Tolerances:

- learnable_blur_update: the MLP's matmuls and the grouped convolution sum
  in another order on XLA than in torch: outputs rtol 1e-5 / atol 1e-6;
  the gradients with respect to the render and to every blur-MLP leaf
  rtol 1e-4 / atol 1e-5 * max|g| of the leaf.
- the training steps (tiny_test with the learnable kernel, patches of 4
  rays, a 9 x 9 kernel, mode 4, boundary 0): the tolerances of
  tests/test_torch_port_train.py (loss items rtol 1e-4 / atol 1e-6;
  gradients rtol 1e-3 / atol 1e-4 * max|g|; parameters after the step
  where |g| clears the noise, rtol 1e-4 / atol 1e-3 * lr).  JAX's
  gradients are read from its first moment after one step from zero
  moments, (1 - beta1) * g.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu.models import aggregator as jagg
from hybridneuralrendering_tpu.models import blur as jblur
from hybridneuralrendering_tpu.models import mlp as jmlp
from hybridneuralrendering_tpu.train import pyramid_cache as jpc
from hybridneuralrendering_tpu.train import state as jstate_mod
from hybridneuralrendering_tpu.train import step as jstep
from hybridneuralrendering_tpu_torch.data import synthetic as tsyn
from hybridneuralrendering_tpu_torch.io import from_jax
from hybridneuralrendering_tpu_torch.models import aggregator as tagg
from hybridneuralrendering_tpu_torch.models import blur as tblur
from hybridneuralrendering_tpu_torch.train import pyramid_cache as tpc
from hybridneuralrendering_tpu_torch.train import state as tstate
from hybridneuralrendering_tpu_torch.train import step as tstep
from test_torch_port_train import (ALPHA_BIAS, _close_grad, _close_update,
                                   _noise, _port_state)
from torch_port_common import (  # noqa: F401  (one_torch_thread: fixture)
    configs, make_params, make_scene, n, one_torch_thread, t)

PATCH_NUM, PATCH_SIZE = 2, 4
# the learnable kernel on tiny_test: its MLP reads patches of tiny_test's 4
LEARNABLE = dict(learnable_blur_kernel=True, learnable_blur_patch_size=4)


def _blur_case(K, norm, mode, boundary, seed=0):
    """(JAX agg config, port agg config, JAX blur-MLP params, port params,
    rendered [R, 3], gt [R, 3], cotangent [R, 3]) as numpy."""
    jc, tc = configs(**LEARNABLE, learnable_blur_kernel_size=K,
                     learnable_blur_kernel_norm=norm,
                     learnable_blur_kernel_mode=mode, boundary_mode=boundary)
    dims = [2 * PATCH_SIZE ** 2, 128, 128, 128,
            K * K + (1 if mode in (2, 4) else 0)]
    mlp_np = jax.tree_util.tree_map(
        np.asarray, jmlp.mlp_init(jax.random.PRNGKey(seed), dims,
                                  jc.agg.act_type))
    rng = np.random.default_rng(seed)
    R = (PATCH_NUM * PATCH_SIZE) ** 2
    rendered, gt, cot = (rng.uniform(0, 1, (R, 3)).astype(np.float32)
                         for _ in range(3))
    return jc.agg, tc.agg, mlp_np, rendered, gt, cot


def _jax_blur(jcfg, mlp_np, rendered, gt, cot):
    def f(p, r):
        out = jblur.learnable_blur_update({"blur_kernel": p}, jcfg, r,
                                          jnp.asarray(gt), PATCH_NUM,
                                          PATCH_SIZE)
        return jnp.sum(out * cot), out
    p = jax.tree_util.tree_map(jnp.asarray, mlp_np)
    (_, out), (gp, gr) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        p, jnp.asarray(rendered))
    return np.asarray(out), jax.tree_util.tree_leaves(gp), np.asarray(gr)


def _port_blur(tcfg, mlp_np, rendered, gt, cot):
    p = from_jax.params_from_numpy(mlp_np, device="cpu")
    p = tstate.tree_map(lambda x: x.requires_grad_(True), p)
    r = t(rendered).requires_grad_(True)
    out = tblur.learnable_blur_update({"blur_kernel": p}, tcfg, r, t(gt),
                                      PATCH_NUM, PATCH_SIZE)
    torch.sum(out * t(cot)).backward()
    return out, [x.grad for x in tstate.tree_leaves(p)], r.grad


def _close_blur_grad(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(n(got), want, rtol=1e-4,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("boundary", [0, 1, 2])
@pytest.mark.parametrize("mode", [0, 4])
@pytest.mark.parametrize("norm", [0, 1])
def test_learnable_blur_update_matches_jax(norm, mode, boundary, K):
    jcfg, tcfg, mlp_np, rendered, gt, cot = _blur_case(K, norm, mode,
                                                       boundary)
    jout, jgp, jgr = _jax_blur(jcfg, mlp_np, rendered, gt, cot)
    out, gp, gr = _port_blur(tcfg, mlp_np, rendered, gt, cot)
    np.testing.assert_allclose(n(out), jout, rtol=1e-5, atol=1e-6)
    assert not np.allclose(jout, rendered, atol=1e-3)     # it blurs
    _close_blur_grad(gr, jgr)
    assert len(gp) == len(jgp) == 8
    for got, want in zip(gp, jgp):
        _close_blur_grad(got, want)
    assert all(np.abs(np.asarray(g)).max() > 0 for g in jgp)


def test_learnable_blur_boundary_3_raises_in_both():
    jcfg, tcfg, mlp_np, rendered, gt, cot = _blur_case(3, 0, 4, 3)
    with pytest.raises(NotImplementedError):
        _jax_blur(jcfg, mlp_np, rendered, gt, cot)
    with pytest.raises(NotImplementedError):
        _port_blur(tcfg, mlp_np, rendered, gt, cot)


@pytest.mark.parametrize("mode", [0, 2, 4])
def test_aggregator_init_blur_kernel_shapes_match_jax(mode):
    jc, tc = configs(**LEARNABLE, learnable_blur_kernel_mode=mode)
    want = jax.eval_shape(lambda k: jagg.init(k, jc.agg),
                          jax.random.PRNGKey(0))["blur_kernel"]
    got = tagg.init(torch.Generator().manual_seed(0), tc.agg,
                    device="cpu")["blur_kernel"]
    assert [(tuple(l["w"].shape), tuple(l["b"].shape)) for l in got] == [
        (tuple(l["w"].shape), tuple(l["b"].shape)) for l in want]
    assert got[-1]["w"].shape[1] == 81 + (mode != 0)
    off = tagg.init(torch.Generator().manual_seed(0), configs()[1].agg,
                    device="cpu")
    assert "blur_kernel" not in off


# ------------------------------------------------------- the training steps

def _learnable_setup():
    jc, tc = configs(**LEARNABLE)
    loss = dict(use_frame_weight=True)
    jc = jc.replace(loss=dataclasses.replace(jc.loss, **loss))
    tc = tc.replace(loss=dataclasses.replace(tc.loss, **loss))
    (jpts, jgrid), (tpts, tgrid) = make_scene(jc, tc)
    jp, _ = make_params(jc, alpha_bias=ALPHA_BIAS)
    jst = jstate_mod.create_train_state(jp, jpts, jc)
    return jc, tc, jst, jgrid, tgrid


def _batch(tc, seed, weight):
    a = tsyn.batch_arrays(tc, seed=seed)
    a["frame_weight"] = np.float32(weight)
    return a


@pytest.fixture(scope="module", params=["uncached", "cached", "multi"])
def learnable_step(request):
    """Both packages from one state through one step with the learnable
    kernel: train_step, the cached train_step (stage maps through each
    package's float32 PyramidCache) or train_step_multi of 2 frames."""
    kind = request.param
    jc, tc, jst, jgrid, tgrid = _learnable_setup()
    bank = jnp.asarray(jblur.generate_kernel_bank(jc.blur))
    tbank = t(np.asarray(bank))
    tst = _port_state(jst, tc)
    before = _port_state(jst, tc)
    key = jax.random.PRNGKey(51)
    if kind == "multi":
        frames = [_batch(tc, 1, 0.8), _batch(tc, 2, 0.9)]
        jb = jstep.stack_batches([{k: jnp.asarray(v) for k, v in f.items()}
                                  for f in frames])
        tb = tstep.stack_batches([{k: t(v) for k, v in f.items()}
                                  for f in frames])
        noise = torch.stack([t(_noise(k, tc))
                             for k in jax.random.split(key, 2)])
        titems, tg_net, tg_table = tstep.multi_loss_and_grads(
            tst, tgrid, tb, tbank, tc, noise=noise)
        jst, jitems = jstep.train_step_multi(jst, jgrid, jb, key, bank, jc)
        tst, items2 = tstep.train_step_multi(tst, tgrid, tb, tbank, tc,
                                             noise=noise)
    else:
        a = _batch(tc, 1, 0.8)
        jb = {k: jnp.asarray(v) for k, v in a.items()}
        tb = {k: t(v) for k, v in a.items()}
        jstaged = tstaged = None
        if kind == "cached":
            views = range(len(a["images_nearest"]))
            jstaged = (jb["images_nearest"], jpc.PyramidCache(
                jc, dtype=jnp.float32).get_stack(
                    jst.params, jb["images_nearest"], views))
            tstaged = (tb["images_nearest"], tpc.PyramidCache(
                tc, dtype=torch.float32).get_stack(
                    tst.params, tb["images_nearest"], views))
        noise = t(_noise(key, tc))
        titems, tg_net, tg_table = tstep.loss_and_grads(
            tst, tgrid, tb, tbank, tc, noise=noise, img_feat_staged=tstaged)
        jst, jitems = jstep.train_step(jst, jgrid, jb, key, bank, jc,
                                       jstaged)
        tst, items2 = tstep.train_step(tst, tgrid, tb, tbank, tc,
                                       noise=noise, img_feat_staged=tstaged)
    c1 = 1.0 - jc.optim.beta1
    jg_net = jax.tree_util.tree_map(lambda m: np.asarray(m) / c1,
                                    jst.opt_state_net[0].mu)
    jg_table = np.asarray(jst.opt_state_pts[0].mu["table"]) / c1
    return dict(tc=tc, kind=kind, jitems=jitems, titems=titems,
                items2=items2, jg_net=jg_net, tg_net=tg_net,
                jg_table=jg_table, tg_table=tg_table, before=before,
                jst=_port_state(jst, tc), tst=tst)


def test_learnable_step_loss_items(learnable_step):
    s = learnable_step
    keys = set(s["titems"]) - {"ray_hit_frac"}
    assert keys == set(s["jitems"]) - {"ray_hit_frac"} and len(keys) > 2
    for k in keys:
        np.testing.assert_allclose(n(s["titems"][k]),
                                   np.asarray(s["jitems"][k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        assert float(s["items2"][k]) == float(s["titems"][k])


def test_learnable_step_network_gradients(learnable_step):
    """Every network leaf as JAX's, the blur MLP's among them and moved."""
    s = learnable_step
    want = s["jg_net"]["aggregator"]
    got = s["tg_net"]["aggregator"]
    assert set(got) == set(want) and "blur_kernel" in got
    for name in got:
        tl, jl = tstate.tree_leaves(got[name]), jax.tree_util.tree_leaves(
            want[name])
        assert len(tl) == len(jl)
        for g, w in zip(tl, jl):
            assert tuple(g.shape) == tuple(w.shape), name
            _close_grad(g, w)
    blur = tstate.tree_leaves(got["blur_kernel"])
    assert len(blur) == 8 and all(float(g.abs().max()) > 0 for g in blur)


def test_learnable_step_table_gradient(learnable_step):
    s = learnable_step
    _close_grad(s["tg_table"], s["jg_table"])
    g = n(s["tg_table"])
    assert not g[:, :3].any() and np.abs(g[:, 3:]).max() > 0


def test_learnable_step_state_after(learnable_step):
    s = learnable_step
    got, want, before = s["tst"], s["jst"], s["before"]
    assert got.step == want.step == 1
    assert got.opt_net.count == want.opt_net.count == 1
    o = s["tc"].optim
    _close_grad(got.opt_pts.mu, want.opt_pts.mu)
    _close_update(got.points.table, n(want.points.table),
                  n(before.points.table), s["jg_table"], o.plr)
    agg_got, agg_want = got.params["aggregator"], want.params["aggregator"]
    for name in agg_got:
        for gp, wp, bp, g in zip(
                tstate.tree_leaves(agg_got[name]),
                tstate.tree_leaves(agg_want[name]),
                tstate.tree_leaves(before.params["aggregator"][name]),
                jax.tree_util.tree_leaves(s["jg_net"]["aggregator"][name])):
            _close_update(gp, n(wp), n(bp), g, o.lr)
    moved = [bool((gp != bp).any()) for gp, bp in zip(
        tstate.tree_leaves(agg_got["blur_kernel"]),
        tstate.tree_leaves(before.params["aggregator"]["blur_kernel"]))]
    assert all(moved)
