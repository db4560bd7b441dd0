"""Feed-forward training in the port (hybridneuralrendering_tpu_torch/
train/step_ff.py, cli/train.py --train-mode ff) against the JAX package,
on the CPU.

The case is JAX's own (tests/test_mvs.py TestFeedForwardTraining):
tiny_test without image fusion, drop or blur, near 1 / far 3, three
32x40 views, D = 8; the learned ProbNet mode and the pretrained-MVSNet mode
(conf threshold MVSNET_THRESH).  Weights are seeded numpy trees of JAX's shapes
carried across (io/from_jax), the candidate noise JAX's draw from the
step's key.  JAX runs jitted.  Tolerances:

- the generated points: the mask and the live count equal; the table
  rtol 1e-5 / atol 1e-5 * max|table| (convolution and product order);
  no confidence lies within CONF_MARGIN (4x the confidences' tolerance)
  of the threshold;
- the loss items: rtol 1e-5 / atol 1e-6;
- gradients: rtol 1e-3 / atol 1e-3 * the group's largest |g|.  The MVS
  group's volume gradients cancel (the softmax over D sums each pixel's
  score gradients to zero), and the first 3D layer's bias and statistics
  gradients, sums of those over the whole volume, agree only to about 1%
  of their own size; the group's scale bounds them;
- the state after a step: Adam's first step moves each element by about
  +-lr whatever its gradient's size, so an element whose gradient lies
  within the rounding noise can move the other way.  Parameters are
  compared where |g| > 2e-3 * the group's largest |g| (rtol 1e-4 /
  atol 1e-3 * lr), the moments everywhere with the gradient tolerance;

The CLIs' feed-forward runs are in tests/test_torch_port_ff_cli.py.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu import config as JC
from hybridneuralrendering_tpu.models import losses as jlosses
from hybridneuralrendering_tpu.models import renderer as jren
from hybridneuralrendering_tpu.mvs import point_gen as JP
from hybridneuralrendering_tpu.ops import voxel_grid as JVG
from hybridneuralrendering_tpu.train import step_ff as JFF
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch.io import from_jax
from hybridneuralrendering_tpu_torch.models import losses as tlosses
from hybridneuralrendering_tpu_torch.models import neural_points as tnpts
from hybridneuralrendering_tpu_torch.models import renderer as tren
from hybridneuralrendering_tpu_torch.mvs import features as TF
from hybridneuralrendering_tpu_torch.mvs import point_gen as TP
from hybridneuralrendering_tpu_torch.ops import voxel_grid as TVG
from hybridneuralrendering_tpu_torch.train import state as TS
from hybridneuralrendering_tpu_torch.train import step_ff as TFF
from torch_port_common import (  # noqa: F401  (one_torch_thread: fixture)
    jax_tree, n, numpy_mvs_params, numpy_params, one_torch_thread, t)

CPU = "cpu"
D = 8
# the MVSNet mode's confidence threshold: random weights' confidences lie
# near 0.49; this one keeps about half of the case's 80 points, and no
# confidence lies within CONF_MARGIN of it (test_generate_points)
MVSNET_THRESH = 0.4919
CONF_MARGIN = 2e-5
GRAD_TOL = 1e-3


def _cfg(pkg):
    cfg = pkg.tiny_test()
    return cfg.replace(
        agg=dataclasses.replace(cfg.agg, use_nearest=0, drop_ratio=0.0),
        render=pkg.RenderConfig(near_plane=1.0, far_plane=3.0),
        blur=pkg.BlurConfig(add_blur_sim=False))


def _inputs():
    rng = np.random.default_rng(0)
    jc = _cfg(JC)
    V, H, W = 3, 32, 40
    images = rng.uniform(0, 1, (V, H, W, 3)).astype(np.float32)
    intr = np.asarray([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]],
                      np.float32)
    w2cs = np.stack([np.eye(4, dtype=np.float32)] * V)
    for v in range(1, V):
        w2cs[v][:3, 3] = rng.normal(0, 0.05, 3)
    R = jc.sampling.rays_per_batch
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs[:, 2] = np.abs(dirs[:, 2]) + 1.0
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays = {"campos": np.zeros(3, np.float32),
            "camrotc2w": np.eye(3, dtype=np.float32), "raydir": dirs,
            "gt_image": rng.uniform(0, 1, (R, 3)).astype(np.float32),
            "bg_color": np.ones(3, np.float32)}
    group = {"images": images, "intrinsic": intr, "w2cs": w2cs}
    return group, rays


class Case:
    """Both packages' inputs for one mode ("learned" or "mvsnet")."""

    def __init__(self, mode):
        self.mode = mode
        self.learned = mode == "learned"
        self.thresh = 0.0 if self.learned else MVSNET_THRESH
        self.jc, self.tc = _cfg(JC), _cfg(TC)
        group, rays = _inputs()
        self.jgroup = {k: jnp.asarray(v) for k, v in group.items()}
        self.tgroup = {k: t(v) for k, v in group.items()}
        self.jrays = {k: jnp.asarray(v) for k, v in rays.items()}
        self.trays = {k: t(v) for k, v in rays.items()}
        zero = np.zeros((1, 3), np.float32)
        self.jgeom = JVG.compute_grid_geometry(zero, np.zeros(1, bool),
                                               self.jc.querier)
        self.tgeom = TVG.compute_grid_geometry(zero, np.zeros(1, bool),
                                               self.tc.querier, device=CPU)
        fd = self.jc.points.feature_dim
        self.mvs_np = numpy_mvs_params(lambda k: JP.init(
            k, fd, use_mvsnet=not self.learned,
            use_probnet=self.learned), 1)
        self.params_np = numpy_params(
            lambda k: jren.init_params(k, self.jc), 2)
        # step i's key is fold_in(base, i); the loss tests use step 0's
        self.base = jax.random.PRNGKey(5)
        self.key = jax.random.fold_in(self.base, 0)
        R, Z = len(rays["raydir"]), self.jc.querier.z_depth_dim
        self.noise = t(np.asarray(jax.random.uniform(self.key, (R, Z))))

    def jstate(self):
        return JFF.create_ff_state(jax_tree(self.params_np),
                                   jax_tree(self.mvs_np), self.jc)

    def tstate(self):
        return TFF.create_ff_state(
            from_jax.params_from_numpy(self.params_np, CPU),
            from_jax.mvs_params_from_numpy(self.mvs_np, CPU), self.tc,
            device=CPU)

    def jax_loss_and_grads(self):
        f = jax.jit(jax.value_and_grad(JFF.ff_loss_fn, argnums=(0, 1),
                                       has_aux=True),
                    static_argnums=(5, 7, 8, 9))
        s = self.jstate()
        return f(s.params, s.mvs_params, self.jgroup, self.jrays, self.jgeom,
                 self.jc, self.key, D, self.learned, self.thresh)

    def port_grads(self, state=None):
        return TFF.loss_and_grads_ff(state or self.tstate(), self.tgroup,
                                     self.trays, self.tgeom, self.tc,
                                     self.noise, D, self.learned,
                                     self.thresh)

    def jax_steps(self, k):
        s = self.jstate()
        out = []
        for i in range(k):
            s, items = JFF.train_step_ff(
                s, self.jgroup, self.jrays, self.jgeom,
                jax.random.fold_in(self.base, i), self.jc, num_depths=D,
                learned=self.learned, conf_thresh=self.thresh)
            out.append((jax.tree_util.tree_map(np.asarray, s), items))
        return out

    def port_steps(self, k, state=None):
        s = state or self.tstate()
        R, Z = self.trays["raydir"].shape[0], self.tc.querier.z_depth_dim
        out = []
        for i in range(k):
            noise = t(np.asarray(jax.random.uniform(
                jax.random.fold_in(self.base, i), (R, Z))))
            s, items = TFF.train_step_ff(
                s, self.tgroup, self.trays, self.tgeom, self.tc, noise,
                num_depths=D, learned=self.learned, conf_thresh=self.thresh)
            # a copy: the next step updates the state's tensors in place
            out.append(([x.clone() if torch.is_tensor(x) else x
                         for x in TFF.ff_leaves(s)], items))
        return out


@pytest.fixture(scope="module", params=["learned", "mvsnet"])
def case(request):
    c = Case(request.param)
    c.jax_grads = c.jax_loss_and_grads()
    return c


def _jax_ff_leaves(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


def _grads_agree(got, want):
    """Every leaf of one group within the gradient tolerance; returns the
    worst error over the group's scale."""
    got = [n(x) for x in TFF._jax_order(got)]
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for w in want)
    worst = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = np.abs(g - w) - GRAD_TOL * np.abs(w)
        worst = max(worst, float(err.max()) / scale)
    return worst


def test_generate_points(case):
    jpts = jax.jit(JFF.generate_points, static_argnums=(2, 3, 4, 5))(
        jax_tree(case.mvs_np), case.jgroup, case.jc, D, case.learned,
        case.thresh)
    tpts = TFF.generate_points(
        from_jax.mvs_params_from_numpy(case.mvs_np, CPU), case.tgroup,
        case.tc, D, case.learned, case.thresh)
    assert np.array_equal(n(tpts.mask), np.asarray(jpts.mask))
    assert tpts.num_live == int(jpts.num_live) > 0
    want = np.asarray(jpts.table)
    np.testing.assert_allclose(n(tpts.table), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    assert tpts.table.shape == (8 * 10, tnpts.table_width(8))
    assert tpts.trainable == (True,) * 5
    if not case.learned:
        _, conf, _ = JP.gen_points(jax_tree(case.mvs_np), case.jgroup[
            "images"], case.jgroup["intrinsic"], case.jgroup["w2cs"], 1.0,
            3.0, D, conf_thresh=case.thresh)
        conf = np.asarray(conf)
        assert (np.abs(conf - case.thresh) > CONF_MARGIN).all()
        assert 0 < (conf > case.thresh).sum() < conf.size


def test_ff_loss_and_every_gradient_leaf(case):
    (jl, jitems), (jg_net, jg_mvs) = case.jax_grads
    items, g_net, g_mvs = case.port_grads()
    assert float(items["loss_total"]) == pytest.approx(float(jl), rel=1e-5,
                                                       abs=1e-6)
    for k, v in jitems.items():
        assert float(items[k]) == pytest.approx(float(v), rel=1e-5,
                                                abs=1e-6), k
    assert _grads_agree(g_net, jg_net) <= 1e-3
    assert _grads_agree(g_mvs, jg_mvs) <= 1e-3
    # BN statistics take gradients, the conv bias JAX keeps takes zeros
    bn = g_mvs.feature["c1b"]["bn"]
    assert float(bn["mean"].abs().max()) > 0
    assert float(bn["var"].abs().max()) > 0
    assert float(g_mvs.feature["c1b"]["conv"]["b"].abs().max()) == 0.0
    assert float(np.abs(np.asarray(
        jg_mvs.feature["c1b"]["conv"]["b"])).max()) == 0.0


def test_table_gradient_reaches_xyz_as_in_jax(case):
    """The gradient of the loss in the generated table, xyz columns
    included: the port passes a gradient to xyz exactly where JAX does
    (the gather's backward; the query reads the detached grid)."""
    jpts = jax.jit(JFF.generate_points, static_argnums=(2, 3, 4, 5))(
        jax_tree(case.mvs_np), case.jgroup, case.jc, D, case.learned,
        case.thresh)
    params = jax_tree(case.params_np)

    def jloss(table):
        pts = dataclasses.replace(jpts, table=table)
        grid = JVG.build_grid(jax.lax.stop_gradient(pts.xyz), pts.mask,
                              case.jgeom, case.jc.querier)
        out = jren.render(params, pts, grid, case.jrays, case.jc,
                          key=case.key, train=True)
        return jlosses.compute_losses(out, case.jrays["gt_image"],
                                      case.jc.loss, None)[0]

    want = np.asarray(jax.jit(jax.grad(jloss))(jpts.table))
    table = t(np.asarray(jpts.table)).requires_grad_(True)
    pts = tnpts.NeuralPoints(table=table, mask=t(np.asarray(jpts.mask)),
                             num_live=int(jpts.num_live), feature_dim=8,
                             trainable=(True,) * 5)
    grid = TVG.build_grid(pts.xyz.detach(), pts.mask, case.tgeom,
                          case.tc.querier)
    out = tren.render(from_jax.params_from_numpy(case.params_np, CPU), pts,
                      grid, case.trays, case.tc, train=True,
                      noise=case.noise)
    tlosses.compute_losses(out, case.trays["gt_image"], case.tc.loss,
                           None)[0].backward()
    got = n(table.grad)
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-4 * np.abs(want).max())
    assert (np.abs(want[:, :3]) > 0).any()
    assert np.array_equal(np.abs(got[:, :3]) > 0, np.abs(want[:, :3]) > 0)


def _step_leaves_agree(got, want, grads, lr_of, b1=0.9):
    """ff_leaves after one step against JAX's: ints equal; parameters
    where the step's gradient is clear of the noise; the first moments
    ((1 - b1) g) with the gradient tolerance.  `grads` [(leaf index, |g|,
    group scale)], lr_of(index)."""
    assert len(got) == len(want)
    n_par = len(grads)
    n_net = sum(1 for _, _, s in grads if s == grads[0][2])
    mu_of = {}
    for j, (i, _, scale) in enumerate(grads):
        if j < n_net:           # after step, params, the net Adam's count
            mu_of[i] = 1 + n_par + 1 + j
        else:                   # ... mu/nu of net, 2 counts, then mvs mu
            mu_of[i] = 1 + n_par + 1 + 2 * n_net + 2 + (j - n_net)
    for i, _, scale in grads:
        np.testing.assert_allclose(
            n(got[mu_of[i]]), want[mu_of[i]], rtol=GRAD_TOL,
            atol=GRAD_TOL * (1 - b1) * scale)
    for i, (g, w) in enumerate(zip(got, want)):
        g = n(g) if torch.is_tensor(g) else np.asarray(g)
        assert g.shape == w.shape, i
        if w.dtype.kind in "iu":
            assert np.array_equal(g, w), i
    for i, absg, scale in grads:
        g, w = n(got[i]), want[i]
        clear = absg > 2e-3 * scale
        lr = lr_of(i)
        np.testing.assert_allclose(g[clear], w[clear], rtol=1e-4,
                                   atol=1e-3 * lr)


def _grad_index(case, state_leaves_fn):
    """(leaf index in ff_leaves, |g| of the first step, group scale) of
    every parameter leaf, and lr by index."""
    (_, _), (jg_net, jg_mvs) = case.jax_grads
    out, lrs = [], {}
    i = 1
    o = case.jc.optim
    for grads, lr in ((jg_net, o.lr), (jg_mvs, o.mvs_lr)):
        leaves = [np.abs(np.asarray(x))
                  for x in jax.tree_util.tree_leaves(grads)]
        scale = max(float(x.max()) for x in leaves)
        for x in leaves:
            out.append((i, x, scale))
            lrs[i] = lr
            i += 1
    return out, lrs.get


def test_one_and_two_steps(case):
    grads, lr_of = _grad_index(case, None)
    jsteps = case.jax_steps(2)
    tsteps = case.port_steps(2)
    for k, ((js, jitems), (tl, titems)) in enumerate(zip(jsteps, tsteps)):
        want = _jax_ff_leaves(js)
        assert int(want[0]) == k + 1
        assert float(titems["loss_total"]) == pytest.approx(
            float(jitems["loss_total"]), rel=1e-4, abs=1e-6)
        if k == 0:
            _step_leaves_agree(tl, want, grads, lr_of)
    # after two steps: parameters within two steps' worth of lr
    tl, want = tsteps[1][0], _jax_ff_leaves(jsteps[1][0])
    for i, _, _ in grads:
        np.testing.assert_allclose(n(tl[i]), want[i], rtol=1e-4,
                                   atol=2 * lr_of(i) + 1e-6)


def test_ff_checkpoint_both_ways(case, tmp_path):
    """Port save -> JAX load_ff_checkpoint and JAX save -> port load, leaf
    for leaf equal."""
    state = case.tstate()
    state, _ = TFF.train_step_ff(state, case.tgroup, case.trays, case.tgeom,
                                 case.tc, case.noise, num_depths=D,
                                 learned=case.learned,
                                 conf_thresh=case.thresh)
    path = TFF.save_ff_checkpoint(str(tmp_path / "port"), state)
    assert os.path.basename(path) == "ff_00000001.npz"
    jback = JFF.load_ff_checkpoint(path, case.jstate())
    mine = TFF.ff_leaves(state)
    theirs = jax.tree_util.tree_leaves(jback)
    assert len(mine) == len(theirs) > 100
    for a, b in zip(mine, theirs):
        a = n(a) if torch.is_tensor(a) else np.asarray(a)
        assert a.dtype == np.asarray(b).dtype
        assert np.array_equal(a, np.asarray(b))
    # JAX's state after its step, saved by JAX, loaded by the port
    js = case.jax_steps(1)[0][0]
    jpath = JFF.save_ff_checkpoint(str(tmp_path / "jax"),
                                   jax.tree_util.tree_map(jnp.asarray, js))
    back = TFF.load_ff_checkpoint(jpath, case.tstate(), device=CPU)
    assert back.step == 1 and back.opt_mvs.count == 1
    for a, b in zip(TFF.ff_leaves(back), _jax_ff_leaves(js)):
        a = n(a) if torch.is_tensor(a) else np.asarray(a)
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# planted faults: each must fail the comparison with JAX
# ---------------------------------------------------------------------------

def test_planted_detached_table_is_rejected(case, monkeypatch):
    real = TFF.table_of
    monkeypatch.setattr(TFF, "table_of", lambda *a: real(*a).detach())
    _, g_net, g_mvs = case.port_grads()
    (_, _), (jg_net, jg_mvs) = case.jax_grads
    assert all(float(x.abs().max()) == 0 for x in TS.tree_leaves(g_mvs))
    assert _grads_agree(g_mvs, jg_mvs) > 0.5


def test_planted_torch_transpose_conv_is_rejected(case, monkeypatch):
    """features.py's upsampling in torch's formulation: the learned mode's
    gradients (or loss) disagree with JAX; the MVSNet mode, which runs
    mvsnet.py's own upsampling, is untouched."""

    def torch_style(x, w):
        wt = torch.flip(w, dims=(0, 1, 2)).permute(3, 4, 0, 1, 2)
        return torch.nn.functional.conv_transpose3d(
            x, wt, stride=2, padding=1, output_padding=1)

    monkeypatch.setattr(TF, "conv_transpose_same", torch_style)
    items, _, g_mvs = case.port_grads()
    (jl, _), (_, jg_mvs) = case.jax_grads
    if not case.learned:
        assert _grads_agree(g_mvs, jg_mvs) <= 1e-3
        return
    assert _grads_agree(g_mvs, jg_mvs) > 1e-2 or abs(
        float(items["loss_total"]) - float(jl)) > 1e-4


def _drop_bn_stats(tree):
    if isinstance(tree, dict):
        return {k: _drop_bn_stats(v) for k, v in tree.items()
                if not (k in ("mean", "var") and torch.is_tensor(v))}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(None if v is None else _drop_bn_stats(v)
                            for v in tree))
    if isinstance(tree, list):
        return [_drop_bn_stats(v) for v in tree]
    return tree


def test_planted_bn_stats_out_of_the_mvs_adam_is_rejected(case,
                                                         monkeypatch):
    real = TFF.adam_tree

    def without_stats(params, grads, opt, base_lr, o):
        if not isinstance(params, TP.MvsPointsParams):
            return real(params, grads, opt, base_lr, o)
        tmp = TS.AdamState(_drop_bn_stats(opt.mu), _drop_bn_stats(opt.nu),
                           opt.count)
        real(_drop_bn_stats(params), _drop_bn_stats(grads), tmp, base_lr, o)
        opt.count = tmp.count

    grads, lr_of = _grad_index(case, None)
    want = _jax_ff_leaves(case.jax_steps(1)[0][0])
    monkeypatch.setattr(TFF, "adam_tree", without_stats)
    got = case.port_steps(1)[0][0]
    with pytest.raises(AssertionError):
        _step_leaves_agree(got, want, grads, lr_of)
