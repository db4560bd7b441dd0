"""The port's checkpoints against the JAX package's file format
(hybridneuralrendering_tpu_torch/train/checkpoint.py vs
hybridneuralrendering_tpu/train/checkpoint.py).

A file saved by either package loads in the other, and every leaf is
equal, dtypes included (tolerance: none, the arrays are copied).  The
round-2 fixture checkpoint's per-attribute layout is stacked into the
table as the JAX loader stacks it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu import config as JC
from hybridneuralrendering_tpu.models import neural_points as jnpts
from hybridneuralrendering_tpu.models import renderer as jrenderer
from hybridneuralrendering_tpu.train import checkpoint as jck
from hybridneuralrendering_tpu.train import state as jstate
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch.train import checkpoint as tck

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".fixture/ckpts/roomsim_full/ckpt/"
    "2000_state.npz")
CPU = "cpu"


def jax_template(jc, n_live=1):
    pts = jnpts.init_from_arrays(np.zeros((n_live, 3), np.float32),
                                 jc.points)
    params = jrenderer.init_params(jax.random.PRNGKey(0), jc)
    return jstate.create_train_state(params, pts, jc)


def jax_state(jc, seed=0):
    """A JAX TrainState whose every leaf is seeded noise: params, the
    table, a ragged mask, both Adams' moments, counts and the step."""
    rng = np.random.default_rng(seed)
    ts = jax_template(jc, n_live=5)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.int32:
            return jnp.asarray(rng.integers(1, 1000, x.shape), jnp.int32)
        if x.dtype == bool:
            return jnp.asarray(rng.random(x.shape) < 0.6)
        return jnp.asarray(rng.normal(size=x.shape).astype(np.float32))

    ts = jax.tree_util.tree_map(fill, ts)
    # optax's schedule count (index 1) counts the Adam's updates
    # (test_schedule_count_is_the_adam_count)
    net, pts = ts.opt_state_net, ts.opt_state_pts
    return ts._replace(
        points=ts.points._replace(
            num_live=jnp.sum(ts.points.mask.astype(jnp.int32))),
        opt_state_net=(net[0], net[1]._replace(count=net[0].count)),
        opt_state_pts=(pts[0], pts[1]._replace(count=pts[0].count)))


def test_schedule_count_is_the_adam_count():
    """The port keeps one count an Adam and writes it at both indices of
    optax's tuple: JAX's update moves both alike."""
    jc = JC.tiny_test()
    ts = jax_template(jc)
    opt_net, _ = jstate.make_optimizers(jc.optim)
    st = ts.opt_state_net
    grads = jax.tree_util.tree_map(jnp.ones_like, ts.params)
    for step in range(1, 4):
        _, st = opt_net.update(grads, st, ts.params)
        assert int(st[0].count) == int(st[1].count) == step


def jax_flat(ts):
    return {k: np.asarray(v) for k, v in jck._flatten(ts._asdict()).items()}


def assert_flat_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def configs():
    return JC.tiny_test(), TC.tiny_test()


def test_jax_save_port_load(tmp_path, configs):
    jc, tc = configs
    ts = jax_state(jc, seed=1)
    path = jck.save_checkpoint(str(tmp_path), ts, best_psnr=27.5)
    got, best = tck.load_checkpoint(path, tc, device=CPU)
    assert best == 27.5
    flat = tck.flatten_state(got)
    del flat["__best_psnr__"]
    assert_flat_equal(flat, jax_flat(ts))
    assert got.step == int(ts.step)
    assert got.points.num_live == int(ts.points.num_live)
    assert got.opt_net.count == int(ts.opt_state_net[0].count)
    assert got.opt_pts.count == int(ts.opt_state_pts[0].count)
    assert got.points.table.device.type == "cpu"
    assert got.points.feature_dim == tc.points.feature_dim
    assert got.points.trainable == (False, True, True, True, True)


def test_port_save_jax_load(tmp_path, configs):
    jc, tc = configs
    src = jck.save_checkpoint(str(tmp_path / "jax"), jax_state(jc, seed=2))
    st, _ = tck.load_checkpoint(src, tc, device=CPU)
    st.step = 123
    st.opt_net.count = st.opt_pts.count = 41
    st.points.table.mul_(1.5)
    st.points.mask[:3] = ~st.points.mask[:3]
    st.points.num_live = int(st.points.mask.sum())
    path = tck.save_checkpoint(str(tmp_path / "port"), st, best_psnr=31.25)
    assert os.path.basename(path) == "123_state.npz"
    assert os.listdir(tmp_path / "port") == ["123_state.npz"]
    ts, best = jck.load_checkpoint(path, jax_template(jc))
    assert best == 31.25
    want = {k: v for k, v in tck.flatten_state(st).items()
            if k != "__best_psnr__"}
    assert_flat_equal(jax_flat(ts), want)
    assert int(ts.opt_state_net[1].count) == 41
    with np.load(path) as z:
        assert z["step"].dtype == np.int32 and z["step"].shape == ()
        assert z["points/num_live"].dtype == np.int32
        assert z["__best_psnr__"].dtype == np.float64


def test_port_save_load_round_trip(tmp_path, configs):
    jc, tc = configs
    src = jck.save_checkpoint(str(tmp_path), jax_state(jc, seed=3))
    st, _ = tck.load_checkpoint(src, tc, device=CPU)
    path = tck.save_checkpoint(str(tmp_path / "again"), st, 1.0)
    back, best = tck.load_checkpoint(path, tc, device=CPU)
    assert best == 1.0
    assert_flat_equal(tck.flatten_state(back, best),
                      tck.flatten_state(st, 1.0))


def test_load_refuses_other_shapes(tmp_path, configs):
    jc, tc = configs
    path = jck.save_checkpoint(str(tmp_path), jax_state(jc))
    small = tc.replace(points=TC.PointsConfig(num_points=1024,
                                              feature_dim=8))
    with pytest.raises(ValueError, match="points/table"):
        tck.load_checkpoint(path, small, device=CPU)
    z = dict(np.load(path))
    del z["params/aggregator/alpha/0/b"]
    np.savez(str(tmp_path / "5_state.npz"), **z)
    with pytest.raises(KeyError, match="params/aggregator/alpha/0/b"):
        tck.load_checkpoint(str(tmp_path / "5_state.npz"), tc, device=CPU)


@pytest.mark.parametrize("key", ["points/num_live", "step",
                                 "opt_state_pts/0/count"])
def test_load_refuses_a_missing_key(tmp_path, configs, key):
    """A file without one of the leaves fails in both loaders, naming it
    in the port's: nothing is rebuilt from the other leaves."""
    jc, tc = configs
    z = dict(np.load(jck.save_checkpoint(str(tmp_path), jax_state(jc))))
    del z[key]
    path = str(tmp_path / "5_state.npz")
    np.savez(path, **z)
    with pytest.raises(KeyError, match=key):
        tck.load_checkpoint(path, tc, device=CPU)
    with pytest.raises(KeyError):
        jck.load_checkpoint(path, jax_template(jc))


def test_load_defaults_to_the_card(tmp_path, configs):
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    jc, tc = configs
    path = jck.save_checkpoint(str(tmp_path), jax_state(jc))
    with pytest.raises(RuntimeError, match="CUDA"):
        tck.load_checkpoint(path, tc)


@pytest.mark.parametrize("names", [
    ["10_state.npz", "9_state.npz", "100_state.npz.tmp.npz", "abc_state.npz",
     "7_state.npy", "x_12_state.npz", "3_state.npz"],
    ["0100_state.npz", "100_state.npz", "99_state.npz", "notes.txt"],
    ["state.npz", "_state.npz", "5_6_state.npz"],
    ["run_config.json"], []])
def test_latest_checkpoint_equal(tmp_path, names):
    for n in names:
        (tmp_path / n).write_bytes(b"")
    assert tck.latest_checkpoint(str(tmp_path)) == \
        jck.latest_checkpoint(str(tmp_path))
    assert tck.latest_checkpoint(str(tmp_path / "absent")) is None


@pytest.fixture(scope="module")
def fixture_loads():
    if not os.path.exists(FIXTURE):
        pytest.skip("the fixture checkpoint is not in this checkout")
    jc, tc = JC.fixture_room(), TC.fixture_room()
    jts, jbest = jck.load_checkpoint(FIXTURE, jax_template(jc))
    tts, tbest = tck.load_checkpoint(FIXTURE, tc, device=CPU)
    return jts, jbest, tts, tbest


def test_round2_fixture_migration_equals_jax(fixture_loads):
    """The fixture's per-attribute points and point moments (no xyz
    moments; table width 64 for feature_dim 32) stacked as JAX stacks
    them."""
    jts, jbest, tts, tbest = fixture_loads
    assert tbest == jbest
    got = tck.flatten_state(tts)
    del got["__best_psnr__"]
    assert_flat_equal(got, jax_flat(jts))
    with np.load(FIXTURE) as z:
        assert tts.points.num_live == int(z["points/num_live"]) == \
            int(z["points/mask"].sum())
    assert tts.points.table.shape == (400_000, 64)
    assert not tts.opt_pts.mu[:, :3].any() and not tts.opt_pts.nu[:, :3].any()
    assert not tts.points.table[:, 42:].any()
    assert tts.step == 2000
