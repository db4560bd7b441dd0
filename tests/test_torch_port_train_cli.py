"""The port's training CLI (hybridneuralrendering_tpu_torch/cli/train.py)
against the JAX package's, on a fake ScanNet scene on the CPU.

Both CLIs train the same scene from the same start: the port gets JAX's
initial parameters, point embeddings and per-step candidate noise through
its three draw functions (init_params, init_embedding, step_noise), so the
two runs differ only by float32 summation order.  The preset is tiny_test
with a burst of 2 in a cycle of 4 steps (uncached, cached and a cache
invalidation within 8 steps), prob_thresh 0 (random initial weights'
opacities lie far below the preset's 0.7) and eval chunks of 1,024 rays,
registered in both packages' PRESETS for the test.  Tolerances:

- run_config.json, the bootstrap cloud (modes 1 and 2, the cap, the drop
  box), the steps that print, evaluate, save, prune and grow and the
  counts they log: equal.  Loss means on the print lines: rtol 1e-3 (the
  runs drift apart by rounding over the steps); eval PSNR: 2e-3 dB.
- the final checkpoint, leaf for leaf: integers and masks equal; the
  point table, the network parameters and the Adam moments within the
  training step's tolerances carried over the run's steps: each Adam step
  moves an element by about +-lr whatever its gradient's size, so an
  element whose gradient lies within rounding noise can move the other
  way (tests/test_torch_port_train.py); a parameter may therefore differ
  by 2 * lr a step, and 99% of each leaf's elements must agree within
  rtol 1e-3 / atol 1e-4 * max|leaf|.
"""

import dataclasses
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu import config as JC
from hybridneuralrendering_tpu.cli import train as jcli
from hybridneuralrendering_tpu.data import scannet as jscannet
from hybridneuralrendering_tpu.models import neural_points as jnpts
from hybridneuralrendering_tpu.models import renderer as jrenderer
from hybridneuralrendering_tpu.train import checkpoint as jck
from hybridneuralrendering_tpu.train import state as jstate
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch.cli import train as tcli
from hybridneuralrendering_tpu_torch.data import scannet as tscannet
from hybridneuralrendering_tpu_torch.io import from_jax
from hybridneuralrendering_tpu_torch.models import neural_points as tnpts
from hybridneuralrendering_tpu_torch.train import checkpoint as tck
from torch_port_common import (  # noqa: F401  (one_torch_thread: fixture)
    one_torch_thread, write_fake_scannet)

PRESET = "itest_train"
SEED = 3
STEPS = 8
# the schedule of the main run: print every 2, probe at 3 and 6, prune at
# 5, eval (and save on a better PSNR) at 6, the final save at 8
ARGS = ["--preset", PRESET, "--max-steps", str(STEPS), "--print-freq", "2",
        "--test-freq", "6", "--test-num", "1", "--prob-freq", "3",
        "--prune-iter", "5", "--prune-thresh", "0.5", "--vox-res", "64",
        "--bootstrap-cap", "1500", "--seed", str(SEED),
        "--drop-box", "0.0", "-0.3", "1.9", "0.4", "0.3", "2.1"]
EVENT = re.compile(r"(bootstrapping|init cloud|drop-box|pyramid cache|"
                   r"training|pruned|probe-and-grow|grew|done|resumed)")


def _preset(pkg):
    base = pkg.tiny_test()
    return base.replace(
        optim=dataclasses.replace(base.optim, pyramid_cycle_steps=4,
                                  pyramid_burst_steps=2),
        sampling=dataclasses.replace(base.sampling, eval_chunk_rays=1024),
        probe=dataclasses.replace(base.probe, prob_thresh=0.0))


@pytest.fixture(scope="module")
def mp():
    m = pytest.MonkeyPatch()
    m.setitem(JC.PRESETS, PRESET, lambda: _preset(JC))
    m.setitem(TC.PRESETS, PRESET, lambda: _preset(TC))
    yield m
    m.undo()


def _write_ply(path, n=900, seed=0):
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1, 1.5, n), rng.uniform(-0.8, 0.8, n),
                    2.0 + rng.normal(0, 0.01, n)], -1)
    with open(path, "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {n}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "end_header\n")
        for p in xyz:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


@pytest.fixture(scope="module")
def scene(tmp_path_factory, mp):
    base = tmp_path_factory.mktemp("traincli")
    mp.setenv("HNR_COMPILE_CACHE", str(base / "jax_cache"))
    root, scan = write_fake_scannet(base / "scans", n_frames=12, ext="png")
    _write_ply(os.path.join(root, scan, "exported", "pcd.ply"))
    return base, root, scan


def _jax_draws(preset=_preset):
    """JAX's draws for seed SEED under preset(JC): initial parameters,
    embeddings and the noise of each step, as the port's draw functions
    return them."""
    key = jax.random.PRNGKey(SEED)
    jc = preset(JC)
    params = jax.tree_util.tree_map(np.asarray,
                                    jrenderer.init_params(key, jc))
    R, Z = jc.sampling.rays_per_batch, jc.querier.z_depth_dim

    def init_params(cfg, seed, device):
        assert seed == SEED
        return from_jax.params_from_numpy(params, device=device)

    def init_embedding(n, cfg, seed):
        assert seed == SEED
        return np.asarray(jax.random.normal(
            key, (n, cfg.points.feature_dim)) * 0.1)

    def step_noise(gen, step, frames, rays, depth, device):
        assert (rays, depth) == (R, Z)
        k = jax.random.fold_in(key, step)
        keys = [k] if frames == 1 else list(jax.random.split(k, frames))
        return torch.stack([torch.as_tensor(np.array(
            jax.random.uniform(kf, (R, Z)))) for kf in keys]).to(device)

    return dict(init_params=init_params, init_embedding=init_embedding,
                step_noise=step_noise)


def _run(label, argv, capture=None, preset=_preset):
    """One CLI run; `capture` collects the xyz each package's
    init_from_arrays receives; the port gets JAX's draws under
    preset(JC)."""
    mp = pytest.MonkeyPatch()
    try:
        if label == "jax":
            if capture is not None:
                real = jnpts.init_from_arrays
                mp.setattr(jnpts, "init_from_arrays", lambda xyz, *a, **k: (
                    capture.append(np.array(xyz)), real(xyz, *a, **k))[1])
            return jcli.main(argv)
        for name, fn in _jax_draws(preset).items():
            mp.setattr(tcli, name, fn)
        if capture is not None:
            real = tnpts.init_from_arrays
            mp.setattr(tnpts, "init_from_arrays", lambda xyz, *a, **k: (
                capture.append(np.array(xyz)), real(xyz, *a, **k))[1])
        return tcli.main(argv + ["--device", "cpu"])
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def runs(scene):
    base, root, scan = scene
    out = {}
    for label in ("jax", "port"):
        ck = str(base / label)
        clouds = []
        _run(label, ARGS + ["--data-root", root, "--scan", scan,
                            "--checkpoints-dir", ck], clouds)
        out[label] = dict(dir=os.path.join(ck, "tiny"), clouds=clouds)
    return out


def _log(run_dir):
    with open(os.path.join(run_dir, "log.txt")) as f:
        return [line.split("] ", 1)[1].rstrip("\n") for line in f]


def test_run_config_equal(runs):
    snaps = []
    for label in ("jax", "port"):
        with open(os.path.join(runs[label]["dir"], "ckpt",
                               "run_config.json")) as f:
            snaps.append(json.load(f))
    assert snaps[0] == snaps[1]
    assert snaps[1]["preset"] == PRESET and snaps[1]["seed"] == SEED


def test_bootstrap_cloud_with_cap_and_drop_box_bitwise(runs):
    (jx,), (tx,) = runs["jax"]["clouds"], runs["port"]["clouds"]
    assert tx.dtype == jx.dtype and np.array_equal(tx, jx)
    lo, hi = np.array([0.0, -0.3, 1.9]), np.array([0.4, 0.3, 2.1])
    assert not np.all((tx >= lo) & (tx <= hi), axis=1).any()
    assert 1000 < len(tx) < 1500


@pytest.mark.parametrize("mode,cap", [(1, 0), (1, 300), (2, 0), (2, 1000)])
def test_bootstrap_points_bitwise(scene, mp, mode, cap):
    base, root, scan = scene
    argv = ["--data-root", root, "--scan", scan, "--load-points", str(mode),
            "--bootstrap-cap", str(cap), "--vox-res", "64", "--seed", "1"]
    jargs = jcli.build_argparser().parse_args(argv)
    targs = tcli.build_argparser().parse_args(argv)
    jc, tc = _preset(JC), _preset(TC)
    want, attrs = jcli.bootstrap_points(
        jargs, jscannet.ScannetScene(root, scan, jc, "train"), jc)
    got, tattrs = tcli.bootstrap_points(
        targs, tscannet.ScannetScene(root, scan, tc, "train"), tc)
    assert attrs is None and tattrs is None
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(got) == (cap if cap else len(got)) and len(got) > 250


def _events(lines):
    return [x for x in lines if EVENT.match(x.strip())]


def test_event_lines_match(runs):
    want, got = _log(runs["jax"]["dir"]), _log(runs["port"]["dir"])
    assert _events(got) == _events(want)
    ev = _events(got)
    assert any(x.startswith("grew ") for x in ev)
    assert any(re.match(r"pruned [1-9]\d* points", x) for x in ev)
    assert ev[-1] == "done: 8 steps, best PSNR " + ev[-1].split()[-1]


def test_print_and_eval_lines_match(runs):
    want, got = _log(runs["jax"]["dir"]), _log(runs["port"]["dir"])
    steps = [(a, b) for a, b in zip(
        [x for x in want if x.startswith(("step ", "eval step"))],
        [x for x in got if x.startswith(("step ", "eval step"))])]
    assert len(steps) == STEPS // 2 + 1
    num = re.compile(r"(\S+)=(-?[\d.]+)")
    for a, b in steps:
        assert a.split()[:2] == b.split()[:2]
        if a.startswith("eval"):
            pa, pb = float(a.split()[4]), float(b.split()[4])
            assert pb == pytest.approx(pa, abs=2e-3)
            continue
        va = {k: float(v) for k, v in num.findall(a) if k != "steps/s"}
        vb = {k: float(v) for k, v in num.findall(b) if k != "steps/s"}
        assert va.keys() == vb.keys() and len(va) > 4
        for k in va:
            assert vb[k] == pytest.approx(va[k], rel=1e-3, abs=2e-6), (a, k)


def test_checkpoints_at_the_same_steps(runs):
    names = [sorted(os.listdir(os.path.join(runs[label]["dir"], "ckpt")))
             for label in ("jax", "port")]
    assert names[0] == names[1] == ["6_state.npz", "8_state.npz",
                                    "run_config.json"]


def _close_leaf(key, got, want, steps, lr):
    if got.dtype.kind in "biu" or key.endswith("mask"):
        assert np.array_equal(got, want), key
        return
    diff = np.abs(got - want)
    scale = max(float(np.abs(want).max()), 1e-30)
    if "/nu/" not in key and "/mu/" not in key:
        assert diff.max() <= 2 * steps * lr + 1e-6 * scale, key
    near = diff <= 1e-3 * np.abs(want) + 1e-4 * scale
    assert near.mean() >= 0.99, (key, near.mean())


def _lr(key, cfg):
    return cfg.optim.plr if key.startswith(("points", "opt_state_pts")) \
        else cfg.optim.lr


def _compare_checkpoints(pa, pb, steps):
    tc = _preset(TC)
    with np.load(pa) as a, np.load(pb) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            if k == "__best_psnr__":
                assert float(a[k]) == pytest.approx(float(b[k]), abs=2e-3)
                continue
            _close_leaf(k, a[k], b[k], steps, _lr(k, tc))


def test_final_checkpoint_leaf_for_leaf(runs):
    _compare_checkpoints(
        os.path.join(runs["port"]["dir"], "ckpt", "8_state.npz"),
        os.path.join(runs["jax"]["dir"], "ckpt", "8_state.npz"), STEPS)


def test_final_checkpoint_loads_in_both(runs):
    path = os.path.join(runs["port"]["dir"], "ckpt", "8_state.npz")
    jc, tc = _preset(JC), _preset(TC)
    params = jrenderer.init_params(jax.random.PRNGKey(0), jc)
    pts = jnpts.init_from_arrays(np.zeros((4, 3), np.float32), jc.points)
    tmpl = jstate.create_train_state(params, pts, jc)
    jst, jbest = jck.load_checkpoint(path, tmpl)
    tst, tbest = tck.load_checkpoint(path, tc, device="cpu")
    assert int(jst.step) == tst.step == STEPS and jbest == tbest > 0
    assert np.array_equal(np.asarray(jst.points.table),
                          tst.points.table.numpy())
    assert int(jst.points.num_live) == tst.points.num_live


@pytest.mark.parametrize("flags", [
    ["--train-mode", "ff", "--mvs-num-depths", "8"],
    ["--load-points", "0", "--mvs-num-depths", "8", "--mvs-conf-thresh",
     "0", "--vox-res", "0"]])
def test_mvs_flags_run_and_default_to_the_card(scene, tmp_path, flags):
    """The flags refused before the MVS port now train (one step on the
    CPU), and without --device they ask for the card, as every entry
    point does."""
    _, root, scan = scene
    argv = ["--preset", PRESET, "--data-root", root, "--scan", scan,
            "--checkpoints-dir", str(tmp_path), "--max-steps", "1",
            "--test-freq", "0", "--save-freq", "0", "--name", "mvs"] + flags
    st = tcli.main(argv + ["--device", "cpu"])
    assert st.step == 1
    ckpts = os.listdir(tmp_path / "mvs" / "ckpt")
    assert ("ff_00000001.npz" if "ff" in flags else "1_state.npz") in ckpts
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(argv + ["--name", "mvs_card"])
    assert not os.path.exists(tmp_path / "mvs_card")


def test_entry_point_defaults_to_the_card(scene, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    _, root, scan = scene
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--preset", PRESET, "--data-root", root, "--scan", scan,
                   "--checkpoints-dir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "tiny")
