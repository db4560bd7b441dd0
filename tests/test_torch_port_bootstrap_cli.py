"""Both training CLIs with --load-points 0 (the MVS bootstrap, then
per-scene steps) on a fake ScanNet scene on the CPU.

The port gets JAX main's draws through its draw functions (init_mvs and
init_params from PRNGKey(seed), each step's noise from fold_in(key,
step)); once with random MVSNet weights, once with a seeded
reference-layout --mvs-ckpt read by both importers.  The run carves a
drop box (the attributes go with the points) and cuts the cloud to
--num-points with the run's own generator.  --vox-res 0 and
--mvs-conf-thresh 0 (random weights give confidences near 0.5) keep every
threshold away from the cloud.  Tolerances: the cloud and its attributes
the same count, rtol 1e-5 / atol 1e-5 * max|JAX|; run_config.json and the
event lines equal; loss means rtol 1e-3; the final checkpoint: its keys,
shapes, dtypes and integer leaves (the masks and counts) equal, each
parameter within 2 * steps * lr of JAX's (Adam's reach) and each Adam
moment within 1% of its leaf's largest plus 1% of its Adam's largest.
Unlike mode 2's clouds, read bit for bit by both packages
(tests/test_torch_port_train_cli.py), these agree to about 1e-6, and the
renderer's steps carry that on: the leaves whose gradients lie near the
rounding noise (the fusion weights take about 1e-7 here) step either
way, so no element-wise test past Adam's reach holds them.
"""

import dataclasses
import json
import os
import re

import jax
import numpy as np
import pytest

from hybridneuralrendering_tpu import config as JC
from hybridneuralrendering_tpu.cli import train as jcli
from hybridneuralrendering_tpu.models import neural_points as jnpts
from hybridneuralrendering_tpu.mvs import point_gen as JP
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch.cli import train as tcli
from hybridneuralrendering_tpu_torch.io import from_jax
from hybridneuralrendering_tpu_torch.models import neural_points as tnpts
from torch_port_common import (  # noqa: F401  (one_torch_thread: fixture)
    mvsnet_state_dict, one_torch_thread, save_mvsnet_ckpt,
    write_fake_scannet)

CPU = "cpu"
ATTRS = ("embedding", "color", "dirs", "conf")


def close(got, want, rtol=1e-5):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(
        float(np.abs(want).max()) if want.size else 0.0, 1e-30))


def _cfg(pkg, ranges):
    cfg = pkg.tiny_test()
    return cfg.replace(querier=dataclasses.replace(cfg.querier,
                                                   ranges=ranges))


PRESET = "itest_mvs"
SEED = 5
STEPS = 4
ARGS = ["--preset", PRESET, "--load-points", "0", "--max-steps", str(STEPS),
        "--print-freq", "2", "--test-freq", "0", "--save-freq", "0",
        "--vox-res", "0", "--mvs-conf-thresh", "0", "--mvs-num-depths", "16",
        "--num-points", "100", "--seed", str(SEED),
        "--drop-box", "-2.0", "-2.0", "0.0", "-0.5", "2.0", "3.0"]
EVENT = re.compile(r"(bootstrapping|init cloud|drop-box|pyramid cache|"
                   r"training|pruned|probe-and-grow|grew|done)")


def _itest(pkg):
    """tiny_test with the ranges of the fake scene's wall at 2 m."""
    return _cfg(pkg, (-2.0, -2.0, -2.0, 2.0, 2.0, 3.0))


def _jax_init_mvs(key):
    def init_mvs(cfg, seed, device, use_mvsnet=True, use_probnet=False):
        p = JP.init(key, cfg.points.feature_dim, use_mvsnet=use_mvsnet,
                    use_probnet=use_probnet)
        return from_jax.mvs_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, p), device)
    return init_mvs


def _jax_draws():
    """JAX main's draws for SEED: the MVS nets and the parameters from
    PRNGKey(SEED), each step's noise from fold_in(key, step)."""
    import torch
    from hybridneuralrendering_tpu.models import renderer as jren
    key = jax.random.PRNGKey(SEED)
    params = jax.tree_util.tree_map(np.asarray,
                                    jren.init_params(key, _itest(JC)))

    def init_params(cfg, seed, device):
        assert seed == SEED
        return from_jax.params_from_numpy(params, device=device)

    def step_noise(gen, step, frames, rays, depth, device):
        return torch.as_tensor(np.array(jax.random.uniform(
            jax.random.fold_in(key, step), (rays, depth))))[None].to(device)

    return dict(init_mvs=_jax_init_mvs(key), init_params=init_params,
                step_noise=step_noise)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    base = tmp_path_factory.mktemp("mvscli")
    mp = pytest.MonkeyPatch()
    mp.setenv("HNR_COMPILE_CACHE", str(base / "jax_cache"))
    mp.setitem(JC.PRESETS, PRESET, lambda: _itest(JC))
    mp.setitem(TC.PRESETS, PRESET, lambda: _itest(TC))
    root, scan = write_fake_scannet(base / "scans", n_frames=12, ext="png")
    ckpt = save_mvsnet_ckpt(base / "model_000014.ckpt", mvsnet_state_dict(6))
    yield base, root, scan, ckpt
    mp.undo()


def _run(label, argv):
    """One CLI run; returns the keyword arrays each package's
    init_from_arrays received (the bootstrap cloud and attributes)."""
    mp = pytest.MonkeyPatch()
    seen = {}
    try:
        if label == "jax":
            real = jnpts.init_from_arrays
            mp.setattr(jnpts, "init_from_arrays", lambda xyz, *a, **k: (
                seen.update(xyz=np.array(xyz), **{
                    x: np.array(k[x]) for x in ATTRS}),
                real(xyz, *a, **k))[1])
            jcli.main(argv)
            return seen
        for name, fn in _jax_draws().items():
            mp.setattr(tcli, name, fn)
        real = tnpts.init_from_arrays
        mp.setattr(tnpts, "init_from_arrays", lambda xyz, *a, **k: (
            seen.update(xyz=np.array(xyz), **{
                x: np.array(k[x]) for x in ATTRS}), real(xyz, *a, **k))[1])
        tcli.main(argv + ["--device", CPU])
        return seen
    finally:
        mp.undo()


def _log(run_dir):
    with open(os.path.join(run_dir, "log.txt")) as f:
        return [line.split("] ", 1)[1].rstrip("\n") for line in f]


@pytest.mark.parametrize("with_ckpt", [False, True])
def test_both_clis_bootstrap_and_train_alike(scene, with_ckpt):
    base, root, scan, ckpt = scene
    argv = ARGS + ["--data-root", root, "--scan", scan]
    if with_ckpt:
        argv += ["--mvs-ckpt", ckpt]
    runs = {}
    for label in ("jax", "port"):
        ck = str(base / f"{label}_{with_ckpt}")
        runs[label] = (_run(label, argv + ["--checkpoints-dir", ck]),
                       os.path.join(ck, "tiny"))
    (want, jdir), (got, tdir) = runs["jax"], runs["port"]
    # the cloud after the drop box and the cut to --num-points (the run's
    # own generator), and its attributes
    assert len(got["xyz"]) == len(want["xyz"]) == 100
    close(got["xyz"], want["xyz"])
    for a in ATTRS:
        close(got[a], want[a])
    for d in (jdir, tdir):
        with open(os.path.join(d, "ckpt", "run_config.json")) as f:
            runs.setdefault("cfg", []).append(json.load(f))
    assert runs["cfg"][0] == runs["cfg"][1]
    lj, lt = _log(jdir), _log(tdir)
    ev = [x for x in lt if EVENT.match(x.strip())]
    assert ev == [x for x in lj if EVENT.match(x.strip())]
    assert any(x.startswith("drop-box removed") for x in ev)
    num = re.compile(r"(\S+)=(-?[\d.]+)")
    steps = [(a, b) for a, b in zip([x for x in lj if x.startswith("step ")],
                                    [x for x in lt if x.startswith("step ")])]
    assert len(steps) == STEPS // 2
    for a, b in steps:
        va = {k: float(v) for k, v in num.findall(a) if k != "steps/s"}
        vb = {k: float(v) for k, v in num.findall(b) if k != "steps/s"}
        assert va.keys() == vb.keys()
        for k in va:
            assert vb[k] == pytest.approx(va[k], rel=1e-3, abs=2e-6), k
    tc = _itest(TC)
    with np.load(os.path.join(jdir, "ckpt", f"{STEPS}_state.npz")) as a, \
            np.load(os.path.join(tdir, "ckpt", f"{STEPS}_state.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        moment_scale = {(opt, m == "mu"): max(
            float(np.abs(a[k]).max()) for k in a.files
            if k.startswith(f"{opt}/0/{m}/"))
            for opt in ("opt_state_net", "opt_state_pts") for m in ("mu",
                                                                     "nu")}
        for k in a.files:
            x, y = a[k], b[k]
            assert x.shape == y.shape and x.dtype == y.dtype, k
            if x.dtype.kind in "biu" or k.endswith("mask"):
                assert np.array_equal(x, y), k
                continue
            lr = tc.optim.plr if k.startswith(("points", "opt_state_pts")) \
                else tc.optim.lr
            diff = np.abs(y - x)
            scale = max(float(np.abs(x).max()), 1e-30)
            if "/nu/" in k or "/mu/" in k:
                # the moments: within 1% of their Adam's largest moment
                assert diff.max() <= 1e-2 * moment_scale[
                    k.split("/0/")[0], "/mu/" in k] + 1e-2 * scale, k
            else:
                assert diff.max() <= 2 * STEPS * lr + 1e-5 * scale, k
