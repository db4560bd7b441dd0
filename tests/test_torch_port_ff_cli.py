"""The port's training CLI in feed-forward mode (cli/train.py --train-mode
ff) against the JAX CLI's, on a fake ScanNet scene on the CPU.

The scene is tests/test_drivers.py's feed-forward one (:120-155; 12
frames of seeded noise at 48x64, poses along x), the run its own: preset
tiny, 2 steps at D = 8.  The port gets JAX train_ff's draws through its
draw functions (init_mvs from PRNGKey(seed), init_params from
fold_in(key, 1), each step's noise from fold_in(key, step)), so the two
runs differ only by float32 summation order.  Tolerances: the event
lines and the printed live counts equal; the printed losses rtol 1e-4 /
atol 1e-6; the ff checkpoints leaf for leaf, integers equal and floats
within rtol 1e-3 / atol 2e-3 (two Adam steps of lr = mvs_lr = 5e-4 each
can move an element whose gradient lies within the rounding noise the
other way: 2e-3 bounds it).
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu import config as JC
from hybridneuralrendering_tpu.cli import train as jcli
from hybridneuralrendering_tpu.models import renderer as jren
from hybridneuralrendering_tpu.mvs import point_gen as JP
from hybridneuralrendering_tpu_torch.cli import train as tcli
from hybridneuralrendering_tpu_torch.data import scannet as tscannet
from hybridneuralrendering_tpu_torch.io import from_jax
from torch_port_common import (  # noqa: F401  (one_torch_thread: fixture)
    mvsnet_state_dict, one_torch_thread, save_mvsnet_ckpt,
    write_fake_scannet)

CPU = "cpu"

SEED = 4
FF_ARGS = ["--preset", "tiny", "--train-mode", "ff", "--max-steps", "2",
           "--mvs-num-depths", "8", "--save-freq", "2", "--print-freq", "1",
           "--seed", str(SEED), "--name", "fftest"]


def _jax_ff_draws(cfg_fn=JC.tiny_test):
    """JAX train_ff's draws for SEED: the MVS nets from PRNGKey(SEED), the
    renderer from fold_in(key, 1), each step's noise from
    fold_in(key, step)."""
    key = jax.random.PRNGKey(SEED)
    jc = cfg_fn()

    def init_mvs(cfg, seed, device, use_mvsnet=True, use_probnet=False):
        assert seed == SEED
        p = JP.init(key, cfg.points.feature_dim, use_mvsnet=use_mvsnet,
                    use_probnet=use_probnet)
        return from_jax.mvs_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, p), device)

    def init_params(cfg, seed, device):
        assert seed == SEED + 1
        return from_jax.params_from_numpy(jax.tree_util.tree_map(
            np.asarray, jren.init_params(jax.random.fold_in(key, 1), jc)),
            device)

    def step_noise(gen, step, frames, rays, depth, device):
        assert frames == 1
        return torch.as_tensor(np.array(jax.random.uniform(
            jax.random.fold_in(key, step), (rays, depth))))[None].to(device)

    return dict(init_mvs=init_mvs, init_params=init_params,
                step_noise=step_noise)


@pytest.fixture(autouse=True)
def jax_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("HNR_COMPILE_CACHE", str(tmp_path / "jax_cache"))


def _run_cli(label, argv, record=None):
    mp = pytest.MonkeyPatch()
    try:
        if label == "jax":
            return jcli.main(argv)
        for name, fn in _jax_ff_draws().items():
            mp.setattr(tcli, name, fn)
        if record is not None:
            real = tscannet.ScannetScene.get_batch
            mp.setattr(tscannet.ScannetScene, "get_batch",
                       lambda self, idx, *a, **k: record.append(
                           (self, idx)) or real(self, idx, *a, **k))
        return tcli.main(argv + ["--device", CPU])
    finally:
        mp.undo()


def _step_lines(run_dir):
    with open(os.path.join(run_dir, "log.txt")) as f:
        lines = [x.split("] ", 1)[1].rstrip("\n") for x in f]
    return lines


def _losses(line):
    return {k: float(v) for k, v in re.findall(r"(\S+)=(-?[\d.]+)", line)
            if k != "steps/s"}


def _compare_runs(base, blur=()):
    root, scan = write_fake_scannet(base / "scans", n_frames=20 if blur
                                    else 12, ext="jpg", blur_list=blur)
    out, record = {}, []
    for label in ("jax", "port"):
        ck = str(base / label)
        _run_cli(label, FF_ARGS + ["--data-root", root, "--scan", scan,
                                   "--checkpoints-dir", ck],
                 record if label == "port" else None)
        out[label] = os.path.join(ck, "fftest")
    want, got = _step_lines(out["jax"]), _step_lines(out["port"])
    assert [x for x in got if not x.startswith("step ")] == \
        [x for x in want if not x.startswith("step ")]
    steps = [(a, b) for a, b in zip(want, got) if a.startswith("step ")]
    assert len(steps) == 2
    for a, b in steps:
        va, vb = _losses(a), _losses(b)
        assert va.keys() == vb.keys() and "pts" in va
        assert vb["pts"] == va["pts"]
        for k in va:
            assert vb[k] == pytest.approx(va[k], rel=1e-4, abs=1e-6), k
    names = [sorted(os.listdir(os.path.join(out[x], "ckpt")))
             for x in ("jax", "port")]
    assert names[0] == names[1] == ["ff_00000002.npz", "run_config.json"]
    with np.load(os.path.join(out["jax"], "ckpt", "ff_00000002.npz")) as a, \
            np.load(os.path.join(out["port"], "ckpt",
                                 "ff_00000002.npz")) as b:
        assert a.files == b.files
        for k in a.files:
            x, y = a[k], b[k]
            assert x.shape == y.shape and x.dtype == y.dtype, k
            if x.dtype.kind in "iu":
                assert np.array_equal(x, y), k
            else:
                np.testing.assert_allclose(y, x, rtol=1e-3,
                                           atol=2 * 1e-3 + 1e-6)
    return record


def test_both_clis_train_ff_alike(tmp_path):
    """tests/test_drivers.py's feed-forward run (the fake scene of
    :120-155, preset tiny, 2 steps at D = 8) through both CLIs: the same
    event lines, printed losses and live counts, and ff checkpoints leaf
    for leaf within two Adam steps (2e-3 = 2 * lr at most apart)."""
    _compare_runs(tmp_path)


def test_ff_keeps_the_blur_list_index_quirk(tmp_path):
    """With a blur list (frame 0 of the train frames 0, 5, 10, 15 listed),
    the triplets hold positions in train_id_list [5, 10, 15], while
    get_batch reads id_list [0, 5, 10, 15]: both CLIs render frame 0,
    a listed frame, for the triplet (5, 10, 15), and agree."""
    record = _compare_runs(tmp_path, blur=(0,))
    ds, idx = record[0]
    assert ds.train_id_list == [5, 10, 15] and ds.id_list == [0, 5, 10, 15]
    assert idx == 0 and ds.id_list[idx] == 0 != ds.train_id_list[idx]


def test_ff_cli_with_mvsnet_checkpoint(tmp_path):
    """--mvs-ckpt: the pretrained-MVSNet mode (conf threshold 0 here, as
    random weights' confidences lie near 0.5), the weights read from a
    seeded reference-layout .ckpt by both CLIs."""
    path = save_mvsnet_ckpt(tmp_path / "mvsnet.ckpt", mvsnet_state_dict(3))
    root, scan = write_fake_scannet(tmp_path / "scans", n_frames=12,
                                    ext="jpg")
    argv = FF_ARGS + ["--data-root", root, "--scan", scan,
                      "--mvs-ckpt", path, "--mvs-conf-thresh", "0"]
    runs = {}
    for label in ("jax", "port"):
        ck = str(tmp_path / label)
        st = _run_cli(label, argv + ["--checkpoints-dir", ck])
        runs[label] = os.path.join(ck, "fftest")
    assert st.mvs_params.mvsnet is not None and st.mvs_params.cost_reg is None
    for a, b in zip(_step_lines(runs["jax"]), _step_lines(runs["port"])):
        if a.startswith("step "):
            va, vb = _losses(a), _losses(b)
            for k in va:
                assert vb[k] == pytest.approx(va[k], rel=1e-4, abs=1e-6), k
        else:
            assert a == b
    assert "(MVSNet depth)" in _step_lines(runs["port"])[0]
