"""Both trainer CLIs with the learnable blur kernel (`--blur-mode
learnable` on a tiny learnable preset) and the native batch sampler
(`--native-prefetch 2`), on the CPU; then both evaluation CLIs on the
learnable run's checkpoint.  The resumed runs are in
tests/test_torch_port_train_cli_learnable_resume.py.

The scene, the draws carried across and the tolerances are those of
tests/test_torch_port_train_cli.py.  The preset is its preset with the
learnable kernel on, whose MLP reads the preset's patches of 4 rays.
Each step's pixels come from the native sampler seeded by the step index
in both CLIs, so the runs sample the same rays.  The evaluation CLIs
render the trained state (no blur at evaluation): PSNR within 1e-4
relative, as tests/test_torch_port_eval_cli.py holds it; SSIM and RMSE
within 1e-4 relative or 1e-5 absolute, since the random-weight renders
of noise frames score an SSIM near 0, where a relative limit alone would
ask for more than float32 rendering gives.
"""

import dataclasses
import functools
import os
import shutil

import numpy as np
import pytest

from hybridneuralrendering_tpu import config as JC
from hybridneuralrendering_tpu.cli import test as jtest_cli
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch.cli import test as ttest_cli
from hybridneuralrendering_tpu_torch.cli import train as tcli
from test_torch_port_train_cli import (  # noqa: F401  (fixtures)
    ARGS, _compare_checkpoints, _events, _log, _preset, _run, scene)
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

PRESET = "itest_learnable"
STEPS = 8
FLAGS = ["--preset", PRESET, "--blur-mode", "learnable",
         "--native-prefetch", "2"]
SCORES_RTOL = 1e-4
SCORES_ATOL = 1e-5      # SSIM and RMSE


def _learnable(pkg):
    base = _preset(pkg)
    return base.replace(
        agg=dataclasses.replace(base.agg, learnable_blur_kernel=True,
                                learnable_blur_patch_size=4),
        blur=dataclasses.replace(base.blur, learnable=True))


@pytest.fixture(scope="module")
def mp():
    """Both presets of the two trainer test files, in both packages."""
    m = pytest.MonkeyPatch()
    for name, fn in (("itest_train", _preset), (PRESET, _learnable)):
        m.setitem(JC.PRESETS, name, functools.partial(fn, JC))
        m.setitem(TC.PRESETS, name, functools.partial(fn, TC))
    yield m
    m.undo()


@pytest.fixture(scope="module")
def runs(scene):
    """Each CLI's run of STEPS steps."""
    base, root, scan = scene
    out = {}
    for label in ("jax", "port"):
        ck = base / f"learnable_{label}"
        _run(label, ARGS + FLAGS + ["--data-root", root, "--scan", scan,
                                    "--checkpoints-dir", str(ck)],
             preset=_learnable)
        out[label] = str(ck / "tiny")
    return out


def test_learnable_native_runs_agree_event_for_event(runs):
    want, got = _log(runs["jax"]), _log(runs["port"])
    assert _events(got) == _events(want)
    assert "native prefetch on (2 workers)" in got
    assert "native prefetch on (2 workers)" in want
    assert any(x.startswith("grew ") for x in _events(got))
    assert _events(got)[-1].startswith(f"done: {STEPS} steps")


def test_learnable_native_final_checkpoint_leaf_for_leaf(runs):
    path = os.path.join("ckpt", f"{STEPS}_state.npz")
    _compare_checkpoints(os.path.join(runs["port"], path),
                         os.path.join(runs["jax"], path), STEPS)
    with np.load(os.path.join(runs["port"], path)) as f:
        blur = [k for k in f.files if "blur_kernel" in k]
    # 4 layers' w and b: the parameters and both Adam moments
    assert len(blur) == 3 * 8


def _scores(path):
    with open(os.path.join(path, "scores.txt")) as f:
        return {k: float(v) for k, v in (line.split(": ") for line in f)}


def test_eval_cli_scores_a_learnable_checkpoint_as_jax(runs, scene, mp):
    _, root, scan = scene
    ck = os.path.dirname(runs["port"])
    argv = ["--preset", PRESET, "--data-root", root, "--scan", scan,
            "--checkpoints-dir", ck, "--num-frames", "2",
            "--eval-chunk", "1024"]
    jtest_cli.main(argv + ["--name", "tiny"])
    shutil.move(os.path.join(ck, "tiny_test"), os.path.join(ck, "jax_test"))
    got = ttest_cli.main(argv + ["--name", "tiny", "--device", "cpu"])
    want = _scores(os.path.join(ck, "jax_test"))
    assert sorted(got) == sorted(want) == ["psnr", "rmse", "ssim"]
    assert got["psnr"] == pytest.approx(want["psnr"], rel=SCORES_RTOL)
    for k in ("ssim", "rmse"):
        assert got[k] == pytest.approx(want[k], rel=SCORES_RTOL,
                                       abs=SCORES_ATOL), k


def test_native_prefetch_is_ignored_without_dilated_sampling(scene,
                                                             monkeypatch):
    """As in JAX, --native-prefetch does nothing for a preset that does
    not sample dilated patches: the port opens no pipeline and logs one
    line saying so."""
    base, root, scan = scene

    def random_sampling():
        cfg = _preset(TC)
        return cfg.replace(sampling=dataclasses.replace(
            cfg.sampling, random_sample="random"))

    def no_pipeline(*a, **kw):
        raise AssertionError("a pipeline was opened")

    monkeypatch.setitem(TC.PRESETS, "itest_random", random_sampling)
    monkeypatch.setattr(tcli.native_sampler, "PrefetchPipeline",
                        no_pipeline)
    ck = base / "random_sampling"
    tcli.main(["--preset", "itest_random", "--data-root", root, "--scan",
               scan, "--checkpoints-dir", str(ck), "--max-steps", "1",
               "--vox-res", "64", "--bootstrap-cap", "1500",
               "--prob-freq", "100", "--test-freq", "0", "--save-freq", "0",
               "--native-prefetch", "2", "--device", "cpu"])
    lines = _log(str(ck / "tiny"))
    off = [x for x in lines if x.startswith("native prefetch")]
    assert off == ["native prefetch off: the native sampler draws dilated "
                   "batches, the preset samples 'random'"]
