"""The port's training CLI against the JAX package's when both resume from
one JAX-written checkpoint, with two frames a step (train_step_multi), and
ROADMAP Queue 3's blur-list quirk in both CLIs; on the CPU.

The scene, the preset, the draws carried across and the tolerances are
those of tests/test_torch_port_train_cli.py; the checkpoint comparison
counts the resumed run's own steps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hybridneuralrendering_tpu import config as JC
from hybridneuralrendering_tpu.cli import train as jcli
from hybridneuralrendering_tpu.data import scannet as jscannet
from hybridneuralrendering_tpu.models import neural_points as jnpts
from hybridneuralrendering_tpu.models import renderer as jrenderer
from hybridneuralrendering_tpu.train import checkpoint as jck
from hybridneuralrendering_tpu.train import state as jstate
from test_torch_port_train_cli import (  # noqa: F401  (fixtures)
    ARGS, PRESET, SEED, STEPS, _compare_checkpoints, _events, _log, _preset,
    _run, mp, scene)
from torch_port_common import (  # noqa: F401  (one_torch_thread: fixture)
    one_torch_thread, write_fake_scannet)

RESUMED_STEPS = 4


@pytest.fixture(scope="module")
def resumed(scene):
    """A JAX state at step STEPS over the CLI's bootstrap cloud, saved by
    JAX's save_checkpoint; both CLIs resume from it for RESUMED_STEPS steps
    of 2 frames: 2 uncached, then (the burst over) 2 cached."""
    base, root, scan = scene
    jc = _preset(JC)
    args = jcli.build_argparser().parse_args(
        ARGS + ["--data-root", root, "--scan", scan])
    xyz, _ = jcli.bootstrap_points(
        args, jscannet.ScannetScene(root, scan, jc, "train"), jc)
    key = jax.random.PRNGKey(SEED + 1)
    pts = jnpts.init_from_arrays(xyz, jc.points, key=key)
    ts = jstate.create_train_state(jrenderer.init_params(key, jc), pts,
                                   jc)._replace(step=jnp.asarray(STEPS,
                                                                 jnp.int32))
    out = {}
    for label in ("jax", "port"):
        ck = base / f"resume_{label}"
        jck.save_checkpoint(str(ck / "tiny" / "ckpt"), ts, best_psnr=7.5)
        argv = ARGS + ["--data-root", root, "--scan", scan,
                       "--checkpoints-dir", str(ck), "--resume",
                       "--frames-per-step", "2", "--prob-freq", "100",
                       "--max-steps", str(STEPS + RESUMED_STEPS)]
        _run(label, argv)
        out[label] = str(ck / "tiny")
    return out


def test_resume_continues_at_the_checkpoint_step(resumed):
    for label in ("jax", "port"):
        lines = _log(resumed[label])
        res = [x for x in lines if x.startswith("resumed from ")]
        assert len(res) == 1 and res[0].endswith(
            f"{STEPS}_state.npz at step {STEPS}")
        assert lines[-1] == f"done: {STEPS + RESUMED_STEPS} steps, best " \
            f"PSNR 7.500"
    assert _events(_log(resumed["port"])) == [
        x.replace(resumed["jax"], resumed["port"])
        for x in _events(_log(resumed["jax"]))]
    names = [sorted(os.listdir(os.path.join(resumed[label], "ckpt")))
             for label in ("jax", "port")]
    end = STEPS + RESUMED_STEPS
    assert names[0] == names[1] == [f"{end}_state.npz", f"{STEPS}_state.npz",
                                    "run_config.json"]
    _compare_checkpoints(
        os.path.join(resumed["port"], "ckpt", f"{end}_state.npz"),
        os.path.join(resumed["jax"], "ckpt", f"{end}_state.npz"),
        RESUMED_STEPS)
    with np.load(os.path.join(resumed["port"], "ckpt",
                              f"{end}_state.npz")) as f:
        assert int(f["step"]) == end
        assert int(f["opt_state_net/0/count"]) == RESUMED_STEPS


def test_blur_listed_train_frame_fails_alike(tmp_path, mp):
    """ROADMAP Queue 3's quirk, kept as in JAX: the blur list removes a
    frame from train_id_list but not from the train split's id_list, so
    with frame weights on, the first step that draws it fails in both
    CLIs with the same ValueError."""
    assert PRESET in JC.PRESETS
    root, scan = write_fake_scannet(tmp_path / "scans", n_frames=12,
                                    ext="png", blur_list=(0, 5),
                                    frame_weights=[0.9, 0.8, 0.7])
    errors = []
    for label in ("jax", "port"):
        argv = ["--preset", PRESET, "--data-root", root, "--scan", scan,
                "--checkpoints-dir", str(tmp_path / label), "--max-steps",
                "6", "--vox-res", "64", "--frame-weight", "1",
                "--seed", str(SEED)]
        with pytest.raises(ValueError) as e:
            _run(label, argv)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "is not in list" in errors[0]
