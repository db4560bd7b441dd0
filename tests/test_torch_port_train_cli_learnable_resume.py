"""Both trainer CLIs resumed from one JAX-written checkpoint of a learnable
run (its blur MLP's leaves and their Adam moments in the file), with the
learnable blur kernel, the native batch sampler and 2 frames a step, on
the CPU.

The scene, the preset, the draws carried across and the tolerances are
those of tests/test_torch_port_train_cli_learnable.py; the checkpoint
comparison counts the resumed run's own steps.
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
    ARGS, SEED, _compare_checkpoints, _events, _log, _run, scene)
from test_torch_port_train_cli_learnable import (  # noqa: F401  (fixtures)
    FLAGS, _learnable, mp)
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

START, RESUMED_STEPS = 8, 2


@pytest.fixture(scope="module")
def resumed(scene):
    """A learnable JAX state at step START over the CLI's bootstrap cloud,
    saved by JAX's save_checkpoint; both CLIs resume from it for
    RESUMED_STEPS steps of 2 frames."""
    base, root, scan = scene
    jc = _learnable(JC)
    args = jcli.build_argparser().parse_args(
        ARGS + ["--data-root", root, "--scan", scan])
    xyz, _ = jcli.bootstrap_points(
        args, jscannet.ScannetScene(root, scan, jc, "train"), jc)
    key = jax.random.PRNGKey(SEED + 2)
    pts = jnpts.init_from_arrays(xyz, jc.points, key=key)
    ts = jstate.create_train_state(jrenderer.init_params(key, jc), pts,
                                   jc)._replace(step=jnp.asarray(START,
                                                                 jnp.int32))
    out = {}
    for label in ("jax", "port"):
        ck = base / f"learnable_resume_{label}"
        jck.save_checkpoint(str(ck / "tiny" / "ckpt"), ts, best_psnr=6.5)
        _run(label, ARGS + FLAGS + [
            "--data-root", root, "--scan", scan, "--checkpoints-dir",
            str(ck), "--resume", "--frames-per-step", "2", "--prob-freq",
            "100", "--max-steps", str(START + RESUMED_STEPS)],
            preset=_learnable)
        out[label] = str(ck / "tiny")
    return out


def test_learnable_native_resumed_runs_agree(resumed):
    end = START + RESUMED_STEPS
    for label in ("jax", "port"):
        lines = _log(resumed[label])
        res = [x for x in lines if x.startswith("resumed from ")]
        assert len(res) == 1 and res[0].endswith(
            f"{START}_state.npz at step {START}")
        assert "native prefetch on (2 workers)" in lines
        assert lines[-1] == f"done: {end} steps, best PSNR 6.500"
    assert _events(_log(resumed["port"])) == [
        x.replace(resumed["jax"], resumed["port"])
        for x in _events(_log(resumed["jax"]))]
    path = os.path.join("ckpt", f"{end}_state.npz")
    _compare_checkpoints(os.path.join(resumed["port"], path),
                         os.path.join(resumed["jax"], path), RESUMED_STEPS)
    with np.load(os.path.join(resumed["port"], path)) as f:
        assert int(f["opt_state_net/0/count"]) == RESUMED_STEPS
        mu = f["opt_state_net/0/mu/aggregator/blur_kernel/0/w"]
        assert mu.shape == (32, 128) and np.abs(mu).max() > 0
