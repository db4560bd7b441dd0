"""The port's RAFT (flow/raft.py), its importers (io/torch_import.py,
io/from_jax.raft_from_numpy), the frame weights (data/frame_weights.py) and
their CLI (cli/frame_weights.py) against the JAX package's.

The same seeded weights reach both sides: random numpy weights in JAX's
RaftParams layout (batch norms with random statistics) go to the port
through raft_from_numpy, and a port module saved as a reference-layout
.pth (`module.`-prefixed) goes to JAX through its own importer.
Tolerances:
- the pieces (both encoders, corr_pyramid with an odd and a size-1
  level, corr_lookup, the update block, upsample_flow_convex): 1e-5
  relative, with an absolute floor of 1e-5 of the output's largest value
  (convolutions and products summed in another order);
- estimate_flow with iters=1 at 64x64 and 128x128: rtol 1e-5, atol 5e-5,
  tighter than JAX's own limit for its flow against the reference's (rtol
  1e-3, atol 5e-2, tests/test_torch_import.py), since it holds: the
  readings, printed, are about 5e-6 on flows of 3 px.  The card's flow
  against the CPU's keeps JAX's limit (tests/test_torch_port_gpu.py).  More
  iterations are not compared: with random weights each refinement moves
  the flow by ~20 px, so the loop amplifies float32 rounding without bound
  (the same comment there);
- data/frame_weights and both CLIs with identity or a given flow: bit for
  bit (the same numpy arithmetic); the roomsim fixture's weights also
  equal .fixture/frame_weights_step5/roomsim_frame_weight_step5.npy, which
  JAX's CLI reproduces on the CPU (identity flow, fixture_room).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu.cli import frame_weights as jfw_cli
from hybridneuralrendering_tpu.data import frame_weights as JFW
from hybridneuralrendering_tpu.flow import raft as jraft
from hybridneuralrendering_tpu.io import torch_import as JTI
from hybridneuralrendering_tpu_torch.cli import frame_weights as tfw_cli
from hybridneuralrendering_tpu_torch.data import frame_weights as TFW
from hybridneuralrendering_tpu_torch.flow import raft as traft
from hybridneuralrendering_tpu_torch.io import from_jax
from hybridneuralrendering_tpu_torch.io import torch_import as TTI
from torch_port_common import (  # noqa: F401  (one_torch_thread: fixture)
    n, numpy_params, one_torch_thread, t, write_fake_scannet)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_ROOT = os.path.join(ROOT, ".fixture")
FIXTURE_WEIGHTS = os.path.join(
    FIXTURE_ROOT, "frame_weights_step5/roomsim_frame_weight_step5.npy")
FLOW_TOL = dict(rtol=1e-5, atol=5e-5)


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(n(got), want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


def _random_bn(tree, rng):
    """Batch norms of the numpy tree with random statistics: scale and
    var in [0.5, 1.5], bias and mean normal * 0.1."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = tree["scale"].shape
            return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": (0.1 * rng.normal(size=c)).astype(np.float32),
                    "mean": (0.1 * rng.normal(size=c)).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        return {k: _random_bn(v, rng) for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def weights():
    """(JAX RaftParams of jnp arrays, the port's RAFT) of one seeded
    numpy tree."""
    tree = numpy_params(jraft.init, seed=3)
    rng = np.random.default_rng(4)
    tree = jraft.RaftParams(*[_random_bn(x, rng) for x in tree])
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jp, from_jax.raft_from_numpy(tree, device="cpu")


def _image(rng, H, W, c=3):
    return rng.uniform(0, 255, (H, W, c)).astype(np.float32)


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_encoder_matches_jax(weights, norm):
    jp, model = weights
    x = np.random.default_rng(1).normal(size=(1, 40, 48, 3)).astype(
        np.float32)
    enc, jenc = ((model.fnet, jp.fnet) if norm == "instance"
                 else (model.cnet, jp.cnet))
    want = jraft.encoder_apply(jenc, jnp.asarray(x), norm)
    with torch.no_grad():
        got = enc(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape == (1, 5, 6, 256)
    _close(got, want)


@pytest.mark.parametrize("hw", [(5, 6), (8, 3), (7, 7)])
def test_corr_pyramid_matches_jax(hw):
    """Odd sizes floor; a size-1 axis stays unpooled."""
    rng = np.random.default_rng(2)
    f1, f2 = (rng.normal(size=hw + (32,)).astype(np.float32)
              for _ in range(2))
    want = jraft.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    got = traft.corr_pyramid(t(f1), t(f2))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert got[-1].shape[1:] == (1, 1)
    for g, w in zip(got, want):
        _close(g, w)


def test_corr_lookup_matches_jax():
    """Targets inside, near and outside the level maps."""
    rng = np.random.default_rng(3)
    H, W = 9, 12
    f1, f2 = (rng.normal(size=(H, W, 32)).astype(np.float32)
              for _ in range(2))
    coords = np.stack([rng.uniform(-4, W + 4, (H, W)),
                       rng.uniform(-4, H + 4, (H, W))], -1).astype(
        np.float32)
    jpyr = jraft.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    want = jraft.corr_lookup(jpyr, jnp.asarray(coords))
    got = traft.corr_lookup(traft.corr_pyramid(t(f1), t(f2)), t(coords))
    assert tuple(got.shape) == want.shape == (H, W, 4 * 81)
    _close(got, want)
    # the window's channel order: channel (i, j) moves x by d_i, y by d_j
    # (radius 1: channel 1 is (x - 1, y), channel 3 is (x, y - 1))
    vol = torch.arange(H * W, dtype=torch.float32).reshape(1, H, W)
    tap = traft.corr_lookup([vol.expand(H * W, H, W)],
                            torch.zeros(H, W, 2) + 4.0, radius=1)
    assert float(tap[0, 0, 1]) == 4 * W + 3
    assert float(tap[0, 0, 3]) == 3 * W + 4


def test_update_block_matches_jax(weights):
    jp, model = weights
    rng = np.random.default_rng(5)
    h, w = 6, 7
    net = np.tanh(rng.normal(size=(1, h, w, 128))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(1, h, w, 128)), 0).astype(np.float32)
    corr = rng.normal(size=(1, h, w, 324)).astype(np.float32)
    flow = (3 * rng.normal(size=(1, h, w, 2))).astype(np.float32)
    want = jraft.update_apply(jp.update, *map(jnp.asarray,
                                              (net, inp, corr, flow)))
    nchw = lambda x: t(x).permute(0, 3, 1, 2)   # noqa: E731
    with torch.no_grad():
        got = model.update_block(*map(nchw, (net, inp, corr, flow)))
    for g, w_ in zip(got, want):
        _close(g.permute(0, 2, 3, 1), w_)


def test_upsample_flow_convex_matches_jax():
    rng = np.random.default_rng(6)
    flow = rng.normal(size=(1, 5, 7, 2)).astype(np.float32)
    mask = rng.normal(size=(1, 5, 7, 576)).astype(np.float32)
    want = jraft.upsample_flow_convex(jnp.asarray(flow), jnp.asarray(mask))
    got = traft.upsample_flow_convex(t(flow), t(mask))
    assert tuple(got.shape) == want.shape == (1, 40, 56, 2)
    _close(got, want)


@pytest.mark.parametrize("size", [64, 128])
def test_estimate_flow_one_iteration(weights, size):
    jp, model = weights
    rng = np.random.default_rng(size)
    im1, im2 = _image(rng, size, size), _image(rng, size, size)
    want = np.asarray(jraft.estimate_flow(jp, jnp.asarray(im1),
                                          jnp.asarray(im2), iters=1))
    got = n(traft.estimate_flow(model, t(im1), t(im2), iters=1))
    err = np.abs(got - want)
    print(f"estimate_flow {size}x{size}, iters=1: max abs {err.max():.3e}, "
          f"flow max {np.abs(want).max():.3e}")
    assert got.shape == (size, size, 2)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, **FLOW_TOL)


def test_reference_layout_checkpoint(weights, tmp_path):
    """The port's module as a reference checkpoint (`module.` keys): the
    port's load_raft takes every key strictly, JAX's importer reads the
    same file, and JAX's flow from it is the port's."""
    _, model = weights
    sd = model.state_dict()
    assert "fnet.layer1.0.conv1.weight" in sd
    assert "cnet.norm1.running_mean" in sd
    assert "update_block.gru.convz1.weight" in sd
    assert "cnet.layer2.0.norm3.running_var" in sd
    assert "cnet.layer2.0.downsample.1.running_var" in sd
    path = str(tmp_path / "raft-things.pth")
    torch.save({"module." + k: v for k, v in sd.items()}, path)
    back = TTI.load_raft(path, device="cpu")
    for k, v in back.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert set(TTI.load_torch_state_dict(path)) == set(sd)
    jp = JTI.import_raft(JTI.load_torch_state_dict(path))
    rng = np.random.default_rng(8)
    im1, im2 = _image(rng, 64, 64), _image(rng, 64, 64)
    want = np.asarray(jraft.estimate_flow(jp, jnp.asarray(im1),
                                          jnp.asarray(im2), iters=1))
    got = n(traft.estimate_flow(back, t(im1), t(im2), iters=1))
    np.testing.assert_allclose(got, want, **FLOW_TOL)
    # a {"state_dict": ...} container loads too; a missing key does not
    torch.save({"state_dict": sd}, str(tmp_path / "wrapped.pth"))
    TTI.load_raft(str(tmp_path / "wrapped.pth"), device="cpu")
    torch.save({k: v for k, v in sd.items() if "convz1" not in k},
               str(tmp_path / "short.pth"))
    with pytest.raises(RuntimeError, match="convz1"):
        TTI.load_raft(str(tmp_path / "short.pth"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        TTI.import_mvsnet({})


def test_raft_from_numpy_of_jax_init(tmp_path):
    """JAX's own initialiser (identity batch norms) through
    raft_from_numpy, saved as a reference .pth and read back by JAX's
    importer: every leaf equal to JAX's."""
    jp = jax.jit(jraft.init)(jax.random.PRNGKey(0))
    model = from_jax.raft_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                     device="cpu")
    path = str(tmp_path / "raft.pth")
    torch.save({"module." + k: v for k, v in model.state_dict().items()},
               path)
    back = JTI.import_raft(JTI.load_torch_state_dict(path))
    want = jax.tree_util.tree_leaves_with_path(jp)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in got] == [k for k, _ in want] and len(want) > 100
    for (k, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(k))


def test_port_init_and_flow_fn():
    """The port's seeded init: conv std sqrt(2 / fan_out), zero biases,
    identity batch norms, eval mode; make_flow_fn pads to multiples of 8
    by edge and crops back."""
    a, b = traft.init(seed=1, device="cpu"), traft.init(seed=1, device="cpu")
    assert not a.training
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    wgt = a.update_block.encoder.convc1.weight
    assert abs(float(wgt.detach().std()) - np.sqrt(2.0 / 256)) < 0.01
    g = np.random.default_rng(1).uniform(0, 255, (30, 37))
    flow = traft.make_flow_fn(a, iters=1)(g, g)
    assert flow.shape == (30, 37, 2) and np.isfinite(flow).all()
    with pytest.raises(ValueError, match="eval mode"):
        traft.estimate_flow(a.train(), t(_image(np.random.default_rng(0), 32,
                                                32)),
                            t(_image(np.random.default_rng(1), 32, 32)))


# ------------------------------------------------------- frame weights

def _frames(num=9, hw=(60, 70), seed=10):
    """Grey frames of a moving texture, some blurred."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (hw[0] + 20, hw[1] + 20))
    out = []
    for i in range(num):
        f = base[i:i + hw[0], 2 * i:2 * i + hw[1]]
        if i % 3 == 1:
            f = TFW._mean_blur(f, 3)
        out.append(f.astype(np.float32))
    return out


def _shift_flow(img1, img2):
    h, w = img1.shape
    ys, xs = np.mgrid[0:h, 0:w]
    return np.stack([1.7 + 0.01 * xs, 0.9 - 0.02 * ys], -1)


@pytest.mark.parametrize("flow", [None, "field"])
def test_frame_weights_bitwise(flow):
    frames = _frames()
    fn = _shift_flow if flow else None
    for name in ("_mean_blur", "laplacian_edge"):
        np.testing.assert_array_equal(getattr(TFW, name)(frames[1]),
                                      getattr(JFW, name)(frames[1]))
    f = _shift_flow(frames[0], frames[1])
    np.testing.assert_array_equal(TFW.warp_by_flow(frames[2], f),
                                  JFW.warp_by_flow(frames[2], f))
    tsc, tsr = TFW.blur_scores(frames, fn, border=5)
    jsc, jsr = JFW.blur_scores(frames, fn, border=5)
    assert tsc == jsc and tsr == jsr
    np.testing.assert_array_equal(TFW.chain_scores(tsc, tsr),
                                  JFW.chain_scores(jsc, jsr))
    for win, step in ((10, 5), (4, 2), (3, 2)):
        want = JFW.compute_frame_weights(frames, fn, win, step, border=5)
        got = TFW.compute_frame_weights(frames, fn, win, step, border=5)
        np.testing.assert_array_equal(got, want)
        assert len(got) == len(frames) and np.isfinite(got).all()


def _run_clis(argv, out):
    res = {}
    for label, mod, extra in (("jax", jfw_cli, []),
                              ("port", tfw_cli, ["--device", "cpu"])):
        mod.main(argv + ["--out", os.path.join(out, label)] + extra)
        res[label] = np.load(os.path.join(
            out, label, "frame_weights_step5",
            f"{argv[argv.index('--scan') + 1]}_frame_weight_step5.npy"))
    return res


def test_cli_fake_scene(tmp_path, capsys):
    """A 40-frame fake scene (8 training frames): identity flow bit for
    bit, and RAFT from one reference-layout checkpoint (iters 1) within
    the flows' float32 rounding."""
    root, scan = write_fake_scannet(str(tmp_path / "scans"), "scene_fw",
                                    n_frames=40, ext="png")
    argv = ["--data-root", root, "--scan", scan, "--preset", "tiny"]
    res = _run_clis(argv, str(tmp_path / "id"))
    assert res["port"].dtype == np.float32 and res["port"].shape == (8,)
    np.testing.assert_array_equal(res["port"], res["jax"])
    lines = capsys.readouterr().out.splitlines()
    half = len(lines) // 2
    assert [x.replace("/jax/", "/port/") for x in lines[:half]] == \
        lines[half:]
    # random weights move a 48x64 frame by tens of pixels, past the
    # 20-pixel border's window; the flow head scaled by 1/100 keeps the
    # flows to a few pixels, so the scores stay defined
    sd = traft.init(seed=2, device="cpu").state_dict()
    sd["update_block.flow_head.conv2.weight"] *= 0.01
    ck = str(tmp_path / "raft.pth")
    torch.save({"module." + k: v for k, v in sd.items()}, ck)
    flow = traft.make_flow_fn(TTI.load_raft(ck, "cpu"), iters=1)(
        *[np.asarray(f, np.float32) for f in
          np.random.default_rng(0).uniform(0, 255, (2, 48, 64))])
    assert 0.1 < np.abs(flow).max() < 8
    res = _run_clis(argv + ["--raft-ckpt", ck, "--iters", "1"],
                    str(tmp_path / "raft"))
    print(f"RAFT-flow weights {res['port']}, port - JAX: max abs "
          f"{np.abs(res['port'] - res['jax']).max():.3e}")
    assert np.isfinite(res["port"]).all()
    np.testing.assert_allclose(res["port"], res["jax"], rtol=1e-3)


def test_cli_roomsim_fixture(tmp_path):
    if not os.path.exists(FIXTURE_WEIGHTS):
        pytest.skip("the frame-weight fixture is not in this checkout")
    argv = ["--data-root", FIXTURE_ROOT, "--scan", "roomsim", "--preset",
            "fixture_room"]
    res = _run_clis(argv, str(tmp_path))
    ref = np.load(FIXTURE_WEIGHTS)
    print(f"roomsim weights, port - fixture file: max abs "
          f"{np.abs(res['port'] - ref).max():.3e}")
    np.testing.assert_array_equal(res["port"], res["jax"])
    np.testing.assert_array_equal(res["port"], ref)


def test_cli_needs_cuda_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfw_cli.main(["--data-root", str(tmp_path), "--scan", "none"])
