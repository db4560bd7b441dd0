"""Shared inputs for the parity tests of the PyTorch port
(hybridneuralrendering_tpu_torch) against the JAX package.

Every input is made once in numpy from a seed and handed to both packages;
parameters come from the JAX initialiser and reach the port through
hybridneuralrendering_tpu_torch.io.from_jax, so both compute from the same
weights.  Everything runs on the CPU at tiny_test sizes, float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu import config as JC
from hybridneuralrendering_tpu.models import neural_points as jnpts
from hybridneuralrendering_tpu.models import renderer as jrenderer
from hybridneuralrendering_tpu.ops import voxel_grid as JVG
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch.data import synthetic as tsyn
from hybridneuralrendering_tpu_torch.io import from_jax
from hybridneuralrendering_tpu_torch.ops import voxel_grid as TVG

CPU = "cpu"
# where the two frameworks sum in another order (cumsum, matmul, conv,
# resize): float32 rtol 1e-5 / atol 1e-6
REORDERED = dict(rtol=1e-5, atol=1e-6)
NUM_POINTS = 1500
NUM_RAYS = 96
# the batch keys renderer.render reads
RENDER_KEYS = ("campos", "camrotc2w", "raydir", "bg_color", "images_nearest",
               "c2w_nearest", "campos_nearest", "intrinsic_nearest",
               "frame_weight_nearest")


def configs(**agg):
    """(JAX tiny_test, port tiny_test), with aggregator overrides on both."""
    jc, tc = JC.tiny_test(), TC.tiny_test()
    if agg:
        jc = jc.replace(agg=dataclasses.replace(jc.agg, **agg))
        tc = tc.replace(agg=dataclasses.replace(tc.agg, **agg))
    return jc, tc


def t(x):
    return torch.as_tensor(np.array(x))


def n(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def make_scene(jc, tc, seed=0, num_points=NUM_POINTS):
    """Both packages' points and grids over one numpy point cloud."""
    a = tsyn.scene_arrays(tc, num_points, seed)
    jpts = jnpts.init_from_arrays(
        a["xyz"], jc.points, embedding=a["embedding"], conf=a["conf"],
        color=a["color"], dirs=a["dirs"])
    mask = np.ones(len(a["xyz"]), bool)
    jgeom = JVG.compute_grid_geometry(a["xyz"], mask, jc.querier)
    jgrid = JVG.build_grid_jit(jpts.xyz, jpts.mask, jgeom, jc.querier)
    tpts = from_jax.points_from_numpy(np.asarray(jpts.table),
                                      np.asarray(jpts.mask),
                                      tc.points.feature_dim, device=CPU)
    tgeom = TVG.compute_grid_geometry(a["xyz"], mask, tc.querier, device=CPU)
    tgrid = TVG.build_grid(tpts.xyz, tpts.mask, tgeom, tc.querier)
    return (jpts, jgrid), (tpts, tgrid)


def make_batch(tc, seed=1, num_rays=NUM_RAYS):
    """(JAX batch, port batch) of the keys the render reads."""
    b = tsyn.batch_arrays(tc, seed, num_rays)
    b = {k: v for k, v in b.items() if k in RENDER_KEYS}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: t(v) for k, v in b.items()})


def numpy_params(jax_init, seed=0):
    """Random numpy weights with the shapes `jax_init(key)` makes
    (jax.eval_shape: no JAX compute), xavier-scaled per leaf; an int leaf
    keeps its value (then the initialiser runs once)."""
    shapes = jax.eval_shape(jax_init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    if any(jnp.issubdtype(s.dtype, jnp.integer)
           for s in jax.tree_util.tree_leaves(shapes)):
        # an int leaf (attention's num_heads) keeps the initialiser's value
        real = jax_init(jax.random.PRNGKey(0))
        shapes = jax.tree_util.tree_map(
            lambda s, r: r if isinstance(r, int) else s, shapes, real)

    def draw(s):
        if isinstance(s, int):
            return s
        if len(s.shape) == 1:
            return rng.uniform(-0.1, 0.1, s.shape).astype(np.float32)
        rf = int(np.prod(s.shape[:-2]))
        lim = np.sqrt(6.0 / (rf * (s.shape[-2] + s.shape[-1])))
        return rng.uniform(-lim, lim, s.shape).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def make_params(jc, seed=0, alpha_bias=0.0):
    """(JAX params, the same weights as port tensors via io.from_jax).
    `alpha_bias` raises the density head's bias, so that a render's colour
    comes from the points rather than the background."""
    tree = numpy_params(lambda k: jrenderer.init_params(k, jc), seed)
    tree["aggregator"]["alpha"][-1]["b"] += np.float32(alpha_bias)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            from_jax.params_from_numpy(tree, device=CPU))


def write_fake_scannet(root, scan="scene_test", n_frames=12, hw=(48, 64),
                       ext="jpg", blur_list=(), frame_weights=None,
                       bad_pose=(), seed=0):
    """A miniature scene in the reference's exported layout under
    root/scan (tests/test_integration.py's fake scene): the camera slides
    along x looking down +z at a wall 2 m away; colour frames of seeded
    noise (.jpg through PIL, .png through imageio), 16-bit depth PNGs,
    4x4 intrinsics.  `blur_list` goes to exported/blur_list.txt,
    `frame_weights` to root/frame_weights_step5, and the frames of
    `bad_pose` get a pose past the validity filter."""
    import os

    import imageio.v2 as imageio
    from PIL import Image
    base = os.path.join(str(root), scan, "exported")
    for sub in ("color", "pose", "depth", "intrinsic"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    H, W = hw
    intr = np.array([[40.0 * W / 64, 0, W / 2], [0, 40.0 * W / 64, H / 2],
                     [0, 0, 1]])
    k4 = np.block([[intr, np.zeros((3, 1))], [np.zeros((1, 3)), 1]])
    for name in ("intrinsic_color", "intrinsic_depth"):
        np.savetxt(os.path.join(base, f"intrinsic/{name}.txt"), k4)
    rng = np.random.default_rng(seed)
    for i in range(n_frames):
        c2w = np.eye(4)
        c2w[0, 3] = 0.05 * i
        if i in bad_pose:
            c2w[2, 3] = 100.0
        np.savetxt(os.path.join(base, f"pose/{i}.txt"), c2w)
        img = rng.uniform(0, 255, (H, W, 3)).astype(np.uint8)
        path = os.path.join(base, f"color/{i}.{ext}")
        if ext == "jpg":
            Image.fromarray(img).save(path)
        else:
            imageio.imwrite(path, img)
        depth_mm = np.full((H, W), 2000, np.uint16)
        depth_mm[: H // 4] = 9000          # beyond 8 m: filtered out
        imageio.imwrite(os.path.join(base, f"depth/{i}.png"), depth_mm)
    if blur_list:
        with open(os.path.join(base, "blur_list.txt"), "w") as f:
            f.write("".join(f"{v}\n" for v in blur_list))
    if frame_weights is not None:
        os.makedirs(os.path.join(str(root), "frame_weights_step5"),
                    exist_ok=True)
        np.save(os.path.join(str(root), "frame_weights_step5",
                             f"{scan}_frame_weight_step5.npy"),
                np.asarray(frame_weights))
    return str(root), scan


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for a test module that imports this
    fixture.  The suite runs in several worker processes on one CPU; with
    torch's default of a thread per core each worker's many small ops wait
    on the others' threads (a module of small renders ran 100x slower
    that way than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_mvs_params(jax_init, seed=0):
    """numpy_params for the MVS networks, with each batch norm's `var`
    drawn in [0.5, 1.5] and `scale` in [0.8, 1.2] (numpy_params draws a
    1-D leaf in +-0.1, and a negative variance has no rsqrt).  Works on
    a tree or on JAX's MvsPointsParams (its None parts kept)."""
    tree = numpy_params(jax_init, seed)
    rng = np.random.default_rng(seed + 1000)

    def fix(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias", "mean", "var"}:
                return dict(node, var=rng.uniform(
                    0.5, 1.5, node["var"].shape).astype(np.float32),
                    scale=rng.uniform(0.8, 1.2, node["scale"].shape)
                    .astype(np.float32))
            return {k: fix(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(None if v is None else fix(v) for v in node))
        if isinstance(node, list):
            return [fix(v) for v in node]
        return node

    return fix(tree)


def jax_tree(tree):
    """A numpy tree (or MvsPointsParams) as JAX arrays."""
    return jax.tree_util.tree_map(jnp.asarray, tree)


def mvsnet_state_dict(seed=0):
    """A seeded state_dict of the official MVSNet under the reference's
    names (JAX io/torch_import.py:79-111 reads them; the trainer saves
    them `module.`-prefixed in {"model": ...}): numpy float32 arrays in
    torch's layouts, batch norms with positive variances."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, o, i, *k, bias=False):
        lim = np.sqrt(6.0 / (i * np.prod(k) + o * np.prod(k)))
        sd[f"{name}.weight"] = rng.uniform(-lim, lim, (o, i) + k)
        if bias:
            sd[f"{name}.bias"] = rng.uniform(-0.1, 0.1, o)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.8, 1.2, c)
        sd[f"{name}.bias"] = rng.uniform(-0.1, 0.1, c)
        sd[f"{name}.running_mean"] = rng.uniform(-0.1, 0.1, c)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c)

    for i, (cin, cout, k) in enumerate([(3, 8, 3), (8, 8, 3), (8, 16, 5),
                                        (16, 16, 3), (16, 16, 3),
                                        (16, 32, 5), (32, 32, 3)]):
        conv(f"feature.conv{i}.conv", cout, cin, k, k)
        bn(f"feature.conv{i}.bn", cout)
    conv("feature.feature", 32, 32, 3, 3, bias=True)
    cr = "cost_regularization"
    for i, (cin, cout) in enumerate([(32, 8), (8, 16), (16, 16), (16, 32),
                                     (32, 32), (32, 64), (64, 64)]):
        conv(f"{cr}.conv{i}.conv", cout, cin, 3, 3, 3)
        bn(f"{cr}.conv{i}.bn", cout)
    for i, (cin, cout) in ((7, (64, 32)), (9, (32, 16)), (11, (16, 8))):
        # ConvTranspose3d weights are [in, out, kd, kh, kw]
        conv(f"{cr}.conv{i}.0", cin, cout, 3, 3, 3)
        bn(f"{cr}.conv{i}.1", cout)
    conv(f"{cr}.prob", 1, 8, 3, 3, 3, bias=True)
    return {k: v.astype(np.float32) for k, v in sd.items()}


def save_mvsnet_ckpt(path, sd):
    """`sd` as the MVSNet trainer saves it: {"model": {"module.<name>":
    tensor}} through torch.save."""
    torch.save({"model": {f"module.{k}": torch.as_tensor(v)
                          for k, v in sd.items()}}, str(path))
    return str(path)
