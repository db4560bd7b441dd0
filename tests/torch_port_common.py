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
    (jax.eval_shape: no JAX compute), xavier-scaled per leaf."""
    shapes = jax.eval_shape(jax_init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(s):
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
