"""One rank of the data-parallel runs of tests/test_torch_port_parallel.py.
It imports torch and the port only (no JAX), so that a rank starts fast.

    python tests/torch_port_parallel_ranks.py --init-method file://<path> \
        --world W --rank r --inputs <dir> --cases <name> [<name> ...]

Each case reads <dir>/<case>.npz (the batch or the frames, the candidate
noise, the cached step's stage maps) and the checkpoint of its config
variant (<dir>/<variant>/0_state.npz), makes the mesh of its layout, takes
one sharded step on gloo, and writes <dir>/<case>.rank<r>.npz: the loss
items, the reduced gradients (before Adam) and the state after the step.
A case with a fault takes its step with the fault planted
(parallel/faults.py).  CASES,
VARIANTS, with_variant and flat are shared with the test.
"""

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

# config variants: (sub-config, overrides) on tiny_test with the frame
# weight (tests/test_torch_port_train._train_setup)
VARIANTS = {
    "bank": (),
    # 3 x 3 patches of 4 x 4 rays: 2 or 4 ray shards cut the patches
    "cut": (("sampling", dict(random_sample_size=12, dilation_patch_num=3,
                              dilation_patch_size=4)),),
    # the learnable blur kernel on tiny_test's patches of 4
    # (tests/test_torch_port_learnable_blur.py)
    "learnable": (("agg", dict(learnable_blur_kernel=True,
                               learnable_blur_patch_size=4)),),
    # no blur, so that a per-shard loss differs only in its normalisers
    "noblur": (("blur", dict(add_blur_sim=False)),),
}

# name -> (kind, variant, world, mesh_shape, frames, fault)
CASES = {
    "rays_bank_w2": ("rays", "bank", 2, None, 0, None),
    "rays_bank_w4": ("rays", "bank", 4, None, 0, None),
    "rays_cut_w2": ("rays", "cut", 2, None, 0, None),
    "rays_cut_w4": ("rays", "cut", 4, None, 0, None),
    "rays_learnable_w2": ("rays", "learnable", 2, None, 0, None),
    "rays_learnable_w4": ("rays", "learnable", 4, None, 0, None),
    "rays_cached_w2": ("cached", "bank", 2, None, 0, None),
    "rays_mesh12": ("rays", "bank", 2, (1, 2), 0, None),
    "rays_mesh22": ("rays", "bank", 4, (2, 2), 0, None),
    "frames2_w2": ("frames", "bank", 2, None, 2, None),
    "frames4_w2": ("frames", "bank", 2, None, 4, None),
    "frames4_mesh22": ("frames", "bank", 4, (2, 2), 4, None),
    "fault_allreduce": ("rays", "bank", 2, None, 0, "allreduce"),
    "fault_gather": ("rays", "noblur", 2, None, 0, "gather"),
    "fault_noise": ("rays", "bank", 2, None, 0, "noise"),
    "fault_allreduce_frames": ("frames", "bank", 2, None, 2, "allreduce"),
}


def with_variant(cfg, variant):
    """`cfg` (a JAX or a port Config: the same field names) with the frame
    weight and the variant's overrides."""
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss,
                                               use_frame_weight=True))
    for sub, kw in VARIANTS[variant]:
        cfg = cfg.replace(**{sub: dataclasses.replace(getattr(cfg, sub),
                                                      **kw)})
    return cfg


def flat(tree, prefix="", out=None):
    """A nested dict / list of arrays or tensors -> {path: numpy array}."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat(v, f"{prefix}{i}/", out)
    elif torch.is_tensor(tree):
        out[prefix.rstrip("/")] = tree.detach().cpu().numpy().copy()
    elif isinstance(tree, np.ndarray) or hasattr(tree, "shape"):
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


# ---------------------------------------------------------------- a rank

def _run_case(name, inputs, world, rank):
    from hybridneuralrendering_tpu_torch import config as TC
    from hybridneuralrendering_tpu_torch.models import blur as tblur
    from hybridneuralrendering_tpu_torch.ops import voxel_grid as TVG
    from hybridneuralrendering_tpu_torch.parallel import distributed as D
    from hybridneuralrendering_tpu_torch.parallel import faults
    from hybridneuralrendering_tpu_torch.parallel import mesh as pmesh
    from hybridneuralrendering_tpu_torch.train import checkpoint as ckpt
    from hybridneuralrendering_tpu_torch.train import step as step_mod

    kind, variant, w, shape, frames, fault = CASES[name]
    assert w == world, (name, w, world)
    cfg = with_variant(TC.tiny_test(), variant)
    cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel,
                                                   mesh_shape=shape))
    mesh = D.global_mesh(cfg.parallel)
    state, _ = ckpt.load_checkpoint(
        os.path.join(inputs, variant, "0_state.npz"), cfg, device="cpu")
    grid = TVG.grid_of(state.points.xyz, state.points.mask, cfg.querier)
    bank = torch.as_tensor(tblur.generate_kernel_bank(cfg.blur))
    data = np.load(os.path.join(inputs, f"{name}.npz"))
    arrays = {k[2:]: torch.as_tensor(data[k]) for k in data.files
              if k.startswith("b_")}
    noise = torch.as_tensor(data["noise"])
    staged = None
    if kind == "cached":
        staged = (arrays["images_nearest"],
                  tuple(torch.as_tensor(data[f"s{i}"]) for i in range(3)))
    with faults.planted(fault):
        if kind == "frames":
            ids = D.local_frame_ids(frames, mesh)
            local = {k: v[ids.start:ids.stop] for k, v in arrays.items()}
            items, g_net, g_table = D.sharded_multi_loss_and_grads(
                state, grid, local, bank, cfg, mesh, noise=noise)
        else:
            items, g_net, g_table = pmesh.sharded_loss_and_grads(
                mesh, state, grid, arrays, bank, cfg, noise=noise,
                img_feat_staged=staged)
        step_mod.apply_updates(state, g_net, g_table, cfg)
    out = {f"items/{k}": v.numpy() for k, v in items.items()}
    out.update(flat(g_net, "grad/net/"))
    out["grad/table"] = g_table.numpy()
    out.update(flat(state.params, "after/params/"))
    out["after/table"] = state.points.table.numpy()
    out["after/mu_table"] = state.opt_pts.mu.numpy()
    out["after/nu_table"] = state.opt_pts.nu.numpy()
    out.update(flat(state.opt_net.mu, "after/mu_net/"))
    np.savez(os.path.join(inputs, f"{name}.rank{rank}.npz"), **out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--cases", nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch.distributed as dist

    from hybridneuralrendering_tpu_torch.parallel import distributed as D
    torch.set_num_threads(1)
    if not D.initialize(init_method=args.init_method,
                        num_processes=args.world, process_id=args.rank,
                        backend="gloo", device="cpu"):
        raise RuntimeError("no process group")
    try:
        for name in args.cases:
            _run_case(name, args.inputs, args.world, args.rank)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
