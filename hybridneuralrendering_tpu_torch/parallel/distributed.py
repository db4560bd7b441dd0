"""Multi-process training over torch.distributed: process init, frame-
sharded batches and steps, per-host copies of the replicated state (JAX:
hybridneuralrendering_tpu/parallel/distributed.py).

  - every rank calls `initialize()` (init_process_group), builds the same
    mesh (`global_mesh`) and runs the same step on its own rows
    (parallel/mesh.make_sharded_train_step) or its own frames
    (`train_step_multi`), which sum their gradients over the mesh's data
    group and apply both Adams on every rank;
  - the point cloud, the grid and the parameters are replicated; each rank
    loads only its own frames in multi-frame mode (`local_frame_ids`,
    `global_frame_batch`), so frame loading, the expensive host work,
    scales with the ranks;
  - the lifecycle runs on every rank on identical inputs and seeds (grow
    and prune are deterministic), a checkpoint is written by rank 0 and,
    after a barrier, read by every rank.

Single-process use is unchanged: `initialize()` does nothing without
settings.  Nothing falls back: under NCCL each rank needs a device of its
own, and a failed init_process_group raises.

`python -m hybridneuralrendering_tpu_torch.parallel.distributed` runs one
rank of a worker (`_worker_main`): the scenarios parity, lifecycle, mesh2d
and dryrun, each writing a line of numbers to --out.
"""

from __future__ import annotations

import hashlib
import os
import socket
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from hybridneuralrendering_tpu_torch.config import Config, ParallelConfig
from hybridneuralrendering_tpu_torch.device import device_batch, resolve
from hybridneuralrendering_tpu_torch.parallel import mesh as pmesh
from hybridneuralrendering_tpu_torch.train import step as step_mod


def host_slot(store, rank: int, world_size: int, host: Optional[str] = None):
    """(this rank's index among the ranks on its host, how many ranks its
    host has), from every rank's host name, which each rank writes into
    the rendezvous `store` (host: default socket.gethostname())."""
    store = dist.PrefixStore("host_of_rank", store)
    host = host or socket.gethostname()
    store.set(str(rank), host)
    hosts = [store.get(str(r)).decode() for r in range(world_size)]
    here = [r for r, h in enumerate(hosts) if h == host]
    return here.index(rank), len(here)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               init_method: Optional[str] = None,
               device="cuda") -> bool:
    """init_process_group from the arguments or the environment: JAX's
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, else
    torchrun's MASTER_ADDR and MASTER_PORT / WORLD_SIZE / RANK.  Unless
    `init_method` is given, the coordinator address becomes tcp://<address>,
    and torchrun's variables env://.

    The backend is `backend`, else nccl when `device` is CUDA and gloo on
    the CPU.  Under nccl each rank of a host takes a CUDA device of its
    own: its index among the ranks of its host (LOCAL_RANK and
    LOCAL_WORLD_SIZE where torchrun sets them, else `host_slot` over the
    rendezvous store, so a job may span hosts); more ranks on a host than
    it has devices raise before the process group is made.  gloo lets ranks
    share one device.  Returns True when a process group was made; without
    an address, or with one process and no backend named, it does nothing
    and returns False."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(env.get("JAX_NUM_PROCESSES")
                            or env.get("WORLD_SIZE") or 0)
    if process_id is None:
        process_id = int(env.get("JAX_PROCESS_ID") or env.get("RANK") or -1)
    if init_method is None:
        if coordinator_address:
            init_method = f"tcp://{coordinator_address}"
        elif env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
            # torchrun's rendezvous (its agent may already hold the port)
            init_method = "env://"
    if not init_method or num_processes < 1 or (
            num_processes == 1 and backend is None):
        return False
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} of {num_processes}")
    dev = resolve(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend != "nccl":
        dist.init_process_group(backend, init_method=init_method,
                                world_size=num_processes, rank=process_id)
        return True
    if dev.type != "cuda":
        raise ValueError("the nccl backend needs device='cuda'")
    store, _, _ = next(dist.rendezvous(init_method, process_id,
                                       num_processes))
    if "LOCAL_RANK" in env and "LOCAL_WORLD_SIZE" in env:
        local, per_host = int(env["LOCAL_RANK"]), int(env["LOCAL_WORLD_SIZE"])
    else:
        local, per_host = host_slot(store, process_id, num_processes)
    if per_host > torch.cuda.device_count():
        raise ValueError(
            f"nccl needs a CUDA device per rank: {per_host} ranks on a host "
            f"of {torch.cuda.device_count()} devices (backend='gloo' lets "
            f"ranks share a device)")
    torch.cuda.set_device(local)
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id)
    return True


def global_mesh(cfg: ParallelConfig) -> pmesh.Mesh:
    """The mesh over every rank of the process group (every rank must
    build the same)."""
    return pmesh.make_mesh(cfg)


def local_frame_ids(num_frames: int, mesh: pmesh.Mesh) -> range:
    """The frame indices this rank loads for a frame-sharded batch: frames
    split evenly over the data axis (num_frames must divide by its size,
    for fixed shapes); replicas load the same frames."""
    n = mesh.data_size
    if num_frames % n:
        raise ValueError(f"frames_per_step={num_frames} must divide over "
                         f"{n} processes")
    per = num_frames // n
    start = mesh.data_index * per
    return range(start, start + per)


def global_frame_batch(local_batches: Dict, device="cuda") -> Dict:
    """This rank's frames (step.stack_batches over local_frame_ids) as
    tensors on its device, without the host-only keys (device_batch):
    the rank's shard of the frame axis, which train_step_multi takes."""
    return device_batch(local_batches, device)


def sharded_multi_loss_and_grads(
        state, grid, batches: Dict, blur_kernels: Optional[torch.Tensor],
        cfg: Config, mesh: pmesh.Mesh,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None, img_feat_staged=None):
    """train/step.multi_loss_and_grads with the frames sharded over the
    data axis.  `batches` (and `img_feat_staged`) hold this rank's F / D
    frames (local_frame_ids); `noise` [F, R, z_depth_dim] is every
    frame's, or each frame's is drawn from `generator` in frame order
    (seeded alike on every rank), so a rank jitters its frames as the
    single process does.  Each frame adds the gradient of its total / F;
    the gradients are then summed over the data group.  Returns (items:
    the means over all F frames, the network gradients, the table
    gradient or None), the same on every rank."""
    if noise is None and generator is None:
        raise ValueError("the sharded step needs `noise` or a `generator` "
                         "seeded alike on every rank")
    batches = step_mod.device_batch(batches)
    n_local = batches["raydir"].shape[0]
    F = n_local * mesh.data_size
    first = mesh.data_index * n_local
    if noise is None:
        noise = torch.stack([step_mod.candidate_noise(
            {"raydir": batches["raydir"][0]}, cfg, generator, None)
            for _ in range(F)])
    params, points = step_mod.grad_leaves(state)
    per_frame = step_mod.frames_backward(
        params, points, grid, batches, blur_kernels, cfg,
        noise=noise[first:first + n_local], img_feat_staged=img_feat_staged,
        num_frames=F)
    # every frame's items in frame order, so that their means are the
    # single process's to the bit
    keys = list(per_frame[0])
    local = torch.stack([torch.stack([it[k] for k in keys])
                         for it in per_frame])                # [F/D, items]
    every = pmesh.gather_rows(local, mesh).t().contiguous()   # [items, F]
    items = {k: torch.mean(every[j]) for j, k in enumerate(keys)}
    g_net, g_table = step_mod.leaf_grads(state, params, points)
    pmesh.reduce_grads(g_net, g_table, mesh)
    return items, g_net, g_table


def train_step_multi(state, grid, batches: Dict,
                     blur_kernels: Optional[torch.Tensor], cfg: Config,
                     mesh: pmesh.Mesh,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None,
                     img_feat_staged=None):
    """The frame-sharded train_step_multi: sharded_multi_loss_and_grads,
    then both Adams on every rank (in place).  Returns (state, items)."""
    items, g_net, g_table = sharded_multi_loss_and_grads(
        state, grid, batches, blur_kernels, cfg, mesh, generator, noise,
        img_feat_staged)
    return step_mod.apply_updates(state, g_net, g_table, cfg), items


def host_local_array(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array on this
    host.  Every rank holds the whole replicated state, so this is its
    own copy; host-side lifecycle code (probe and grow, the grid's
    geometry, checkpoints) reads the state through it."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def replicate_host_tree(tree, mesh: pmesh.Mesh, device="cuda"):
    """Host arrays (and tensors) of `tree` onto this rank's device, with no
    communication: every rank must pass the same value (mesh.replicate_tree
    broadcasts rank 0's instead)."""
    dev = resolve(device)
    return pmesh.map_arrays(lambda x: torch.as_tensor(x).to(dev), tree)


# ---------------------------------------------------------------------------
# Multi-process worker (tests/test_torch_port_parallel.py and chip_smoke.py
# launch N of these)
# ---------------------------------------------------------------------------

def clone_state(state):
    """A copy of a TrainState whose tensors the steps may update in
    place."""
    return pmesh.map_arrays(lambda t: t.clone(), state)


def replicated_start(cfg: Config, num_points: int, mesh: pmesh.Mesh,
                     device="cuda"):
    """(state, grid, blur kernels or None) of the synthetic scene and the
    seeded parameters, the state broadcast from rank 0 (replicate_tree);
    each rank builds the grid from those points."""
    from hybridneuralrendering_tpu_torch.data import synthetic
    from hybridneuralrendering_tpu_torch.models import blur, renderer
    from hybridneuralrendering_tpu_torch.ops import voxel_grid as VG
    from hybridneuralrendering_tpu_torch.train import state as state_mod
    dev = resolve(device)
    points, _ = synthetic.make_synthetic_scene(cfg, num_points, seed=0,
                                               device=dev)
    params = renderer.init_params(cfg, seed=0, device=dev)
    state = pmesh.replicate_tree(
        state_mod.create_train_state(params, points, cfg, device=dev), mesh,
        dev)
    grid = VG.grid_of(state.points.xyz, state.points.mask, cfg.querier)
    kernels = None
    if cfg.blur.add_blur_sim:
        kernels = torch.as_tensor(blur.generate_kernel_bank(cfg.blur),
                                  device=dev)
    return state, grid, kernels


def _frames(cfg: Config, seeds, device):
    from hybridneuralrendering_tpu_torch.data import synthetic
    return step_mod.stack_batches([synthetic.make_synthetic_batch(
        cfg, seed=s, device=device) for s in seeds])


def _seeded(seed: int, device) -> torch.Generator:
    return torch.Generator(device=resolve(device)).manual_seed(seed)


def parity(cfg: Config, mesh: pmesh.Mesh, state, grid, kernels,
           frames: int = 2, device="cuda") -> Dict[str, float]:
    """One frame-sharded train_step_multi of `frames` frames (this rank
    stacks only its own) and one ray-sharded step, each beside the
    single-process step from the same state and noise seed."""
    out = {}
    local = global_frame_batch(
        _frames(cfg, local_frame_ids(frames, mesh), device), device)
    _, items = train_step_multi(clone_state(state), grid, local, kernels,
                                cfg, mesh, generator=_seeded(7, device))
    _, ref = step_mod.train_step_multi(
        clone_state(state), grid, _frames(cfg, range(frames), device),
        kernels, cfg, generator=_seeded(7, device))
    out["frames_loss"] = float(items["loss_total"])
    out["frames_loss_single"] = float(ref["loss_total"])
    batch = _frames(cfg, [0], device)
    batch = {k: v[0] for k, v in batch.items()}
    fn = pmesh.make_sharded_train_step(mesh, cfg)
    _, items = fn(clone_state(state), grid, batch, kernels,
                  generator=_seeded(7, device))
    _, ref = step_mod.train_step(clone_state(state), grid, batch, kernels,
                                 cfg, generator=_seeded(7, device))
    out["rays_loss"] = float(items["loss_total"])
    out["rays_loss_single"] = float(ref["loss_total"])
    return out


def state_digest(state) -> Dict[str, float]:
    """Sums of the replicated state: equal across ranks when it stayed
    identical."""
    from hybridneuralrendering_tpu_torch.train.state import tree_leaves
    return {"step": float(state.step),
            "num_live": float(state.points.num_live),
            "xyz_sum": float(state.points.xyz[state.points.mask].double()
                             .sum()),
            "table_sum": float(state.points.table.double().sum()),
            "params_abs_sum": float(sum(t.double().abs().sum() for t in
                                        tree_leaves(state.params))),
            "mu_table_sum": float(state.opt_pts.mu.double().sum())
            if state.opt_pts is not None else 0.0}


def digest(tree) -> str:
    """A SHA-1 of the bytes of every tensor and array of `tree` (dicts,
    lists, tuples, named tuples, dataclasses: map_arrays order): equal on
    two ranks when their copies are equal bit for bit.  A grid, a state or
    a step's (items, gradients) digests in a few seconds at full width."""
    h = hashlib.sha1()

    def add(x):
        t = torch.as_tensor(x).detach()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).contiguous().cpu().view(torch.uint8).numpy()
                 .tobytes())
        return x

    pmesh.map_arrays(add, tree)
    return h.hexdigest()


class StubDataset:
    """A one-frame dataset for probe_and_grow: rays of a camera at
    (0, 0, -2.5) looking down +z, ground truth 0.25 grey (unlike the
    background, so missed rays become growth candidates)."""

    id_list = [0]

    def __init__(self, cfg: Config):
        self.height, self.width = cfg.image_hw

    def __len__(self):
        return 1

    def image(self, vid):
        return np.full((self.height, self.width, 3), 0.25, np.float32)

    def get_batch(self, idx, rng=None, pixelcoords=None):
        H, W = self.height, self.width
        pc = pixelcoords.reshape(-1, 2).astype(np.float32)
        x = (pc[:, 0] + 0.5 - W / 2) / (0.9 * W)
        y = (pc[:, 1] + 0.5 - H / 2) / (0.9 * W)
        dirs = np.stack([x, y, np.ones_like(x)], -1)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        return {"campos": np.array([0, 0, -2.5], np.float32),
                "camrotc2w": np.eye(3, dtype=np.float32),
                "raydir": dirs.astype(np.float32),
                "pixel_idx": pc.astype(np.int32),
                "gt_image": np.full((len(pc), 3), 0.25, np.float32),
                "bg_color": np.ones(3, np.float32)}


def _checkpoint_round_trip(state, cfg: Config, workdir: str,
                           best_psnr: float, device):
    """Rank 0 writes the checkpoint; after a barrier every rank reads
    it.  Returns (restored state, best PSNR)."""
    from hybridneuralrendering_tpu_torch.train import checkpoint as ckpt
    if dist.get_rank() == 0:
        ckpt.save_checkpoint(workdir, state, best_psnr=best_psnr)
    dist.barrier()
    return ckpt.load_checkpoint(ckpt.latest_checkpoint(workdir), cfg,
                                device=device)


def lifecycle(cfg: Config, mesh: pmesh.Mesh, state, grid, kernels,
              workdir: str, frames: int = 2, device="cuda"
              ) -> Dict[str, float]:
    """JAX's lifecycle scenario: three frame-sharded steps, a probe and
    grow on every rank, a rank-0 checkpoint restored on every rank, one
    eval chunk on the restored state."""
    import dataclasses

    from hybridneuralrendering_tpu_torch import serve
    from hybridneuralrendering_tpu_torch.train import lifecycle as life
    losses = []
    for i in range(3):
        seeds = local_frame_ids(frames, mesh) if i == 0 else [
            10 + (i - 1) * 7 + f for f in local_frame_ids(frames, mesh)]
        local = global_frame_batch(_frames(cfg, seeds, device), device)
        state, items = train_step_multi(
            state, grid, local, kernels, cfg, mesh,
            generator=_seeded(7 if i == 0 else 100 + i - 1, device))
        losses.append(float(items["loss_total"]))
    probe_cfg = cfg.replace(probe=dataclasses.replace(cfg.probe,
                                                      prob_thresh=0.0))
    new_points, new_grid, n_added = life.probe_and_grow(
        state.params, state.points, grid, StubDataset(cfg), probe_cfg,
        rng=np.random.default_rng(0))
    state = dataclasses.replace(state, points=new_points)
    restored, best = _checkpoint_round_trip(state, cfg, workdir, 1.25,
                                            device)
    eb = StubDataset(cfg).get_batch(0, pixelcoords=np.stack(np.meshgrid(
        np.arange(8), np.arange(8), indexing="xy"), -1))
    out = serve.render_rays(restored.params, restored.points, new_grid,
                            device_batch(eb, device), cfg)
    return {"step_loss": losses[0], "last_loss": losses[-1],
            "added": float(n_added), "best": float(best),
            "restored_xyz_sum": float(restored.points.xyz[
                restored.points.mask].double().sum()),
            "eval_mean": float(out["coarse_raycolor"].double().mean()),
            "grid": digest(new_grid), **state_digest(state)}


def dryrun(cfg: Config, mesh: pmesh.Mesh, state, grid, kernels,
           workdir: str, grow_points: int = 64, device="cuda"
           ) -> Dict[str, float]:
    """JAX's __graft_entry__.dryrun_multichip sequence on the mesh: a
    ray-sharded step; 64 seeded points grown into free slots, the grid
    rebuilt, the Adams reset, a step; the first 32 points' conf set to
    0.01 and a prune at 0.1, a step; a rank-0 checkpoint restored on every
    rank, a step.  Raises when a part does not do its work."""
    import dataclasses

    from hybridneuralrendering_tpu_torch.models import neural_points as npts
    from hybridneuralrendering_tpu_torch.ops import voxel_grid as VG
    from hybridneuralrendering_tpu_torch.train import lifecycle as life
    from hybridneuralrendering_tpu_torch.train import state as state_mod
    dev = resolve(device)
    fn = pmesh.make_sharded_train_step(mesh, cfg)
    gen = _seeded(0, dev)
    batch = {k: v[0] for k, v in _frames(cfg, [1], dev).items()}
    losses = []

    def step(st, g):
        st, items = fn(st, g, batch, kernels, generator=gen)
        losses.append(float(items["loss_total"]))
        if not np.isfinite(losses[-1]):
            raise FloatingPointError(f"step {len(losses)}: loss "
                                     f"{losses[-1]}")
        return st

    state = step(state, grid)
    live0 = state.points.num_live
    g = torch.Generator().manual_seed(7)
    n, fd = grow_points, cfg.points.feature_dim
    grown = npts.grow(
        state.points, torch.rand((n, 3), generator=g) - 0.5,
        torch.zeros((n, fd)), torch.full((n, 1), 0.3),
        torch.full((n, 3), 0.5), torch.zeros((n, 3)),
        torch.ones(n, dtype=torch.bool))
    if grown.num_live != live0 + n:
        raise AssertionError(f"grow added {grown.num_live - live0} of {n}")
    grid = VG.grid_of(grown.xyz, grown.mask, cfg.querier)
    state = step(state_mod.reset_optimizers(
        dataclasses.replace(state, points=grown), cfg), grid)
    low = dataclasses.replace(state.points, table=state.points.table.clone())
    low.conf[:32] = 0.01
    pruned, grid = life.prune_and_rebuild(low, cfg.replace(
        probe=dataclasses.replace(cfg.probe, prune_thresh=0.1)))
    n_pruned = grown.num_live - pruned.num_live
    if n_pruned < 32:
        raise AssertionError(f"prune removed {n_pruned} < 32 points")
    state = step(state_mod.reset_optimizers(
        dataclasses.replace(state, points=pruned), cfg), grid)
    restored, best = _checkpoint_round_trip(state, cfg, workdir, 1.0, dev)
    if (best != 1.0 or restored.step != state.step
            or restored.points.num_live != state.points.num_live):
        raise AssertionError("the checkpoint did not round-trip")
    saved = state_digest(state)
    state = step(restored, grid)
    return {"losses": losses, "added": float(n), "pruned": float(n_pruned),
            "saved_table_sum": saved["table_sum"], "grid": digest(grid),
            **state_digest(state)}


# the worker's scenarios run tiny_test() on a synthetic scene of this many
# points, as JAX's worker does
WORKER_POINTS = 1500


def _worker_main(argv=None):
    import argparse
    import dataclasses
    import json

    from hybridneuralrendering_tpu_torch import config as C

    parser = argparse.ArgumentParser(description="one rank of a "
                                     "multi-process scenario")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0 (tcp rendezvous)")
    parser.add_argument("--init-method", default=None,
                        help="e.g. file:///tmp/rendezvous, instead of "
                        "--coordinator")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="default: JAX_NUM_PROCESSES or WORLD_SIZE")
    parser.add_argument("--process-id", type=int, default=None,
                        help="default: JAX_PROCESS_ID or RANK")
    parser.add_argument("--frames", type=int, default=2)
    parser.add_argument("--out", required=True,
                        help="the JSON file; {rank} is replaced by the rank")
    parser.add_argument("--scenario", default="parity",
                        choices=("parity", "lifecycle", "mesh2d", "dryrun"))
    parser.add_argument("--workdir", default=None,
                        help="shared dir for the checkpoint (lifecycle, "
                        "dryrun)")
    parser.add_argument("--backend", default=None,
                        help="nccl or gloo (default: nccl on CUDA, gloo "
                        "on the CPU)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.scenario in ("lifecycle", "dryrun") and not args.workdir:
        parser.error(f"--scenario {args.scenario} needs --workdir")
    dev = resolve(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)     # the ranks share the host's cores
    if not initialize(args.coordinator, args.num_processes, args.process_id,
                      backend=args.backend, init_method=args.init_method,
                      device=dev):
        raise RuntimeError("no process group: give --coordinator or "
                           "--init-method, or run under torchrun")
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        cfg = C.tiny_test()
        if args.scenario == "mesh2d":
            # the 2-axis (replica, data) layout with one replica
            cfg = cfg.replace(parallel=dataclasses.replace(
                cfg.parallel, mesh_shape=(1, world)))
        m = global_mesh(cfg.parallel)
        state, grid, kernels = replicated_start(cfg, WORKER_POINTS, m, dev)
        if args.scenario in ("parity", "mesh2d"):
            res = parity(cfg, m, state, grid, kernels, args.frames, dev)
        elif args.scenario == "lifecycle":
            res = lifecycle(cfg, m, state, grid, kernels, args.workdir,
                            args.frames, dev)
        else:
            res = dryrun(cfg, m, state, grid, kernels, args.workdir,
                         device=dev)
        with open(args.out.format(rank=rank), "w") as f:
            json.dump(res, f)
        print(f"rank {rank}: {args.scenario} {res}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker_main()
