"""The port's data parallel (parallel/mesh, parallel/distributed) on gloo,
in real CPU processes, against the port's single-process steps and the JAX
package's, at tiny_test sizes.

The ranks run tests/torch_port_parallel_ranks.py (torch and the port only)
as subprocesses that meet through a file:// rendezvous in tmp_path, one
intra-op thread each.  Every case starts from one checkpoint of the JAX
initial state (make_params carried across by io/from_jax) and takes one
sharded step with the noise of JAX's key; the test holds it against the
port's train_step / train_step_multi and JAX's.  Tolerances:

- sharded against the port's single process: the ranks sum per-shard
  partial sums where the single process sums once, so results differ in
  float32 order only: loss items rtol 1e-5 / atol 1e-7; gradients rtol
  1e-4 / atol 1e-5 * max|g| of the leaf; the state after the step, Adam's
  moments with the gradient tolerance, parameters where |g| exceeds 1e-3 *
  max|g| (Adam's first step moves each element by about +-lr whatever its
  gradient's size, so an element whose gradient lies within rounding noise
  may move the other way; elsewhere by at most lr) rtol 1e-5 / atol 1e-4 *
  lr;
- sharded against JAX: tests/test_torch_port_train.py's step tolerances
  (loss items rtol 1e-4 / atol 1e-6, gradients rtol 1e-3 / atol 1e-4 *
  max|g|, parameters rtol 1e-4 / atol 1e-3 * lr where |g| clears the
  noise); JAX's gradients are read from its first moment after one step
  from zero moments, (1 - beta1) * g;
- across the ranks of one run: every output bit for bit;
- the planted faults: the loss's and each Adam group's gradient norm's
  relative error against the single process must exceed 10 times the
  limits the correct runs meet (PLANTED_LOSS_TOL, PLANTED_NORM_TOL), or
  the ranks' states must differ.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu import config as JC
from hybridneuralrendering_tpu.models import blur as jblur
from hybridneuralrendering_tpu.parallel import distributed as jdist
from hybridneuralrendering_tpu.parallel import mesh as jmesh
from hybridneuralrendering_tpu.train import pyramid_cache as jpc
from hybridneuralrendering_tpu.train import state as jstate_mod
from hybridneuralrendering_tpu.train import step as jstep
from hybridneuralrendering_tpu_torch import config as TC
from hybridneuralrendering_tpu_torch.data import synthetic as tsyn
from hybridneuralrendering_tpu_torch.models import blur as tblur
from hybridneuralrendering_tpu_torch.ops import voxel_grid as TVG
from hybridneuralrendering_tpu_torch.parallel import distributed as tdist
from hybridneuralrendering_tpu_torch.parallel import mesh as tmesh
from hybridneuralrendering_tpu_torch.train import checkpoint as tckpt
from hybridneuralrendering_tpu_torch.train import pyramid_cache as tpc
from hybridneuralrendering_tpu_torch.train import step as tstep
from test_torch_port_train import (ALPHA_BIAS, _close_grad, _close_update,
                                   _noise, _port_state)
from torch_port_common import (  # noqa: F401  (one_torch_thread: fixture)
    make_params, make_scene, n, one_torch_thread, t)
from torch_port_parallel_ranks import CASES, flat, with_variant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(ROOT, "tests", "torch_port_parallel_ranks.py")
RUN_TIMEOUT = 300
PLANTED_LOSS_TOL, PLANTED_NORM_TOL = 1e-5, 1e-4
CORRECT = [c for c, v in CASES.items() if v[5] is None]
FAULTED = [c for c, v in CASES.items() if v[5] is not None]


def _env():
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    return env


def _launch(argv_of_rank, world, cwd):
    return [subprocess.Popen(argv_of_rank(r), cwd=cwd, env=_env(),
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
            for r in range(world)]


def _wait(procs):
    logs = [p.communicate(timeout=RUN_TIMEOUT)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


def _ref_key(case):
    kind, variant, _, _, frames, _ = CASES[case]
    return (kind, variant, frames)


def _frame_arrays(tc, F):
    out = []
    for seed in range(1, F + 1):
        a = tsyn.batch_arrays(tc, seed=seed)
        a["frame_weight"] = np.float32(0.7 + 0.1 * seed)
        out.append(a)
    return {k: np.stack([a[k] for a in out]) for k in out[0]}


def _inputs(tc, jc, jst, tst, kind, frames):
    """(numpy arrays of the case file, JAX batch, JAX key, JAX staged)."""
    if kind == "frames":
        arrays = _frame_arrays(tc, frames)
        key = jax.random.PRNGKey(41)
        noise = np.stack([_noise(k, tc)
                          for k in jax.random.split(key, frames)])
    else:
        arrays = tsyn.batch_arrays(tc, seed=1)
        arrays["frame_weight"] = np.float32(0.8)
        key = jax.random.PRNGKey(21)
        noise = _noise(key, tc)
    files = {"noise": noise, **{f"b_{k}": v for k, v in arrays.items()}}
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    jstaged = None
    if kind == "cached":
        views = range(len(arrays["images_nearest"]))
        jstaged = (jb["images_nearest"], jpc.PyramidCache(
            jc, dtype=jnp.float32).get_stack(jst.params,
                                             jb["images_nearest"], views))
        stages = tpc.PyramidCache(tc, dtype=torch.float32).get_stack(
            tst.params, t(arrays["images_nearest"]), views)
        files.update({f"s{i}": n(s) for i, s in enumerate(stages)})
    return files, jb, key, jstaged


def _outputs(items, g_net, g_table, state):
    """The layout the ranks write (torch_port_parallel_ranks._run_case),
    as copies."""
    out = {f"items/{k}": n(v).copy() for k, v in items.items()}
    out.update(flat(g_net, "grad/net/"))
    out["grad/table"] = n(g_table).copy()
    out.update(flat(state.params, "after/params/"))
    out["after/table"] = n(state.points.table).copy()
    out["after/mu_table"] = n(state.opt_pts.mu).copy()
    out["after/nu_table"] = n(state.opt_pts.nu).copy()
    out.update(flat(state.opt_net.mu, "after/mu_net/"))
    return out


def _port_single(tc, tst, files, kind):
    """The port's single-process step on the case's inputs: (outputs with
    the state before Adam, outputs with the state after)."""
    st = tdist.clone_state(tst)
    grid = TVG.grid_of(st.points.xyz, st.points.mask, tc.querier)
    bank = t(tblur.generate_kernel_bank(tc.blur))
    arrays = {k[2:]: t(v) for k, v in files.items() if k.startswith("b_")}
    noise = t(files["noise"])
    if kind == "frames":
        items, g_net, g_table = tstep.multi_loss_and_grads(
            st, grid, arrays, bank, tc, noise=noise)
    else:
        staged = None
        if kind == "cached":
            staged = (arrays["images_nearest"],
                      tuple(t(files[f"s{i}"]) for i in range(3)))
        items, g_net, g_table = tstep.loss_and_grads(
            st, grid, arrays, bank, tc, noise=noise, img_feat_staged=staged)
    before = _outputs(items, g_net, g_table, st)
    tstep.apply_updates(st, g_net, g_table, tc)
    return before, _outputs(items, g_net, g_table, st)


def _jax_step(jc, jst, jgrid, jb, key, jstaged, kind):
    """JAX's single-process step: its items, its gradients (from the first
    moment) and its state after the step."""
    bank = jnp.asarray(jblur.generate_kernel_bank(jc.blur))
    jst = jax.tree_util.tree_map(jnp.array, jst)   # the step donates it
    if kind == "frames":
        jst2, items = jstep.train_step_multi(jst, jgrid, jb, key, bank, jc)
    else:
        jst2, items = jstep.train_step(jst, jgrid, jb, key, bank, jc,
                                       jstaged)
    c1 = 1.0 - jc.optim.beta1
    return dict(
        items={k: float(v) for k, v in items.items()},
        g_net=jax.tree_util.tree_map(lambda m: np.asarray(m) / c1,
                                     jst2.opt_state_net[0].mu),
        g_table=np.asarray(jst2.opt_state_pts[0].mu["table"]) / c1,
        state=jst2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case of CASES run on its ranks, and each case's references:
    the port's single-process step ('single', with the gradients and state
    'before' Adam) and JAX's ('jax', but for the noblur variant)."""
    root = tmp_path_factory.mktemp("parallel")
    setups = {}
    for variant in sorted({v[1] for v in CASES.values()}):
        jc = with_variant(JC.tiny_test(), variant)
        tc = with_variant(TC.tiny_test(), variant)
        (jpts, jgrid), _ = make_scene(jc, tc)
        jp, _ = make_params(jc, alpha_bias=ALPHA_BIAS)
        jst = jstate_mod.create_train_state(jp, jpts, jc)
        tst = _port_state(jst, tc)
        tckpt.save_checkpoint(str(root / variant), tst)
        setups[variant] = (jc, tc, jst, tst, jgrid)
    refs_in = {}
    for case in CASES:
        kind, variant, _, _, frames, _ = CASES[case]
        jc, tc, jst, tst, _ = setups[variant]
        files, jb, key, jstaged = _inputs(tc, jc, jst, tst, kind, frames)
        np.savez(root / f"{case}.npz", **files)
        refs_in.setdefault(_ref_key(case), (files, jb, key, jstaged))
    procs = []
    for world in (2, 4):
        cases = [c for c, v in CASES.items() if v[2] == world]
        procs += _launch(lambda r, w=world, cs=cases: [
            sys.executable, RANKS, "--init-method",
            f"file://{root}/rdv{w}", "--world", str(w), "--rank", str(r),
            "--inputs", str(root), "--cases", *cs], world, ROOT)
    single, jref = {}, {}
    try:
        for rk, (files, jb, key, jstaged) in refs_in.items():
            kind, variant, _ = rk
            jc, tc, jst, tst, jgrid = setups[variant]
            single[rk] = _port_single(tc, tst, files, kind)
            if variant != "noblur":
                jref[rk] = _jax_step(jc, jst, jgrid, jb, key, jstaged, kind)
    finally:
        _wait(procs)
    ranks = {c: [dict(np.load(root / f"{c}.rank{r}.npz"))
                 for r in range(CASES[c][2])] for c in CASES}
    return dict(setups=setups, single=single, jax=jref, ranks=ranks,
                root=root)


# ------------------------------------------------------------ the layout

@pytest.mark.parametrize("world, shape", [(2, None), (4, None), (2, (1, 2)),
                                          (4, (1, 4)), (4, (2, 2))])
def test_make_mesh_layouts_equal_jax(world, shape):
    """Axis names and each rank's coordinates as JAX's make_mesh lays out
    the devices of the same index (conftest's 8 virtual CPU devices)."""
    jm = jmesh.make_mesh(JC.ParallelConfig(mesh_shape=shape),
                         jax.devices()[:world])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    cfg = TC.ParallelConfig(mesh_shape=shape)
    for r in range(world):
        m = tmesh.make_mesh(cfg, world, r)
        assert m.shape == ids.shape and m.axis_names == jm.axis_names
        assert m.group is None and m.data_size == ids.shape[-1]
        assert ids[m.coords] == jax.devices()[r].id


@pytest.mark.parametrize("shape", [(3,), (2, 3), (1, 2, 2)])
def test_make_mesh_rejects_bad_shapes(shape):
    with pytest.raises(ValueError):
        tmesh.make_mesh(TC.ParallelConfig(mesh_shape=shape), 4, 0)


def test_ray_axis_keys_equal_jax():
    assert tmesh.RAY_AXIS_KEYS == jmesh.RAY_AXIS_KEYS


@pytest.mark.parametrize("world, shape", [(2, None), (4, None), (4, (2, 2))])
def test_shard_batch_rows(world, shape):
    """Each rank's rows of the ray keys, in data order; the rest whole; the
    replicas of a data coordinate hold the same rows."""
    tc = TC.tiny_test()
    batch = {k: t(v) for k, v in tsyn.batch_arrays(tc, seed=1).items()}
    batch["pixel_idx"] = torch.arange(2 * 64).reshape(64, 2)
    cfg = TC.ParallelConfig(mesh_shape=shape)
    meshes = [tmesh.make_mesh(cfg, world, r) for r in range(world)]
    parts = [tmesh.shard_batch(batch, m, cfg) for m in meshes]
    D = meshes[0].data_size
    sh = tmesh.batch_shardings(batch, meshes[0], cfg)
    for k, v in batch.items():
        assert (sh[k].spec == ("data",)) == (k in tmesh.RAY_AXIS_KEYS)
        if k in tmesh.RAY_AXIS_KEYS:
            by_data = {}
            for m, p in zip(meshes, parts):
                assert p[k].shape[0] == v.shape[0] // D
                by_data.setdefault(m.data_index, []).append(p[k])
            for rows in by_data.values():
                assert all(torch.equal(rows[0], x) for x in rows)
            assert torch.equal(torch.cat([by_data[i][0] for i in range(D)]),
                               v)
        else:
            assert all(p[k] is v for p in parts)


def test_shard_batch_raises_when_rays_do_not_divide():
    tc = TC.tiny_test()
    batch = {k: t(v) for k, v in tsyn.batch_arrays(tc, seed=1,
                                                   num_rays=6).items()}
    m = tmesh.make_mesh(TC.ParallelConfig(), 4, 1)
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.shard_batch(batch, m, TC.ParallelConfig())


@pytest.mark.parametrize("frames, world", [(2, 1), (2, 2), (4, 2), (8, 4),
                                           (3, 2)])
def test_local_frame_ids_equal_jax(monkeypatch, frames, world):
    """JAX's arithmetic (its process count and index stood in for) and its
    refusal of frames that do not divide."""
    cfg = TC.ParallelConfig()
    for r in range(world):
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        m = tmesh.make_mesh(cfg, world, r)
        if frames % world:
            with pytest.raises(AssertionError):
                jdist.local_frame_ids(frames, None)
            with pytest.raises(ValueError, match="must divide"):
                tdist.local_frame_ids(frames, m)
        else:
            assert tdist.local_frame_ids(frames, m) == \
                jdist.local_frame_ids(frames, None)


def test_host_local_array_and_replicate_host_tree():
    """host_local_array: a tensor or an array as numpy on this host, as
    JAX's is for a fully addressable array; replicate_host_tree: host
    leaves as tensors on the rank's device, the other leaves kept."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    for v in (x, t(x), t(x).requires_grad_(True)):
        got = tdist.host_local_array(v)
        assert isinstance(got, np.ndarray) and np.array_equal(got, x)
        assert np.array_equal(got, jdist.host_local_array(jnp.asarray(x)))
    m = tmesh.make_mesh(TC.ParallelConfig(), 1, 0)
    tree = {"a": x, "b": [t(x), 3], "c": (x[0], None)}
    got = tdist.replicate_host_tree(tree, m, device="cpu")
    assert torch.is_tensor(got["a"]) and torch.equal(got["a"], t(x))
    assert torch.equal(got["b"][0], t(x)) and got["b"][1] == 3
    assert torch.equal(got["c"][0], t(x[0])) and got["c"][1] is None


def test_collectives_raise_without_a_process_group():
    """A layout-only mesh does not fall back to a single process: its
    collectives raise, as torch.distributed does before
    init_process_group."""
    assert not torch.distributed.is_initialized()
    m = tmesh.make_mesh(TC.ParallelConfig(), 2, 0)
    with pytest.raises((RuntimeError, ValueError)):
        tmesh.replicate_tree({"a": torch.ones(3)}, m, device="cpu")
    with pytest.raises((RuntimeError, ValueError)):
        tmesh.gather_rows(torch.ones(4, 3), m)


_DIST_ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
             "JAX_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
             "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def test_initialize_without_settings_does_nothing(monkeypatch):
    for k in _DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    assert tdist.initialize(device="cpu") is False
    # one process and no backend named: single-process use, unchanged
    assert tdist.initialize("127.0.0.1:1", 1, 0, device="cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    assert tdist.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_digest_sees_every_bit():
    """digest: equal for equal copies of a tree (a grid's named tuples,
    dataclasses, bools, arrays); another for one flipped bit, for a dtype
    or a shape changed."""
    tc = TC.tiny_test()
    points, grid = tsyn.make_synthetic_scene(tc, 300, device="cpu")
    tree = {"grid": grid, "points": points, "a": np.arange(4.0)}
    same = tdist.digest(tmesh.map_arrays(
        lambda x: x.copy() if isinstance(x, np.ndarray) else x.clone(),
        tree))
    assert tdist.digest(tree) == same
    table = points.table.clone()
    table.view(torch.int32)[7, 3] ^= 1
    other = dict(tree, points=dataclasses.replace(points, table=table))
    assert tdist.digest(other) != same
    for a in (np.arange(4, dtype=np.int64), np.arange(4.0).reshape(2, 2)):
        assert tdist.digest(dict(tree, a=a)) != same


@pytest.mark.parametrize("hosts", [["a"] * 2, ["a"] * 4 + ["b"] * 4,
                                   ["a", "b", "a", "b"]])
def test_host_slot_counts_the_ranks_of_each_host(hosts):
    """Each rank's index among the ranks of its host and their number,
    from the host names in one store (a rank a thread): on 2 x 4 ranks,
    rank 5 is the second of host b's four."""
    from concurrent.futures import ThreadPoolExecutor
    store = torch.distributed.HashStore()
    with ThreadPoolExecutor(len(hosts)) as pool:
        got = list(pool.map(lambda r: tdist.host_slot(
            store, r, len(hosts), hosts[r]), range(len(hosts))))
    for r, h in enumerate(hosts):
        same = [q for q, g in enumerate(hosts) if g == h]
        assert got[r] == (same.index(r), len(same))


def test_initialize_refuses_nccl_on_the_cpu(monkeypatch, tmp_path):
    for k in _DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="nccl"):
        tdist.initialize(init_method=f"file://{tmp_path}/rdv",
                         num_processes=2, process_id=0, backend="nccl",
                         device="cpu")
    with pytest.raises(ValueError, match="process id"):
        tdist.initialize(init_method=f"file://{tmp_path}/rdv",
                         num_processes=2, process_id=2, device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("names", ["jax", "torchrun"])
def test_world_one_steps_are_the_plain_steps_bit_for_bit(
        monkeypatch, runs, names):
    """A one-rank gloo group from each convention's environment: the
    ray-sharded step and the frame-sharded train_step_multi equal
    train_step and train_step_multi to the bit (loss items, gradients,
    the state after)."""
    import socket
    for k in _DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    if names == "jax":
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{port}")
        monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
        monkeypatch.setenv("JAX_PROCESS_ID", "0")
    else:
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", str(port))
        monkeypatch.setenv("WORLD_SIZE", "1")
        monkeypatch.setenv("RANK", "0")
    assert tdist.initialize(backend="gloo", device="cpu")
    try:
        _, tc, _, tst, _ = runs["setups"]["bank"]
        m = tdist.global_mesh(tc.parallel)
        assert m.shape == (1,) and m.group is not None
        for kind, case in (("rays", "rays_bank_w2"), ("frames",
                                                     "frames2_w2")):
            files = dict(np.load(runs["root"] / f"{case}.npz"))
            before, after = _port_single(tc, tst, files, kind)
            st = tdist.clone_state(tst)
            grid = TVG.grid_of(st.points.xyz, st.points.mask, tc.querier)
            bank = t(tblur.generate_kernel_bank(tc.blur))
            arrays = {k[2:]: t(v) for k, v in files.items()
                      if k.startswith("b_")}
            if kind == "frames":
                got = tdist.sharded_multi_loss_and_grads(
                    st, grid, arrays, bank, tc, m, noise=t(files["noise"]))
            else:
                got = tmesh.sharded_loss_and_grads(
                    m, st, grid, arrays, bank, tc, noise=t(files["noise"]))
            mine = _outputs(*got, st)
            tstep.apply_updates(st, got[1], got[2], tc)
            mine_after = _outputs(*got, st)
            for want, have in ((before, mine), (after, mine_after)):
                assert set(want) == set(have)
                for k in want:
                    assert np.array_equal(want[k], have[k]), (kind, k)
    finally:
        torch.distributed.destroy_process_group()


# ------------------------------------------------------- the sharded steps

def _check_items(got, want, rtol, atol):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol,
                                   err_msg=k)


def _items(out):
    return {k[len("items/"):]: float(v) for k, v in out.items()
            if k.startswith("items/")}


def _grads(out):
    return {k: v for k, v in out.items() if k.startswith("grad/")}


def _close_grad_tight(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30))


def test_cases_cut_the_blur_patches():
    """The `cut` cases' shards end inside a row of patches, and the
    learnable cases' at 4 ranks too."""
    for case in ("rays_cut_w2", "rays_cut_w4", "rays_learnable_w4"):
        _, variant, world, _, _, _ = CASES[case]
        s = with_variant(TC.tiny_test(), variant).sampling
        side = s.dilation_patch_num * s.dilation_patch_size
        rows = side * side // world
        assert rows % (side * s.dilation_patch_size), case


@pytest.mark.timeout(RUN_TIMEOUT)
@pytest.mark.parametrize("case", CORRECT)
def test_sharded_step_equals_the_single_process(runs, case):
    """Loss items, every gradient before Adam, the state after the step."""
    before, after = runs["single"][_ref_key(case)]
    out = runs["ranks"][case][0]
    _check_items(_items(out), _items(before), 1e-5, 1e-7)
    grads = _grads(before)
    assert set(_grads(out)) == set(grads) and len(grads) > 20
    for k, want in grads.items():
        _close_grad_tight(out[k], want)
    lr, plr = TC.tiny_test().optim.lr, TC.tiny_test().optim.plr
    for k, want in after.items():
        if k.startswith("after/mu") or k.startswith("after/nu"):
            _close_grad_tight(out[k], want)
        elif k.startswith("after/"):
            g = before["grad/table" if k == "after/table"
                       else "grad/net/" + k[len("after/params/"):]]
            _close_update_tight(out[k], want, before[k], g,
                                plr if k == "after/table" else lr)


def _close_update_tight(p_got, p_want, p_before, g, lr):
    sel = np.abs(g) > 1e-3 * np.abs(g).max()
    np.testing.assert_allclose(p_got[sel], p_want[sel], rtol=1e-5,
                               atol=1e-4 * lr)
    assert (np.abs(p_got - p_before) <= lr * (1 + 1e-5)
            + 1e-6 * np.abs(p_got)).all()


@pytest.mark.timeout(RUN_TIMEOUT)
@pytest.mark.parametrize("case", CORRECT)
def test_sharded_step_equals_jax(runs, case):
    """The sharded step against JAX's single-process train_step /
    train_step_multi with JAX's parameters and noise."""
    j = runs["jax"][_ref_key(case)]
    out = runs["ranks"][case][0]
    before, _ = runs["single"][_ref_key(case)]
    got = _items(out)
    for k, v in j["items"].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    jflat = flat(j["g_net"], "grad/net/")
    assert set(jflat) == {k for k in out if k.startswith("grad/net/")}
    for k, want in jflat.items():
        _close_grad(out[k], want)
    _close_grad(out["grad/table"], j["g_table"])
    jst = j["state"]
    cfg = TC.tiny_test().optim
    _close_update(out["after/table"], np.asarray(jst.points.table),
                  before["after/table"], j["g_table"], cfg.plr)
    jparams = flat(jax.tree_util.tree_map(np.asarray, jst.params),
                   "after/params/")
    for k, want in jparams.items():
        _close_update(out[k], want, before[k],
                      jflat["grad/net/" + k[len("after/params/"):]], cfg.lr)


@pytest.mark.timeout(RUN_TIMEOUT)
@pytest.mark.parametrize("case", CORRECT + FAULTED)
def test_ranks_hold_one_state(runs, case):
    """Every rank's items, gradients and state after the step, bit for
    bit; but where the all-reduce is left out the states differ, and where
    each rank takes the loss of its own rays the items do."""
    outs = runs["ranks"][case]
    fault = CASES[case][5]

    def same(prefix):
        return all(np.array_equal(outs[0][k], o[k]) for o in outs[1:]
                   for k in outs[0] if k.startswith(prefix))

    assert same("items/") == (fault != "gather")
    assert same("grad/") == same("after/") == (fault != "allreduce")


@pytest.mark.parametrize("case", ["rays_learnable_w2", "rays_learnable_w4"])
def test_post_gather_leaves_are_not_counted_per_rank(runs, case):
    """The blur MLP's leaves, read only after the gather, keep the single
    process's gradient, not W times it."""
    before, _ = runs["single"][_ref_key(case)]
    out = runs["ranks"][case][0]
    keys = [k for k in before if k.startswith("grad/net/aggregator/"
                                              "blur_kernel/")]
    assert len(keys) == 8
    for k in keys:
        assert np.abs(before[k]).max() > 0
        ratio = np.sum(out[k] * before[k]) / np.sum(before[k] * before[k])
        assert ratio == pytest.approx(1.0, rel=1e-4), k


def _deviation(out, ref):
    """(loss relative error, largest relative error of the two Adam
    groups' gradient norms) against the single process."""
    loss = abs(float(out["items/loss_total"])
               - float(ref["items/loss_total"])) / abs(
                   float(ref["items/loss_total"]))
    norms = []
    for sel in (lambda k: k.startswith("grad/net/"),
                lambda k: k == "grad/table"):
        a = np.sqrt(sum(np.sum(out[k].astype(np.float64) ** 2)
                        for k in out if sel(k)))
        b = np.sqrt(sum(np.sum(ref[k].astype(np.float64) ** 2)
                        for k in ref if sel(k)))
        norms.append(abs(a - b) / b)
    return loss, max(norms)


@pytest.mark.parametrize("case", CORRECT)
def test_correct_runs_meet_the_fault_limits(runs, case):
    loss, norm = _deviation(runs["ranks"][case][0],
                            runs["single"][_ref_key(case)][0])
    assert loss <= PLANTED_LOSS_TOL and norm <= PLANTED_NORM_TOL


@pytest.mark.parametrize("case", FAULTED)
def test_planted_faults_are_rejected(runs, case):
    """The all-reduce left out, each rank's loss on its own rays (no
    gather), every rank on noise rows 0 ... R / D: each fails the checks
    by a margin."""
    outs = runs["ranks"][case]
    ref = runs["single"][_ref_key(case)][0]
    devs = [_deviation(o, ref) for o in outs]
    loss = max(d[0] for d in devs)
    norm = max(d[1] for d in devs)
    assert loss > 10 * PLANTED_LOSS_TOL or norm > 10 * PLANTED_NORM_TOL, \
        (case, loss, norm)


# ----------------------------------------------- the worker's scenarios

def _scenario(tmp_path, scenario, world=2):
    procs = _launch(lambda r: [
        sys.executable, "-m",
        "hybridneuralrendering_tpu_torch.parallel.distributed",
        "--init-method", f"file://{tmp_path}/rdv",
        "--num-processes", str(world), "--process-id", str(r),
        "--scenario", scenario, "--device", "cpu", "--backend", "gloo",
        "--workdir", str(tmp_path), "--out", str(tmp_path / f"r{r}.json")],
        world, ROOT)
    _wait(procs)
    import json
    return [json.load(open(tmp_path / f"r{r}.json")) for r in range(world)]


@pytest.mark.timeout(RUN_TIMEOUT)
def test_lifecycle_scenario_two_ranks(tmp_path):
    """Three frame-sharded steps, probe and grow, a rank-0 checkpoint read
    by both ranks, an eval chunk: points added, the best PSNR and xyz
    round-tripped, the ranks' digests (the grown grid's too) equal to the
    bit."""
    d = _scenario(tmp_path, "lifecycle")
    assert d[0] == d[1]
    assert d[0]["added"] > 0 and d[0]["best"] == 1.25
    assert d[0]["restored_xyz_sum"] == d[0]["xyz_sum"]
    assert all(np.isfinite(v) for k, v in d[0].items() if k != "grid")


@pytest.mark.timeout(RUN_TIMEOUT)
def test_dryrun_and_parity_scenarios_two_ranks(tmp_path):
    """The dry run (step, grow, prune, checkpoint, step) with equal
    digests; parity on the (1, 2) mesh: the sharded losses within the
    step tolerance of the single process's."""
    (tmp_path / "dry").mkdir()
    d = _scenario(tmp_path / "dry", "dryrun")
    assert d[0] == d[1]
    assert d[0]["added"] == 64 and d[0]["pruned"] >= 32
    assert len(d[0]["losses"]) == 4 and np.isfinite(d[0]["losses"]).all()
    (tmp_path / "par").mkdir()
    p = _scenario(tmp_path / "par", "mesh2d")
    assert p[0] == p[1]
    for k in ("frames_loss", "rays_loss"):
        assert p[0][k] == pytest.approx(p[0][k + "_single"], rel=1e-5)


@pytest.mark.timeout(RUN_TIMEOUT)
def test_torchrun_runs_the_parity_scenario(tmp_path):
    """Two ranks under torch.distributed.run (torchrun): initialize reads
    its environment (env:// rendezvous); the sharded losses as the single
    process's."""
    import json
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "-m", "hybridneuralrendering_tpu_torch.parallel.distributed",
         "--scenario", "parity", "--device", "cpu",
         "--out", str(tmp_path / "r{rank}.json")],
        cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=RUN_TIMEOUT)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    p = [json.load(open(tmp_path / f"r{r}.json")) for r in range(2)]
    assert p[0] == p[1]
    for k in ("frames_loss", "rays_loss"):
        assert p[0][k] == pytest.approx(p[0][k + "_single"], rel=1e-5)
