"""Drive the PyTorch port on one NVIDIA GPU: build, check, serve, train.

    python3 chip_smoke.py [--profile]

Phases, each printing one JSON progress line:
  1. device      the card's name and power limit, torch and CUDA versions;
  2. build       every CUDA kernel of the port, one nvcc per source, together;
  3. kernels     each kernel against its plain PyTorch version on the card at
                 the main path's shapes, with the tolerance it holds, times,
                 bound and the time of one PyTorch library call, and the
                 kernel's time over the library's and over the bound;
                 K-min also on the device alone and bit for bit on edge
                 rows (all BIG, all +inf, few entries below BIG, k > C),
                 and at the per-voxel K-NN's width (C = 27 * P = 702) at a
                 serving chunk's and a step's rows;
                 the shading chain's forward at a serving chunk's and a
                 training step's rows and its two backward kernels at a
                 step's, with a planted fault, a bitwise repeat and the old
                 per-layer bf16 chain as a control the comparisons reject
                 and as yardstick; the row scan at float32 [602,112, 64]
                 and int32 [602,112] and [16,200,000], with an exclusive
                 scan as the planted fault (the int32 ones also timed as a
                 CUDA graph of calls: device time without the host's);
  4. scene       the 600k-point serve_config scene, grid and random
                 full-width parameters, built on the card (two row-scan
                 launches: the grid's and the supervoxels' segments);
  5. serve       4 requests of 16,384 rays through serve.render_rays, with
                 every kernel's launch count read over exactly that run (one
                 K-min and one chain forward per request); then request 0
                 again for the census of the K-min's rows (the share with
                 fewer than K entries below BIG);
     serve_pervoxel the same requests with supervoxel=False: the
                 per-voxel K-NN, one K-min a request at C = 702; request
                 0's masks and sorted neighbour ids equal to the supervoxel
                 path's and colours within 1e-4, over the samples whose
                 neighbourhood fills no voxel's P or node's Ps slots;
  6. check       the first rays of request 0 rendered again on the CPU
                 through the plain versions, compared with the card's result;
  7. train       train_config() on the same scene: 1 warm-up and 5 timed
                 train_step calls of 3,136 rays (blur bank, frame weight, the
                 pyramid CNN inside the step), every kernel's launch count
                 read over exactly the timed steps (per step one K-min, two
                 segment sums, one table Adam, one chain forward and one of
                 each chain backward kernel, no row scan); then the two segment
                 sums of one more step, captured and held against the plain
                 version;
  8. train_cached stage maps of the views from the trained parameters,
                 built once through PyramidCache (bf16), then 1 warm-up and
                 5 timed cached train_steps: the dedup gather ranks its
                 unique rows with the row scan; per step one K-min, ONE
                 segment sum (the cached map takes no gradient), one table
                 Adam, each chain kernel once and one row scan; then the
                 dedup gather against a direct table[idx] at the step's
                 ids, and the blend line (bench.py's fields: 10% uncached,
                 90% cached steps, from the config's burst schedule);
  9. train_check one step of 256 rays from one state on the card and on the
                 CPU (plain versions), compared; the same on the card with
                 each of six planted kernel faults must be rejected; then a
                 cached step the same way, where a rank scan made exclusive
                 (the dedup gather's ranks off by one) must be rejected;
     train_learnable  the learnable blur kernel at full width (49 patches
                 of 8x8 rays, a 9x9 kernel, mode 4): 1 + 5 uncached and
                 1 + 5 cached steps with the bank's launches; then
                 train_check_learnable, train_check's card-vs-CPU step with
                 the blur MLP's gradient among the checked parts and three
                 planted faults it must reject (the kernel flipped, the
                 kernels laid out by .repeat, the identity mix dropped);
 10. eval_cli    the evaluation CLI: a ScanNet-layout scene of 20 frames
                 of the requests' camera written as PNGs, the trained state
                 saved with save_checkpoint (load back bit-equal), then
                 cli.test.main scores 4 whole 480x640 test frames from that
                 file (per frame 19 K-min and 19 chain forwards, 2 row scans
                 for the grid of the loaded points, nothing else), writes
                 their PNGs and scores.txt; 256 pixels of frame 0 again on
                 the CPU from the same file must agree with the card's, and
                 the card's render of frame 0 with frame 1's pose must not;
 11. train_cli   the training CLI at train_config() on a ScanNet-layout
                 scene of 20 frames of one wall (constant 2.5 m depth PNGs,
                 4 train frames), bootstrapped from its sensor depth with a
                 hole carved by --drop-box and a cap below capacity: 420
                 steps (uncached 0-39 and 400-419, cached 40-399, the cache
                 emptied at 400), a probe-and-grow at 250 that must add
                 points, a prune at 300 that must remove them, an eval of
                 one test frame and a save at 410, the final save; then a
                 second call resumes from it for 3 steps of 2 frames
                 (train_step_multi).  Each call's launches must equal what
                 its schedule gives (_predicted_launches); it prints the
                 bootstrap, step (bare and loop wall), probe, prune,
                 rebuild, eval, save and resume times and the run's log
                 events.  A third call trains a fresh run with
                 --blur-mode learnable --native-prefetch 2 for 60 steps (40
                 uncached, 20 cached, one save), held to its schedule, its
                 checkpoint holding the blur MLP's leaves; each call prints
                 the loop's host pieces (get_batch, device_batch, the native
                 sampler's wait).  Then native_sampler (host): 50 batches at
                 480x640 through numpy get_batch and through the native
                 sampler, the native batch's checks, device_batch and the
                 tracker's float().
 12. NeRF        nerf_train_config() (fixture_nerf_points: SR = 80, the
                 chain in 16 rematerialised chunks, white background) on
                 an object scene written in the Blender layout (20 train
                 and 4 test frames at 400x400, a fused.ply of 400,000
                 surface points): nerf_scene (its grid: two row scans);
                 the chain kernels at the workload's pieces (163,840 rows
                 a request's, 144,000 a step's; K-min at its two shapes is
                 in phase 3); serve_nerf, 4 requests of 4,096 rays (per
                 request one K-min and 16 chain forwards), rays/s and
                 peak; train_nerf, 1 + 5 steps of 3,600 rays (per step one
                 K-min, 32 chain forwards with remat's recompute, 16 of
                 each backward kernel, one segment sum held against its
                 plain version, one Adam), then one step each with remat
                 off, one chunk and both, their times and peaks;
                 train_check_nerf, a 256-ray step on the card against the
                 CPU with three planted faults it must reject (the chunks
                 joined out of order, the last chunk's dW alone, a black
                 background); train_cli_nerf, cli.train --preset
                 fixture_nerf_points --load-points 1 for 60 steps and
                 cli.test on 2 whole test frames (40 chunks a frame), each
                 call's launches equal to its schedule's.
 13. knobs      the aggregator's other model code (ROADMAP item 10): the
                 chain kernels at de = 16 and 25 (the embeddings sh_intrp
                 and gau_intrp leave) in phase 3; serve_knobs, the serve
                 requests with each of sh_intrp, gau_intrp, attention,
                 attention + Gumbel and the plane background, launches as
                 the preset's, 1,024 rays against the CPU and one planted
                 fault each; train_check_<knob>, one card-vs-CPU step each.
 14. drivers    inside eval_cli, cli.render_vid (8 path frames, frame 1
                 against the CPU, frame 2 rejected) and cli.visualize (16
                 frames, PSNR lines equal to cli.test's); after
                 train_cli_nerf, render_vid_nerf (8 orbit frames).  Without
                 imageio both video calls must end with ModuleNotFoundError
                 after their PNGs, as the JAX CLI's would.
 15. query_pers after serve_knobs, the frustum querier (ops/query_pers)
                 on the serve scene from the requests' camera at vsize
                 PERS_VSIZE: the frustum grid (two row scans), the 4
                 requests (one K-min each), 1,024 rays' ids and masks
                 equal to the CPU's.
 16. edit       inside eval_cli, cli.edit on its checkpoint: the scene
                 whole and half its points turned 30 degrees and shifted
                 (900,000 points, preset serve_edit: serve with the grid
                 capacities of the merge), 8 orbit frames (per frame one
                 K-min and one chain forward a chunk, two row scans for
                 the merged grid), frame 1 against the CPU, the identity
                 rw2c rejected, the video call as render_vid's.
 17. frame_weights inside eval_cli, RAFT with seeded weights saved as a
                 reference-layout .pth: one 480x640 pair at one
                 refinement against the CPU, 3 pairs at 12 timed, then
                 cli.frame_weights on eval_cli's scene with RAFT and with
                 identity flow (card = CPU bit for bit); no kernel of the
                 port runs.
`--profile` adds a torch.profiler pass over one more request, one more
training step and one more cached step, each with the blur bank and with
the learnable kernel, and one more NeRF request and NeRF step, and prints
the kernels that took the most device time.

The last lines are the kernel table ({"kernels": [...]}; `launches` sums
the serve, serve_pervoxel, train, train_cached, train_learnable, eval_cli,
train_cli, serve_nerf, train_nerf, train_cli_nerf, serve_knobs,
render_vid, visualize, render_vid_nerf, query_pers and edit runs), the
card as
nvidia-smi names it, and {"ok": true, "device": {...}}.  Any failure exits
non-zero before those lines.  The port's float32 matmuls and convolutions run
without TF32 (torch.backends.cuda.matmul.allow_tf32 stays False; serving
and the training step set cudnn's allow_tf32 False).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

DEADLINE_S = 900
DEVICE = "cuda"     # of the scene and requests; a CPU rehearsal sets "cpu"
NUM_REQUESTS = 4
RAYS_PER_REQUEST = 16_384
CHECK_RAYS = 256
# card against CPU renders: bf16 chains round at other points on the two
# devices (one bf16 step near 1 is 2**-8); the masks must agree exactly
CHECK_TOL = 5e-3
# serve_pervoxel: the two K-NN paths keep the same neighbours and differ
# only in their order, so the colours differ by the K-sum's float32 order
PER_VOXEL_COLOUR_TOL = 1e-4
# the eval_cli phase: a scene of 20 frames (4 train, 16 test), 4 of them
# scored whole
EVAL_FRAMES, EVAL_SCORED = 20, 4
TRAIN_STEPS = 5
# the training-shape segment sum: R * SR * K cotangent rows onto the table;
# the ids and empty slots a step has (the train phase's census, PERF.md)
SEG_ROWS, SEG_COLS, SEG_IDS = 3_136 * 24 * 8, 64, 600_000
SEG_TOUCHED, SEG_EMPTY = 68_315, 408_048
# the row scan's int32 inputs on the main path: the dedup gather's first-slot
# flags over a step's R * SR * K slots (68.3k unique ids and the empty
# slots' id 0) and the supervoxel build's head flags over its 27 * 600,000
# keys (3.77M nodes, the scene line's census, PERF.md)
SCAN_RANK, SCAN_RANK_NEW = SEG_ROWS, SEG_TOUCHED + 1
SCAN_GRID, SCAN_GRID_NEW = 27 * 600_000, 3_770_000
# the train_check batch: 2x2 patches of 8x8 rays on the same scene
CHECK_PATCHES, CHECK_PATCH_SIZE = 2, 8
# the planted chain_dw fault drops the scratch's first rows: 64 of the
# batch's 256 rays, SR * K rows each
DW_FAULT_ROWS = 4_096
# the per-voxel K-NN's candidates a sample: 27 voxels of P = 26 points
PER_VOXEL_COLUMNS = 27 * 26
# the NeRF workload's K-min (SR = 80, Ps = 64, K = 8): a step's 3,600 rays
# and a request's 4,096; and its chain pieces (R * SR * K rows over
# chain_chunks = 16): a request's and a step's
NERF_SELECT_SHAPES = [(3_600 * 80, 64, 8), (4_096 * 80, 64, 8)]
NERF_CHAIN_ROWS = (4_096 * 80 * 8 // 16, 3_600 * 80 * 8 // 16)
# published H100 SXM peaks (dense): bytes/s of HBM3, float32 op/s outside
# the tensor cores, bf16 op/s on them
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12     # tensor cores, dense


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def log_kernel(name: str, row: dict) -> None:
    """One kernels-phase row, with the kernel's time over the library
    call's (where there is one) and over its bound."""
    lib = row.get("library_ms")
    log("kernels", kernel=name, **row,
        kernel_over_library=row["kernel_ms"] / lib if lib else None,
        kernel_over_bound=row["kernel_ms"] / row["bound_ms"])


def _deadline(signum, frame):
    raise TimeoutError(f"chip_smoke passed its {DEADLINE_S} s deadline")


def cuda_ms(fn, iters: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of fn per call: iters calls captured in one CUDA graph
    and replayed, so the host's time to issue them is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())
    return smi


def kernel_libs():
    from hybridneuralrendering_tpu_torch.ops import (adam, scan, segment_sum,
                                                     select, shading_chain)
    return {**select.KERNEL_LIBS, **segment_sum.KERNEL_LIBS,
            **adam.KERNEL_LIBS, **shading_chain.KERNEL_LIBS,
            **scan.KERNEL_LIBS}


def launch_counters():
    """name -> the wrapper that counts the kernel's launches in its
    `launches` (the shading chain's wrappers count in one module dict,
    shading_chain.LAUNCHES)."""
    from hybridneuralrendering_tpu_torch.ops import (adam, scan, segment_sum,
                                                     select)
    return {"k_smallest": select.k_smallest,
            "segment_sum": segment_sum.segment_sum,
            "adam_table": adam.adam_table,
            "cumsum_rows": scan.cumsum_rows}


def reset_launches():
    from hybridneuralrendering_tpu_torch.ops import shading_chain
    for fn in launch_counters().values():
        fn.launches = 0
    for k in shading_chain.LAUNCHES:
        shading_chain.LAUNCHES[k] = 0


def read_launches():
    from hybridneuralrendering_tpu_torch.ops import shading_chain
    return {**{k: fn.launches for k, fn in launch_counters().items()},
            **shading_chain.LAUNCHES}


def phase_build():
    from hybridneuralrendering_tpu_torch.ops import build
    libs = kernel_libs()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        futs = [pool.submit(build.load_library, name, srcs)
                for name, srcs in libs.items()]
        for f in futs:
            f.result()
    log("build", seconds=time.perf_counter() - t0,
        nvcc_seconds=build.BUILD_SECONDS)
    for lib in ("shading_chain", "k_smallest"):
        logs = sorted(build.BUILD_DIR.glob(f"lib{lib}-*.log"),
                      key=lambda p: p.stat().st_mtime)
        log("ptxas", lib=lib,
            kernels=ptxas_report(logs[-1].read_text()) if logs else None)


# entry-function names of csrc/shading_chain.cu and csrc/k_smallest.cu, by a
# piece of their mangled names (K-min: the thread-per-row path by its list
# size, the warp-per-row path by its columns a lane)
PTXAS_NAMES = {"chain_hopILb0": "chain_fwd bf16", "chain_hopILb1":
               "chain_bwd bf16", "chain_fwd_f32": "chain_fwd f32",
               "chain_bwd_f32": "chain_bwd f32", "dw_hop": "chain_dw bf16",
               "chain_dw_f32": "chain_dw f32", "chain_reduce": "chain_reduce",
               **{f"narrow_kernelILi{k}E": f"k_smallest narrow KB={k}"
                  for k in (4, 8, 16)},
               **{f"wide_kernelILi{n}E": f"k_smallest wide NPER={n}"
                  for n in (1, 2, 4, 8, 16, 32)}}


def ptxas_report(text):
    """Each kernel's registers and spills from the `-Xptxas -v` output."""
    out, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = next((v for k, v in PTXAS_NAMES.items() if k in line),
                        line.split("'")[1])
        elif name and ("spill" in line or "Used" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return out


def _select_inputs(S, C, gen):
    import torch
    from hybridneuralrendering_tpu_torch.ops.select import BIG
    d = torch.rand(S, C, generator=gen, device="cuda")
    d = torch.round(d * 256) / 256            # exact ties
    d[torch.rand(S, C, generator=gen, device="cuda") < 0.3] = BIG
    ids = torch.randint(0, 1 << 30, (S, C), generator=gen, device="cuda",
                        dtype=torch.int32)
    return d, ids


def _select_bound_ms(S, C, K):
    bytes_ = S * C * 8 + S * K * 8            # d, ids in; d, ids out
    ops = S * C * K                           # K min passes over C values
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _select_edge_rows(C, K, gen, n=64):
    """n rows of each kind that the fill rule meets (the plain version
    overwrites each pick with BIG, so a row short of K entries below BIG
    goes on with the lowest column then <= BIG): all BIG, all +inf, +inf
    and 3e30 with and without BIG, exact ties, random with 30% BIG, and
    1..K-1 entries below BIG among BIG, above-BIG or mixed columns."""
    import torch
    from hybridneuralrendering_tpu_torch.ops.select import BIG

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    def pick(vals):
        v = torch.tensor(vals, dtype=torch.float32, device="cuda")
        return v[torch.randint(0, len(vals), (n, C), generator=gen,
                               device="cuda")]

    ties = torch.round(rand(n, C) * 8) / 8
    ties[rand(n, C) < 0.3] = BIG
    blocks = [pick([BIG]), pick([math.inf]), pick([math.inf, 3e30, BIG]),
              pick([math.inf, 3e30]), pick([0.25, 0.5]), ties]
    for m in range(1, K):
        for rest in ([BIG], [math.inf, 3e30], [math.inf, 3e30, BIG]):
            d = pick(rest)
            cols = torch.argsort(rand(n, C), dim=1)[:, :m]
            d.scatter_(1, cols, torch.round(rand(n, cols.shape[1]) * 4) / 4)
            blocks.append(d)
    d = torch.cat(blocks)
    ids = torch.randint(0, 1 << 30, d.shape, generator=gen, device="cuda",
                        dtype=torch.int32)
    return d, ids


def phase_kernels(cfg):
    """K-min kernel vs plain at the serving shape, the training step's
    shape and two others, timed back to back and on the device alone; then
    bit for bit on edge rows through both of its paths."""
    import torch
    from hybridneuralrendering_tpu_torch.ops import select
    gen = torch.Generator(device="cuda").manual_seed(0)
    K = cfg.querier.K
    main_shape = (RAYS_PER_REQUEST * cfg.querier.SR, cfg.querier.Ps, K)
    # serving; training (3,136 rays * SR); a wide row; per-voxel K-NN rows
    # (C = 27 voxels * P points): a few, a serving chunk's, a step's
    pv = PER_VOXEL_COLUMNS
    shapes = [main_shape, (75_264, cfg.querier.Ps, K), (75_264, 64, 8),
              (4_096, pv, 8), (RAYS_PER_REQUEST * cfg.querier.SR, pv, K),
              (75_264, pv, K)] + NERF_SELECT_SHAPES
    rows = {}
    for S, C, k in shapes:
        d, ids = _select_inputs(S, C, gen)
        kd, ki = select.k_smallest(d, ids, k)
        pd, pi = select.k_smallest_plain(d, ids, k)
        torch.cuda.synchronize()
        if not (torch.equal(kd, pd) and torch.equal(ki, pi)):
            raise AssertionError(f"k_smallest kernel != plain at {S, C, k}")
        bound, by = _select_bound_ms(S, C, k)
        row = dict(
            shape=[S, C, k], equal=True,
            max_abs_err=float((kd - pd).abs().max()),
            kernel_ms=cuda_ms(lambda: select.k_smallest(d, ids, k)),
            kernel_graph_ms=graph_ms(lambda: select.k_smallest(d, ids, k),
                                     5 if S > 100_000 else 20),
            plain_ms=cuda_ms(lambda: select.k_smallest_plain(d, ids, k)),
            library_ms=cuda_ms(lambda: torch.topk(d, k, dim=1,
                                                  largest=False)),
            bound_ms=bound, bound_by=by)
        row["kernel_graph_over_bound"] = row["kernel_graph_ms"] / bound
        log_kernel("k_smallest", row)
        rows[(S, C, k)] = row
    # thread per row to C = 64 and k = 16, warp per row past either
    edge = [(32, 8), (64, 8), (32, 4), (5, 8), (33, 16), (1, 4), (702, 8),
            (64, 17)]
    n_rows = 0
    for C, k in edge:
        d, ids = _select_edge_rows(C, k, gen)
        kd, ki = select.k_smallest(d, ids, k)
        pd, pi = select.k_smallest_plain(d, ids, k)
        torch.cuda.synchronize()
        if not (torch.equal(kd, pd) and torch.equal(ki, pi)):
            raise AssertionError(f"k_smallest kernel != plain on the edge "
                                 f"rows at C={C}, k={k}")
        n_rows += d.shape[0]
    log("kernels", kernel="k_smallest", edge_rows=n_rows, shapes=edge,
        equal=True)
    return rows[main_shape]


def _bound(bytes_, ops, ops_per_s=F32_OPS_PER_S):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _integer_rows(M, C, gen):
    """Rows of integers in +-[1, 8]: every float32 partial sum of up to 2**21
    of them is exact, so the kernel must equal its plain version bit for
    bit, and one row summed twice, dropped or given to the neighbouring id
    shows."""
    import torch
    mag = torch.randint(1, 9, (M, C), generator=gen, device="cuda")
    sign = torch.randint(0, 2, (M, C), generator=gen, device="cuda") * 2 - 1
    return (mag * sign).float()


def segment_sum_row(sg, end_pos, n, label):
    """The segment-sum kernel against its plain version on id-sorted rows
    sg [M, C] with inclusive segment ends end_pos [n]:
      - sg itself within the kernel's float32 summation bound
        (ops/segment_sum.tolerance: (ceil(min(L, 128) / 4) + 3 + [P > 1]
        * (ceil(P / 8) + 2)) * 2**-24 * sum|rows| for a segment of L rows
        in P row tiles of 128);
      - integer rows with the same segments bit for bit; a planted fault
        (the first row of the longest segment counted twice) must fail
        that comparison;
      - two launches bit for bit."""
    import torch
    from hybridneuralrendering_tpu_torch.ops import segment_sum as SS
    gen = torch.Generator(device="cuda").manual_seed(n)
    M, C = sg.shape
    got = SS.segment_sum(sg, end_pos, n)
    again = SS.segment_sum(sg, end_pos, n)
    want = SS.segment_sum_plain(sg, end_pos, n)
    tol = SS.tolerance(sg, end_pos, n)
    err = (got - want).abs()
    q = _integer_rows(M, C, gen)
    got_q = SS.segment_sum(q, end_pos, n)
    want_q = SS.segment_sum_plain(q, end_pos, n)
    lens = torch.diff(end_pos.long(), prepend=end_pos.new_full((1,), -1))
    p = int(lens.argmax())
    planted = got_q.clone()
    planted[p] += q[int(end_pos[p]) - int(lens[p]) + 1]
    torch.cuda.synchronize()
    if not (err <= tol).all():
        raise AssertionError(f"segment_sum kernel != plain ({label}): max "
                             f"excess {float((err - tol).max())}")
    if not torch.equal(got, again):
        raise AssertionError(f"segment_sum kernel is not deterministic "
                             f"({label})")
    if not torch.equal(got_q, want_q):
        raise AssertionError(f"segment_sum kernel != plain on integer rows "
                             f"({label})")
    if torch.equal(planted, want_q):
        raise AssertionError(f"segment_sum check passed a planted fault "
                             f"({label})")
    used = int(end_pos[-1]) + 1 if n else 0
    ids = torch.repeat_interleave(torch.arange(n, device=sg.device), lens)
    bound, by = _bound(used * C * 4 + n * 4 + n * C * 4, used * C)
    row = dict(
        shape=[M, C, n], ids=label, rows_in_segments=used,
        touched_ids=int((lens > 0).sum()), max_segment=int(lens.max()),
        tolerance="(ceil(min(L,128)/4)+3+[P>1](ceil(P/8)+2))*2^-24"
                  "*sum|rows|; integer rows bitwise",
        max_abs_err=float(err.max()),
        max_err_over_tolerance=float((err / tol.clamp(min=1e-30)).max()),
        integer_rows_bitwise=True, planted_fault_rejected=True,
        bitwise_repeatable=True,
        kernel_ms=cuda_ms(lambda: SS.segment_sum(sg, end_pos, n)),
        plain_ms=cuda_ms(lambda: SS.segment_sum_plain(sg, end_pos, n)),
        library_ms=cuda_ms(lambda: torch.zeros(
            n, C, device=sg.device).index_add_(0, ids, sg[:used])),
        bound_ms=bound, bound_by=by)
    log_kernel("segment_sum", row)
    return row


def _sorted_segments(ids, n):
    """Segment ends of ids [M] (n marks an empty slot) after a sort."""
    import torch
    from hybridneuralrendering_tpu_torch.models.neural_points import \
        segment_ends
    return segment_ends(torch.sort(ids.int()).values, n)


def phase_kernels_train():
    """Segment sum at the training shape (ids drawn like a step's: 68.3k
    touched ids of 600k, the rest absent, two thirds of the rows empty
    slots sorted after the last id) and duplicate-heavy (a few ids, long
    segments); the table Adam over three accumulating steps at
    [600,000, 64]."""
    import torch
    from hybridneuralrendering_tpu_torch.config import OptimConfig
    from hybridneuralrendering_tpu_torch.ops import adam as A
    from hybridneuralrendering_tpu_torch.train.state import lr_schedule
    gen = torch.Generator(device="cuda").manual_seed(1)
    sg = torch.randn(SEG_ROWS, SEG_COLS, generator=gen, device="cuda")
    pool = torch.randperm(SEG_IDS, generator=gen, device="cuda")[
        :SEG_TOUCHED]
    ids = pool[torch.randint(0, SEG_TOUCHED, (SEG_ROWS,), generator=gen,
                             device="cuda")]
    ids[torch.randperm(SEG_ROWS, generator=gen, device="cuda")[
        :SEG_EMPTY]] = SEG_IDS
    segment_sum_row(sg, _sorted_segments(ids, SEG_IDS), SEG_IDS,
                    "step-like")
    heavy = torch.randint(0, 16, (SEG_ROWS,), generator=gen, device="cuda")
    segment_sum_row(sg, _sorted_segments(heavy * 37_501, SEG_IDS), SEG_IDS,
                    "16 ids")

    N, C = SEG_IDS, SEG_COLS
    o = OptimConfig()
    sched = lr_schedule(o.plr, o)
    p = torch.randn(N, C, generator=gen, device="cuda")
    kern = [p.clone(), torch.zeros_like(p), torch.zeros_like(p)]
    plain = [p.clone(), torch.zeros_like(p), torch.zeros_like(p)]
    for step in range(3):
        g = torch.randn(N, C, generator=gen, device="cuda")
        s = A.adam_scalars(step, step, sched, o.beta1, o.beta2)
        A.adam_table(kern[0], g, kern[1], kern[2], s)
        A.adam_table_plain(plain[0], g, plain[1], plain[2], s)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(kern, plain))
    if not all(torch.equal(a, b) for a, b in zip(kern, plain)):
        raise AssertionError(f"adam_table kernel != plain: max abs err "
                             f"{err}")
    lib_p = p.clone().requires_grad_(True)
    lib_p.grad = g
    lib = torch.optim.Adam([lib_p], lr=o.plr, betas=(o.beta1, o.beta2),
                           fused=True)
    bound, by = _bound(7 * N * C * 4, 15 * N * C)
    adam = dict(
        shape=[N, C], steps=3, tolerance="bitwise", max_abs_err=err,
        kernel_ms=cuda_ms(lambda: A.adam_table(kern[0], g, kern[1],
                                               kern[2], s)),
        plain_ms=cuda_ms(lambda: A.adam_table_plain(plain[0], g, plain[1],
                                                    plain[2], s)),
        library_ms=cuda_ms(lib.step), bound_ms=bound, bound_by=by)
    log_kernel("adam_table", adam)
    return adam


def scan_row(x, label, iters=10):
    """The row-scan kernel against its plain version on x:
      - int32: bit for bit;
      - float32: within ops/scan.tolerance ((depth + 2) * 2**-24 *
        cumsum|x|), and rows of integers in +-[1, 8] of the same shape (every
        partial sum exact) bit for bit;
      - a planted fault, the exclusive scan (kernel - x), must fail each
        comparison;
      - two launches bit for bit."""
    import torch
    from hybridneuralrendering_tpu_torch.ops import scan as SC
    got, again = SC.cumsum_rows(x), SC.cumsum_rows(x)
    want = SC.cumsum_rows_plain(x)
    cases = [(x, got, want)]
    if x.dtype == torch.float32:
        gen = torch.Generator(device="cuda").manual_seed(x.shape[0])
        q = _integer_rows(x.shape[0], x.shape[1], gen)
        cases.append((q, SC.cumsum_rows(q), SC.cumsum_rows_plain(q)))
        tol = SC.tolerance(x)
        err = (got.double() - want.double()).abs()
        fault = ((got - x).double() - want.double()).abs()
        max_err = float(err.max())
        over, fault_over = float((err / tol).max()), float((fault / tol)
                                                           .max())
        tolerance = "(depth+2)*2^-24*cumsum|x|; integer rows bitwise"
    else:
        max_err = float((got - want).abs().max())
        over = fault_over = None
        tolerance = "bitwise"
    torch.cuda.synchronize()
    if over is not None and (over > 1 or fault_over <= 1):
        raise AssertionError(f"cumsum_rows ({label}): kernel reads {over} "
                             f"of its tolerance, the exclusive scan "
                             f"{fault_over}")
    for xi, g, w in cases[1 if over is not None else 0:]:
        if not torch.equal(g, w):
            raise AssertionError(f"cumsum_rows kernel != plain ({label}, "
                                 f"{xi.dtype} bitwise)")
        if torch.equal(g - xi, w):
            raise AssertionError(f"cumsum_rows check passed an exclusive "
                                 f"scan ({label})")
    if not torch.equal(got, again):
        raise AssertionError(f"cumsum_rows is not deterministic ({label})")
    M = x.shape[0]
    F = x.shape[1] if x.dim() == 2 else 1
    bound, by = _bound(2 * M * F * 4, M * F)
    slow = F > 1 and M > 10 ** 5      # torch's outer-dim scans: ~0.2 s each
    lib_kw = {} if x.dtype == torch.float32 else {"dtype": torch.int32}
    if x.dtype == torch.int32 and F == 1:
        # device time alone (a CUDA graph of the calls): where a call's
        # host time exceeds its device time, kernel_ms reads the host
        graphs = dict(
            kernel_graph_ms=graph_ms(lambda: SC.cumsum_rows(x)),
            library_graph_ms=graph_ms(lambda: torch.cumsum(x, dim=0,
                                                           **lib_kw)))
    else:
        graphs = {}
    row = dict(
        shape=list(x.shape), dtype=str(x.dtype).replace("torch.", ""),
        input=label, tolerance=tolerance, max_abs_err=max_err,
        max_err_over_tolerance=over, planted_fault_over_tolerance=fault_over,
        integer_rows_bitwise=True, planted_fault_rejected=True,
        bitwise_repeatable=True,
        kernel_ms=cuda_ms(lambda: SC.cumsum_rows(x), iters),
        plain_ms=cuda_ms(lambda: SC.cumsum_rows_plain(x), 2 if slow
                         else iters),
        library_ms=cuda_ms(lambda: torch.cumsum(x, dim=0, **lib_kw),
                           2 if slow else iters),
        bound_ms=bound, bound_by=by, **graphs)
    log_kernel("cumsum_rows", row)
    return row


def _flags(n, ones, gen):
    """int32 [n] 0/1 flags with `ones` ones, the first among them."""
    import torch
    f = torch.zeros(n, dtype=torch.int32, device="cuda")
    f[torch.randperm(n - 1, generator=gen, device="cuda")[:ones - 1] + 1] = 1
    f[0] = 1
    return f


def phase_kernels_scan():
    """The row scan at the TPU kernel's function (float32 [602,112, 64], the
    JAX gather backward's cotangent shape) and at the main path's two int32
    uses: the dedup gather's ranks and the supervoxel build's segments."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(4)
    scan_row(torch.randn(SEG_ROWS, SEG_COLS, generator=gen, device="cuda"),
             "normal rows", iters=5)
    rank = scan_row(_flags(SCAN_RANK, SCAN_RANK_NEW, gen),
                    "dedup first-slot flags")
    scan_row(_flags(SCAN_GRID, SCAN_GRID_NEW, gen), "grid head flags")
    return rank


def phase_scene(cfg):
    import torch
    from hybridneuralrendering_tpu_torch.data import synthetic
    from hybridneuralrendering_tpu_torch.models import renderer
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_launches()
    points, grid = synthetic.make_synthetic_scene(
        cfg, cfg.points.num_points, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    launches = read_launches()
    params = renderer.init_params(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    # the grid build ranks the segments of its voxel ids and of its
    # supervoxel keys with the row scan, and launches nothing else
    want = dict.fromkeys(launches, 0)
    want["cumsum_rows"] = 2
    if launches != want:
        raise AssertionError(f"the grid build launched {launches}")
    log("scene", seconds=time.perf_counter() - t0,
        points=int(points.num_live), occupied_voxels=int(grid.num_occ),
        supervoxel_nodes=int(grid.num_nodes), launches=launches,
        max_memory_allocated=torch.cuda.max_memory_allocated())
    return points, grid, params


def phase_serve(cfg, points, grid, params):
    import torch
    from hybridneuralrendering_tpu_torch import serve
    from hybridneuralrendering_tpu_torch.data import synthetic
    requests = [synthetic.make_synthetic_batch(
        cfg, seed=1 + i, num_rays=RAYS_PER_REQUEST, device=DEVICE)
        for i in range(NUM_REQUESTS)]
    chunks = sum(-(-r["raydir"].shape[0] // cfg.sampling.eval_rays)
                 for r in requests)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, ms = [], []
    reset_launches()
    for req in requests:
        t0 = time.perf_counter()
        outs.append(serve.render_rays(params, points, grid, req, cfg))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    for i, out in enumerate(outs):
        for k, v in out.items():
            if v.shape[0] != RAYS_PER_REQUEST:
                raise AssertionError(f"request {i}: {k} has {v.shape[0]} "
                                     "rays")
            if v.is_floating_point() and not torch.isfinite(v).all():
                raise AssertionError(f"request {i}: {k} is not finite")
    hit = float(torch.cat([o["ray_mask"] for o in outs]).float().mean())
    if hit <= 0:
        raise AssertionError("no ray hit the scene")
    # one K-min and one chain forward per chunk, nothing of training
    want = dict.fromkeys(launches, 0)
    want.update(k_smallest=chunks, shading_chain_fwd=chunks)
    if launches != want:
        raise AssertionError(f"serving launched {launches} for {chunks} "
                             "chunks")
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    log("serve", request_ms=ms, chunks=chunks, launches=launches,
        ray_hit_share=hit, rays_per_s=NUM_REQUESTS * RAYS_PER_REQUEST
        / (sum(ms) / 1e3), steady_rays_per_s=RAYS_PER_REQUEST
        / (steady / 1e3), max_memory_allocated=torch.cuda
        .max_memory_allocated(),
        select_rows=_select_row_census(cfg, points, grid, params,
                                       requests[0]))
    return requests, outs, launches, RAYS_PER_REQUEST / (steady / 1e3)


def _full_neighbourhoods(cfg, grid, loc):
    """For shading points loc [S, 3]: whether a voxel of the kernel_size
    neighbourhood holds P points or the supervoxel node holds Ps, the caps
    past which the two K-NN paths may keep different points."""
    import torch
    from hybridneuralrendering_tpu_torch.ops import query
    from hybridneuralrendering_tpu_torch.ops import voxel_grid as VG
    q = cfg.querier
    cap = q.grid_capacity
    svox = VG.voxel_coords(loc, grid.geom)
    node = query._get_fill(grid.coor2node,
                           VG.linearize(svox, grid.geom, cap), -1)
    last_pid = grid.node_bucket[:, 4 * q.Ps - 1:4 * q.Ps].contiguous().view(
        torch.int32)[:, 0]
    full_node = (node >= 0) & (last_pid[node.clamp(min=0).long()] >= 0)
    kx, ky, kz = q.kernel_size
    offs = torch.as_tensor([[dx, dy, -(kz // 2)]
                            for dx in range(-(kx // 2), (kx + 1) // 2)
                            for dy in range(-(ky // 2), (ky + 1) // 2)],
                           device=loc.device)
    occ = query._window_gather_1d(grid.coor2occ, VG.linearize_padz(
        svox[:, None] + offs, grid.geom, cap), kz, -1).reshape(len(loc), -1)
    full_vox = ((occ >= 0) & (grid.occ_numpnts[occ.clamp(min=0).long()]
                              == q.P)).any(dim=1)
    return full_vox, full_node


def phase_serve_pervoxel(cfg, points, grid, params, requests, sv_outs):
    """The serving requests with supervoxel=False: the per-voxel K-NN, one
    K-min a chunk over C = 27 * P candidates.  Then request 0's query and
    render held to the supervoxel path's: masks equal, each sample's
    sorted neighbour ids equal and colours within PER_VOXEL_COLOUR_TOL,
    over the samples (and rays) whose neighbourhood fills neither a voxel's
    P slots nor a node's Ps."""
    import dataclasses
    import torch
    from hybridneuralrendering_tpu_torch import serve
    from hybridneuralrendering_tpu_torch.ops import query
    pcfg = cfg.replace(querier=dataclasses.replace(cfg.querier,
                                                   supervoxel=False))
    chunks = sum(-(-r["raydir"].shape[0] // cfg.sampling.eval_rays)
                 for r in requests)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, ms = [], []
    reset_launches()
    for req in requests:
        t0 = time.perf_counter()
        outs.append(serve.render_rays(params, points, grid, req, pcfg))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(launches, 0)
    want.update(k_smallest=chunks, shading_chain_fwd=chunks)
    if launches != want:
        raise AssertionError(f"per-voxel serving launched {launches} for "
                             f"{chunks} chunks")
    for i, out in enumerate(outs):
        if not all(torch.isfinite(v).all() for v in out.values()
                   if v.is_floating_point()):
            raise AssertionError(f"per-voxel request {i} is not finite")

    req = requests[0]
    near, far = cfg.render.near_plane, cfg.render.far_plane
    res = [query.query_points(grid, points.xyz, req["campos"],
                              req["raydir"], c.querier, near, far)
           for c in (cfg, pcfg)]
    sv, pv = res
    R, SR, K = sv.sample_pidx.shape
    full_vox, full_node = _full_neighbourhoods(
        cfg, grid, sv.sample_loc_w.reshape(-1, 3))
    excluded = (sv.sample_mask.reshape(-1) & (full_vox | full_node))
    keep = ~excluded.reshape(R, SR)
    keep_ray = keep.all(dim=1)
    census = dict(
        voxels_holding_P=int((grid.occ_numpnts == cfg.querier.P).sum()),
        nodes_holding_Ps=int((grid.node_bucket[:, 4 * cfg.querier.Ps - 1]
                              .contiguous().view(torch.int32) >= 0).sum()),
        samples=int(sv.sample_mask.sum()), excluded_samples=int(
            excluded.sum()), excluded_rays=int((~keep_ray).sum()))
    diffs = dict(
        sample_mask=int((sv.sample_mask != pv.sample_mask).sum()),
        pnt_mask=int((sv.pnt_mask != pv.pnt_mask)[keep].sum()),
        ray_mask=int((sv.ray_mask != pv.ray_mask)[keep_ray].sum()),
        neighbour_ids=int((torch.sort(sv.sample_pidx, dim=-1).values
                           != torch.sort(pv.sample_pidx, dim=-1).values)
                          .any(dim=-1)[keep].sum()))
    colour = float((outs[0]["coarse_raycolor"] - sv_outs[0][
        "coarse_raycolor"])[keep_ray].abs().max())
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    log("serve_pervoxel", request_ms=ms, chunks=chunks, launches=launches,
        candidates_per_sample=PER_VOXEL_COLUMNS,
        steady_rays_per_s=RAYS_PER_REQUEST / (steady / 1e3),
        max_memory_allocated=peak, census=census,
        against_supervoxel=dict(diffs, colour_max_abs_err=colour,
                                colour_tolerance=PER_VOXEL_COLOUR_TOL,
                                neighbours_found=int(sv.pnt_mask.sum())))
    if any(diffs.values()) or colour > PER_VOXEL_COLOUR_TOL \
            or not bool(sv.pnt_mask.any()):
        raise AssertionError(f"per-voxel and supervoxel paths differ: "
                             f"{diffs}, colour {colour}")
    return launches


def _select_row_census(cfg, points, grid, params, request):
    """Request 0 once more, after the counted run: of the K-min's rows (the
    query's d2 over each sample's Ps candidates), the share with fewer than
    K entries below BIG, which the fill rule decides, and the share with
    none (no supervoxel, or no candidate within the radius)."""
    from hybridneuralrendering_tpu_torch import serve
    from hybridneuralrendering_tpu_torch.ops import query
    seen = []

    def census(real):
        def k_smallest(d, ids, k):
            below = (d < query.BIG).sum(1)
            seen.append((d.shape[0], (below < k).sum(), (below == 0).sum()))
            return real(d, ids, k)
        return k_smallest

    with _Planted(query, "k_smallest", census):
        serve.render_rays(params, points, grid, request, cfg)
    rows = sum(r for r, _, _ in seen)
    return dict(rows=rows,
                short_share=float(sum(s for _, s, _ in seen)) / rows,
                empty_share=float(sum(e for _, _, e in seen)) / rows)


def cpu(x):
    """A copy on the CPU of a tensor, a NamedTuple, dict or list of them,
    or a NeuralPoints."""
    import dataclasses
    import torch
    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, dict):
        return {k: cpu(v) for k, v in x.items()}
    if isinstance(x, list):
        return [cpu(v) for v in x]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(cpu(v) for v in x))
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: cpu(getattr(x, f.name)) for f in dataclasses.fields(x)
            if torch.is_tensor(getattr(x, f.name))})
    return x


def _ray_errors(got, ref):
    """Per-output max abs error of got against ref, and the count of mask
    entries that differ."""
    import torch
    errs = {}
    for k, v in ref.items():
        g = got[k].cpu()
        errs[k] = (int((g != v).sum()) if v.dtype == torch.bool
                   else float((g.float() - v.float()).abs().max()))
    return errs


def _rejected(errs, tol):
    return {k: e for k, e in errs.items()
            if (isinstance(e, int) and e) or e > tol}


def phase_check(cfg, points, grid, params, request, out, grid_c):
    """Rays of request 0 again on the CPU through the plain versions."""
    from hybridneuralrendering_tpu_torch import serve
    pts_c = cpu(points)
    req_c = cpu(dict(request, raydir=request["raydir"][:CHECK_RAYS]))
    t0 = time.perf_counter()
    ref = serve.render_rays(cpu(params), pts_c, grid_c, req_c, cfg)
    errs = _ray_errors({k: v[:CHECK_RAYS] for k, v in out.items()}, ref)
    bad = _rejected(errs, CHECK_TOL)
    log("check", rays=CHECK_RAYS, max_abs_err=errs, tolerance=CHECK_TOL,
        seconds=time.perf_counter() - t0)
    if bad:
        raise AssertionError(f"card and CPU renders differ: {bad}")


def profile(label, fn):
    """fn() under torch.profiler: device time by kernel and by the
    record_function ranges of the port (render.*, agg.*, train.*,
    gather.*, adam.*, chain.*), and the share of the wall time the device
    was busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    stage = ("render.", "agg.", "train.", "gather.", "adam.", "chain.")
    kernels = sorted(((e.self_device_time_total, e.key, e.count)
                      for e in events if e.device_type == DeviceType.CUDA
                      and not e.key.startswith(stage)), reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    ranges = {"host": {}, "device": {}}
    for e in prof.events():
        if e.name.startswith(stage):
            side = ranges["device" if e.device_type == DeviceType.CUDA
                          else "host"]
            side[e.name] = side.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    log("profile", run=label, wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=1.0 - busy_ms / wall_ms,
        stage_span_ms=ranges,
        top_kernels=[{"name": k[:90], "device_ms": us / 1e3, "calls": c}
                     for us, k, c in kernels[:15]])


def phase_profile(cfg, points, grid, params, request):
    """One request under torch.profiler."""
    from hybridneuralrendering_tpu_torch import serve
    profile("serve", lambda: serve.render_rays(params, points, grid, request,
                                               cfg))


def old_chain(p, cfg, emb, dflat, extras):
    """The port's per-neighbour chain before the fused kernels, kept here as
    a yardstick and called by nothing of the port: one cast of inputs and
    weights to bf16 at entry, then bf16 end to end through torch's ops
    (cuBLAS products, elementwise passes and concats), as the JAX
    package's shipped chain.  Returns (feat, alpha_raw)."""
    import torch
    from hybridneuralrendering_tpu_torch.core.encoding import \
        positional_encoding
    from hybridneuralrendering_tpu_torch.models import mlp
    ft = torch.cat([emb, positional_encoding(emb, cfg.num_feat_freqs),
                    positional_encoding(dflat, abs(cfg.dist_xyz_freq))], -1)
    ft = ft.to(torch.bfloat16)
    extras = [e.to(torch.bfloat16) for e in extras]
    p = {k: [{n: t.to(torch.bfloat16) for n, t in layer.items()}
             for layer in v] for k, v in p.items()}
    ft = mlp.mlp_apply(p["block1"], ft, cfg.act_type, final_act=True)
    ft = mlp.mlp_apply(p["block3"], torch.cat([ft] + extras, -1),
                       cfg.act_type, final_act=True)
    return ft, ft @ p["alpha"][0]["w"][:, 0] + p["alpha"][0]["b"][0]


def _chain_inputs(cfg, n, gen):
    """Neighbour rows as the aggregator gives them: embeddings of the
    table's scale, offsets within the query radius (a third of the slots
    empty, zero), colours in [0, 1], unit-vector deltas and their dot."""
    import torch
    from hybridneuralrendering_tpu_torch.models import aggregator
    q = cfg.querier
    radius = q.radius_limit_scale * max(q.vsize[0], q.vsize[1])
    # the embedding the chain reads: what the distance kernel leaves
    de = cfg.agg.point_features_dim - aggregator.consumed_channels(cfg.agg)
    emb = 0.1 * torch.randn(n, de, generator=gen, device=DEVICE)
    dists = (torch.rand(n, cfg.agg.dist_dim, generator=gen, device=DEVICE)
             * 2 - 1) * radius
    dists[torch.rand(n, generator=gen, device=DEVICE) < 1 / 3] = 0.0
    unit = lambda: torch.nn.functional.normalize(                # noqa: E731
        torch.randn(n, 3, generator=gen, device=DEVICE), dim=1)
    pdir, vdir = unit(), unit()
    color = torch.rand(n, 3, generator=gen, device=DEVICE)
    extras = [color, pdir - vdir, (pdir * vdir).sum(1, keepdim=True)]
    return emb, dists, extras


def _chain_ops(layout, rows):
    """Multiply-adds of the chain's products at its real widths, x2."""
    return 2 * rows * sum(s.kin * s.nout for s in layout.layers)


def _bf16_bound(bytes_, ops):
    return _bound(bytes_, ops, BF16_OPS_PER_S)


def _rates(ops, row):
    """Achieved TFLOP/s of a chain kernel's products (ops at the real
    widths) and their share of the bf16 peak, back to back (kernel_ms) and
    on the device alone (kernel_graph_ms)."""
    out = {}
    for key, suffix in (("kernel_ms", ""), ("kernel_graph_ms", "_graph")):
        tflops = ops / (row[key] * 1e-3) / 1e12
        out["tflops" + suffix] = tflops
        out["peak_share" + suffix] = tflops * 1e12 / BF16_OPS_PER_S
    return out


def _old_chain_grads(p, cfg, emb, dists, extras, dfeat, dalpha):
    """(feat, alpha) of old_chain and the gradients of
    sum(feat * dfeat) + sum(alpha * dalpha) in its inputs and parameters,
    named as phase_kernels_chain names them."""
    import torch
    leaves = {f"{k}/{i}/{n_}": t.detach().clone().requires_grad_(True)
              for k, v in p.items() for i, layer in enumerate(v)
              for n_, t in layer.items()}
    p = {k: [{n_: leaves[f"{k}/{i}/{n_}"] for n_ in layer}
             for i, layer in enumerate(v)] for k, v in p.items()}
    x = {"d_emb": emb.clone().requires_grad_(True),
         "d_dists": dists.clone().requires_grad_(True)}
    extras = [e.clone().requires_grad_(True) for e in extras]
    feat, alpha = old_chain(p, cfg, x["d_emb"], x["d_dists"], extras)
    loss = ((feat.float() * dfeat).sum()
            + (alpha.float() * dalpha.view_as(alpha)).sum())
    names = list(x) + ["d_extra"] + list(leaves)
    g = torch.autograd.grad(loss, list(x.values()) + extras
                            + list(leaves.values()))
    g = list(g[:2]) + [torch.cat(g[2:2 + len(extras)], 1)] + \
        list(g[2 + len(extras):])
    return dict(zip(names, g))


def phase_kernels_chain(cfg, rows_=None, label=""):
    """The fused shading chain's kernels against their plain versions on the
    card (ops/shading_chain.tolerance, a relative L2 error per output) with
    random full-width weights: the forward at a serving chunk's rows
    (16,384 rays * SR * K) and at a training step's (3,136 * SR * K), the
    backward kernels at the training step's rows, two backward launches bit
    for bit.  Controls the comparisons must reject: a planted fault
    (block3's extra columns read one column off) in the forward, and
    old_chain, the per-layer chain the kernels replace, which rounds more
    (bf16 end to end), in the forward and the backward.  old_chain is also
    the yardstick, timed at the same rows.  `rows_` = (serving rows,
    training rows) replaces those two counts, and `label` prefixes the
    rows' names (the NeRF workload's chain pieces)."""
    import torch
    from hybridneuralrendering_tpu_torch.models import renderer
    from hybridneuralrendering_tpu_torch.ops import shading_chain as SC
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    a = cfg.agg
    dt_name = SC.chain_dtype(a)
    dt = SC.COMPUTE_DTYPES[dt_name]
    params = renderer.init_params(cfg, seed=2, device=DEVICE)["aggregator"]
    chain = {k: params[k] for k in ("block1", "block2", "block3", "alpha")
             if k in params}
    kpr = cfg.querier.SR * cfg.querier.K
    serve_rows, train_rows = rows_ or (RAYS_PER_REQUEST * kpr,
                                       cfg.sampling.rays_per_batch * kpr)
    rows = {}

    def over(errs):
        """The largest reading over its output's limit (> 1 rejects)."""
        return max(e / SC.tolerance(dt_name, k if k in ("feat", "alpha")
                                    else "grad") for k, e in errs.items())

    def forward_row(n, label):
        emb, dists, extras = _chain_inputs(cfg, n, gen)
        extra = torch.cat(extras, 1)
        layout = SC.chain_layout(chain, a, emb.shape[1], dists.shape[1],
                                 extra.shape[1])
        w, b = SC.pack_chain(chain, layout, dt)
        feat, alpha = SC.chain_forward(layout, w, b, emb, dists, extra)
        want_f, want_a = SC.chain_plain(emb, dists, extra, chain, a, dt_name)
        planted, _ = SC.chain_forward(layout, w, b, emb, dists,
                                      extra.roll(1, dims=1).contiguous())
        again = SC.chain_forward(layout, w, b, emb, dists, extra)
        old_f, old_a = old_chain(chain, a, emb, dists, extras)
        torch.cuda.synchronize()
        errs = {"feat": SC.rel_l2(feat, want_f),
                "alpha": SC.rel_l2(alpha, want_a)}
        control = {"feat": SC.rel_l2(old_f.float(), want_f),
                   "alpha": SC.rel_l2(old_a.float().view_as(want_a), want_a)}
        del old_f, old_a
        fault = {"feat": SC.rel_l2(planted, want_f)}
        if over(errs) > 1:
            raise AssertionError(f"chain forward kernel != plain ({label}): "
                                 f"{errs}")
        if over(fault) <= 1 or over(control) <= 1:
            raise AssertionError(f"chain forward check passed a control "
                                 f"({label}): fault {fault}, old chain "
                                 f"{control}")
        if not (torch.equal(feat, again[0]) and torch.equal(alpha, again[1])):
            raise AssertionError(f"chain forward kernel is not "
                                 f"bit-repeatable ({label})")
        del again
        iters = 5 if n > 10 ** 6 else 10
        bytes_ = (n * (emb.shape[1] + dists.shape[1] + extra.shape[1]) * 4
                  + w.numel() * w.element_size() + b.numel() * 4
                  + (feat.numel() + alpha.numel()) * 4)
        bound, by = _bf16_bound(bytes_, _chain_ops(layout, n))
        row = dict(
            shape=[n, layout.c1], rows=label,
            tolerance={k: SC.tolerance(dt_name, k) for k in errs},
            rel_l2=errs, max_abs_err=float(max((feat - want_f).abs().max(),
                                               (alpha - want_a).abs().max())),
            margin=1 / over(errs),
            planted_fault_rel_l2=fault["feat"],
            planted_fault_margin=over(fault),
            old_chain_rel_l2=control, old_chain_margin=over(control),
            bitwise_repeatable=True,
            kernel_ms=cuda_ms(lambda: SC.chain_forward(
                layout, w, b, emb, dists, extra), iters),
            kernel_graph_ms=graph_ms(lambda: SC.chain_forward(
                layout, w, b, emb, dists, extra), iters),
            plain_ms=cuda_ms(lambda: SC.chain_plain(emb, dists, extra, chain,
                                                    a, dt_name), iters),
            yardstick_old_chain_ms=cuda_ms(lambda: old_chain(
                chain, a, emb, dists, extras), iters),
            library_ms=None, bound_ms=bound, bound_by=by)
        row.update(_rates(_chain_ops(layout, n), row))
        log_kernel("shading_chain_fwd", row)
        return row, (emb, dists, extras, extra, layout, w, b)

    rows["fwd"], _ = forward_row(serve_rows, label + "serve chunk")
    rows["fwd_train"], (emb, dists, extras, extra, layout, w, b) = \
        forward_row(train_rows, label + "training step")

    n = train_rows
    F = layout.layers[layout.na + layout.nb - 1].nout
    dfeat = torch.randn(n, F, generator=gen, device=DEVICE) * 1e-3
    dalpha = torch.randn(n, 1, generator=gen, device=DEVICE) * 1e-3
    args = (layout, w, b, emb, dists, extra, dfeat, dalpha)
    d_emb, d_dists, d_extra, ascr, gscr, dbpart = SC.chain_backward(*args)
    packed = SC.chain_dw(layout, ascr, gscr, dbpart)
    again = SC.backward_on_card(*args)
    want = SC.chain_backward_plain(emb, dists, extra, chain, a, dt_name,
                                   dfeat, dalpha)
    old = _old_chain_grads(chain, a, emb, dists, extras, dfeat, dalpha)
    torch.cuda.synchronize()
    got = {"d_emb": d_emb, "d_dists": d_dists, "d_extra": d_extra}
    ref = {"d_emb": want[0], "d_dists": want[1], "d_extra": want[2]}
    for s_, g_, r_ in zip(layout.layers, SC.unpack_chain(packed, layout),
                          SC._layer_list(want[3])):
        name = f"{s_.key[0]}/{s_.key[1]}"
        got[name + "/w"], ref[name + "/w"] = g_["w"], r_["w"]
        got[name + "/b"], ref[name + "/b"] = g_["b"], r_["b"]
    errs = {k: SC.rel_l2(got[k], ref[k]) for k in got}
    control = {k: SC.rel_l2(old[k], ref[k]) for k in got}
    del old
    tol = SC.tolerance(dt_name, "grad")
    if over(errs) > 1:
        raise AssertionError(f"chain backward kernels != plain: {errs} > "
                             f"{tol}")
    if over(control) <= 1:
        raise AssertionError(f"chain backward check passed the old chain: "
                             f"{control}")
    repeat = all(torch.equal(x, y) for x, y in zip(
        (d_emb, d_dists, d_extra, packed), again))
    if not repeat:
        raise AssertionError("chain backward kernels are not bit-repeatable")
    max_err = max(float((got[k] - ref[k]).abs().max()) for k in got)
    flops = _chain_ops(layout, n)
    raw_in = n * (emb.shape[1] + dists.shape[1] + extra.shape[1]) * 4
    wbytes = w.numel() * w.element_size() + b.numel() * 4
    scratch = (ascr.numel() + gscr.numel()) * ascr.element_size()
    old_p = {k: [{n_: t.detach().clone().requires_grad_(True)
                  for n_, t in layer.items()} for layer in v]
             for k, v in chain.items()}
    emb_g, dists_g = emb.clone().requires_grad_(True), \
        dists.clone().requires_grad_(True)
    extras_g = [e.clone().requires_grad_(True) for e in extras]

    def old_fwd_bwd():
        feat, alpha = old_chain(old_p, a, emb_g, dists_g, extras_g)
        ((feat.float() * dfeat).sum()
         + (alpha.float() * dalpha.view_as(alpha)).sum()).backward()

    def fused_fwd_bwd():
        SC.chain_forward(layout, w, b, emb, dists, extra)
        SC.backward_on_card(*args)

    def dw_plain():
        return ([ascr[:, s.aoff:s.aoff + s.kp].float().t()
                 @ gscr[:, s.goff:s.goff + s.np].float()
                 for s in layout.layers], dbpart.sum(0))

    def dw_library():
        # five cuBLAS calls (one bf16 product a layer, bf16 out), not one,
        # and the db sum: a yardstick the port never calls
        return ([torch.mm(ascr[:, s.aoff:s.aoff + s.kp].t(),
                          gscr[:, s.goff:s.goff + s.np])
                 for s in layout.layers], dbpart.sum(0))

    common = dict(rows=label + "training step", tolerance={"grad": tol},
                  max_abs_err=max_err)
    # Bounds count what each kernel's function needs.  chain_bwd: the
    # recompute and dX products (2x the forward's), reading the inputs,
    # cotangents and weights and writing the input gradients (the A/G
    # scratch it writes exists only in this design and is left out).
    # chain_dw: the dW products (1x) and reading its own inputs once, the
    # A/G scratch and the db partials, and writing every dW and db; the
    # split partials exist only in this design and are left out.
    dw_in = scratch + dbpart.numel() * 4
    dw_bound = dict(bound_bytes_ms=(dw_in + packed.numel() * 4)
                    / HBM_BYTES_PER_S * 1e3,
                    bound_ops_ms=flops / BF16_OPS_PER_S * 1e3)
    rows["bwd"] = dict(
        common, rel_l2=errs, margin=1 / over(errs),
        old_chain_rel_l2=control, old_chain_margin=over(control),
        bitwise_repeatable=True,
        kernel_ms=cuda_ms(lambda: SC.chain_backward(*args), 5),
        kernel_graph_ms=graph_ms(lambda: SC.chain_backward(*args), 5),
        plain_ms=cuda_ms(lambda: SC.chain_backward_plain(
            emb, dists, extra, chain, a, dt_name, dfeat, dalpha), 5),
        library_ms=None,
        **dict(zip(("bound_ms", "bound_by"), _bf16_bound(
            raw_in * 2 + (dfeat.numel() + dalpha.numel()) * 4 + wbytes,
            2 * flops))))
    rows["dw"] = dict(
        common, kernel_ms=cuda_ms(lambda: SC.chain_dw(layout, ascr, gscr,
                                              dbpart), 5),
        kernel_graph_ms=graph_ms(lambda: SC.chain_dw(layout, ascr, gscr,
                                                     dbpart), 5),
        plain_ms=cuda_ms(dw_plain, 5), library_ms=cuda_ms(dw_library, 5),
        library="5 cuBLAS bf16 mm (one a layer) + dbpart.sum(0)",
        **dw_bound, bound_ms=max(dw_bound.values()),
        bound_by=("bytes" if dw_bound["bound_bytes_ms"]
                  >= dw_bound["bound_ops_ms"] else "operations"))
    for key, suffix in (("kernel_ms", ""), ("kernel_graph_ms", "_graph")):
        rows["dw"]["input_tb_per_s" + suffix] = (
            dw_in / (rows["dw"][key] * 1e-3) / 1e12)
    rows["dw"].update(_rates(flops, rows["dw"]))
    rows["bwd"].update(_rates(2 * flops, rows["bwd"]))
    for k in ("bwd", "dw"):
        log_kernel(f"shading_chain_{k}", rows[k])
    whole_bound, _ = _bf16_bound(raw_in + wbytes, 3 * flops)
    log("chain", rows=n, label=label or None,
        fused_fwd_bwd_ms=cuda_ms(fused_fwd_bwd, 5),
        old_chain_fwd_bwd_ms=cuda_ms(old_fwd_bwd, 5),
        backward_ms=cuda_ms(lambda: SC.backward_on_card(*args), 5),
        bound_fwd_bwd_ms=whole_bound, scratch_bytes=scratch)
    return rows


def phase_train(cfg, points, grid):
    """train_config() on the serve scene: 1 warm-up step, then TRAIN_STEPS
    timed steps; launch counts over exactly the timed steps."""
    import dataclasses
    import torch
    from hybridneuralrendering_tpu_torch.data import synthetic
    from hybridneuralrendering_tpu_torch.models import blur, renderer
    from hybridneuralrendering_tpu_torch.models import neural_points as npts
    from hybridneuralrendering_tpu_torch.train import state as TS
    from hybridneuralrendering_tpu_torch.train import step as TT
    t_setup = time.perf_counter()
    params = renderer.init_params(cfg, seed=1, device=DEVICE)
    pts = dataclasses.replace(points, table=points.table.clone())
    st = TS.create_train_state(params, pts, cfg, device=DEVICE)
    batches = [synthetic.make_synthetic_batch(cfg, seed=10 + i,
                                              device=DEVICE)
               for i in range(TRAIN_STEPS + 2)]
    bank = torch.as_tensor(blur.generate_kernel_bank(cfg.blur),
                           device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    R = cfg.sampling.rays_per_batch
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup

    t0 = time.perf_counter()
    st, _ = TT.train_step(st, grid, batches[0], bank, cfg, generator=gen)
    torch.cuda.synchronize()
    warmup_ms = (time.perf_counter() - t0) * 1e3
    before = st.points.table.clone()
    torch.cuda.reset_peak_memory_stats()
    ms, host_ms, items = [], [], []
    mem0 = torch.cuda.memory_stats()
    reset_launches()
    for b in batches[1:TRAIN_STEPS + 1]:
        t0 = time.perf_counter()
        st, it = TT.train_step(st, grid, b, bank, cfg, generator=gen)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        items.append({k: float(v) for k, v in it.items()})
    launches = read_launches()
    mem1 = torch.cuda.memory_stats()
    peak = torch.cuda.max_memory_allocated()
    after = st.points.table
    # per step: one K-min over the candidates; two segment sums (the point
    # table's and the pyramid map's gather backward); one table Adam; the
    # chain once forward and once backward (chain_bwd, chain_dw); no row
    # scan (the uncached step gathers the table directly)
    want = dict.fromkeys(launches, TRAIN_STEPS)
    want["segment_sum"] = 2 * TRAIN_STEPS
    want["cumsum_rows"] = 0
    if launches != want:
        raise AssertionError(f"training launched {launches}, want {want}")
    bad = [(i, k) for i, it in enumerate(items) for k, v in it.items()
           if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"loss items not finite: {bad}")
    F = cfg.points.feature_dim
    xyz_fixed = bool(torch.equal(after[:, :3], before[:, :3]))
    moved = (after[:, 3:3 + F + 7] != before[:, 3:3 + F + 7]).any(dim=1)
    if not xyz_fixed or not bool(moved.any()):
        raise AssertionError(f"xyz lanes fixed: {xyz_fixed}, rows whose "
                             f"trainable lanes moved: {int(moved.sum())}")

    # the two segment sums of one more step's backward (point table,
    # pyramid map), captured and held against the plain version
    captured = []
    real = npts.segment_sum
    npts.segment_sum = lambda sg, e, n: (
        captured.append((sg.clone(), e.clone(), n)) or real(sg, e, n))
    try:
        TT.loss_and_grads(st, grid, batches[-1], bank, cfg, generator=gen)
    finally:
        npts.segment_sum = real
    V, H, W = batches[-1]["images_nearest"].shape[:3]
    labels = {st.points.capacity: "step: point table",
              V * H * W: "step: pyramid map"}
    if sorted(c[2] for c in captured) != sorted(labels):
        raise AssertionError(f"a step's segment sums reduce onto "
                             f"{[c[2] for c in captured]} rows")
    step_rows = [segment_sum_row(*c, labels[c[2]])
                 for c in sorted(captured, key=lambda c: c[2] != st.points
                                 .capacity)]
    steady = sorted(ms)[len(ms) // 2]
    log("train", setup_seconds=setup_s, warmup_ms=warmup_ms, step_ms=ms,
        median_step_ms=steady, min_step_ms=min(ms), max_step_ms=max(ms),
        rays_per_step=R, rays_per_s=R / (steady / 1e3),
        max_memory_allocated=peak, launches=launches,
        # host clock until train_step returns (before the synchronize): a
        # step whose return time is near its step time waits on the host
        host_return_ms=host_ms,
        # cudaMalloc / cudaFree calls of the caching allocator in the timed
        # steps (each cudaFree waits for the device)
        device_segments_allocated=mem1["segment.all.allocated"]
        - mem0["segment.all.allocated"],
        device_segments_freed=mem1["segment.all.freed"]
        - mem0["segment.all.freed"],
        loss_items_last=items[-1], xyz_lanes_unchanged=xyz_fixed,
        rows_moved=int(moved.sum()),
        step_segments={r["ids"]: {k: r[k] for k in (
            "shape", "rows_in_segments", "touched_ids", "max_segment",
            "kernel_ms")} for r in step_rows})
    return st, batches[-1], bank, launches, step_rows[0], steady


def phase_train_cached(cfg, st, grid, bank, uncached_ms):
    """The pyramid-cached step on the trained state: the views' stage maps
    built once through PyramidCache (bf16, from the state's parameters),
    then 1 warm-up and TRAIN_STEPS timed cached steps; launch counts over
    exactly the timed steps.  Then the dedup gather of the warm-up step's
    ids against a direct table[idx], and the blend of bench.py."""
    import torch
    from hybridneuralrendering_tpu_torch.data import synthetic
    from hybridneuralrendering_tpu_torch.models import neural_points as npts
    from hybridneuralrendering_tpu_torch.train import pyramid_cache as PC
    from hybridneuralrendering_tpu_torch.train import step as TT
    batches = [synthetic.make_synthetic_batch(cfg, seed=30 + i,
                                              device=DEVICE)
               for i in range(TRAIN_STEPS + 1)]
    views = batches[0]["images_nearest"]
    cache = PC.PyramidCache(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = (views, cache.get_stack(st.params, views, range(len(views))))
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    R = cfg.sampling.rays_per_batch

    captured = []
    real = npts.dedup_gather
    npts.dedup_gather = lambda table, idx, u: (
        captured.append((table.detach(), idx.clone(), u))
        or real(table, idx, u))
    try:
        t0 = time.perf_counter()
        st, _ = TT.train_step(st, grid, batches[0], bank, cfg, generator=gen,
                              img_feat_staged=staged)
        torch.cuda.synchronize()
        warmup_ms = (time.perf_counter() - t0) * 1e3
    finally:
        npts.dedup_gather = real
    torch.cuda.reset_peak_memory_stats()
    ms, host_ms, items = [], [], []
    reset_launches()
    for b in batches[1:]:
        t0 = time.perf_counter()
        st, it = TT.train_step(st, grid, b, bank, cfg, generator=gen,
                               img_feat_staged=staged)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        items.append({k: float(v) for k, v in it.items()})
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    # per step: one K-min, ONE segment sum (the point table's: the cached
    # map takes no gradient), one table Adam, each chain kernel once, and
    # one row scan (the dedup gather's ranks)
    want = dict.fromkeys(launches, TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"cached training launched {launches}, want "
                             f"{want}")
    bad = [(i, k) for i, it in enumerate(items) for k, v in it.items()
           if not math.isfinite(v)]
    if bad or len(captured) != 1:
        raise AssertionError(f"loss items not finite: {bad}; dedup gathers "
                             f"in a step: {len(captured)}")

    # the dedup gather (with its host read of the unique count) against a
    # direct gather of the same ids; the host read alone on an idle queue
    table, idx, u_cap = captured[0]
    unique = int(torch.unique(torch.clamp(idx, min=0)).numel())
    one = torch.zeros(1, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        int(one[-1])
    read_us = (time.perf_counter() - t0) / 100 * 1e6
    dedup = dict(slots=idx.numel(), unique_ids=unique,
                 u_cap=min(u_cap, idx.numel()),
                 dedup_ms=cuda_ms(lambda: npts.dedup_gather(table, idx,
                                                            u_cap)),
                 direct_ms=cuda_ms(lambda: table[torch.clamp(idx, min=0)]),
                 host_read_us=read_us)
    steady = sorted(ms)[len(ms) // 2]
    log("train_cached", stage_map_build_ms=build_ms,
        cache=dict(hits=cache.hits, misses=cache.misses,
                   bytes=sum(x.numel() * x.element_size()
                             for x in staged[1])),
        warmup_ms=warmup_ms, step_ms=ms, median_step_ms=steady,
        min_step_ms=min(ms), max_step_ms=max(ms), rays_per_step=R,
        rays_per_s=R / (steady / 1e3), max_memory_allocated=peak,
        launches=launches, host_return_ms=host_ms,
        loss_items_last=items[-1], dedup_gather=dedup)
    o = cfg.optim
    share = o.pyramid_burst_steps / o.pyramid_cycle_steps
    t_unc, t_c = uncached_ms / 1e3, steady / 1e3
    log("blend", train_rays_per_s=R / (share * t_unc + (1 - share) * t_c),
        uncached_rays_per_s=R / t_unc, cached_rays_per_s=R / t_c,
        uncached_share=share, uncached_step_ms=uncached_ms,
        cached_step_ms=steady)
    if t_c > t_unc:
        log("note", text=f"the cached step ({steady:.3f} ms) is slower than "
            f"the uncached step ({uncached_ms:.3f} ms)")
    return st, staged, launches


def learnable_config(cfg):
    """cfg with the learnable blur kernel (config.apply_blur_overrides'
    'learnable'): its MLP reads patches of dilation_patch_size."""
    import dataclasses
    from hybridneuralrendering_tpu_torch import config
    cfg = config.apply_blur_overrides(cfg, "learnable")
    return cfg.replace(agg=dataclasses.replace(
        cfg.agg, learnable_blur_patch_size=cfg.sampling.dilation_patch_size))


def _timed_steps(st, grid, batches, cfg, gen, staged=None):
    """One warm-up step on batches[0], then one timed step on each of the
    rest; launches over exactly the timed steps."""
    import torch
    from hybridneuralrendering_tpu_torch.train import step as TT
    t0 = time.perf_counter()
    st, _ = TT.train_step(st, grid, batches[0], None, cfg, generator=gen,
                          img_feat_staged=staged)
    torch.cuda.synchronize()
    warmup_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    ms, host_ms, items = [], [], []
    reset_launches()
    for b in batches[1:]:
        t0 = time.perf_counter()
        st, it = TT.train_step(st, grid, b, None, cfg, generator=gen,
                               img_feat_staged=staged)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        items.append({k: float(v) for k, v in it.items()})
    bad = [(i, k) for i, it in enumerate(items) for k, v in it.items()
           if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"loss items not finite: {bad}")
    return st, dict(warmup_ms=warmup_ms, step_ms=_stats(ms),
                    host_return_ms=_stats(host_ms),
                    max_memory_allocated=torch.cuda.max_memory_allocated(),
                    launches=read_launches(), loss_items_last=items[-1])


def phase_train_learnable(cfg, points, grid):
    """The training steps with the learnable blur kernel at full width
    (cfg = learnable_config(train_config()): 49 patches of 8x8 rays, a 9x9
    kernel, mode 4, boundary 0): 1 warm-up and TRAIN_STEPS uncached steps,
    then the views' stage maps and 1 + TRAIN_STEPS cached steps; each
    set's launches as the bank's steps (phases train, train_cached), and
    the blur MLP must move."""
    import dataclasses
    import torch
    from hybridneuralrendering_tpu_torch.data import synthetic
    from hybridneuralrendering_tpu_torch.models import renderer
    from hybridneuralrendering_tpu_torch.train import pyramid_cache as PC
    from hybridneuralrendering_tpu_torch.train import state as TS
    params = renderer.init_params(cfg, seed=1, device=DEVICE)
    blur0 = [x.clone() for x in TS.tree_leaves(
        params["aggregator"]["blur_kernel"])]
    pts = dataclasses.replace(points, table=points.table.clone())
    st = TS.create_train_state(params, pts, cfg, device=DEVICE)
    batches = [synthetic.make_synthetic_batch(cfg, seed=50 + i,
                                              device=DEVICE)
               for i in range(TRAIN_STEPS + 1)]
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    st, unc = _timed_steps(st, grid, batches, cfg, gen)
    views = batches[0]["images_nearest"]
    staged = (views, PC.PyramidCache(cfg).get_stack(st.params, views,
                                                    range(len(views))))
    st, cac = _timed_steps(st, grid, batches, cfg, gen, staged)
    want_unc = dict.fromkeys(unc["launches"], TRAIN_STEPS)
    want_unc.update(segment_sum=2 * TRAIN_STEPS, cumsum_rows=0)
    want_cac = dict.fromkeys(cac["launches"], TRAIN_STEPS)
    moved = [bool((a != b).any()) for a, b in zip(TS.tree_leaves(
        st.params["aggregator"]["blur_kernel"]), blur0)]
    K = cfg.agg.learnable_blur_kernel_size
    log("train_learnable", rays_per_step=cfg.sampling.rays_per_batch,
        patches=cfg.sampling.dilation_patch_num ** 2,
        patch_size=cfg.sampling.dilation_patch_size, kernel=[K, K],
        mode=cfg.agg.learnable_blur_kernel_mode,
        boundary=cfg.agg.boundary_mode, uncached=unc, cached=cac,
        blur_leaves_moved=moved)
    if unc["launches"] != want_unc or cac["launches"] != want_cac \
            or not all(moved):
        raise AssertionError(f"learnable steps launched {unc['launches']} "
                             f"and {cac['launches']}, want {want_unc} and "
                             f"{want_cac}; blur leaves moved: {moved}")
    return {k: unc["launches"][k] + cac["launches"][k]
            for k in unc["launches"]}, (cfg, st, batches[-1], staged)


def _learnable_faults():
    """The learnable blur kernel's planted faults: (a) the kernel flipped,
    a true convolution; (b) the grouped kernels laid out by .repeat, so
    channel c of patch i takes the kernel of patch (3i + c) mod P; (c) the
    identity mix dropped, mode 4 run as mode 0."""
    import dataclasses
    from hybridneuralrendering_tpu_torch.models import blur

    def flipped(real):
        return lambda x, k: real(x, k.flip(-1, -2))

    def tiled(real):
        return lambda x, k: real(x, k[::3].repeat(3, 1, 1))

    def no_identity(real):
        def learnable_blur_update(params, cfg, *a):
            return real(params, dataclasses.replace(
                cfg, learnable_blur_kernel_mode=0), *a)
        return learnable_blur_update

    return {"blur kernel flipped (a convolution)": (
                _Planted(blur, "_conv_grouped", flipped), "net_grad_rel_l2"),
            "blur kernels by .repeat": (
                _Planted(blur, "_conv_grouped", tiled), "net_grad_rel_l2"),
            "blur identity mix dropped": (
                _Planted(blur, "learnable_blur_update", no_identity),
                "item_rel_err")}


def _adam_agreement(g_card, g_cpu, d_card, d_cpu, lr):
    """Adam's first step moves an element by about -lr * sign(g), so the
    update follows the gradient's sign.  Counts: elements whose gradient
    reaches 1e-2 of the largest and changes sign between the devices
    (`large_flips`, must be 0); elements whose gradients agree in sign and
    both exceed 1e-5 (so that eps = 1e-8 shifts the step by under 1e-3 *
    lr) but whose updates differ by more than 1e-2 * lr (`disagree`, must
    be 0); and the sign flips below that size (reported: gradients within
    the rounding noise)."""
    import torch
    g_card, g_cpu = g_card.reshape(-1), g_cpu.reshape(-1)
    flip = torch.sign(g_card) != torch.sign(g_cpu)
    large = g_cpu.abs() >= 1e-2 * g_cpu.abs().max()
    agree = ~flip & (torch.minimum(g_card.abs(), g_cpu.abs()) > 1e-5)
    off = (d_card.reshape(-1) - d_cpu.reshape(-1)).abs() > 1e-2 * lr
    return dict(large=int(large.sum()), large_flips=int((large & flip).sum()),
                compared=int(agree.sum()), disagree=int((agree & off).sum()),
                small_flips=int((flip & ~large).sum()))


# train_check's limits, between the largest sound reading of the card
# against the CPU and the reading of the planted fault each must reject
# (PERF.md §6: sound 7.6e-7, 7.3e-3 and 3.5e-3; faults 4.8e-2, 0.50 and
# 2.0e-2 on an H100)
ITEM_REL_LIMIT = 1e-4
TABLE_GRAD_LIMIT = 5e-2
NET_GRAD_LIMIT = 8e-3


class _Planted:
    """Replaces module.name by make(real) inside a `with` block."""

    def __init__(self, module, name, make):
        self.module, self.name, self.make = module, name, make

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        fake = self.make(self.real)
        setattr(self.module, self.name, fake)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def _faults(table_rows):
    """name -> (the planted fault, the reading that must reject it).  Each
    breaks one kernel's result on the main path: the segment sum of the
    point table's (table_rows ids) or of the pyramid map's gather backward
    loses each id's last row (a boundary off by one), the K-min loses each
    sample's nearest neighbour, the table Adam runs with the next step's
    bias correction, the chain's forward reads block3's extra columns one
    column off, chain_dw drops the scratch's first DW_FAULT_ROWS rows."""
    import torch
    from hybridneuralrendering_tpu_torch.models import neural_points as npts
    from hybridneuralrendering_tpu_torch.ops import query
    from hybridneuralrendering_tpu_torch.ops import shading_chain as SC
    from hybridneuralrendering_tpu_torch.train import step as TT

    def drop_last(on_table):
        def make(real):
            def segment_sum(sg, end_pos, n):
                out = real(sg, end_pos, n)
                if (n == table_rows) != on_table:
                    return out
                lens = torch.diff(end_pos.long(),
                                  prepend=end_pos.new_full((1,), -1))
                p = torch.nonzero(lens > 0)[:, 0]
                out[p] -= sg[end_pos[p].long()]
                return out
            return segment_sum
        return make

    def drop_nearest(real):
        def k_smallest(d, ids, k):
            bd, bi = real(d, ids, k)
            bd = bd.clone()
            bd[:, 0] = query.BIG
            return bd, bi
        return k_smallest

    def extra_off_by_one(real):
        def chain_forward(layout, w, b, emb, dists, extra):
            return real(layout, w, b, emb, dists,
                        extra.roll(1, dims=1).contiguous())
        return chain_forward

    def drop_first_rows(real):
        def chain_dw(layout, ascr, gscr, dbpart):
            rows = DW_FAULT_ROWS
            return real(layout, ascr[rows:], gscr[rows:],
                        dbpart[rows // SC.TILE:])
        return chain_dw

    def late_adam(real):
        def adam_table(p, g, mu, nu, s):
            real(p, g, mu, nu, s._replace(bc1=1 - s.b1 * (1 - s.bc1),
                                          bc2=1 - s.b2 * (1 - s.bc2)))
        return adam_table

    return {"segment_sum (point table)": (
                _Planted(npts, "segment_sum", drop_last(True)),
                "table_grad_rel_l2"),
            "segment_sum (pyramid map)": (
                _Planted(npts, "segment_sum", drop_last(False)),
                "net_grad_rel_l2"),
            "k_smallest": (_Planted(query, "k_smallest", drop_nearest),
                           "item_rel_err"),
            "adam_table": (_Planted(TT, "adam_table", late_adam),
                           "table_adam_equal"),
            "shading_chain_fwd": (_Planted(SC, "chain_forward",
                                           extra_off_by_one),
                                  "net_grad_rel_l2"),
            "shading_chain_dw": (_Planted(SC, "chain_dw",
                                          drop_first_rows),
                                     "net_grad_rel_l2")}


def _cached_faults():
    """The cached step's planted fault: the dedup gather's rank scan made
    exclusive, so each unique row's first slot takes the previous row's
    rank (its ranks off by one)."""
    from hybridneuralrendering_tpu_torch.models import neural_points as npts

    def exclusive(real):
        return lambda x: real(x) - x
    return {"cumsum_rows (dedup rank)": (
        _Planted(npts, "cumsum_rows", exclusive), "item_rel_err")}


def phase_train_check(cfg, points, grid, grid_c, params, learnable=False,
                      nerf_ds=None, knob=None):
    """One step of CHECK_PATCHES^2 patches of CHECK_PATCH_SIZE^2 rays from
    one state on the card and on the CPU (plain versions).  The bf16
    chains round at other points on the two devices.  The card's step must
    agree with the CPU's:
      - loss items to ITEM_REL_LIMIT relative (of max(|item|, 1e-3));
      - the table gradient (row 0, which collects every empty neighbour
        slot's conf term, apart from the other rows) to TABLE_GRAD_LIMIT
        and the network gradient (all of it, and each part of the
        aggregator apart: the small pyramid CNN would drown in the whole)
        to NET_GRAD_LIMIT relative L2 error;
      - after the step, the table must be exactly Adam of the card's own
        gradient, from scalars computed here, and the network parameters
        within one float32 rounding of theirs (2**-23 * |p|) plus
        1e-5 * lr: torch._foreach_ divides by a Python number, which may
        round otherwise;
      - Adam's first step moves each element by about +-lr whatever the
        gradient's size, so no gradient that reaches 1e-2 of the largest
        may change sign, and where both gradients agree in sign and exceed
        1e-5 the updates agree to 1e-2 * lr (_adam_agreement).
    Then the card's step is run again with each of _faults() planted, and
    the check must reject each of them.  Then the same for a cached step
    (stage maps through PyramidCache on each device, the dedup gather) with
    _cached_faults() planted.  Each control reports its margin, the reading
    that rejects it over that reading's limit.  With `learnable` (cfg and
    params with the learnable blur kernel) it is one uncached step,
    `train_check_learnable`, with _learnable_faults(): the blur MLP's
    gradient is one of the network's checked parts.  With `nerf_ds` (a
    NerfSynthScene of cfg = nerf_train_config()) it is one uncached step
    of CHECK_PATCHES^2 * CHECK_PATCH_SIZE^2 random rays of train frame 0,
    SR = 80 and K = 8, the chain in its 16 rematerialised chunks,
    `train_check_nerf`, with _nerf_faults().  With `knob` (a name of
    KNOB_VARIANTS; cfg, points and params of knob_config / knob_state) it
    is one uncached step, `train_check_<knob>`, without faults (serve_knobs
    plants them); for the plane the batch carries the plane keys and its
    bg_ray is computed once, on the CPU, for both steps (the foreground
    splat's ceil may round otherwise on the card: serve_knobs)."""
    import dataclasses
    import numpy as np
    import torch
    from hybridneuralrendering_tpu_torch.data import synthetic
    from hybridneuralrendering_tpu_torch.models import blur
    from hybridneuralrendering_tpu_torch.ops import adam as A
    from hybridneuralrendering_tpu_torch.train import pyramid_cache as PC
    from hybridneuralrendering_tpu_torch.train import state as TS
    from hybridneuralrendering_tpu_torch.train import step as TT
    small = cfg.replace(sampling=dataclasses.replace(
        cfg.sampling, random_sample_size=CHECK_PATCHES * CHECK_PATCH_SIZE,
        dilation_patch_num=CHECK_PATCHES,
        dilation_patch_size=CHECK_PATCH_SIZE))
    if learnable:
        small = small.replace(agg=dataclasses.replace(
            small.agg, learnable_blur_patch_size=CHECK_PATCH_SIZE))
    R = small.sampling.rays_per_batch
    o = small.optim
    arrays = synthetic.batch_arrays(small, seed=99)
    if nerf_ds is not None:
        from hybridneuralrendering_tpu_torch.data import sampling
        from hybridneuralrendering_tpu_torch.device import HOST_KEYS
        pix = sampling.sample_pixels(small.sampling, *small.image_hw,
                                     np.random.default_rng(99))
        arrays = {k: v for k, v in nerf_ds.get_batch(
            0, pixelcoords=pix).items() if k not in HOST_KEYS}
    if knob == "plane":
        arrays = TT.maybe_add_bg_ray(_plane_arrays(arrays), cpu(points),
                                     small)
    noise = torch.rand((R, small.querier.z_depth_dim),
                       generator=torch.Generator().manual_seed(5))
    bank = torch.as_tensor(blur.generate_kernel_bank(small.blur))
    t0 = time.perf_counter()

    def run(dev, g, cached=False):
        pts = dataclasses.replace(points, table=points.table.to(dev).clone(),
                                  mask=points.mask.to(dev))
        st = TS.create_train_state(TS.tree_map(torch.clone, params), pts,
                                   small, device=dev)
        b = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
        staged = None
        if cached:
            views = b["images_nearest"]
            staged = (views, PC.PyramidCache(small).get_stack(
                st.params, views, range(len(views))))
        items, g_net, g_table = TT.loss_and_grads(
            st, g, b, bank.to(dev), small, noise=noise.to(dev),
            img_feat_staged=staged)
        p_before = [t.clone() for t in TS.tree_leaves(st.params)]
        t_before = st.points.table.clone()
        TT.apply_updates(st, g_net, g_table, small)
        # Adam of this step's own gradient, from scalars computed here
        s_t = A.adam_scalars(0, 0, TS.lr_schedule(o.plr, o), o.beta1,
                             o.beta2)
        s_n = A.adam_scalars(0, 0, TS.lr_schedule(o.lr, o), o.beta1,
                             o.beta2)
        want_t = t_before.clone()
        A.adam_table_plain(want_t, g_table, torch.zeros_like(want_t),
                           torch.zeros_like(want_t), s_t)
        net_err = 0.0
        for p, p0, gl in zip(TS.tree_leaves(st.params), p_before,
                             TS.tree_leaves(g_net)):
            w = p0.clone()
            A.adam_table_plain(w, gl, torch.zeros_like(w),
                               torch.zeros_like(w), s_n)
            over = (p - w).abs() - 2.0 ** -23 * w.abs()
            net_err = max(net_err, float(over.max()))
        return dict(
            items={k: float(v) for k, v in items.items()},
            g_table=g_table.cpu(), d_table=(st.points.table - t_before).cpu(),
            table_adam_equal=bool(torch.equal(st.points.table, want_t)),
            net_adam_err=net_err,
            g_net=torch.cat([x.reshape(-1).cpu()
                             for x in TS.tree_leaves(g_net)]),
            g_parts={f"{k}/{k2}": torch.cat([
                x.reshape(-1).cpu() for x in TS.tree_leaves(v)])
                for k, sub in g_net.items() for k2, v in sub.items()},
            d_net=torch.cat([(a - b0).reshape(-1).cpu() for a, b0 in zip(
                TS.tree_leaves(st.params), p_before)]))

    def rel_l2(a, b):
        d, r = float(torch.linalg.norm(a - b)), float(torch.linalg.norm(b))
        return d / r if r > 0 else (0.0 if d == 0 else math.inf)

    def readings(k, c):
        return dict(
            item_rel_err=max(abs(k["items"][n] - v) / max(abs(v), 1e-3)
                             for n, v in c["items"].items()),
            table_grad_rel_l2=rel_l2(k["g_table"][1:], c["g_table"][1:]),
            table_row0_rel_l2=rel_l2(k["g_table"][0], c["g_table"][0]),
            net_grad_rel_l2=rel_l2(k["g_net"], c["g_net"]),
            net_part_rel_l2={n: rel_l2(v, c["g_parts"][n])
                             for n, v in k["g_parts"].items()},
            table_adam_equal=k["table_adam_equal"],
            net_adam_err_over_lr=k["net_adam_err"] / o.lr)

    def rejected(r):
        return dict(
            item_rel_err=r["item_rel_err"] > ITEM_REL_LIMIT,
            table_grad_rel_l2=max(r["table_grad_rel_l2"],
                                  r["table_row0_rel_l2"])
            > TABLE_GRAD_LIMIT,
            net_grad_rel_l2=max(r["net_grad_rel_l2"],
                                *r["net_part_rel_l2"].values())
            > NET_GRAD_LIMIT,
            table_adam_equal=not r["table_adam_equal"],
            net_adam_err=r["net_adam_err_over_lr"] > 1e-5)

    def margin(r, reading):
        """The rejecting reading over its limit (None for the bitwise
        Adam comparison)."""
        return dict(
            item_rel_err=r["item_rel_err"] / ITEM_REL_LIMIT,
            table_grad_rel_l2=max(r["table_grad_rel_l2"],
                                  r["table_row0_rel_l2"]) / TABLE_GRAD_LIMIT,
            net_grad_rel_l2=max(r["net_grad_rel_l2"],
                                *r["net_part_rel_l2"].values())
            / NET_GRAD_LIMIT).get(reading)

    def check(label, cached, faults):
        card = run(DEVICE, grid, cached)
        ref = run("cpu", grid_c, cached)
        sound = readings(card, ref)
        upd_table = _adam_agreement(card["g_table"], ref["g_table"],
                                    card["d_table"], ref["d_table"], o.plr)
        upd_net = _adam_agreement(card["g_net"], ref["g_net"],
                                  card["d_net"], ref["d_net"], o.lr)
        controls = {}
        for name, (fault, reading) in faults.items():
            with fault:
                r = readings(run(DEVICE, grid, cached), ref)
            controls[name] = dict(r, rejected_by=reading,
                                  rejected=rejected(r)[reading],
                                  margin=margin(r, reading))
        log(label, rays=R, items_card=card["items"], sound=sound,
            controls=controls, table_update=upd_table, net_update=upd_net,
            limits=dict(items=f"rel {ITEM_REL_LIMIT} of max(|item|, 1e-3)",
                        grads=f"rel L2: table {TABLE_GRAD_LIMIT}, network "
                        f"and each part {NET_GRAD_LIMIT}",
                        adam="of the card's own gradient: table bitwise, "
                        "network 2^-23*|p| + 1e-5*lr",
                        update="no sign flip where |g| >= 1e-2 max|g|; "
                        "1e-2*lr where signs agree and both |g| > 1e-5"),
            seconds=time.perf_counter() - t0)
        failed = [k for k, v in rejected(sound).items() if v]
        if (failed or upd_table["disagree"] or upd_net["disagree"]
                or upd_table["large_flips"] or upd_net["large_flips"]
                or upd_table["compared"] == 0):
            raise AssertionError(f"card and CPU training steps differ "
                                 f"({label}): {failed}")
        missed = [k for k, v in controls.items() if not v["rejected"]]
        if missed:
            raise AssertionError(f"{label} passed planted faults: {missed}")

    if learnable:
        check("train_check_learnable", False, _learnable_faults())
        return
    if knob is not None:
        check(f"train_check_{knob}", False, {})
        return
    if nerf_ds is not None:
        check("train_check_nerf", False, _nerf_faults())
        return
    check("train_check", False, _faults(points.capacity))
    check("train_check_cached", True, _cached_faults())


def _cpu_grid(points, cfg):
    from hybridneuralrendering_tpu_torch.ops import voxel_grid as VG
    geom = VG.compute_grid_geometry(points.xyz.numpy(), points.mask.numpy(),
                                    cfg.querier, device="cpu")
    return VG.build_grid(points.xyz, points.mask, geom, cfg.querier)


def phase_eval_cli(cfg, st, grid):
    """The evaluation CLI on the card: a ScanNet-layout scene of
    EVAL_FRAMES frames of the requests' camera (EVAL_FRAMES // 5 train
    frames, the rest test) in a temporary directory; the trained state
    `st` saved with save_checkpoint, loaded back on the card and held leaf
    for leaf bit-equal; then cli.test.main scores EVAL_SCORED test frames
    (whole 480x640 frames: 19 chunks of 16,384 rays, the last 12,288) from
    that file, every kernel's launch count read over exactly that call.
    Then CHECK_RAYS pixels of test frame 0 again on the CPU, from the same
    checkpoint and dataset, against the card's pixels; the card's render
    of frame 0 with frame 1's pose (through `grid`, the scene's grid: the
    state's xyz lanes are the scene's) must be rejected by the same
    check."""
    import tempfile
    import numpy as np
    import torch
    from hybridneuralrendering_tpu_torch import serve
    from hybridneuralrendering_tpu_torch.cli import test as cli_test
    from hybridneuralrendering_tpu_torch.data import scannet, synthetic
    from hybridneuralrendering_tpu_torch.train import checkpoint as ckpt
    H, W = cfg.image_hw
    chunks = -(-H * W // cfg.sampling.eval_rays)
    with tempfile.TemporaryDirectory(prefix="eval_cli_") as root:
        t0 = time.perf_counter()
        synthetic.write_scannet_scene(root, cfg, "synth", EVAL_FRAMES)
        write_s = time.perf_counter() - t0
        ck_root = os.path.join(root, "ckpts")
        t0 = time.perf_counter()
        path = ckpt.save_checkpoint(
            os.path.join(ck_root, "synth_full", "ckpt"), st, best_psnr=0.0)
        save_s = time.perf_counter() - t0
        ckpt_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        back, _ = ckpt.load_checkpoint(path, cfg, device=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if back.points.table.device.type != torch.device(DEVICE).type:
            raise AssertionError(f"load_checkpoint did not load onto "
                                 f"{DEVICE}")
        saved, loaded = ckpt.flatten_state(st), ckpt.flatten_state(back)
        differ = [k for k in saved if k not in loaded
                  or saved[k].dtype != loaded[k].dtype
                  or not np.array_equal(saved[k], loaded[k])]
        if differ or len(loaded) != len(saved):
            raise AssertionError(f"checkpoint round trip changed {differ}")
        del back, saved, loaded

        frames, frames_hit, first = [], [], {}

        def timed_frame(real):
            def render_full_frame(*a, **kw):
                t = time.perf_counter()
                img = real(*a, **kw)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
                if img.shape != (H, W, 3) or not torch.isfinite(img).all():
                    raise AssertionError(f"frame {len(frames)}: image "
                                         f"{tuple(img.shape)} not finite")
                frames.append(dict(ms=ms, rays_per_s=H * W / (ms / 1e3)))
                return img
            return render_full_frame

        def hit_share(real):
            def render_rays(*a, **kw):
                out = real(*a, **kw)
                frames_hit.append(float(out["ray_mask"].float().mean()))
                if not first:
                    first.update(out)
                return out
            return render_rays

        argv = ["--preset", "serve", "--data-root", root, "--scan", "synth",
                "--checkpoints-dir", ck_root, "--name", "synth_full",
                "--num-frames", str(EVAL_SCORED)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()    # the smoke's own tensors
        reset_launches()
        t0 = time.perf_counter()
        with _Planted(serve, "render_full_frame", timed_frame), \
                _Planted(serve, "render_rays", hit_share):
            scores = cli_test.main(argv)
        main_s = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        # per frame one K-min and one chain forward a chunk; the grid build
        # from the loaded points two row scans; nothing of training
        want = dict.fromkeys(launches, 0)
        want.update(k_smallest=EVAL_SCORED * chunks,
                    shading_chain_fwd=EVAL_SCORED * chunks, cumsum_rows=2)
        if launches != want:
            raise AssertionError(f"cli.test launched {launches}, want {want}")
        out_dir = os.path.join(ck_root, "synth_full_test")
        with open(os.path.join(out_dir, "scores.txt")) as f:
            written = {k: float(v) for k, v in
                       (line.rstrip("\n").split(": ") for line in f)}
        pngs = sorted(os.listdir(os.path.join(out_dir, "images")))
        if (written != scores or len(frames) != EVAL_SCORED
                or len(pngs) != 2 * EVAL_SCORED
                or not all(math.isfinite(v) for v in scores.values())):
            raise AssertionError(f"scores.txt {written}, returned {scores}, "
                                 f"{len(frames)} frames, PNGs {pngs}")

        # CHECK_RAYS pixels of test frame 0, spread over the frame, on the
        # CPU from the same file and dataset
        t0 = time.perf_counter()
        pick = np.linspace(0, H * W - 1, CHECK_RAYS).astype(np.int64)
        st_c, _ = ckpt.load_checkpoint(path, cfg, device="cpu")
        grid_c = _cpu_grid(st_c.points, cfg)
        ds = scannet.ScannetScene(root, "synth", cfg, "test")
        pix = np.stack([pick % W, pick // W], -1).astype(np.float32)[:, None]
        ref = serve.render_rays(
            st_c.params, st_c.points, grid_c,
            scannet.device_batch(ds.get_batch(0, pixelcoords=pix), "cpu"),
            cfg)
        card = {k: v[torch.as_tensor(pick, device=v.device)]
                for k, v in first.items()}
        errs = _ray_errors(card, ref)
        # the planted fault: frame 0 rendered on the card with frame 1's pose
        b0 = ds.get_batch(0, pixelcoords=pix)
        b1 = ds.get_batch(1, pixelcoords=pix)
        fault = dict(b0, campos=b1["campos"], camrotc2w=b1["camrotc2w"],
                     raydir=b1["raydir"])
        wrong = serve.render_rays(st.params, st.points, grid,
                                  scannet.device_batch(fault, DEVICE), cfg)
        fault_errs = _ray_errors(wrong, ref)
        check_s = time.perf_counter() - t0
        # the path and preview drivers on the same scene and checkpoint
        more = [phase_render_vid(cfg, root, ck_root, st_c, grid_c),
                phase_visualize(cfg, root, ck_root)]
        del st_c, grid_c
        more += [phase_edit(root, ck_root), phase_frame_weights(root)]
    log("eval_cli", frames=frames, scores=scores, launches=launches,
        ray_hit_share=sum(frames_hit) / len(frames_hit),
        mean_frame_ms=sum(f["ms"] for f in frames) / len(frames),
        main_seconds=main_s, max_memory_allocated=peak,
        memory_allocated_before=held,
        scene_write_seconds=write_s, save_seconds=save_s,
        load_seconds=load_s, checkpoint_bytes=ckpt_bytes,
        check_rays=CHECK_RAYS,
        check_max_abs_err=errs, check_tolerance=CHECK_TOL,
        fault_max_abs_err=fault_errs, check_seconds=check_s)
    bad = _rejected(errs, CHECK_TOL)
    if bad:
        raise AssertionError(f"card and CPU frames differ: {bad}")
    if not _rejected(fault_errs, CHECK_TOL):
        raise AssertionError(f"frame 0 with frame 1's pose passed the "
                             f"check: {fault_errs}")
    return launches, more


# the train_cli phase: cli.train.main on a ScanNet-layout scene of
# EVAL_FRAMES frames (constant 2.5 m depth: one wall at z = 0) at
# train_config(); a hole carved in the wall for the probe to find, a cap
# below the 600,000 capacity for growth to fill; grow at 250, prune at 300,
# eval (and save) at 410, the final save at 420; the burst of steps 400-419
# follows the cached steps 40-399, so the cache is emptied at 400
TRAIN_CLI_STEPS, TRAIN_CLI_RESUME_STEPS, TRAIN_CLI_FRAMES = 420, 3, 2
TRAIN_CLI_PROBE, TRAIN_CLI_PRUNE, TRAIN_CLI_TEST = 250, 300, 410
TRAIN_CLI_CAP = 300_000
# call 3, learnable blur and the native sampler: 40 uncached steps of the
# burst, then 20 cached
TRAIN_CLI_LEARNABLE_STEPS = 60
# the native_sampler phase: batches timed each way
NATIVE_BATCHES = 50
TRAIN_CLI_DROP_BOX = (-0.4, -0.3, -0.05, 0.4, 0.3, 0.05)
TRAIN_CLI_FLAGS = ["--prob-freq", str(TRAIN_CLI_PROBE), "--prob-frames",
                   "2", "--prune-iter", str(TRAIN_CLI_PRUNE),
                   "--prune-thresh", "0.5", "--test-freq",
                   str(TRAIN_CLI_TEST), "--test-num", "1", "--save-freq",
                   "0", "--bootstrap-cap", str(TRAIN_CLI_CAP), "--drop-box",
                   *map(str, TRAIN_CLI_DROP_BOX)]
# train_config() with prob_thresh lowered from 0.7 to 0 (registered by
# phase_train_cli): random weights' max opacities at the hole's border stay
# under 0.7 after 250 steps (the phase prints them), and the probe must grow
TRAIN_CLI_PRESET = "train_lifecycle"
TRAIN_CLI_PROB_THRESH = 0.0


def _stats(ms):
    ms = sorted(ms)
    return dict(n=len(ms), median=ms[len(ms) // 2] if ms else None,
                min=ms[0] if ms else None, max=ms[-1] if ms else None)


class _Recorder:
    """Wraps the trainer's entry points for one cli.train.main call: times
    each call (synchronizing after it) and counts what the launch
    prediction needs (steps by kind and frames, grid builds, grows with
    new points, probed frames, evaluated frames)."""

    def __init__(self):
        self.steps = []          # (cached, frames, t_enter, ms)
        self.events = []         # (name, seconds, detail)
        self.grids = self.grows = self.probe_frames = self.eval_frames = 0
        self.invalidations = 0

    def timed(self, name, detail=None):
        import torch

        def make(real):
            def fn(*a, **kw):
                t0 = time.perf_counter()
                out = real(*a, **kw)
                torch.cuda.synchronize()
                self.events.append((name, time.perf_counter() - t0,
                                    detail(a, kw, out) if detail else None))
                return out
            return fn
        return make

    def step(self, frames):
        import torch

        def make(real):
            def fn(*a, **kw):
                t0 = time.perf_counter()
                out = real(*a, **kw)
                torch.cuda.synchronize()
                self.steps.append((kw.get("img_feat_staged") is not None,
                                   frames, t0,
                                   (time.perf_counter() - t0) * 1e3))
                return out
            return fn
        return make

    def counting(self, attr, count=lambda a, kw: True):
        def make(real):
            def fn(*a, **kw):
                if count(a, kw):
                    setattr(self, attr, getattr(self, attr) + 1)
                return real(*a, **kw)
            return fn
        return make

    def planted(self):
        from hybridneuralrendering_tpu_torch import serve
        from hybridneuralrendering_tpu_torch.cli import train as cli_train
        from hybridneuralrendering_tpu_torch.data import native_sampler
        from hybridneuralrendering_tpu_torch.data.scannet import ScannetScene
        from hybridneuralrendering_tpu_torch.models import neural_points
        from hybridneuralrendering_tpu_torch.ops import voxel_grid
        from hybridneuralrendering_tpu_torch.train import checkpoint
        from hybridneuralrendering_tpu_torch.train import lifecycle
        from hybridneuralrendering_tpu_torch.train import step
        from hybridneuralrendering_tpu_torch.train.pyramid_cache import (
            PyramidCache)
        return [
            _Planted(PyramidCache, "invalidate", self.counting(
                "invalidations")),
            _Planted(step, "train_step", self.step(1)),
            _Planted(step, "train_step_multi", self.step(None)),
            _Planted(voxel_grid, "build_grid", self.counting("grids")),
            _Planted(neural_points, "grow", self.counting(
                "grows", lambda a, kw: a[-1].shape[0] > 0)),
            _Planted(lifecycle, "probe_frame", self.counting(
                "probe_frames")),
            _Planted(serve, "render_full_frame", self.timed(
                "eval_frame")),
            _Planted(lifecycle, "holes_from_maps", self.timed(
                "holes", lambda a, kw, out: _hole_stats(*a[:2], out))),
            _Planted(lifecycle, "probe_and_grow", self.timed(
                "probe_and_grow", lambda a, kw, out: dict(
                    added=out[2], live=out[0].num_live))),
            _Planted(lifecycle, "prune_and_rebuild", self.timed(
                "prune_and_rebuild", lambda a, kw, out: dict(
                    removed=a[0].num_live - out[0].num_live,
                    live=out[0].num_live))),
            _Planted(cli_train, "evaluate", self.timed(
                "evaluate", lambda a, kw, out: dict(psnr=out))),
            _Planted(cli_train, "bootstrap_points", self.timed(
                "bootstrap", lambda a, kw, out: dict(points=len(out)))),
            _Planted(checkpoint, "save_checkpoint", self.timed(
                "save", lambda a, kw, out: dict(file=os.path.basename(out),
                                                bytes=os.path.getsize(out)))),
            _Planted(checkpoint, "load_checkpoint", self.timed("load")),
            # the loop's host work: the training frames' batches, their
            # copies to the card, the native sampler's wait
            _Planted(ScannetScene, "get_batch", self.timed(
                "get_batch", lambda a, kw, out: a[0].split)),
            _Planted(cli_train, "device_batch", self.timed("device_batch")),
            _Planted(native_sampler.PrefetchPipeline, "pop", self.timed(
                "native_pop")),
        ]

    def of(self, name):
        return [e for e in self.events if e[0] == name]

    def host_split(self):
        """Median ms a step of the loop's host pieces: a training frame's
        get_batch, its device_batch and the native sampler's pop."""
        ms = {k: [e[1] * 1e3 for e in self.of(k)
                  if k != "get_batch" or e[2] == "train"]
              for k in ("get_batch", "device_batch", "native_pop")}
        return {k: _stats(v) for k, v in ms.items() if v}


def _hole_stats(maps, bg, out):
    """The max opacities of a probed frame's hit pixels next to a miss
    (the candidates before the prob_thresh test) and the points taken."""
    import numpy as np
    from hybridneuralrendering_tpu_torch.train import lifecycle
    hit = maps["ray_mask"][..., 0] > 0
    miss = ~hit & (np.linalg.norm(maps["gt_image"] - bg, axis=-1) > 0.002)
    op = maps["ray_max_shading_opacity"][..., 0][
        hit & lifecycle.bloat_mask(miss, 1)]
    q = np.quantile(op, [0.0, 0.5, 0.99, 1.0]).tolist() if op.size else []
    return dict(miss_pixels=int(miss.sum()), border_pixels=int(op.size),
                opacity_min_median_p99_max=q, taken=len(out[0]))


def _cli_call(cli_train, argv, frames):
    """One cli.train.main call under a _Recorder; every kernel's launches
    over exactly the call."""
    import contextlib
    import torch
    rec = _Recorder()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for p in rec.planted():
            stack.enter_context(p)
        st = cli_train.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rec.steps = [(c, f or frames, t, ms) for c, f, t, ms in rec.steps]
    return st, rec, read_launches(), seconds, \
        torch.cuda.max_memory_allocated()


def _predicted_launches(cfg, launches, steps=(), renders=0, grids=0,
                        grows=0):
    """Each kernel's launches (every key of `launches`) that a schedule
    gives: `steps` holds each step's (cached, frames), `renders` counts
    the eval chunks of the probed, evaluated and served frames.  Per frame
    of a step one K-min; the chain in chain_chunks pieces (when they
    divide its rays, as models/aggregator runs it) forward, again forward
    in remat's recompute, and backward (chain_bwd, chain_dw); one segment
    sum for the point table, and with image fusion (use_nearest > 0) one
    more for the pyramid map when the frame is uncached; one row scan
    cached (the dedup gather's ranks).  Per step one table Adam.  Per eval
    chunk one K-min and the chain's pieces forward.  Two row scans a grid
    build (voxels and supervoxels) and two a grow (the new points' and the
    free slots' ranks)."""
    nc = cfg.agg.chain_chunks

    def pieces(rays):
        return nc if nc > 1 and rays % nc == 0 else 1

    p, e = pieces(cfg.sampling.rays_per_batch), pieces(cfg.sampling.eval_rays)
    fwd = p * (2 if cfg.agg.remat_chain else 1)
    frames = sum(f for _, f in steps)
    cached = sum(f for c, f in steps if c)
    maps = frames - cached if cfg.agg.use_nearest > 0 else 0
    want = dict.fromkeys(launches, 0)
    want.update(
        k_smallest=frames + renders,
        shading_chain_fwd=frames * fwd + renders * e,
        shading_chain_bwd=frames * p, shading_chain_dw=frames * p,
        segment_sum=frames + maps, adam_table=len(steps),
        cumsum_rows=2 * grids + cached + 2 * grows)
    return want


def _log_events(path):
    """The event lines of a run's log.txt (all but the loss lines)."""
    with open(path) as f:
        lines = [line.split("] ", 1)[1].rstrip("\n") for line in f]
    return [x for x in lines if not x.startswith("step ")]


def phase_train_cli():
    """The training CLI on the card at train_config() with prob_thresh
    TRAIN_CLI_PROB_THRESH (module constants TRAIN_CLI_*): a ScanNet-layout
    scene of EVAL_FRAMES frames (4 train), bootstrapped from its sensor
    depth, then TRAIN_CLI_STEPS steps crossing burst -> cached -> burst,
    with a probe-and-grow, a prune, an eval, a save on the better PSNR and
    the final save; then a second call
    resumes from that checkpoint and takes TRAIN_CLI_RESUME_STEPS steps of
    TRAIN_CLI_FRAMES frames (train_step_multi).  Each call's launches must
    equal the schedule's (_predicted_launches); growth must add and the
    prune remove points; the final checkpoint loads at the last step."""
    import dataclasses
    import tempfile
    import torch
    from hybridneuralrendering_tpu_torch import config
    from hybridneuralrendering_tpu_torch.cli import train as cli_train
    from hybridneuralrendering_tpu_torch.data import sampling, synthetic
    from hybridneuralrendering_tpu_torch.train import checkpoint as ckpt
    from hybridneuralrendering_tpu_torch.train import pyramid_cache
    from hybridneuralrendering_tpu_torch.train import state as TS

    def lifecycle_config():
        cfg = config.train_config()
        return cfg.replace(probe=dataclasses.replace(
            cfg.probe, prob_thresh=TRAIN_CLI_PROB_THRESH))
    config.PRESETS[TRAIN_CLI_PRESET] = lifecycle_config
    cfg = config.PRESETS[TRAIN_CLI_PRESET]()
    H, W = cfg.image_hw
    ef = cfg.sampling.edge_filter
    probe_chunks = -(-sampling.full_image_grid(H, W, ef).reshape(-1, 2)
                     .shape[0] // cfg.sampling.eval_rays)
    eval_chunks = -(-H * W // cfg.sampling.eval_rays)
    with tempfile.TemporaryDirectory(prefix="train_cli_") as root:
        synthetic.write_scannet_scene(root, cfg, "synth", EVAL_FRAMES)
        ck_root = os.path.join(root, "ckpts")
        base = ["--preset", TRAIN_CLI_PRESET, "--data-root", root, "--scan",
                "synth", "--checkpoints-dir", ck_root, "--name",
                "synth_train", "--load-points", "2",
                "--device", DEVICE] + TRAIN_CLI_FLAGS
        held = torch.cuda.memory_allocated()

        def once(argv, frames):
            st, rec, launches, seconds, peak = _cli_call(cli_train, argv,
                                                         frames)
            rec.eval_frames = len(rec.of("eval_frame"))
            want = _predicted_launches(
                cfg, launches, [(c, f) for c, f, _, _ in rec.steps],
                rec.probe_frames * probe_chunks
                + rec.eval_frames * eval_chunks, rec.grids, rec.grows)
            if launches != want:
                raise AssertionError(f"cli.train launched {launches}, the "
                                     f"schedule gives {want}")
            return st, rec, launches, seconds, peak

        st1, rec1, l1, s1, peak1 = once(
            base + ["--max-steps", str(TRAIN_CLI_STEPS)], 1)
        run_dir = os.path.join(ck_root, "synth_train")
        events1 = _log_events(os.path.join(run_dir, "log.txt"))
        st2, rec2, l2, s2, peak2 = once(
            base + ["--max-steps", str(TRAIN_CLI_STEPS
                                       + TRAIN_CLI_RESUME_STEPS),
                    "--resume", "--frames-per-step", str(TRAIN_CLI_FRAMES)],
            TRAIN_CLI_FRAMES)
        events2 = _log_events(os.path.join(run_dir, "log.txt"))[
            len(events1):]
        final = ckpt.latest_checkpoint(os.path.join(run_dir, "ckpt"))
        back, best = ckpt.load_checkpoint(final, cfg, device=DEVICE)
        ckpts = sorted(os.listdir(os.path.join(run_dir, "ckpt")))
        # call 3: a fresh run with the learnable blur kernel and the
        # native batch sampler
        base3 = [x if x != "synth_train" else "synth_learnable"
                 for x in base]
        st3, rec3, l3, s3, peak3 = once(
            base3 + ["--max-steps", str(TRAIN_CLI_LEARNABLE_STEPS),
                     "--blur-mode", "learnable", "--native-prefetch", "2"],
            1)
        run3 = os.path.join(ck_root, "synth_learnable")
        events3 = _log_events(os.path.join(run3, "log.txt"))
        ckpts3 = sorted(os.listdir(os.path.join(run3, "ckpt")))
        back3, _ = ckpt.load_checkpoint(
            ckpt.latest_checkpoint(os.path.join(run3, "ckpt")),
            config.apply_blur_overrides(cfg, "learnable"), device=DEVICE)
        phase_native_sampler(root, cfg)

    def steps_of(rec, cached):
        """The steps' own times, and the loop's wall a step: from one
        step's start to the next's, where no probe, prune or eval ran
        between them (a print's loss read stays in)."""
        ms = [x[3] for x in rec.steps if x[0] == cached]
        loop = [(b[2] - a[2]) * 1e3 for i, (a, b) in enumerate(
            zip(rec.steps, rec.steps[1:])) if a[0] == cached and all(
            (i + 1) % k for k in (TRAIN_CLI_PROBE, TRAIN_CLI_PRUNE,
                                  TRAIN_CLI_TEST))]
        return dict(step_ms=_stats(ms), loop_ms=_stats(loop))

    grows = [e[2] for e in rec1.of("probe_and_grow")]
    prunes = [e[2] for e in rec1.of("prune_and_rebuild")]
    total = TRAIN_CLI_STEPS + TRAIN_CLI_RESUME_STEPS
    log("train_cli", preset=TRAIN_CLI_PRESET, steps=TRAIN_CLI_STEPS,
        bootstrap=[dict(seconds=e[1], **e[2]) for e in
                   rec1.of("bootstrap") + rec2.of("bootstrap")],
        uncached=steps_of(rec1, False), cached=steps_of(rec1, True),
        multi_frame_step_ms=_stats([x[3] for x in rec2.steps]),
        probe_and_grow=[dict(seconds=e[1], **e[2]) for e in
                        rec1.of("probe_and_grow")],
        probe_frames=rec1.probe_frames, probe_chunks=probe_chunks,
        probe_holes=[e[2] for e in rec1.of("holes")],
        prune_and_rebuild=[dict(seconds=e[1], **e[2]) for e in
                           rec1.of("prune_and_rebuild")],
        eval_frame_ms=[e[1] * 1e3 for e in rec1.of("eval_frame")],
        evaluate=[dict(seconds=e[1], **e[2]) for e in rec1.of("evaluate")],
        saves=[dict(seconds=e[1], **e[2]) for e in
               rec1.of("save") + rec2.of("save")],
        resume_load_seconds=[e[1] for e in rec2.of("load")],
        grid_builds=[rec1.grids, rec2.grids], grows=rec1.grows,
        cache_invalidations=[rec1.invalidations, rec2.invalidations],
        main_seconds=[s1, s2], max_memory_allocated=[peak1, peak2],
        memory_allocated_before=held, launches=[l1, l2],
        checkpoints=ckpts, final_step=back.step, final_live=
        back.points.num_live, best_psnr=best, log_events=events1 + events2,
        host_split=rec1.host_split())
    blur_leaves = TS.tree_leaves(back3.params["aggregator"].get(
        "blur_kernel", []))
    log("train_cli_learnable", steps=TRAIN_CLI_LEARNABLE_STEPS,
        flags=["--blur-mode", "learnable", "--native-prefetch", "2"],
        uncached=steps_of(rec3, False), cached=steps_of(rec3, True),
        call1_uncached=steps_of(rec1, False),
        call1_cached=steps_of(rec1, True), host_split=rec3.host_split(),
        call1_host_split=rec1.host_split(),
        saves=[dict(seconds=e[1], **e[2]) for e in rec3.of("save")],
        main_seconds=s3, max_memory_allocated=peak3, launches=l3,
        checkpoints=ckpts3, blur_leaves=[list(x.shape) for x in
                                         blur_leaves],
        log_events=events3)
    kinds3 = [x[0] for x in rec3.steps]
    if (kinds3 != [not pyramid_cache.in_burst(s, cfg.optim)
                   for s in range(TRAIN_CLI_LEARNABLE_STEPS)]
            or not any(kinds3) or rec3.invalidations != 0
            or ckpts3 != [f"{TRAIN_CLI_LEARNABLE_STEPS}_state.npz",
                          "run_config.json"]
            or "native prefetch on (2 workers)" not in events3
            or len(rec3.of("native_pop")) != TRAIN_CLI_LEARNABLE_STEPS):
        raise AssertionError(f"the learnable run took other steps than its "
                             f"schedule, saved {ckpts3} or did not sample "
                             f"natively")
    want_blur = TS.tree_leaves(st3.params["aggregator"]["blur_kernel"])
    if (len(blur_leaves) != 8 or any(
            x.device.type != torch.device(DEVICE).type
            or not torch.equal(x, w) for x, w in zip(blur_leaves,
                                                     want_blur))):
        raise AssertionError("the learnable run's checkpoint does not hold "
                             "its blur MLP's leaves")
    added = sum(g["added"] for g in grows)
    removed = sum(p["removed"] for p in prunes)
    if not grows or added <= 0 or not prunes or removed <= 0:
        raise AssertionError(f"the lifecycle grew {added} points in "
                             f"{len(grows)} probes and pruned {removed} in "
                             f"{len(prunes)}")
    # the burst schedule: uncached in each cycle's first steps, cached
    # after them, the cache emptied where a burst follows a cached step
    kinds = [[x[0] for x in rec.steps] for rec in (rec1, rec2)]
    want = [[not pyramid_cache.in_burst(s, cfg.optim) for s in steps]
            for steps in (range(TRAIN_CLI_STEPS), range(TRAIN_CLI_STEPS,
                                                        total))]
    flips = sum(pyramid_cache.burst_begins(s, cfg.optim)
                for s in range(TRAIN_CLI_STEPS))
    if (kinds != want or rec1.invalidations != flips
            or rec2.invalidations != 0 or not any(kinds[0])
            or not rec1.of("evaluate")
            or not all(math.isfinite(e[2]["psnr"])
                       for e in rec1.of("evaluate"))):
        raise AssertionError(f"the run took other steps than its schedule "
                             f"(cache emptied {rec1.invalidations} times, "
                             f"the schedule {flips}), or its eval is "
                             f"missing or not finite")
    if (back.step != total or st2.step != total
            or back.points.num_live != st2.points.num_live
            or f"{total}_state.npz" not in ckpts
            or {back.points.table.device.type, st2.points.table.device.type}
            != {torch.device(DEVICE).type}
            or not any(x.startswith("resumed from ") for x in events2)):
        raise AssertionError(f"the final checkpoint {ckpts} (step "
                             f"{back.step}) is not the resumed run's")
    if not torch.equal(back.points.table, st2.points.table):
        raise AssertionError("the final checkpoint's table differs from "
                             "the trainer's")
    return {k: l1[k] + l2[k] + l3[k] for k in l1}


def phase_native_sampler(root, cfg):
    """Host batch assembly at cfg's image size and sampling, NATIVE_BATCHES
    batches over the scene's training frames (decoded once before): numpy
    get_batch against the native sampler's assemble_batch plus
    get_batch(pixelcoords=...), and assemble_batch alone; the native batch
    checked as JAX tests/test_data.py checks it; and the loop's other host
    pieces: device_batch of one batch and the tracker's float() of a card
    scalar on an idle queue."""
    import numpy as np
    import torch
    from hybridneuralrendering_tpu_torch.data import native_sampler as NS
    from hybridneuralrendering_tpu_torch.data.scannet import (ScannetScene,
                                                              _np_raydir)
    from hybridneuralrendering_tpu_torch.device import device_batch
    from hybridneuralrendering_tpu_torch.ops import build
    t0 = time.perf_counter()
    NS.load()
    load_s = time.perf_counter() - t0
    ds = ScannetScene(root, "synth", cfg, "train")
    s = cfg.sampling
    n = len(ds)
    for i in range(n):
        ds.image(ds.id_list[i])
    rng = np.random.default_rng(0)

    def native(i, with_batch=True):
        vid = ds.id_list[i % n]
        xy, rgb, dirs = NS.assemble_batch(
            ds.image(vid), s.edge_filter, s.dilation_patch_num,
            s.dilation_patch_size, s.dilation_min, s.dilation_max,
            ds.intrinsic, ds._pose(vid)[:3, :3], i)
        if not with_batch:
            return xy, rgb, dirs
        b = ds.get_batch(i % n, rng, pixelcoords=xy)
        b["raydir"], b["gt_image"] = dirs, rgb
        return b

    def per_batch_ms(fn):
        t0 = time.perf_counter()
        for i in range(NATIVE_BATCHES):
            fn(i)
        return (time.perf_counter() - t0) / NATIVE_BATCHES * 1e3

    numpy_ms = per_batch_ms(lambda i: ds.get_batch(i % n, rng))
    native_ms = per_batch_ms(native)
    assemble_ms = per_batch_ms(lambda i: native(i, False))
    b = native(0)
    # the trainer's view bank has put the nearest views on the card
    b["images_nearest"] = torch.as_tensor(b["images_nearest"], device=DEVICE)
    dev_ms = per_batch_ms(lambda i: device_batch(b, DEVICE))
    one = torch.zeros(1, device=DEVICE)
    torch.cuda.synchronize()
    float_us = per_batch_ms(lambda i: float(one[0])) * 1e3

    H, W, m = ds.height, ds.width, s.edge_filter
    xy, rgb, dirs = native(7, False)
    flat = xy.reshape(-1, 2).astype(int)
    img = ds.image(ds.id_list[7 % n])
    again = native(7, False)
    other = native(8, False)
    checks = dict(
        inside_margin=bool(xy[..., 0].min() >= m and xy[..., 0].max()
                           < W - m and xy[..., 1].min() >= m
                           and xy[..., 1].max() < H - m),
        gt_exact=bool(np.array_equal(rgb, img[flat[:, 1], flat[:, 0]])),
        raydir_close=bool(np.allclose(
            dirs, _np_raydir(xy.reshape(-1, 2), ds.intrinsic,
                             ds._pose(ds.id_list[7 % n])[:3, :3]),
            rtol=1e-4, atol=1e-5)),
        same_seed_equal=all(np.array_equal(a, c)
                            for a, c in zip(again, (xy, rgb, dirs))),
        other_seed_differs=not np.array_equal(other[0], xy))
    log("native_sampler", image_hw=[H, W], rays=int(xy.size // 2),
        batches=NATIVE_BATCHES, load_seconds=load_s,
        build_seconds=build.BUILD_SECONDS.get("sampler"),
        numpy_get_batch_ms=numpy_ms, native_get_batch_ms=native_ms,
        assemble_batch_ms=assemble_ms, device_batch_ms=dev_ms,
        tracker_float_us=float_us, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"the native batch fails its checks: {checks}")


# ------------------------------------------------------ the NeRF workload
# nerf_train_config() (fixture_nerf_points, the JAX bench's second field) on
# the smoke's object scene: write_blender_scene's sphere on a box,
# NERF_FRAMES train and test frames at 400x400 and a fused.ply of
# config.NERF_NUM_POINTS surface points; serving NERF_REQUESTS requests of
# NERF_RAYS_PER_REQUEST rays (one eval chunk each) from test frame 0's middle
# rows; the trainer CLI NERF_CLI_STEPS steps, then cli.test on
# NERF_CLI_SCORED whole test frames
NERF_SCAN = "objsim"
NERF_FRAMES = (20, 4)
NERF_REQUESTS, NERF_RAYS_PER_REQUEST = 4, 4_096
NERF_CLI_STEPS, NERF_CLI_SCORED = 60, 2


def phase_nerf_scene(root):
    """The smoke's object scene written in the Blender layout under root;
    its fused.ply cloud on the card with embeddings from a seed, the grid
    (two row scans) and random full-width parameters."""
    import numpy as np
    import torch
    from hybridneuralrendering_tpu_torch import config
    from hybridneuralrendering_tpu_torch.data import synthetic
    from hybridneuralrendering_tpu_torch.data.nerf_synth import NerfSynthScene
    from hybridneuralrendering_tpu_torch.models import neural_points as npts
    from hybridneuralrendering_tpu_torch.models import renderer
    from hybridneuralrendering_tpu_torch.ops import voxel_grid as VG
    cfg = config.nerf_train_config()
    t0 = time.perf_counter()
    synthetic.write_blender_scene(root, NERF_SCAN, *NERF_FRAMES,
                                  hw=cfg.image_hw,
                                  num_points=config.NERF_NUM_POINTS)
    write_s = time.perf_counter() - t0
    train_ds = NerfSynthScene(root, NERF_SCAN, cfg, "train")
    test_ds = NerfSynthScene(root, NERF_SCAN, cfg, "test")
    xyz = train_ds.load_init_points()
    emb = np.random.default_rng(0).standard_normal(
        (len(xyz), cfg.points.feature_dim)) * 0.1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_launches()
    scans = []
    real = VG.cumsum_rows
    VG.cumsum_rows = lambda x: scans.append(x.clone()) or real(x)
    try:
        points = npts.init_from_arrays(xyz, cfg.points, embedding=emb,
                                       device=DEVICE)
        grid = VG.grid_of(points.xyz, points.mask, cfg.querier)
        torch.cuda.synchronize()
    finally:
        VG.cumsum_rows = real
    build_s = time.perf_counter() - t0
    launches = read_launches()
    want = _predicted_launches(cfg, launches, grids=1)
    # the grid's two row scans held against the plain version at the
    # workload's shapes (int32 head flags)
    if len(scans) != want["cumsum_rows"]:
        raise AssertionError(f"the NeRF grid build passed {len(scans)} "
                             f"row scans through VG.cumsum_rows, want "
                             f"{want['cumsum_rows']}")
    for x in scans:
        scan_row(x, f"NeRF grid: {x.shape[0]:,} keys")
    q = cfg.querier
    if (launches != want or len(xyz) != config.NERF_NUM_POINTS
            or int(grid.num_occ) >= q.max_o
            or int(grid.num_nodes) >= q.max_nodes):
        raise AssertionError(f"the NeRF scene: {len(xyz)} points, "
                             f"{int(grid.num_occ)} voxels, "
                             f"{int(grid.num_nodes)} nodes, launches "
                             f"{launches}")
    params = renderer.init_params(cfg, seed=0, device=DEVICE)
    log("nerf_scene", points=int(points.num_live), capacity=points.capacity,
        occupied_voxels=int(grid.num_occ), max_o=q.max_o,
        supervoxel_nodes=int(grid.num_nodes), max_nodes=q.max_nodes,
        frames=list(NERF_FRAMES), image_hw=list(cfg.image_hw),
        write_seconds=write_s, build_seconds=build_s, launches=launches)
    return cfg, train_ds, test_ds, points, grid, params


def phase_serve_nerf(cfg, test_ds, points, grid, params, prof=False):
    """NERF_REQUESTS requests of NERF_RAYS_PER_REQUEST rays (test frame
    0's middle rows) through serve.render_rays: per request one eval
    chunk, one K-min at (4,096 * SR, Ps, K) and the chain forward in
    chain_chunks pieces; the white background in every miss."""
    import torch
    from hybridneuralrendering_tpu_torch import serve
    from hybridneuralrendering_tpu_torch.device import device_batch
    H, W = cfg.image_hw
    full = test_ds.get_batch(0)
    n = NERF_RAYS_PER_REQUEST
    first = (H * W - NERF_REQUESTS * n) // 2
    keys = ("campos", "camrotc2w", "bg_color")
    requests = [device_batch(dict(
        {k: full[k] for k in keys},
        raydir=full["raydir"][first + i * n:first + (i + 1) * n]), DEVICE)
        for i in range(NERF_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, ms = [], []
    reset_launches()
    for req in requests:
        t0 = time.perf_counter()
        outs.append(serve.render_rays(params, points, grid, req, cfg))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    chunks = NERF_REQUESTS * -(-n // cfg.sampling.eval_rays)
    want = _predicted_launches(cfg, launches, renders=chunks)
    if launches != want:
        raise AssertionError(f"NeRF serving launched {launches}, want "
                             f"{want}")
    for i, out in enumerate(outs):
        for k, v in out.items():
            if v.shape[0] != n or (v.is_floating_point()
                                   and not torch.isfinite(v).all()):
                raise AssertionError(f"NeRF request {i}: {k} "
                                     f"{tuple(v.shape)} or not finite")
    hit = torch.cat([o["ray_mask"] for o in outs])
    colour = torch.cat([o["coarse_raycolor"] for o in outs])
    miss_white = bool((colour[~hit] == 1.0).all())
    if not bool(hit.any()) or not bool((~hit).any()) or not miss_white:
        raise AssertionError(f"NeRF requests: hit share "
                             f"{float(hit.float().mean())}, misses white "
                             f"{miss_white}")
    if prof:
        profile("serve_nerf", lambda: serve.render_rays(
            params, points, grid, requests[1], cfg))
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    log("serve_nerf", request_ms=ms, rays=n, chunks=chunks,
        launches=launches, ray_hit_share=float(hit.float().mean()),
        misses_white=miss_white,
        rays_per_s=NERF_REQUESTS * n / (sum(ms) / 1e3),
        steady_rays_per_s=n / (steady / 1e3), max_memory_allocated=peak)
    return launches


def _nerf_steps(st, grid, batches, cfg, gen, warm=1):
    """`warm` steps, then the rest of `batches` timed one by one; returns
    (ms, launches and peak memory over the timed steps, last items)."""
    import torch
    from hybridneuralrendering_tpu_torch.train import step as TT
    for b in batches[:warm]:
        st, _ = TT.train_step(st, grid, b, None, cfg, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    reset_launches()
    for b in batches[warm:]:
        t0 = time.perf_counter()
        st, items = TT.train_step(st, grid, b, None, cfg, generator=gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, read_launches(), torch.cuda.max_memory_allocated(), \
        {k: float(v) for k, v in items.items()}


def phase_train_nerf(cfg, train_ds, points, grid, prof=False):
    """nerf_train_config() steps on the object scene (3,600 random rays of
    a train frame, SR = 80, the chain in 16 rematerialised chunks): 1
    warm-up and TRAIN_STEPS timed steps, launches over exactly the timed
    steps; then one timed step (after one warm-up) with remat off, with
    chain_chunks 1 and with both, their times and peaks beside the
    preset's; then one more step's segment sum and table Adam captured
    and held against their plain versions (fused torch.optim.Adam timed
    on the same table)."""
    import dataclasses
    import numpy as np
    import torch
    from hybridneuralrendering_tpu_torch.device import device_batch
    from hybridneuralrendering_tpu_torch.models import neural_points as npts
    from hybridneuralrendering_tpu_torch.models import renderer
    from hybridneuralrendering_tpu_torch.ops import adam as A
    from hybridneuralrendering_tpu_torch.train import state as TS
    from hybridneuralrendering_tpu_torch.train import step as TT
    params = renderer.init_params(cfg, seed=1, device=DEVICE)
    pts = dataclasses.replace(points, table=points.table.clone())
    st = TS.create_train_state(params, pts, cfg, device=DEVICE)
    rng = np.random.default_rng(0)
    batches = [device_batch(train_ds.get_batch(i % len(train_ds), rng),
                            DEVICE) for i in range(TRAIN_STEPS + 8)]
    R = cfg.sampling.rays_per_batch
    if batches[0]["raydir"].shape[0] != R or bool(
            (batches[0]["bg_color"] != 1.0).any()):
        raise AssertionError("a NeRF batch is not 3,600 rays on white")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    before = st.points.table.clone()
    ms, launches, peak, items = _nerf_steps(st, grid,
                                            batches[:TRAIN_STEPS + 1], cfg,
                                            gen)
    want = _predicted_launches(cfg, launches, [(False, 1)] * TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"NeRF training launched {launches}, want "
                             f"{want}")
    if not all(math.isfinite(v) for v in items.values()):
        raise AssertionError(f"NeRF loss items not finite: {items}")
    moved = (st.points.table != before).any(dim=1)
    if not bool(moved.any()) or not torch.equal(st.points.table[:, :3],
                                                before[:, :3]):
        raise AssertionError("the NeRF steps moved no point, or moved xyz")
    knobs = {}
    for label, kw in (("remat off", dict(remat_chain=False)),
                      ("chain_chunks 1", dict(chain_chunks=1)),
                      ("both off", dict(remat_chain=False, chain_chunks=1))):
        vcfg = cfg.replace(agg=dataclasses.replace(cfg.agg, **kw))
        v_ms, v_launches, v_peak, _ = _nerf_steps(
            st, grid, batches[TRAIN_STEPS + 1:TRAIN_STEPS + 3], vcfg, gen)
        want = _predicted_launches(vcfg, v_launches, [(False, 1)])
        if v_launches != want:
            raise AssertionError(f"NeRF step ({label}) launched "
                                 f"{v_launches}, want {want}")
        knobs[label] = dict(step_ms=v_ms[0], max_memory_allocated=v_peak,
                            launches=v_launches)
    # one more step: its segment sum and its table Adam captured and held
    # against their plain versions at the workload's shapes
    captured, adams = [], []
    real, real_adam = npts.segment_sum, TT.adam_table
    npts.segment_sum = lambda sg, e, n: (
        captured.append((sg.clone(), e.clone(), n)) or real(sg, e, n))
    TT.adam_table = lambda p, g, mu, nu, s: (adams.append(
        (p.clone(), g.clone(), mu.clone(), nu.clone(), s))
        or real_adam(p, g, mu, nu, s))
    try:
        TT.train_step(st, grid, batches[-1], None, cfg, generator=gen)
    finally:
        npts.segment_sum, TT.adam_table = real, real_adam
    if [c[2] for c in captured] != [st.points.capacity] or len(adams) != 1:
        raise AssertionError(f"a NeRF step's segment sums reduce onto "
                             f"{[c[2] for c in captured]} rows, "
                             f"{len(adams)} table Adams")
    seg = segment_sum_row(*captured[0], "NeRF step: point table")
    kern = [t.clone() for t in adams[0][:4]]
    plain = [t.clone() for t in adams[0][:4]]
    real_adam(kern[0], kern[1], kern[2], kern[3], adams[0][4])
    A.adam_table_plain(plain[0], plain[1], plain[2], plain[3], adams[0][4])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(kern, plain)):
        raise AssertionError("adam_table kernel != plain at the NeRF "
                             "table")
    N, C = kern[0].shape
    bound, by = _bound(7 * N * C * 4, 15 * N * C)
    o = cfg.optim
    lib_p = adams[0][0].clone().requires_grad_(True)
    lib_p.grad = adams[0][1].clone()
    lib = torch.optim.Adam([lib_p], lr=o.plr, betas=(o.beta1, o.beta2),
                           fused=True)
    log_kernel("adam_table", dict(
        shape=[N, C], table="NeRF step", tolerance="bitwise",
        max_abs_err=0.0,
        kernel_ms=cuda_ms(lambda: real_adam(kern[0], kern[1], kern[2],
                                            kern[3], adams[0][4])),
        plain_ms=cuda_ms(lambda: A.adam_table_plain(
            plain[0], plain[1], plain[2], plain[3], adams[0][4])),
        library_ms=cuda_ms(lib.step), bound_ms=bound, bound_by=by))
    if prof:
        profile("train_nerf", lambda: TT.train_step(
            st, grid, batches[-2], None, cfg, generator=gen))
    steady = sorted(ms)[len(ms) // 2]
    log("train_nerf", step_ms=ms, median_step_ms=steady, min_step_ms=min(ms),
        max_step_ms=max(ms), rays_per_step=R, rays_per_s=R / (steady / 1e3),
        chain_rows_per_step=R * cfg.querier.SR * cfg.querier.K,
        chain_chunks=cfg.agg.chain_chunks, remat_chain=cfg.agg.remat_chain,
        max_memory_allocated=peak, launches=launches, loss_items_last=items,
        rows_moved=int(moved.sum()), knobs=knobs,
        step_segments={k: seg[k] for k in (
            "shape", "rows_in_segments", "touched_ids", "max_segment",
            "kernel_ms")})
    return launches


def _nerf_faults():
    """The NeRF check's planted faults: the chain's ray chunks joined out
    of order (the first chunk moved last); the chain's weight gradient of
    the last chunk alone (the other chunks' chain_dw results dropped;
    autograd runs the last chunk first); a black background on the white
    scene (the batch's bg_color zeroed)."""
    from hybridneuralrendering_tpu_torch.models import aggregator as AG
    from hybridneuralrendering_tpu_torch.ops import shading_chain as SC
    from hybridneuralrendering_tpu_torch.train import step as TT

    def rotated(real):
        return lambda outs: real(outs[1:] + outs[:1])

    def last_chunk_dw(real):
        calls = []

        def backward_on_card(*a):
            d_emb, d_dists, d_extra, packed = real(*a)
            calls.append(1)
            if len(calls) > 1:
                packed = packed * 0.0
            return d_emb, d_dists, d_extra, packed
        return backward_on_card

    def black_bg(real):
        return lambda batch: dict(real(batch),
                                  bg_color=batch["bg_color"] * 0.0)

    return {"chunks out of order": (
                _Planted(AG, "join_chunks", rotated), "item_rel_err"),
            "last chunk's dW only": (
                _Planted(SC, "backward_on_card", last_chunk_dw),
                "net_grad_rel_l2"),
            "black background": (
                _Planted(TT, "device_batch", black_bg), "item_rel_err")}


def phase_train_cli_nerf(root, cfg):
    """cli.train.main --preset fixture_nerf_points --load-points 1 on the
    object scene for NERF_CLI_STEPS steps (no probe, prune or eval in that
    many steps; the final save), launches equal to the schedule's
    (_predicted_launches: every step uncached, the bootstrap's grid); then
    cli.test.main scores NERF_CLI_SCORED whole 400x400 test frames of the
    saved state (per frame 40 eval chunks of 4,096 rays, the last 256;
    the loaded points' grid)."""
    import re
    import numpy as np
    import torch
    from hybridneuralrendering_tpu_torch.cli import test as cli_test
    from hybridneuralrendering_tpu_torch.cli import train as cli_train
    ck = os.path.join(root, "nerf_ckpts")
    argv = ["--preset", "fixture_nerf_points", "--data-root", root,
            "--scan", NERF_SCAN, "--checkpoints-dir", ck, "--load-points",
            "1", "--max-steps", str(NERF_CLI_STEPS), "--print-freq", "20",
            "--seed", "0", "--device", DEVICE]
    steps = []

    def timed(real):
        def train_step(*a, **kw):
            t = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            steps.append((t, (time.perf_counter() - t) * 1e3))
            return out
        return train_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with _Planted(cli_train.step_mod, "train_step", timed):
        st = cli_train.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    bare = [ms for _, ms in steps]
    # one step's start to the next's: the loop's wall a step
    loop = [(b[0] - a[0]) * 1e3 for a, b in zip(steps, steps[1:])]
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    want = _predicted_launches(cfg, launches,
                               [(False, 1)] * NERF_CLI_STEPS, grids=1)
    run_dir = os.path.join(ck, f"{NERF_SCAN}_points")
    saved = sorted(os.listdir(os.path.join(run_dir, "ckpt")))
    if launches != want or st.step != NERF_CLI_STEPS or saved != [
            f"{NERF_CLI_STEPS}_state.npz", "run_config.json"]:
        raise AssertionError(f"the NeRF trainer: step {st.step}, saved "
                             f"{saved}, launched {launches}, want {want}")
    H, W = cfg.image_hw
    chunks = -(-H * W // cfg.sampling.eval_rays)
    reset_launches()
    t0 = time.perf_counter()
    scores = cli_test.main(argv[:8] + ["--num-frames", str(NERF_CLI_SCORED),
                                       "--device", DEVICE])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    t_launches = read_launches()
    t_want = _predicted_launches(cfg, t_launches,
                                 renders=NERF_CLI_SCORED * chunks, grids=1)
    with open(os.path.join(run_dir + "_test", "log.txt")) as f:
        frames = [float(m.group(1)) for m in re.finditer(
            r"frame \d+: PSNR \S+\s+render \S+ \((\d+) rays/s\)", f.read())]
    if (t_launches != t_want or len(frames) != NERF_CLI_SCORED
            or not all(np.isfinite(v) for v in scores.values())):
        raise AssertionError(f"the NeRF eval: scores {scores}, frames "
                             f"{frames}, launched {t_launches}, want "
                             f"{t_want}")
    log("train_cli_nerf", steps=NERF_CLI_STEPS, train_seconds=train_s,
        step_ms=_stats(bare), loop_ms=_stats(loop),
        outside_steps_seconds=train_s - sum(bare) / 1e3,
        points=st.points.num_live,
        checkpoint_bytes=os.path.getsize(os.path.join(
            run_dir, "ckpt", saved[0])),
        max_memory_allocated=peak, launches=launches, test_seconds=test_s,
        scored_frames=NERF_CLI_SCORED, chunks_a_frame=chunks,
        frame_rays_per_s=frames, scores=scores, test_launches=t_launches)
    return {k: launches[k] + t_launches[k] for k in launches}


# the aggregator's other model code (ROADMAP item 10) in serve_knobs and
# train_check_knobs; the plane behind the scene (its points lie within
# z <= 3) facing the camera, and its colour
KNOB_VARIANTS = ("sh_intrp", "gau_intrp", "attention", "attention_gumbel",
                 "plane")
PLANE = dict(plane_pnt=(0.0, 0.0, 3.5), plane_normal=(0.0, 0.1, 1.0),
             plane_color=(0.25, 0.55, 0.45))
# raised density bias of knob_state's parameters, and the spread of the
# embeddings of the distance kernels' points in serve_knobs (N(0, scale)):
# at 4 the SH sign flip moved 256 rays' colours by at most 4.8e-3 on the
# card, under the check's 5e-3; at 8 the SH terms saturate, where a flip
# moves them most.  The Gaussian kernel keeps 4: its radii are sigmoids of
# the embedding, which at 8 would leave most weights zero.  The training
# checks keep the scene's 0.1-scale table: with the spread one, the bf16
# chain's card-vs-CPU gradient of the fusion weights read 8.04e-3 against
# the train_check limit of 8e-3.
KNOB_ALPHA_BIAS = 3.0
KNOB_EMBEDDING_SCALE = {"sh_intrp": 8.0, "gau_intrp": 4.0}
# rays of request 0 that serve_knobs holds against the CPU
KNOB_CHECK_RAYS = 1024
# pixels: a projected coordinate this close to an integer or to the
# image's edge may round to the other side on the CPU (ceil, floor)
NEAR_INTEGER = 1e-3
# share of a view's pixels whose foreground splat may differ between the
# card and the CPU: points within float32 rounding of a pixel's edge
# (about 100 of 2.4M projected coordinates lie within 1e-5 pixel of one)
FG_FLIP_SHARE = 1e-3


def knob_config(cfg, name):
    """cfg with one knob of KNOB_VARIANTS on."""
    import dataclasses
    if name == "plane":
        return cfg.replace(render=dataclasses.replace(cfg.render,
                                                      bgmodel="img_plane"))
    agg = {"sh_intrp": dict(agg_distance_kernel="sh_intrp"),
           "gau_intrp": dict(agg_distance_kernel="gau_intrp"),
           "attention": dict(tradition_attention=True),
           "attention_gumbel": dict(tradition_attention=True,
                                    use_gumbel_softmax=True)}[name]
    return cfg.replace(agg=dataclasses.replace(cfg.agg, **agg))


def knob_state(cfg, name, points, spread=True):
    """(cfg, params, points) of a knob: full-width parameters from seed 0
    with the density head's bias raised by KNOB_ALPHA_BIAS (so that the
    colours come from the points, whose weights the kernels set), the
    attention's output projection seeded too (zero at init, which would
    leave the fusion out of every output), and for the distance kernels
    the points' embeddings N(0, KNOB_EMBEDDING_SCALE) (the table's
    0.1-scale embeddings keep every rotation inside the +-pi/4 clip, every
    SH term near sigmoid(0) and the neighbours' features alike, where a
    planted fault would not show); `spread` False keeps the scene's table
    (the training checks, which plant no fault)."""
    import dataclasses
    import torch
    from hybridneuralrendering_tpu_torch.models import renderer
    kcfg = knob_config(cfg, name)
    params = renderer.init_params(kcfg, seed=0, device=DEVICE)
    with torch.no_grad():
        params["aggregator"]["alpha"][-1]["b"] += KNOB_ALPHA_BIAS
    att = params["aggregator"].get("attention")
    if att is not None:
        g = torch.Generator(device=DEVICE).manual_seed(4)
        att["proj"]["w"] = 0.2 * torch.randn(
            att["proj"]["w"].shape, generator=g, device=DEVICE)
    if spread and name in KNOB_EMBEDDING_SCALE:
        g = torch.Generator(device=DEVICE).manual_seed(5)
        table = points.table.clone()
        width = cfg.points.feature_dim
        table[:, 3:3 + width] = KNOB_EMBEDDING_SCALE[name] * torch.randn(
            (table.shape[0], width), generator=g, device=table.device)
        points = dataclasses.replace(points, table=table)
    return kcfg, params, points


def _plane_arrays(b):
    """A batch (numpy arrays or tensors) with the plane keys, the left half
    of its views' images replaced by the plane colour +- 0.05 (seeded), so
    that some samples fit the plane's +-0.03 colour window and some do
    not.  The right half keeps the images' texture: on views of nearly
    one colour the bf16 pyramid's features carry little signal, and the
    card-vs-CPU gradient of the fusion weights read 2.3e-2 against
    train_check's 8e-3."""
    import numpy as np
    import torch
    imgs = b["images_nearest"]
    W = imgs.shape[2]
    color = np.asarray(PLANE["plane_color"], np.float32)
    noise = np.random.default_rng(7).uniform(
        -0.05, 0.05, tuple(imgs.shape)).astype(np.float32)
    new = (imgs.cpu().numpy() if torch.is_tensor(imgs)
           else np.array(imgs, np.float32))
    new[:, :, :W // 2] = np.clip(color + noise, 0, 1)[:, :, :W // 2]
    out = dict(b, **{k: np.asarray(v, np.float32) for k, v in PLANE.items()})
    if torch.is_tensor(imgs):
        out = {k: torch.as_tensor(v, device=imgs.device)
               if not torch.is_tensor(v) else v for k, v in out.items()}
        out["images_nearest"] = torch.as_tensor(new, device=imgs.device)
    else:
        out["images_nearest"] = new
    return out


# the attention requests' views: camera offsets in metres (the serve
# requests' views all sit at the request's camera, where every view is
# valid for the same samples and sees the same delta view direction)
VIEW_SPREAD = ((0.8, 0.0), (-0.8, 0.3), (0.3, -0.6), (-0.2, 0.5))


def _spread_views(b):
    """The request with its nearest views moved apart by VIEW_SPREAD (x, y),
    so that a sample is valid in some views and not in others."""
    import torch
    c2w = b["c2w_nearest"].clone()
    shift = torch.zeros((c2w.shape[0], 3), device=c2w.device)
    shift[:, :2] = torch.tensor(VIEW_SPREAD[:c2w.shape[0]],
                                device=c2w.device)
    c2w[:, :3, 3] += shift
    return dict(b, c2w_nearest=c2w, campos_nearest=c2w[:, :3, 3].clone())


def _knob_faults(name):
    """The planted fault of a knob: SH evaluated with flip_dir=True; the
    Gaussian kernel's rotations not clipped to +-pi/4; attention without
    its view mask; the plane without its foreground mask."""
    import torch
    from hybridneuralrendering_tpu_torch.core import bg_plane
    from hybridneuralrendering_tpu_torch.models import aggregator as agg
    from hybridneuralrendering_tpu_torch.models import attention

    def flipped(real):
        return lambda d, deg, flip_dir=False: real(d, deg, flip_dir=True)

    def unclipped(real):
        def dist_weight_ex(name_, dists, pnt_mask, emb, vsize, grid_vox_sz,
                           sh_degree=agg.SH_DEGREE):
            if name_ != "gau_intrp":
                return real(name_, dists, pnt_mask, emb, vsize, grid_vox_sz,
                            sh_degree)
            radii = vsize[2] * 20.0 * torch.sigmoid(emb[..., 1:4])
            gau = agg.compute_world2local_dist(dists[..., :3], radii,
                                               emb[..., 4:7])
            w = (pnt_mask.to(dists.dtype) * torch.abs(emb[..., 0])
                 * torch.exp(-0.5 * torch.sum(gau ** 2, dim=-1)))
            return w, emb[..., 7:].contiguous()
        return dist_weight_ex

    def unmasked(real):
        return lambda p, q, c, valid=None, **kw: real(p, q, c, None, **kw)

    def no_foreground(real):
        return lambda xyz, mask, w2c, intr, H, W: torch.zeros(
            H, W, device=xyz.device)

    return {"sh_intrp": ("flip_dir", _Planted(agg, "sh_basis", flipped)),
            "gau_intrp": ("rotation not clipped",
                          _Planted(agg, "dist_weight_ex", unclipped)),
            "attention": ("no view mask",
                          _Planted(attention, "apply", unmasked)),
            "attention_gumbel": ("no view mask",
                                 _Planted(attention, "apply", unmasked)),
            "plane": ("no foreground mask",
                      _Planted(bg_plane, "fg_pixel_mask", no_foreground))
            }[name]


def _plane_rays_kept(req_c, points_c, cfg):
    """Rays of a CPU plane request whose crossing projects, in every view,
    farther than NEAR_INTEGER from an integer pixel and from the edge, and
    onto a pixel whose foreground splat the card and the CPU agree on;
    the pixels they disagree on, per view.  Returns (kept [R] bool, flips
    per view)."""
    import numpy as np
    import torch
    from hybridneuralrendering_tpu_torch.core import bg_plane
    H, W = cfg.image_hw
    xyz, _ = bg_plane.ray_plane_cross(req_c["campos"], req_c["raydir"],
                                      req_c["plane_pnt"],
                                      req_c["plane_normal"])
    keep = np.ones(xyz.shape[0], bool)
    flips = []
    intr = req_c["intrinsic_nearest"]
    for c2w in req_c["c2w_nearest"]:
        w2c = torch.linalg.inv(c2w)
        cam = torch.cat([xyz.double(), torch.ones_like(xyz[:, :1]).double()],
                        -1) @ torch.linalg.inv(c2w.double()).T
        xy = ((cam[:, :3] / cam[:, 2:3]) @ intr.double().T)[:, :2].numpy()
        frac = np.abs(xy - np.round(xy))
        edge = np.minimum.reduce([np.abs(xy[:, 0]), np.abs(xy[:, 0] - W + 1),
                                  np.abs(xy[:, 1]), np.abs(xy[:, 1] - H + 1)])
        keep &= (frac > NEAR_INTEGER).all(-1) & (edge > NEAR_INTEGER)
        fg_c = bg_plane.fg_pixel_mask(points_c.xyz, points_c.mask, w2c,
                                      intr, H, W)
        fg_d = bg_plane.fg_pixel_mask(
            points_c.xyz.to(DEVICE), points_c.mask.to(DEVICE),
            torch.linalg.inv(c2w.to(DEVICE)), intr.to(DEVICE), H, W).cpu()
        diff = (fg_c != fg_d).numpy()
        flips.append(int(diff.sum()))
        cx = np.clip(np.ceil(xy[:, 0]).astype(np.int64), 0, W - 1)
        cy = np.clip(np.ceil(xy[:, 1]).astype(np.int64), 0, H - 1)
        keep &= ~diff[cy, cx]
    return keep, flips


def phase_serve_knobs(cfg, points, grid, grid_c, requests, base_steady):
    """The serve phase's requests with each knob of KNOB_VARIANTS
    (knob_state's parameters and points; the plane's requests with the
    plane keys, their bg_ray computed in each request; the attention's
    with their views moved apart, _spread_views): launches equal to
    the preset path's (one K-min and one chain forward a chunk), steady
    rays/s beside the preset path's and the peak; KNOB_CHECK_RAYS rays of
    request 0 against the CPU (the plane's rays kept by _plane_rays_kept,
    its bg_ray among the outputs); then request 0 on the card with the
    knob's planted fault (_knob_faults), which the same check must
    reject."""
    import torch
    from hybridneuralrendering_tpu_torch import serve
    from hybridneuralrendering_tpu_torch.train import step as TT
    chunks = sum(-(-r["raydir"].shape[0] // cfg.sampling.eval_rays)
                 for r in requests)
    total = None
    for name in KNOB_VARIANTS:
        t0 = time.perf_counter()
        kcfg, params, pts = knob_state(cfg, name, points)
        reqs = ([_plane_arrays(r) for r in requests] if name == "plane"
                else [_spread_views(r) for r in requests]
                if name.startswith("attention") else requests)

        def render(req):
            req = TT.maybe_add_bg_ray(req, pts, kcfg)
            out = serve.render_rays(params, pts, grid, req, kcfg)
            if "bg_ray" in req:
                out["bg_ray"] = req["bg_ray"]
            return out

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        outs, ms = [], []
        for req in reqs:
            t = time.perf_counter()
            outs.append(render(req))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        want = dict.fromkeys(launches, 0)
        want.update(k_smallest=chunks, shading_chain_fwd=chunks)
        if launches != want:
            raise AssertionError(f"serve {name} launched {launches}, want "
                                 f"{want}")
        for out in outs:
            for k, v in out.items():
                if v.is_floating_point() and not torch.isfinite(v).all():
                    raise AssertionError(f"serve {name}: {k} not finite")
        total = launches if total is None else {
            k: total[k] + launches[k] for k in total}
        req_c = cpu(dict(reqs[0],
                         raydir=reqs[0]["raydir"][:KNOB_CHECK_RAYS]))
        pts_c = cpu(pts)
        keep, flips = None, None
        if name == "plane":
            keep, flips = _plane_rays_kept(req_c, pts_c, kcfg)
            if max(flips) > FG_FLIP_SHARE * kcfg.image_hw[0] * \
                    kcfg.image_hw[1] or keep.sum() < KNOB_CHECK_RAYS // 2:
                raise AssertionError(f"serve plane: {flips} foreground "
                                     f"pixels differ, {keep.sum()} rays kept")
        t_cpu = time.perf_counter()
        breq = TT.maybe_add_bg_ray(req_c, pts_c, kcfg)
        ref = serve.render_rays(cpu(params), pts_c, grid_c, breq, kcfg)
        if "bg_ray" in breq:
            ref["bg_ray"] = breq["bg_ray"]
        cpu_s = time.perf_counter() - t_cpu
        pick = (torch.arange(KNOB_CHECK_RAYS) if keep is None
                else torch.as_tensor(keep).nonzero()[:, 0])

        def errs_of(out):
            return _ray_errors({k: v[:KNOB_CHECK_RAYS][pick.to(v.device)]
                                for k, v in out.items()},
                               {k: v[pick] for k, v in ref.items()})

        errs = errs_of(outs[0])
        fault_name, fault = _knob_faults(name)
        with fault:
            fault_errs = errs_of(render(reqs[0]))
        steady = sorted(ms[1:])[len(ms[1:]) // 2]
        hit = float(torch.cat([o["ray_mask"] for o in outs]).float().mean())
        log("serve_knobs", knob=name, request_ms=ms, launches=launches,
            steady_rays_per_s=RAYS_PER_REQUEST / (steady / 1e3),
            preset_steady_rays_per_s=base_steady, ray_hit_share=hit,
            max_memory_allocated=peak, check_rays=int(len(pick)),
            fg_pixels_differing=flips, check_max_abs_err=errs,
            check_tolerance=CHECK_TOL, fault=fault_name,
            fault_max_abs_err=fault_errs, cpu_seconds=cpu_s,
            seconds=time.perf_counter() - t0)
        bad = _rejected(errs, CHECK_TOL)
        if bad:
            raise AssertionError(f"serve {name}: card and CPU differ: {bad}")
        if not _rejected(fault_errs, CHECK_TOL):
            raise AssertionError(f"serve {name}: the planted fault "
                                 f"({fault_name}) passed: {fault_errs}")
    return total


def _frame_timer(frames, H, W, scene=None):
    """A render_full_frame wrapper that times each frame to synchronize
    and keeps its image; `scene`, where given, gets the first frame's
    params, points and grid."""
    import torch

    def make(real):
        def render_full_frame(*a, **kw):
            if scene is not None and not scene:
                scene.update(params=a[0], points=a[1], grid=a[2])
            t = time.perf_counter()
            img = real(*a, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            if img.shape != (H, W, 3) or not torch.isfinite(img).all():
                raise AssertionError(f"frame {len(frames)}: image "
                                     f"{tuple(img.shape)} not finite")
            frames.append(dict(ms=ms, rays_per_s=H * W / (ms / 1e3),
                               img=img))
            return img
        return render_full_frame
    return make


def _run_render_vid(argv, cfg, n_frames, grids=1, cli=None, scene=None):
    """cli.main(argv) (cli.render_vid's, or another CLI that renders
    through render_vid.render_pose_path: cli.edit's) on the card, each
    frame timed, launches over the call; without imageio it must end with
    ModuleNotFoundError naming it after all frame PNGs are written (as the
    JAX CLI), with it the video must exist.  `scene` gets the rendered
    params, points and grid (_frame_timer).  Returns (frames, launches,
    video, seconds)."""
    import torch
    from hybridneuralrendering_tpu_torch import serve
    from hybridneuralrendering_tpu_torch.cli import render_vid
    cli = cli or render_vid
    H, W = cfg.image_hw
    frames = []
    try:
        import imageio  # noqa: F401
        has_imageio = True
    except ModuleNotFoundError:
        has_imageio = False
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    video = None
    with _Planted(serve, "render_full_frame",
                  _frame_timer(frames, H, W, scene)):
        try:
            video = cli.main(argv)
            if not has_imageio:
                raise AssertionError(f"{cli.__name__} wrote a video "
                                     "without imageio")
        except ModuleNotFoundError as e:
            if has_imageio or "imageio" not in str(e):
                raise
            video = f"ModuleNotFoundError: {e}"
    seconds = time.perf_counter() - t0
    launches = read_launches()
    chunks = -(-H * W // cfg.sampling.eval_rays)
    want = _predicted_launches(cfg, launches, renders=n_frames * chunks,
                               grids=grids)
    if launches != want or len(frames) != n_frames:
        raise AssertionError(f"{cli.__name__}: {len(frames)} frames, "
                             f"launched {launches}, want {want}")
    if has_imageio and cli is render_vid and not os.path.exists(video):
        raise AssertionError(f"render_vid: no video at {video}")
    return frames, launches, video, seconds


def phase_render_vid(cfg, root, ck_root, st_c, grid_c):
    """cli.render_vid on eval_cli's scene and checkpoint (--key-stride 1
    --frames 8: the 4 training poses' closed path, 8 whole 480x640 frames):
    rays/s a frame, launches (per frame one K-min and one chain forward a
    chunk; the loaded points' grid), the PNGs; CHECK_RAYS pixels of path
    frame 1 against the CPU render of the same pose from the same file,
    and frame 2 (the next pose) must be rejected by the same check."""
    import numpy as np
    import torch
    from hybridneuralrendering_tpu_torch import serve
    from hybridneuralrendering_tpu_torch.cli import render_vid
    from hybridneuralrendering_tpu_torch.data import scannet
    import argparse
    H, W = cfg.image_hw
    n = 8
    argv = ["--preset", "serve", "--data-root", root, "--scan", "synth",
            "--checkpoints-dir", ck_root, "--name", "synth_full",
            "--key-stride", "1", "--frames", str(n), "--device", DEVICE]
    frames, launches, video, seconds = _run_render_vid(argv, cfg, n)
    pngs = sorted(os.listdir(os.path.join(ck_root, "synth_full_vid",
                                          "images")))
    if pngs != [f"step-{i:04d}-path.png" for i in range(n)]:
        raise AssertionError(f"render_vid wrote {pngs}")
    t0 = time.perf_counter()
    ds = scannet.ScannetScene(root, "synth", cfg, "train")
    poses = render_vid.scene_path_poses(ds, argparse.Namespace(
        frames=n, key_stride=1, phi=0.0, radius=0.0))
    pick = np.linspace(0, H * W - 1, CHECK_RAYS).astype(np.int64)
    pix = np.stack([pick % W, pick // W], -1).astype(np.float32)[:, None]
    view = render_vid.PathView(ds, poses)
    ref = serve.render_rays(
        st_c.params, st_c.points, grid_c,
        scannet.device_batch(view.get_batch(1, pixelcoords=pix), "cpu"),
        cfg)["coarse_raycolor"]
    idx = torch.as_tensor(pick)

    def err(k):
        img = frames[k]["img"].reshape(-1, 3).cpu()
        return float((img[idx] - ref).abs().max())

    errs, fault = err(1), err(2)
    log("render_vid", frames=[{k: v for k, v in f.items() if k != "img"}
                              for f in frames],
        launches=launches, seconds=seconds, video=video, pngs=len(pngs),
        check_rays=CHECK_RAYS, check_max_abs_err=errs,
        check_tolerance=CHECK_TOL, fault_next_pose_max_abs_err=fault,
        check_seconds=time.perf_counter() - t0)
    if errs > CHECK_TOL:
        raise AssertionError(f"render_vid frame 1: card and CPU differ "
                             f"{errs}")
    if fault <= CHECK_TOL:
        raise AssertionError(f"render_vid: the next pose passed the check "
                             f"({fault})")
    return launches


def phase_visualize(cfg, root, ck_root):
    """cli.visualize on eval_cli's checkpoint, all 16 test frames (stride
    1): its PSNR lines (2 decimals) equal cli.test's (3 decimals) for the
    frames both scored, to the last printed digit; launches as its
    schedule."""
    import re
    import torch
    from hybridneuralrendering_tpu_torch.cli import visualize
    H, W = cfg.image_hw
    argv = ["--preset", "serve", "--data-root", root, "--scan", "synth",
            "--checkpoints-dir", ck_root, "--name", "synth_full",
            "--frames", "16", "--device", DEVICE]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    psnrs = visualize.main(argv)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    chunks = -(-H * W // cfg.sampling.eval_rays)
    want = _predicted_launches(cfg, launches, renders=len(psnrs) * chunks,
                               grids=1)

    def lines(sub):
        with open(os.path.join(ck_root, sub, "log.txt")) as f:
            return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
                r"frame (\d+): PSNR ([\d.]+)", f.read())}

    vis, test = lines("synth_full_vis"), lines("synth_full_test")
    both = sorted(set(vis) & set(test))
    diffs = {i: abs(vis[i] - test[i]) for i in both}
    pngs = os.listdir(os.path.join(ck_root, "synth_full_vis", "images"))
    log("visualize", frames=len(psnrs), seconds=seconds, launches=launches,
        psnr=vis, cli_test_psnr=test, compared=both)
    if (launches != want or len(pngs) != 16 or len(psnrs) != 16
            or len(both) < 4
            or max(diffs.values()) > 0.0051):
        raise AssertionError(f"visualize: launched {launches} (want {want}),"
                             f" {len(pngs)} PNGs, PSNR {vis} against "
                             f"cli.test's {test}")
    return launches


def phase_render_vid_nerf(root, cfg):
    """cli.render_vid --preset fixture_nerf_points on train_cli_nerf's
    checkpoint: the spherical orbit, 8 whole 400x400 frames (40 chunks of
    16 chain pieces each), rays/s a frame, launches as the schedule's;
    without imageio it ends with ModuleNotFoundError after the 8 PNGs."""
    n = 8
    ck = os.path.join(root, "nerf_ckpts")
    argv = ["--preset", "fixture_nerf_points", "--data-root", root,
            "--scan", NERF_SCAN, "--checkpoints-dir", ck, "--frames",
            str(n), "--device", DEVICE]
    frames, launches, video, seconds = _run_render_vid(argv, cfg, n)
    pngs = os.listdir(os.path.join(ck, f"{NERF_SCAN}_points_vid", "images"))
    log("render_vid_nerf", frames=[{k: v for k, v in f.items()
                                    if k != "img"} for f in frames],
        launches=launches, seconds=seconds, video=video, pngs=len(pngs))
    if len(pngs) != n:
        raise AssertionError(f"render_vid NeRF wrote {pngs}")
    return launches


# the edit phase: cli.edit on eval_cli's checkpoint, two parts: the whole
# scene, and every second live point turned EDIT_ANGLE degrees about z
# and shifted by EDIT_SHIFT (inside serve's ranges, +-3.2 m): 900,000
# points, EDIT_FRAMES orbit frames at the CLI's default radius and phi.
# The merge holds 779,258 occupied voxels and 6,551,458 supervoxel nodes
# (a numpy census of the synthetic scene), past serve's max_o 610,000 and
# max_nodes 4,000,000, over which both packages' grid builds drop voxels
# silently; EDIT_PRESET is serve_config() with those two capacities
# raised, every width unchanged.
EDIT_PRESET = "serve_edit"
EDIT_FRAMES = 8
EDIT_ANGLE, EDIT_SHIFT = 30.0, (0.3, -0.2, 0.1)
EDIT_MAX_O, EDIT_MAX_NODES = 1_000_000, 7_000_000
EDIT_CHECK_RAYS = 1_024
# the query_pers phase: the frustum querier on the serve scene from the
# requests' camera, at serve's SR, K and z_depth_dim, with vsize (in x/z,
# y/z and z units, times vscale 2) PERS_VSIZE: its grid is 351 x 264 x
# 497 voxels, 46.2M z-padded of serve's 70M grid_capacity, with 187,406
# points in the frustum, 165,491 occupied voxels and 1,482,512 supervoxel
# nodes (numpy census), inside max_o and max_nodes
PERS_VSIZE = (0.0016, 0.0016, 0.008)
PERS_CHECK_RAYS = 1_024
# the frame_weights phase: RAFT with seeded weights (flow/raft.init),
# the flow head's last conv scaled by FLOW_HEAD_SCALE: random weights
# move a frame by ~650 px after 12 refinements (by ~50 px after one),
# past any frame, and the blur scores of an empty overlap are NaN; scaled,
# the flows are a few pixels, as between neighbouring video frames
FLOW_HEAD = "update_block.flow_head.conv2.weight"
FLOW_HEAD_SCALE = 0.01
# card against CPU at one refinement: float32 convolutions summed in
# another order (tests/test_torch_port_flow.py's limit against JAX)
FLOW_RTOL, FLOW_ATOL = 1e-3, 5e-2
FLOW_PAIRS = 3


def edit_config():
    """serve_config() with the grid capacities of the 900,000-point
    merge (EDIT_MAX_O, EDIT_MAX_NODES)."""
    import dataclasses
    from hybridneuralrendering_tpu_torch import config
    cfg = config.serve_config()
    return cfg.replace(querier=dataclasses.replace(
        cfg.querier, max_o=EDIT_MAX_O, max_nodes=EDIT_MAX_NODES))


def _edit_transform():
    import numpy as np
    a = math.radians(EDIT_ANGLE)
    T = np.eye(4)
    T[:3, :3] = [[math.cos(a), -math.sin(a), 0],
                 [math.sin(a), math.cos(a), 0], [0, 0, 1]]
    T[:3, 3] = EDIT_SHIFT
    return T


def phase_edit(root, ck_root):
    """cli.edit on the card (EDIT_* constants): eval_cli's checkpoint
    whole, and half its live points (an index file) moved by a rotating
    transform; the 900,000-point merge's capacity rounded up to 900,096,
    its grid built, its points dumped, EDIT_FRAMES whole 480x640 orbit
    frames rendered (per frame one K-min and one chain forward a chunk,
    two row scans for the merged grid), the video call handled as
    render_vid's.  EDIT_CHECK_RAYS pixels of frame 1 again on the CPU,
    from the same files through the port's load_part / merge_parts, must
    agree within CHECK_TOL; the card's render of them with every rw2c the
    identity (the planted fault: the moved part shaded in the world's
    frame) must not."""
    import dataclasses
    import numpy as np
    import torch
    from hybridneuralrendering_tpu_torch import config, serve
    from hybridneuralrendering_tpu_torch.cli import edit, render_vid
    from hybridneuralrendering_tpu_torch.device import device_batch
    from hybridneuralrendering_tpu_torch.ops import voxel_grid as VG
    from hybridneuralrendering_tpu_torch.train import checkpoint as ckpt
    config.PRESETS[EDIT_PRESET] = edit_config
    cfg = edit_config()
    H, W = cfg.image_hw
    ckpt_dir = os.path.join(ck_root, "synth_full", "ckpt")
    with np.load(ckpt.latest_checkpoint(ckpt_dir)) as f:
        live = np.nonzero(f["points/mask"])[0]
    files = {k: os.path.join(root, f"edit_{k}.txt")
             for k in ("all", "half", "id", "rot")}
    np.savetxt(files["all"], live, fmt="%d")
    np.savetxt(files["half"], live[::2], fmt="%d")
    np.savetxt(files["id"], np.eye(4))
    np.savetxt(files["rot"], _edit_transform())
    argv = ["--preset", EDIT_PRESET, "--checkpoints-dir", ck_root,
            "--parts", "synth_full", "synth_full", "--index-files",
            files["all"], files["half"], "--transforms", files["id"],
            files["rot"], "--out-name", "synth_edited", "--render-frames",
            str(EDIT_FRAMES), "--device", DEVICE]
    scene = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frames, launches, video, seconds = _run_render_vid(
        argv, cfg, EDIT_FRAMES, cli=edit, scene=scene)
    peak = torch.cuda.max_memory_allocated()
    out_dir = os.path.join(ck_root, "synth_edited")
    if not isinstance(video, str):
        video = sorted(f for f in os.listdir(out_dir)
                       if f.startswith("video."))
    points, grid = scene["points"], scene["grid"]
    n_merged = len(live) + len(live[::2])
    pngs = sorted(os.listdir(os.path.join(out_dir, "images")))
    with open(os.path.join(out_dir, "points", "step-0.txt"), "rb") as f:
        dumped = sum(buf.count(b"\n") for buf in iter(
            lambda: f.read(1 << 24), b""))
    if (points.num_live != n_merged or dumped != n_merged
            or points.capacity != -(-n_merged // 1024) * 1024
            or points.rw2c is None
            or pngs != [f"step-{i:04d}-edited.png"
                        for i in range(EDIT_FRAMES)]):
        raise AssertionError(f"edit: {points.num_live} points of "
                             f"{n_merged}, capacity {points.capacity}, "
                             f"{dumped} dumped, PNGs {pngs}")

    # frame 1's pixels on the CPU from the same files
    t0 = time.perf_counter()
    parts, params_c = [], None
    for idx, trf in ((files["all"], files["id"]),
                     (files["half"], files["rot"])):
        p, attrs = edit.load_part(ckpt_dir, cfg, idx, trf, device="cpu")
        params_c = params_c or p
        parts.append(attrs)
    pts_c = edit.merge_parts(parts, cfg, device="cpu")
    grid_c = VG.grid_of(pts_c.xyz, pts_c.mask, cfg.querier)
    xyz = pts_c.xyz.numpy()[pts_c.mask.numpy()]
    poses = edit.orbit_poses(xyz.mean(axis=0), EDIT_FRAMES, -25.0, 3.0)
    pick = np.linspace(0, H * W - 1, EDIT_CHECK_RAYS).astype(np.int64)
    pix = np.stack([pick % W, pick // W], -1).astype(np.float32)[:, None]
    b = render_vid.PathView(edit.OrbitBase(cfg), poses).get_batch(
        1, pixelcoords=pix)
    ref = serve.render_rays(params_c, pts_c, grid_c, device_batch(b, "cpu"),
                            cfg)
    card = frames[1]["img"].reshape(-1, 3).cpu()[torch.as_tensor(pick)]
    err = float((card - ref["coarse_raycolor"]).abs().max())
    eye = torch.eye(3, device=points.table.device).expand(
        points.capacity, 3, 3)
    wrong = serve.render_rays(scene["params"],
                              dataclasses.replace(points, rw2c=eye),
                              grid, device_batch(b, DEVICE), cfg)
    fault = float((wrong["coarse_raycolor"].cpu()
                   - ref["coarse_raycolor"]).abs().max())
    check_s = time.perf_counter() - t0
    log("edit", frames=[{k: v for k, v in f.items() if k != "img"}
                        for f in frames],
        mean_frame_ms=sum(f["ms"] for f in frames) / len(frames),
        launches=launches, seconds=seconds, video=video,
        points=points.num_live, capacity=points.capacity,
        occupied_voxels=int(grid.num_occ), max_o=cfg.querier.max_o,
        supervoxel_nodes=int(grid.num_nodes),
        max_nodes=cfg.querier.max_nodes, max_memory_allocated=peak,
        check_rays=EDIT_CHECK_RAYS,
        ray_hit_share=float(ref["ray_mask"].float().mean()),
        check_max_abs_err=err, check_tolerance=CHECK_TOL,
        fault_identity_rw2c_max_abs_err=fault, check_seconds=check_s)
    if err > CHECK_TOL:
        raise AssertionError(f"edit frame 1: card and CPU differ {err}")
    if fault <= CHECK_TOL:
        raise AssertionError(f"edit: identity rw2c passed the check "
                             f"({fault})")
    return launches


def phase_query_pers(cfg, points, requests):
    """ops/query_pers on the card (PERS_* constants): the serve scene's
    frustum grid from the requests' camera (two row scans), then the
    NUM_REQUESTS requests through query_points_pers (one K-min each),
    timed; PERS_CHECK_RAYS rays of request 0 again on the CPU from the
    same points: grid tables, ids and masks equal, locations within
    1e-5."""
    import dataclasses
    import torch
    from hybridneuralrendering_tpu_torch.data import synthetic
    from hybridneuralrendering_tpu_torch.ops import query_pers as QP
    qcfg = dataclasses.replace(cfg.querier, vsize=PERS_VSIZE)
    H, W = cfg.image_hw
    near, far = cfg.render.near_plane, cfg.render.far_plane
    intr = synthetic.intrinsic(H, W)
    cam = requests[0]
    if not all(torch.equal(r["campos"], cam["campos"])
               and torch.equal(r["camrotc2w"], cam["camrotc2w"])
               for r in requests):
        raise AssertionError("query_pers: the requests' cameras differ")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    geom = QP.frustum_geometry(intr, H, W, near, far, qcfg, device=DEVICE)
    grid = QP.build_frustum_grid(points.xyz, points.mask, cam["camrotc2w"],
                                 cam["campos"], geom, qcfg)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    outs, ms = [], []
    for req in requests:
        t0 = time.perf_counter()
        outs.append(QP.query_points_pers(
            grid, points.xyz, req["camrotc2w"], req["campos"],
            req["raydir"], qcfg, near, far))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(launches, 0)
    want.update(k_smallest=len(requests), cumsum_rows=2)
    if launches != want:
        raise AssertionError(f"query_pers launched {launches}, want {want}")
    hit = float(torch.cat([o.ray_mask for o in outs]).float().mean())

    t0 = time.perf_counter()
    pts_c = cpu(points)
    cam_c = {k: v.cpu() for k, v in cam.items()}
    geom_c = QP.frustum_geometry(intr, H, W, near, far, qcfg, device="cpu")
    grid_c = QP.build_frustum_grid(pts_c.xyz, pts_c.mask,
                                   cam_c["camrotc2w"], cam_c["campos"],
                                   geom_c, qcfg)
    ref = QP.query_points_pers(grid_c, pts_c.xyz, cam_c["camrotc2w"],
                               cam_c["campos"],
                               cam_c["raydir"][:PERS_CHECK_RAYS], qcfg,
                               near, far)
    differ = [k for k in ("coor2occ", "occ_pnts", "coor2node", "occ_bits",
                          "num_occ", "num_nodes")
              if not torch.equal(getattr(grid, k).cpu(), getattr(grid_c, k))]
    differ += [k for k in ("sample_pidx", "sample_mask", "pnt_mask",
                           "ray_mask")
               if not torch.equal(getattr(outs[0], k)[:PERS_CHECK_RAYS]
                                  .cpu(), getattr(ref, k))]
    loc_err = float((outs[0].sample_loc_w[:PERS_CHECK_RAYS].cpu()
                     - ref.sample_loc_w).abs().max())
    check_s = time.perf_counter() - t0
    log("query_pers", vsize=PERS_VSIZE, query_vsize=qcfg.query_vsize,
        dims=geom.dims, voxels=geom.dims[0] * geom.dims[1]
        * (geom.dims[2] + 2), grid_capacity=qcfg.grid_capacity,
        occupied_voxels=int(grid.num_occ), max_o=qcfg.max_o,
        supervoxel_nodes=int(grid.num_nodes), max_nodes=qcfg.max_nodes,
        build_ms=build_ms, request_ms=ms, rays=RAYS_PER_REQUEST,
        SR=qcfg.SR, K=qcfg.K, z_depth_dim=qcfg.z_depth_dim,
        launches=launches, ray_hit_share=hit, max_memory_allocated=peak,
        check_rays=PERS_CHECK_RAYS, check_differ=differ,
        check_sample_loc_max_abs_err=loc_err, check_seconds=check_s)
    if hit <= 0:
        raise AssertionError("query_pers: no ray found a neighbour")
    if differ or loc_err > 1e-5 * float(
            ref.sample_loc_w.abs().max()):
        raise AssertionError(f"query_pers: card and CPU differ in {differ}"
                             f", locations by {loc_err}")
    return launches


def phase_frame_weights(root):
    """RAFT and the frame-weight CLI on the card (FLOW_* constants):
    seeded weights saved as a reference-layout .pth and loaded through
    io/torch_import on the card and on the CPU; one 480x640 pair at one
    refinement, card against CPU within FLOW_RTOL / FLOW_ATOL; FLOW_PAIRS
    pairs at 12 refinements timed (ms a pair, peak), finite; then
    cli.frame_weights --raft-ckpt on eval_cli's scene (one finite weight
    a training frame) and without it (identity flow) on the card and on
    the CPU, bit-equal.  None of the port's kernels runs."""
    import numpy as np
    import torch
    from hybridneuralrendering_tpu_torch.cli import frame_weights as fw_cli
    from hybridneuralrendering_tpu_torch.data import scannet
    from hybridneuralrendering_tpu_torch.flow import raft
    from hybridneuralrendering_tpu_torch.io import torch_import as TI
    from hybridneuralrendering_tpu_torch import config
    cfg = config.serve_config()
    H, W = cfg.image_hw
    sd = raft.init(seed=0, device="cpu").state_dict()
    sd[FLOW_HEAD] *= FLOW_HEAD_SCALE
    path = os.path.join(root, "raft-seeded.pth")
    torch.save({"module." + k: v for k, v in sd.items()}, path)
    reset_launches()
    card, host = TI.load_raft(path, DEVICE), TI.load_raft(path, "cpu")
    rng = np.random.default_rng(0)
    im1 = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    im2 = np.roll(im1, (2, 5), axis=(0, 1))
    a, b = torch.as_tensor(im1), torch.as_tensor(im2)
    t0 = time.perf_counter()
    f_card = raft.estimate_flow(card, a.to(DEVICE), b.to(DEVICE), 1).cpu()
    f_cpu = raft.estimate_flow(host, a, b, 1)
    one_s = time.perf_counter() - t0
    excess = float(((f_card - f_cpu).abs()
                    - FLOW_RTOL * f_cpu.abs()).max())
    one_err = float((f_card - f_cpu).abs().max())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a, b = a.to(DEVICE), b.to(DEVICE)
    raft.estimate_flow(card, a, b, 12)
    torch.cuda.synchronize()
    ms = []
    for _ in range(FLOW_PAIRS):
        t0 = time.perf_counter()
        flow = raft.estimate_flow(card, a, b, 12)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(flow).all())
    mean_px = float(flow.abs().mean())

    t0 = time.perf_counter()
    outs = {}
    for label, extra in (("raft", ["--raft-ckpt", path, "--device", DEVICE]),
                         ("identity_card", ["--device", DEVICE]),
                         ("identity_cpu", ["--device", "cpu"])):
        out = fw_cli.main(["--data-root", root, "--scan", "synth",
                           "--preset", "serve", "--out",
                           os.path.join(root, "fw_" + label)] + extra)
        outs[label] = np.load(out)
    cli_s = time.perf_counter() - t0
    launches = read_launches()
    n_train = len(scannet.ScannetScene(root, "synth", cfg,
                                       "train").train_id_list)
    log("frame_weights", pair_ms=ms, hw=[H, W], iters=12,
        max_memory_allocated=peak, flow_finite=finite,
        flow_mean_abs_px=mean_px, one_iteration_max_abs_err=one_err,
        one_iteration_excess_over_rtol=excess, rtol=FLOW_RTOL,
        atol=FLOW_ATOL, one_iteration_seconds=one_s,
        weights={k: v.tolist() for k, v in outs.items()},
        train_frames=n_train, cli_seconds=cli_s, launches=launches)
    if excess > FLOW_ATOL:
        raise AssertionError(f"RAFT card and CPU differ: {one_err}")
    if not finite:
        raise AssertionError("RAFT flow at 12 refinements is not finite")
    w = outs["raft"]
    if w.shape != (n_train,) or w.dtype != np.float32 or not np.isfinite(
            w).all():
        raise AssertionError(f"frame weights {w}")
    if not np.array_equal(outs["identity_card"], outs["identity_cpu"]):
        raise AssertionError("identity-flow weights differ card vs CPU")
    if any(launches.values()):
        raise AssertionError(f"frame_weights launched {launches}")
    return launches


def phase_profile_train(cfg, st, grid, batch, bank, staged, learnable):
    """One more training step and one more cached step under
    torch.profiler, each with the blur bank and with the learnable kernel
    (`learnable` = (its cfg, state, batch, staged maps))."""
    import torch
    from hybridneuralrendering_tpu_torch.train import step as TT
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    profile("train", lambda: TT.train_step(st, grid, batch, bank, cfg,
                                           generator=gen))
    profile("train_cached", lambda: TT.train_step(
        st, grid, batch, bank, cfg, generator=gen, img_feat_staged=staged))
    lcfg, lst, lbatch, lstaged = learnable
    profile("train_learnable", lambda: TT.train_step(
        lst, grid, lbatch, None, lcfg, generator=gen))
    profile("train_learnable_cached", lambda: TT.train_step(
        lst, grid, lbatch, None, lcfg, generator=gen,
        img_feat_staged=lstaged))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    signal.signal(signal.SIGALRM, _deadline)
    signal.alarm(DEADLINE_S)
    t_start = time.perf_counter()

    from hybridneuralrendering_tpu_torch import config
    from hybridneuralrendering_tpu_torch.models import renderer
    cfg = config.serve_config()
    smi = phase_device()
    phase_build()
    sel = phase_kernels(cfg)
    adam = phase_kernels_train()
    chain = phase_kernels_chain(config.train_config())
    # the chain at the embedding widths the SH and Gaussian kernels leave
    for knob, de in (("sh_intrp", 16), ("gau_intrp", 25)):
        phase_kernels_chain(knob_config(config.train_config(), knob),
                            label=f"{knob} de={de} ")
    scan = phase_kernels_scan()
    points, grid, params = phase_scene(cfg)
    requests, outs, serve_launches, serve_steady = phase_serve(
        cfg, points, grid, params)
    pervoxel_launches = phase_serve_pervoxel(cfg, points, grid, params,
                                             requests, outs)
    grid_c = cpu(grid)
    phase_check(cfg, points, grid, params, requests[0], outs[0], grid_c)
    knob_launches = phase_serve_knobs(cfg, points, grid, grid_c, requests,
                                      serve_steady)
    pers_launches = phase_query_pers(cfg, points, requests)
    if args.profile:
        phase_profile(cfg, points, grid, params, requests[1])
    tcfg = config.train_config()
    st, batch, bank, train_launches, seg, train_ms = phase_train(
        tcfg, points, grid)
    st, staged, cached_launches = phase_train_cached(tcfg, st, grid, bank,
                                                     train_ms)
    phase_train_check(tcfg, points, grid, grid_c, params)
    lcfg = learnable_config(tcfg)
    learnable_launches, learnable = phase_train_learnable(lcfg, points,
                                                         grid)
    phase_train_check(lcfg, points, grid, grid_c, renderer.init_params(
        lcfg, seed=0, device=DEVICE), learnable=True)
    for knob in KNOB_VARIANTS:
        kcfg, kparams, kpoints = knob_state(tcfg, knob, points,
                                            spread=False)
        phase_train_check(kcfg, kpoints, grid, grid_c, kparams, knob=knob)
        del kparams, kpoints
    eval_launches, driver_launches = phase_eval_cli(cfg, st, grid)
    train_cli_launches = phase_train_cli()
    if args.profile:
        phase_profile_train(tcfg, st, grid, batch, bank, staged, learnable)
    del st, batch, bank, staged, learnable, points, grid, params, grid_c
    with tempfile.TemporaryDirectory(prefix="nerf_") as root:
        ncfg, n_train, n_test, n_points, n_grid, n_params = \
            phase_nerf_scene(root)
        phase_kernels_chain(ncfg, NERF_CHAIN_ROWS, "NeRF ")
        nerf_launches = [
            phase_serve_nerf(ncfg, n_test, n_points, n_grid, n_params,
                             args.profile),
            phase_train_nerf(ncfg, n_train, n_points, n_grid, args.profile)]
        phase_train_check(ncfg, n_points, n_grid, cpu(n_grid), n_params,
                          nerf_ds=n_train)
        del n_points, n_grid, n_params
        nerf_launches.append(phase_train_cli_nerf(root, ncfg))
        nerf_launches.append(phase_render_vid_nerf(root, ncfg))
    signal.alarm(0)
    log("done", seconds=time.perf_counter() - t_start)

    launches = {k: serve_launches[k] + pervoxel_launches[k]
                + train_launches[k] + cached_launches[k]
                + learnable_launches[k] + eval_launches[k]
                + train_cli_launches[k] + sum(n[k] for n in nerf_launches)
                + knob_launches[k] + sum(d[k] for d in driver_launches)
                + pers_launches[k]
                for k in serve_launches}
    src = "hybridneuralrendering_tpu_torch/csrc/"

    def row(name, replaces, m):
        return {"name": name, "route": "cuda", "source": src + name + ".cu",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": m["max_abs_err"], "ms": m["kernel_ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": m["library_ms"]}

    kernels = [
        row("k_smallest", "hybridneuralrendering_tpu/ops/pallas_select.py:41",
            sel),
        row("segment_sum", "tools/pallas_gather.py:68", seg),
        row("adam_table", "tools/pallas_adam.py:61", adam),
        row("cumsum_rows", "tools/pallas_scan.py:50", scan)]
    chain_src = {"fwd": "tools/pallas_shading.py:201",
                 "bwd": "tools/pallas_shading.py:217",
                 "dw": "tools/pallas_shading.py:249"}
    for k, replaces in chain_src.items():
        r = dict(row("shading_chain_" + k, replaces, chain[k]),
                 source=src + "shading_chain.cu")
        kernels.append(r)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
