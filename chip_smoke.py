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
                 rows (all BIG, all +inf, few entries below BIG, k > C);
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
 10. eval_cli    the evaluation CLI: a ScanNet-layout scene of 20 frames
                 of the requests' camera written as PNGs, the trained state
                 saved with save_checkpoint (load back bit-equal), then
                 cli.test.main scores 4 whole 480x640 test frames from that
                 file (per frame 19 K-min and 19 chain forwards, 2 row scans
                 for the grid of the loaded points, nothing else), writes
                 their PNGs and scores.txt; 256 pixels of frame 0 again on
                 the CPU from the same file must agree with the card's, and
                 the card's render of frame 0 with frame 1's pose must not.
`--profile` adds a torch.profiler pass over one more request, one more
training step and one more cached step and prints the kernels that took the
most device time.

The last lines are the kernel table ({"kernels": [...]}; `launches` sums
the serve, train, train_cached and eval_cli runs), the card as nvidia-smi
names it, and {"ok": true, "device": {...}}.  Any failure exits non-zero
before those lines.  The port's float32 matmuls and convolutions run
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
    shapes = [main_shape, (75_264, cfg.querier.Ps, K), (75_264, 64, 8),
              (4_096, 702, 8)]
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
    return requests, outs, launches


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
    q = cfg.querier
    radius = q.radius_limit_scale * max(q.vsize[0], q.vsize[1])
    emb = 0.1 * torch.randn(n, cfg.agg.point_features_dim, generator=gen,
                            device=DEVICE)
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


def phase_kernels_chain(cfg):
    """The fused shading chain's kernels against their plain versions on the
    card (ops/shading_chain.tolerance, a relative L2 error per output) with
    random full-width weights: the forward at a serving chunk's rows
    (16,384 rays * SR * K) and at a training step's (3,136 * SR * K), the
    backward kernels at the training step's rows, two backward launches bit
    for bit.  Controls the comparisons must reject: a planted fault
    (block3's extra columns read one column off) in the forward, and
    old_chain, the per-layer chain the kernels replace, which rounds more
    (bf16 end to end), in the forward and the backward.  old_chain is also
    the yardstick, timed at the same rows."""
    import torch
    from hybridneuralrendering_tpu_torch.models import renderer
    from hybridneuralrendering_tpu_torch.ops import shading_chain as SC
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    a = cfg.agg
    dt_name = a.shading_dtype
    dt = SC.COMPUTE_DTYPES[dt_name]
    params = renderer.init_params(cfg, seed=2, device=DEVICE)["aggregator"]
    chain = {k: params[k] for k in ("block1", "block2", "block3", "alpha")
             if k in params}
    kpr = cfg.querier.SR * cfg.querier.K
    serve_rows = RAYS_PER_REQUEST * kpr
    train_rows = cfg.sampling.rays_per_batch * kpr
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

    rows["fwd"], _ = forward_row(serve_rows, "serve chunk")
    rows["fwd_train"], (emb, dists, extras, extra, layout, w, b) = \
        forward_row(train_rows, "training step")

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

    common = dict(rows="training step", tolerance={"grad": tol},
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
    log("chain", rows=n, fused_fwd_bwd_ms=cuda_ms(fused_fwd_bwd, 5),
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


def phase_train_check(cfg, points, grid, grid_c, params):
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
    that rejects it over that reading's limit."""
    import dataclasses
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
    R = small.sampling.rays_per_batch
    o = small.optim
    arrays = synthetic.batch_arrays(small, seed=99)
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
    return launches


def phase_profile_train(cfg, st, grid, batch, bank, staged):
    """One more training step and one more cached step under
    torch.profiler."""
    import torch
    from hybridneuralrendering_tpu_torch.train import step as TT
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    profile("train", lambda: TT.train_step(st, grid, batch, bank, cfg,
                                           generator=gen))
    profile("train_cached", lambda: TT.train_step(
        st, grid, batch, bank, cfg, generator=gen, img_feat_staged=staged))


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
    cfg = config.serve_config()
    smi = phase_device()
    phase_build()
    sel = phase_kernels(cfg)
    adam = phase_kernels_train()
    chain = phase_kernels_chain(config.train_config())
    scan = phase_kernels_scan()
    points, grid, params = phase_scene(cfg)
    requests, outs, serve_launches = phase_serve(cfg, points, grid, params)
    grid_c = cpu(grid)
    phase_check(cfg, points, grid, params, requests[0], outs[0], grid_c)
    if args.profile:
        phase_profile(cfg, points, grid, params, requests[1])
    tcfg = config.train_config()
    st, batch, bank, train_launches, seg, train_ms = phase_train(
        tcfg, points, grid)
    st, staged, cached_launches = phase_train_cached(tcfg, st, grid, bank,
                                                     train_ms)
    phase_train_check(tcfg, points, grid, grid_c, params)
    eval_launches = phase_eval_cli(cfg, st, grid)
    if args.profile:
        phase_profile_train(tcfg, st, grid, batch, bank, staged)
    signal.alarm(0)
    log("done", seconds=time.perf_counter() - t_start)

    launches = {k: serve_launches[k] + train_launches[k]
                + cached_launches[k] + eval_launches[k]
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
