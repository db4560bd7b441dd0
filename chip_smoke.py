"""Drive the PyTorch port on one NVIDIA GPU: build, check, serve.

    python3 chip_smoke.py [--profile]

Phases, each printing one JSON progress line:
  1. device   the card's name and power limit, torch and CUDA versions;
  2. build    every CUDA kernel of the port, one nvcc per source, together;
  3. kernels  each kernel against its plain PyTorch version on the card at
              the serving shapes (exact equality), with times and bounds;
  4. scene    the 600k-point serve_config scene, grid and random full-width
              parameters, built on the card;
  5. serve    4 requests of 16,384 rays through serve.render_rays, with
              every kernel's launch count read over exactly that run;
  6. check    the first rays of request 0 rendered again on the CPU through
              the plain versions, compared with the card's result.
`--profile` adds a torch.profiler pass over one more request and prints the
kernels that took the most device time.

The last lines are the kernel table ({"kernels": [...]}), the card as
nvidia-smi names it, and {"ok": true, "device": {...}}.  Any failure exits
non-zero before those lines.  The port's float32 matmuls and convolutions
run without TF32 (torch.backends.cuda.matmul.allow_tf32 stays False and
serve sets cudnn's allow_tf32 False).
"""

from __future__ import annotations

import argparse
import json
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
# published H100 SXM peaks (dense): bytes/s of HBM3, float32 op/s outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def phase_build():
    from hybridneuralrendering_tpu_torch.ops import build, select
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(select.KERNEL_LIBS)) as pool:
        futs = [pool.submit(build.load_library, name, srcs)
                for name, srcs in select.KERNEL_LIBS.items()]
        for f in futs:
            f.result()
    log("build", seconds=time.perf_counter() - t0,
        nvcc_seconds=build.BUILD_SECONDS)


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


def phase_kernels(cfg):
    """K-min kernel vs plain at the serving shape and two others."""
    import torch
    from hybridneuralrendering_tpu_torch.ops import select
    gen = torch.Generator(device="cuda").manual_seed(0)
    K = cfg.querier.K
    main_shape = (RAYS_PER_REQUEST * cfg.querier.SR, cfg.querier.Ps, K)
    shapes = [main_shape, (75_264, 64, 8), (4_096, 702, 8)]
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
            plain_ms=cuda_ms(lambda: select.k_smallest_plain(d, ids, k)),
            library_ms=cuda_ms(lambda: torch.topk(d, k, dim=1,
                                                  largest=False)),
            bound_ms=bound, bound_by=by)
        log("kernels", kernel="k_smallest", **row)
        rows[(S, C, k)] = row
    return rows[main_shape]


def phase_scene(cfg):
    import torch
    from hybridneuralrendering_tpu_torch.data import synthetic
    from hybridneuralrendering_tpu_torch.models import renderer
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    points, grid = synthetic.make_synthetic_scene(
        cfg, cfg.points.num_points, seed=0, device=DEVICE)
    params = renderer.init_params(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    log("scene", seconds=time.perf_counter() - t0,
        points=int(points.num_live), occupied_voxels=int(grid.num_occ),
        supervoxel_nodes=int(grid.num_nodes),
        max_memory_allocated=torch.cuda.max_memory_allocated())
    return points, grid, params


def phase_serve(cfg, points, grid, params):
    import torch
    from hybridneuralrendering_tpu_torch import serve
    from hybridneuralrendering_tpu_torch.data import synthetic
    from hybridneuralrendering_tpu_torch.ops import select
    requests = [synthetic.make_synthetic_batch(
        cfg, seed=1 + i, num_rays=RAYS_PER_REQUEST, device=DEVICE)
        for i in range(NUM_REQUESTS)]
    chunks = sum(-(-r["raydir"].shape[0] // cfg.sampling.eval_rays)
                 for r in requests)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, ms = [], []
    select.k_smallest.launches = 0
    for req in requests:
        t0 = time.perf_counter()
        outs.append(serve.render_rays(params, points, grid, req, cfg))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"k_smallest": select.k_smallest.launches}
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
    if launches["k_smallest"] != chunks:
        raise AssertionError(f"k_smallest launched {launches['k_smallest']}"
                             f" times for {chunks} chunks")
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    log("serve", request_ms=ms, chunks=chunks, launches=launches,
        ray_hit_share=hit, rays_per_s=NUM_REQUESTS * RAYS_PER_REQUEST
        / (sum(ms) / 1e3), steady_rays_per_s=RAYS_PER_REQUEST
        / (steady / 1e3), max_memory_allocated=torch.cuda
        .max_memory_allocated())
    return requests, outs, launches


def phase_check(cfg, points, grid, params, request, out):
    """Rays of request 0 again on the CPU through the plain versions."""
    import torch
    import dataclasses
    from hybridneuralrendering_tpu_torch import serve

    def cpu(x):
        if torch.is_tensor(x):
            return x.cpu()
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        if isinstance(x, list):
            return [cpu(v) for v in x]
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(cpu(v) for v in x))
        return x

    grid_c = cpu(grid)
    pts_c = dataclasses.replace(points, table=points.table.cpu(),
                                mask=points.mask.cpu())
    req_c = cpu(dict(request, raydir=request["raydir"][:CHECK_RAYS]))
    t0 = time.perf_counter()
    ref = serve.render_rays(cpu(params), pts_c, grid_c, req_c, cfg)
    errs = {}
    for k, v in ref.items():
        got = out[k][:CHECK_RAYS].cpu()
        if v.dtype == torch.bool:
            errs[k] = int((got != v).sum())
        else:
            errs[k] = float((got.float() - v.float()).abs().max())
    # bf16 chains round at other points on the two devices: one bf16 step
    # near 1 is 2**-8; the masks must agree exactly
    tol = 5e-3
    bad = {k: e for k, e in errs.items()
           if (isinstance(e, int) and e) or e > tol}
    log("check", rays=CHECK_RAYS, max_abs_err=errs, tolerance=tol,
        seconds=time.perf_counter() - t0)
    if bad:
        raise AssertionError(f"card and CPU renders differ: {bad}")


def phase_profile(cfg, points, grid, params, request):
    """One request under torch.profiler: device time by kernel and by
    render stage (the record_function ranges of models/renderer.py), and
    the share of the request's wall time the device was busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from hybridneuralrendering_tpu_torch import serve
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.render_rays(params, points, grid, request, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    stage = ("render.", "agg.")     # record_function ranges, not kernels
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
    log("profile", wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=1.0 - busy_ms / wall_ms,
        stage_span_ms=ranges,
        top_kernels=[{"name": k[:90], "device_ms": us / 1e3, "calls": c}
                     for us, k, c in kernels[:12]])


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
    points, grid, params = phase_scene(cfg)
    requests, outs, launches = phase_serve(cfg, points, grid, params)
    phase_check(cfg, points, grid, params, requests[0], outs[0])
    if args.profile:
        phase_profile(cfg, points, grid, params, requests[1])
    signal.alarm(0)
    log("done", seconds=time.perf_counter() - t_start)

    kernels = [{
        "name": "k_smallest", "route": "cuda",
        "source": "hybridneuralrendering_tpu_torch/csrc/k_smallest.cu",
        "replaces": "hybridneuralrendering_tpu/ops/pallas_select.py:41",
        "launches": launches["k_smallest"],
        "max_abs_err": sel["max_abs_err"], "ms": sel["kernel_ms"],
        "plain_ms": sel["plain_ms"], "bound_ms": sel["bound_ms"],
        "bound_by": sel["bound_by"], "library_ms": sel["library_ms"]}]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
