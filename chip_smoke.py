#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``yolov10_3d_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card     - print ``nvidia-smi`` name and power limit; no CUDA device fails.
  2. build    - compile every kernel source under yolov10_3d_torch/csrc with
                nvcc for sm_90a (one process per source, all at once).
  3. kernels  - hold each kernel against its plain PyTorch twin on the card at
                the main path's shapes; time both on the device (CUDA graph
                replay, CUDA events) and the kernel's eager call as well.
  4. serving  - YOLOv10-S (full width, nc=80, seeded random weights) answers
                three predict requests at 640x640: batch 1, a uniform batch of
                8 HD frames and a mixed-shape list. Every kernel's launch count must
                rise on each request; the detections must match the same model
                run on the CPU (TF32 off) within the parity-test bars.

The last three lines are the card line, one JSON object with the per-kernel
numbers, and {"ok": true, "device": {...}}. Imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# NVIDIA H100 SXM data sheet: HBM3 rate and float32 (non-tensor-core) peak.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
L2_COLD_BYTES = 100 * 2**20  # twice the 50 MB L2 cache
# K1 arithmetic per anchor: 4 x 16 bins x (max, sub, exp, add, mul, add)
# + 4 divides + 8 box ops + nc x (neg, exp, add, divide).
K1_OPS_PER_ANCHOR = lambda nc: 4 * 16 * 6 + 4 + 8 + 4 * nc  # noqa: E731

# Every kernel of the main path: where it lives and the TPU kernel it replaces.
KERNELS = {
    "decode_detect": {"route": "cuda", "source": "yolov10_3d_torch/csrc/decode_detect.cu",
                      "replaces": "yolov10_3d_tpu/ops/pallas_kernels.py:66"},
}

IMGSZ = 640
SCORE_TOL = 1e-4  # end-to-end bars of tests/test_torch_predictor.py
BOX_TOL = 0.1
CONF = 0.01  # low enough that every image fills max_det: the top-k cut is compared too


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, iters: int, warmup: int = 10) -> float:
    """Mean ms per call over ``iters`` back-to-back eager calls, CUDA events.
    Host work per call (checks, allocation, the launch) is included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_device(fns, replays: int = 20) -> float:
    """Device ms per call: every call of ``fns`` captured once in a CUDA
    graph, the graph replayed ``replays`` times, CUDA events around the
    replays. No host work between launches; one fn per input buffer, so
    that buffers larger than the L2 cache in all keep the reads cold."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * len(fns))


def phase_card():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs an NVIDIA GPU")
    line = card_line()
    print(f"[card] {line} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return line


def phase_build():
    from yolov10_3d_torch.kernels import _build

    names = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    for n in names:  # build from the sources every run: the time is real
        _build.lib_path(n).unlink(missing_ok=True)
    secs = _build.build(names)
    for n in names:
        report = [ln.strip() for ln in _build.build_report(n).splitlines()
                  if "registers" in ln or "spill" in ln]
        print(f"[build] {n}: {secs[n]:.1f} s -> {_build.lib_path(n).name}")
        for ln in report:
            print(f"[build]   {ln}")


def check_k1(B: int) -> dict:
    import torch

    from yolov10_3d_torch.kernels.decode import decode_detect_cuda, decode_detect_torch

    nc, shapes, strides = 80, [(80, 80), (40, 40), (20, 20)], (8, 16, 32)
    A = sum(h * w for h, w in shapes)
    g = torch.Generator(device="cuda").manual_seed(B)
    n_buf = -(-L2_COLD_BYTES // (B * (64 + nc) * A * 4))  # inputs > 2x the L2 cache
    xs = [torch.randn((B, 64 + nc, A), generator=g, device="cuda") for _ in range(n_buf)]
    got = decode_detect_cuda(xs[0], shapes, strides, nc)
    ref = decode_detect_torch(xs[0], shapes, strides, nc)
    torch.cuda.synchronize()
    # the bar of tests/test_pallas_kernels.py (TPU kernel vs its XLA twin)
    torch.testing.assert_close(got[..., :4], ref[..., :4], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[..., 4:], ref[..., 4:], rtol=1e-5, atol=1e-6)
    err = float((got - ref).abs().max())
    ms = time_device([lambda x=x: decode_detect_cuda(x, shapes, strides, nc) for x in xs])
    plain_ms = time_device([lambda x=x: decode_detect_torch(x, shapes, strides, nc) for x in xs])
    call_ms = time_cuda(lambda: decode_detect_cuda(xs[0], shapes, strides, nc), 200)
    nbytes = xs[0].numel() * 4 + got.numel() * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = B * A * K1_OPS_PER_ANCHOR(nc) / F32_FLOPS_PER_S * 1e3
    r = {
        "shape": [B, 64 + nc, A], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "eager_call_ms": call_ms,
    }
    print(f"[k1] B={B}: max_abs_err {err:.3g} | kernel {ms:.4f} ms (device, graph replay, "
          f"{n_buf} input buffers) | twin {plain_ms:.4f} ms | bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}, {nbytes / 1e6:.1f} MB) | eager call {call_ms:.4f} ms "
          f"| library_ms: null (no single PyTorch call computes this)")
    return r


def phase_kernels():
    return {"decode_detect": (check_k1(1), check_k1(32))}


def _check_results(results, shapes):
    import numpy as np

    if len(results) != len(shapes):
        raise AssertionError(f"{len(results)} results for {len(shapes)} images")
    for r, (h, w) in zip(results, shapes):
        d = np.asarray(r.boxes.data)
        if d.ndim != 2 or d.shape[1] != 6 or not np.isfinite(d).all() or len(d) == 0:
            raise AssertionError(f"bad detections {d.shape} for a {h}x{w} image")
        if (d[:, [0, 2]].min() < 0 or d[:, [0, 2]].max() > w
                or d[:, [1, 3]].min() < 0 or d[:, [1, 3]].max() > h):
            raise AssertionError("boxes leave the image")


def phase_serving(card: str):
    import numpy as np
    import torch

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.data.preprocess import preprocess_batch
    from yolov10_3d_torch.kernels import launch_counts, reset_launch_counts
    from yolov10_3d_torch.ops.preprocess import serve_preprocess
    from yolov10_3d_torch.utils.parity import calibrate, compare_results, smooth_images

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[serve] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    rng = np.random.default_rng(0)
    requests = [  # (name, image (h, w)s, batch)
        ("b1_640", [(640, 640)], 1),  # device letterbox, no resize
        ("uniform_b8", [(720, 1280)] * 8, 8),  # device letterbox, antialiased downscale
        ("mixed", [(480, 640), (640, 427), (360, 640), (512, 512)], 4),  # host letterbox
    ]
    requests = [(n, shp, smooth_images(rng, shp), b) for n, shp, b in requests]

    gpu = YOLOv10("yolov10s.yaml", device="cuda", seed=0)
    cal, _ = preprocess_batch([im for _, _, ims, _ in requests for im in ims], IMGSZ)
    calibrate(gpu.model, torch.from_numpy(cal).permute(0, 3, 1, 2).contiguous().cuda())
    n_params = sum(p.numel() for p in gpu.model.parameters())
    print(f"[serve] YOLOv10-S nc={gpu.spec.nc} params={n_params} strides={gpu.spec.strides}")

    for _, _, ims, b in requests:  # warm-up: cuDNN handles, allocator
        gpu.predict(ims, imgsz=IMGSZ, batch=b, conf=CONF)
    torch.cuda.synchronize()

    reps = 5
    reset_launch_counts()
    gpu_res, times = {}, {}
    for name, shp, ims, b in requests:
        times[name] = []
        for _ in range(reps):
            before = dict(launch_counts)
            t0 = time.perf_counter()
            res = gpu.predict(ims, imgsz=IMGSZ, batch=b, conf=CONF)  # returns host arrays: synced
            times[name].append((time.perf_counter() - t0) * 1e3)
            for k, v in launch_counts.items():
                if v <= before[k]:
                    raise AssertionError(f"request {name}: kernel {k} was not launched")
            _check_results(res, shp)
        gpu_res[name] = res
    launches = dict(launch_counts)
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"kernel {k} never launched on the main path")

    u8 = torch.from_numpy(np.stack(requests[1][2]))  # the uniform batch
    gap = (serve_preprocess(u8.cuda(), (IMGSZ, IMGSZ)).cpu()
           - serve_preprocess(u8, (IMGSZ, IMGSZ))).abs().max()
    print(f"[serve] device letterbox of {requests[1][0]}, GPU vs CPU: max abs diff "
          f"{float(gap):.3g} on [0, 1] pixels")

    cpu = YOLOv10("yolov10s.yaml", device="cpu", seed=0)
    cpu.model.load_state_dict(gpu.model.state_dict())
    for name, shp, ims, b in requests:
        t0 = time.perf_counter()
        ref = cpu.predict(ims, imgsz=IMGSZ, batch=b, conf=CONF)
        cpu_s = time.perf_counter() - t0
        stats = compare_results(ref, gpu_res[name], conf=CONF, score_tol=SCORE_TOL,
                                box_tol=BOX_TOL)
        if stats["n_compared"] < 0.5 * (stats["n_ref"] + stats["n_got"]):
            raise AssertionError(f"request {name}: too few separated detections {stats}")
        ms = statistics.median(times[name])
        print(f"[serve] {name}: {len(ims)} img, {stats['n_ref']} dets | GPU median "
              f"{ms:.2f} ms/request, {len(ims) / ms * 1e3:.1f} img/s ({card}, {reps} reps) "
              f"| vs CPU: {stats['n_compared']} compared, max score err "
              f"{stats['max_score_err']:.3g} (bar {SCORE_TOL}), max box err "
              f"{stats['max_box_err']:.3g} px (bar {BOX_TOL}); CPU took {cpu_s:.1f} s")
    print(f"[serve] main-path launches: {launches}")
    return launches


def main() -> int:
    t0 = time.perf_counter()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    card = phase_card()
    import torch

    import yolov10_3d_torch  # noqa: F401  (fails outside a checkout of the repo)

    phase_build()
    kern = phase_kernels()
    launches = phase_serving(card)
    if not set(KERNELS) == set(kern) == set(launches):
        raise AssertionError(f"kernel tables disagree: {set(KERNELS)}, {set(kern)}, {set(launches)}")
    entries = [
        {"name": name, **KERNELS[name], "launches": launches[name], **b1,
         "b32": {k: b32[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                     "eager_call_ms")}}
        for name, (b1, b32) in kern.items()
    ]
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
