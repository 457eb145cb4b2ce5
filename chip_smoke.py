#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``yolov10_3d_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card     - print ``nvidia-smi`` name and power limit; no CUDA device fails.
  2. build    - compile every kernel source under yolov10_3d_torch/csrc with
                nvcc for sm_90a (one process per source, all at once).
  3. kernels  - hold each kernel against its plain PyTorch twin on the card at
                the main path's shapes, at batch 1 and 32; time both on the
                device (CUDA graph replay, CUDA events) and the kernel's eager
                call as well. The int8 kernels must equal their twins bit for bit.
                The fused stem (stem_conv): float32 at B=1 and B=32 at 640x640
                and B=1 at 384x1280, bf16 at B=32, odd sizes with C 16 and 80,
                each bit for bit against its twin, beside cuDNN's conv + SiLU.
                K1 reads the per-scale maps in place, bit for bit against its
                twin on their concatenation; the concatenation is timed too.
                K2 at both of its sites (SPPF.cv1, PSA ffn.0) at B=1, 8 and
                32, beside torch._int_mm on the same GEMM (a yardstick).
                Each line prints the share of the bound (bound / kernel ms).
  3b. int8-layers - every distinct gated-conv shape of YOLOv10-S's int8 plan
                at 640x640 on its three routes (K2, K3, int8_conv_f32), at
                batch 1 and 8: bit for bit against the twin, device ms, bound
                and share of bound; the sum over one forward's 43 launches
                (printed again after [serve] beside the int8 requests'
                medians); two yardsticks the port never calls: torch._int_mm
                on a 1x1 shape (the GEMM alone) and cuDNN's fp16
                channels-last conv on a 3x3 shape (a float16 route's cost).
  4. serving  - YOLOv10-S (full width, nc=80, seeded random weights) answers
                three float32 predict requests at 640x640 (batch 1, a uniform
                batch of 8 HD frames and a mixed-shape list) and two int8 ones
                (batch 1 and the 8 HD frames; scope k3deep, scale 8/127), all
                with the default spd_serving (the stem in the fused stem
                kernel). Each request must launch its kernels: the stem kernel
                and K1 once per batch, and in int8 K2, K3 and int8_conv_f32
                exactly as often as the int8 plan has them per forward (the
                stem out of it); float32 requests launch no int8 kernel. The
                float32 detections must match the same model run on the CPU
                (TF32 off) within the parity-test bars, and the same requests
                served with spd_serving=False (the unfused stem) on the card.
                The int8 detections must match the same forward with the
                kernels' twins on the card (score 1e-2, box 1 px), and every
                gated conv must match the CPU int8 path given the same input (a
                free-running CPU run is chaotic in int8: see
                int8_layers_vs_cpu); the free-running gap is printed. One
                float32 request is profiled, eager and replayed: its device
                operations, and no flatten-concatenation of the head maps
                before K1. Every request goes through the Predictor's captured
                forward: its first call runs eagerly and captures the key, the
                timed calls replay the graph (one replay counts one launch of
                each kernel it holds, so the expected counts are per request as
                before); the twins' int8 reference runs the eager forward. The port's
                top-k (ties to the lowest index) is timed beside torch.topk
                at v10_postprocess's shapes, B=1 and 8 (a yardstick).
  4b. serve3d - YOLOv10-S-3D (full width, nc=3, seeded random weights
                calibrated on the served frames) answers KITTI-sized requests
                at 384x1280 (375x1242 uint8 frames): one frame and eight at
                max_det 50 (the sparse head) and one at max_det 100 (the dense
                fallback), five times each; the stem kernel launches once per
                forward. The detections must match a CPU run of the same
                weights (TF32 off): score 1e-4, 2D box and projected 3D centre
                0.1 px, s3d and dep_un 1e-3 (the CPU's own float32 error on
                these frames is printed beside them); and on the card the
                sparse head must match the dense one. Then kitti_b8 once more
                on a second net calibrated to BatchNorm std 0.5 (the 2D
                requests'): the card's dense one2one maps (unfused stem, and
                the served fused stem) must lie, branch by branch, within
                twice the distance of the CPU float32 run of the same route
                from a float64 run of the same weights and input.
  4x. serve-graph - at the end of phases 4 and 4b, for every request
                (and kitti_b8_dense, eight frames at max_det 100): each
                chunk's replayed forward against the eager forward on the same
                model input, bit for bit (torch.equal; fatal otherwise, the
                differing output columns named); median host ms per request
                captured and eager over 5 calls in turns; one replay's device
                ms (CUDA events); each key's capture time, reserved memory and
                launches per replay. Then the 3D route (ROADMAP 10b): is dense
                faster than sparse beyond the calls' spread at B=1 and B=8?
  4d. server - the port's InferenceServer on the card (HTTP on localhost,
                port 0): YOLOv10-S at 640, max_batch 8, max_delay_ms 10;
                warmup captures buckets 1, 2, 4 and 8; 16 client threads post
                64 PNGs (480x640, from the seed, encoded here with zlib) from
                a child process (the clients do not share the server's
                interpreter lock); every
                response held to a direct call of the captured Predictor at the
                float32 bars; requests/s, p50/p90/p99, batch_hist, /stats; one
                K1 and one stem launch per device batch. Then YOLOv10-S-3D at
                384x1280, max_batch 2, four frames from two threads, held
                likewise. Both servers stopped, no thread left behind.
  4e. sources - prediction over files as users call it. On the host (no
                cv2, no PIL here): every file of tests/data/codec decoded by
                cv2's and PIL's rules equals the digests of cv2's and PIL's
                pixels committed beside it, every enc_*.png encodes to the
                digests of PIL's and cv2's JPEG bytes, and each codec stage
                of the library equals its numpy rule (data/codec_rules.py).
                Then YOLOv10-S at 640 (seeded, calibrated) predicts a folder
                of 32 frames of 480x640 (28 JPEG written by the port's
                encoder, 3 PNG, 1 BMP) at batch 1 and 8, with save, save_txt
                and save_crop, and with stream=True: the Results equal, bit
                for bit, those of the same frames passed as ndarrays, and
                every saved file equals what its Results give (the annotated
                JPEG, the label lines, the crops). img/s over files, the
                decode ms of a 640x480 JPEG and the decode share of a
                request. A .pt in the JAX package's export format, written
                here with torch.save from the port's model, serves bit for bit
                as the model it came from (YOLOv10-S, and YOLOv10-S-3D at
                384x1280). One JPEG request to the InferenceServer, its rows
                held to the direct call. K1 and the stem once per forward.
  4c. val3d  - KITTI AP40 validation, YOLOv10("yolov10s_3D.yaml").val(...), on a
                synthetic KITTI tree the script writes to a temporary directory:
                16 frames of 375x1242 PNGs (smooth background, painted
                objects), labels of the three classes at every difficulty
                and a DontCare row each, KITTI's P2 calibration. The net is
                [serve3d]'s, calibrated on these frames, its one2many head set
                near the one2one head (a trained net's, so the depth fusion
                finds clusters). Two runs at 1280x384, batch 8: max_det 50 (the
                sparse head) and use_o2m_depth (the dense head and the
                one2many depth fusion). Each is held to the same call on the
                CPU in float64 (same weights, TF32 off; the CPU's float32 run
                is as far from it as the card, printed beside): the KITTI rows
                of every image,
                before the text formatting, the same count and classes, score
                1e-4 + 1e-3 max(1, |ln score|) of the score (the score is
                sigmoid * exp(-dep_un)), 2D box 0.1 px, sizes and depth 1e-3
                relative, angles 1e-3 where the heading bin agrees (differing
                bins counted). Prints both AP40 tables, the rotated IoU's
                route, the hand kernels' launches (the path runs none: cuDNN
                convs, the plain 3D decode and top-k) and images/s split into
                loader, device, host rows and evaluator.
  5. train-lockstep - one train step of YOLOv10-S (nc=80, seeded weights, the
                trainer's head init) at 640x640, batch 2, on one augmented
                batch with fixed draws, SGD, float32 with TF32 off, on the GPU
                and on the CPU from the same state: the six loss terms within
                rtol 1e-3 and every parameter's update within 1e-2 of its
                largest element (plus 1e-4 of the model's largest update, for
                the parameters whose exact gradient is 0).
  6. train    - YOLOv10("yolov10s.yaml").train(...) on a synthetic set of 160
                PNGs (640x480, painted boxes) that the script writes to a
                temporary directory: imgsz 640, batch 16, one epoch, device
                augmentation, the JAX defaults otherwise (AdamW, nbs 64, amp).
                K4 must launch once per step; the epoch's loss means must be
                finite.
  6b. host-aug - the host augmentation's C++ library (native/host_aug.cc,
                built with g++) against its numpy twins (data/cv2_rules.py;
                this host has no cv2): host-mode items of the same set from
                one seed, 32 at the JAX defaults and 8 with degrees 10,
                shear 2, perspective 5e-4 and mosaic9 0.5, equal bit for bit
                in every key and in the generator's final state; ms library
                against twin (warpAffine and warpPerspective 1280²→640², HSV
                at 640², one sample); the loader's img/s alone at workers 0,
                2 and 4, beside os.cpu_count().
  6c. train-host - YOLOv10("yolov10s.yaml").train at the JAX defaults
                (device_aug False: the host augmentation; amp, workers 4) on
                the same set at 640, batch 16, 2 epochs with close_mosaic=1:
                ms a step in the loop per epoch (mosaic, then letterbox),
                img/s and loader-wait share an epoch, the device's busy and
                idle share (torch.profiler, 3 steps), the step with no
                loader, beside [train]'s device-augmentation figures; no K4.
                Then device_aug=True, close_mosaic=1, half the set, 2
                epochs: tile batches and K4 in the first, host batches in
                the second.
  7. ckpt     - YOLOv10("yolov10s.yaml").train(...) on 64 synthetic PNGs at
                640x640, batch 16, 2 epochs, device augmentation, validation
                every epoch and checkpoints (last, best, a mid-epoch save every
                2 steps): the file's size, the train thread's snapshot ms per
                save against the writer thread's encode-and-write ms, the
                writes submitted and done; K4 once a step, K1 once a
                validation batch. Then, in a child process with
                CUBLAS_WORKSPACE_CONFIG set and deterministic algorithms, a
                run killed after a mid-epoch save (between two accumulated
                micro-steps) and resumed must end bit for bit where an
                uninterrupted run ends (or, where torch names an op as
                nondeterministic, within [train-lockstep]'s update bars).
                YOLOv10(".../best.ckpt") and last.ckpt serve [serve]'s b1_640
                request through the captured forward bit for bit what the
                run's own EMA models serve (K1 and the stem launch); the file
                stripped to float16 serves bit for bit what its float16-rounded
                weights serve, and its gap to the float32 file is printed.
  8. val2d    - YOLOv10("yolov10s.yaml").val(...) on the same 64 PNGs at 640,
                batch 16, weights calibrated on them: img/s split into loader
                wait, device (forward, K1, top-k), host rows and metrics; K1
                once a batch; every image's rows held to a float64 CPU run of
                the same weights at the [serve] bars, metrics both ways.
  9. learn3d  - the JAX 3D learn-proof (tests/test_overfit_ap.py:58-103), key
                for key: yolov10n-3D on 8 synthetic KITTI frames at 320x96, 300
                epochs, AdamW, checkpoints; YOLOv10(".../last.ckpt").val must
                reach mAP50 >= 0.9 and metrics/3D >= 7.0.
  10. learn2d - the JAX 2D learn-proof (tests/test_overfit_ap.py:188-223),
                key for key: yolov10n on 8 synthetic 96x96 frames (a numpy
                mirror of tests/_helpers.py make_overfit2d_tree, written as
                JPEG by the port's encoder: the helper's cv2.imwrite bytes) at 64, 900 epochs, mosaic 0 (the host letterbox path),
                checkpoints; YOLOv10(".../last.ckpt").val must reach mAP50
                >= 0.9 and mp >= 0.8; the int8 reference: the same file's
                predict(int8=True) on the 8 frames, scored by
                utils/metrics.py, must reach mAP50 >= 0.9 (K2, K3 and
                int8_conv_f32 on trained weights), the float32 predict
                scored beside it.

Each path (serving, serve3d, server, sources, val3d, train, train-host, ckpt, val2d, learn3d,
learn2d) is driven with the launch counts set to 0 just before it and read just after. The last three lines are
the card line, one JSON object with the per-kernel numbers, and {"ok": true, "device":
{...}}.
Imports no JAX.

    python3 chip_smoke.py --sweep NAMES [--package-root DIR]

with NAMES a comma-separated subset of stem, k1, int8, k2tiles, val2d-std05,
learn2d-epoch, serve3d-std05 and serve, runs the card line, the build of the
named kernels and their timings only
(the stem and K1 as in phase 3, the int8 convs as in phase 3b and K2 as in
phase 3, "k2tiles" every tile K2 compiles, "val2d-std05" [val2d] at
BatchNorm std 0.5, "learn2d-epoch" [learn2d]'s epoch with and without its
saves, "serve3d-std05" [serve3d]'s std 0.5 check on frames upsampled by
cv2's rule and the witnesses of its miss, "serve" the device kernels of one float32 request), with the
``yolov10_3d_torch``
package found under DIR (default: this checkout), so that two checkouts'
kernels can be timed in one call on one card.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import itertools
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

# NVIDIA H100 SXM data sheet: HBM3 rate, float32 (non-tensor-core) peak and
# int8 dense tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
L2_COLD_BYTES = 100 * 2**20  # twice the 50 MB L2 cache
# K1 arithmetic per anchor: 4 x 16 bins x (max, sub, exp, add, mul, add)
# + 4 divides + 8 box ops + nc x (neg, exp, add, divide).
K1_OPS_PER_ANCHOR = lambda nc: 4 * 16 * 6 + 4 + 8 + 4 * nc  # noqa: E731
# K4 arithmetic per pixel: max/min 4, 4 divides, 8 adds and subtracts, 3 gain
# multiplies, fmod, 4 clips, floor, 8 for p/q/t, 15 sector selects, 6 compares.
K4_OPS_PER_PIXEL = 54

# Every kernel of the main path: where it lives and the TPU kernel it replaces.
KERNELS = {
    "decode_detect": {"route": "cuda", "source": "yolov10_3d_torch/csrc/decode_detect.cu",
                      "replaces": "yolov10_3d_tpu/ops/pallas_kernels.py:66"},
    "int8_mm_fused": {"route": "cuda", "source": "yolov10_3d_torch/csrc/int8_conv.cu",
                      "replaces": "yolov10_3d_tpu/ops/pallas_kernels.py:109"},
    "int8_conv3x3_fused": {"route": "cuda", "source": "yolov10_3d_torch/csrc/int8_conv.cu",
                           "replaces": "yolov10_3d_tpu/ops/pallas_kernels.py:161"},
    "int8_conv_f32": {"route": "cuda", "source": "yolov10_3d_torch/csrc/int8_conv.cu",
                      "replaces": "yolov10_3d_tpu/nn/modules.py:68 (XLA int8_conv, no TPU kernel)"},
    "hsv_jitter": {"route": "cuda", "source": "yolov10_3d_torch/csrc/hsv_jitter.cu",
                   "replaces": "yolov10_3d_tpu/ops/pallas_preprocess.py:113"},
    "stem_conv": {"route": "cuda", "source": "yolov10_3d_torch/csrc/stem_conv.cu",
                  "replaces": "tools/exp_pallas_stem.py:94; tools/exp_pallas_stem2.py:130"},
}
SERVING_KERNELS = ("decode_detect", "int8_mm_fused", "int8_conv3x3_fused", "int8_conv_f32",
                   "stem_conv")
SERVE3D_KERNELS = ("stem_conv",)
SERVER_KERNELS = ("decode_detect", "stem_conv")
SOURCES_KERNELS = ("decode_detect", "stem_conv")
SOURCES_FRAMES = 32  # 640x480: 28 JPEG, 3 PNG, 1 BMP
BRANCHES_3D = ("cls", "o2d", "s2d", "o3d", "s3d", "hd", "dep", "dep_un")  # o2o_heads.{j}
TRAIN_KERNELS = ("hsv_jitter",)
TRAIN_FIGURES: dict = {}  # [train]'s figures, printed again beside [train-host]

IMGSZ = 640
SCORE_TOL = 1e-4  # end-to-end bars of tests/test_torch_predictor.py
BOX_TOL = 0.1
SCORE_TOL_INT8 = 1e-2  # int8: a float rounding gap can move a code by one step
BOX_TOL_INT8 = 1.0
CONF = 0.01  # low enough that every image fills max_det: the top-k cut is compared too
KITTI_HW = (384, 1280)  # the 3D model's input; KITTI frames are 375x1242
REG_TOL_3D = 1e-3  # s3d and dep_un, raw head outputs of order 1 (tests/test_torch_detect3d.py)
# The 3D net is calibrated to BatchNorm outputs of std 0.25, not the 2D
# requests' 0.5: at 0.5 a random YOLOv10-S-3D amplifies float32 rounding on
# these KITTI frames to 5.7e-5 in score and 6e-3 in the regression maps on
# the CPU alone (against float64), the size of the bars; at 0.25 to 3.4e-6
# and 8.4e-5. float32_gap_3d prints that floor beside each comparison. At
# 0.5, std05_vs_float64 holds the card to float64 relative to that floor.
BN_STD_3D = 0.25
VAL3D_FRAMES = 16
KITTI_P2 = ("7.215377e+02 0.000000e+00 6.095593e+02 4.485728e+01 0.000000e+00 7.215377e+02 "
            "1.728540e+02 2.163791e-01 0.000000e+00 0.000000e+00 1.000000e+00 2.745884e-03")


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
    cpu = next((ln.split(":", 1)[1].strip() for ln in Path("/proc/cpuinfo").read_text()
                .splitlines() if ln.startswith("model name")), "unknown")
    print(f"[card] {line} | torch {torch.__version__} cuda {torch.version.cuda} cudnn "
          f"{torch.backends.cudnn.version()} | {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()} | host {cpu}, {os.cpu_count()} CPUs")
    return line


def phase_build(names=None):
    """Build ``names`` (default: every source under csrc/) anew, print the
    build times and ptxas' registers and spills per kernel."""
    from yolov10_3d_torch.kernels import _build

    names = names or sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
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
    """K1 at YOLOv10's 640x640 head shapes: the kernel on the per-scale maps
    as the serving path hands them over (separate NCHW tensors read in
    place; a checkout without that entry, on their concatenation, which its
    serving path launched first), held to the twin on the concatenation.
    Device times of the kernel, the twin and that concatenation; the bound."""
    import torch

    from yolov10_3d_torch.kernels import decode as KD

    nc, shapes, strides = 80, [(80, 80), (40, 40), (20, 20)], (8, 16, 32)
    A = sum(h * w for h, w in shapes)
    g = torch.Generator(device="cuda").manual_seed(B)
    n_buf = -(-L2_COLD_BYTES // (B * (64 + nc) * A * 4))  # inputs > 2x the L2 cache
    maps = [[torch.randn((B, 64 + nc, h, w), generator=g, device="cuda") for h, w in shapes]
            for _ in range(n_buf)]
    cat = lambda m: torch.cat([f.flatten(2) for f in m], 2)  # noqa: E731
    flats = [cat(m) for m in maps]
    in_place = hasattr(KD, "decode_detect_maps_cuda")
    if in_place:
        call = lambda m, x: KD.decode_detect_maps_cuda(m, strides, nc)  # noqa: E731
    else:
        call = lambda m, x: KD.decode_detect_cuda(x, shapes, strides, nc)  # noqa: E731
    got = call(maps[0], flats[0])
    ref = KD.decode_detect_torch(flats[0], shapes, strides, nc)
    torch.cuda.synchronize()
    # the bar of tests/test_pallas_kernels.py (TPU kernel vs its XLA twin)
    torch.testing.assert_close(got[..., :4], ref[..., :4], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[..., 4:], ref[..., 4:], rtol=1e-5, atol=1e-6)
    err = float((got - ref).abs().max())
    exact = torch.equal(got, ref)
    ms = time_device([lambda m=m, x=x: call(m, x) for m, x in zip(maps, flats)])
    plain_ms = time_device([lambda x=x: KD.decode_detect_torch(x, shapes, strides, nc)
                            for x in flats])
    cat_ms = time_device([lambda m=m: cat(m) for m in maps])
    call_ms = time_cuda(lambda: call(maps[0], flats[0]), 200)
    nbytes = flats[0].numel() * 4 + got.numel() * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = B * A * K1_OPS_PER_ANCHOR(nc) / F32_FLOPS_PER_S * 1e3
    r = {
        "shape": [B, 64 + nc, A], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "eager_call_ms": call_ms, "concat_ms": cat_ms,
    }
    print(f"[k1] B={B} ({'per-scale maps in place' if in_place else 'concatenated input'}): "
          f"max_abs_err {err:.3g} ({'bit-exact' if exact else 'not bit-exact'} vs twin) | "
          f"kernel {ms:.4f} ms (device, graph replay, {n_buf} input buffers) | bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {nbytes / 1e6:.1f} MB), share "
          f"{r['bound_ms'] / ms:.3f} | twin {plain_ms:.4f} ms | the flatten-concatenation "
          f"{cat_ms:.4f} ms ({'not launched' if in_place else 'launched'} by the serving path) "
          f"| eager call {call_ms:.4f} ms | library_ms: null (no single PyTorch call computes "
          f"this)")
    return r


def _int8_inputs(seed: int, x_shape, w_shape):
    """Seeded int8 input buffers (more than twice the L2 cache in all, so
    that a graph of one launch per buffer reads them cold), int8 weights
    and a realistic epilogue (deq as sx * sw, BatchNorm rows)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    n_buf = -(-L2_COLD_BYTES // math.prod(x_shape))
    xs = [torch.randint(-127, 128, x_shape, generator=g, device="cuda", dtype=torch.int8)
          for _ in range(n_buf)]
    w = torch.randint(-127, 128, w_shape, generator=g, device="cuda", dtype=torch.int8)
    N = w_shape[0]
    fan_in = math.prod(w_shape[1:])
    deq = (8 / 127) / (127 * fan_in**0.5) * (0.5 + torch.rand(N, generator=g, device="cuda"))
    ep = torch.stack([deq, 0.2 * torch.randn(N, generator=g, device="cuda"),
                      0.5 + torch.rand(N, generator=g, device="cuda"),
                      0.2 * torch.randn(N, generator=g, device="cuda")]).contiguous()
    return xs, w, ep


def _int8_bound(x, w, ep, out, macs: int):
    """(bound ms, what bounds it, MB moved) of one int8 conv call: each
    input read once and the output written once at the HBM rate, or 2 x
    macs int8 operations at the tensor cores' rate."""
    nbytes = x.numel() + w.numel() + ep.numel() * 4 + out.numel() * out.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * macs / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes / 1e6


def _check_int8(name: str, B: int, x_shape, w_shape, call, twin, macs: int):
    """One int8 kernel against its twin on the same CUDA tensors, bit for
    bit; device times of both, the eager call's time and the bound. Returns
    (the numbers, the input buffers, the weights)."""
    import torch

    xs, w, ep = _int8_inputs(B, x_shape, w_shape)
    n_buf = len(xs)
    got = call(xs[0], w, ep)
    ref = twin(xs[0], w, ep)
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype or not torch.equal(got, ref):
        raise AssertionError(f"{name} B={B}: kernel differs from its twin")
    err = float((got.float() - ref.float()).abs().max())
    ms = time_device([lambda x=x: call(x, w, ep) for x in xs])
    plain_ms = time_device([lambda x=x: twin(x, w, ep) for x in xs], replays=2)
    call_ms = time_cuda(lambda: call(xs[0], w, ep), 200)
    bound, bound_by, mb = _int8_bound(xs[0], w, ep, got, macs)
    r = {
        "shape": [list(x_shape), list(w_shape)], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None, "eager_call_ms": call_ms,
    }
    print(f"[{name}] B={B} x{list(x_shape)} w{list(w_shape)}: bit-exact vs twin | kernel "
          f"{ms:.4f} ms (device, graph replay, {n_buf} input buffers) | twin {plain_ms:.4f} ms "
          f"| bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {mb:.2f} MB, "
          f"{2 * macs / 1e9:.3f} G int8 ops) | eager call {call_ms:.4f} ms")
    return r, xs, w


# K2's two sites in YOLOv10-S at 640 (20x20 maps, M = 400 B): (K, N)
K2_SITES = {"sppf_cv1": (512, 256), "psa_ffn0": (256, 512)}


def check_k2(B: int, site: str = "sppf_cv1") -> dict:
    """K2 at one of its sites, (B*400, K) x (N, K), bit for bit against the
    twin; device times of the kernel and the twin beside the bound, and of
    torch._int_mm on the same GEMM (int32 out, no epilogue: a yardstick the
    port never calls)."""
    import torch

    from yolov10_3d_torch.kernels import int8 as K8

    (K, N), M, inv = K2_SITES[site], B * 400, 127 / 8
    r, xs, w = _check_int8(f"k2 {site}", B, (M, K), (N, K),
                           lambda x, w, ep: K8.int8_mm_fused_cuda(x, w, ep, inv),
                           lambda x, w, ep: K8.int8_mm_fused_torch(x, w, ep, inv), M * N * K)
    wt = w.t()
    try:
        r["int_mm_ms"] = time_device([lambda x=x: torch._int_mm(x, wt) for x in xs])
        int_mm = f"{r['int_mm_ms']:.4f} ms"
    except RuntimeError as e:  # a yardstick only: its failure is reported, not fatal
        r["int_mm_ms"], int_mm = None, f"not measured ({str(e).splitlines()[0]})"
    tile = ""
    if hasattr(K8, "mm_tiles"):
        t = K8.mm_tiles(M, N, K, torch.cuda.get_device_properties(0).multi_processor_count)
        tile = f"tile {t.bm}x{t.bn}x{t.stages}, grid {t.grid}; "
    print(f"[k2 {site}] B={B}: {tile}share of bound {r['bound_ms'] / r['ms']:.3f}; "
          f"torch._int_mm (GEMM alone, int32 out) {int_mm}; library_ms null: no single "
          f"PyTorch call computes the fused function")
    return r


def k2_sites() -> dict:
    """K2 at both sites at batch 1, 8 and 32: {(site, B): numbers}."""
    return {(site, B): check_k2(B, site) for site in K2_SITES for B in (1, 8, 32)}


def k2_tile_sweep() -> None:
    """Every tile K2 compiles, at both sites and batch 1, 8 and 32, bit for
    bit against the twin: device ms with a grid of one block per tile and,
    where the tiles outnumber the SMs, with the persistent grid of one block
    per SM. Marks the tile mm_tiles picks."""
    import torch

    from yolov10_3d_torch.kernels import int8 as K8

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    inv = 127 / 8
    for site, (K, N) in K2_SITES.items():
        for B in (1, 8, 32):
            M, kt = B * 400, -(-K // K8.BK)
            xs, w, ep = _int8_inputs(B + N, (M, K), (N, K))
            want = K8.int8_mm_fused_torch(xs[0], w, ep, inv)
            tiles = []
            for bm, bn, st in K8.MM_TILES:
                count = -(-M // bm) * -(-N // bn)
                tiles += [K8.MmTiles(bm, bn, st, g, kt) for g in sorted({count, min(count, sms)})]
            pick, parts = K8.mm_tiles(M, N, K, sms), []
            for t in tiles:
                got = K8._mm_launch(xs[0], w, ep, inv, t)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"k2 {site} B={B} tile {t}: differs from the twin")
                ms = time_device([lambda x=x, t=t: K8._mm_launch(x, w, ep, inv, t) for x in xs])
                parts.append(f"{t.bm}x{t.bn}x{t.stages}/{t.grid}{'*' if t == pick else ''} "
                             f"{ms:.4f}")
            print(f"[k2-tiles] {site} B={B} (M={M}, K={K}, N={N}), tile/grid ms (* mm_tiles): "
                  + ", ".join(parts))


def check_k3(B: int) -> dict:
    """K3 at the head's P3 box conv[0] of YOLOv10-S at 640: 80x80, 128 -> 64."""
    from yolov10_3d_torch.kernels.int8 import (
        int8_conv3x3_fused_cuda, int8_conv3x3_fused_torch,
    )

    inv = 127 / 8
    r, _, _ = _check_int8("k3", B, (B, 80, 80, 128), (64, 3, 3, 128),
                          lambda x, w, ep: int8_conv3x3_fused_cuda(x, w, ep, inv),
                          lambda x, w, ep: int8_conv3x3_fused_torch(x, w, ep, inv),
                          B * 6400 * 64 * 9 * 128)
    print(f"[k3] B={B}: library_ms null: PyTorch has no int8 convolution on CUDA"
          f"{k_loop_reads(B * 6400, 64, 9 * 128, r['ms'])}")
    return r


def check_conv_f32(B: int) -> dict:
    """int8_conv_f32 at layer 17 of YOLOv10-S at 640: 3x3 stride 2, 80x80x128 -> 40x40x128."""
    from yolov10_3d_torch.kernels.int8 import int8_conv_f32_cuda, int8_conv_f32_torch

    r, _, _ = _check_int8("int8_conv_f32", B, (B, 80, 80, 128), (128, 3, 3, 128),
                          lambda x, w, ep: int8_conv_f32_cuda(x, w, ep, 2, 1, True),
                          lambda x, w, ep: int8_conv_f32_torch(x, w, ep, 2, 1, True),
                          B * 1600 * 128 * 9 * 128)
    print(f"[int8_conv_f32] B={B}: library_ms null: PyTorch has no int8 convolution on CUDA"
          f"{k_loop_reads(B * 1600, 128, 9 * 128, r['ms'])}")
    return r


def check_k4(B: int) -> dict:
    """K4 on planar (B, 3, 640, 640) float32 images, the training batch's."""
    import torch

    from yolov10_3d_torch.kernels.hsv import hsv_jitter_cuda, hsv_jitter_torch

    H = W = IMGSZ
    g = torch.Generator(device="cuda").manual_seed(B)
    n_buf = -(-L2_COLD_BYTES // (B * 3 * H * W * 4))  # inputs > 2x the L2 cache
    xs = [torch.rand((B, 3, H, W), generator=g, device="cuda") for _ in range(n_buf)]
    hyp = torch.tensor([0.015, 0.7, 0.4], device="cuda")
    gains = 1 + (torch.rand((B, 3), generator=g, device="cuda") * 2 - 1) * hyp
    got = hsv_jitter_cuda(xs[0], gains)
    ref = hsv_jitter_torch(xs[0], gains)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not err <= 1e-6:
        raise AssertionError(f"k4 B={B}: max abs error {err:.3g} against the twin (bar 1e-6)")
    ms = time_device([lambda x=x: hsv_jitter_cuda(x, gains) for x in xs])
    plain_ms = time_device([lambda x=x: hsv_jitter_torch(x, gains) for x in xs], replays=5)
    call_ms = time_cuda(lambda: hsv_jitter_cuda(xs[0], gains), 200)
    nbytes = 2 * xs[0].numel() * 4 + gains.numel() * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = B * H * W * K4_OPS_PER_PIXEL / F32_FLOPS_PER_S * 1e3
    r = {
        "shape": [B, 3, H, W], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "eager_call_ms": call_ms,
    }
    print(f"[k4] B={B} (B, 3, {H}, {W}): max_abs_err {err:.3g} (bar 1e-6) | kernel {ms:.4f} ms "
          f"(device, graph replay, {n_buf} input buffers) | twin {plain_ms:.4f} ms | bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {nbytes / 1e6:.1f} MB) | eager call "
          f"{call_ms:.4f} ms | library_ms: null (no single PyTorch call converts to HSV)")
    return r


def check_stem(B: int, H: int, W: int, C: int = 32, bf16: bool = False) -> dict:
    """The fused stem kernel against its twin on the same CUDA tensors, bit
    for bit (bf16: the twin's float32 result rounded once to bf16); device
    times of the kernel, the twin and cuDNN's conv + SiLU on the same folded
    weights (TF32 off), the bound."""
    import torch
    import torch.nn.functional as F

    from yolov10_3d_torch.kernels.stem import stem_conv_cuda, stem_conv_torch

    torch.backends.cudnn.allow_tf32 = False
    dtype = torch.bfloat16 if bf16 else torch.float32
    g = torch.Generator(device="cuda").manual_seed(B * H + C)
    size = B * 3 * H * W * (2 if bf16 else 4)
    n_buf = -(-L2_COLD_BYTES // size)  # inputs > 2x the L2 cache
    xs = [torch.rand((B, 3, H, W), generator=g, device="cuda").to(dtype) for _ in range(n_buf)]
    w = torch.randn((C, 3, 3, 3), generator=g, device="cuda") / 27**0.5
    b = torch.randn((C,), generator=g, device="cuda") * 0.5
    got = stem_conv_cuda(xs[0], w, b)
    ref = stem_conv_torch(xs[0], w, b)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    if got.shape != ref.shape or got.dtype != ref.dtype or not torch.equal(got, ref):
        raise AssertionError(f"stem B={B} {H}x{W} C={C} {dtype}: kernel differs from its twin "
                             f"(max abs {err:.3g}; bar 0)")
    wl = w.to(dtype)
    bl = b.to(dtype)
    ms = time_device([lambda x=x: stem_conv_cuda(x, w, b) for x in xs])
    plain_ms = time_device([lambda x=x: stem_conv_torch(x, w, b) for x in xs], replays=3)
    lib_ms = time_device([lambda x=x: F.silu(F.conv2d(x, wl, bl, 2, 1)) for x in xs])
    conv_ms = time_device([lambda x=x: F.conv2d(x, wl, bl, 2, 1) for x in xs])
    call_ms = time_cuda(lambda: stem_conv_cuda(xs[0], w, b), 200)
    Ho, Wo = (H + 1) // 2, (W + 1) // 2
    nbytes = xs[0].numel() * xs[0].element_size() + got.numel() * got.element_size() \
        + (w.numel() + b.numel()) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * 27 * C * B * Ho * Wo / F32_FLOPS_PER_S * 1e3  # float32 sums on CUDA cores
    r = {
        "shape": [B, 3, H, W, C, str(dtype).split(".")[-1]], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": lib_ms,
        "library_conv_ms": conv_ms, "eager_call_ms": call_ms,
    }
    print(f"[stem] B={B} {H}x{W} C={C} {str(dtype).split('.')[-1]}: bit-exact vs twin | kernel "
          f"{ms:.4f} ms (device, graph replay, {n_buf} input buffers) | twin {plain_ms:.4f} ms "
          f"| bound {r['bound_ms']:.4f} ms, share {r['bound_ms'] / ms:.3f} "
          f"({r['bound_by']}: {nbytes / 1e6:.2f} MB, "
          f"{2 * 27 * C * B * Ho * Wo / 1e9:.3f} GFLOP) | library (two calls: cuDNN conv2d + "
          f"silu, TF32 off) {lib_ms:.4f} ms, conv2d alone {conv_ms:.4f} ms | eager call "
          f"{call_ms:.4f} ms")
    return r


def check_stem_extremes() -> None:
    """The stem's SiLU over every binade, bit for bit against the twin:
    weights that pass the centre tap of input channel 0 through, so that
    y = silu(x) for x of random sign, exponent (subnormal to 2^127) and
    mantissa; the kernel's fast division path and its __fdiv_rn fallback
    both run."""
    import torch

    from yolov10_3d_torch.kernels.stem import stem_conv_cuda, stem_conv_torch

    g = torch.Generator().manual_seed(1)
    n = 2 * 3 * 256 * 256
    bits = ((torch.randint(0, 2, (n,), generator=g) << 31)
            | (torch.randint(0, 254, (n,), generator=g) << 23)
            | torch.randint(0, 1 << 23, (n,), generator=g))
    x = bits.to(torch.int32).view(torch.float32).reshape(2, 3, 256, 256).cuda()
    w = torch.zeros((32, 3, 3, 3), device="cuda")
    w[:, 0, 1, 1] = 1.0
    b = torch.zeros(32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        got = stem_conv_cuda(x.to(dtype), w, b)
        want = stem_conv_torch(x.to(dtype), w, b)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"stem SiLU over every binade ({dtype}): "
                                 f"{int((got != want).sum())} values differ from the twin")
    print(f"[stem] SiLU over every binade ({n // 3} values through the centre tap, float32 "
          f"and bf16): bit-exact vs twin")


def phase_kernels():
    stem = (check_stem(1, IMGSZ, IMGSZ), check_stem(32, IMGSZ, IMGSZ))
    check_stem(1, *KITTI_HW)  # YOLOv10-S-3D's stem at the KITTI size
    check_stem(32, IMGSZ, IMGSZ, bf16=True)  # the TPU kernel's dtype contract
    check_stem(2, 375, 1241, C=16)  # odd sizes, YOLOv10-N's width
    check_stem(3, 333, 517, C=80)  # odd sizes, YOLOv10-X's width
    check_stem_extremes()
    k2 = k2_sites()
    keys = ("ms", "plain_ms", "bound_ms", "int_mm_ms")
    sites = [{"site": site, "B": B, **{k: r[k] for k in keys}} for (site, B), r in k2.items()]
    return {
        "decode_detect": (check_k1(1), check_k1(32)),
        "int8_mm_fused": ({**k2[("sppf_cv1", 1)], "sites": sites}, k2[("sppf_cv1", 32)]),
        "int8_conv3x3_fused": (check_k3(1), check_k3(32)),
        "int8_conv_f32": (check_conv_f32(1), check_conv_f32(32)),
        "hsv_jitter": (check_k4(1), check_k4(16)),
        "stem_conv": stem,
    }


def int8_plan_shapes(imgsz: int = IMGSZ) -> list:
    """The distinct gated-conv shapes of YOLOv10-S's int8 plan at imgsz x
    imgsz (the fused stem out of it) on its three routes, in forward order:
    (route, H, W, K padded to 4, N, ks, stride, pad, act, count)."""
    from torch import nn

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.nn.quant import Int8Config, plan_int8

    model = YOLOv10("yolov10s.yaml", device="cpu", seed=0).model
    plan = plan_int8(model, (imgsz, imgsz), Int8Config(), stem=True)
    counts = {}
    for conv, route in plan.routes.items():
        c = conv.conv
        h = math.isqrt(plan.hw[conv])
        key = (route, h, h, -(-c.in_channels // 4) * 4, c.out_channels, c.kernel_size[0],
               c.stride[0], c.padding[0], isinstance(conv.act, nn.SiLU))
        counts[key] = counts.get(key, 0) + 1
    return [(*k, n) for k, n in counts.items()]


def k_loop_reads(M: int, N: int, Krow: int, ms: float) -> str:
    """The bytes the wgmma kernel's K loop fetches from L2 for an implicit
    GEMM (M, N, Krow) at its tile, and the rate at ``ms``: every N-tile
    gathers the im2col rows of its M-tile (out-of-image taps read nothing
    but are counted), every M-tile the filters of its N-tile. '' for a
    checkout whose kernels have no tiles (before the wgmma kernels)."""
    import torch

    from yolov10_3d_torch.kernels import int8 as K8

    if not hasattr(K8, "conv_tiles"):
        return ""
    t = K8.conv_tiles(M, N, Krow, torch.cuda.get_device_properties(0).multi_processor_count)
    a, b = M * Krow * -(-N // t.bn) / 1e6, N * Krow * -(-M // t.bm) / 1e6
    return (f" | tile {t.bm}x{t.bn}x{t.stages}, K loop reads {a:.1f} MB im2col + {b:.1f} MB "
            f"weights from L2, {(a + b) / ms / 1e3:.2f} TB/s")


def _sweep_one(route, B, H, W, K, N, ks, stride, pad, act) -> dict:
    """One int8 conv shape: the kernel bit for bit against its twin on the
    same CUDA tensors, its device time over inputs larger than the L2 cache
    in all, and its bound."""
    import torch

    from yolov10_3d_torch.kernels import int8 as K8

    inv = 127 / 8
    if route == "int8_mm_fused":  # a 1x1 stride-1 conv as (B H W, K) x (N, K)
        xs, w, ep = _int8_inputs(B * H + N, (B * H * W, K), (N, K))
        call = lambda x: K8.int8_mm_fused_cuda(x, w, ep, inv)  # noqa: E731
        twin = lambda x: K8.int8_mm_fused_torch(x, w, ep, inv)  # noqa: E731
    else:
        xs, w, ep = _int8_inputs(B * H + N, (B, H, W, K), (N, ks, ks, K))
        if route == "int8_conv3x3_fused":
            call = lambda x: K8.int8_conv3x3_fused_cuda(x, w, ep, inv)  # noqa: E731
            twin = lambda x: K8.int8_conv3x3_fused_torch(x, w, ep, inv)  # noqa: E731
        else:
            call = lambda x: K8.int8_conv_f32_cuda(x, w, ep, stride, pad, act)  # noqa: E731
            twin = lambda x: K8.int8_conv_f32_torch(x, w, ep, stride, pad, act)  # noqa: E731
    got, ref = call(xs[0]), twin(xs[0])
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype or not torch.equal(got, ref):
        raise AssertionError(f"{route} B={B} {H}x{W} {K}->{N} k{ks} s{stride}: kernel "
                             "differs from its twin")
    ms = time_device([lambda x=x: call(x) for x in xs])
    Ho, Wo = (H + 2 * pad - ks) // stride + 1, (W + 2 * pad - ks) // stride + 1
    M, Krow = B * Ho * Wo, ks * ks * K
    bound, bound_by, _ = _int8_bound(xs[0], w, ep, got, M * N * Krow)
    l2 = "" if route == "int8_mm_fused" else k_loop_reads(M, N, Krow, ms)
    return {"ms": ms, "bound_ms": bound, "bound_by": bound_by, "l2": l2}


def phase_int8_layers(card: str) -> dict:
    """Every distinct K2 / K3 / int8_conv_f32 shape of YOLOv10-S's int8 plan
    at 640, at batch 1 and 8; returns the per-forward sums by batch (ms,
    bound ms and the launches summed over)."""
    import torch
    import torch.nn.functional as F

    shapes = int8_plan_shapes()
    n_convs = sum(s[-1] for s in shapes)
    print(f"[int8-layers] YOLOv10-S int8 plan at {IMGSZ}x{IMGSZ}: {len(shapes)} distinct "
          f"shapes, {n_convs} launches a forward on K2, K3 and int8_conv_f32 ({card})")
    sums = {}
    for B in (1, 8):
        total = bound = 0.0
        for route, H, W, K, N, ks, stride, pad, act, count in shapes:
            r = _sweep_one(route, B, H, W, K, N, ks, stride, pad, act)
            total += count * r["ms"]
            bound += count * r["bound_ms"]
            name = {"int8_mm_fused": "k2", "int8_conv3x3_fused": "k3"}.get(route, route)
            print(f"[int8-layers] B={B} {name} {H}x{W} {K}->{N} k{ks} s{stride} p{pad} "
                  f"act={int(act)} x{count}: bit-exact vs twin | kernel {r['ms']:.4f} ms | bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}) | share of bound "
                  f"{r['bound_ms'] / r['ms']:.3f}{r['l2']}")
        sums[B] = {"ms": total, "bound_ms": bound, "launches": n_convs}
        print(f"[int8-layers] B={B} sum over the {n_convs} launches of a forward: "
              f"{total:.4f} ms (bound {bound:.4f} ms, share {bound / total:.3f})")

    # yardsticks, never called by the port; library_ms stays null for both
    g = torch.Generator(device="cuda").manual_seed(5)
    a = torch.randint(-127, 128, (8 * 400, 1024), generator=g, device="cuda", dtype=torch.int8)
    b = torch.randint(-127, 128, (512, 1024), generator=g, device="cuda", dtype=torch.int8).t()
    try:
        mm = f"{time_device([lambda: torch._int_mm(a, b)]):.4f} ms"
    except RuntimeError as e:  # a yardstick only: its failure is reported, not fatal
        mm = f"not measured ({str(e).splitlines()[0]})"
    x = torch.randn((8, 128, 80, 80), generator=g, device="cuda").half()
    x = x.contiguous(memory_format=torch.channels_last)
    wf = torch.randn((128, 128, 3, 3), generator=g, device="cuda").half()
    wf = wf.contiguous(memory_format=torch.channels_last)
    conv = time_device([lambda: F.conv2d(x, wf, None, 2, 1)])
    print(f"[int8-layers] yardsticks at B=8 (reference only, not called by the port): "
          f"torch._int_mm (3200, 1024) x (1024, 512), the GEMM of a 20x20 1x1 conv 1024->512 "
          f"alone, int32 out: {mm}; cuDNN fp16 channels-last conv2d, layer 17 (3x3 s2, "
          f"80x80x128 -> 40x40x128), no epilogue: {conv:.4f} ms")
    return sums


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


@contextlib.contextmanager
def twins_on_card():
    """Inside: the int8 kernels' and the stem kernel's wrappers run their
    plain twins on CUDA tensors (a reference run of the same forward with
    the same float ops)."""
    from yolov10_3d_torch.kernels import int8 as K8
    from yolov10_3d_torch.kernels import stem as KS

    swaps = [(K8, n) for n in ("int8_mm_fused", "int8_conv3x3_fused", "int8_conv_f32")]
    swaps.append((KS, "stem_conv"))
    saved = {(mod, n): getattr(mod, f"{n}_cuda") for mod, n in swaps}
    try:
        for mod, n in swaps:
            setattr(mod, f"{n}_cuda", getattr(mod, f"{n}_torch"))
        yield
    finally:
        for (mod, n), fn in saved.items():
            setattr(mod, f"{n}_cuda", fn)


@contextlib.contextmanager
def eager_forward():
    """Inside: every Predictor runs its forward eagerly (``forward_eager``,
    the function its graphs capture) and captures nothing: the reference
    the replayed forward is held to, and the only way the twins of
    ``twins_on_card`` can reach a served request. A package without
    captured forwards (an older checkout under ``--package-root``) is
    eager already."""
    from yolov10_3d_torch.engine.predictor import Predictor

    if not hasattr(Predictor, "forward_eager"):
        yield
        return
    saved = Predictor._forward
    Predictor._forward = lambda self, x, max_det: self.forward_eager(x, max_det).cpu().numpy()
    try:
        yield
    finally:
        Predictor._forward = saved


def int8_layers_vs_cpu(gpu8, cpu8, x) -> dict:
    """Every gated conv of one GPU int8 forward of ``x`` against the CPU int8
    path given the same input (the GPU's). Codes: at most a fraction 1e-4
    differ (at least one), by one; float outputs: atol 1e-5 and rtol 1e-5,
    the bars of tests/test_torch_int8.py."""
    import torch

    from yolov10_3d_torch.nn.quant import Int8Config, plan_int8

    cfg = Int8Config()
    pg = plan_int8(gpu8.model, tuple(x.shape[-2:]), cfg)
    pc = plan_int8(cpu8.model, tuple(x.shape[-2:]), cfg)
    seen = {}
    hooks = [c.register_forward_hook(lambda m, i, o: seen.__setitem__(m, (i[0], o)))
             for c in pg.routes]
    try:
        with torch.inference_mode():
            gpu8.model(x, fast_eval=True, int8=cfg)
    finally:
        for h in hooks:
            h.remove()
    flips = codes = 0
    worst = 0.0
    with torch.inference_mode():
        for conv, route in pg.routes.items():
            name = pg.names[conv]
            xin, out = seen[conv]
            ref = pc.run(cpu8.model.get_submodule(name), xin.cpu(), route)
            out = out.cpu()
            if out.dtype == torch.int8:
                d = (out.int() - ref.int()).abs()
                n = int((d > 0).sum())
                if int(d.max()) > 1 or n > max(1, 1e-4 * d.numel()):
                    raise AssertionError(f"{name}: {n} of {d.numel()} codes differ from the CPU")
                flips, codes = flips + n, codes + d.numel()
            else:
                err = float(((out - ref).abs() - 1e-5 * ref.abs()).max())
                if err > 1e-5:
                    raise AssertionError(f"{name}: float output off the CPU's by {err:.3g}")
                worst = max(worst, float((out - ref).abs().max()))
    return {"convs": len(pg.routes), "codes": codes, "flipped": flips, "max_float_err": worst}


def int8_drift(gpu8, cpu8, x) -> dict:
    """Free-running int8 forwards of ``x`` on the GPU and on the CPU: where
    their fused sites' codes first differ, how many differ at the last
    fused site, and the gap of the one2one maps (and, for scale, the gap
    between the GPU's int8 and float32 maps)."""
    import torch

    from yolov10_3d_torch.nn.quant import Int8Config, plan_int8

    cfg = Int8Config()
    outs = {}

    def run(m, xin, side):
        plan = plan_int8(m.model, tuple(xin.shape[-2:]), cfg)
        fused = [c for c, r in plan.routes.items() if r != "int8_conv_f32"]
        hooks = [c.register_forward_hook(
            lambda mod, i, o, n=plan.names[c]: outs.__setitem__((side, n), o.cpu()))
            for c in fused]
        try:
            with torch.inference_mode():
                return m.model(xin, fast_eval=True, int8=cfg)["one2one"], [plan.names[c]
                                                                           for c in fused]
        finally:
            for h in hooks:
                h.remove()

    g8, names = run(gpu8, x, "gpu")
    c8, _ = run(cpu8, x.cpu(), "cpu")
    with torch.inference_mode():
        g32 = gpu8.model(x, fast_eval=True)["one2one"]
    diffs = [(n, int((outs["gpu", n] != outs["cpu", n]).sum()), outs["cpu", n].numel())
             for n in names]
    first = next((f"{n} ({k} of {t})" for n, k, t in diffs if k), "no fused site")
    n, k, t = diffs[-1]
    gap = lambda a, b: max(float((p.cpu() - q.cpu()).abs().max()) for p, q in zip(a, b))  # noqa: E731
    return {"first": first, "head": f"{k} of {t} differ at {n}", "maps": gap(g8, c8),
            "effect": gap(g8, g32)}


def request_kernels(model=None) -> dict:
    """The device operations of one float32 b1_640 request (torch.profiler),
    eager and replayed from its graph; of the eager one the concatenation
    kernels, the top-k's sort and select kernels, and the
    flatten-concatenations of the head maps (``torch.cat`` of 3-D (B, 4*16 +
    nc, H*W) maps, which the decode took before K1 read the maps in place),
    counted by a spy on ``torch.cat``. ``model``: a YOLOv10-S on the card
    (default: seeded random weights)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.utils.parity import smooth_images

    model = model or YOLOv10("yolov10s.yaml", device="cuda", seed=0)
    img = smooth_images(np.random.default_rng(0), [(640, 640)])
    for _ in range(2):  # the capture, then a replay
        model.predict(img, imgsz=IMGSZ, conf=CONF)
    with eager_forward():
        model.predict(img, imgsz=IMGSZ, conf=CONF)
    torch.cuda.synchronize()
    no = 64 + model.spec.nc
    flat_cats, real_cat = [], torch.cat

    def spy(tensors, *args, **kwargs):
        if all(t.dim() == 3 and t.shape[1] == no for t in tensors):
            flat_cats.append(len(tensors))
        return real_cat(tensors, *args, **kwargs)

    def device_ops(eager: bool):
        """(device operations by name, device busy ms, host ms) of one traced request."""
        torch.cat = spy
        try:
            with eager_forward() if eager else contextlib.nullcontext():
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    model.predict(img, imgsz=IMGSZ, conf=CONF)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cat = real_cat
        ops, busy = {}, 0.0
        for e in prof.key_averages():
            if e.device_type.name == "CUDA":
                ops[e.key] = ops.get(e.key, 0) + e.count
                busy += (getattr(e, "self_device_time_total", 0)
                         or getattr(e, "self_cuda_time_total", 0)) / 1e3
        return ops, busy, wall

    ops, busy, wall = device_ops(eager=True)
    flat = len(flat_cats)
    replay_ops, rbusy, rwall = device_ops(eager=False)
    count = lambda *frags: sum(n for k, n in ops.items()  # noqa: E731
                               if any(f in k.lower() for f in frags))
    r = {"device_ops": sum(ops.values()), "concat_kernels": count("cat"),
         "topk_kernels": count("sort", "radix", "topk", "select"),
         "flatten_concats": flat, "replay_device_ops": sum(replay_ops.values())}
    idle = lambda b, w: f"{max(0.0, 1 - b / w):.3f}" if b else "not measured"  # noqa: E731
    print(f"[serve] one b1_640 float32 request, eager: {r['device_ops']} device operations "
          f"(torch.profiler: kernels and copies), {r['concat_kernels']} of them concatenation "
          f"kernels, {r['topk_kernels']} sort or select kernels (the top-k); "
          f"flatten-concatenations of the head maps before the decode: {r['flatten_concats']}; "
          f"device busy {busy:.3f} of {wall:.3f} traced ms, idle share {idle(busy, wall)} | "
          f"replayed from its graph: {r['replay_device_ops']} device operations, device busy "
          f"{rbusy:.3f} of {rwall:.3f} traced ms, idle share {idle(rbusy, rwall)}")
    return r


def topk_yardstick() -> None:
    """Device ms of the port's top-k (ops/topk.py, ties to the lowest index)
    beside torch.topk on the same tensors, at v10_postprocess's two
    selections at 640x640 (300 of 8400 anchors, then 300 of 300 x 80
    pairs), B=1 and 8, scores rounded to 0.01 so that ties occur. A printed
    yardstick: the port never calls torch.topk."""
    import torch

    from yolov10_3d_torch.ops.topk import topk_lowest_index

    for B in (1, 8):
        g = torch.Generator(device="cuda").manual_seed(B)
        parts = []
        for n in (8400, 300 * 80):
            s = torch.round(torch.rand((B, n), generator=g, device="cuda"), decimals=2)
            try:
                sel = time_device([lambda: topk_lowest_index(s, 300)], replays=50)
                ref = time_device([lambda: torch.topk(s, 300, dim=1)], replays=50)
                parts.append(f"({B}, {n}) k=300: topk_lowest_index {sel:.4f} ms, torch.topk "
                             f"{ref:.4f} ms")
            except RuntimeError as e:  # a yardstick only: its failure is reported, not fatal
                parts.append(f"({B}, {n}): not measured ({str(e).splitlines()[0]})")
        print("[serve] top-k, device ms: " + "; ".join(parts))


def replay_device_ms(cap, replays: int = 20) -> float:
    """Device ms of one replay of a captured forward (CUDA events around
    ``replays`` back-to-back replays on its static input)."""
    import torch

    cap.graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        cap.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / replays


def serve_graph(card: str, requests, imgsz, reps: int = 5) -> dict:
    """[serve-graph] for ``requests`` (name, facade, images, batch, predict
    kwargs): each chunk's replayed forward against ``forward_eager`` on the
    same model input (``torch.equal``, fatal on any difference, which is
    located by output column); the median host ms per request over ``reps``
    calls captured and eager, in turns; the device ms of one replay; each
    key's capture time, reserved memory and launches per replay. Returns
    name -> {captured, eager: the host ms of each call; device_ms}."""
    import numpy as np
    import torch

    from yolov10_3d_torch.cfg import get_cfg

    out = {}
    for name, facade, ims, b, kw in requests:
        facade.predict(ims, imgsz=imgsz, batch=b, conf=CONF, **kw)  # a key not served yet: captured
        pred = facade.predictor(get_cfg(kw))
        _, max_det, sz = pred._resolve(CONF, kw.get("max_det"), imgsz)
        caps, diffs = [], []
        for i in range(0, len(ims), b):
            x, _ = pred.preprocess(ims[i:i + b], sz)
            cap = pred.graphs[pred.graph_key(x, max_det)]
            replayed = torch.from_numpy(cap.replay(x))
            eager = pred.forward_eager(x, max_det).cpu()
            if not torch.equal(replayed, eager):
                cols = (replayed - eager).abs().amax((0, 1))
                diffs.append(f"chunk {i // b}: columns {torch.nonzero(cols).flatten().tolist()} "
                             f"differ by up to {float(cols.max()):.3g}")
            caps.append(cap)
        times = {"captured": [], "eager": []}
        for _ in range(reps):
            for way in times:
                with eager_forward() if way == "eager" else contextlib.nullcontext():
                    t0 = time.perf_counter()
                    facade.predict(ims, imgsz=imgsz, batch=b, conf=CONF, **kw)
                    times[way].append((time.perf_counter() - t0) * 1e3)
        dev = replay_device_ms(caps[0])
        cap = caps[0]
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"[serve-graph] {name}: replayed vs eager forward: "
              f"{'bit for bit (torch.equal)' if not diffs else 'DIFFER: ' + '; '.join(diffs)} | "
              f"host ms/request captured {med['captured']:.2f} (reps "
              f"{', '.join(f'{t:.2f}' for t in times['captured'])}), eager {med['eager']:.2f} "
              f"(reps {', '.join(f'{t:.2f}' for t in times['eager'])}) | device ms of one replay "
              f"{dev:.4f} | key {tuple(cap.x.shape)}: capture {cap.capture_s * 1e3:.1f} ms, "
              f"reserved {cap.reserved / 2**20:.1f} MiB, launches per replay "
              f"{ {k: n for k, n in cap.launches.items() if n} } ({card})")
        if diffs:
            raise AssertionError(f"{name}: the replayed forward differs from the eager one: "
                                 + "; ".join(diffs))
        out[name] = {**times, "device_ms": dev}
    return out


def phase_serving(card: str):
    import numpy as np
    import torch

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.data.preprocess import preprocess_batch
    from yolov10_3d_torch.kernels import launch_counts, reset_launch_counts
    from yolov10_3d_torch.nn.quant import Int8Config, plan_int8
    from yolov10_3d_torch.ops.preprocess import serve_preprocess
    from yolov10_3d_torch.utils.parity import calibrate, compare_results, smooth_images

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[serve] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    rng = np.random.default_rng(0)
    shapes = {
        "b1_640": [(640, 640)],  # device letterbox, no resize
        "uniform_b8": [(720, 1280)] * 8,  # device letterbox, antialiased downscale
        "mixed": [(480, 640), (640, 427), (360, 640), (512, 512)],  # host letterbox
    }
    images = {n: smooth_images(rng, shp) for n, shp in shapes.items()}
    requests = [  # (name, images, batch, int8); int8 serves the same images
        ("b1_640", images["b1_640"], 1, False),
        ("uniform_b8", images["uniform_b8"], 8, False),
        ("mixed", images["mixed"], 4, False),
        ("b1_640_int8", images["b1_640"], 1, True),
        ("uniform_b8_int8", images["uniform_b8"], 8, True),
    ]

    cal, _ = preprocess_batch([im for ims in images.values() for im in ims], IMGSZ)
    cal = torch.from_numpy(cal).permute(0, 3, 1, 2).contiguous().cuda()
    gpu = YOLOv10("yolov10s.yaml", device="cuda", seed=0)
    calibrate(gpu.model, cal)
    # the same weights; head scales fitted to the int8 outputs, which the
    # static scale 8/127 moves far from the float32 ones on a random net. The
    # int8 class logits have a long tail, so the batch maximum is pinned
    # higher (6): the served top-k scores then spread enough that most of them
    # clear the selection boundaries by the 1e-2 bar.
    gpu8 = YOLOv10("yolov10s.yaml", device="cuda", seed=0)
    calibrate(gpu8.model, cal, cls_max=6.0, int8=Int8Config())
    models = {False: gpu, True: gpu8}
    n_params = sum(p.numel() for p in gpu.model.parameters())
    print(f"[serve] YOLOv10-S nc={gpu.spec.nc} params={n_params} strides={gpu.spec.strides}")
    # spd_serving (the default) takes the stem out of the int8 plan
    plan = plan_int8(gpu8.model, (IMGSZ, IMGSZ), Int8Config(), stem=True).counts()
    print(f"[serve] int8 plan at {IMGSZ}x{IMGSZ} with the fused stem, launches per forward: "
          f"{plan}")
    if plan != {"int8_mm_fused": 2, "int8_conv3x3_fused": 11, "int8_conv_f32": 30}:
        raise AssertionError(f"int8 plan {plan}, expected 2 / 11 / 30")

    def expected(ims, b, int8, spd=True):
        batches = -(-len(ims) // b)
        want = {k: 0 for k in launch_counts}
        want["decode_detect"] = batches
        want["stem_conv"] = batches if spd else 0
        if int8:
            want.update({k: n * batches for k, n in plan.items()})
        return want

    for _, ims, b, int8 in requests:  # warm-up: cuDNN handles, allocator, int8 weights
        models[int8].predict(ims, imgsz=IMGSZ, batch=b, conf=CONF, int8=int8)
    torch.cuda.synchronize()

    reps = 5
    reset_launch_counts()
    gpu_res, times = {}, {}
    for name, ims, b, int8 in requests:
        times[name] = []
        want = expected(ims, b, int8)
        for _ in range(reps):
            before = dict(launch_counts)
            t0 = time.perf_counter()
            res = models[int8].predict(ims, imgsz=IMGSZ, batch=b, conf=CONF, int8=int8)
            times[name].append((time.perf_counter() - t0) * 1e3)  # host arrays: synced
            got = {k: launch_counts[k] - before[k] for k in launch_counts}
            if got != want:
                raise AssertionError(f"request {name}: launches {got}, expected {want}")
            _check_results(res, [im.shape[:2] for im in ims])
        gpu_res[name] = res
    launches = dict(launch_counts)
    for k in SERVING_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} never launched on the serving path")
    serve_graph(card, [(name, models[int8], ims, b, {"int8": True} if int8 else {})
                       for name, ims, b, int8 in requests], IMGSZ)

    # the float32 requests again with the unfused stem (cuDNN conv, BN, SiLU)
    for name, ims, b, int8 in requests:
        if int8:
            continue
        before = dict(launch_counts)
        plain = gpu.predict(ims, imgsz=IMGSZ, batch=b, conf=CONF, spd_serving=False)
        got = {k: launch_counts[k] - before[k] for k in launch_counts}
        if got != expected(ims, b, False, spd=False):
            raise AssertionError(f"request {name} with spd_serving=False: launches {got}")
        stats = compare_results(plain, gpu_res[name], conf=CONF, score_tol=SCORE_TOL,
                                box_tol=BOX_TOL)
        if stats["n_compared"] < 0.5 * (stats["n_ref"] + stats["n_got"]):
            raise AssertionError(f"request {name}: too few separated detections {stats}")
        print(f"[serve] {name}: spd_serving=True (fused stem) vs False (unfused stem) on the "
              f"GPU: {stats['n_compared']} compared, max score err {stats['max_score_err']:.3g} "
              f"(bar {SCORE_TOL}), max box err {stats['max_box_err']:.3g} px (bar {BOX_TOL})")

    u8 = torch.from_numpy(np.stack(images["uniform_b8"]))
    gap = (serve_preprocess(u8.cuda(), (IMGSZ, IMGSZ)).cpu()
           - serve_preprocess(u8, (IMGSZ, IMGSZ))).abs().max()
    print(f"[serve] device letterbox of uniform_b8, GPU vs CPU: max abs diff "
          f"{float(gap):.3g} on [0, 1] pixels")

    cpu = YOLOv10("yolov10s.yaml", device="cpu", seed=0)
    cpu.model.load_state_dict(gpu.model.state_dict())
    cpu8 = YOLOv10("yolov10s.yaml", device="cpu", seed=0)
    cpu8.model.load_state_dict(gpu8.model.state_dict())
    for name, ims, b, int8 in requests:
        t0 = time.perf_counter()
        if int8:  # see int8_layers_vs_cpu below for the CPU reference
            before = dict(launch_counts)
            with twins_on_card(), eager_forward():
                ref = gpu8.predict(ims, imgsz=IMGSZ, batch=b, conf=CONF, int8=True)
            if any(launch_counts[k] != before[k] for k in KERNELS if k != "decode_detect"):
                raise AssertionError(f"request {name}: the twins' reference launched a kernel")
            score_tol, box_tol, against = SCORE_TOL_INT8, BOX_TOL_INT8, "twins on the card"
        else:
            ref = cpu.predict(ims, imgsz=IMGSZ, batch=b, conf=CONF)
            score_tol, box_tol, against = SCORE_TOL, BOX_TOL, "CPU"
        ref_s = time.perf_counter() - t0
        stats = compare_results(ref, gpu_res[name], conf=CONF, score_tol=score_tol,
                                box_tol=box_tol)
        if stats["n_compared"] < 0.5 * (stats["n_ref"] + stats["n_got"]):
            raise AssertionError(f"request {name}: too few separated detections {stats}")
        ms = statistics.median(times[name])
        print(f"[serve] {name}: {len(ims)} img, {stats['n_ref']} dets | GPU median "
              f"{ms:.2f} ms/request, {len(ims) / ms * 1e3:.1f} img/s ({card}, {reps} reps) "
              f"| vs {against}: {stats['n_compared']} compared, max score err "
              f"{stats['max_score_err']:.3g} (bar {score_tol}), max box err "
              f"{stats['max_box_err']:.3g} px (bar {box_tol}); reference took {ref_s:.1f} s")

    # The CPU int8 run, layer by layer: a float op one ulp off between card and
    # CPU (cuDNN's sums, exp) moves a value across a rounding boundary of the
    # next quantizer now and then, and the flipped codes multiply through the
    # 44 quantizers of a random net; so each gated conv is held to the CPU's
    # given the GPU's own input, and the free-running gap is printed.
    for name in ("b1_640", "uniform_b8"):
        u8 = torch.from_numpy(np.stack(images[name])).cuda()
        x = serve_preprocess(u8, (IMGSZ, IMGSZ))
        r = int8_layers_vs_cpu(gpu8, cpu8, x)
        print(f"[serve] {name}_int8 vs the CPU int8 path, conv by conv on the GPU's inputs: "
              f"{r['convs']} gated convs, {r['flipped']} of {r['codes']} int8 codes differ "
              f"(bar: 1e-4 of each conv's, by one), float outputs max abs err "
              f"{r['max_float_err']:.3g} (bar 1e-5 + 1e-5 |y|)")
    x = serve_preprocess(torch.from_numpy(images["b1_640"][0][None]).cuda(), (IMGSZ, IMGSZ))
    d = int8_drift(gpu8, cpu8, x)
    print(f"[serve] b1_640 int8, free-running on GPU and CPU: codes first differ at "
          f"{d['first']}; {d['head']}; one2one maps max abs diff {d['maps']:.3g}, against "
          f"{d['effect']:.3g} between GPU int8 and GPU float32 (the quantization's effect)")
    print(f"[serve] main-path launches: {launches}")
    if request_kernels(gpu)["flatten_concats"] != 0:
        raise AssertionError("the 2D decode concatenated the head maps before K1")
    topk_yardstick()
    return launches, {name: statistics.median(t) for name, t in times.items()}


def _check_results3d(results, shapes, max_det: int):
    """Finite 3D rows of the Boxes3D layout, one per 2D detection."""
    import numpy as np

    _check_results(results, shapes)
    for r in results:
        d = np.asarray(r.boxes3d.data)
        if d.shape != (len(r.boxes), 16) or len(d) > max_det or not np.isfinite(d).all():
            raise AssertionError(f"bad 3D rows {d.shape} for {len(r.boxes)} detections")
        if not np.array_equal(d[:, :6], r.boxes.data):
            raise AssertionError("boxes3d's 2D columns differ from boxes")


def sparse_vs_dense_on_card(model, x, nc: int) -> dict:
    """The 3D head's sparse forward against its dense one on the card:
    equal class maps, zeros off the candidates, 1e-4 + 1e-4 |y| at them,
    and the same detections at max_det SPARSE_K."""
    import torch

    from yolov10_3d_torch.nn.heads3d import SPARSE_K
    from yolov10_3d_torch.ops.postprocess import decode_detect3d, v10_3d_postprocess

    strides = model.spec.strides
    with torch.inference_mode():
        dense = model(x, fast_eval=True, stem=True)["one2one"]
        sparse = model(x, fast_eval=True, stem=True, sparse=True)["one2one"]
        fills, worst = [], 0.0
        for d, s in zip(dense, sparse):
            if not torch.equal(d[:, :nc], s[:, :nc]):
                raise AssertionError("sparse head: class maps differ from dense")
            cand = (s[:, nc:].abs().sum(1) > 0)[:, None].expand_as(s[:, nc:])
            if bool((s[:, nc:][~cand] != 0).any()):
                raise AssertionError("sparse head: non-zero regression off the candidates")
            err = ((s[:, nc:] - d[:, nc:]).abs() - 1e-4 * d[:, nc:].abs())[cand]
            if float(err.max()) > 1e-4:
                raise AssertionError(f"sparse head off dense at the candidates by {float(err.max())}")
            worst = max(worst, float((s[:, nc:] - d[:, nc:]).abs()[cand].max()))
            fills.append(round(float(cand[:, 0].float().mean()), 4))
        pd = v10_3d_postprocess(decode_detect3d(dense, strides[: len(dense)], nc), SPARSE_K, nc)
        ps = v10_3d_postprocess(decode_detect3d(sparse, strides[: len(sparse)], nc), SPARSE_K, nc)
    if not (torch.equal(pd[2], ps[2]) and torch.equal(pd[1], ps[1])):
        raise AssertionError("sparse head: top-k labels or scores differ from dense")
    reg_err = float((pd[0] - ps[0]).abs().max())
    if reg_err > 1e-3:
        raise AssertionError(f"sparse head: detections' regression off dense by {reg_err:.3g}")
    return {"fills": fills, "maps": worst, "detections": reg_err}


def branch_gaps_3d(maps, ref, nc: int) -> dict:
    """Max abs distance of 3D one2one head maps from ``ref`` per branch (over
    the batch and the scales): the score after the sigmoid, then each
    regression branch of OUTPUT_CHANNELS."""
    from yolov10_3d_torch.nn.heads3d import OUTPUT_CHANNELS

    gap = lambda a, b: max(float((p.cpu().double() - q).abs().max())  # noqa: E731
                           for p, q in zip(a, b))
    gaps = {"score": gap([p[:, :nc].sigmoid() for p in maps], [q[:, :nc].sigmoid() for q in ref])}
    c0 = nc
    for name, n in list(OUTPUT_CHANNELS.items())[1:]:
        gaps[name] = gap([p[:, c0:c0 + n] for p in maps], [q[:, c0:c0 + n] for q in ref])
        c0 += n
    return gaps


def float32_gap_3d(cpu, x) -> dict:
    """How far the CPU's float32 head maps of ``x`` lie from a float64 run of
    the same weights, per 3D branch (max abs over the batch): the float
    noise floor of a GPU-vs-CPU comparison on this random net."""
    import torch

    m64 = copy.deepcopy(cpu.model).double()
    with torch.inference_mode():
        a = cpu.model(x, fast_eval=True)["one2one"]
        b = m64(x.double(), fast_eval=True)["one2one"]
    return branch_gaps_3d(a, b, cpu.spec.nc)


def std05_net(x):
    """A second YOLOv10-S-3D on the card, calibrated on ``x`` to the 2D
    requests' BatchNorm std 0.5."""
    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.utils.parity import calibrate

    gpu = YOLOv10("yolov10s_3D.yaml", device="cuda", seed=0)
    calibrate(gpu.model, x, bn_std=0.5)
    return gpu


def std05_vs_float64(gpu, frames, x, imgsz) -> dict:
    """``kitti_b8`` on ``std05_net``, where float32 rounding grows to the
    size of the absolute bars: served once on the card (one stem launch,
    finite 3D rows); then the card's dense one2one maps, with the unfused
    stem and with the fused one (the served route, BatchNorm folded), each
    held to a float64 CPU run of the same weights and input, per branch
    within twice the distance of the CPU's float32 run of the same route."""
    import torch

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.kernels import launch_counts

    before = dict(launch_counts)
    res = gpu.predict(frames, imgsz=imgsz, batch=8, conf=CONF, max_det=50)
    got = {k: launch_counts[k] - before[k] for k in launch_counts}
    if got != {k: int(k == "stem_conv") for k in launch_counts}:
        raise AssertionError(f"kitti_b8 at BatchNorm std 0.5: launches {got}")
    _check_results3d(res, [im.shape[:2] for im in frames], 50)
    cpu = YOLOv10("yolov10s_3D.yaml", device="cpu", seed=0)
    cpu.model.load_state_dict(gpu.model.state_dict())
    t0 = time.perf_counter()
    xc = x.cpu()
    with torch.inference_mode():
        ref = copy.deepcopy(cpu.model).double()(xc.double(), fast_eval=True)["one2one"]
        gaps = {}
        for stem in (False, True):
            card = gpu.model(x, fast_eval=True, stem=stem)["one2one"]
            own = cpu.model(xc, fast_eval=True, stem=stem)["one2one"]
            gaps[stem] = (branch_gaps_3d(card, ref, gpu.spec.nc),
                          branch_gaps_3d(own, ref, gpu.spec.nc))
    over = []
    for stem, (g, c) in gaps.items():
        route = "fused stem" if stem else "unfused stem"
        print(f"[serve3d] kitti_b8 at BatchNorm std 0.5, {route}: dense one2one maps vs a "
              f"float64 CPU run of the same weights (max abs; bar: 2x the CPU float32 run's): "
              + ", ".join(f"{k} GPU {g[k]:.3g} / CPU {c[k]:.3g}" for k in c))
        over += [f"{k} ({route})" for k in c if not g[k] <= 2 * c[k]]
    print(f"[serve3d] std 0.5 references took {time.perf_counter() - t0:.1f} s")
    if over:
        raise AssertionError(f"kitti_b8 at BatchNorm std 0.5: the GPU is further from float64 "
                             f"than twice the CPU's float32 run in {over}")
    return gaps


def traced_request(call) -> str:
    """``profile_report`` of one ``call`` (a served request, synchronised)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return profile_report(prof, wall, 1).replace("/step", "")


def route_10b(card: str, graph: dict) -> bool:
    """The 3D route on the card (ROADMAP 10b), from the captured requests of
    [serve-graph]: is the dense head faster than the sparse one beyond the
    runs' spread (its slowest call faster than sparse's fastest) at both
    B=1 and B=8? Prints both routes' host ms and one replay's device ms."""
    faster = {}
    for B in (1, 8):
        sp, de = graph[f"kitti_b{B}"], graph[f"kitti_b{B}_dense"]
        faster[B] = max(de["captured"]) < min(sp["captured"])
        print(f"[serve-graph] 10b, B={B}: sparse host ms {min(sp['captured']):.2f}-"
              f"{max(sp['captured']):.2f} (device {sp['device_ms']:.4f}), dense "
              f"{min(de['captured']):.2f}-{max(de['captured']):.2f} (device "
              f"{de['device_ms']:.4f}), both captured: dense "
              f"{'faster' if faster[B] else 'not faster'} beyond the spread ({card})")
    verdict = all(faster.values())
    print(f"[serve-graph] 10b: {'serve dense' if verdict else 'keep the sparse route'} while "
          f"max_det <= 50 on the card")
    return verdict


def phase_serve3d(card: str):
    """YOLOv10-S-3D at 384x1280: KITTI-sized requests on the card, held to a
    CPU run of the same weights; the sparse head held to the dense one."""
    import numpy as np
    import torch

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.kernels import launch_counts, reset_launch_counts
    from yolov10_3d_torch.ops.preprocess import serve_preprocess
    from yolov10_3d_torch.utils.parity import calibrate, compare_results, smooth_images

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    frames = smooth_images(np.random.default_rng(3), [(375, 1242)] * 8)
    imgsz = [KITTI_HW[1], KITTI_HW[0]]  # predict's [w, h]
    requests = [("kitti_b1", frames[:1], 1, 50), ("kitti_b8", frames, 8, 50),
                ("kitti_b1_dense", frames[:1], 1, 100)]
    cols = {"center3d": (slice(6, 8), BOX_TOL), "s3d": (slice(8, 11), REG_TOL_3D),
            "dep_un": (slice(15, 16), REG_TOL_3D)}
    gpu = YOLOv10("yolov10s_3D.yaml", device="cuda", seed=0)
    x = serve_preprocess(torch.from_numpy(np.stack(frames)).cuda(), KITTI_HW)
    calibrate(gpu.model, x, bn_std=BN_STD_3D)
    n_params = sum(p.numel() for p in gpu.model.parameters())
    print(f"[serve3d] YOLOv10-S-3D nc={gpu.spec.nc} params={n_params} strides="
          f"{gpu.spec.strides} at {KITTI_HW[0]}x{KITTI_HW[1]} (375x1242 frames)")
    for _, ims, b, md in requests:  # warm-up
        gpu.predict(ims, imgsz=imgsz, batch=b, conf=CONF, max_det=md)
    torch.cuda.synchronize()

    reps = 5
    reset_launch_counts()
    gpu_res, times = {}, {}
    for name, ims, b, md in requests:
        want = {k: 0 for k in launch_counts}
        want["stem_conv"] = -(-len(ims) // b)
        times[name] = []
        for _ in range(reps):
            before = dict(launch_counts)
            t0 = time.perf_counter()
            res = gpu.predict(ims, imgsz=imgsz, batch=b, conf=CONF, max_det=md)
            times[name].append((time.perf_counter() - t0) * 1e3)
            got = {k: launch_counts[k] - before[k] for k in launch_counts}
            if got != want:
                raise AssertionError(f"request {name}: launches {got}, expected {want}")
            _check_results3d(res, [im.shape[:2] for im in ims], md)
        gpu_res[name] = res
    launches = dict(launch_counts)
    for k in SERVE3D_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} never launched on the 3D serving path")
    graph = serve_graph(card, [(name, gpu, ims, b, {"max_det": md}) for name, ims, b, md in
                               requests + [("kitti_b8_dense", frames, 8, 100)]], imgsz)
    route_10b(card, graph)
    for name, md in (("kitti_b8", 50), ("kitti_b8_dense", 100)):
        print(f"[serve-graph] {name}, one captured request traced: "
              + traced_request(lambda: gpu.predict(frames, imgsz=imgsz, batch=8, conf=CONF,
                                                   max_det=md)))

    sd = sparse_vs_dense_on_card(gpu.model, x, gpu.spec.nc)
    print(f"[serve3d] sparse vs dense head on the GPU, 8 frames: class maps equal, candidates "
          f"fill {sd['fills']} of P3/P4/P5, max abs diff at the candidates {sd['maps']:.3g} "
          f"(bar 1e-4 + 1e-4 |y|), top-{50} labels and scores equal, regression max abs diff "
          f"{sd['detections']:.3g} (bar 1e-3)")

    cpu = YOLOv10("yolov10s_3D.yaml", device="cpu", seed=0)
    cpu.model.load_state_dict(gpu.model.state_dict())
    t0 = time.perf_counter()
    gaps = float32_gap_3d(cpu, x.cpu())
    print(f"[serve3d] the CPU's own float32 error on the 8 frames (dense head maps vs a float64 "
          f"run, max abs; BatchNorm std {BN_STD_3D}): "
          + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
          + f" ({time.perf_counter() - t0:.1f} s)")
    for name, ims, b, md in requests:
        t0 = time.perf_counter()
        ref = cpu.predict(ims, imgsz=imgsz, batch=b, conf=CONF, max_det=md)
        ref_s = time.perf_counter() - t0
        stats = compare_results(ref, gpu_res[name], conf=CONF, score_tol=SCORE_TOL,
                                box_tol=BOX_TOL, cols=cols)
        if stats["n_compared"] < 0.5 * (stats["n_ref"] + stats["n_got"]):
            raise AssertionError(f"request {name}: too few separated detections {stats}")
        ms = statistics.median(times[name])
        print(f"[serve3d] {name}: {len(ims)} img, max_det {md}, {stats['n_ref']} dets | GPU "
              f"median {ms:.2f} ms/request, {len(ims) / ms * 1e3:.1f} img/s ({card}, {reps} "
              f"reps: {', '.join(f'{t:.2f}' for t in times[name])}) | vs CPU: "
              f"{stats['n_compared']} compared, max score err {stats['max_score_err']:.3g} (bar "
              f"{SCORE_TOL}), box {stats['max_box_err']:.3g} px (bar {BOX_TOL}), 3D centre "
              f"{stats['max_center3d_err']:.3g} px (bar {BOX_TOL}), s3d "
              f"{stats['max_s3d_err']:.3g}, dep_un {stats['max_dep_un_err']:.3g} (bar "
              f"{REG_TOL_3D}); reference took {ref_s:.1f} s")
    std05_vs_float64(std05_net(x), frames, x, imgsz)
    print(f"[serve3d] main-path launches: {launches}")
    return launches


def _http(url: str, timeout: float = 60.0) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


# The load generator of [server], run in a process of its own (stdlib only),
# so that its threads do not share the server's interpreter lock: argv is
# the /predict URL, a folder of PNG bodies and the number of client
# threads; each thread posts every n-th body in turn, one connection a
# request. Prints one JSON object: wall seconds, per request the ms in all
# and its parts (connect, send, wait for the response's head, read), the
# replies (None where a request failed, with the error beside).
LOAD_CLIENT = r"""
import http.client, json, sys, threading, time
from pathlib import Path
from urllib.parse import urlparse
url, folder, n = urlparse(sys.argv[1]), Path(sys.argv[2]), int(sys.argv[3])
bodies = [p.read_bytes() for p in sorted(folder.glob("*.png"))]
replies, parts, errors = [None] * len(bodies), [None] * len(bodies), []
def client(k):
    for i in range(k, len(bodies), n):
        try:
            t0 = time.perf_counter()
            c = http.client.HTTPConnection(url.hostname, url.port, timeout=120)
            c.connect()
            t1 = time.perf_counter()
            c.request("POST", url.path, body=bodies[i])
            t2 = time.perf_counter()
            r = c.getresponse()
            t3 = time.perf_counter()
            replies[i] = json.loads(r.read())
            c.close()
            t4 = time.perf_counter()
            if r.status != 200:
                raise RuntimeError(f"HTTP {r.status}: {replies[i]}")
            parts[i] = [(t4 - t0) * 1e3, (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3,
                        (t4 - t3) * 1e3]
        except Exception as e:
            errors.append(f"request {i}: {e!r}")
threads = [threading.Thread(target=client, args=(k,)) for k in range(n)]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join()
json.dump({"wall_s": time.perf_counter() - t0, "parts": parts, "replies": replies,
           "errors": errors}, sys.stdout)
"""


def load_clients(url: str, bodies, threads: int) -> dict:
    """Post ``bodies`` to ``url`` from ``threads`` client threads of a
    child process (``LOAD_CLIENT``); its output, after it has exited."""
    with tempfile.TemporaryDirectory() as tmp:
        for i, body in enumerate(bodies):
            (Path(tmp) / f"{i:04d}.png").write_bytes(body)
        out = subprocess.run([sys.executable, "-c", LOAD_CLIENT, url, tmp, str(threads)],
                             capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"the load client failed: {out.stderr[-2000:]}")
    run = json.loads(out.stdout)
    if run["errors"] or any(r is None for r in run["replies"]):
        raise AssertionError(f"{len(run['errors'])} requests failed: {run['errors'][:3]}")
    return run


def _joined(before: set, what: str) -> None:
    """Every thread started since ``before`` has ended (10 s to finish)."""
    import threading

    deadline = time.monotonic() + 10
    while set(threading.enumerate()) - before and time.monotonic() < deadline:
        time.sleep(0.05)
    left = set(threading.enumerate()) - before
    if left:
        raise AssertionError(f"{what} left threads behind: {sorted(t.name for t in left)}")


def phase_server(card: str) -> dict:
    """[server]: the port's InferenceServer on the card over HTTP on
    localhost. YOLOv10-S at 640 (seeded, calibrated), max_batch 8,
    max_delay_ms 10: warmup captures buckets 1, 2, 4 and 8; 16 client
    threads of a child process (``LOAD_CLIENT``) post 64 PNG bodies
    (480x640, made from the seed and encoded here); every response's rows
    are held to a direct call of the facade's captured Predictor on the
    same image at the float32 bars; requests/s, client p50/p90/p99, the
    batch histogram and /stats. Then YOLOv10-S-3D at 384x1280, max_batch
    2, four KITTI-sized frames from two client threads, held to a direct
    call likewise (hwl and depth_sigma at 1e-3). Each server is
    stopped and must leave no thread behind. Returns the launch counts of
    the 2D traffic (the warmup excluded)."""
    import threading

    import numpy as np
    import torch

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.engine.server import InferenceServer
    from yolov10_3d_torch.kernels import launch_counts, reset_launch_counts
    from yolov10_3d_torch.ops.preprocess import serve_preprocess
    from yolov10_3d_torch.utils.parity import (calibrate, compare_results, smooth_images,
                                               summary_results)

    torch.backends.cudnn.allow_tf32 = False  # the float32 bars, as in [serve]
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    imgs = smooth_images(np.random.default_rng(5), [(480, 640)] * 64)
    bodies = [png_bytes(im) for im in imgs]
    model = YOLOv10("yolov10s.yaml", device="cuda", seed=0)
    calibrate(model.model, serve_preprocess(torch.from_numpy(np.stack(imgs[:16])).cuda(),
                                            (IMGSZ, IMGSZ)))
    before = set(threading.enumerate())
    srv = InferenceServer(model, imgsz=IMGSZ, conf=CONF, max_batch=8, max_delay_ms=10.0)
    t0 = time.perf_counter()
    srv.warmup()
    warm_s = time.perf_counter() - t0
    caps = {k[0][0]: c for k, c in srv.predictor.graphs.items()}
    if sorted(caps) != [1, 2, 4, 8] or srv.batcher.allowed != [1, 2, 4, 8]:
        raise AssertionError(f"warmup captured batches {sorted(caps)}, allowed "
                             f"{srv.batcher.allowed}")
    print(f"[server] YOLOv10-S at {IMGSZ}, max_batch 8, max_delay_ms 10: warmup of buckets "
          f"{srv.batcher.allowed} took {warm_s:.2f} s; per bucket capture ms / reserved MiB: "
          + ", ".join(f"{b}: {c.capture_s * 1e3:.1f} / {c.reserved / 2**20:.1f}"
                      for b, c in sorted(caps.items())) + f" ({card})")
    http = srv.serve(port=0, blocking=False, warmup=False)
    url = f"http://127.0.0.1:{http.server_address[1]}"
    reset_launch_counts()
    run = load_clients(url + "/predict", bodies, 16)
    launches = dict(launch_counts)
    stats = _http(url + "/stats")
    srv.stop()
    _joined(before, "[server] 2D")
    replies, wall = run["replies"], run["wall_s"]
    parts = np.array(run["parts"])  # (requests, [all, connect, send, wait, read]) ms
    lat = parts[:, 0]
    if launches["decode_detect"] != stats["batches"] or launches["stem_conv"] != stats["batches"]:
        raise AssertionError(f"[server]: launches {launches} for {stats['batches']} batches")
    model.predict(imgs[0], imgsz=IMGSZ, conf=CONF)  # the direct path's capture
    direct = model.predict(imgs, imgsz=IMGSZ, conf=CONF)
    got = [summary_results(r["detections"], im.shape) for r, im in zip(replies, imgs)]
    cmp = compare_results(direct, got, conf=CONF, score_tol=SCORE_TOL, box_tol=BOX_TOL)
    if cmp["n_compared"] < 0.5 * (cmp["n_ref"] + cmp["n_got"]):
        raise AssertionError(f"[server]: too few separated detections {cmp}")
    q = np.percentile(lat, [50, 90, 99])
    split = "; ".join(f"{name} " + "/".join(f"{v:.2f}" for v in np.percentile(parts[:, j],
                                                                             [50, 90, 99]))
                      for j, name in enumerate(("connect", "send", "wait", "read"), 1))
    print(f"[server] 64 requests from 16 client threads (another process) in {wall:.3f} s: "
          f"{len(bodies) / wall:.1f} "
          f"requests/s, client ms p50 {q[0]:.2f} p90 {q[1]:.2f} p99 {q[2]:.2f} (p50/p90/p99 of "
          f"its parts: {split}); batched_with "
          f"{sorted({r['batched_with'] for r in replies})}; /stats {json.dumps(stats)}; "
          f"launches {launches} ({card})")
    print(f"[server] responses vs a direct call of the captured Predictor: {cmp['n_compared']} "
          f"compared, max score err {cmp['max_score_err']:.3g} (bar {SCORE_TOL}), max box err "
          f"{cmp['max_box_err']:.3g} px (bar {BOX_TOL})")

    frames = smooth_images(np.random.default_rng(6), [(375, 1242)] * 4)
    imgsz3 = [KITTI_HW[1], KITTI_HW[0]]
    m3 = YOLOv10("yolov10s_3D.yaml", device="cuda", seed=0)
    calibrate(m3.model, serve_preprocess(torch.from_numpy(np.stack(frames)).cuda(), KITTI_HW),
              bn_std=BN_STD_3D)
    srv3 = InferenceServer(m3, imgsz=imgsz3, conf=CONF, max_batch=2, max_delay_ms=10.0)
    t0 = time.perf_counter()
    srv3.warmup()
    warm3 = time.perf_counter() - t0
    http = srv3.serve(port=0, blocking=False, warmup=False)
    url = f"http://127.0.0.1:{http.server_address[1]}"
    replies3 = load_clients(url + "/predict", [png_bytes(f) for f in frames], 2)["replies"]
    stats3 = _http(url + "/stats")
    srv3.stop()
    _joined(before, "[server] 3D")
    direct3 = m3.predict(frames, imgsz=imgsz3, conf=CONF, max_det=50)
    got3 = [summary_results(r["detections"], f.shape) for r, f in zip(replies3, frames)]
    cols = {"s3d": (slice(8, 11), REG_TOL_3D), "dep_un": (slice(15, 16), REG_TOL_3D)}
    cmp3 = compare_results(direct3, got3, conf=CONF, score_tol=SCORE_TOL, box_tol=BOX_TOL,
                           cols=cols)
    if cmp3["n_compared"] < 0.5 * (cmp3["n_ref"] + cmp3["n_got"]):
        raise AssertionError(f"[server] 3D: too few separated detections {cmp3}")
    print(f"[server] YOLOv10-S-3D at {KITTI_HW[0]}x{KITTI_HW[1]}, max_batch 2: warmup "
          f"{warm3:.2f} s; 4 frames from 2 client threads, batched_with "
          f"{sorted({r['batched_with'] for r in replies3})}, /stats {json.dumps(stats3)}; vs a "
          f"direct call: {cmp3['n_compared']} compared, score {cmp3['max_score_err']:.3g}, box "
          f"{cmp3['max_box_err']:.3g} px, hwl {cmp3['max_s3d_err']:.3g}, depth_sigma "
          f"{cmp3['max_dep_un_err']:.3g} (bars {SCORE_TOL}, {BOX_TOL}, {REG_TOL_3D}); both "
          f"servers stopped, no thread left; phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def kitti_tree(root: Path, n: int = VAL3D_FRAMES, seed: int = 0, n_val: int = None,
               seg: bool = False) -> Path:
    """A KITTI tree of ``n`` 375x1242 PNG frames (smooth background, one
    painted box per object), labels of the three classes at each difficulty
    (easy, moderate, hard, and an occlusion 3 that KITTI ignores) with a
    DontCare row a frame, KITTI's P2 calibration, ImageSets/train.txt (all
    frames) and val.txt (the first ``n_val``, default all); with ``seg`` the
    instance masks of the FGDM depth maps (each object's box its label row,
    background 51) under deepseg/training/image_2. Returns its data YAML."""
    import numpy as np

    from yolov10_3d_torch.utils.parity import smooth_images

    rng = np.random.default_rng(seed)
    for sub in ("image_2", "label_2", "calib"):
        (root / "training" / sub).mkdir(parents=True)
    (root / "ImageSets").mkdir()
    seg_dir = root / "deepseg" / "training" / "image_2"
    if seg:
        seg_dir.mkdir(parents=True)
    fu, cu, cv = 721.5377, 609.5593, 172.854
    dims = {"Car": (1.53, 1.63, 3.88), "Pedestrian": (1.76, 0.66, 0.84),
            "Cyclist": (1.74, 0.6, 1.76)}
    levels = [(0.0, 0), (0.2, 1), (0.4, 2), (0.0, 3)]  # (truncation, occlusion)
    for i, img in enumerate(smooth_images(rng, [(375, 1242)] * n)):
        lines = []
        mask = np.full((375, 1242), 51, np.uint8)
        for j, name in enumerate(("Car", "Pedestrian", "Cyclist", "Car", "Pedestrian", "Car")):
            h, w, l = dims[name]
            z, x, ry = rng.uniform(8, 45), rng.uniform(-10, 10), rng.uniform(-math.pi, math.pi)
            u, v = fu * x / z + cu, fu * (1.65 - h / 2) / z + cv
            bw, bh = fu * max(l, w) / z, fu * h / z
            x1, y1 = max(u - bw / 2, 0), max(v - bh / 2, 0)
            x2, y2 = min(u + bw / 2, 1241), min(v + bh / 2, 374)
            if x2 - x1 < 8 or y2 - y1 < 8:
                continue
            img[int(y1):int(y2), int(x1):int(x2)] = rng.integers(0, 256, 3)
            mask[int(y1):int(y2), int(x1):int(x2)] = len(lines)
            trunc, occ = levels[(i + j) % 4]
            alpha = ry - math.atan2(u - cu, fu)
            lines.append(f"{name} {trunc:.2f} {occ} {alpha:.2f} {x1:.2f} {y1:.2f} {x2:.2f} "
                         f"{y2:.2f} {h:.2f} {w:.2f} {l:.2f} {x:.2f} 1.65 {z:.2f} {ry:.2f}")
        dx = rng.uniform(0, 1100)
        lines.append(f"DontCare -1 -1 -10 {dx:.2f} 160.00 {dx + 120:.2f} 200.00 -1 -1 -1 "
                     "-1000 -1000 -1000 -10")
        write_png(root / "training" / "image_2" / f"{i:06d}.png", img)
        if seg:
            write_png(seg_dir / f"{i:06d}_seg.png", np.repeat(mask[..., None], 3, 2))
        (root / "training" / "label_2" / f"{i:06d}.txt").write_text("\n".join(lines) + "\n")
        (root / "training" / "calib" / f"{i:06d}.txt").write_text(
            f"P2: {KITTI_P2}\nR0_rect: 1 0 0 0 1 0 0 0 1\n"
            "Tr_velo_to_cam: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    (root / "ImageSets" / "train.txt").write_text("".join(f"{i:06d}\n" for i in range(n)))
    (root / "ImageSets" / "val.txt").write_text(
        "".join(f"{i:06d}\n" for i in range(n if n_val is None else min(n_val, n))))
    yaml_path = root / "kitti_val.yaml"
    yaml_path.write_text(f"path: {root}\ntrain: ImageSets/train.txt\nval: ImageSets/val.txt\n"
                         "names:\n  0: Car\n  1: Pedestrian\n  2: Cyclist\n")
    return yaml_path


def phase_val3d(card: str) -> dict:
    """KITTI AP40 validation of YOLOv10-S-3D on the card, on both routes,
    each held to the same call on the CPU in float64 (the exact rows); the
    gaps to the CPU's float32 run, and of that run to float64, are printed
    beside. The launches and times of each."""
    import numpy as np
    import torch

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.data.kitti import KITTIDataset
    from yolov10_3d_torch.eval.kitti_eval import iou_route
    from yolov10_3d_torch.kernels import launch_counts, reset_launch_counts
    from yolov10_3d_torch.native import build_error
    from yolov10_3d_torch.utils.parity import calibrate, compare_kitti_rows, o2m_near_o2o

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = kitti_tree(Path(tmp) / "kitti")
        ds = KITTIDataset(data.parent, "val")
        frames = np.stack([ds[i]["img"] for i in range(len(ds))])
        print(f"[val3d] synthetic KITTI tree: {len(ds)} frames 375x1242 written and read back in "
              f"{time.perf_counter() - t0:.1f} s; rotated IoU route: {iou_route()}"
              + (f" (native build failed: {build_error()})" if build_error() else ""))
        gpu = YOLOv10("yolov10s_3D.yaml", device="cuda", seed=0)
        x = torch.from_numpy(frames).cuda().permute(0, 3, 1, 2).float().div(255.0).contiguous()
        calibrate(gpu.model, x, bn_std=BN_STD_3D)
        o2m_near_o2o(gpu.model)
        del x
        cpu = YOLOv10("yolov10s_3D.yaml", device="cpu", seed=0)
        cpu.model.load_state_dict(gpu.model.state_dict())
        exact = YOLOv10("yolov10s_3D.yaml", device="cpu", seed=0)
        exact.model.load_state_dict(gpu.model.state_dict())
        exact.model.double()
        common = dict(data=str(data), batch=8)
        gpu.val(**common, save_dir=f"{tmp}/warmup")  # cuDNN's first calls, the native build
        torch.cuda.synchronize()
        out = {}
        for route, kw in (("sparse", {"max_det": 50}), ("o2m", {"use_o2m_depth": True})):
            reset_launch_counts()
            t0 = time.perf_counter()
            got = gpu.val(**common, save_dir=f"{tmp}/gpu_{route}", **kw)
            wall = time.perf_counter() - t0
            launches = dict(launch_counts)
            v = gpu.validator
            if any(launches.values()):
                raise AssertionError(f"val3d {route}: hand kernels launched {launches}; the "
                                     "validator's path runs none")
            t0 = time.perf_counter()
            want = cpu.val(**common, save_dir=f"{tmp}/cpu_{route}", **kw)
            ref_s = time.perf_counter() - t0
            c = cpu.validator
            exact.val(**common, save_dir=f"{tmp}/f64_{route}", **kw)
            e = exact.validator
            stats = compare_kitti_rows(e.results, v.results, SCORE_TOL, BOX_TOL, REG_TOL_3D,
                                       REG_TOL_3D, e.bins, v.bins)
            inf = float("inf")  # the float32 runs' gaps, printed
            gap_cpu = compare_kitti_rows(c.results, v.results, inf, inf, inf, inf, c.bins, v.bins)
            floor = compare_kitti_rows(e.results, c.results, inf, inf, inf, inf, e.bins, c.bins)
            if list(got) != list(want) or stats["n_rows"] == 0:
                raise AssertionError(f"val3d {route}: metric keys {list(got)} vs {list(want)}, "
                                     f"{stats['n_rows']} rows")
            t = v.timings
            print(f"[val3d] {route}: the card vs the CPU's float32 rows: " + _row_gaps(gap_cpu)
                  + "; the CPU's float32 rows vs float64: " + _row_gaps(floor))
            print(f"[val3d] {route} ({v.route(kw.get('max_det', 50), route == 'o2m')}): "
                  f"{t['images']} frames, {stats['n_rows']} KITTI rows | vs float64: score "
                  f"{stats['max_score_err']:.3g} ({stats['max_score_rel_err']:.3g} relative; bar "
                  f"{SCORE_TOL} + {REG_TOL_3D} max(1, |ln s|) of the score s), box {stats['max_box_err']:.3g} px "
                  f"(bar {BOX_TOL}), sizes {stats['max_dim_rel_err']:.3g}, depth "
                  f"{stats['max_depth_rel_err']:.3g}, x/y {stats['max_xy_err_over_z']:.3g} of z "
                  f"(bar {REG_TOL_3D}), angles {stats.get('max_angle_err', 0.0):.3g} (bar "
                  f"{REG_TOL_3D}), heading bins differing {stats['n_bin_flips']}; CPU took "
                  f"{ref_s:.1f} s")
            print(f"[val3d] {route}: {t['images'] / t['total']:.2f} img/s end to end "
                  f"({t['total'] * 1e3:.1f} ms for {t['images']} frames, host clock {wall:.2f} s "
                  f"around val) = loader wait {t['loader'] * 1e3:.1f} ms (PNG decode + warp, 4 "
                  f"threads) + device {t['device'] * 1e3:.1f} ms (forward + decode + top-k, "
                  f"CUDA events) + host rows {t['host'] * 1e3:.1f} ms (decode_preds, 2D metrics, "
                  f"save_results) + evaluator {t['eval'] * 1e3:.1f} ms (eval_from_scratch) ({card})")
            print(f"[val3d] {route}: AP40 tables, card {v.table} | CPU {e.table}; metrics card "
                  + ", ".join(f"{k} {got[k]:.4g}" for k in ("mAP50", "mAP50-95", "metrics/3D"))
                  + f"; hand-kernel launches {launches}")
            out[route] = {"stats": stats, "gap_cpu": gap_cpu, "floor": floor, "timings": t,
                          "launches": launches}
    print(f"[val3d] phase took {time.perf_counter() - t_phase:.1f} s")
    return out


def _row_gaps(stats: dict) -> str:
    return ", ".join(f"{k[4:]} {v:.3g}" for k, v in stats.items() if k.startswith("max_")) + \
        f", heading bins differing {stats['n_bin_flips']}"


def bmp_bytes(img) -> bytes:
    """A 24-bit bottom-up BMP of an HWC RGB uint8 image."""
    import numpy as np

    h, w, _ = img.shape
    stride = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img[::-1, :, ::-1].reshape(h, -1)
    head = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    return b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54) + head + rows.tobytes()


def reference_pt(model, path: Path, model_yaml: str) -> None:
    """A .pt of the port's model in the JAX package's export format
    (yolov10_3d_tpu/utils/torch_export.py export_torch_checkpoint): the
    state_dict with the keys a reference model has beside the port's (the
    DFL's arange; the 3D head's o2o_heads.{j} aliases of its branches), the
    YAML, names and train args, written with torch.save."""
    import torch

    sd = {k: v.detach().cpu().clone() for k, v in model.model.state_dict().items()}
    head = f"model.{model.spec.head_index}"
    sd[f"{head}.dfl.conv.weight"] = torch.arange(16, dtype=torch.float32).reshape(1, 16, 1, 1)
    if model.task == "detect3d":
        for key in [k for k in sd if k.startswith(head + ".")]:
            rest = key[len(head) + 1:]
            for j, br in enumerate(BRANCHES_3D):
                if rest.startswith(br + "."):
                    sd[f"{head}.o2o_heads.{j}.{rest[len(br) + 1:]}"] = sd[key]
                    break
    torch.save({"state_dict": sd, "model_yaml": model_yaml, "names": model.names,
                "train_args": {"imgsz": IMGSZ}, "format": "yolov10_3d_tpu.torch_export/1"}, path)


def codec_on_host() -> str:
    """The codec library on this host against the committed digests of
    tests/data/codec (cv2's and PIL's decoded pixels, PIL's and cv2's JPEG
    bytes) and, stage by stage, against data/codec_rules.py."""
    import hashlib

    import numpy as np

    from yolov10_3d_torch.data import codec_rules as R
    from yolov10_3d_torch.data import image_io
    from yolov10_3d_torch.native import image_codec

    def sha(b):
        return hashlib.sha256(b).hexdigest()

    fx = Path(__file__).resolve().parent / "tests" / "data" / "codec"
    digests = json.loads((fx / "digests.json").read_text())
    n_dec = n_stage = 0
    for name, want in sorted(digests["decoded"].items()):
        data = (fx / name).read_bytes()
        for rule in ("cv2", "pil"):
            got = image_io.decode_bytes(data, rule, name)
            if [sha(got.tobytes()), list(got.shape)] != want[rule]:
                raise AssertionError(f"sources: {name} by {rule}'s rule is not its digest")
            n_dec += 1
        if name.endswith(".jpg"):
            coded = image_codec.jpeg_decode_stages(data)
            for k in coded.components:
                if not np.array_equal(R.blocks_to_plane(R.idct_islow(k.coefs, k.qtable)), k.plane):
                    raise AssertionError(f"sources: {name}'s IDCT is not its rule")
            if not np.array_equal(R.decode_pixels(coded), coded.output):
                raise AssertionError(f"sources: {name}'s upsampling and colour are not the rule")
            n_stage += 2
    n_enc = 0
    for name, want in sorted(digests["encoded"].items()):
        img = image_io.imread(fx / name)
        for style in ("pil", "cv2"):
            if sha(image_io.encode_jpeg(img, style)) != want[style]:
                raise AssertionError(f"sources: {name} encoded in {style}'s style is not its digest")
            n_enc += 1
            coded = image_codec.jpeg_encode_stages(img, image_io.JPEG_QUALITY[style])
            for k, full in zip(coded.components, R.rgb_to_ycc(img)):
                plane = R.downsample(full, coded.hmax // k.h, k.plane.shape[1], k.plane.shape[0],
                                     coded.vmax)
                coefs = R.encode_coefficients(k.plane, k.qtable, k.coefs.shape[:2],
                                              k.blocks_real, k.h, k.v)
                if not (np.array_equal(plane, k.plane) and np.array_equal(coefs, k.coefs)):
                    raise AssertionError(f"sources: {name}'s encoding stages are not the rules")
                n_stage += 2
    raw = np.random.default_rng(2).integers(0, 256, (64, 1 + 3 * 97), dtype=np.uint8)
    raw[:, 0] = np.arange(64) % 5
    if not np.array_equal(image_codec.png_unfilter(raw, 64, 3 * 97, 3, "rows"),
                          R.png_unfilter(raw, 64, 3 * 97, 3)):
        raise AssertionError("sources: the PNG unfilter is not its rule")
    return (f"{n_dec} decodes of {len(digests['decoded'])} files equal their cv2/PIL digests, "
            f"{n_enc} encodes equal PIL's and cv2's bytes, {n_stage + 1} stages equal "
            "data/codec_rules.py")


def phase_sources(card: str) -> dict:
    """[sources]: prediction over files on the card (the docstring's 4e).
    Returns the launch counts of its forwards."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.data import image_io
    from yolov10_3d_torch.engine.server import InferenceServer
    from yolov10_3d_torch.native import image_codec
    from yolov10_3d_torch.kernels import launch_counts, reset_launch_counts
    from yolov10_3d_torch.ops.preprocess import serve_preprocess
    from yolov10_3d_torch.utils.parity import (calibrate, compare_results, smooth_images,
                                               summary_results)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    print(f"[sources] codec on the card machine's host: {codec_on_host()} "
          f"({time.perf_counter() - t0:.1f} s)")

    def same(a, b, what):
        if len(a) != len(b) or any(not np.array_equal(x.boxes.data, y.boxes.data)
                                   for x, y in zip(a, b)):
            raise AssertionError(f"sources: {what} differ")

    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp) / "frames"
        folder.mkdir()
        imgs = smooth_images(np.random.default_rng(13), [(480, 640)] * SOURCES_FRAMES)
        for i, im in enumerate(imgs):
            if i < SOURCES_FRAMES - 4:
                (folder / f"f{i:02d}.jpg").write_bytes(image_io.encode_jpeg(im, "pil"))
            elif i < SOURCES_FRAMES - 1:
                (folder / f"f{i:02d}.png").write_bytes(png_bytes(im))
            else:
                (folder / f"f{i:02d}.bmp").write_bytes(bmp_bytes(im))
        files = sorted(str(p) for p in folder.iterdir())
        decode_ms, stage_ms = [], {"output only": [], "every stage": []}
        for f in files[:SOURCES_FRAMES - 4]:
            t0 = time.perf_counter()
            image_io.imread(f)
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            data = Path(f).read_bytes()
            for name, fn in (("output only", image_codec.jpeg_decode),
                             ("every stage", image_codec.jpeg_decode_stages)):
                t0 = time.perf_counter()
                fn(data)
                stage_ms[name].append((time.perf_counter() - t0) * 1e3)
        frames = [image_io.imread(f) for f in files]
        model = YOLOv10("yolov10s.yaml", device="cuda", seed=0)
        calibrate(model.model, serve_preprocess(torch.from_numpy(np.stack(frames[:16])).cuda(),
                                                (IMGSZ, IMGSZ)))
        kw = dict(imgsz=IMGSZ, conf=CONF)
        for b in (1, 8):  # each batch size's first call captures its graph
            model.predict(frames[:b], batch=b, **kw)
        torch.cuda.synchronize()
        reset_launch_counts()
        forwards, rate = 0, {}
        for b in (1, 8):
            t0 = time.perf_counter()
            from_files = model.predict(str(folder), batch=b, **kw)
            rate[b] = SOURCES_FRAMES / (time.perf_counter() - t0)
            if [r.path for r in from_files] != files:
                raise AssertionError("sources: the folder's frames came in another order")
            same(from_files, model.predict(frames, batch=b, **kw), f"batch {b}: files and arrays")
            out = Path(tmp) / f"out{b}"
            t0 = time.perf_counter()
            saved = model.predict(str(folder), batch=b, save=True, save_txt=True, save_crop=True,
                                  save_dir=str(out), max_det=20, **kw)
            rate[f"{b}_save"] = SOURCES_FRAMES / (time.perf_counter() - t0)
            n_files = check_saved(saved, out)
            forwards += 3 * -(-SOURCES_FRAMES // b)
        streamed = list(model.predict(str(folder), stream=True, **kw))
        forwards += SOURCES_FRAMES
        same(streamed, model.predict(str(folder), batch=1, **kw), "stream=True and the list")
        forwards += SOURCES_FRAMES
        # .pt in the JAX export format, served as the model it came from
        pt = Path(tmp) / "yolov10s.pt"
        reference_pt(model, pt, "yolov10s.yaml")
        reloaded = YOLOv10(str(pt), device="cuda")
        same(reloaded.predict(frames[:8], batch=8, **kw), model.predict(frames[:8], batch=8, **kw),
             "the .pt's and its source model's Results")
        forwards += 2
        files_counts = dict(launch_counts)  # one K1 and one stem launch a forward
        if any(files_counts[k] != forwards for k in SOURCES_KERNELS):
            raise AssertionError(f"sources: launches {files_counts} for {forwards} forwards")
        # one JPEG request to the server, rows held to the direct call
        before = set(threading.enumerate())
        srv = InferenceServer(model, imgsz=IMGSZ, conf=CONF, max_batch=1)
        http = srv.serve(port=0, blocking=False, warmup=True)
        url = f"http://127.0.0.1:{http.server_address[1]}/predict"
        req = urllib.request.Request(url, data=Path(files[0]).read_bytes(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            reply = json.loads(r.read())
        srv.stop()
        _joined(before, "[sources] server")
        direct = model.predict(image_io.imread(files[0], "pil"), **kw)
        cmp = compare_results(direct, [summary_results(reply["detections"], frames[0].shape)],
                              conf=CONF, score_tol=SCORE_TOL, box_tol=BOX_TOL)
    counts = dict(launch_counts)
    # 3D: a .pt of YOLOv10-S-3D at 384x1280
    kitti = smooth_images(np.random.default_rng(3), [(375, 1242)] * 2)
    m3 = YOLOv10("yolov10s_3D.yaml", device="cuda", seed=0)
    calibrate(m3.model, serve_preprocess(torch.from_numpy(np.stack(kitti)).cuda(), KITTI_HW),
              bn_std=BN_STD_3D)
    with tempfile.TemporaryDirectory() as tmp:
        reference_pt(m3, Path(tmp) / "yolov10s_3D.pt", "yolov10s_3D.yaml")
        r3 = YOLOv10(str(Path(tmp) / "yolov10s_3D.pt"), device="cuda")
        imgsz3 = [KITTI_HW[1], KITTI_HW[0]]
        a, b = (m.predict(kitti, imgsz=imgsz3, batch=2, conf=CONF) for m in (m3, r3))
        if any(not np.array_equal(x.boxes3d.data, y.boxes3d.data) for x, y in zip(a, b)):
            raise AssertionError("sources: the 3D .pt does not serve as its source model")
    dec = statistics.median(decode_ms)
    request_ms = 1e3 / rate[1]
    print(f"[sources] YOLOv10-S at {IMGSZ}, a folder of {SOURCES_FRAMES} 480x640 frames (28 JPEG "
          f"from the port's encoder, 3 PNG, 1 BMP): {rate[1]:.1f} img/s at batch 1, "
          f"{rate[8]:.1f} at batch 8; with save, save_txt, save_crop (max_det 20) "
          f"{rate['1_save']:.1f} / {rate['8_save']:.1f} img/s, {n_files} files each, every one "
          f"equal to its Results; decode of a 640x480 JPEG {dec:.2f} ms (median of 28; "
          f"min {min(decode_ms):.2f}), {dec / request_ms:.3f} of a batch-1 request's "
          f"{request_ms:.2f} ms; the library's decode of the same bytes, median of 28 in turn: "
          f"output only {statistics.median(stage_ms['output only']):.3f} ms, every stage copied "
          f"out {statistics.median(stage_ms['every stage']):.3f} ms ({card})")
    print(f"[sources] files = arrays bit for bit at batch 1 and 8; stream=True = the list; "
          f"YOLOv10(.pt) serves bit for bit as its source model, 2D and 3D (384x1280); one JPEG "
          f"request to the server: {len(reply['detections'])} rows, {cmp['n_compared']} compared, "
          f"max score err {cmp['max_score_err']:.2e}, box {cmp['max_box_err']:.2e} px; launches "
          f"{ {k: files_counts[k] for k in SOURCES_KERNELS} } for the {forwards} forwards over "
          f"files, { {k: counts[k] for k in SOURCES_KERNELS} } with the server's")
    print(f"[sources] phase {time.perf_counter() - t_phase:.1f} s")
    return counts


def check_saved(results, out: Path) -> int:
    """Every file ``_save_outputs`` wrote under ``out`` equals what its
    Results give: the annotated JPEG, the label lines, the crops. Returns
    the number of files."""
    import numpy as np

    from yolov10_3d_torch.data import image_io

    n = 0
    for r in results:
        stem = Path(r.path).stem
        if (out / f"{stem}.jpg").read_bytes() != image_io.encode_jpeg(r.plot(), "pil"):
            raise AssertionError(f"sources: {stem}.jpg is not its Results' plot")
        tmp = out.parent / "check.txt"
        r.save_txt(tmp, save_conf=True)
        if (out / "labels" / f"{stem}.txt").read_text() != tmp.read_text():
            raise AssertionError(f"sources: labels/{stem}.txt is not its Results' lines")
        tmp.unlink()
        n += 2
        for j in range(len(r.boxes)):
            x1, y1, x2, y2 = (int(v) for v in r.boxes.xyxy[j])
            crop = r.orig_img[max(y1, 0):max(y2, 1), max(x1, 0):max(x2, 1)]
            c = int(r.boxes.cls[j])
            f = out / "crops" / str(r.names.get(c, c)) / f"{stem}_{j}.jpg"
            if crop.size:
                if f.read_bytes() != image_io.encode_jpeg(np.ascontiguousarray(crop), "pil"):
                    raise AssertionError(f"sources: {f.name} is not its crop")
                n += 1
    if n != sum(1 for p in out.rglob("*") if p.is_file()):
        raise AssertionError(f"sources: {out} holds files that no Results gave")
    return n


def png_bytes(img) -> bytes:
    """An 8-bit RGB PNG of an HWC uint8 image (filter 0, zlib level 1)."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_png(path: Path, img) -> None:
    path.write_bytes(png_bytes(img))


def painted_image(rng, h: int, w: int, n_max: int = 5):
    """A smooth background with 1..n_max painted boxes; (HWC uint8, YOLO label rows)."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w]
    base = rng.integers(0, 120, 3)
    img = np.stack([(base[c] + (yy * (c + 1) + xx * (3 - c)) // 16) % 140 for c in range(3)],
                   -1).astype(np.uint8)
    rows = []
    for _ in range(int(rng.integers(1, n_max + 1))):
        bw, bh = int(rng.integers(24, w // 3)), int(rng.integers(24, h // 3))
        x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        img[y0:y0 + bh, x0:x0 + bw] = rng.integers(140, 256, 3)
        rows.append((int(rng.integers(0, 80)), (x0 + bw / 2) / w, (y0 + bh / 2) / h, bw / w, bh / h))
    return img, rows


def synthetic_set(root: Path, n: int = 160, seed: int = 0) -> Path:
    """n 640x480 PNGs with their YOLO label files and a data.yaml (nc=80)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir(parents=True)
    for i in range(n):
        img, rows = painted_image(rng, 480, 640)
        write_png(root / "images" / f"{i:04d}.png", img)
        (root / "labels" / f"{i:04d}.txt").write_text(
            "\n".join(f"{c} {x:.6f} {y:.6f} {w:.6f} {h:.6f}" for c, x, y, w, h in rows))
    names = "\n".join(f"  {i}: class{i}" for i in range(80))
    (root / "data.yaml").write_text(f"path: {root}\ntrain: images\nval: images\nnames:\n{names}\n")
    return root / "data.yaml"


def lockstep_batch():
    """Two samples of four 640x640 tiles with tile-frame labels, and fixed
    augmentation draws (crop offsets, HSV gains, flips)."""
    import numpy as np
    import torch

    from yolov10_3d_torch.data.preprocess import letterbox

    rng = np.random.default_rng(1)
    tiles = np.zeros((2, 4, IMGSZ, IMGSZ, 3), np.uint8)
    labels = np.zeros((2, 4, 8, 5), np.float32)
    mask = np.zeros((2, 4, 8), bool)
    for b in range(2):
        for t in range(4):
            img, rows = painted_image(rng, 480, 640)
            tiles[b, t], r, (dw, dh) = letterbox(img, (IMGSZ, IMGSZ))
            for k, (c, x, y, w, h) in enumerate(rows):
                labels[b, t, k] = (c, (x - w / 2) * 640 * r + dw, (y - h / 2) * 480 * r + dh,
                                   (x + w / 2) * 640 * r + dw, (y + h / 2) * 480 * r + dh)
                mask[b, t, k] = True
    draws = {"oy": torch.tensor([150, 420]), "ox": torch.tensor([333, 40]),
             "gains": torch.tensor([[1.012, 1.35, 0.82], [0.991, 0.55, 1.25]]),
             "flip": torch.tensor([True, False])}
    return [torch.from_numpy(a) for a in (tiles, labels, mask)], draws


@contextlib.contextmanager
def assignments(record: list = None, replay: list = None):
    """Inside: the loss's TAL assignments are appended to ``record`` (on the
    CPU), or taken in order from ``replay`` instead of being computed."""
    from yolov10_3d_torch.train import loss as L

    real = L.assign

    def assign(*args, **kw):
        if replay is not None:
            r = replay.pop(0)
            return type(r)(*(t.to(args[0].device) for t in r))
        r = real(*args, **kw)
        if record is not None:
            record.append(type(r)(*(t.detach().cpu() for t in r)))
        return r

    L.assign = assign
    try:
        yield
    finally:
        L.assign = real


def assignment_gap(a, b) -> str:
    """How two TAL assignments of one branch differ."""
    fg = int((a.fg_mask != b.fg_mask).sum())
    idx = int(((a.target_gt_idx != b.target_gt_idx) & a.fg_mask & b.fg_mask).sum())
    ts = float((a.target_scores - b.target_scores).abs().max())
    return (f"fg {int(a.fg_mask.sum())}/{int(b.fg_mask.sum())}, {fg} anchors differ in fg, "
            f"{idx} in target GT, target scores max abs diff {ts:.3g}")


def phase_train_lockstep(card: str) -> dict:
    """One SGD train step of YOLOv10-S at 640x640, batch 2, float32 (TF32
    off), on the GPU and on the CPU from the same state and batch. The CPU
    step takes the GPU step's TAL assignments, so that the comparison is of
    the arithmetic; the CPU's own assignments are computed too and the
    difference printed (a random net has near-ties in the top-10 metric)."""
    import torch

    from yolov10_3d_torch.cfg import resolve_model_cfg
    from yolov10_3d_torch.nn.build import build_model
    from yolov10_3d_torch.nn.heads import detect_bias_init
    from yolov10_3d_torch.ops.device_aug import augment_core
    from yolov10_3d_torch.train.optim import Optimizer
    from yolov10_3d_torch.train.state import TrainState, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    (tiles, labels, mask), draws = lockstep_batch()
    gpu, spec = build_model(resolve_model_cfg("yolov10s"), device="cuda", seed=0)
    detect_bias_init(gpu.model[spec.head_index], spec.nc, spec.strides)
    cpu = copy.deepcopy(gpu).cpu()
    kw = dict(name="SGD", lr0=0.01, epochs=10, steps_per_epoch=10, warmup_epochs=0.0,
              batch_size=2, nbs=2)
    step = make_train_step(nc=spec.nc, strides=spec.strides)
    before = {k: v.detach().cpu().clone() for k, v in cpu.state_dict().items()}
    own_cpu = copy.deepcopy(cpu)
    rec_gpu, rec_cpu = [], []
    out = {}
    for name, model, dev, ctx in (("gpu", gpu, "cuda", assignments(record=rec_gpu)),
                                  ("cpu", cpu, "cpu", assignments(replay=rec_gpu)),
                                  ("cpu_own", own_cpu, "cpu", assignments(record=rec_cpu))):
        batch = augment_core(tiles.to(dev), labels.to(dev), mask.to(dev), **draws,
                             out_hw=(IMGSZ, IMGSZ), crop_hw=(IMGSZ, IMGSZ), max_boxes=32)
        state = TrainState.create(model, Optimizer(model, **kw))
        if name == "cpu":
            rec_gpu_kept = list(rec_gpu)
        with ctx:
            _, metrics = step(state, batch)
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     {k: v.detach().cpu() for k, v in model.state_dict().items()}, batch)
    (mg, sg, bg), (mc, sc, bc) = out["gpu"], out["cpu"]
    m_own = out["cpu_own"][0]
    print("[train-lockstep] TAL assignments, GPU vs the CPU's own: " + "; ".join(
        f"{br}: {assignment_gap(a, b)}"
        for br, a, b in zip(("one2many", "one2one"), rec_gpu_kept, rec_cpu)))
    print("[train-lockstep] loss terms of the CPU step with its own assignments: " + ", ".join(
        f"{k} {v:.7g}" for k, v in m_own.items()))
    img_err = float((bg["img"].cpu() - bc["img"]).abs().max())
    if not img_err <= 1e-6 or not torch.equal(bg["mask_gt"].cpu(), bc["mask_gt"]):
        raise AssertionError(f"the augmented batch differs between GPU and CPU ({img_err:.3g})")
    worst_term = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc)
    params = [k for k, _ in cpu.named_parameters()]
    big = max(float((sc[k] - before[k]).abs().max()) for k in params)
    worst, floored, bad = (0.0, ""), [], []
    for k in params:
        d_gpu, d_cpu = sg[k] - before[k], sc[k] - before[k]
        top = float(d_cpu.abs().max())
        err = float((d_gpu - d_cpu).abs().max())
        if err > 1e-2 * top:
            floored.append(k)
        if err > 1e-2 * top + 1e-4 * big:
            bad.append(f"{k} ({err:.3g} of {top:.3g})")
        worst = max(worst, (err / (top + 1e-30), k))
    stats = [k for k in sc if k.endswith(("running_mean", "running_var"))]
    bn_err = max(float((sg[k] - sc[k]).abs().max()) for k in stats)
    print(f"[train-lockstep] YOLOv10-S 640x640 B=2, SGD, float32 (TF32 off), one step; "
          f"augmented batch GPU (K4) vs CPU (twin): max abs {img_err:.3g} ({card})")
    print("[train-lockstep] loss terms GPU / CPU given the GPU's assignments: " + ", ".join(
        f"{k} {mg[k]:.7g} / {mc[k]:.7g}" for k in mc) + f" | worst rel {worst_term:.3g} (bar 1e-3)")
    print(f"[train-lockstep] updates: worst {worst[0]:.3g} of its own largest element at "
          f"{worst[1]}; {len(floored)} of {len(params)} parameters beyond 1e-2 of their own, "
          f"all within it plus 1e-4 of the model's largest update ({big:.3g}) unless listed: "
          f"{bad[:8] or 'none'}{' ...' if len(bad) > 8 else ''} ({len(bad)} listed); BN running "
          f"stats max abs diff {bn_err:.3g} ({time.perf_counter() - t0:.1f} s)")
    if worst_term > 1e-3 or bad:
        raise AssertionError(f"train-lockstep: GPU step off the CPU step (terms {worst_term:.3g}, "
                             f"{len(bad)} updates beyond their bar)")
    return {"loss_terms_rel": worst_term, "update_worst": worst[0], "floored": len(floored),
            "bn_err": bn_err}


@contextlib.contextmanager
def timed_train_steps(times: list, prof=None, profiled=()):
    """Inside: every train step that ``DetectionTrainer`` builds is timed,
    host clock between two synchronisations; the steps whose index is in
    ``profiled`` (consecutive) also run under the profiler ``prof``."""
    import torch

    from yolov10_3d_torch.engine import trainer as T

    real = T.make_train_step

    def make(**kw):
        step = real(**kw)

        def timed(state, batch):
            n = len(times)
            torch.cuda.synchronize()
            if profiled and n == profiled[0]:
                prof.start()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if profiled and n == profiled[-1]:
                prof.stop()
            return out

        return timed

    T.make_train_step = make
    try:
        yield
    finally:
        T.make_train_step = real


KERNEL_GROUPS = (  # kernel name fragments -> a layer of the train step
    ("hsv_jitter", "K4 hsv_jitter"), ("fft", "convolution (cuDNN FFT)"),
    ("conv", "convolution (cuDNN)"),
    ("gemm", "matmul / convolution GEMM"), ("sm90", "matmul / convolution GEMM"),
    ("sm80", "matmul / convolution GEMM"), ("cutlass", "matmul / convolution GEMM"),
    ("batch_norm", "batch norm"), ("bn_", "batch norm"),
    ("foreach", "optimizer and EMA (foreach)"), ("reduce", "reductions"),
    ("elementwise", "elementwise"), ("copy", "copies and casts"),
)


def profile_report(prof, wall_ms: float, steps: int) -> str:
    """Device time per train step by layer and the top kernels, from a
    torch.profiler trace of ``steps`` synchronised steps (``wall_ms`` of host
    time), and the device's idle share."""
    kernels = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if t and e.device_type.name == "CUDA":
            kernels[e.key] = kernels.get(e.key, 0.0) + t / 1e3  # ms
    busy = sum(kernels.values())
    if not busy:
        return "the profiler saw no device time (not measured)"
    groups = {}
    for name, ms in kernels.items():
        low = name.lower()
        g = next((g for frag, g in KERNEL_GROUPS if frag in low), "other")
        groups[g] = groups.get(g, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return (f"device busy {busy / steps:.1f} ms/step of {wall_ms / steps:.1f} ms, idle share "
            f"{max(0.0, 1 - busy / wall_ms):.3f}; by layer (ms/step): " + ", ".join(
                f"{g} {ms / steps:.1f}" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]))
            + "; top kernels (ms/step): " + "; ".join(
                f"{name[:70]} {ms / steps:.2f}" for name, ms in top))


def isolated_steps(trainer, amp: bool, n: int = 5) -> list:
    """ms of ``n`` more train steps of the trained state on one cached batch,
    with no loader thread running (synchronised, host clock)."""
    import torch

    from yolov10_3d_torch.train.state import make_train_step

    args = trainer.args
    loader = trainer.build_loader(trainer.train_ds, args["batch"])
    loader.workers = 0  # the batch is read in this thread
    batch = trainer.to_device({**next(iter(loader)), **trainer.epoch_batch_extras(0)})
    step = make_train_step(nc=trainer.spec.nc, strides=trainer.spec.strides,
                           gains=(args["box"], args["cls"], args["dfl"]), amp=amp,
                           preprocess_fn=trainer.make_preprocess_fn(),
                           loss_fn=trainer.make_loss(trainer.spec), nhwc=trainer.nhwc)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(trainer.state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def phase_train(card: str, data: Path) -> dict:
    """YOLOv10.train on the synthetic set ``data`` in amp (bf16 autocast;
    no float32 run: the script's time goes to the learn-proofs, and the last
    float32 figures are PERF.md's). Returns the launch counts."""
    import torch

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.kernels import launch_counts, reset_launch_counts

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    times = []
    model = YOLOv10("yolov10s.yaml")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    profiled = (6, 7, 8)  # steady steps, timed apart
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with timed_train_steps(times, prof, profiled):
            state = model.train(data=str(data), imgsz=IMGSZ, batch=16, epochs=1, device_aug=True,
                                val=False, save=False, workers=4, save_dir=str(Path(tmp) / "run"))
        wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    row = model.trainer.last_metrics
    steps = state.step
    if counts["hsv_jitter"] != steps or steps < 3:
        raise AssertionError(f"train: {steps} steps launched K4 {counts['hsv_jitter']} times")
    terms = {k: v for k, v in row.items() if k not in ("epoch", "time", "lr")}
    if not all(math.isfinite(v) for v in terms.values()):
        raise AssertionError(f"train: non-finite epoch loss means {terms}")
    steady = [t for i, t in enumerate(times) if i >= 2 and i not in profiled]
    ms = statistics.median(steady)
    traced_ms = sum(times[i] for i in profiled)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train] YOLOv10-S amp (bf16 autocast) {steps} micro-steps of 16 at 640x640, "
          f"{state.optimizer.updates} optimizer updates (accumulate {state.optimizer.accumulate}): "
          f"median {ms:.1f} ms/step ({len(steady)} steady steps, not traced; all: "
          f"{', '.join(f'{t:.0f}' for t in times)} ms), {16 / ms * 1e3:.1f} img/s; epoch "
          f"{row['time']:.1f} s ({16 * steps / row['time']:.1f} img/s with the loader), call "
          f"{wall:.1f} s; peak device memory {peak:.2f} GiB ({card})")
    report = profile_report(prof, traced_ms, len(profiled))
    print(f"[train] profile of steps {[i + 1 for i in profiled]} (traced: "
          f"{traced_ms / len(profiled):.1f} ms/step): {report}")
    iso = isolated_steps(model.trainer, True)
    idle = report.split("idle share ")[1].split(";")[0] if "idle share " in report else None
    TRAIN_FIGURES.update(loop_ms=ms, iso_ms=statistics.median(iso),
                         img_s=16 * steps / row["time"], idle=idle)
    print(f"[train] the same step with no loader running (a cached batch, {len(iso)} steps): "
          f"median {statistics.median(iso):.1f} ms/step ({', '.join(f'{t:.0f}' for t in iso)} ms)")
    print(f"[train] epoch loss means: " + ", ".join(f"{k} {v:.5g}" for k, v in terms.items())
          + f"; lr {row['lr']:.3g}; launches {counts}")
    return counts


TRAIN3D_FRAMES = 32  # [train3d]'s synthetic KITTI tree; its val split is the first 16


@contextlib.contextmanager
def assignments3d(record: list = None, replay: list = None, gaps: list = None):
    """Inside: the 3D loss's assign3d results are appended to ``record`` (on
    the CPU), or taken in order from ``replay`` instead, while the step's own
    assignment is still computed and its difference appended to ``gaps``."""
    from yolov10_3d_torch.train import loss3d as L3

    real = L3.assign3d

    def assign(*args, **kw):
        r = real(*args, **kw)
        if replay is not None:
            want = type(r)(*(t.to(r.fg_mask.device) for t in replay.pop(0)))
            gaps.append(assignment_gap(want, r))
            return want
        if record is not None:
            record.append(type(r)(*(t.detach().cpu() for t in r)))
        return r

    L3.assign3d = assign
    try:
        yield
    finally:
        L3.assign3d = real


def phase_train3d_lockstep(card: str) -> dict:
    """One SGD train step of YOLOv10-S-3D (nc=3, seeded weights, the 3D
    head init) at 384x1280, batch 2, float32 (TF32 off), on the GPU and on
    the CPU from the same state and the same KITTI batch (made by the port's
    KITTIDataset, training split, from a synthetic tree). The CPU step takes
    the GPU step's 3D assignments; the CPU's own are computed beside them and
    their difference printed."""
    import numpy as np
    import torch

    from yolov10_3d_torch.cfg import get_cfg, resolve_model_cfg
    from yolov10_3d_torch.data.dataset import DictLoader
    from yolov10_3d_torch.data.kitti import KITTIDataset
    from yolov10_3d_torch.engine.trainer3d import HOST_KEYS
    from yolov10_3d_torch.nn.build import build_model
    from yolov10_3d_torch.nn.heads3d import detect3d_bias_init
    from yolov10_3d_torch.train.loss3d import detect3d_loss
    from yolov10_3d_torch.train.optim import Optimizer
    from yolov10_3d_torch.train.state import TrainState, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data = kitti_tree(Path(tmp) / "kitti", n=4)
        ds = KITTIDataset(data.parent, "train", args={"fliplr": 1.0, "random_crop": 1.0,
                                                      "mixup": 1.0})
        batch = DictLoader.collate([ds[i] for i in range(2)])
    batch = {k: torch.from_numpy(v) for k, v in batch.items() if k not in HOST_KEYS}
    gpu, spec = build_model(resolve_model_cfg("yolov10s_3D"), device="cuda", seed=0)
    detect3d_bias_init(gpu.model[spec.head_index], spec.nc, spec.strides)
    cpu = copy.deepcopy(gpu).cpu()
    hyp = get_cfg()
    kw = dict(name="SGD", lr0=0.01, epochs=10, steps_per_epoch=10, warmup_epochs=0.0,
              batch_size=2, nbs=2)
    step = make_train_step(nc=spec.nc, strides=spec.strides, nhwc=True, loss_fn=lambda p, b:
                           detect3d_loss(p, b, nc=spec.nc, strides=spec.strides, hyp=hyp))
    before = {k: v.detach().cpu().clone() for k, v in cpu.state_dict().items()}
    record, gaps, out = [], [], {}
    for name, model, dev, ctx in (("gpu", gpu, "cuda", assignments3d(record=record)),
                                  ("cpu", cpu, "cpu", assignments3d(replay=record, gaps=gaps))):
        state = TrainState.create(model, Optimizer(model, **kw))
        with ctx:
            _, metrics = step(state, {k: v.to(dev) for k, v in batch.items()})
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     {k: v.detach().cpu() for k, v in model.state_dict().items()})
    (mg, sg), (mc, sc) = out["gpu"], out["cpu"]
    worst_term = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc)
    params = [k for k, _ in cpu.named_parameters()]
    big = max(float((sc[k] - before[k]).abs().max()) for k in params)
    worst, bad = (0.0, ""), []
    for k in params:
        d_gpu, d_cpu = sg[k] - before[k], sc[k] - before[k]
        top = float(d_cpu.abs().max())
        # an update is a difference of float32 parameters: known to one spacing
        ulp = float(np.spacing(np.float32(float(before[k].abs().max()))))
        err = float((d_gpu - d_cpu).abs().max())
        if err > 1e-2 * top + 1e-4 * big + ulp:
            bad.append(f"{k} ({err:.3g} of {top:.3g})")
        worst = max(worst, (err / (top + 1e-30), k))
    stats = [k for k in sc if k.endswith(("running_mean", "running_var"))]
    bn_err = max(float((sg[k] - sc[k]).abs().max()) for k in stats)
    print("[train3d-lockstep] 3D assignments, the GPU's vs the CPU's own: " + "; ".join(
        f"{br}: {g}" for br, g in zip(("one2many", "one2one"), gaps)))
    print(f"[train3d-lockstep] YOLOv10-S-3D 384x1280 B=2 (KITTI training split: flip, crop, "
          f"mixup), SGD, float32 (TF32 off), one step; {int(batch['mask_gt'].sum())} objects "
          f"({card})")
    print("[train3d-lockstep] loss terms GPU / CPU given the GPU's assignments: " + ", ".join(
        f"{k} {mg[k]:.7g} / {mc[k]:.7g}" for k in mc) + f" | worst rel {worst_term:.3g} (bar 1e-3)")
    print(f"[train3d-lockstep] updates: worst {worst[0]:.3g} of its own largest element at "
          f"{worst[1]}; each within 1e-2 of its largest element plus 1e-4 of the model's largest "
          f"update ({big:.3g}) plus one float32 spacing of the parameter unless listed: "
          f"{bad[:8] or 'none'} ({len(bad)} listed); BN running stats max abs diff {bn_err:.3g} "
          f"({time.perf_counter() - t0:.1f} s)")
    if worst_term > 1e-3 or bad:
        raise AssertionError(f"train3d-lockstep: GPU step off the CPU step (terms "
                             f"{worst_term:.3g}, {len(bad)} updates beyond their bar)")
    return {"loss_terms_rel": worst_term, "update_worst": worst[0], "bn_err": bn_err}


def phase_train3d(card: str) -> dict:
    """YOLOv10("yolov10s_3D.yaml").train on a synthetic KITTI tree: two
    epochs with per-epoch AP40 validation in amp (bf16 autocast), then one
    epoch of a ``fgdm_predictor: true`` model with the depth maps, the FGDM
    loss and HTL. Returns the hand kernels' launches."""
    import torch

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.cfg import resolve_model_cfg
    from yolov10_3d_torch.kernels import launch_counts, reset_launch_counts
    from yolov10_3d_torch.train.loss3d import ITEM_KEYS

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = kitti_tree(Path(tmp) / "kitti", n=TRAIN3D_FRAMES, n_val=16, seg=True)
        n_val = len((data.parent / "ImageSets" / "val.txt").read_text().split())
        print(f"[train3d] synthetic KITTI tree: {TRAIN3D_FRAMES} frames 375x1242 with instance "
              f"masks, val split {n_val} of them, written in {time.perf_counter() - t0:.1f} s")
        fgdm_yaml = Path(tmp) / "yolov10s_3D_fgdm.yaml"
        fgdm_yaml.write_text(resolve_model_cfg("yolov10s_3D").read_text()
                             + "fgdm_predictor: true\n")
        # no float32 run: the script's time goes to the learn-proofs (its last
        # float32 figures are PERF.md's)
        runs = (("amp", "yolov10s_3D.yaml", dict(amp=True, epochs=2, val=True)),
                ("fgdm+htl", str(fgdm_yaml), dict(amp=True, epochs=1, val=False, htl=True,
                                                  load_depth_maps=True, fgdm_loss=True)))
        for name, cfg, kw in runs:
            times = []
            model = YOLOv10(cfg, device="cuda", seed=0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            profiled = (5, 6) if kw["epochs"] == 2 else ()  # epoch 2's middle steps
            t0 = time.perf_counter()
            with timed_train_steps(times, prof, profiled):
                state = model.train(data=str(data), kitti_resolution=[1280, 384], batch=8,
                                    workers=4, save=False, save_dir=str(Path(tmp) / name), **kw)
            wall = time.perf_counter() - t0
            counts = dict(launch_counts)
            trainer = model.trainer
            with open(Path(tmp) / name / "results.csv") as f:
                rows = list(csv.DictReader(f))
            terms = {k: float(rows[-1][k]) for k in ("loss", *ITEM_KEYS, "fgdm")
                     if k in rows[-1]}
            if not rows or not all(math.isfinite(v) for v in terms.values()):
                raise AssertionError(f"train3d {name}: non-finite epoch loss means {terms}")
            if any(counts.values()):
                raise AssertionError(f"train3d {name}: hand kernels launched {counts}; the 3D "
                                     "training path runs none")
            steps = state.step
            per_epoch = steps // kw["epochs"]
            steady = [t for i, t in enumerate(times) if i >= 1 and i not in profiled]
            ms = statistics.median(steady)
            epoch_s = float(rows[-1]["time"])
            last = times[-per_epoch:]
            wait = epoch_s * 1e3 - sum(last)
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"[train3d] {name}: YOLOv10-S-3D 1280x384, batch 8, {steps} steps in "
                  f"{kw['epochs']} epoch(s): median {ms:.1f} ms/step in the loop (steps "
                  f"{', '.join(f'{t:.0f}' for t in times)} ms); last epoch {epoch_s:.2f} s = "
                  f"{8 * per_epoch / epoch_s:.1f} img/s with the loader, of which the steps "
                  f"{sum(last) / 1e3:.2f} s and the loader wait (with the H2D copies) "
                  f"{wait / 1e3:.2f} s; call {wall:.1f} s; peak device memory {peak:.2f} GiB "
                  f"({card})")
            if profiled:
                traced_ms = sum(times[i] for i in profiled)
                print(f"[train3d] {name}: profile of steps {[i + 1 for i in profiled]}: "
                      f"{profile_report(prof, traced_ms, len(profiled))}")
            iso = isolated_steps(trainer, kw["amp"])
            print(f"[train3d] {name}: the same step with no loader running (a cached batch, "
                  f"{len(iso)} steps): median {statistics.median(iso):.1f} ms/step "
                  f"({', '.join(f'{t:.0f}' for t in iso)} ms)")
            print(f"[train3d] {name}: epoch loss means, last epoch: " + ", ".join(
                f"{k} {v:.5g}" for k, v in terms.items())
                + (f"; loss by epoch {[round(float(r['loss']), 3) for r in rows]}"
                   if len(rows) > 1 else "") + f"; hand-kernel launches {counts}")
            if kw["val"]:
                t = trainer.validator.timings
                print(f"[train3d] {name}: per-epoch validation ({t['images']} frames): "
                      f"{t['total'] * 1e3:.1f} ms (loader wait {t['loader'] * 1e3:.1f}, device "
                      f"{t['device'] * 1e3:.1f}, host rows {t['host'] * 1e3:.1f}, evaluator "
                      f"{t['eval'] * 1e3:.1f}); metrics/3D by epoch "
                      f"{[float(r['metrics/3D']) for r in rows]}")
            if "htl" in kw:
                w = trainer._htl_weights
                print(f"[train3d] {name}: fgdm {terms['fgdm']:.5g}, HTL weights "
                      f"{[round(float(v), 4) for v in w]} (sum {float(w.sum()):.4f})")
                if not terms.get("fgdm", 0.0) > 0:
                    raise AssertionError(f"train3d {name}: no FGDM loss term {terms}")
            out[name] = {"ms": ms, "counts": counts, "loss": [float(r["loss"]) for r in rows]}
            del model, trainer, state
            torch.cuda.empty_cache()
    print(f"[train3d] phase took {time.perf_counter() - t_phase:.1f} s")
    return out


CKPT_SET = 64  # [ckpt] trains and [val2d] validates on this many synthetic PNGs


def one_picture_set(root: Path, n: int = 32) -> Path:
    """``n`` copies of one painted 480x640 PNG with its labels: the set of
    the kill-and-resume pair (the mosaic partners come from the dataset's
    generator, which no checkpoint carries; with one picture they cannot
    change a batch)."""
    import numpy as np

    img, rows = painted_image(np.random.default_rng(7), 480, 640)
    body = png_bytes(img)
    label = "\n".join(f"{c} {x:.6f} {y:.6f} {w:.6f} {h:.6f}" for c, x, y, w, h in rows)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir(parents=True)
    for i in range(n):
        (root / "images" / f"{i:02d}.png").write_bytes(body)
        (root / "labels" / f"{i:02d}.txt").write_text(label)
    names = "\n".join(f"  {i}: class{i}" for i in range(80))
    (root / "data.yaml").write_text(f"path: {root}\ntrain: images\nval: images\nnames:\n{names}\n")
    return root / "data.yaml"


class _Kill(Exception):
    pass


def ckpt_pair(root: Path) -> dict:
    """The kill-and-resume pair on the card (run in a child process, whose
    environment sets CUBLAS_WORKSPACE_CONFIG before cuBLAS starts):
    YOLOv10-S at 640, batch 4, nbs 12 (accumulate 3), float32 with TF32 off,
    2 epochs of 8 micro-steps on the one-picture set; an uninterrupted run,
    then a run killed after micro-step 10 with a save every 2 (the last one
    between two accumulated micro-steps), then ``resume=True``, all under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` and
    ``cudnn.deterministic``. Returns the ops torch warned about, whether the
    two end states are equal bit for bit, and the worst update gap."""
    import warnings

    import torch

    from yolov10_3d_torch.cfg import get_cfg
    from yolov10_3d_torch.engine.trainer import DetectionTrainer
    from yolov10_3d_torch.utils.checkpoint import load_checkpoint

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    data = one_picture_set(root / "set")
    kw = dict(model="yolov10s.yaml", data=str(data), epochs=2, imgsz=IMGSZ, batch=4, workers=0,
              device_aug=True, close_mosaic=0, warmup_epochs=0.0, amp=False, lr0=0.003,
              optimizer="AdamW", nbs=12, val=False, seed=0, device="cuda")
    init = {}
    real_init = DetectionTrainer.init_params

    def keep_init(self, model, spec):
        real_init(self, model, spec)
        init.update({k: v.detach().cpu().double() for k, v in model.state_dict().items()})

    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        DetectionTrainer.init_params = keep_init
        try:
            ref = DetectionTrainer(get_cfg({**kw, "save_dir": str(root / "ref")}))
            ref.train()
        finally:
            DetectionTrainer.init_params = real_init
        killed = DetectionTrainer(get_cfg({**kw, "save_dir": str(root / "k"),
                                           "ckpt_period_steps": 2}))
        calls = {"n": 0}
        to_device = killed.to_device

        def killing(batch):
            calls["n"] += 1
            if calls["n"] > 10:
                raise _Kill()
            return to_device(batch)

        killed.to_device = killing
        try:
            killed.train()
            raise AssertionError("ckpt: the killed run was not killed")
        except _Kill:
            pass
        meta = load_checkpoint(root / "k" / "weights" / "last.ckpt")["meta"]
        resumed = DetectionTrainer(get_cfg({**kw, "save_dir": str(root / "k"), "resume": True}))
        resumed.train()
    ops = sorted({str(w.message).split("\n")[0][:160] for w in caught
                  if "deterministic" in str(w.message)})
    a, b = ref.state, resumed.state
    params = [k for k, _ in a.model.named_parameters()]
    sa, sb = a.model.state_dict(), b.model.state_dict()
    keys = [k for k in sa if not k.endswith("num_batches_tracked")]
    differ = [k for k in keys if not torch.equal(sa[k], sb[k])]
    differ += [f"ema.{k}" for k, x, y in zip(params, a.ema_params, b.ema_params)
               if not torch.equal(x, y)]
    big = max(float((sa[k].double().cpu() - init[k]).abs().max()) for k in params)
    worst, bad = 0.0, []
    for k in params:  # [train-lockstep]'s bar on each update
        upd = sa[k].double().cpu() - init[k]
        err = float((sb[k].double().cpu() - sa[k].double().cpu()).abs().max())
        top = float(upd.abs().max())
        worst = max(worst, err / (top + 1e-30))
        if err > 1e-2 * top + 1e-4 * big:
            bad.append(k)
    return {"ops": ops, "bitwise": not differ, "n_differ": len(differ), "n_keys": len(keys),
            "worst_rel": worst, "n_beyond_bar": len(bad), "meta": {k: meta.get(k) for k in (
                "step", "epoch", "batches_done")}, "steps": b.step, "updates":
            b.optimizer.updates, "seconds": time.perf_counter() - t0}


@contextlib.contextmanager
def record_best_ema(record: dict):
    """Inside: each ``save_ckpt`` of best.ckpt keeps a copy of the EMA model
    state it writes, under ``record['best']``."""
    from yolov10_3d_torch.engine.trainer import DetectionTrainer

    real = DetectionTrainer.save_ckpt

    def save(self, path, state, meta):
        if Path(path).name == "best.ckpt":
            record["best"] = {k: v.detach().clone() for k, v in state.ema_state_dict().items()}
            record["best_epoch"] = meta["epoch"]
        return real(self, path, state, meta)

    DetectionTrainer.save_ckpt = save
    try:
        yield
    finally:
        DetectionTrainer.save_ckpt = real


class PinnedBody:
    """The trainer's snapshot without a device image: the body's bytes
    between arrays written once into a kept pinned host buffer, each leaf
    on the card copied straight into its slot there (one grouped call of
    asynchronous copies, then one synchronisation). Timed against
    ``Snapshot`` in ``snapshot_ab``; the port keeps the faster."""

    def __init__(self):
        self.key = None

    def __call__(self, params, batch_stats=None, ema_params=None, opt_state=None):
        import numpy as np
        import torch

        from yolov10_3d_torch.utils import msgpack
        from yolov10_3d_torch.utils.checkpoint import _sorted, to_numpy_tree

        tree = _sorted({"params": params, "batch_stats": batch_stats or {},
                        "ema_params": ema_params or {},
                        "opt_state": opt_state if opt_state is not None else {}})
        leaves = []
        key = msgpack.layout(tree, leaves)
        if key != self.key:
            heads, raws = msgpack.pack_segments(to_numpy_tree(tree))
            image, slots = bytearray(), []
            for head, raw in zip(heads, raws + [b""]):
                image += head
                if len(slots) < len(raws):
                    slots.append((len(image), len(raw)))
                image += raw
            self.host = torch.frombuffer(image, dtype=torch.uint8).pin_memory()
            self.views = [self.host[off:off + n] for off, n in slots]
            self.key = key
        dst, src = [], []
        body = self.host.numpy()
        for leaf, view in zip(leaves, self.views):
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                dst.append(view)
                src.append(leaf.detach().contiguous().reshape(-1).view(torch.uint8))
            else:
                off = view.data_ptr() - self.host.data_ptr()
                body[off:off + view.numel()] = np.frombuffer(
                    msgpack._array_parts(leaf)[2], np.uint8, view.numel())
        if dst:
            torch._foreach_copy_(dst, src, non_blocking=True)
        torch.cuda.synchronize()
        return body


def snapshot_ab(state) -> dict:
    """The train thread's snapshot of ``state`` three ways, five of each in
    turn with no write in flight: ``Snapshot`` (the port's: the file's body
    encoded in an image on the card, one transfer to a pinned buffer),
    ``PinnedBody`` (no image on the card: each leaf copied into a kept
    pinned buffer) and ``host_copy`` (the earlier snapshot: a copy a
    leaf into pageable memory, encoded later on the writer thread). Median
    ms of each, the bodies of the first two equal byte for byte, and the
    memory each keeps: device bytes and pinned host bytes."""
    import numpy as np
    import torch

    from yolov10_3d_torch.utils.checkpoint import Snapshot, host_copy

    snap, pinned = Snapshot(), PinnedBody()
    body, release = snap(**state.checkpoint_trees())  # each layout built once
    if not np.array_equal(body, pinned(**state.checkpoint_trees())):
        raise AssertionError("ckpt: the two snapshots' bodies differ")
    release()
    times = {"snapshot": [], "pinned": [], "host_copy": []}
    for _ in range(5):
        for name, fn in (("snapshot", lambda t: snap(**t)[1]()), ("pinned", lambda t: pinned(**t)),
                         ("host_copy", host_copy)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(state.checkpoint_trees())
            times[name].append((time.perf_counter() - t0) * 1e3)
    out = {k: statistics.median(v) for k, v in times.items()}
    out.update(image_mib=snap._image.numel() / 2**20, snapshot_pinned_mib=snap.host_bytes / 2**20,
               pinned_mib=pinned.host.numel() / 2**20)
    return out


def phase_ckpt(card: str, data: Path) -> dict:
    """Checkpoints on the card: YOLOv10("yolov10s.yaml").train with
    validation and checkpoints (last, best, a mid-epoch save every 2 steps),
    its sizes and times; the kill-and-resume pair (a child process); the
    reloaded best.ckpt and last.ckpt serving [serve]'s b1_640 request through
    the captured forward, bit for bit what the run's own EMA models serve;
    the file stripped to float16 and reloaded. Returns the hand kernels'
    launches of the training run and of the reloads."""
    import numpy as np
    import torch

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.kernels import launch_counts, reset_launch_counts
    from yolov10_3d_torch.utils.checkpoint import strip_optimizer
    from yolov10_3d_torch.utils.parity import smooth_images

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run = Path(tmp) / "run"
        record = {}
        model = YOLOv10("yolov10s.yaml", device="cuda")
        reset_launch_counts()
        t0 = time.perf_counter()
        with record_best_ema(record):
            state = model.train(data=str(data), imgsz=IMGSZ, batch=16, epochs=2, device_aug=True,
                                close_mosaic=0, val=True, save=True, ckpt_period_steps=2,
                                workers=4, save_dir=str(run))
        wall = time.perf_counter() - t0
        train_counts = dict(launch_counts)
        trainer = model.trainer
        writer = trainer._ckpt_writer
        weights = run / "weights"
        last, best = weights / "last.ckpt", weights / "best.ckpt"
        steps = state.step
        if train_counts["hsv_jitter"] != steps or train_counts["decode_detect"] < 2:
            raise AssertionError(f"ckpt: {steps} steps, launches {train_counts} (K4 once a step, "
                                 "K1 once a validation batch)")
        if writer.written + writer.superseded != writer.submitted or not last.exists():
            raise AssertionError(f"ckpt: writes submitted {writer.submitted}, done "
                                 f"{writer.written}, superseded {writer.superseded}")
        snap, write = trainer.snapshot_ms, [s * 1e3 for s in writer.write_seconds]
        held = trainer._snapshot.host_bytes / 2**20
        ab = snapshot_ab(state)
        rows = list(csv.DictReader(open(run / "results.csv")))
        print(f"[ckpt] YOLOv10-S {IMGSZ}x{IMGSZ}, batch 16, 2 epochs on {CKPT_SET} PNGs with "
              f"validation and checkpoints: {steps} steps in {wall:.1f} s; last.ckpt "
              f"{last.stat().st_size / 2**20:.1f} MiB, best.ckpt (epoch "
              f"{record['best_epoch']}) {best.stat().st_size / 2**20:.1f} MiB; train thread's "
              f"snapshot per save: median {statistics.median(snap):.1f} ms (all "
              f"{', '.join(f'{t:.1f}' for t in snap)}); writer thread's write: median "
              f"{statistics.median(write):.1f} ms (all {', '.join(f'{t:.0f}' for t in write)}); "
              f"writes submitted {writer.submitted}, done {writer.written}, superseded "
              f"{writer.superseded}; the final state's snapshot with no write in flight, "
              f"median of 5 alternating: Snapshot (the body, encoded on the card) "
              f"{ab['snapshot']:.1f} ms, PinnedBody (no device image) {ab['pinned']:.1f} ms, "
              f"host_copy (a copy a leaf) {ab['host_copy']:.1f} ms a save; memory kept: "
              f"Snapshot's image {ab['image_mib']:.1f} MiB on the card and {held:.1f} MiB of "
              f"pinned host buffers in the run ({ab['snapshot_pinned_mib']:.1f} alone), "
              f"PinnedBody {ab['pinned_mib']:.1f} MiB pinned; "
              f"mAP50 by epoch {[float(r['mAP50']) for r in rows]}; "
              f"launches {train_counts} ({card})")

        # the kill-and-resume pair, in a child process: cuBLAS reads its
        # workspace setting when it starts
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--ckpt-pair",
                              str(Path(tmp) / "pair")], capture_output=True, text=True,
                             timeout=600, env={**__import__("os").environ,
                                               "CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
        if out.returncode != 0:
            raise AssertionError(f"ckpt: the kill-and-resume pair failed:\n{out.stderr[-3000:]}")
        pair = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"[ckpt] kill and resume on the card (YOLOv10-S 640, batch 4, accumulate 3, "
              f"float32, deterministic algorithms): killed at meta {pair['meta']}, resumed to "
              f"{pair['steps']} steps / {pair['updates']} updates in {pair['seconds']:.1f} s; "
              f"end state bit for bit: {pair['bitwise']} ({pair['n_differ']} of "
              f"{pair['n_keys']} tensors differ, worst update gap {pair['worst_rel']:.3g} of "
              f"its update); ops torch names as nondeterministic: {pair['ops'] or 'none'}")
        if not pair["bitwise"]:
            if not pair["ops"]:
                raise AssertionError("ckpt: resumed != uninterrupted with no nondeterministic op")
            if pair["n_beyond_bar"]:
                raise AssertionError(f"ckpt: {pair['n_beyond_bar']} updates beyond "
                                     "[train-lockstep]'s bar after resume")

        # the reloads, through the captured forward, against the run's own EMA models
        img = smooth_images(np.random.default_rng(0), [(640, 640)])  # [serve]'s b1_640
        ref = YOLOv10("yolov10s.yaml", device="cuda")
        ref.model.load_state_dict(record["best"])
        reset_launch_counts()
        served = {}
        for name, facade in (("trainer EMA (last)", model), ("last.ckpt", YOLOv10(str(last))),
                             ("best EMA", ref), ("best.ckpt", YOLOv10(str(best)))):
            for _ in range(2):  # the first call captures, the second replays
                r = facade.predict(img, imgsz=IMGSZ, conf=0.0, max_det=50)
            served[name] = r[0].boxes.data
        reload_counts = dict(launch_counts)
        for a, b in (("trainer EMA (last)", "last.ckpt"), ("best EMA", "best.ckpt")):
            if not np.array_equal(served[a], served[b]):
                raise AssertionError(f"ckpt: {b} serves other detections than the {a}")
        if not reload_counts["decode_detect"] or not reload_counts["stem_conv"]:
            raise AssertionError(f"ckpt: the reloads did not launch K1 and the stem "
                                 f"({reload_counts})")
        stripped = Path(tmp) / "best_fp16.ckpt"
        strip_optimizer(best, stripped)
        half = YOLOv10("yolov10s.yaml", device="cuda")
        half.model.load_state_dict({k: v.half().float() if v.is_floating_point() else v
                                    for k, v in record["best"].items()})
        got = YOLOv10(str(stripped)).predict(img, imgsz=IMGSZ, conf=0.0, max_det=50)
        want = half.predict(img, imgsz=IMGSZ, conf=0.0, max_det=50)
        if not np.array_equal(got[0].boxes.data, want[0].boxes.data):
            raise AssertionError("ckpt: the stripped file serves other detections than its "
                                 "weights rounded to float16")
        print(f"[ckpt] reloads served b1_640 through the captured forward: last.ckpt = the "
              f"trainer's EMA model, best.ckpt = the EMA model it was written from (epoch "
              f"{record['best_epoch']}), bit for bit on all 50 rows (conf 0; "
              f"{int((served['best.ckpt'][:, 4] > CONF).sum())} above {CONF}); launches "
              f"{reload_counts}; strip_optimizer: {last.stat().st_size / 2**20:.1f} -> "
              f"{stripped.stat().st_size / 2**20:.1f} MiB, its reload = the float16-rounded "
              f"weights bit for bit (what float16 costs a net with rows above conf: [val2d]); "
              f"phase {time.perf_counter() - t_phase:.1f} s")
    return {"train": train_counts, "reload": reload_counts}


def nearest_rows(ref_runs, got_runs, score_tol: float) -> list:
    """Per image, every row of ``ref_runs`` more than ``score_tol`` clear of
    the cutoffs beside its nearest same-class box in ``got_runs`` (both
    validator ``rows``): (box px, image, row, coordinate, score gap), with
    an infinite gap where the class has no row."""
    import numpy as np

    from yolov10_3d_torch.utils.parity import _clear_of_cutoffs

    def table(r):
        return np.concatenate([r[0], r[1][:, None], r[2][:, None]], 1).astype(np.float64)

    gaps = []
    for img, (ref, got) in enumerate(zip(ref_runs, got_runs)):
        ref, got = table(ref), table(got)
        for i in np.flatnonzero(_clear_of_cutoffs(ref[:, 4], 0.001, score_tol)):
            same = got[got[:, 5] == ref[i, 5]]
            if not len(same):
                gaps.append((math.inf, img, int(i), -1, math.inf))
                continue
            err = np.abs(same[:, :4] - ref[i, :4])
            j = int(err.max(1).argmin())
            gaps.append((float(err[j].max()), img, int(i), int(err[j].argmax()),
                         abs(float(same[j, 4] - ref[i, 4]))))
    return gaps


def phase_val2d(card: str, data: Path) -> dict:
    """``YOLOv10("yolov10s.yaml").val`` on the synthetic PNGs at 640, batch
    16, seeded weights calibrated on all the letterboxed images: img/s split into
    loader wait, device (forward, K1, top-k), host rows and metrics; K1's
    launches; every image's rows held to a CPU run of the same weights in
    float64 (TF32 off) at the [serve] bars, the metrics printed both ways.
    The reference is float64 as in [val3d]: at max_det 300 and conf 0.001
    the rows reach boxes 800 px wide, where the card's and the CPU's float32
    errors add up to more than 0.1 px (0.113 in the first run). The net is
    calibrated to BatchNorm std 0.25, as [serve3d]'s (BN_STD_3D): at 0.5
    the random net amplifies float32 rounding to the size of the bars on
    these 4800 rows (8e-5 in score on the CPU alone at 128 px).

    Then the same net through a file: saved, stripped to float16
    (``strip_optimizer``) and validated from it on the card, its rows beside
    the float32 net's and the metrics both ways, printed, not held: on a
    random net float16 weights move rows by up to tens of pixels. What
    float16 costs a trained net is held in [learn3d]."""
    import numpy as np
    import torch

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.data.dataset import YOLODataset
    from yolov10_3d_torch.kernels import launch_counts, reset_launch_counts
    from yolov10_3d_torch.utils.checkpoint import save_checkpoint, strip_optimizer
    from yolov10_3d_torch.utils.parity import calibrate, match_detections
    from yolov10_3d_torch.utils.weights import torch_to_flax_variables

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = YOLODataset(data.parent / "images", imgsz=IMGSZ, augment=False)
    x = torch.from_numpy(np.stack([ds[i]["img"] for i in range(len(ds))]))  # every image served
    gpu = YOLOv10("yolov10s.yaml", device="cuda", seed=0)
    calibrate(gpu.model, x.permute(0, 3, 1, 2).float().div(255.0).contiguous().cuda(),
              bn_std=BN_STD_3D)
    cpu = YOLOv10("yolov10s.yaml", device="cpu", seed=0)
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    cpu.model.double()
    gpu.val(data=str(data), imgsz=IMGSZ, batch=16)  # warm-up: cuDNN, allocator
    reset_launch_counts()
    out = gpu.val(data=str(data), imgsz=IMGSZ, batch=16)
    counts = dict(launch_counts)
    t = gpu.validator.timings
    rows_gpu = gpu.validator.rows
    t0 = time.perf_counter()
    ref = cpu.val(data=str(data), imgsz=IMGSZ, batch=16)
    cpu_s = time.perf_counter() - t0
    n, worst_s, worst_b, n_ref, n_got = 0, 0.0, 0.0, 0, 0
    for a, b in zip(cpu.validator.rows, rows_gpu):
        rows = [np.concatenate([r[0], r[1][:, None], r[2][:, None]], 1).astype(np.float64)
                for r in (a, b)]
        st = match_detections(*rows, 0.001, SCORE_TOL, BOX_TOL)
        n, n_ref, n_got = n + st["n_compared"], n_ref + st["n_ref"], n_got + st["n_got"]
        worst_s, worst_b = max(worst_s, st["max_score_err"]), max(worst_b, st["max_box_err"])
    if n < 0.5 * (n_ref + n_got):
        raise AssertionError(f"val2d: too few separated rows ({n} of {n_ref} / {n_got})")
    dev = t["forward"] + t["decode"] + t["topk"]
    keys = ("mAP50", "mAP50-95", "mp", "mr")
    print(f"[val2d] YOLOv10-S {IMGSZ}x{IMGSZ}, {t['images']} synthetic 480x640 PNGs, batch 16: "
          f"{t['images'] / t['total']:.1f} img/s, {t['total'] * 1e3:.1f} ms = loader wait "
          f"{t['loader'] * 1e3:.1f} + device {dev * 1e3:.1f} (forward {t['forward'] * 1e3:.1f}, "
          f"K1 {t['decode'] * 1e3:.2f}, top-k {t['topk'] * 1e3:.2f}) + host rows "
          f"{t['host'] * 1e3:.1f} + metrics {t['metrics'] * 1e3:.1f}; K1 launches "
          f"{counts['decode_detect']}, launches {counts} ({card})")
    print(f"[val2d] rows vs a float64 CPU run of the same weights ({cpu_s:.1f} s): {n} compared of "
          f"{n_ref} / {n_got}, score {worst_s:.3g}, box {worst_b:.3g} px (bars {SCORE_TOL}, "
          f"{BOX_TOL}); metrics card " + ", ".join(f"{k} {out[k]:.6f}" for k in keys)
          + " | CPU float64 " + ", ".join(f"{k} {ref[k]:.6f}" for k in keys))
    if counts["decode_detect"] != -(-t["images"] // 16):
        raise AssertionError(f"val2d: K1 launched {counts['decode_detect']} times")

    with tempfile.TemporaryDirectory() as tmp:
        full, half = Path(tmp) / "calibrated.ckpt", Path(tmp) / "calibrated_fp16.ckpt"
        variables = torch_to_flax_variables(gpu.model.state_dict())
        save_checkpoint(full, params=variables["params"], batch_stats=variables["batch_stats"],
                        meta={"model_yaml": "yolov10s.yaml", "nc": gpu.spec.nc})
        strip_optimizer(full, half)
        f16 = YOLOv10(str(half), device="cuda")
        out16 = f16.val(data=str(data), imgsz=IMGSZ, batch=16)
    gaps = nearest_rows(rows_gpu, f16.validator.rows, 1e-2)
    box = np.array([g[0] for g in gaps])
    score = np.array([g[4] for g in gaps])
    beyond = int(((box > BOX_TOL) | (score > SCORE_TOL)).sum())
    print(f"[val2d] the same net saved, stripped to float16 and validated from the file on the "
          f"card, each of the float32 net's {len(gaps)} rows clear of the cutoffs beside its "
          f"nearest same-class float16 row: box worst {box.max():.4g} px, 99th percentile "
          f"{np.percentile(box, 99):.4g}, median {np.median(box):.4g}; score worst "
          f"{score.max():.3g}, median {np.median(score):.3g}; {beyond} rows beyond the [serve] "
          f"bars ({BOX_TOL} px, {SCORE_TOL}); not held (a random net); metrics float16 "
          + ", ".join(f"{k} {out16[k]:.6f}" for k in keys) + f" ({card})")
    return counts


def val2d_std05_witness(card: str) -> None:
    """``--sweep val2d-std05``: [val2d]'s net calibrated on the first 16
    images at BatchNorm std 0.5, where its rows once missed the 0.1 px bar
    against float64. Every row of a float64 CPU run of the same weights
    beside its nearest same-class box in three runs: the card's float32,
    the CPU's float32 and the card's float64 (the same path, K1 decoding
    the maps cast to float32, as the CPU's float64 run decodes them). The
    card's float64 at the CPU's says the card's path computes the same
    function; the two float32 gaps say how far each one's rounding goes."""
    import numpy as np
    import torch

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.data.dataset import YOLODataset
    from yolov10_3d_torch.utils.parity import calibrate

    class Float64(torch.nn.Module):  # the card's float64 forward, float32 maps for K1
        def __init__(self, model):
            super().__init__()
            self.inner = model

        def forward(self, x, **kw):
            out = self.inner(x, **kw)
            return {"one2one": [f.float() for f in out["one2one"]]}

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = synthetic_set(Path(tmp) / "set", n=CKPT_SET, seed=1)
        ds = YOLODataset(data.parent / "images", imgsz=IMGSZ, augment=False)
        x = torch.from_numpy(np.stack([ds[i]["img"] for i in range(16)]))
        gpu = YOLOv10("yolov10s.yaml", device="cuda", seed=0)
        calibrate(gpu.model, x.permute(0, 3, 1, 2).float().div(255.0).contiguous().cuda(),
                  bn_std=0.5)
        state = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
        gpu.val(data=str(data), imgsz=IMGSZ, batch=16)
        runs["card"] = gpu.validator.rows
        gpu.model = Float64(copy.deepcopy(gpu.model).double())
        gpu.val(data=str(data), imgsz=IMGSZ, batch=16)
        runs["card64"] = gpu.validator.rows
        for name, dtype in (("cpu32", torch.float32), ("cpu64", torch.float64)):
            cpu = YOLOv10("yolov10s.yaml", device="cpu", seed=0)
            cpu.model.load_state_dict(state)
            cpu.model.to(dtype)
            cpu.val(data=str(data), imgsz=IMGSZ, batch=16)
            runs[name] = cpu.validator.rows
    gaps = {who: nearest_rows(runs["cpu64"], runs[who], SCORE_TOL)
            for who in ("card", "cpu32", "card64")}
    coords = ("x1", "y1", "x2", "y2")
    worst = max(gaps["card"])
    at = {who: next(g for g in gaps[who] if g[1:3] == worst[1:3]) for who in gaps}
    print(f"[val2d-std05] calibrated on 16 images at BatchNorm std 0.5, {len(gaps['card'])} "
          f"rows of the float64 CPU run clear of the cutoffs: the card's worst is image "
          f"{worst[1]} ref[{worst[2]}] {coords[worst[3]]}, {worst[0]:.4g} px; on that row the "
          f"CPU float32 {at['cpu32'][0]:.4g} px, the card float64 {at['card64'][0]:.4g} px; "
          f"worst over all rows: " + ", ".join(
              f"{who} {max(g)[0]:.4g} px, score {max(r[4] for r in g):.3g}, "
              f"{sum(r[0] > BOX_TOL for r in g)} rows beyond {BOX_TOL} px"
              for who, g in gaps.items()) + f" ({card})")


LEARN3D_RES = [320, 96]  # W, H: the JAX learn-proof's resolution
LEARN3D_BARS = {"mAP50": 0.9, "metrics/3D": 7.0}  # tests/test_overfit_ap.py:97-103
LEARN3D_JAX = {"mAP50": 0.995, "metrics/3D": 14.0}  # JAX's calibration at this recipe


def learn_tree(root: Path, n: int = 8, seed: int = 0, n_objects: int = 2,
               z_range=(8.0, 25.0)) -> Path:
    """A numpy mirror of tests/_helpers.py ``make_kitti_tree(draw_boxes=True,
    n_objects=2, z_range=(8, 25), val_all=True)``: the same draws in the same
    order, noise frames of 375x1242 with each Car painted as a solid
    rectangle in its own colour (overlapping ones skipped), KITTI's P2, every
    frame in both splits. The helper writes its frames with cv2 (BGR order),
    so the PNG holds the channels reversed, as its readers see them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for sub in ("image_2", "label_2", "calib"):
        (root / "training" / sub).mkdir(parents=True)
    (root / "ImageSets").mkdir()
    fu, cu, cv = 721.5377, 609.5593, 172.854
    ids = []
    for i in range(n):
        img = rng.uniform(0, 255, (375, 1242, 3)).astype(np.uint8)
        lines, drawn = [], []
        for j in range(n_objects):
            z = float(rng.uniform(*z_range))
            y, (h, w, l) = 1.65, (1.5, 1.65, 3.9)
            x = float(rng.uniform(-8, 8))
            ry = float(rng.uniform(-math.pi, math.pi))
            u, v = fu * x / z + cu, fu * (y - h / 2) / z + cv
            bw, bh = fu * l / z, fu * h / z
            x1, y1 = max(u - bw / 2, 0), max(v - bh / 2, 0)
            x2, y2 = min(u + bw / 2, 1241), min(v + bh / 2, 374)
            if x2 - x1 < 10 or y2 - y1 < 10:
                continue
            if any(x1 < px2 and px1 < x2 and y1 < py2 and py1 < y2
                   for px1, py1, px2, py2 in drawn):
                continue
            drawn.append((x1, y1, x2, y2))
            img[int(y1):int(y2), int(x1):int(x2)] = np.array(
                [40 + 70 * j, 255 - 80 * j, (60 + 90 * i + 50 * j) % 256], np.uint8)
            alpha = ry - math.atan2(u - cu, fu)
            lines.append(f"Car 0.0 0 {alpha:.2f} {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} "
                         f"{h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} {z:.2f} {ry:.2f}")
        write_png(root / "training" / "image_2" / f"{i:06d}.png",
                  np.ascontiguousarray(img[..., ::-1]))
        (root / "training" / "label_2" / f"{i:06d}.txt").write_text("\n".join(lines) + "\n")
        (root / "training" / "calib" / f"{i:06d}.txt").write_text(
            f"P2: {KITTI_P2}\nR0_rect: 1 0 0 0 1 0 0 0 1\n"
            "Tr_velo_to_cam: 1 0 0 0 0 1 0 0 0 0 1 0\n")
        ids.append(f"{i:06d}")
    for split in ("train", "val"):
        (root / "ImageSets" / f"{split}.txt").write_text("\n".join(ids) + "\n")
    yaml_path = root / "kitti_mini.yaml"
    yaml_path.write_text(f"path: {root}\ntrain: ImageSets/train.txt\nval: ImageSets/val.txt\n"
                         "names:\n  0: Car\n  1: Pedestrian\n  2: Cyclist\n")
    return yaml_path


def phase_learn3d(card: str) -> dict:
    """The JAX package's 3D learn-proof (tests/test_overfit_ap.py:58-103),
    key for key, through the port on the card: yolov10n-3D trained on 8
    synthetic KITTI frames at 320x96 for 300 epochs (AdamW, lr0 0.003, lrf
    0.2, no warmup, flip, crop or mixup, float32, nbs 8, no validation
    during the run), saving checkpoints; then ``YOLOv10(last.ckpt)`` is
    validated on the same frames and must reach mAP50 >= 0.9 and metrics/3D
    >= 7.0 (JAX calibrated 0.995 and 14.0 here); so must the file stripped
    to float16 (``strip_optimizer``), whose metrics are printed beside the
    float32 file's."""
    import torch

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.kernels import launch_counts, reset_launch_counts
    from yolov10_3d_torch.utils.checkpoint import strip_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data = learn_tree(Path(tmp) / "kitti")
        model = YOLOv10("yolov10n_3D.yaml", device="cuda")
        reset_launch_counts()
        t0 = time.perf_counter()
        state = model.train(data=str(data), epochs=300, imgsz=LEARN3D_RES,
                    kitti_resolution=LEARN3D_RES, batch=8, workers=2, warmup_epochs=0.0,
                    fliplr=0.0, random_crop=0.0, mixup=0.0, patience=10000, amp=False,
                    lr0=0.003, lrf=0.2, optimizer="AdamW", nbs=8, val_period=10**6,
                    max_depth_threshold=60.0, save=True, save_dir=str(Path(tmp) / "run"))
        wall = time.perf_counter() - t0
        with open(Path(tmp) / "run" / "results.csv") as f:
            rows = list(csv.DictReader(f))
        print(f"[learn3d] YOLOv10-n-3D 320x96, 8 frames, batch 8, 300 epochs (AdamW lr0 0.003, "
              f"float32, TF32 off): {wall:.1f} s ({wall / len(rows) * 1e3:.1f} ms an epoch, "
              f"checkpoints included; {card}); loss by epoch: " + ", ".join(
                  f"{r['epoch']}: {float(r['loss']):.4f}" for r in rows
                  if int(r["epoch"]) % 50 == 0 or int(r["epoch"]) == len(rows) - 1))
        last = Path(tmp) / "run" / "weights" / "last.ckpt"
        print(f"[learn3d] last.ckpt {last.stat().st_size / 2**20:.1f} MiB, written every epoch")
        t0 = time.perf_counter()
        res = YOLOv10(str(last), device="cuda").val(data=str(data), batch=8,
                                                     kitti_resolution=LEARN3D_RES,
                                                     save_dir=str(Path(tmp) / "val"))
        got = {k: float(res[k]) for k in LEARN3D_BARS}
        witness = last_ckpt_witness(model, state, last, data, Path(tmp))
        print(f"[learn3d] YOLOv10(last.ckpt).val on the 8 frames ({time.perf_counter() - t0:.1f} "
              f"s): mAP50 {got['mAP50']:.4f} (bar {LEARN3D_BARS['mAP50']}, JAX "
              f"{LEARN3D_JAX['mAP50']}), metrics/3D {got['metrics/3D']:.4f} (bar "
              f"{LEARN3D_BARS['metrics/3D']}, JAX {LEARN3D_JAX['metrics/3D']}), mAP50-95 "
              f"{float(res['mAP50-95']):.4f}; hand-kernel launches {dict(launch_counts)}")
        ema = {k: float(witness["val"][k]) for k in (*LEARN3D_BARS, "mAP50-95")}
        print(f"[learn3d] witness of the writer: last.ckpt's body = the final state's trees "
              f"encoded directly (save_checkpoint of host_copy), {witness['bytes']} bytes, "
              f"byte for byte; the trainer's EMA model before the save validates to "
              + ", ".join(f"{k} {v:.4f}" for k, v in ema.items())
              + f", the reloaded file to "
              + ", ".join(f"{k} {float(res[k]):.4f}" for k in ema))
        if ema != {k: float(res[k]) for k in ema}:
            raise AssertionError(f"learn3d: last.ckpt validates to other metrics than the "
                                 f"trainer's EMA model ({ema})")
        half = Path(tmp) / "last_fp16.ckpt"
        strip_optimizer(last, half)
        res16 = YOLOv10(str(half), device="cuda").val(data=str(data), batch=8,
                                                      kitti_resolution=LEARN3D_RES,
                                                      save_dir=str(Path(tmp) / "val16"))
        got16 = {k: float(res16[k]) for k in LEARN3D_BARS}
        print(f"[learn3d] the file stripped to float16 ({half.stat().st_size / 2**20:.1f} MiB): "
              + ", ".join(f"{k} {got16[k]:.4f} (float32 file {got[k]:.4f}, bar "
                          f"{LEARN3D_BARS[k]})" for k in LEARN3D_BARS)
              + f", mAP50-95 {float(res16['mAP50-95']):.4f} (float32 file "
              f"{float(res['mAP50-95']):.4f}); phase {time.perf_counter() - t_phase:.1f} s")
    missed = {f"{k}{tag}": v for tag, run in (("", got), (" float16", got16))
              for k, v in run.items() if not v >= LEARN3D_BARS[k]}
    if missed:
        raise AssertionError(f"learn3d: the trained 3D net misses its bars {missed} "
                             f"(bars {LEARN3D_BARS})")
    return got


def last_ckpt_witness(model, state, last: Path, data: Path, tmp: Path) -> dict:
    """That the trainer's checkpoint writer wrote the run's end state: the
    body of ``last`` against the same state's trees encoded directly on the
    host (``save_checkpoint`` of ``host_copy``, the path before the
    ``Snapshot`` writer), byte for byte; and the validation of the
    trainer's own EMA model (``model`` after ``train``), to be compared
    with that of the reloaded file."""
    from yolov10_3d_torch.utils.checkpoint import MAGIC, host_copy, save_checkpoint

    direct = tmp / "direct.ckpt"
    save_checkpoint(direct, **host_copy(state.checkpoint_trees()))

    def body(path):
        raw = path.read_bytes()
        return raw[len(MAGIC) + 8 + int.from_bytes(raw[len(MAGIC):len(MAGIC) + 8], "little"):]

    written = body(last)
    if written != body(direct):
        raise AssertionError("learn3d: last.ckpt's body is not the run's end state")
    val = model.val(data=str(data), batch=8, kitti_resolution=LEARN3D_RES,
                    save_dir=str(tmp / "val_ema"))
    return {"bytes": len(written), "val": val}


HOST_AUG_SAMPLES = 32  # [host-aug]'s default-hyp samples, library against twins
HOST_AUG_WARP = {"degrees": 10.0, "shear": 2.0, "perspective": 5e-4, "mosaic9": 0.5}


def _median_ms(fn, n: int) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_host_aug(card: str, data: Path) -> None:
    """The host augmentation's library (``native/host_aug.cc``, built here
    with g++) against its numpy twins (``data/cv2_rules.py``) on this host,
    which has no cv2: host-mode items of the [train] set from one seed,
    32 at the JAX defaults and 8 with warps, perspective and mosaic9, equal
    bit for bit in every key and in the generator's final state; per-op ms
    library against twin; the loader's img/s alone at workers 0, 2, 4."""
    import numpy as np

    from yolov10_3d_torch.cfg import get_cfg
    from yolov10_3d_torch.data import augment as A
    from yolov10_3d_torch.data import cv2_rules
    from yolov10_3d_torch.data.dataset import DataLoader, YOLODataset
    from yolov10_3d_torch.native import host_aug

    t_phase = time.perf_counter()
    host_aug.get_lib()
    print(f"[host-aug] library {host_aug._LIBRARY.path().name} built with g++ "
          f"{' '.join(host_aug.gxx_flags())} in {time.perf_counter() - t_phase:.1f} s")
    images = data.parent / "images"
    hyp = get_cfg()
    sample_ms = {}
    for case, over, n in (("defaults", {}, HOST_AUG_SAMPLES), ("warp", HOST_AUG_WARP, 8)):
        runs = {}
        for name, ops in (("library", A.NATIVE), ("twin", A.TWIN)):
            ds = YOLODataset(images, imgsz=IMGSZ, hyp={**hyp, **over}, seed=11, device_aug=False,
                             ops=ops)
            items, ms = [], []
            for i in range(n):
                t0 = time.perf_counter()
                items.append(ds[(7 * i) % len(ds)])
                ms.append((time.perf_counter() - t0) * 1e3)
            runs[name] = (items, ds.rng.bit_generator.state, ms)
        (lib, lib_state, lib_ms), (twin, twin_state, twin_ms) = runs["library"], runs["twin"]
        bad = [(i, k) for i, (a, b) in enumerate(zip(lib, twin)) for k in a
               if not np.array_equal(a[k], b[k])]
        n_boxes = sum(int(it["mask_gt"].sum()) for it in lib)
        sample_ms[case] = (statistics.median(lib_ms), statistics.median(twin_ms))
        print(f"[host-aug] {case} ({over or 'JAX defaults'}): {n} samples at {IMGSZ}, "
              f"{n_boxes} boxes; library vs twins: {len(bad)} keys differ "
              f"{bad[:6]}, generator state {'equal' if lib_state == twin_state else 'DIFFERS'}; "
              f"ms a sample (decode included), median: library {sample_ms[case][0]:.1f}, "
              f"twins {sample_ms[case][1]:.1f}")
        if bad or lib_state != twin_state:
            raise AssertionError(f"host-aug: the library's items differ from the twins' ({case})")
    rng = np.random.default_rng(0)
    canvas = rng.integers(0, 256, (2 * IMGSZ, 2 * IMGSZ, 3), dtype=np.uint8)
    M = np.array([[0.93, 0.05, -290.0], [-0.04, 1.08, -350.0]])
    tile = np.ascontiguousarray(canvas[:IMGSZ, :IMGSZ])
    lut = np.stack([np.arange(256) % 180, np.clip(np.arange(256) * 1.3, 0, 255),
                    np.arange(256) * 0.7], -1).astype(np.uint8)
    big, out = f"{2 * IMGSZ}²", f"{IMGSZ}²"
    ops = {
        f"warpAffine {big}→{out}": (lambda: host_aug.warp_affine(canvas, M, (IMGSZ, IMGSZ)),
                                  lambda: cv2_rules.warp_affine(canvas, M, (IMGSZ, IMGSZ))),
        f"warpPerspective {big}→{out}": (
            lambda: host_aug.warp_perspective(canvas, np.vstack([M, [1e-4, -2e-4, 1.0]]),
                                              (IMGSZ, IMGSZ)),
            lambda: cv2_rules.warp_perspective(canvas, np.vstack([M, [1e-4, -2e-4, 1.0]]),
                                               (IMGSZ, IMGSZ))),
        f"HSV at {out}": (lambda: host_aug.hsv_lut(tile, lut),
                          lambda: cv2_rules.hsv_lut(tile, lut)),
    }
    parts = []
    for name, (lib_fn, twin_fn) in ops.items():
        if not np.array_equal(lib_fn(), twin_fn()):
            raise AssertionError(f"host-aug: {name} differs from its twin")
        parts.append(f"{name} {_median_ms(lib_fn, 7):.2f} / {_median_ms(twin_fn, 2):.1f}")
    print("[host-aug] ms, library / twin (median): " + "; ".join(parts) + "; one train_augment "
          f"sample (defaults) {sample_ms['defaults'][0]:.1f} / {sample_ms['defaults'][1]:.1f}")
    rates = []
    for workers in (0, 2, 4):
        loader = DataLoader(YOLODataset(images, imgsz=IMGSZ, hyp=hyp, seed=3, device_aug=False),
                            16, seed=3, workers=workers)
        it = iter(loader)
        next(it)  # the threads started, the buffer warm
        t0 = time.perf_counter()
        n = sum(len(b["img"]) for b in itertools.islice(it, 5))
        rates.append(f"workers {workers}: {n / (time.perf_counter() - t0):.1f}")
        it.close()
    print(f"[host-aug] the loader alone, YOLOv10-S's batch of 16 at {IMGSZ}, JAX defaults, img/s "
          f"(up to 5 batches after the first): {'; '.join(rates)} (os.cpu_count() "
          f"{os.cpu_count()}); "
          f"phase {time.perf_counter() - t_phase:.1f} s ({card})")


@contextlib.contextmanager
def batch_kinds(record: list):
    """Inside: every batch a DetectionTrainer moves to the device appends
    (epoch, a tile batch?) to ``record``."""
    from yolov10_3d_torch.engine.trainer import DetectionTrainer

    real = DetectionTrainer.to_device

    def recording(self, batch):
        record.append((self.epoch, "tiles" in batch))
        return real(self, batch)

    DetectionTrainer.to_device = recording
    try:
        yield
    finally:
        DetectionTrainer.to_device = real


def phase_train_host(card: str, data: Path) -> dict:
    """``YOLOv10("yolov10s.yaml").train`` at the JAX defaults on the [train]
    set (host augmentation, amp, 640², batch 16, workers 4): 2 epochs with
    close_mosaic=1, so that epoch 2 runs the letterbox path; ms a step in
    the loop and with no loader, img/s and the loader-wait share an epoch,
    the device's busy and idle share (torch.profiler, 3 steady steps).
    Then device_aug=True with close_mosaic=1 on half the set for 2 epochs:
    tiles and K4 in epoch 1, host batches in epoch 2. Returns the launches."""
    import torch

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.kernels import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        times, kinds = [], []
        model = YOLOv10("yolov10s.yaml")
        reset_launch_counts()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        profiled = (6, 7, 8)
        t0 = time.perf_counter()
        with timed_train_steps(times, prof, profiled), batch_kinds(kinds):
            state = model.train(data=str(data), imgsz=IMGSZ, batch=16, epochs=2, close_mosaic=1,
                                val=False, save=False, workers=4, save_dir=str(Path(tmp) / "host"))
        wall = time.perf_counter() - t0
        counts = dict(launch_counts)
        with open(Path(tmp) / "host" / "results.csv") as f:
            rows = list(csv.DictReader(f))
        per_epoch = len(times) // 2
        if (counts["hsv_jitter"] or any(tiles for _, tiles in kinds) or len(rows) != 2
                or model.trainer.train_ds.hyp["mosaic"] != 0.0):
            raise AssertionError(f"train-host: {counts}, tile batches "
                                 f"{sum(t for _, t in kinds)}, {len(rows)} epochs")
        terms = {k: float(v) for k, v in rows[-1].items() if k not in ("epoch", "time", "lr")}
        if not all(math.isfinite(float(v)) for r in rows for k, v in r.items() if k != "epoch"):
            raise AssertionError(f"train-host: non-finite epoch means {rows}")
        parts = []
        for e, r in enumerate(rows):
            ep = times[e * per_epoch:(e + 1) * per_epoch]
            steady = [t for i, t in enumerate(ep) if (i >= 2 or e) and e * per_epoch + i
                      not in profiled] or ep
            secs = float(r["time"])
            parts.append(f"epoch {e + 1} ({'mosaic' if e == 0 else 'closed: letterbox'}): "
                         f"median {statistics.median(steady):.1f} ms/step in the loop "
                         f"({', '.join(f'{t:.0f}' for t in ep)}), {16 * len(ep) / secs:.1f} "
                         f"img/s, loader-wait share {max(0.0, 1 - sum(ep) / 1e3 / secs):.3f}")
        traced = sum(times[i] for i in profiled)
        iso = isolated_steps(model.trainer, True)
        ref = TRAIN_FIGURES
        print(f"[train-host] YOLOv10-S at the JAX defaults (host augmentation, amp), batch 16 at "
              f"{IMGSZ}, 2 epochs, close_mosaic=1, workers 4: " + "; ".join(parts)
              + f"; call {wall:.1f} s ({card})")
        print(f"[train-host] profile of steps {[i + 1 for i in profiled]} (mosaic epoch; "
              f"traced {traced / len(profiled):.1f} ms/step): "
              f"{profile_report(prof, traced, len(profiled))}")
        print(f"[train-host] the same step with no loader (a cached letterbox batch, "
              f"{len(iso)} steps): median {statistics.median(iso):.1f} ms/step; beside "
              f"[train]'s device augmentation in this run: {ref.get('loop_ms', float('nan')):.1f} "
              f"ms/step in the loop, {ref.get('iso_ms', float('nan')):.1f} with no loader, "
              f"{ref.get('img_s', float('nan')):.1f} img/s an epoch, idle "
              f"{ref.get('idle') or 'not measured'}; loss means {terms}")
        kinds.clear()
        reset_launch_counts()
        with batch_kinds(kinds):
            state = YOLOv10("yolov10s.yaml").train(
                data=str(data), imgsz=IMGSZ, batch=16, epochs=2, close_mosaic=1, device_aug=True,
                fraction=0.5, val=False, save=False, workers=4, save_dir=str(Path(tmp) / "dev"))
        k4 = launch_counts["hsv_jitter"]
        want = [(0, True)] * (state.step // 2) + [(1, False)] * (state.step // 2)
        print(f"[train-host] device_aug=True, close_mosaic=1, half the set, 2 epochs: batches "
              f"(epoch, tiles) {kinds}; K4 launches {k4} ({card})")
        if kinds != want or k4 != state.step // 2:
            raise AssertionError(f"train-host: device_aug run saw {kinds}, K4 {k4}")
        counts["hsv_jitter"] += k4
    print(f"[train-host] phase {time.perf_counter() - t_phase:.1f} s")
    return counts


LEARN2D_BARS = {"mAP50": 0.9, "mp": 0.8}  # tests/test_overfit_ap.py:220-223
LEARN2D_EPOCHS = 900  # the JAX recipe's
# tests/test_overfit_ap.py:194-217, key for key (epochs apart); plus save=True
LEARN2D_RECIPE = dict(imgsz=64, batch=8, workers=2, warmup_epochs=0.0, close_mosaic=0,
                      mosaic=0.0, mixup=0.0, fliplr=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0,
                      scale=0.0, translate=0.0, patience=10000, amp=False, lr0=0.003, lrf=0.2,
                      optimizer="AdamW", nbs=8, val_period=10**6, save=True)
LEARN2D_JAX = 0.995  # JAX's calibration of mAP50 at this recipe


def overfit2d_tree(root: Path, n: int = 8) -> Path:
    """A numpy mirror of tests/_helpers.py ``make_overfit2d_tree``: the same
    draws, 96x96 frames of grey 30 with two solid red or green rectangles in
    disjoint halves, val == train, written as JPEG by the port's encoder in
    cv2's style: the bytes of the helper's ``cv2.imwrite`` (held equal in
    tests/test_torch_codec.py)."""
    import numpy as np

    from yolov10_3d_torch.data.image_io import encode_jpeg

    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            r = np.random.default_rng(i)
            img = np.full((96, 96, 3), 30, np.uint8)
            lines = []
            for x0, x1lim in ((2, 44), (50, 92)):
                c = int(r.integers(0, 2))
                w = min(int(r.integers(24, 40)), x1lim - x0)
                h = int(r.integers(24, 44))
                x1 = x0 + int(r.integers(0, max(x1lim - x0 - w, 1)))
                y1 = int(r.integers(2, 96 - h - 2))
                img[y1:y1 + h, x1:x1 + w] = (220, 40, 40) if c == 0 else (40, 220, 40)
                lines.append(f"{c} {(x1 + w / 2) / 96:.6f} {(y1 + h / 2) / 96:.6f} "
                             f"{w / 96:.6f} {h / 96:.6f}")
            (root / "images" / split / f"{i}.jpg").write_bytes(encode_jpeg(img, "cv2"))
            (root / "labels" / split / f"{i}.txt").write_text("\n".join(lines))
    (root / "data.yaml").write_text(f"path: {root}\ntrain: images/train\nval: images/val\n"
                                    "names:\n  0: red\n  1: green\n")
    return root / "data.yaml"


def predict_map50(model, root: Path, int8: bool) -> dict:
    """``model.predict`` on the frames of ``root``'s val split (imgsz 64,
    conf 0.001, max_det 300), scored by the port's ``utils/metrics.py``
    against the label files."""
    import numpy as np

    from yolov10_3d_torch.data.image_io import imread
    from yolov10_3d_torch.utils.metrics import DetMetrics

    metrics = DetMetrics(nc=2)
    for path in sorted((root / "images" / "val").glob("*.jpg")):
        img = imread(path)
        (res,) = model.predict(img, imgsz=64, conf=0.001, max_det=300, int8=int8)
        lab = np.loadtxt(root / "labels" / "val" / f"{path.stem}.txt", ndmin=2)
        h, w = img.shape[:2]
        xywh = lab[:, 1:5] * [w, h, w, h]
        gt = np.concatenate([xywh[:, :2] - xywh[:, 2:] / 2, xywh[:, :2] + xywh[:, 2:] / 2], 1)
        d = res.boxes.data
        metrics.process_batch(d[:, :4], d[:, 4], d[:, 5], gt, lab[:, 0])
    return metrics.results()


def phase_learn2d(card: str) -> dict:
    """The JAX package's 2D learn-proof (tests/test_overfit_ap.py:188-223),
    key for key, through the port on the card: yolov10n on 8 frames at 64²,
    900 epochs, batch 8, no mosaic (the host letterbox path), AdamW lr0
    0.003, lrf 0.2, float32, nbs 8, no validation during the run; plus
    save=True. ``YOLOv10(last.ckpt).val`` on the same frames must reach
    mAP50 >= 0.9 and mp >= 0.8 (JAX calibrated mAP50 0.995). Then the int8
    reference: the trained file served with ``predict(int8=True)`` (K2, K3,
    ``int8_conv_f32`` on trained weights) and scored by ``utils/metrics.py``
    must reach mAP50 >= 0.9; the float32 predict is scored the same way.
    Returns the hand kernels' launches of the reload, val and predicts."""
    import torch

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.kernels import launch_counts, reset_launch_counts

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "overfit"
        data = overfit2d_tree(root)
        model = YOLOv10("yolov10n.yaml", device="cuda")
        t0 = time.perf_counter()
        model.train(data=str(data), epochs=LEARN2D_EPOCHS, save_dir=str(Path(tmp) / "run"),
                    **LEARN2D_RECIPE)
        wall = time.perf_counter() - t0
        with open(Path(tmp) / "run" / "results.csv") as f:
            rows = list(csv.DictReader(f))
        print(f"[learn2d] yolov10n 64², 8 frames (JPEG, the JAX test's cv2.imwrite bytes), batch 8, {len(rows)} epochs (AdamW lr0 0.003, float32, TF32 off, "
              f"no mosaic): {wall:.1f} s ({wall / len(rows) * 1e3:.1f} ms an epoch, checkpoints "
              f"included; {card}); loss by epoch: " + ", ".join(
                  f"{r['epoch']}: {float(r['loss']):.4f}" for r in rows
                  if int(r["epoch"]) % 100 == 0 or int(r["epoch"]) == len(rows) - 1))
        last = Path(tmp) / "run" / "weights" / "last.ckpt"
        reset_launch_counts()
        t0 = time.perf_counter()
        trained = YOLOv10(str(last), device="cuda")
        res = trained.val(data=str(data), imgsz=64, batch=8)
        got = {k: float(res[k]) for k in LEARN2D_BARS}
        print(f"[learn2d] last.ckpt {last.stat().st_size / 2**20:.1f} MiB; YOLOv10(last.ckpt).val "
              f"on the 8 frames ({time.perf_counter() - t0:.1f} s): mAP50 {got['mAP50']:.4f} "
              f"(bar {LEARN2D_BARS['mAP50']}, JAX {LEARN2D_JAX}), mp {got['mp']:.4f} (bar "
              f"{LEARN2D_BARS['mp']}), mr {float(res['mr']):.4f}, mAP50-95 "
              f"{float(res['mAP50-95']):.4f}")
        scored = {int8: predict_map50(trained, root, int8) for int8 in (False, True)}
        counts = dict(launch_counts)
        print(f"[learn2d] the int8 reference: predict(int8=True) on the 8 frames, scored by "
              f"utils/metrics.py: mAP50 {scored[True]['mAP50']:.4f} (bar 0.9), mp "
              f"{scored[True]['mp']:.4f}, mAP50-95 {scored[True]['mAP50-95']:.4f}; float32 "
              f"predict the same way: mAP50 {scored[False]['mAP50']:.4f}, mp "
              f"{scored[False]['mp']:.4f}, mAP50-95 {scored[False]['mAP50-95']:.4f}; hand-kernel "
              f"launches of the reload, val and predicts {counts}; phase "
              f"{time.perf_counter() - t_phase:.1f} s")
    missed = {k: v for k, v in got.items() if not v >= LEARN2D_BARS[k]}
    if not scored[True]["mAP50"] >= LEARN2D_BARS["mAP50"]:
        missed["int8 mAP50"] = scored[True]["mAP50"]
    if missed:
        raise AssertionError(f"learn2d: the trained 2D net misses its bars {missed}")
    if not all(counts[k] for k in ("decode_detect", "int8_mm_fused", "int8_conv3x3_fused",
                                   "int8_conv_f32", "stem_conv")):
        raise AssertionError(f"learn2d: a kernel of the path did not launch: {counts}")
    return counts


def from_layer0(model, x, y0):
    """``model``'s dense one2one maps of ``x`` with layer 0's output
    replaced by ``y0``."""
    hook = model.model[0].register_forward_hook(lambda m, a, out: y0)
    try:
        return model(x, fast_eval=True)["one2one"]
    finally:
        hook.remove()


def std05_stem_witness(gpu, x) -> None:
    """Where a miss of ``std05_vs_float64`` comes from, per branch against
    the CPU's float64 run: the card's float64 forward (does the card's path
    compute the CPU's function?); layer 0's output by each route (the stem
    kernel, its twin on the CPU, the unfused conv + BatchNorm + SiLU on the
    card and on the CPU), its distance from float64, and the maps when it is
    run on in float64 (layer 0's rounding alone); and float64's layer 0 run
    on in the card's and the CPU's float32 (the rest's rounding alone)."""
    import torch

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.kernels.stem import stem_conv_torch

    nc = gpu.spec.nc
    cpu = YOLOv10("yolov10s_3D.yaml", device="cpu", seed=0)
    cpu.model.load_state_dict(gpu.model.state_dict())
    xc = x.cpu()
    m64 = copy.deepcopy(cpu.model).double()
    fmt = lambda g: ", ".join(f"{k} {v:.3g}" for k, v in g.items())  # noqa: E731
    with torch.inference_mode():
        ref = m64(xc.double(), fast_eval=True)["one2one"]
        card64 = copy.deepcopy(gpu.model).double()(x.double(), fast_eval=True)["one2one"]
        print("[sweep] serve3d-std05 witness: the card's float64 forward vs the CPU's (max abs): "
              + fmt(branch_gaps_3d(card64, ref, nc)))
        del card64
        y64 = m64.model[0](xc.double())
        layer0 = {"the stem kernel": gpu.model.model[0].fused_stem(x),
                  "its twin on the CPU": cpu.model.model[0].fused_stem(xc),
                  "the unfused stem on the card": gpu.model.model[0](x),
                  "the unfused stem on the CPU": cpu.model.model[0](xc)}
        for name, y in layer0.items():
            y = y.cpu().double()
            print(f"[sweep] serve3d-std05 witness: layer 0 by {name}, max abs "
                  f"{float((y - y64).abs().max()):.3g} from float64's; run on in float64, the "
                  f"maps vs the CPU's float64 run: " + fmt(branch_gaps_3d(
                      from_layer0(m64, xc.double(), y), ref, nc)))
        _, w, b = gpu.model.model[0].stem_cache  # folded on the card
        _, wc, bc = cpu.model.model[0].stem_cache  # folded on the CPU
        kern = layer0["the stem kernel"].cpu()
        print(f"[sweep] serve3d-std05 witness: the stem kernel vs its twin on the CPU, layer 0 max "
              f"abs {float((kern - layer0['its twin on the CPU']).abs().max()):.3g}; vs the twin "
              f"on the CPU with the card's folded weights "
              f"{float((kern - stem_conv_torch(xc, w.cpu(), b.cpu())).abs().max()):.3g}; the "
              f"BatchNorm folded on the card vs on the CPU: weights max abs "
              f"{float((w.cpu() - wc).abs().max()):.3g}, bias {float((b.cpu() - bc).abs().max()):.3g}")
        for name, model, xin in (("card", gpu.model, x), ("CPU", cpu.model, xc)):
            got = from_layer0(model, xin, y64.float().to(xin.device))
            print(f"[sweep] serve3d-std05 witness: float64's layer 0 run on in the {name}'s "
                  f"float32, the maps vs the CPU's float64 run: " + fmt(branch_gaps_3d(got, ref, nc)))


def serve3d_std05_witness() -> None:
    """[serve3d]'s BatchNorm std 0.5 check (``std05_vs_float64``) on the
    same seeded coarse noise upsampled by ``resize_linear`` (cv2's rule)
    instead of ``smooth_images``' own edge rule: printed, not held (ROADMAP
    queue 3); then ``std05_stem_witness`` on those frames."""
    import numpy as np
    import torch

    from yolov10_3d_torch.data.preprocess import resize_linear
    from yolov10_3d_torch.ops.preprocess import serve_preprocess

    rng = np.random.default_rng(3)
    frames = [resize_linear(rng.integers(0, 256, (375 // 8, 1242 // 8, 3), dtype=np.uint8),
                            (1242, 375)) for _ in range(8)]
    x = serve_preprocess(torch.from_numpy(np.stack(frames)).cuda(), KITTI_HW)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = std05_net(x)
    try:
        std05_vs_float64(gpu, frames, x, [KITTI_HW[1], KITTI_HW[0]])
        print("[sweep] serve3d-std05 on cv2-upsampled frames: within the bar")
    except AssertionError as e:
        print(f"[sweep] serve3d-std05 on cv2-upsampled frames: {e}")
    t0 = time.perf_counter()
    std05_stem_witness(gpu, x)
    print(f"[sweep] serve3d-std05 witness took {time.perf_counter() - t0:.1f} s")


def learn2d_epoch_sweep(card: str, epochs: int = 60) -> None:
    """Where [learn2d]'s epoch goes: its recipe for ``epochs`` epochs with
    save=False, with save=True, and with save=True but the writer's submits
    dropped (the snapshot alone), twice each in turns: ms an epoch, the
    step's median (host clock between synchronisations), the snapshot's
    and the writer's median ms."""
    import torch

    from yolov10_3d_torch import YOLOv10
    from yolov10_3d_torch.utils.checkpoint import AsyncCheckpointer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    real_submit = AsyncCheckpointer.submit
    with tempfile.TemporaryDirectory() as tmp:
        data = overfit2d_tree(Path(tmp) / "overfit")
        for run, (name, save) in enumerate([("save off", False), ("save on", True),
                                            ("snapshot only", True)] * 2):
            times = []
            if name == "snapshot only":
                AsyncCheckpointer.submit = lambda self, path, **kw: None
            try:
                model = YOLOv10("yolov10n.yaml", device="cuda")
                t0 = time.perf_counter()
                with timed_train_steps(times):
                    model.train(data=str(data), epochs=epochs, save_dir=f"{tmp}/{run}",
                                **{**LEARN2D_RECIPE, "save": save})
                wall = time.perf_counter() - t0
            finally:
                AsyncCheckpointer.submit = real_submit
            trainer = model.trainer
            writes = trainer._ckpt_writer.write_seconds if trainer._ckpt_writer else []
            print(f"[sweep] learn2d-epoch {name}: {wall / epochs * 1e3:.1f} ms an epoch, the step "
                  f"{statistics.median(times[5:]):.1f} ms (median), the snapshot "
                  f"{statistics.median(trainer.snapshot_ms or [0.0]):.1f} ms, the writer "
                  f"{statistics.median(writes or [0.0]) * 1e3:.1f} ms a save ({epochs} epochs; "
                  f"{card})")


SWEEPS = {"int8": "int8_conv", "k2tiles": "int8_conv", "stem": "stem_conv",
          "k1": "decode_detect", "val2d-std05": "decode_detect", "learn2d-epoch": "decode_detect",
          "serve3d-std05": "stem_conv"}


def sweep_only(argv) -> int:
    """``--sweep NAMES [--package-root DIR]``: the card line, the build of
    the named kernels' sources with their registers and spills, and their
    timings alone, with the ``yolov10_3d_torch`` package found under DIR. NAMES is a comma-separated
    subset of int8 (phase 3b, then K2 at both sites at B=1, 8 and 32 beside
    torch._int_mm), k2tiles (every tile K2 compiles at those six shapes),
    stem (the stem at 640x640, B=1 and 32, beside cuDNN), k1 (B=1 and
    32), val2d-std05 (``val2d_std05_witness``), learn2d-epoch
    (``learn2d_epoch_sweep``) and serve3d-std05 (``serve3d_std05_witness``),
    so that two checkouts' kernels are timed in one call on one card;
    "serve" adds the device kernels of one float32 request (which builds
    every source)."""
    names = argv[argv.index("--sweep") + 1].split(",")
    unknown = set(names) - set(SWEEPS) - {"serve"}
    if unknown:
        raise SystemExit(f"--sweep takes {sorted(SWEEPS)} and serve, got {sorted(unknown)}")
    root = Path(argv[argv.index("--package-root") + 1]) if "--package-root" in argv \
        else Path(__file__).resolve().parent
    sys.path.insert(0, str(root.resolve()))
    card = phase_card()
    print(f"[sweep] {','.join(names)} with the package under {root}")
    phase_build(None if "serve" in names else sorted({SWEEPS[n] for n in names}))
    if "stem" in names:
        check_stem(1, IMGSZ, IMGSZ)
        check_stem(32, IMGSZ, IMGSZ)
    if "k1" in names:
        check_k1(1)
        check_k1(32)
    if "int8" in names:
        phase_int8_layers(card)
        k2_sites()
    if "k2tiles" in names:
        k2_tile_sweep()
    if "val2d-std05" in names:
        val2d_std05_witness(card)
    if "learn2d-epoch" in names:
        learn2d_epoch_sweep(card)
    if "serve3d-std05" in names:
        serve3d_std05_witness()
    if "serve" in names:
        request_kernels()
    print(card_line())
    return 0


def train_set(root: Path) -> Path:
    """[train]'s synthetic set, written under ``root``."""
    t0 = time.perf_counter()
    data = synthetic_set(root / "set")
    n_img = len(list(data.parent.glob("images/*.png")))
    print(f"[train] synthetic set: {n_img} PNGs 640x480 written in "
          f"{time.perf_counter() - t0:.1f} s")
    return data


def main() -> int:
    t0 = time.perf_counter()
    if "--sweep" in sys.argv:
        return sweep_only(sys.argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if "--ckpt-pair" in sys.argv:  # the child process of [ckpt]
        print(json.dumps(ckpt_pair(Path(sys.argv[sys.argv.index("--ckpt-pair") + 1]))))
        return 0
    card = phase_card()
    import torch

    import yolov10_3d_torch  # noqa: F401  (fails outside a checkout of the repo)

    def done(phase: str) -> None:
        print(f"[time] {phase} done at {time.perf_counter() - t0:.1f} s")

    phase_build()
    kern = phase_kernels()
    done("build, kernels")
    sweep = phase_int8_layers(card)
    serving, medians = phase_serving(card)
    done("int8-layers, serve")
    print(f"[int8-layers] per forward, the {sweep[1]['launches']} K2, K3 and "
          f"int8_conv_f32 launches: B=1 {sweep[1]['ms']:.4f} ms, B=8 {sweep[8]['ms']:.4f} ms "
          f"of device time | request medians: b1_640_int8 {medians['b1_640_int8']:.2f} ms, "
          f"uniform_b8_int8 {medians['uniform_b8_int8']:.2f} ms")
    serve3d = phase_serve3d(card)
    done("serve3d")
    server = phase_server(card)
    done("server")
    sources = phase_sources(card)
    done("sources")
    phase_val3d(card)
    done("val3d")
    failed = []
    try:  # the train phase runs even when the lockstep misses a bar; both are fatal
        phase_train_lockstep(card)
    except AssertionError as e:
        failed.append(f"train-lockstep: {e}")
        print(f"[train-lockstep] FAILED: {e}")
    with tempfile.TemporaryDirectory() as tmp:
        data = train_set(Path(tmp))
        train = phase_train(card, data)
        done("train-lockstep, train")
        phase_host_aug(card, data)
        done("host-aug")
        train_host = phase_train_host(card, data)
        done("train-host")
    try:  # as above: [train3d] runs even when its lockstep misses a bar
        phase_train3d_lockstep(card)
    except AssertionError as e:
        failed.append(f"train3d-lockstep: {e}")
        print(f"[train3d-lockstep] FAILED: {e}")
    phase_train3d(card)
    done("train3d-lockstep, train3d")
    if failed:
        raise AssertionError("; ".join(failed))
    with tempfile.TemporaryDirectory() as tmp:
        data = synthetic_set(Path(tmp) / "set", n=CKPT_SET, seed=1)
        ckpt = phase_ckpt(card, data)
        done("ckpt")
        val2d = phase_val2d(card, data)
        done("val2d")
    phase_learn3d(card)
    done("learn3d")
    learn2d = phase_learn2d(card)
    done("learn2d")
    launches = {**{k: serving[k] for k in SERVING_KERNELS}, **{k: train[k] for k in TRAIN_KERNELS}}
    # K4 and K1; K1 and the stem; K1; K4; K1, the stem, K2, K3 and int8_conv_f32
    for counts in (ckpt["train"], ckpt["reload"], val2d, train_host, learn2d):
        for k in KERNELS:
            launches[k] += counts[k]
    for k in SERVE3D_KERNELS:  # the 3D requests run the stem kernel too
        launches[k] += serve3d[k]
    for k in SERVER_KERNELS:  # and the server's traffic K1 and the stem
        launches[k] += server[k]
    for k in SOURCES_KERNELS:  # and prediction over files
        launches[k] += sources[k]
    if not set(KERNELS) == set(kern) == set(launches) == set(serving):
        raise AssertionError(f"kernel tables disagree: {set(KERNELS)}, {set(kern)}, {set(launches)}")
    entries = [
        {"name": name, **KERNELS[name], "launches": launches[name], **b1,
         "large": {k: big[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "library_ms", "eager_call_ms")}}
        for name, (b1, big) in kern.items()
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
