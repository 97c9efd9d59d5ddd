#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build the Hopper kernels,
hold each against its plain PyTorch version, serve full-width detections
over HTTP, and check what comes out.

    python3 chip_smoke.py

Phases (each prints one progress line with its wall time):
  1. device   the card's name and power limit; fails without CUDA
  2. build    nvcc builds simple_sfod_tpu_torch/ops/csrc/nms.cu while g++
              builds the host libraries (the image codec, the C++ COCO
              evaluator); each kernel's registers, shared memory and spills
              (-Xptxas -v)
  3. kernels  suppress_relation_bits and greedy_keep_from_bits against their
              plain versions on seeded boxes (ties, invalid and zero-area
              boxes, class-offset boxes, N up to 8192 and N = 4097, and
              N = 12288, above the keep kernel's shared-memory route) and on
              cases built to break them (IoUs at the threshold's rounding
              boundaries, a suppression chain, identical boxes, disjoint
              boxes); bitmasks and keep masks must be equal bit for bit
  4. serve    the main configuration (VGG16-BN, 8 classes, 608x1216 canvas,
              bfloat16) with seeded weights behind the HTTP server; 4
              requests of seeded 600x1200 uint8 images, two of them
              concurrent, then a 1024x2048 frame sent as a PNG file (decoded
              and resized by the native codec); both NMS kernels must launch
              for every image, and on the NMS inputs captured from one
              request kernel and plain keep masks must be equal
  5. profile  the served detector without HTTP: median latency at batch 1
              and 2, then one image under torch.profiler (device time, busy
              share, top kernels and ops, peak memory)
  6. check    the same weights in float32 on a small canvas: the card's
              detections agree with the port's CPU path (which the CPU tests
              hold to the JAX package)
  7. timing   each kernel on the captured inputs: its device time (profiler),
              its time a call (CUDA events over back-to-back calls), its
              plain version's time and its bound
  8. train    the supervised source-training configuration
              (configs/faster_rcnn_VGG_cityscapes_source_new.yaml: base
              trainer, VGG16-BN, 608x1216, batch 1) at full width and depth
              from seeded weights, with synthetic ground truth on a
              600x1200 image: 12 steps on one repeated batch in float32 and
              in bfloat16 (finite losses every step, a lower total loss
              after 10 steps, one launch of each NMS kernel per image and
              step, median step time of the last 10), the train-mode RPN
              NMS inputs bit-equal between kernel and plain version, one
              bfloat16 step under torch.profiler, and one float32 step on
              the card against the same step on the CPU at 256x512
  9. adapt    the main path: the source-free adaptive-teacher step at full
              width from seeded weights (the class-1 logit bias raised by 4,
              so random weights give pseudo-labels above 0.8; the student's
              bbox_pred bias offset by 1e-2 from the teacher's) on one
              synthetic 600x1200 target image: 12 bfloat16 steps of the main
              variant on the adaptation benchmark's configuration (strong
              view, adaptive threshold, fixed bfloat16 teacher), 12 on the
              main configuration (domain classifiers built and zero-weighted),
              6 of `source_free_adaptive_teacher_single` (EMA, float32
              teacher); finite losses, pseudo-labels, the fixed teacher's
              parameters unchanged and its statistics moved, the EMA rule,
              exactly 3 launches of each NMS kernel per image and step, the
              three NMS inputs of one step bit-equal between kernel and plain
              version, the strong view against the CPU's on the same draws,
              one step under set_sync_debug_mode("error"), one step under
              torch.profiler, and one float32 step on the card against the
              CPU's at 128x256 (and at 256x512, reported: random weights'
              tied scores make the top-k cuts there differ)
 10. eval     the target domain from disk: 16 synthetic
              1024x2048 records written as PNG with a COCO JSON, registered
              as the main configuration's two DATASETS.TEST names and its
              TRAIN_TARGET; the first PNG decode bit-equal to the array
              written; 4 bfloat16 adaptation steps of the main variant on
              MAIN_CONFIG from trainer.build_train_loader() (decoded and
              resized natively to 600x1200 on the 608x1216 canvas); then
              trainer.test(): student and teacher on both datasets, exactly
              2 launches of each NMS kernel per image and evaluated model
              (128 of each), eval_results.json with 4 entries of finite AP,
              AP50 and F1; the native COCO result equal to the plain
              coco_map on the same records (1e-9); a dispatch under
              set_sync_debug_mode("error"); images/s of the whole eval loop
              at pipeline depth 1 and 4, one pass under torch.profiler (busy
              share), peak memory, host decode+resize ms an image; and a
              float32 eval loop on 4 images at 128x256 on the card against
              the CPU's

Prints the card's name and power limit and a JSON line of the kernels'
numbers, then, as the last line, {"ok": true, "device": {...}}. Any failure
raises and the exit code is not 0.
"""

from __future__ import annotations

import io
import json
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib

import numpy as np
import torch

from simple_sfod_tpu_torch import host_libs
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg, get_main_cfg, get_source_cfg
from simple_sfod_tpu_torch.config.defaults import MAIN_CONFIG, SFAT_BENCH_CONFIG, config_opts
from simple_sfod_tpu_torch.data import native_codec, transforms
from simple_sfod_tpu_torch.data.datasets import CITYSCAPES_THING_CLASSES, register_dataset
from simple_sfod_tpu_torch.data.loader import build_test_loader
from simple_sfod_tpu_torch.data.synthetic import make_synthetic_records, synthetic_batch, synthetic_bench_batch, synthetic_image
from simple_sfod_tpu_torch.engine.eval_loop import Staging, inference_on_dataset
from simple_sfod_tpu_torch.engine.serve import DetectionService, serve_in_thread
from simple_sfod_tpu_torch.evaluation import COCOEvaluator, F1Evaluator, coco_map
from simple_sfod_tpu_torch.evaluation.native import coco_map_native
from simple_sfod_tpu_torch.engine.train_state import ema_tensors
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from simple_sfod_tpu_torch.engine.trainers.base import BaseTrainer
from simple_sfod_tpu_torch.models.detector import Detector
from simple_sfod_tpu_torch.models.faster_rcnn import FasterRCNN, init_weights
from simple_sfod_tpu_torch.ops import _kernels, nms

SEED = 0
N_REQUESTS = 4
IMAGE_HW = (600, 1200)  # Cityscapes' 1024x2048 after the shortest-edge-600 resize
FRAME_HW = (1024, 2048)  # a Cityscapes frame
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 flop/s
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# training: steps on one repeated batch, of which the last TIMED are timed;
# the loss must fall over the first 10 updates
TRAIN_STEPS = 12
TIMED = 10
# the solver of the training phase: the source config's own, without its
# 1000-step warmup (which would keep the LR near 0 for the whole phase)
TRAIN_SOLVER = {"SOLVER.WARMUP_ITERS": "0", "SOLVER.BASE_LR": "0.01"}
TRAIN_LOSSES = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "total_loss")
# the card's float32 step against the CPU's: per-loss relative error (the
# proposals inherit the RPN deltas' rounding scaled by anchors up to 512 px,
# and the box-regression targets scale that again by 10 / proposal width);
# each other parameter within PARAM_REL of its tensor's largest entry plus
# PARAM_MOVE of how far the step moved it (a ReLU that flips sign on
# rounding moves a channel's gradient by percents on small feature maps);
# BatchNorm running statistics relative to their largest entry
# (the conv biases that feed a BatchNorm have an exact gradient of 0: each
# must move less than BN_FED_BIAS_TOL times as far as its conv's weight)
LOSS_TOL = 1e-3
PARAM_REL, PARAM_MOVE = 1e-4, 0.25
BN_TOL = 1e-4
BN_FED_BIAS_TOL = 1e-3
# adaptation: steps of the main variant (the last TIMED timed) and of
# `_single`; the cuts of the configurations: the adaptive threshold's warm-up
# at 4 steps (100 in the configuration), so that its branch runs; no
# 1000-step LR warmup, at the main YAML's LR 0.0025
ADAPT_STEPS = 12
SINGLE_STEPS = 6
ADAPT_CUTS = {"ADAPTIVE_THRESHOLD.WARM_UP": "4", "SOLVER.WARMUP_ITERS": "0", "SOLVER.BASE_LR": "0.0025"}
ADAPT_LOSSES = ("loss_rpn_cls_pseudo", "loss_rpn_loc_pseudo", "loss_cls_pseudo", "loss_box_reg_pseudo",
                "loss_bpc_pseudo", "total_loss")
CLS_BIAS_BOOST = 4.0  # added to the class-1 logit bias: softmax ~0.87 > BBOX_THRESHOLD 0.8
BBOX_OFFSET = 1e-2  # the student's regression biases against the teacher's
# eval: the target domain on disk, Cityscapes-sized; steps adapted from the
# loader before trainer.test(); the float32 card-vs-CPU eval loop's size
EVAL_IMAGES = 16
EVAL_STEPS = 4
EVAL_SMALL = dict(images=4, hw=(100, 200), canvas=(128, 256), min_size=120)
# float32 operations per (i < j, both valid) pair of the relation: 2 max,
# 2 min, 2 sub, 2 clamp, 1 mul (intersection), 2 add/sub (union), 1 div,
# 1 compare; the areas are per box, not per pair
OPS_PER_PAIR = 13


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            log(f"[phase] {self.name}: ok in {time.perf_counter() - self.t0:.2f} s")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- kernel cases
def case_boxes(rng: np.random.RandomState, n: int, n_valid: int, extent=(608.0, 1216.0), classes=0):
    """Seeded boxes with exact score ties, zero-area and invalid boxes, and
    (classes > 0) the class-offset shift of batched_class_nms."""
    h, w = extent
    cx = rng.uniform(0, w, n)
    cy = rng.uniform(0, h, n)
    bw = rng.uniform(4, 300, n)
    bh = rng.uniform(4, 200, n)
    # clusters of near-duplicates, as an RPN produces around objects
    dup = rng.rand(n) < 0.5
    src = rng.randint(0, max(n // 8, 1), n)
    cx[dup] = cx[src[dup]] + rng.normal(0, 6, dup.sum())
    cy[dup] = cy[src[dup]] + rng.normal(0, 6, dup.sum())
    boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1).astype(np.float32)
    boxes[::11, 2] = boxes[::11, 0]  # zero width
    scores = np.round(rng.uniform(0, 1, n), 3).astype(np.float32)  # many exact ties
    scores[::13] = scores[0]
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:n_valid]] = True
    t = lambda a: torch.from_numpy(a).cuda()
    boxes_t, scores_t, valid_t = t(boxes), t(scores), t(valid)
    if classes:
        cls = t(rng.randint(0, classes, n).astype(np.int32))
        zero = torch.zeros((), device="cuda")
        max_coord = torch.where(valid_t[:, None], boxes_t, zero).max() + 1.0
        boxes_t = boxes_t + (cls.to(torch.float32) * max_coord)[:, None]
    return boxes_t, scores_t, valid_t


def borderline_case(thr: float, pairs: int = 256, seed: int = 0):
    """Box pairs whose float32 IoU lands on t, one ulp below and one above
    it, each as close to its rounding midpoints as integer boxes get.

    Pair k is [0, 2k, L, 2k+1] and [s, 2k, s+L, 2k+1] (L + s < 2^24, so the
    intersection L - s, the areas L and the union L + s are exact and only
    the division rounds): IoU = (L - s) / (L + s). Pairs lie in disjoint
    bands, the first box of each scores higher, and the second is
    suppressed iff fl(IoU) > t. -> boxes, scores, valid, expected keep."""
    t = np.float32(thr)
    targets = (np.nextafter(t, np.float32(-np.inf)), t, np.nextafter(t, np.float32(np.inf)))
    L = np.arange(9_000_000, 9_400_000, dtype=np.int64)
    s0 = np.round(L * (1 - float(t)) / (1 + float(t))).astype(np.int64)
    L = np.tile(L, 7)
    s = np.concatenate([s0 + d for d in range(-3, 4)])
    ok = L + s < 2**24
    L, s = L[ok], s[ok]
    q32 = (L - s).astype(np.float32) / (L + s).astype(np.float32)
    q64 = (L - s) / (L + s)
    picked = []
    for v in targets:
        hit = np.nonzero(q32 == v)[0]
        lo = (float(v) + float(np.nextafter(v, np.float32(-np.inf)))) / 2
        hi = (float(v) + float(np.nextafter(v, np.float32(np.inf)))) / 2
        picked += [hit[np.argmin(q64[hit] - lo)], hit[np.argmin(hi - q64[hit])]]
    rng = np.random.RandomState(seed)
    near = np.nonzero(np.isin(q32, np.asarray(targets)))[0]
    picked = np.concatenate([picked, rng.choice(near, pairs - len(picked), replace=False)])
    L, s, q32 = L[picked], s[picked], q32[picked]
    band = 2.0 * np.arange(pairs)
    a = np.stack([np.zeros(pairs), band, L, band + 1], 1)
    b = np.stack([s, band, s + L, band + 1], 1)
    boxes = np.stack([a, b], 1).reshape(-1, 4).astype(np.float32)
    scores = np.linspace(1.0, 0.01, 2 * pairs).astype(np.float32)
    keep = np.stack([np.ones(pairs, bool), q32 <= t], 1).reshape(-1)
    perm = rng.permutation(2 * pairs)
    return boxes[perm], scores[perm], np.ones(2 * pairs, bool), keep[perm]


def chain_case(n: int, thr: float):
    """n boxes of width 16 in a row, each shifted by d from the one before:
    every box suppresses the next and not the one after (IoU (16-d)/(16+d)
    above thr, (16-2d)/(16+2d) below), scores falling along the row. Greedy
    NMS keeps every other box; the fixpoint needs n/2 rounds."""
    d = {0.5: 4.0, 0.7: 2.0}[thr]
    x = d * np.arange(n)
    boxes = np.stack([x, np.zeros(n), x + 16.0, np.full(n, 16.0)], 1).astype(np.float32)
    scores = np.linspace(1.0, 0.01, n).astype(np.float32)
    return boxes, scores, np.ones(n, bool), np.arange(n) % 2 == 0


def identical_case(n: int, seed: int = 0):
    """n copies of one box, with tied scores: greedy NMS keeps one, the
    first of the highest score."""
    rng = np.random.RandomState(seed)
    boxes = np.tile(np.float32([[10.0, 20.0, 110.0, 220.0]]), (n, 1))
    scores = np.round(rng.uniform(0, 1, n), 2).astype(np.float32)
    keep = np.zeros(n, bool)
    keep[np.argmax(scores)] = True
    return boxes, scores, np.ones(n, bool), keep


def disjoint_case(n: int, seed: int = 0):
    """n boxes on a grid, none touching another: greedy NMS keeps all."""
    rng = np.random.RandomState(seed)
    k = np.arange(n)
    x, y = 10.0 * (k % 64), 10.0 * (k // 64)
    boxes = np.stack([x, y, x + 8.0, y + 8.0], 1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    return boxes, scores, np.ones(n, bool), np.ones(n, bool)


# label -> (function making boxes, scores, valid, expected keep; IoU threshold)
EDGE_CASES = {
    "borderline thr=0.5": (lambda: borderline_case(0.5), 0.5),
    "borderline thr=0.7": (lambda: borderline_case(0.7), 0.7),
    "chain N=4096 thr=0.7": (lambda: chain_case(4096, 0.7), 0.7),
    "chain N=12288 thr=0.7": (lambda: chain_case(12288, 0.7), 0.7),
    "identical N=4096 thr=0.7": (lambda: identical_case(4096), 0.7),
    "disjoint N=4096 thr=0.5": (lambda: disjoint_case(4096), 0.5),
}


def edge_cases():
    """(label, boxes, scores, valid, thr, expected keep) of the cases built
    to break the kernels: rounding at the threshold, a suppression chain,
    all boxes equal, no box overlapping another."""
    out = []
    for label, (build, thr) in EDGE_CASES.items():
        boxes, scores, valid, keep = build()
        out.append((label, boxes, scores, valid, thr, keep))
    return out


def sorted_inputs(boxes, scores, valid):
    order = nms.score_order(scores, valid)
    return boxes[order].contiguous(), valid[order].contiguous()


def plain_keep(boxes, scores, valid, thr):
    """nms_mask_matrix through the plain versions, on the tensors' device."""
    order = nms.score_order(scores, valid)
    sb, sv = boxes[order].contiguous(), valid[order].contiguous()
    keep_sorted = nms.greedy_keep_plain(nms.suppress_relation_plain(sb, sv, thr), sv)
    keep = torch.zeros_like(valid)
    keep[order] = keep_sorted
    return keep


def check_kernels_against_plain(boxes, scores, valid, thr, label, expected=None, cpu=True):
    """Both kernels against their plain versions on the card, bit for bit;
    the whole NMS against the plain path, the CPU path (unless cpu=False)
    and, where given, the expected keep mask."""
    sb, sv = sorted_inputs(boxes, scores, valid)
    rel = nms.suppress_relation_plain(sb, sv, thr)
    bits_k = _kernels.launch_suppress_relation_bits(sb, sv, thr)
    bits_p = nms.pack_bits(rel)
    torch.cuda.synchronize()
    if not torch.equal(bits_k, bits_p):
        bad = (bits_k != bits_p).sum().item()
        raise AssertionError(f"{label}: suppress_relation_bits differs from plain in {bad} words")
    keep_k = nms.greedy_keep_from_bits(bits_k, sv)  # the route N picks
    keep_p = nms.greedy_keep_plain(rel, sv)
    torch.cuda.synchronize()
    if not torch.equal(keep_k, keep_p):
        raise AssertionError(f"{label}: greedy_keep_from_bits differs from plain")
    full_k = nms.nms_mask_matrix(boxes, scores, valid, thr)
    if not torch.equal(full_k, plain_keep(boxes, scores, valid, thr)):
        raise AssertionError(f"{label}: nms_mask_matrix on the card differs from the plain path")
    if cpu and not torch.equal(full_k.cpu(), nms.nms_mask_matrix(boxes.cpu(), scores.cpu(), valid.cpu(), thr)):
        raise AssertionError(f"{label}: nms_mask_matrix on the card differs from the CPU path")
    if expected is not None and not np.array_equal(full_k.cpu().numpy(), expected):
        raise AssertionError(f"{label}: keep mask differs from the expected one")
    return int(keep_k.sum().item())


# ---------------------------------------------------------------- timing
def time_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile(fn, reps: int):
    """Run fn reps times under torch.profiler. Returns (wall ms per rep,
    device kernel ms per rep, {kernel name: ms per rep}, {op: self device ms
    per rep}); the kernels run on one stream, so their sum over the wall is
    the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    ops = {
        e.key: e.self_device_time_total / 1e3 / reps
        for e in prof.key_averages()
        if e.device_type == DeviceType.CPU and e.self_device_time_total > 0
    }
    return wall, sum(kernels.values()), kernels, ops


def top(d, k=6):
    return ", ".join(f"{name[:60]} {ms:.3f}" for name, ms in sorted(d.items(), key=lambda kv: -kv[1])[:k])


def kernel1_bound_ms(sv: torch.Tensor):
    n = sv.shape[0]
    words = (n + 63) // 64
    v = int(sv.sum().item())
    bytes_ = n * 16 + n + n * words * 8
    ops = OPS_PER_PAIR * v * (v - 1) // 2
    return max(bytes_ / PEAK_BYTES_S, ops / PEAK_F32_S) * 1e3, ("bytes" if bytes_ / PEAK_BYTES_S >= ops / PEAK_F32_S else "operations")


def kernel2_bound_ms(keep_sorted: torch.Tensor):
    """Bytes this run's data needs: each row's diagonal word, the words right
    of the diagonal of every kept row, valid in, keep out. The integer ORs
    are far fewer than the bytes."""
    n = keep_sorted.shape[0]
    words = (n + 63) // 64
    kept = torch.nonzero(keep_sorted).flatten().cpu().numpy()
    right = int(np.sum(words - 1 - kept // 64)) if kept.size else 0
    bytes_ = 8 * (n + right) + 2 * n
    return bytes_ / PEAK_BYTES_S * 1e3, "bytes"


# ---------------------------------------------------------------- training
def train_cfg(dtype: str, canvas=(608, 1216)):
    """The source-training configuration with the phase's solver, seed 0."""
    cfg = get_source_cfg()
    opts = {"SEED": "0", "TPU.DTYPE": dtype, "TPU.CANVAS": repr(tuple(canvas)), **TRAIN_SOLVER}
    cfg.merge_from_list([x for kv in opts.items() for x in kv])
    return cfg


def train_batch(cfg, image_hw, seed: int):
    """One synthetic image of image_hw (1..6 boxes) on the config's canvas."""
    recs = make_synthetic_records(1, tuple(image_hw), cfg.MODEL.ROI_HEADS.NUM_CLASSES, 6, seed=seed)
    return synthetic_batch(recs, tuple(cfg.TPU.CANVAS), cfg.TPU.GT_CAPACITY)


def card_vs_cpu_step(canvas=(256, 512), image_hw=(250, 500), seed: int = SEED):
    """One float32 step (TF32 off, which the trainer sets) from the same
    weights, batch and draws on the card and on the CPU. -> the errors:
    each loss's relative error, whether the sample counts are equal, the
    worst parameter difference relative to its tensor's largest entry and
    the worst ratio of a parameter difference to its bound (with the
    tensors' names), the worst BatchNorm statistic difference relative to
    its largest entry, and the largest movement of a conv bias that feeds a
    BatchNorm relative to its weight's movement (its exact gradient is 0)."""
    cfg = train_cfg("float32", canvas)
    state = init_weights(FasterRCNN(detector_config_from_cfg(cfg)), SEED).state_dict()
    batch = train_batch(cfg, image_hw, seed)
    cpu = BaseTrainer(cfg, device="cpu", state_dict=state)
    card = BaseTrainer(cfg, device="cuda", state_dict=state)
    draws = cpu.make_draws(1, tuple(canvas), cfg.TPU.GT_CAPACITY)
    mc = {k: float(v) for k, v in cpu.run_step(batch, draws).items()}
    mg = {k: float(v) for k, v in card.run_step(batch, draws).items()}
    out = {"loss": {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in TRAIN_LOSSES},
           "counts_equal": all(mg[k] == mc[k] for k in ("num_fg", "num_sampled")),
           "losses_cpu": mc}
    out.update(state_errors(state, cpu.state.model.state_dict(), card.state.model.state_dict()))
    return out


def state_errors(start, after_cpu, after_cuda):
    """The card's state after a step against the CPU's, from the same start:
    the worst parameter difference relative to its tensor's largest entry,
    the worst ratio of a parameter difference to its bound, the worst
    BatchNorm statistic difference relative to its largest entry, and the
    largest movement of a conv bias that feeds a BatchNorm relative to its
    weight's movement (with the tensors' names)."""
    after = {"cpu": after_cpu, "cuda": {k: v.cpu() for k, v in after_cuda.items()}}
    state = {k: v.cpu().float() for k, v in start.items()}
    out = {"param": (0.0, ""), "param_bound": (0.0, ""), "bn": (0.0, ""), "bn_fed_bias": (0.0, "")}
    for k, c in after["cpu"].items():
        if k.endswith("num_batches_tracked") or k in ("pixel_mean", "pixel_std"):
            continue
        c = c.float()
        err = (after["cuda"][k].float() - c).abs().max().item()
        scale = max(c.abs().max().item(), 1e-12)
        if k.endswith(("running_mean", "running_var")):
            out["bn"] = max(out["bn"], (err / scale, k))
        elif k.startswith("backbone.") and k.endswith(".bias") and int(k.split(".")[-2]) % 3 == 0:
            w = k[:-4] + "weight"
            for side in ("cpu", "cuda"):
                moved = (after[side][k].float() - state[k]).abs().max().item()
                moved_w = (after[side][w].float() - state[w]).abs().max().item()
                out["bn_fed_bias"] = max(out["bn_fed_bias"], (moved / max(moved_w, 1e-30), f"{k} ({side})"))
        else:
            moved = (c - state[k]).abs().max().item()
            out["param"] = max(out["param"], (err / scale, k))
            out["param_bound"] = max(out["param_bound"], (err / (PARAM_REL * scale + PARAM_MOVE * moved + 1e-8), k))
    return out


def card_step_ok(err) -> bool:
    return (
        max(err["loss"].values()) <= LOSS_TOL and err["counts_equal"] and err["param_bound"][0] <= 1.0
        and err["bn"][0] <= BN_TOL and err["bn_fed_bias"][0] <= BN_FED_BIAS_TOL
        and err.get("teacher_bn", (0.0, ""))[0] <= BN_TOL
    )


def format_errors(err, losses) -> str:
    return (", ".join(f"{k} {err['loss'][k]:.3g}" for k in losses) + f" (tol {LOSS_TOL}); counts equal "
            f"{err['counts_equal']}; param max rel diff {err['param'][0]:.3g} ({err['param'][1]}); worst diff / bound "
            f"{err['param_bound'][0]:.3g} ({err['param_bound'][1]}; bound {PARAM_REL} x largest entry + {PARAM_MOVE} x "
            f"movement + 1e-8, tol 1); BN stats rel err {err['bn'][0]:.3g} ({err['bn'][1]}, tol {BN_TOL}); "
            f"BN-fed conv bias movement / weight movement {err['bn_fed_bias'][0]:.3g} ({err['bn_fed_bias'][1]}, "
            f"tol {BN_FED_BIAS_TOL})")


# ---------------------------------------------------------------- adaptation
def adapt_cfg(base, trainer: str = "source_free_adaptive_teacher", dtype: str = "bfloat16", canvas=(608, 1216)):
    """An adaptation configuration (`SFAT_BENCH_CONFIG` or `MAIN_CONFIG`) with
    the phase's cuts, seed 0."""
    cfg = get_cfg()
    opts = {"TRAINER": trainer, "SEED": "0", "TPU.DTYPE": dtype, "TPU.CANVAS": repr(tuple(canvas)), **ADAPT_CUTS}
    cfg.merge_from_list(config_opts(base) + [x for kv in opts.items() for x in kv])
    return cfg


def adapt_trainer(cfg, device=None):
    """The trainer from seeded weights with the class-1 logit bias raised
    (teacher and student) and the student's bbox_pred bias offset from the
    teacher's."""
    model = init_weights(FasterRCNN(detector_config_from_cfg(cfg)), SEED)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.bias[1] += CLS_BIAS_BOOST
    tr = build_trainer(cfg, device=device, state_dict=model.state_dict())
    with torch.no_grad():
        tr.state.model.roi_heads.box_predictor.bbox_pred.bias += BBOX_OFFSET
    return tr


def capture_nms(captured: list):
    """A stand-in for nms.nms_mask_matrix that records its inputs."""
    orig = nms.nms_mask_matrix

    def record(boxes, scores, valid, thr):
        captured.append((boxes.clone(), scores.clone(), valid.clone(), thr))
        return orig(boxes, scores, valid, thr)

    return orig, record


def adapt_run(cfg, steps: int, captured: list):
    """`steps` adaptation steps on the synthetic bench image (the draws the
    trainer makes). Captures the NMS inputs of the first step, checks the
    EMA rule (where the trainer has EMA) at the second. -> (trainer, batch,
    per-step metrics, wall ms, launches, teacher parameters before, EMA
    error)."""
    tr = adapt_trainer(cfg)
    batch = synthetic_bench_batch(cfg)
    teacher0 = {k: v.clone() for k, v in tr.state.teacher.state_dict().items()}
    orig, record = capture_nms(captured)
    metrics, wall, launches, ema_err = [], [], [], None
    try:
        for i in range(steps):
            before = dict(_kernels.LAUNCHES)
            if i == 0:
                nms.nms_mask_matrix = record
            if i == 1 and tr.ema_enabled:
                t_before = [t.clone() for t in ema_tensors(tr.state.teacher)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.append(tr.run_step(batch))
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            nms.nms_mask_matrix = orig
            launches.append({k: c - before[k] for k, c in _kernels.LAUNCHES.items()})
            if i == 1 and tr.ema_enabled:
                keep = np.float32(cfg.SEMISUPNET.EMA_KEEP_RATE)
                ema_err = max(
                    ((t1 - (keep * t0 + (np.float32(1) - keep) * s1)).abs().max() / s1.abs().max().clamp_min(1e-30)).item()
                    for t0, t1, s1 in zip(t_before, ema_tensors(tr.state.teacher), ema_tensors(tr.state.model))
                )
    finally:
        nms.nms_mask_matrix = orig
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    return tr, batch, metrics, wall, launches, teacher0, ema_err


def check_adapt_run(label, tr, metrics, launches, teacher0, batch_size: int = 1):
    for i, m in enumerate(metrics):
        if not all(np.isfinite(m[k]) for k in ADAPT_LOSSES):
            raise AssertionError(f"{label} step {i}: non-finite loss {m}")
    for i, d in enumerate(launches):
        if any(c != 3 * batch_size for c in d.values()):
            raise AssertionError(f"{label} step {i}: kernel launches {d}, expected 3 of each per image")
    if not any(m["num_pseudo"] > 0 for m in metrics):
        raise AssertionError(f"{label}: no pseudo-labels in any step")
    if not tr.ema_enabled:
        after = tr.state.teacher.state_dict()
        for k, v in teacher0.items():
            if k.endswith(("running_mean", "running_var")):
                check(not torch.equal(after[k], v) and after[k].dtype == torch.float32, f"{label}: teacher {k} did not move")
            elif not k.endswith("num_batches_tracked"):
                check(torch.equal(after[k], v), f"{label}: fixed teacher {k} changed")


def strong_view_card_vs_cpu(image, size, draws):
    """The strong view of one image on the card and on the CPU from the same
    draws. -> (max difference, pixels more than 1 step apart, pixels)."""
    got = transforms.strong_augment(image, draws, 0, size).cpu()
    want = transforms.strong_augment(image.cpu(), draws.to("cpu"), 0, size.cpu())
    err = (got - want).abs()
    return float(err.max()), int((err > 1.0).sum()), err.numel()


def card_vs_cpu_adapt_step(canvas=(128, 256), image_hw=(120, 250)):
    """One float32 main-variant step (strong view, adaptive threshold; TF32
    off, which the trainer sets) on the card and on the CPU from the same
    weights, batch and draws. -> the errors of `state_errors`, the losses'
    and the pseudo-label counts', and the teacher statistics' (which its
    pseudo forward moved).

    Held at 128x256: there every top-k of the step keeps all its candidates.
    At 256x512 the teacher's 1000 test-mode proposals are cut from about
    1400 kept by NMS and its 100 detections from more than 100 above the
    threshold, among scores of random weights that tie to rounding, so the
    card and the CPU keep sets that differ by a box or two: the counts stay
    equal and loss_box_reg or loss_rpn_loc moves by 0.5-4% (measured)."""
    cfg = adapt_cfg(SFAT_BENCH_CONFIG, dtype="float32", canvas=canvas)
    cpu = adapt_trainer(cfg, device="cpu")
    card = adapt_trainer(cfg, device="cuda")
    start = {k: v.clone() for k, v in cpu.state.model.state_dict().items()}
    batch = synthetic_bench_batch(cfg)
    batch["sizes"][:] = image_hw
    batch["images"][:, image_hw[0]:] = 0
    batch["images"][:, :, image_hw[1]:] = 0
    draws = cpu.make_draws(1, tuple(canvas))
    mc = {k: float(v) for k, v in cpu.run_step(batch, draws).items()}
    mg = {k: float(v) for k, v in card.run_step(batch, draws.to("cuda")).items()}
    out = {"loss": {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in ADAPT_LOSSES},
           "counts_equal": all(mg[k] == mc[k] for k in ("num_fg_pseudo", "num_sampled_pseudo", "num_pseudo")),
           "losses_cpu": mc}
    out.update(state_errors(start, cpu.state.model.state_dict(), card.state.model.state_dict()))
    tc, tg = cpu.state.teacher.state_dict(), card.state.teacher.state_dict()
    out["teacher_bn"] = max(
        (((tg[k].cpu() - tc[k]).abs().max() / tc[k].abs().max().clamp_min(1e-12)).item(), k)
        for k in tc if k.endswith(("running_mean", "running_var"))
    )
    return out


# ---------------------------------------------------------------- eval data
def png_bytes(rgb: np.ndarray, level: int = 1) -> bytes:
    """An 8-bit RGB PNG of rgb [H, W, 3] uint8, written with the standard
    library (zlib, struct): the rows filtered by types 0-4 in turn, so that
    a decoder meets every filter."""
    h, w, _ = rgb.shape
    x = rgb.reshape(h, w * 3).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 3:] = x[:-1, :-3]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (np.zeros_like(x), a, b, (a + b) // 2, paeth)
    ft = np.arange(h) % 5
    rows = np.empty((h, w * 3 + 1), np.uint8)
    rows[:, 0] = ft
    for t, pred in enumerate(preds):
        rows[ft == t, 1:] = ((x - pred)[ft == t] % 256).astype(np.uint8)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return native_codec.PNG_MAGIC + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b"")


def write_eval_dataset(root: str, n: int, hw, seed: int = SEED):
    """n synthetic records of size hw (1..6 boxes of Cityscapes' 8 classes),
    rendered as the loader's synthetic images, written as PNG files with a
    COCO JSON (category ids 1..8) under root. -> (JSON path, records, the
    first image as written, RGB uint8)."""
    recs = make_synthetic_records(n, tuple(hw), len(CITYSCAPES_THING_CLASSES), 6, seed=seed)
    images, anns, first = [], [], None
    for r in recs:
        rgb = np.clip(synthetic_image(r), 0, 255).astype(np.uint8)
        first = rgb if first is None else first
        fname = f"frame_{r['image_id']:04d}.png"
        with open(os.path.join(root, fname), "wb") as f:
            f.write(png_bytes(rgb))
        images.append({"id": r["image_id"], "file_name": fname, "height": hw[0], "width": hw[1]})
        for box, cls in zip(r["boxes"], r["classes"]):
            x1, y1, x2, y2 = box
            anns.append({"id": len(anns) + 1, "image_id": r["image_id"], "category_id": cls + 1,
                         "bbox": [x1, y1, x2 - x1, y2 - y1], "iscrowd": 0})
    cats = [{"id": k + 1, "name": name} for k, name in enumerate(CITYSCAPES_THING_CLASSES)]
    path = os.path.join(root, "annotations.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)
    return path, recs, first


def match_dumps(a, b):
    """Two COCO detection dumps of the same images, paired per image one to
    one by category and nearest box (closest pairs first). -> (entries
    without a partner, largest box difference in px, largest score
    difference)."""
    def by_image(dump):
        out = {}
        for e in dump:
            out.setdefault(e["image_id"], []).append(e)
        return out

    ai, bi = by_image(a), by_image(b)
    unpaired, box_err, score_err = 0, 0.0, 0.0
    for img in set(ai) | set(bi):
        p, q = ai.get(img, []), bi.get(img, [])
        unpaired += abs(len(p) - len(q))
        if not p or not q:
            continue
        pb, qb = np.asarray([e["bbox"] for e in p]), np.asarray([e["bbox"] for e in q])
        pc, qc = np.asarray([e["category_id"] for e in p]), np.asarray([e["category_id"] for e in q])
        dist = np.abs(pb[:, None] - qb[None]).max(-1) + np.where(pc[:, None] != qc[None], np.inf, 0.0)
        taken = np.zeros(len(q), bool)
        for i in np.argsort(dist.min(axis=1), kind="stable")[: min(len(p), len(q))]:
            k = int(np.argmin(np.where(taken, np.inf, dist[i])))
            if not np.isfinite(dist[i, k]):
                unpaired += 1
                continue
            taken[k] = True
            box_err = max(box_err, float(dist[i, k]))
            score_err = max(score_err, abs(p[i]["score"] - q[k]["score"]))
    return unpaired, box_err, score_err


def card_vs_cpu_eval(root: str):
    """A float32 eval loop (TF32 off) on EVAL_SMALL's 4 PNG images at
    128x256 (100x200 files resized to 120x240) on the card and on the CPU,
    seeded weights. -> (card results, CPU results, match_dumps of the two
    dumps, detections on the CPU)."""
    path, _, _ = write_eval_dataset(root, EVAL_SMALL["images"], EVAL_SMALL["hw"], seed=SEED + 5)
    register_dataset("eval_small", path, root, CITYSCAPES_THING_CLASSES)
    cfg = get_main_cfg()
    ms = EVAL_SMALL["min_size"]
    cfg.merge_from_list(["TPU.DTYPE", "float32", "TPU.CANVAS", repr(EVAL_SMALL["canvas"]), "INPUT.MIN_SIZE_TEST", str(ms),
                         "INPUT.MAX_SIZE_TEST", str(EVAL_SMALL["canvas"][1]), "TEST.IMS_PER_BATCH", "2"])
    dcfg = detector_config_from_cfg(cfg)
    sd = init_weights(FasterRCNN(dcfg), SEED).state_dict()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for dev in ("cuda", "cpu"):
            dump = os.path.join(root, f"dump_{dev}.json")
            det = Detector(dcfg, device=dev).load_state_dict(sd)
            res = inference_on_dataset(det, build_test_loader(cfg, "eval_small"), CITYSCAPES_THING_CLASSES,
                                       dump_json=dump, pipeline_depth=2)
            with open(dump) as f:
                out[dev] = (res, json.load(f))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out["cuda"][0], out["cpu"][0], match_dumps(out["cuda"][1], out["cpu"][1]), len(out["cpu"][1])


def train_run(dtype: str, captured: list):
    """TRAIN_STEPS steps of the full-width trainer on one repeated batch.
    Captures the RPN NMS inputs of the first step. -> (trainer, batch,
    per-step metrics, per-step wall ms, per-step kernel launches)."""
    cfg = train_cfg(dtype)
    trainer = BaseTrainer(cfg)
    batch = train_batch(cfg, IMAGE_HW, SEED + 3)
    orig_nms, record = capture_nms(captured)
    metrics, wall, launches = [], [], []
    try:
        for i in range(TRAIN_STEPS):
            before = dict(_kernels.LAUNCHES)
            if i == 0:
                nms.nms_mask_matrix = record
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.append(trainer.run_step(batch))
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            nms.nms_mask_matrix = orig_nms
            launches.append({k: c - before[k] for k, c in _kernels.LAUNCHES.items()})
    finally:
        nms.nms_mask_matrix = orig_nms
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    return trainer, batch, metrics, wall, launches


def kernel_rows(b, s, v, thr, site, plain_reps=(20, 5)):
    """Both kernels on one NMS call's inputs: device time (profiler), time a
    call (CUDA events), plain version's time (over plain_reps calls of each,
    after a warm-up call), bound, and the differences from the plain
    version."""
    sb, sv = sorted_inputs(b, s, v)
    bits = _kernels.launch_suppress_relation_bits(sb, sv, thr)
    keep = nms.greedy_keep_from_bits(bits, sv)  # the route N picks
    rel = nms.suppress_relation_plain(sb, sv, thr)
    call1 = time_ms(lambda: _kernels.launch_suppress_relation_bits(sb, sv, thr), 200)
    p1 = time_ms(lambda: nms.pack_bits(nms.suppress_relation_plain(sb, sv, thr)), plain_reps[0])
    call2 = time_ms(lambda: nms.greedy_keep_from_bits(bits, sv), 200)
    p2 = time_ms(lambda: nms.greedy_keep_plain(rel, sv), plain_reps[1], warmup=1)
    # the kernels' own device time, from the profiler's kernel events
    _, _, kern1, _ = profile(lambda: _kernels.launch_suppress_relation_bits(sb, sv, thr), 50)
    _, _, kern2, _ = profile(lambda: nms.greedy_keep_from_bits(bits, sv), 50)
    k1 = sum(v for name, v in kern1.items() if "suppress_relation_bits_kernel" in name)
    k2 = sum(v for name, v in kern2.items() if "greedy_keep_from_bits" in name)
    check(k1 > 0 and k2 > 0, f"profiler saw no kernel time: {kern1} {kern2}")
    b1, by1 = kernel1_bound_ms(sv)
    b2, by2 = kernel2_bound_ms(keep)
    err1 = int((bits != nms.pack_bits(rel)).sum().item())
    err2 = int((keep != nms.greedy_keep_plain(rel, sv)).sum().item())
    n = int(sb.shape[0])
    log(f"  {site} N={n} valid={int(sv.sum())} kept={int(keep.sum())}: suppress_relation_bits {k1 * 1e3:.2f} us on the device, "
        f"{call1 * 1e3:.1f} us a call (plain {p1 * 1e3:.1f} us, bound {b1 * 1e3:.2f} us {by1}); "
        f"greedy_keep_from_bits {k2 * 1e3:.2f} us on the device, {call2 * 1e3:.1f} us a call "
        f"(plain {p2 * 1e3:.1f} us, bound {b2 * 1e3:.3f} us {by2})")
    return (
        dict(site=site, n=n, thr=thr, ms=k1, call_ms=call1, plain_ms=p1, bound_ms=b1, bound_by=by1, err=err1),
        dict(site=site, n=n, thr=thr, ms=k2, call_ms=call2, plain_ms=p2, bound_ms=b2, bound_by=by2, err=err2),
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    with Phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    with Phase("build"):
        # nvcc for the kernels and g++ for the two host libraries, together
        from concurrent.futures import ThreadPoolExecutor

        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as pool:
            futures = {"nms": pool.submit(_kernels.build, "nms")}
            futures.update({name: pool.submit(host_libs.build, name) for name in ("imgcodec", "cocoeval")})
            built = {name: f.result() for name, f in futures.items()}
        _kernels.load_all()
        log(f"build: {built['nms']} in {time.perf_counter() - t0:.2f} s with the host libraries (nvcc "
            f"{_kernels.BUILD_SECONDS.get('nms', 0.0):.2f} s; g++ imgcodec {host_libs.BUILD_SECONDS.get('imgcodec', 0.0):.2f} s, "
            f"cocoeval {host_libs.BUILD_SECONDS.get('cocoeval', 0.0):.2f} s)")
        # registers, static shared memory and spills, from nvcc -Xptxas -v
        ptxas = {}
        for mangled, use in _kernels.resource_usage("nms").items():
            # greedy_keep_from_bits has two routes: its kernel and the row walk
            name = next(k for k in _kernels.LAUNCHES if k in mangled)
            ptxas.setdefault(name, []).append(use)
            log(f"  {name} ({mangled}): {use}")
        check(set(ptxas) == set(_kernels.LAUNCHES), f"ptxas reported {sorted(ptxas)}")

    with Phase("kernels vs plain"):
        rng = np.random.RandomState(SEED)
        cases = [
            ("N=4096 thr=0.7", 4096, 3900, 0.7, 0),
            ("N=1024 thr=0.5 class-offset", 1024, 1000, 0.5, 8),
            ("N=1000 thr=0.5", 1000, 1000, 0.5, 0),
            ("N=1 thr=0.5", 1, 1, 0.5, 0),
            ("N=257 thr=0.7 0 valid", 257, 0, 0.7, 0),
            ("N=8192 thr=0.7", 8192, 8000, 0.7, 0),
            ("N=4097 thr=0.7", 4097, 4000, 0.7, 0),
            # above the keep kernel's shared-memory route: its row walk
            ("N=12288 thr=0.7", 12288, 12000, 0.7, 0),
        ]
        large_n = {}
        for label, n, n_valid, thr, ncls in cases:
            b, s, v = case_boxes(rng, n, n_valid, classes=ncls)
            kept = check_kernels_against_plain(b, s, v, thr, label, cpu=n <= 4097)
            log(f"  {label}: bit-equal, kept {kept}")
            if n > _kernels.GREEDY_MAX_N:
                large_n[label] = (b, s, v, thr)
        for label, b, s, v, thr, want in edge_cases():
            t = lambda a: torch.from_numpy(a).cuda()
            # the plain fixpoint needs n/2 rounds for the chain: too slow on the CPU
            kept = check_kernels_against_plain(t(b), t(s), t(v), thr, label, want, cpu="chain" not in label)
            log(f"  {label}: bit-equal and as expected, kept {kept}")
            if len(b) > _kernels.GREEDY_MAX_N:
                large_n[label] = (t(b), t(s), t(v), thr)

    with Phase("serve"):
        cfg = get_main_cfg()
        cfg.freeze()
        det_cfg = detector_config_from_cfg(cfg)
        check(det_cfg.dtype == torch.bfloat16 and tuple(cfg.TPU.CANVAS) == (608, 1216), "main config")
        state = init_weights(FasterRCNN(det_cfg), SEED).state_dict()
        service = DetectionService(cfg, state, batch=2, max_wait_ms=10.0, config_name="main")
        srv, url = serve_in_thread(service)
        captured = []
        orig_nms, record = capture_nms(captured)
        try:
            rng = np.random.RandomState(SEED + 1)
            bodies, imgs = [], []
            for _ in range(N_REQUESTS):
                img = rng.randint(0, 256, IMAGE_HW + (3,)).astype(np.uint8)
                imgs.append(img)
                buf = io.BytesIO()
                np.save(buf, img)
                bodies.append(buf.getvalue())

            def post(body):
                req = urllib.request.Request(f"{url}/predict", data=body, method="POST")
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=300) as resp:
                    out = json.loads(resp.read())
                return out, (time.perf_counter() - t0) * 1e3

            info = json.loads(urllib.request.urlopen(f"{url}/", timeout=60).read())
            check(info["canvas"] == [608, 1216] and info["platforms"] == ["cuda"], f"service info {info}")

            results = [None] * N_REQUESTS
            latency = [0.0] * N_REQUESTS
            _kernels.reset_launches()
            # requests 0 and 1 one at a time (request 1's NMS inputs captured),
            # then 2 and 3 together
            for i in (0, 1):
                before = dict(_kernels.LAUNCHES)
                if i == 1:
                    nms.nms_mask_matrix = record
                results[i], latency[i] = post(bodies[i])
                nms.nms_mask_matrix = orig_nms
                for k, c in _kernels.LAUNCHES.items():
                    if c - before[k] < 2:
                        raise AssertionError(f"request {i}: {k} launched {c - before[k]} times, expected 2 (RPN + detection NMS)")
            errors = []

            def worker(i):
                try:
                    results[i], latency[i] = post(bodies[i])
                except BaseException as e:  # reported below, after join
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(i,)) for i in (2, 3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
                if t.is_alive():
                    raise AssertionError("a concurrent request did not finish")
            if errors:
                raise errors[0]
            # a Cityscapes frame sent as a PNG file: native decode and resize
            big = rng.randint(0, 256, FRAME_HW + (3,)).astype(np.uint8)
            before = dict(_kernels.LAUNCHES)
            big_res, big_ms = post(png_bytes(big))
            check("error" not in big_res, f"{FRAME_HW} request: {big_res.get('error')}")
            for k, c in _kernels.LAUNCHES.items():
                check(c - before[k] == 2, f"{FRAME_HW} request: {k} launched {c - before[k]} times, expected 2")
            big_prep = service._prepare(big[:, :, ::-1].copy())
            check(big_prep[1] == (600, 1200), f"{FRAME_HW} frame resized to {big_prep[1]}, expected (600, 1200)")
            launches = dict(_kernels.LAUNCHES)
        finally:
            nms.nms_mask_matrix = orig_nms
            srv.shutdown()
            srv.server_close()
            service.close()

        for k, c in launches.items():
            if c < 2 * (N_REQUESTS + 1):
                raise AssertionError(f"{k} launched {c} times for {N_REQUESTS + 1} images, expected >= {2 * (N_REQUESTS + 1)}")
        check(big_res["width"] == FRAME_HW[1] and big_res["height"] == FRAME_HW[0], f"{FRAME_HW} request: size {big_res}")
        for d in big_res["detections"]:
            x0, y0, x1, y1 = d["box"]
            check(np.isfinite(d["score"]) and 0 <= x0 <= x1 <= FRAME_HW[1] and 0 <= y0 <= y1 <= FRAME_HW[0],
                  f"{FRAME_HW} request: detection {d}")
        log(f"  request {N_REQUESTS} ({FRAME_HW[0]}x{FRAME_HW[1]} PNG, resized to {big_prep[1]}): {big_ms:.1f} ms, "
            f"{len(big_res['detections'])} detections")
        for i, res in enumerate(results):
            if "error" in res:
                raise AssertionError(f"request {i}: {res['error']}")
            check(res["width"] == IMAGE_HW[1] and res["height"] == IMAGE_HW[0], f"request {i}: size {res}")
            dets = res["detections"]
            check(len(dets) <= det_cfg.detections_per_image, f"request {i}: {len(dets)} detections")
            for d in dets:
                x0, y0, x1, y1 = d["box"]
                if not all(np.isfinite([x0, y0, x1, y1, d["score"]])):
                    raise AssertionError(f"request {i}: non-finite detection {d}")
                if not (0 <= x0 <= x1 <= IMAGE_HW[1] and 0 <= y0 <= y1 <= IMAGE_HW[0]):
                    raise AssertionError(f"request {i}: box outside the image {d['box']}")
                check(0 <= d["class"] < det_cfg.num_classes, f"request {i}: class {d['class']}")
            log(f"  request {i}: {latency[i]:.1f} ms, {len(dets)} detections")
        log(f"  launches on the main path: {launches}")

        if len(captured) != 2:
            raise AssertionError(f"captured {len(captured)} NMS calls for one image, expected 2")
        for (b, s, v, thr), site in zip(captured, ("rpn", "roi")):
            keep_k = orig_nms(b, s, v, thr)
            keep_p = plain_keep(b, s, v, thr)
            if not torch.equal(keep_k, keep_p):
                raise AssertionError(f"{site} NMS: kernel and plain keep masks differ on the served inputs")
            log(f"  {site} NMS N={b.shape[0]} thr={thr}: kernel == plain, kept {int(keep_k.sum())} of {int(v.sum())} valid")

    with Phase("profile"):
        # the served detector without HTTP and the coalescing window: latency
        # by batch, then one image under torch.profiler
        det = service.detector
        prepared = [service._prepare(img) for img in imgs[:2]]
        canv = np.stack([p[0] for p in prepared])
        sizes = np.asarray([p[1] for p in prepared], np.int32)
        latency_ms = {}
        for b in (1, 2):
            for _ in range(3):
                det.infer(canv[:b], sizes[:b]).valid.cpu()
            runs = []
            for _ in range(10):
                t0 = time.perf_counter()
                det.infer(canv[:b], sizes[:b]).valid.cpu()
                runs.append((time.perf_counter() - t0) * 1e3)
            latency_ms[b] = float(np.median(runs))
            log(f"  infer batch {b}: median {latency_ms[b]:.2f} ms of 10 ({latency_ms[b] / b:.2f} ms/image)")
        torch.cuda.reset_peak_memory_stats()
        wall, dev, kern, ops = profile(lambda: det.infer(canv[:1], sizes[:1]).valid.cpu(), 5)
        log(f"  profile batch 1: wall {wall:.2f} ms, device kernels {dev:.2f} ms, busy {dev / wall:.1%}, "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"  top kernels (ms/image): {top(kern)}")
        log(f"  top ops by device self time (ms/image): {top(ops)}")
        del service, det

    with Phase("check vs CPU path"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        small = get_main_cfg()
        small.merge_from_list(["TPU.DTYPE", "float32", "TPU.CANVAS", "(128, 256)"])
        small_cfg = detector_config_from_cfg(small)
        sd = init_weights(FasterRCNN(small_cfg), SEED).state_dict()
        rng = np.random.RandomState(SEED + 2)
        img = rng.randint(0, 256, (1, 128, 256, 3)).astype(np.uint8)
        sizes = np.asarray([[120, 250]], np.int32)
        outs = {}
        for dev in ("cuda", "cpu"):
            d = Detector(small_cfg, device=dev).load_state_dict(sd)
            with torch.inference_mode():
                feat = d.model.features(torch.from_numpy(img).to(dev)).float().cpu()
            outs[dev] = (feat, d.infer(img, sizes))
        fg, fc = outs["cuda"][0], outs["cpu"][0]
        ferr = ((fg - fc).abs().max() / fc.abs().max().clamp_min(1e-12)).item()
        if not torch.isfinite(fg).all() or ferr > 1e-4:
            raise AssertionError(f"vgg4 feature: card vs CPU relative error {ferr:.3g} > 1e-4")
        g, c = outs["cuda"][1], outs["cpu"][1]
        gv, cv = g.valid.cpu(), c.valid
        if not torch.equal(gv, cv) or not torch.equal(g.classes.cpu()[gv], c.classes[cv]):
            raise AssertionError("detections: card and CPU valid/classes differ")
        berr = (g.boxes.cpu()[gv] - c.boxes[cv]).abs().max().item() if cv.any() else 0.0
        serr = (g.scores.cpu()[gv] - c.scores[cv]).abs().max().item() if cv.any() else 0.0
        if berr > 1e-2 or serr > 1e-4:
            raise AssertionError(f"detections: card vs CPU box err {berr:.3g} px, score err {serr:.3g}")
        log(f"  vgg4 rel err {ferr:.3g}; {int(cv.sum())} detections, box err {berr:.3g} px, score err {serr:.3g}")
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    with Phase("timing"):
        rows = {"suppress_relation_bits": [], "greedy_keep_from_bits": []}
        for (b, s, v, thr), site in zip(captured, ("rpn", "roi")):
            r1, r2 = kernel_rows(b, s, v, thr, site)
            rows["suppress_relation_bits"].append(r1)
            rows["greedy_keep_from_bits"].append(r2)
        # N above the keep kernel's shared-memory route (its row walk)
        large_rows = {"suppress_relation_bits": [], "greedy_keep_from_bits": []}
        for label, (b, s, v, thr) in large_n.items():
            # the plain fixpoint takes N/2 rounds on the chain: one timed call
            r1, r2 = kernel_rows(b, s, v, thr, label, plain_reps=(2, 1))
            large_rows["suppress_relation_bits"].append(r1)
            large_rows["greedy_keep_from_bits"].append(r2)
        del large_n

    with Phase("train"):
        cfg = train_cfg("float32")
        log(f"  solver: BASE_LR {cfg.SOLVER.BASE_LR}, WARMUP_ITERS {cfg.SOLVER.WARMUP_ITERS}, MOMENTUM "
            f"{cfg.SOLVER.MOMENTUM}, WEIGHT_DECAY {cfg.SOLVER.WEIGHT_DECAY} (norm {cfg.SOLVER.WEIGHT_DECAY_NORM}), "
            f"STEPS {cfg.SOLVER.STEPS}, FACTOR_LIST {cfg.SOLVER.FACTOR_LIST}; canvas {cfg.TPU.CANVAS}, batch 1, image {IMAGE_HW}")
        train_captured = []
        step_ms = {}
        _kernels.reset_launches()
        for dtype in ("float32", "bfloat16"):
            trainer, batch, metrics, wall, per_step = train_run(dtype, train_captured)
            for i, m in enumerate(metrics):
                if not all(np.isfinite(m[k]) for k in TRAIN_LOSSES):
                    raise AssertionError(f"{dtype} step {i}: non-finite loss {m}")
            for i, d in enumerate(per_step):
                if any(c != 1 for c in d.values()):
                    raise AssertionError(f"{dtype} step {i}: kernel launches {d}, expected 1 of each per image")
            first, tenth = metrics[0]["total_loss"], metrics[10]["total_loss"]
            if not tenth < first:
                raise AssertionError(f"{dtype}: total loss did not fall over 10 steps ({first:.4f} -> {tenth:.4f})")
            step_ms[dtype] = float(np.median(wall[-TIMED:]))
            log(f"  {dtype} [{smi}]: step {step_ms[dtype]:.2f} ms (median of the last {TIMED} of {TRAIN_STEPS}; first "
                f"{wall[0]:.1f} ms), total loss {first:.4f} -> {tenth:.4f} after 10 steps, "
                f"gt {int(batch['gt_valid'].sum())} boxes; step 10: " +
                ", ".join(f"{k} {metrics[10][k]:.4f}" for k in TRAIN_LOSSES[:4]) +
                f", num_fg {metrics[10]['num_fg']:.0f}, num_sampled {metrics[10]['num_sampled']:.0f}")
        # one bfloat16 step (the SFAT main path's dtype) under the profiler
        torch.cuda.reset_peak_memory_stats()
        wall_p, dev_p, kern_p, ops_p = profile(lambda: trainer.run_step(batch), 3)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        train_launches = dict(_kernels.LAUNCHES)
        nms_ms = sum(v for k, v in kern_p.items() if "suppress_relation_bits_kernel" in k or "greedy_keep_from_bits_kernel" in k)
        log(f"  profile bfloat16 step [{smi}]: wall {wall_p:.2f} ms, device kernels {dev_p:.2f} ms, busy {dev_p / wall_p:.1%}, "
            f"NMS kernels {nms_ms:.3f} ms ({nms_ms / dev_p:.1%} of device time), peak memory {peak_gib:.2f} GiB")
        log(f"  top kernels (ms/step): {top(kern_p)}")
        log(f"  top ops by device self time (ms/step): {top(ops_p, 10)}")
        log(f"  launches on the train path: {train_launches} over {2 * TRAIN_STEPS + 4} steps")

        if len(train_captured) != 2:
            raise AssertionError(f"captured {len(train_captured)} train-mode NMS calls, expected 2")
        for (b, s, v, thr), dtype in zip(train_captured, ("float32", "bfloat16")):
            keep_k = nms.nms_mask_matrix(b, s, v, thr)
            if not torch.equal(keep_k, plain_keep(b, s, v, thr)):
                raise AssertionError(f"train-mode RPN NMS ({dtype}): kernel and plain keep masks differ")
            log(f"  train-mode RPN NMS ({dtype}) N={b.shape[0]} thr={thr}: kernel == plain, kept {int(keep_k.sum())} of {int(v.sum())} valid")
        train_rows = kernel_rows(*train_captured[1], "train rpn (bfloat16)")
        del trainer

        err = card_vs_cpu_step()
        log("  card vs CPU, one float32 step at 256x512 (TF32 off): loss rel err " + format_errors(err, TRAIN_LOSSES) +
            "; CPU losses " + ", ".join(f"{k} {err['losses_cpu'][k]:.4f}" for k in TRAIN_LOSSES))
        if not card_step_ok(err):
            raise AssertionError(f"card step differs from the CPU step: {err}")

    with Phase("adapt"):
        # the main path: the main variant on the adaptation benchmark's
        # configuration (bfloat16, strong view, adaptive threshold, fixed
        # bfloat16 teacher), then on the main configuration, then _single
        adapt_captured = []
        _kernels.reset_launches()
        for i, (label, base, trainer, steps) in enumerate((
            ("main variant, SFAT_BENCH_CONFIG", SFAT_BENCH_CONFIG, "source_free_adaptive_teacher", ADAPT_STEPS),
            ("main variant, MAIN_CONFIG", MAIN_CONFIG, "source_free_adaptive_teacher", ADAPT_STEPS),
            ("_single, SFAT_BENCH_CONFIG", SFAT_BENCH_CONFIG, "source_free_adaptive_teacher_single", SINGLE_STEPS),
        )):
            cfg = adapt_cfg(base, trainer)
            tr, batch, metrics, wall, per_step, teacher0, ema_err = adapt_run(cfg, steps, adapt_captured if i == 0 else [])
            check_adapt_run(label, tr, metrics, per_step, teacher0)
            if tr.ema_enabled:
                check(ema_err is not None and ema_err <= 1e-6, f"{label}: EMA rule off by {ema_err}")
            med = float(np.median(wall[-TIMED:])) if steps > TIMED else float(np.median(wall[1:]))
            log(f"  {label} [{smi}]: {type(tr).__name__}, teacher {next(tr.state.teacher.parameters()).dtype}, "
                f"step {med:.2f} ms (median of the last {min(TIMED, steps - 1)} of {steps}; first {wall[0]:.1f} ms); "
                f"num_pseudo per step {[int(m['num_pseudo']) for m in metrics]}; step {steps - 1}: " +
                ", ".join(f"{k} {metrics[-1][k]:.4f}" for k in ADAPT_LOSSES) +
                (f"; EMA rule error {ema_err:.3g}" if ema_err is not None else "; teacher parameters unchanged, statistics moved"))
            if i == 0:
                main_tr, main_batch = tr, batch
            del tr
        adapt_launches = dict(_kernels.LAUNCHES)
        total_steps = 2 * ADAPT_STEPS + SINGLE_STEPS
        log(f"  launches on the adaptation path: {adapt_launches} over {total_steps} steps at batch 1")
        check(all(c == 3 * total_steps for c in adapt_launches.values()), f"adaptation launches {adapt_launches}")

        # the three NMS inputs of the first step: kernel == plain
        check(len(adapt_captured) == 3, f"captured {len(adapt_captured)} NMS calls in one adaptation step, expected 3")
        adapt_sites = ("teacher rpn (test mode)", "teacher detection", "student rpn (train mode)")
        for (b, s_, v, thr), site in zip(adapt_captured, adapt_sites):
            keep_k = nms.nms_mask_matrix(b, s_, v, thr)
            check(torch.equal(keep_k, plain_keep(b, s_, v, thr)), f"{site} NMS: kernel and plain keep masks differ")
            log(f"  {site} NMS N={b.shape[0]} thr={thr}: kernel == plain, kept {int(keep_k.sum())} of {int(v.sum())} valid")

        # the strong view on the card against the CPU's, on the trainer's
        # draws and on draws that apply every op
        images, sizes = main_tr.stage(main_batch)
        draws = main_tr.make_draws(1, tuple(images.shape[1:3]))
        every_op = draws.strong._replace(do=torch.ones_like(draws.strong.do))
        for what, d in (("drawn", draws.strong), ("every op", every_op)):
            err, n_over, n_px = strong_view_card_vs_cpu(images[0].float(), sizes[0], d)
            log(f"  strong view card vs CPU ({what}: ops {d.do[0].int().tolist()}): max diff {err:.4g}, "
                f"{n_over} of {n_px} values more than 1 uint8 step apart")
            check(err <= 2.0 and n_over <= 1e-4 * n_px, f"strong view ({what}): card vs CPU {err}, {n_over} over 1 step")

        # the bfloat16 step reads nothing back to the host
        images, sizes = main_tr.stage(main_batch)
        draws = main_tr.make_draws(1, tuple(images.shape[1:3]))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            m = main_tr.step_on_device(images, sizes, draws)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(all(np.isfinite(float(m[k])) for k in ADAPT_LOSSES), "sync-checked step: non-finite loss")
        log("  step_on_device (bfloat16, batch on the device) ran under set_sync_debug_mode('error')")

        # one bfloat16 step under the profiler
        torch.cuda.reset_peak_memory_stats()
        wall_a, dev_a, kern_a, ops_a = profile(lambda: main_tr.run_step(main_batch), 3)
        peak_a = torch.cuda.max_memory_allocated() / 2**30
        nms_a = sum(v for k, v in kern_a.items() if "suppress_relation_bits" in k or "greedy_keep_from_bits" in k)
        log(f"  profile bfloat16 adaptation step [{smi}]: wall {wall_a:.2f} ms, device kernels {dev_a:.2f} ms, "
            f"busy {dev_a / wall_a:.1%}, NMS kernels {nms_a:.3f} ms ({nms_a / dev_a:.1%} of device time), "
            f"peak memory {peak_a:.2f} GiB")
        log(f"  top kernels (ms/step): {top(kern_a)}")
        log(f"  top ops by device self time (ms/step): {top(ops_a, 12)}")
        del main_tr

        # the kernels on the step's three NMS inputs
        adapt_rows = {"suppress_relation_bits": [], "greedy_keep_from_bits": []}
        for (b, s_, v, thr), site in zip(adapt_captured, adapt_sites):
            r1, r2 = kernel_rows(b, s_, v, thr, site)
            adapt_rows["suppress_relation_bits"].append(r1)
            adapt_rows["greedy_keep_from_bits"].append(r2)

        for canvas, image_hw, held in (((128, 256), (120, 250), True), ((256, 512), (250, 500), False)):
            err = card_vs_cpu_adapt_step(canvas, image_hw)
            log(f"  card vs CPU, one float32 adaptation step at {canvas[0]}x{canvas[1]} (TF32 off"
                f"{'' if held else '; reported, not held: see card_vs_cpu_adapt_step'}): loss rel err " +
                format_errors(err, ADAPT_LOSSES) + f"; teacher BN stats rel err {err['teacher_bn'][0]:.3g} "
                f"({err['teacher_bn'][1]}); CPU " + ", ".join(f"{k} {err['losses_cpu'][k]:.4f}" for k in ADAPT_LOSSES) +
                f", num_pseudo {err['losses_cpu']['num_pseudo']:.0f}")
            if held:
                check(card_step_ok(err), f"adaptation step on the card differs from the CPU's: {err}")

    with Phase("eval"):
        # the host libraries, built in the build phase from the checkout's sources
        for name in ("imgcodec", "cocoeval"):
            log(f"  host library {name}: {os.path.basename(built[name])}, g++ {host_libs.BUILD_SECONDS.get(name, 0.0):.2f} s")
        log(f"  JPEG decode built in: {native_codec.has_jpeg()} (PNG decode needs no library)")
        eval_dir = tempfile.TemporaryDirectory(prefix="sfod_eval_")
        root = eval_dir.name
        try:
            t0 = time.perf_counter()
            path, recs, first = write_eval_dataset(root, EVAL_IMAGES, FRAME_HW)
            log(f"  wrote {EVAL_IMAGES} {FRAME_HW[0]}x{FRAME_HW[1]} PNG frames and their COCO JSON in "
                f"{time.perf_counter() - t0:.2f} s")
            got = native_codec.decode(os.path.join(root, "frame_0001.png"))
            check(got.shape == first.shape and np.array_equal(got, first), "first PNG decode differs from the array written")
            cfg = adapt_cfg(MAIN_CONFIG)
            cfg.OUTPUT_DIR = os.path.join(root, "output")
            for name in (*cfg.DATASETS.TEST, *cfg.DATASETS.TRAIN_TARGET):
                register_dataset(name, path, root, CITYSCAPES_THING_CLASSES)
            tr = adapt_trainer(cfg)
            loader = tr.build_train_loader()
            # host decode + resize, one thread, every record
            t0 = time.perf_counter()
            preps = [loader._prep_image(r) for r in loader.records]
            decode_ms = (time.perf_counter() - t0) * 1e3 / len(preps)
            check(all(p[0].shape == (600, 1200, 3) for p in preps), f"resized to {preps[0][0].shape}")
            log(f"  host decode + resize (PNG {FRAME_HW[0]}x{FRAME_HW[1]} -> 600x1200) [{smi}]: {decode_ms:.2f} ms an image "
                "(one thread)")
            del preps
            it = iter(loader)
            steps = []
            for _ in range(EVAL_STEPS):
                batch = next(it)
                check(tuple(batch["sizes"][0]) == (600, 1200), f"train batch size {batch['sizes']}")
                steps.append({k: float(v) for k, v in tr.run_step(batch).items()})
            it.close()
            check(all(np.isfinite(m[k]) for m in steps for k in ADAPT_LOSSES), f"adaptation losses {steps}")
            log(f"  {EVAL_STEPS} adaptation steps from trainer.build_train_loader(): total loss "
                f"{[round(m['total_loss'], 4) for m in steps]}, num_pseudo {[int(m['num_pseudo']) for m in steps]}")

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _kernels.reset_launches()
            t0 = time.perf_counter()
            results = tr.test()
            torch.cuda.synchronize()
            test_s = time.perf_counter() - t0
            eval_launches = dict(_kernels.LAUNCHES)
            peak_eval = torch.cuda.max_memory_allocated() / 2**30
            n_eval = 2 * len(cfg.DATASETS.TEST) * EVAL_IMAGES
            check(all(c == 2 * n_eval for c in eval_launches.values()),
                  f"test(): launches {eval_launches}, expected {2 * n_eval} of each (2 per image and model)")
            with open(os.path.join(cfg.OUTPUT_DIR, "eval_results.json")) as f:
                written = json.load(f)
            check(len(written) == 4 and all(
                isinstance(v.get(k), (int, float)) and np.isfinite(v[k]) for v in written.values() for k in ("AP", "AP50", "F1")
            ), f"eval_results.json: {written}")
            log(f"  trainer.test() [{smi}]: {test_s:.2f} s for {n_eval} images ({n_eval / test_s:.2f} images/s, the host "
                f"decode included), launches {eval_launches}, peak memory {peak_eval:.2f} GiB")
            for key, v in written.items():
                log(f"    {key}: AP {v['AP']:.4f} AP50 {v['AP50']:.4f} F1 {v['F1']:.4f} DECE {v['DECE']}")

            # the whole eval loop (loader, dispatch, read-back, evaluators) by
            # pipeline depth, on the teacher (the fixed bfloat16 one)
            name = cfg.DATASETS.TEST[0]
            rate = {}
            for depth in (1, 4, 1, 4):
                coco = COCOEvaluator(CITYSCAPES_THING_CLASSES)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                inference_on_dataset(tr.teacher, build_test_loader(cfg, name), CITYSCAPES_THING_CLASSES,
                                     [coco, F1Evaluator()], pipeline_depth=depth)
                rate.setdefault(depth, []).append(EVAL_IMAGES / (time.perf_counter() - t0))
            log(f"  eval loop [{smi}]: depth 1 {rate[1]} images/s, depth 4 {rate[4]} images/s ({EVAL_IMAGES} images, "
                f"batch {cfg.TEST.IMS_PER_BATCH}, {cfg.DATALOADER.NUM_WORKERS} decode threads)")
            native, plain = coco_map_native(coco._dets, coco._gts, 8), coco_map(coco._dets, coco._gts, 8)
            diff = max(abs(native[k] - plain[k]) for k in ("AP", "AP50", "AP75", "AR100") if np.isfinite(plain[k]))
            check(diff <= 1e-9 and all(np.isfinite(native[k]) == np.isfinite(plain[k]) for k in native if k.startswith("A")),
                  f"native COCO vs coco_map: {diff}")
            n_dets = sum(len(d["scores"]) for d in coco._dets.values())
            log(f"  native COCO evaluator vs plain coco_map on {n_dets} detections: max difference {diff:.3g} (tol 1e-9)")

            wall_e, dev_e, kern_e, ops_e = profile(
                lambda: inference_on_dataset(tr.teacher, build_test_loader(cfg, name), CITYSCAPES_THING_CLASSES,
                                             pipeline_depth=4), 1)
            nms_e = sum(v for k, v in kern_e.items() if "suppress_relation_bits" in k or "greedy_keep_from_bits" in k)
            log(f"  profile eval loop, depth 4 [{smi}]: wall {wall_e:.2f} ms, device kernels {dev_e:.2f} ms, busy "
                f"{dev_e / wall_e:.1%}, NMS kernels {nms_e:.3f} ms ({nms_e / EVAL_IMAGES:.3f} ms an image)")
            log(f"  top kernels (ms/pass): {top(kern_e)}")

            # a dispatch reads nothing back to the host
            staging = Staging(tr.teacher.device, 1)
            batch = next(iter(build_test_loader(cfg, name)))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                images, sizes = staging.stage(0, batch)
                dets = tr.teacher.infer(images, sizes)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            check(bool(torch.isfinite(dets.scores).all()), "sync-checked dispatch: non-finite scores")
            log("  staging + Detector.infer ran under set_sync_debug_mode('error')")

            res_card, res_cpu, (unpaired, box_err, score_err), n_small = card_vs_cpu_eval(root)
            metric_err = max(abs(res_card[k] - res_cpu[k]) for k in ("AP", "AP50", "F1"))
            log(f"  card vs CPU, float32 eval loop on {EVAL_SMALL['images']} images at {EVAL_SMALL['canvas']}: "
                f"{n_small} detections, {unpaired} unpaired, box err {box_err:.3g} px, score err {score_err:.3g}, "
                f"AP/AP50/F1 err {metric_err:.3g}")
            check(n_small > 0 and unpaired == 0 and box_err <= 1e-2 and score_err <= 1e-4 and metric_err <= 1e-6,
                  "card eval loop differs from the CPU's")
            del tr
        finally:
            eval_dir.cleanup()

    replaces = {
        "suppress_relation_bits": "simple_sfod_tpu/ops/pallas_kernels.py:26",
        "greedy_keep_from_bits": "simple_sfod_tpu/ops/pallas_kernels.py:123",
    }
    kernels = []
    for name in rows:
        # the main path, one adaptation step (batch 1): the kernel once per
        # NMS call site (teacher RPN, teacher detection, student RPN); the
        # numbers are the sum over the three sites, on the first step's
        # inputs. launches count every path: serve, train, adapt and eval
        # (trainer.test(), 2 per image and evaluated model).
        # per_call: one served image's two calls; train_per_step: one
        # supervised step's RPN call; large_n: N above the keep kernel's
        # shared-memory route (the row walk)
        per = adapt_rows[name]
        bound_by = max(per, key=lambda r: r["bound_ms"])["bound_by"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "simple_sfod_tpu_torch/ops/csrc/nms.cu",
            "replaces": replaces[name],
            "launches": launches[name] + train_launches[name] + adapt_launches[name] + eval_launches[name],
            "max_abs_err": float(max(r["err"] for r in per + rows[name] + large_rows[name])),
            "ms": sum(r["ms"] for r in per),
            "call_ms": sum(r["call_ms"] for r in per),
            "plain_ms": sum(r["plain_ms"] for r in per),
            "bound_ms": sum(r["bound_ms"] for r in per),
            "bound_by": bound_by,
            "library_ms": None,
            "ptxas": ptxas[name],
            "launches_by_path": {"serve": launches[name], "train": train_launches[name], "adapt": adapt_launches[name],
                                 "eval": eval_launches[name]},
            "adapt_per_step": per,
            "per_call": rows[name],
            "train_per_step": train_rows[0 if name == "suppress_relation_bits" else 1],
            "large_n": large_rows[name],
        })
    log(f"total wall {time.perf_counter() - t_start:.2f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
