#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build the Hopper kernels,
hold each against its plain PyTorch version, serve full-width detections
over HTTP, and check what comes out.

    python3 chip_smoke.py

Phases (each prints one progress line with its wall time):
  1. device   the card's name and power limit; fails without CUDA
  2. build    nvcc builds simple_sfod_tpu_torch/ops/csrc/nms.cu
  3. kernels  suppress_relation_bits and greedy_keep_from_bits against their
              plain versions on seeded boxes (ties, invalid and zero-area
              boxes, class-offset boxes); bitmasks and keep masks must be
              equal bit for bit
  4. serve    the main configuration (VGG16-BN, 8 classes, 608x1216 canvas,
              bfloat16) with seeded weights behind the HTTP server; 4
              requests of seeded 600x1200 uint8 images, two of them
              concurrent; both NMS kernels must launch for every image, and
              on the NMS inputs captured from one request kernel and plain
              keep masks must be equal
  5. profile  the served detector without HTTP: median latency at batch 1
              and 2, then one image under torch.profiler (device time, busy
              share, top kernels and ops, peak memory)
  6. check    the same weights in float32 on a small canvas: the card's
              detections agree with the port's CPU path (which the CPU tests
              hold to the JAX package)
  7. timing   each kernel on the captured inputs: its device time (profiler),
              its time a call (CUDA events over back-to-back calls), its
              plain version's time and its bound

Prints the card's name and power limit and a JSON line of the kernels'
numbers, then, as the last line, {"ok": true, "device": {...}}. Any failure
raises and the exit code is not 0.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_main_cfg
from simple_sfod_tpu_torch.engine.serve import DetectionService, serve_in_thread
from simple_sfod_tpu_torch.models.detector import Detector
from simple_sfod_tpu_torch.models.faster_rcnn import FasterRCNN, init_weights
from simple_sfod_tpu_torch.ops import _kernels, nms

SEED = 0
N_REQUESTS = 4
IMAGE_HW = (600, 1200)  # Cityscapes' 1024x2048 after the shortest-edge-600 resize
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 flop/s
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
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


def check_kernels_against_plain(boxes, scores, valid, thr, label):
    sb, sv = sorted_inputs(boxes, scores, valid)
    rel = nms.suppress_relation_plain(sb, sv, thr)
    bits_k = _kernels.launch_suppress_relation_bits(sb, sv, thr)
    bits_p = nms.pack_bits(rel)
    torch.cuda.synchronize()
    if not torch.equal(bits_k, bits_p):
        bad = (bits_k != bits_p).sum().item()
        raise AssertionError(f"{label}: suppress_relation_bits differs from plain in {bad} words")
    keep_k = _kernels.launch_greedy_keep_from_bits(bits_k, sv)
    keep_p = nms.greedy_keep_plain(rel, sv)
    torch.cuda.synchronize()
    if not torch.equal(keep_k, keep_p):
        raise AssertionError(f"{label}: greedy_keep_from_bits differs from plain")
    full_k = nms.nms_mask_matrix(boxes, scores, valid, thr)
    full_cpu = nms.nms_mask_matrix(boxes.cpu(), scores.cpu(), valid.cpu(), thr)
    if not torch.equal(full_k.cpu(), full_cpu) or not torch.equal(full_k, plain_keep(boxes, scores, valid, thr)):
        raise AssertionError(f"{label}: nms_mask_matrix on the card differs from the plain path")
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
        t0 = time.perf_counter()
        path = _kernels.build("nms")
        _kernels.load_all()
        log(f"build: {path} in {time.perf_counter() - t0:.2f} s (nvcc {_kernels.BUILD_SECONDS.get('nms', 0.0):.2f} s)")

    with Phase("kernels vs plain"):
        rng = np.random.RandomState(SEED)
        cases = [
            ("N=4096 thr=0.7", 4096, 3900, 0.7, 0),
            ("N=1024 thr=0.5 class-offset", 1024, 1000, 0.5, 8),
            ("N=1000 thr=0.5", 1000, 1000, 0.5, 0),
            ("N=1 thr=0.5", 1, 1, 0.5, 0),
            ("N=257 thr=0.7 0 valid", 257, 0, 0.7, 0),
        ]
        for label, n, n_valid, thr, ncls in cases:
            b, s, v = case_boxes(rng, n, n_valid, classes=ncls)
            kept = check_kernels_against_plain(b, s, v, thr, label)
            log(f"  {label}: bit-equal, kept {kept}")

    with Phase("serve"):
        cfg = get_main_cfg()
        cfg.freeze()
        det_cfg = detector_config_from_cfg(cfg)
        check(det_cfg.dtype == torch.bfloat16 and tuple(cfg.TPU.CANVAS) == (608, 1216), "main config")
        state = init_weights(FasterRCNN(det_cfg), SEED).state_dict()
        service = DetectionService(cfg, state, batch=2, max_wait_ms=10.0, config_name="main")
        srv, url = serve_in_thread(service)
        captured = []
        orig_nms = nms.nms_mask_matrix
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

            def record(boxes, scores, valid, thr):
                captured.append((boxes.clone(), scores.clone(), valid.clone(), thr))
                return orig_nms(boxes, scores, valid, thr)

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
            launches = dict(_kernels.LAUNCHES)
        finally:
            nms.nms_mask_matrix = orig_nms
            srv.shutdown()
            srv.server_close()
            service.close()

        for k, c in launches.items():
            if c < 2 * N_REQUESTS:
                raise AssertionError(f"{k} launched {c} times for {N_REQUESTS} images, expected >= {2 * N_REQUESTS}")
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
            sb, sv = sorted_inputs(b, s, v)
            bits = _kernels.launch_suppress_relation_bits(sb, sv, thr)
            keep = _kernels.launch_greedy_keep_from_bits(bits, sv)
            rel = nms.suppress_relation_plain(sb, sv, thr)
            call1 = time_ms(lambda: _kernels.launch_suppress_relation_bits(sb, sv, thr), 200)
            p1 = time_ms(lambda: nms.pack_bits(nms.suppress_relation_plain(sb, sv, thr)), 20)
            call2 = time_ms(lambda: _kernels.launch_greedy_keep_from_bits(bits, sv), 200)
            p2 = time_ms(lambda: nms.greedy_keep_plain(rel, sv), 5, warmup=1)
            # the kernels' own device time, from the profiler's kernel events
            _, _, kern1, _ = profile(lambda: _kernels.launch_suppress_relation_bits(sb, sv, thr), 50)
            _, _, kern2, _ = profile(lambda: _kernels.launch_greedy_keep_from_bits(bits, sv), 50)
            k1 = sum(v for name, v in kern1.items() if "suppress_relation_bits_kernel" in name)
            k2 = sum(v for name, v in kern2.items() if "greedy_keep_from_bits_kernel" in name)
            check(k1 > 0 and k2 > 0, f"profiler saw no kernel time: {kern1} {kern2}")
            b1, by1 = kernel1_bound_ms(sv)
            b2, by2 = kernel2_bound_ms(keep)
            err1 = int((bits != nms.pack_bits(rel)).sum().item())
            err2 = int((keep != nms.greedy_keep_plain(rel, sv)).sum().item())
            n = int(sb.shape[0])
            rows["suppress_relation_bits"].append(dict(site=site, n=n, thr=thr, ms=k1, call_ms=call1, plain_ms=p1, bound_ms=b1, bound_by=by1, err=err1))
            rows["greedy_keep_from_bits"].append(dict(site=site, n=n, thr=thr, ms=k2, call_ms=call2, plain_ms=p2, bound_ms=b2, bound_by=by2, err=err2))
            log(f"  {site} N={n} valid={int(sv.sum())} kept={int(keep.sum())}: suppress_relation_bits {k1 * 1e3:.2f} us on the device, "
                f"{call1 * 1e3:.1f} us a call (plain {p1 * 1e3:.1f} us, bound {b1 * 1e3:.2f} us {by1}); "
                f"greedy_keep_from_bits {k2 * 1e3:.2f} us on the device, {call2 * 1e3:.1f} us a call "
                f"(plain {p2 * 1e3:.1f} us, bound {b2 * 1e3:.3f} us {by2})")

    replaces = {
        "suppress_relation_bits": "simple_sfod_tpu/ops/pallas_kernels.py:26",
        "greedy_keep_from_bits": "simple_sfod_tpu/ops/pallas_kernels.py:123",
    }
    kernels = []
    for name, per in rows.items():
        # one served image runs the kernel once per NMS call site: the
        # numbers are the sum over both sites, on the inputs of request 1
        bound_by = max(per, key=lambda r: r["bound_ms"])["bound_by"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "simple_sfod_tpu_torch/ops/csrc/nms.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": float(max(r["err"] for r in per)),
            "ms": sum(r["ms"] for r in per),
            "call_ms": sum(r["call_ms"] for r in per),
            "plain_ms": sum(r["plain_ms"] for r in per),
            "bound_ms": sum(r["bound_ms"] for r in per),
            "bound_by": bound_by,
            "library_ms": None,
            "per_call": per,
        })
    log(f"total wall {time.perf_counter() - t_start:.2f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
