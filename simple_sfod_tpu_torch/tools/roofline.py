"""The roofline of the port's training steps and inference on the H100 (the
port of the JAX package's `tools/roofline.py`, which reads XLA's cost
model): the operations and bytes of one call, counted by `utils/cost.py`,
the least time the card could take for them, and with --measure the time it
takes and the share of that floor it reaches.

    python -m simple_sfod_tpu_torch.tools.roofline [--headline | --eval [--stages] [--scan K]
        | --serving --artifact FILE] [--batches 1 4 8] [--measure]
        [--steps-per-dispatch 10] [--windows 5] [--device cpu] [KEY VALUE ...]

Modes, one JSON line a mode and batch:
  (default)   the FPN supervised step: configs/vgg16_fpn_cityscapes_to_foggy_source.yaml
              at batch 1 on synthetic data;
  --headline  the SFAT adaptation step on `utils/bench.py:sfat_bench_cfg`;
  --eval      the forward paths of that configuration's detector by batch:
              with --stages `features` (the backbone and neck forward that
              `Detector.infer_from_feature` takes), `raw` (`Detector.infer_raw`:
              no class-wise NMS) and `full` (`Detector.infer`); `full` alone
              otherwise, over K batches back to back with --scan K;
  --serving   an artifact of `engine/export.py` (`tools/export_model.py`),
              loaded by `load_exported`, at each of --batches its batch allows.
KEY VALUE pairs override the configuration (a small canvas on the CPU).

Each line holds the counts (flops, elementwise_ops, bytes_min, bytes_eager,
the NMS terms), the floors in ms against the card's published peaks
(peak_flops, peak_bytes_per_s, machine_balance, bound_by), the device, and
the card's name and power limit as nvidia-smi prints them. On the card the
counted call's NMS kernel launches (`ops/_kernels.py:LAUNCHES`) are beside
the counted ones. --measure times the path as the JAX tool does: inputs
staged before the timer, fresh content in every window (one pixel varied,
or an offset), the steps of a window through `run_step_chunk` (the steps of
`run_steps` on one staged batch for --headline), each window closed by
`torch.cuda.synchronize()`, the median of --windows reported with
pct_of_roofline = 100 x floor / measured.

The tool runs on CUDA and raises without it; --device cpu prints the
counts only and refuses --measure (no CPU time is a device time).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

FPN_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "configs",
                        "vgg16_fpn_cityscapes_to_foggy_source.yaml")
# the JAX tool's eval timing: dispatches a window, input variants cycled
EVAL_DISPATCHES, EVAL_VARIANTS = 12, 6
# the benchmark batch's content size (utils/bench.py:synthetic_bench_batch)
CONTENT_HW = (600, 1200)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Operations, bytes and the H100 floor of a step or a forward path.")
    p.add_argument("--headline", action="store_true", help="the SFAT adaptation step")
    p.add_argument("--eval", action="store_true", help="the forward eval path")
    p.add_argument("--serving", action="store_true", help="an exported artifact (--artifact)")
    p.add_argument("--artifact", default=None, help="the artifact --serving loads")
    p.add_argument("--batches", nargs="*", type=int, default=[1, 4, 8])
    p.add_argument("--measure", action="store_true", help="also time the path on the card")
    p.add_argument("--stages", action="store_true", help="eval: features / raw (no NMS) / full")
    p.add_argument("--scan", type=int, default=1, help="eval: K batches back to back, reported a batch")
    p.add_argument("--steps-per-dispatch", type=int, default=10)
    p.add_argument("--windows", type=int, default=5)
    p.add_argument("--device", default=None, help="default cuda; cpu prints the counts only")
    p.add_argument("--output-dir", default="./output/roofline", help="the trainers' OUTPUT_DIR")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="KEY VALUE config overrides")
    return p.parse_args(argv)


def fpn_cfg(output_dir: str, opts=()):
    """The FPN source YAML at batch 1 on 8 synthetic images of its canvas,
    without checkpoints, evaluation or validation loss."""
    from ..config import get_cfg
    from ..data.synthetic import register_synthetic

    cfg = get_cfg()
    cfg.merge_from_file(FPN_YAML)
    cfg.merge_from_list(["SOLVER.IMS_PER_BATCH", "1", "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0",
                         "TEST.VAL_LOSS", "False", "TPU.MESH_DATA", "1", *opts])
    cfg.OUTPUT_DIR = output_dir
    register_synthetic("synthetic_train", 8, tuple(cfg.TPU.CANVAS), 8, seed=0)
    cfg.DATASETS.TRAIN = ("synthetic_train",)
    cfg.DATASETS.TEST = ()
    cfg.freeze()
    return cfg


def bench_cfg(output_dir: str, opts=(), trainer: str = "source_free_adaptive_teacher"):
    """`sfat_bench_cfg` with the KEY VALUE overrides."""
    from ..utils.bench import sfat_bench_cfg

    cfg = sfat_bench_cfg(trainer=trainer, output_dir=output_dir)
    if opts:
        cfg.defrost()
        cfg.merge_from_list(list(opts))
        cfg.freeze()
    return cfg


def content_sizes(canvas, n: int):
    """n content sizes: 600x1200, or the canvas where it is smaller."""
    import numpy as np

    hw = (min(CONTENT_HW[0], int(canvas[0])), min(CONTENT_HW[1], int(canvas[1])))
    return np.tile(np.asarray([hw], np.int32), (n, 1))


class Card:
    """The device a run counts and times on, and what the lines say of it."""

    def __init__(self, device: Optional[str], measure: bool):
        import torch

        from ..device import resolve_device
        from ..utils.cost import card_identity

        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        if measure and not self.cuda:
            raise ValueError("--measure times the card: it runs on CUDA only")
        name, limit = card_identity() if self.cuda else (None, None)
        self.fields = {"device": str(self.device), "gpu_name": name, "power_limit": limit}
        self.sync = torch.cuda.synchronize if self.cuda else (lambda: None)

    def launches(self):
        """The NMS kernels' launch counters (zeros off the card)."""
        from ..ops import _kernels

        return dict(_kernels.LAUNCHES)


def counted(card: Card, fn, *args, **kw):
    """`utils/cost.py:count` of fn(*args), with the kernels' own launch
    counts of the call on the card. -> (result, Cost, the line's count
    fields)."""
    from ..utils.cost import count

    before = card.launches()
    result, cost = count(fn, *args, **kw)
    card.sync()
    fields = cost.as_dict()
    if card.cuda:
        after = card.launches()
        fields["kernel_launches"] = {k: after[k] - before[k] for k in after}
    return result, cost, fields


# ---------------------------------------------------------------- training steps
def step_roofline(args, card: Card) -> dict:
    """The FPN supervised step, or (--headline) the SFAT step."""
    import torch

    from ..engine.trainers import build_trainer
    from ..utils.cost import trainer_tensors

    if args.headline:
        from ..utils.bench import synthetic_bench_batch

        cfg = bench_cfg(args.output_dir, args.opts)
        tr = build_trainer(cfg, device=card.device, synthetic=True)
        batch = synthetic_bench_batch(cfg)
        batch["sizes"] = content_sizes(cfg.TPU.CANVAS, len(batch["images"]))
        loader = None
        n_img = int(cfg.SOLVER.IMS_PER_BATCH_TARGET)
    else:
        cfg = fpn_cfg(args.output_dir, args.opts)
        tr = build_trainer(cfg, device=card.device, synthetic=True)
        loader = iter(tr.build_train_loader())
        batch = dict(next(loader))
        n_img = int(cfg.SOLVER.IMS_PER_BATCH)
    state, trained, opt_state = trainer_tensors(tr)
    _, cost, fields = counted(card, tr.step_staged, tr.stage(batch), state=state, trained=trained,
                              optimizer_state=opt_state)
    out = {
        "workload": "sfat_headline" if args.headline else "fpn_supervised",
        "canvas": list(cfg.TPU.CANVAS),
        "batch": n_img,
        "dtype": cfg.TPU.DTYPE,
        "flops_per_step": cost.flops,
        "hbm_bytes_per_step": cost.bytes_min,
        **fields,
        **card.fields,
    }
    if not args.measure:
        return out

    k = args.steps_per_dispatch

    def fresh(tag: int) -> list:
        """A chunk's batches (--headline: one batch k times), each with one
        pixel set to the tag."""
        bs = [dict(b, images=b["images"].copy()) for b in ([batch] if loader is None else
                                                           [next(loader) for _ in range(k)])]
        for b in bs:
            b["images"][0, 0, 0, 0] = tag % 251
        return bs * k if loader is None else bs

    def prestage(bs: list):
        """The chunk on the card before the timer: `run_steps`'s one staged
        batch k times (--headline), or each batch staged."""
        xs = tr.stage_chunk(bs[:1]) * k if loader is None else tr.stage_chunk(bs)
        torch.cuda.synchronize()
        return bs, xs

    t0 = time.perf_counter()
    bs, xs = prestage(fresh(0))
    tr.run_step_chunk(bs, xs=xs)
    torch.cuda.synchronize()
    out["first_dispatch_s"] = time.perf_counter() - t0
    rates, tag = [], 1
    for _ in range(args.windows):
        chunks = [prestage(fresh(tag + i)) for i in range(3)]
        tag += 3
        t0 = time.perf_counter()
        for bs, xs in chunks:
            tr.run_step_chunk(bs, xs=xs)
        torch.cuda.synchronize()
        rates.append(3 * k * n_img / (time.perf_counter() - t0))
    med = sorted(rates)[len(rates) // 2]
    out["steps_per_dispatch"] = k
    out["measured_imgs_per_sec"] = med
    out["measured_ms_per_step"] = 1e3 * n_img / med
    out["pct_of_roofline"] = 100.0 * fields["floor_ms"] / out["measured_ms_per_step"]
    out["windows"] = rates
    return out


# ---------------------------------------------------------------- forward paths
def eval_calls(args, card: Card):
    """-> (canvas, [(stage, call(images, sizes), state tensors, K batches a
    call)]) for --eval or --serving."""
    import torch

    from ..utils.cost import module_tensors

    if args.serving:
        from ..engine.export import load_exported

        if not args.artifact:
            raise ValueError("--serving needs --artifact FILE (tools/export_model.py writes one)")
        program, meta = load_exported(args.artifact, card.device)
        module = program.module()
        served = torch.inference_mode()(module)  # as engine/serve.py calls it
        allowed = meta.get("batch")  # None: a symbolic batch
        bad = [b for b in args.batches if allowed is not None and int(allowed) != b]
        if bad:
            raise ValueError(f"the artifact's batch is {allowed}; --batches {bad} cannot run on it")
        return tuple(meta["canvas"]), [("full", served, module_tensors(module), 1)], meta

    from ..engine.trainers import build_trainer

    cfg = bench_cfg(args.output_dir, args.opts)
    det = build_trainer(cfg, device=card.device, synthetic=True).detector
    state = module_tensors(det.model)

    @torch.inference_mode()
    def features(images, sizes):
        return det.model.features(images, train=False)

    def scanned(images, sizes):
        return [det.infer(images[j], sizes[j]) for j in range(images.shape[0])]

    if args.stages:
        calls = [("features", features, state, 1), ("raw", det.infer_raw, state, 1), ("full", det.infer, state, 1)]
    elif args.scan > 1:
        calls = [("full", scanned, state, args.scan)]
    else:
        calls = [("full", det.infer, state, 1)]
    return tuple(cfg.TPU.CANVAS), calls, None


def eval_roofline(args, card: Card) -> List[dict]:
    """One line a batch and stage (module docstring)."""
    import numpy as np
    import torch

    canvas, calls, meta = eval_calls(args, card)
    lines = []
    for b in args.batches:
        for stage, call, state, kfac in calls:
            rs = np.random.RandomState(0)
            lead = (kfac, b) if kfac > 1 else (b,)
            sizes = torch.from_numpy(content_sizes(canvas, b)).to(card.device)
            if kfac > 1:
                sizes = sizes.expand(kfac, b, 2).contiguous()
            variants = [torch.from_numpy(rs.randint(0, 256, (*lead, *canvas, 3)).astype(np.uint8)).to(card.device)
                        for _ in range(EVAL_VARIANTS)]
            card.sync()
            _, cost, fields = counted(card, call, variants[0], sizes, state=state)
            cost = cost.scaled(kfac)
            fields.update(cost.as_dict())
            if "kernel_launches" in fields:
                fields["kernel_launches"] = {n: c // kfac for n, c in fields["kernel_launches"].items()}
            out = {
                "workload": "serving_artifact" if args.serving else "eval_forward",
                "stage": stage,
                "canvas": list(canvas),
                "batch": b,
                "scan": kfac,
                "flops_per_batch": cost.flops,
                "hbm_bytes_per_batch": cost.bytes_min,
                **fields,
                **card.fields,
            }
            if meta is not None:
                out["artifact"] = {k: meta.get(k) for k in ("batch", "model", "params_dtype", "config")}
            if args.measure:
                t0 = time.perf_counter()
                call(variants[0], sizes)
                torch.cuda.synchronize()
                out["first_call_s"] = time.perf_counter() - t0
                rates = []
                for w in range(args.windows):
                    # every dispatch its own content, made before the timer
                    win = [variants[i % EVAL_VARIANTS] + (1 + (w * EVAL_DISPATCHES + i) % 250)
                           for i in range(EVAL_DISPATCHES)]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for v in win:
                        call(v, sizes)
                    torch.cuda.synchronize()
                    rates.append(EVAL_DISPATCHES * b * kfac / (time.perf_counter() - t0))
                med = sorted(rates)[len(rates) // 2]
                out["measured_imgs_per_sec"] = med
                out["measured_ms_per_batch"] = 1e3 * b / med
                out["pct_of_roofline"] = 100.0 * fields["floor_ms"] / out["measured_ms_per_batch"]
                out["windows"] = rates
            print(json.dumps(out), flush=True)
            lines.append(out)
    return lines


def main(argv=None) -> List[dict]:
    """Run the tool; -> the lines it printed, as dicts."""
    args = parse_args(argv)
    card = Card(args.device, args.measure)
    if args.eval or args.serving:
        return eval_roofline(args, card)
    out = step_roofline(args, card)
    print(json.dumps(out), flush=True)
    return [out]


if __name__ == "__main__":
    main()
