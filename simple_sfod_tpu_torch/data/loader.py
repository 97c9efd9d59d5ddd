"""Host batch assembly (the port of `simple_sfod_tpu/data/loader.py`).

File records are decoded and resized by the port's native codec
(data/native_codec.py: PNG, JPEG, BMP, DIB, GIF, TIFF, WebP, Netpbm, ICO,
CUR, QOI, SGI, PCX, DCX and TGA, by the port's own decoders; the
Pillow-exact bilinear resample), array and synthetic
records resized by the same resample, so neither PIL nor another decoder is
needed. Each batch is a dict of fixed-shape numpy arrays: uint8 canvases
(the device casts them), true sizes, per-axis resize scales, padded ground
truth, image ids and the records' file sizes.

Every random draw (the train stream's permutations and the per-image
MIN_SIZE_TRAIN "choice") happens on the iterator thread in record order, so
a stream depends only on its seed, whatever the number of decode threads.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..structures.instances import Instances
from . import native_codec
from .datasets import get_dataset
from .synthetic import synthetic_image


class ArrayBatch(dict):
    """A batch: images [B, H, W, 3] uint8, sizes [B, 2] int32, scale [B, 2]
    float32 (sx, sy), gt_boxes [B, N, 4] float32, gt_classes [B, N] int32,
    gt_valid [B, N] bool, image_ids [B] int64, heights [B] and widths [B]
    int32 (the records' file sizes)."""


def d2_output_shape(h: int, w: int, min_size: int, max_size: int) -> Tuple[int, int]:
    """detectron2 ResizeShortestEdge.get_output_shape, bit-exact: the shorter
    edge goes to min_size unless the max_size cap applies, and the final dims
    round half up via int(x + 0.5)."""
    size = float(min_size)
    scale = size / min(h, w)
    if h < w:
        newh, neww = size, scale * w
    else:
        newh, neww = scale * h, size
    if max(newh, neww) > max_size:
        s = max_size / max(newh, neww)
        newh, neww = newh * s, neww * s
    return int(newh + 0.5), int(neww + 0.5)


def _resize_shortest_edge(img: np.ndarray, min_size: int, max_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Shortest-edge resize, as detectron2's ResizeTransform (PIL BILINEAR on
    uint8), by the native resample, which is bit-exact with PIL. Returns
    (image, scale_xy [2] float32): the resized image is uint8 (the input's
    values cast to uint8 first, as PIL receives them); an image already at
    its output size is returned as it is."""
    h, w = img.shape[:2]
    nh, nw = d2_output_shape(h, w, min_size, max_size)
    if (nh, nw) == (h, w):
        return img, np.ones((2,), np.float32)
    out = native_codec.resize_bilinear(np.asarray(img).astype(np.uint8), nh, nw)
    return out, np.asarray([nw / w, nh / h], np.float32)


class DetectionLoader:
    """Iterates fixed-shape batches over a list of dataset records.

    training=False: one pass in record order, the final batch padded by
    repeating its last record. training=True: an infinite stream of
    concatenated seeded permutations (detectron2's TrainingSampler), each
    image at a MIN_SIZE_TRAIN drawn per image when it has several values.
    prefetch > 0 builds batches on a background thread, up to `prefetch`
    ahead; decode_threads > 1 decodes a batch's file records in parallel.
    """

    def __init__(
        self,
        records: List[dict],
        batch_size: int,
        canvas_hw: Tuple[int, int],
        min_size,
        max_size: int = 1333,
        gt_capacity: int = 64,
        training: bool = True,
        seed: int = 0,
        input_format: str = "BGR",
        synthetic: bool = False,
        prefetch: int = 2,
        decode_threads: int = 1,
    ):
        assert records, "empty dataset"
        self.records = records
        self.batch_size = batch_size
        self.canvas_hw = canvas_hw
        self.min_sizes = tuple(int(s) for s in min_size) if hasattr(min_size, "__len__") else (int(min_size),)
        self.min_size = self.min_sizes[0]
        self.max_size = max_size
        if training and len(self.min_sizes) > 1:
            # every sampled scale must fit the canvas: an overflowing one
            # would be cropped with its ground truth clipped, silently
            try:
                hs = np.asarray([r["height"] for r in records])
                ws = np.asarray([r["width"] for r in records])
            except KeyError:
                import warnings

                warnings.warn(
                    "records lack height/width; the MIN_SIZE_TRAIN canvas-overflow check is skipped and "
                    "oversized samples will only surface at the runtime crop"
                )
                hs = ws = None
            if hs is not None:
                for ms in self.min_sizes:
                    shapes = [d2_output_shape(int(h), int(w), ms, max_size) for h, w in zip(hs, ws)]
                    bad = [(nh, nw) for nh, nw in shapes if nh > canvas_hw[0] or nw > canvas_hw[1]]
                    if bad:
                        raise ValueError(
                            f"MIN_SIZE_TRAIN choice {ms} resizes {len(bad)} image(s) beyond TPU.CANVAS "
                            f"{tuple(canvas_hw)} (worst {max(bad)}); raise TPU.CANVAS to fit the largest "
                            "training scale"
                        )
        self.gt_capacity = gt_capacity
        self.training = training
        self.rng = np.random.RandomState(seed)
        self.input_format = input_format
        self.synthetic = synthetic
        self.prefetch = prefetch
        self.decode_threads = max(1, int(decode_threads))
        self._pool = None  # ThreadPoolExecutor for per-image decode, made at first use

    def __len__(self):
        return (len(self.records) + self.batch_size - 1) // self.batch_size

    def _prep_image(self, rec: dict, min_size: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """One record -> (shortest-edge-resized uint8 image, scale_xy).
        File records: native decode (RGB, flipped to BGR for INPUT.FORMAT
        BGR) and resize. Array ("image") and synthetic records: the
        float32 image, resized and cast as the JAX loader does. `min_size`
        carries the per-image "choice" draw; None takes the first size."""
        min_size = self.min_size if min_size is None else min_size
        if not (self.synthetic or "image" in rec):
            arr = native_codec.decode(rec["file_name"])
            out, scale = _resize_shortest_edge(arr, min_size, self.max_size)
            if self.input_format == "BGR":
                out = out[:, :, ::-1]
            return out, scale
        img = np.asarray(rec["image"], np.float32) if "image" in rec else synthetic_image(rec)
        img, scale = _resize_shortest_edge(img, min_size, self.max_size)
        return np.clip(img, 0, 255).astype(np.uint8), scale

    def _make_batch(self, recs: List[dict]) -> ArrayBatch:
        b = len(recs)
        ch, cw = self.canvas_hw
        n = self.gt_capacity
        images = np.zeros((b, ch, cw, 3), np.uint8)
        sizes = np.zeros((b, 2), np.int32)
        scales = np.ones((b, 2), np.float32)
        gt_boxes = np.zeros((b, n, 4), np.float32)
        gt_classes = np.zeros((b, n), np.int32)
        gt_valid = np.zeros((b, n), bool)
        image_ids = np.zeros((b,), np.int64)
        heights = np.zeros((b,), np.int32)
        widths = np.zeros((b,), np.int32)

        # the per-image shortest-edge draw, here on the iterator thread
        if self.training and len(self.min_sizes) > 1:
            msizes = [int(self.rng.choice(self.min_sizes)) for _ in recs]
        else:
            msizes = [self.min_size] * len(recs)
        if self.decode_threads > 1 and len(recs) > 1 and not self.synthetic:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(max_workers=self.decode_threads, thread_name_prefix="sfod-decode")
            preps = list(self._pool.map(self._prep_image, recs, msizes))
        else:
            preps = [self._prep_image(rec, ms) for rec, ms in zip(recs, msizes)]

        for i, (rec, (img, scale)) in enumerate(zip(recs, preps)):
            h, w = img.shape[:2]
            cropped = h > ch or w > cw  # outlier aspect ratios at a single size
            h, w = min(h, ch), min(w, cw)
            images[i, :h, :w] = img[:h, :w]
            sizes[i] = (h, w)
            scales[i] = scale
            image_ids[i] = rec["image_id"]
            heights[i] = rec["height"]
            widths[i] = rec["width"]
            boxes = np.asarray(rec["boxes"], np.float32).reshape(-1, 4) * np.concatenate([scale, scale])
            classes = np.asarray(rec["classes"], np.int32)
            k = min(len(boxes), n)
            if len(boxes) > n:  # over capacity: keep the largest boxes
                areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
                keep = np.argsort(-areas)[:n]
                boxes, classes = boxes[keep], classes[keep]
            if cropped:
                # clip the scaled GT to the placed extent and drop boxes that
                # fell outside it
                boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w)
                boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h)
                alive = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            else:
                alive = np.ones((len(boxes),), bool)
            gt_boxes[i, :k] = boxes[:k]
            gt_classes[i, :k] = classes[:k]
            gt_valid[i, :k] = alive[:k]

        return ArrayBatch(
            images=images,
            sizes=sizes,
            scale=scales,
            gt_boxes=gt_boxes,
            gt_classes=gt_classes,
            gt_valid=gt_valid,
            image_ids=image_ids,
            heights=heights,
            widths=widths,
        )

    def _index_stream(self) -> Iterator[List[int]]:
        n = len(self.records)
        if not self.training:
            for s in range(0, n, self.batch_size):
                idx = list(range(s, min(s + self.batch_size, n)))
                while len(idx) < self.batch_size:  # pad the final batch by repeat
                    idx.append(idx[-1])
                yield idx
            return
        # one infinite stream of concatenated epoch permutations, cut into
        # batches that may span epochs (a dataset smaller than a batch works)
        pool: List[int] = []
        while True:
            while len(pool) < self.batch_size:
                pool.extend(self.rng.permutation(n).tolist())
            yield pool[: self.batch_size]
            del pool[: self.batch_size]

    def __iter__(self) -> Iterator[ArrayBatch]:
        stream = self._index_stream()
        if self.prefetch <= 0:
            for idx in stream:
                yield self._make_batch([self.records[i] for i in idx])
            return

        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        # bound here: a generator closed at interpreter exit may find the
        # module's globals already cleared
        full, empty = queue_mod.Full, queue_mod.Empty
        stop = object()
        abandoned = threading.Event()
        err: list = []

        def worker():
            try:
                for idx in stream:
                    if abandoned.is_set():
                        # build (and draw for) no batch nobody will take: a
                        # stale worker beside a fresh iteration would
                        # interleave the generator's draws
                        return
                    batch = self._make_batch([self.records[i] for i in idx])
                    while not abandoned.is_set():
                        try:
                            q.put(batch, timeout=0.5)
                            break
                        except full:
                            continue
                    if abandoned.is_set():
                        return
            except BaseException as e:  # raised again in the consumer
                err.append(e)
            finally:
                while not abandoned.is_set():
                    try:
                        q.put_nowait(stop)
                        break
                    except full:
                        abandoned.wait(0.1)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # the consumer left (a break, or the end): retire the worker
            abandoned.set()
            try:
                while True:
                    q.get_nowait()
            except empty:
                pass


def gt_instances(batch: Mapping[str, np.ndarray], device: torch.device) -> Instances:
    """The padded ground truth of a batch in the loader's layout (gt_boxes
    [B, M, 4], gt_classes [B, M], gt_valid [B, M]) as Instances on `device`,
    with scores 1."""

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

    classes = t(batch["gt_classes"], torch.int32)
    return Instances(
        boxes=t(batch["gt_boxes"], torch.float32),
        scores=torch.ones(classes.shape, dtype=torch.float32, device=device),
        classes=classes,
        valid=t(batch["gt_valid"], torch.bool),
    )


def divide_label_unlabel(records, sup_percent: float, random_seed: int):
    """Seeded labelled/unlabelled split: DATALOADER.SUP_PERCENT of the set is
    labelled, chosen by RANDOM_DATA_SEED. Returns (labelled, unlabelled)."""
    n = len(records)
    n_label = int(n * sup_percent / 100.0)
    rs = np.random.RandomState(random_seed)
    perm = rs.permutation(n)
    labeled = [records[i] for i in sorted(perm[:n_label])]
    unlabeled = [records[i] for i in sorted(perm[n_label:])]
    return labeled, unlabeled


def build_train_loader(cfg, dataset_names=None, batch_size=None, seed=None, labeled=True, **kw):
    """The train loader of DATASETS.TRAIN (or `dataset_names`): images
    without annotations dropped under DATALOADER.FILTER_EMPTY_ANNOTATIONS
    before the SUP_PERCENT split; DATALOADER.NUM_WORKERS is both the prefetch
    depth and the decode thread count (0: synchronous)."""
    names = dataset_names or cfg.DATASETS.TRAIN
    records = []
    for name in names:
        records.extend(get_dataset(name)["records"])
    if cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS:
        records = [r for r in records if len(r.get("boxes", ()))]
    sup = float(cfg.DATALOADER.SUP_PERCENT)
    if sup < 100.0:
        lab, unlab = divide_label_unlabel(records, sup, cfg.DATALOADER.RANDOM_DATA_SEED)
        records = lab if labeled else unlab
    return DetectionLoader(
        records,
        batch_size or cfg.SOLVER.IMS_PER_BATCH,
        tuple(cfg.TPU.CANVAS),
        tuple(cfg.INPUT.MIN_SIZE_TRAIN),
        cfg.INPUT.MAX_SIZE_TRAIN,
        cfg.TPU.GT_CAPACITY,
        training=True,
        seed=cfg.SEED if seed is None else seed,
        input_format=cfg.INPUT.FORMAT,
        **{
            "prefetch": int(cfg.DATALOADER.NUM_WORKERS),
            "decode_threads": int(cfg.DATALOADER.NUM_WORKERS),
            **kw,
        },
    )


def build_test_loader(cfg, dataset_name, **kw):
    """The test loader of one dataset: every image, in record order."""
    records = get_dataset(dataset_name)["records"]
    return DetectionLoader(
        records,
        cfg.TEST.IMS_PER_BATCH,
        tuple(cfg.TPU.CANVAS),
        cfg.INPUT.MIN_SIZE_TEST,
        cfg.INPUT.MAX_SIZE_TEST,
        cfg.TPU.GT_CAPACITY,
        training=False,
        input_format=cfg.INPUT.FORMAT,
        **{"decode_threads": int(cfg.DATALOADER.NUM_WORKERS), **kw},
    )
