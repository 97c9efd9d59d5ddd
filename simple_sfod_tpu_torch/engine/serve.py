"""HTTP detection service (the port of `simple_sfod_tpu/engine/serve.py`).

Two sources of detections, one service:

  an artifact   DetectionService("model.sfodx"): the program that
                `engine/export.py` wrote (tools/export_model.py), reloaded
                with this package's op library and without its model code,
                as the JAX service loads its StableHLO artifact;
  a config      DetectionService(cfg, weights): the detector built from a
                config and a port state dict (a `torch.save` file or an
                in-memory dict) and run eagerly.

Preprocessing and postprocessing are the JAX service's: shortest-edge
resize and canvas placement as the test loader does (the native codec's
Pillow-exact resample, so no PIL), boxes mapped back to file coordinates by
the per-axis inverse scale and clipped.

  GET  /          serving info (canvas, batch, classes, platforms)
  POST /predict   body = a PNG or JPEG file (data/native_codec.py) or a raw .npy
                  HxWx3 uint8 array; optional ?min_score=S
                  -> {"width", "height", "detections": [{"box" xyxy in file
                     coords, "score", "class", "class_name"}, ...]}

Concurrent requests micro-batch: each request runs on its own server
thread, and one worker coalesces up to `batch` of them into one device call.
A fixed-batch artifact runs its batch, padded; a poly-batch artifact takes up
to 8, padded to the next power of two as the JAX service does; the eager
detector runs exactly the images it was given.

    python -m simple_sfod_tpu_torch.tools.serve_model --artifact model.sfodx [--port 8360]
    python -m simple_sfod_tpu_torch.engine.serve --config-file configs/X.yaml \
        --weights model.pth [--port 8360] [--batch 4]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Union
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..data import native_codec
from ..data.loader import _resize_shortest_edge
from ..device import resolve_device

POLY_CALL_BATCH = 8  # the most requests one call of a poly-batch artifact takes


class _MicroBatcher:
    """Coalesce concurrent predict() calls into batched device calls.

    Submitting threads block on an event; one worker thread drains the
    queue -- it waits `max_wait_s` after the first arrival to let concurrent
    requests pile up, then runs `run_batch` on up to `max_batch` of them.
    `close()` stops the worker once the queue is empty."""

    def __init__(self, run_batch, max_batch: int, max_wait_s: float = 0.005):
        self._run_batch = run_batch
        self.max_batch = max(int(max_batch), 1)
        self.max_wait_s = float(max_wait_s)
        self._queue: List[dict] = []
        self._cv = threading.Condition()
        self._closed = False
        self.calls = 0  # device calls issued (observable for tests/metrics)
        self._gate = threading.Event()  # tests clear() to hold draining
        self._gate.set()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, payload):
        item = {"payload": payload, "done": threading.Event(), "out": None}
        with self._cv:
            if self._closed:
                raise RuntimeError("the service is closed")
            self._queue.append(item)
            self._cv.notify()
        item["done"].wait()
        if isinstance(item["out"], BaseException):
            raise item["out"]
        return item["out"]

    def close(self, timeout: float = 30.0) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout)
        if self._worker.is_alive():
            raise RuntimeError("micro-batcher worker did not stop")

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:
                    return
                if self.max_wait_s > 0:
                    # coalescing window: wake early once a full batch is queued
                    self._cv.wait_for(
                        lambda: len(self._queue) >= self.max_batch or self._closed,
                        timeout=self.max_wait_s,
                    )
            self._gate.wait()
            with self._cv:
                batch, self._queue = (
                    self._queue[: self.max_batch],
                    self._queue[self.max_batch :],
                )
            try:
                self.calls += 1
                outs = self._run_batch([it["payload"] for it in batch])
                for it, out in zip(batch, outs):
                    it["out"] = out
            except BaseException as e:  # deliver failures to the waiters
                for it in batch:
                    it["out"] = e
            for it in batch:
                it["done"].set()


def _load_weights(weights) -> Dict[str, torch.Tensor]:
    if isinstance(weights, str):
        weights = torch.load(weights, map_location="cpu", weights_only=True)
    if "model" in weights and isinstance(weights["model"], dict):
        weights = weights["model"]  # the fvcore Checkpointer wrapper
    return weights


def _input_shape(program, index: int):
    """The shape of user input `index` of an exported program."""
    names = [s.arg.name for s in program.graph_signature.input_specs if s.kind.name == "USER_INPUT"]
    node = next(n for n in program.graph.nodes if n.op == "placeholder" and n.name == names[index])
    return tuple(node.meta["val"].shape)


class DetectionService:
    """Detections with loader-parity pre/post-processing, from an exported
    artifact (`source` its path; `weights` the state dict of an artifact
    exported without its weights, the JAX service's `variables`) or from a
    config and `weights` (a state dict or a `torch.save` file), on `device`
    (None means CUDA and raises without a GPU). `batch` (the config route's)
    caps the requests a call coalesces; an artifact's batch is its own."""

    def __init__(
        self,
        source,
        weights: Union[None, str, Dict[str, torch.Tensor]] = None,
        device: Optional[Union[str, torch.device]] = None,
        batch: int = 1,
        max_wait_ms: float = 5.0,
        class_names: Optional[List[str]] = None,
        config_name: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        if isinstance(source, (str, os.PathLike)):
            self._init_artifact(os.fspath(source), weights)
        else:
            self._init_config(source, weights, batch, class_names, config_name)
        self._batcher = _MicroBatcher(
            self._run_batch,
            self.batch,
            max_wait_s=(max_wait_ms / 1000.0) if self.batch > 1 else 0.0,
        )

    def _init_artifact(self, path: str, weights) -> None:
        from .export import load_exported, weights_argument

        self.program, self.meta = load_exported(path, self.device)
        meta = self.meta
        if not meta.get("bundle_params", True) and weights is None:
            raise ValueError(
                "artifact was exported with --no-bundle-params; serving it requires the weights (a state dict)"
            )
        # the exported key order, on the program's device, the
        # 4-D weights in channels_last on CUDA (as the detector holds them)
        self.weights = None if weights is None else weights_argument(self.program, {
            k: v.to(self.device, memory_format=torch.channels_last)
            if v.dim() == 4 and self.device.type == "cuda" else v.to(self.device)
            for k, v in _load_weights(weights).items()
        })
        # images are the second-to-last input in both layouts
        shape = _input_shape(self.program, -2)
        self.canvas = tuple(meta.get("canvas") or shape[1:3])
        b = meta["batch"] if "batch" in meta else (shape[0] if isinstance(shape[0], int) else None)
        self.poly = not b
        self.batch = int(b) if b else POLY_CALL_BATCH
        self.min_size = int(meta.get("min_size", 600))
        self.max_size = int(meta.get("max_size", 1333))
        self.image_format = meta.get("image_format", "BGR")
        self.class_names = meta.get("class_names")
        self._info_batch = meta.get("batch", 1)
        self._model_name, self.config_name = meta.get("model"), meta.get("config")
        self._module = self.program.module()

    def _init_config(self, cfg, weights, batch, class_names, config_name) -> None:
        from ..config import detector_config_from_cfg
        from ..models.detector import Detector

        self.detector = Detector(detector_config_from_cfg(cfg), device=self.device)
        self.detector.load_state_dict(_load_weights(weights))
        self.canvas = tuple(int(v) for v in cfg.TPU.CANVAS)
        self.batch = max(int(batch), 1)
        self.poly = False
        self.min_size = int(cfg.INPUT.MIN_SIZE_TEST)
        self.max_size = int(cfg.INPUT.MAX_SIZE_TEST)
        self.image_format = cfg.INPUT.FORMAT
        self.class_names = class_names
        self._info_batch = self.batch
        self._model_name, self.config_name = "detector", config_name
        self._module = None

    def close(self) -> None:
        """Stop the micro-batch worker."""
        self._batcher.close()

    def info(self) -> Dict:
        return {
            "canvas": list(self.canvas),
            "batch": self._info_batch,
            "min_size": self.min_size,
            "max_size": self.max_size,
            "image_format": self.image_format,
            "class_names": self.class_names,
            "platforms": [self.device.type],
            "model": self._model_name,
            "config": self.config_name,
        }

    def _prepare(self, img: np.ndarray):
        """Loader-parity resize + canvas placement for one image ->
        (canvas [ch,cw,3] uint8, (h,w), scale, (ow,oh))."""
        oh, ow = img.shape[:2]
        resized, scale = _resize_shortest_edge(img, self.min_size, self.max_size)
        ch, cw = self.canvas
        h, w = min(resized.shape[0], ch), min(resized.shape[1], cw)
        canvas = np.zeros((ch, cw, 3), np.uint8)
        canvas[:h, :w] = np.clip(resized[:h, :w], 0, 255).astype(np.uint8)
        return canvas, (h, w), scale, (ow, oh)

    def call_batch(self, k: int) -> int:
        """The batch one call runs for k coalesced requests: k for the eager
        detector, a fixed artifact's batch, or the next power of two up to
        POLY_CALL_BATCH for a poly-batch artifact (a bounded set of shapes,
        as the JAX service keeps its compiled set)."""
        if self._module is None:
            return k
        if not self.poly:
            return self.batch
        return max(min(1 << (k - 1).bit_length(), self.batch), k)

    def infer(self, images: torch.Tensor, sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One device call on canvases [B, H, W, 3] uint8 and sizes [B, 2]
        int32 on the device -> the program's dict of detections."""
        if self._module is None:
            return vars(self.detector.infer(images, sizes))
        args = (images, sizes) if self.weights is None else (self.weights, images, sizes)
        with torch.inference_mode():
            return self._module(*args)

    def _run_batch(self, payloads: List[tuple]) -> List[Dict[str, np.ndarray]]:
        """One device call for the K <= batch prepared canvases, padded to
        `call_batch(K)`; returns each request's output slot."""
        k = len(payloads)
        b = self.call_batch(k)
        ch, cw = self.canvas
        images = np.zeros((b, ch, cw, 3), np.uint8)
        sizes = np.zeros((b, 2), np.int32)
        sizes[:] = payloads[0][1]  # pad slots reuse a real size (any valid hw)
        for i, (canvas, hw, _, _) in enumerate(payloads):
            images[i] = canvas
            sizes[i] = hw
        out = self.infer(torch.from_numpy(images).to(self.device), torch.from_numpy(sizes).to(self.device))
        out = {key: val.cpu().numpy() for key, val in out.items()}
        return [{key: val[i] for key, val in out.items()} for i in range(k)]

    def predict_array(self, img: np.ndarray, min_score: float = 0.0) -> Dict:
        """img: HxWx3 uint8 in the config's pixel format (INPUT.FORMAT)."""
        payload = self._prepare(img)
        out = self._batcher.submit(payload)
        _, _, scale, (ow, oh) = payload
        boxes, scores, classes = out["boxes"], out["scores"], out["classes"]
        keep = out["valid"] & (scores >= min_score)
        inv = 1.0 / np.maximum(np.concatenate([scale, scale]), 1e-8)
        file_boxes = np.clip(boxes[keep] * inv, 0, [ow, oh, ow, oh])
        dets = []
        for b, s, c in zip(file_boxes, scores[keep], classes[keep]):
            name = (
                self.class_names[int(c)]
                if self.class_names and 0 <= int(c) < len(self.class_names)
                else str(int(c))
            )
            dets.append(
                {"box": [float(v) for v in b], "score": float(s), "class": int(c), "class_name": name}
            )
        dets.sort(key=lambda d: -d["score"])
        return {"width": ow, "height": oh, "detections": dets}

    def predict_bytes(self, raw: bytes, min_score: float = 0.0) -> Dict:
        """Decode a PNG or JPEG file (the native codec) or a .npy uint8
        array, then predict."""
        if raw[:6] == b"\x93NUMPY":
            arr = np.load(io.BytesIO(raw), allow_pickle=False)
        else:
            arr = native_codec.decode_bytes(raw, "request body")
            if self.image_format == "BGR":
                arr = arr[:, :, ::-1]
        arr = np.ascontiguousarray(arr, np.uint8)
        if arr.ndim != 3 or arr.shape[2] != 3:
            raise ValueError(f"expected an HxWx3 image, got shape {arr.shape}")
        return self.predict_array(arr, min_score=min_score)


class _Handler(BaseHTTPRequestHandler):
    service: DetectionService  # set by make_server

    def log_message(self, fmt, *args):
        pass

    def _json(self, obj, code: int = 200):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if urlparse(self.path).path == "/":
            return self._json(self.service.info())
        return self._json({"error": "unknown endpoint"}, 404)

    def do_POST(self):
        parsed = urlparse(self.path)
        if parsed.path != "/predict":
            return self._json({"error": "unknown endpoint"}, 404)
        try:
            qs = parse_qs(parsed.query)
            min_score = float(qs.get("min_score", ["0"])[0])
            raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            return self._json(self.service.predict_bytes(raw, min_score=min_score))
        except Exception as e:  # the server keeps running; the client gets the error
            return self._json({"error": f"{type(e).__name__}: {e}"}, 400)


def make_server(service: "DetectionService", host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def serve_in_thread(service: DetectionService, host: str = "127.0.0.1", port: int = 0):
    """Start on a daemon thread; returns (server, base_url). Stop it with
    server.shutdown() and server.server_close()."""
    srv = make_server(service, host, port)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, f"http://{host}:{srv.server_address[1]}"


def main(argv=None):
    p = argparse.ArgumentParser(description="Serve detections over HTTP from a config and port weights.")
    p.add_argument("--config-file", required=True)
    p.add_argument("--weights", required=True, help="torch.save state dict of the port (or its {'model': ...} wrapper)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8360)
    p.add_argument("--batch", type=int, default=1, help="most requests coalesced into one device call")
    p.add_argument("--max-wait-ms", type=float, default=5.0, help="micro-batch coalescing window")
    p.add_argument("--device", default=None, help="default: cuda (fails without a GPU)")
    p.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    args = p.parse_args(argv)

    from ..config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    service = DetectionService(
        cfg, args.weights, device=args.device, batch=args.batch,
        max_wait_ms=args.max_wait_ms, config_name=args.config_file,
    )
    srv = make_server(service, args.host, args.port)
    info = service.info()
    print(
        f"serving {info['config']} ({info['canvas'][0]}x{info['canvas'][1]} canvas, "
        f"{info['platforms']}) on http://{args.host}:{srv.server_address[1]}/",
        flush=True,
    )
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        service.close()


if __name__ == "__main__":
    main()
