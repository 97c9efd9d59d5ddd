"""Checkpoints as Detectron2/fvcore files (the port of
`simple_sfod_tpu/checkpoint/checkpointer.py`, which writes orbax
directories).

A checkpoint is `<OUTPUT_DIR>/<name>.pth`, a `torch.save` of

    {"model":     Detectron2-named float32 tensors (the detector, or
                  modelTeacher.* then modelStudent.* for a teacher-student
                  state: what the JAX package's torch_export.export_train_state
                  writes for the same state),
     "iteration": steps taken,
     "optimizer": {"count": int, "mu": {parameter name: momentum}},
     "trainer":   what else a resume needs (generator states, the domain
                  classifiers, the adaptive-threshold statistics)}

and `last_checkpoint` (fvcore's marker) holds the newest file's name. Files
hold only tensors, numbers and strings, and are read with
`torch.load(weights_only=True)`.

`save(block=False)` snapshots the state to host memory on the caller's
thread and writes it on a non-daemon thread, so the loop does not wait for
the disk; the file is written under a temporary name and renamed, and the
marker is written only after that, so a resume never sees a half-written
file. `wait()` joins the write and raises its error.

Several processes (a process group of more than one): rank 0 alone
writes, synchronously, and every rank waits at a barrier after the write,
so no rank reads a file or a marker that is not on disk yet (the JAX
package's multi-process saves are synchronous for the same reason). The
trainers hand over the full tensors of a tensor-parallel box head, so a
file has no topology.
"""

from __future__ import annotations

import os
import pickle
import re
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel import mesh
from . import torch_import

TORCH_SUFFIXES = (".pth", ".pt", ".pkl", ".pth.tar")
MARKER = "last_checkpoint"


def to_host(tree: Any) -> Any:
    """A copy of `tree` with every tensor detached and copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


class _NumpyOnlyUnpickler(pickle.Unpickler):
    """Detectron2 `.pkl` weights: dicts of numpy arrays. Any other class in
    the pickle is refused, since unpickling can run code."""

    ALLOWED = {
        ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
        ("numpy", "ndarray"), ("numpy", "dtype"), ("collections", "OrderedDict"),
    }

    def find_class(self, module, name):
        if (module, name) not in self.ALLOWED:
            raise pickle.UnpicklingError(f"{module}.{name} is not allowed in a weights pickle")
        return super().find_class(module, name)


def load_torch_weights(path: str, det_cfg=None) -> Dict[str, torch.Tensor]:
    """The detector state dict of a `.pth`/`.pt`/`.pth.tar` (torch.save) or
    `.pkl` (Detectron2 pickle) file: its "model" (or "state_dict") entry,
    the student's keys of a teacher-student file with their `modelStudent.`
    prefix stripped, a DDP `module.` prefix stripped (as the JAX package's
    torch_import does). A torchvision VGG16(-BN) file (ImageNet weights)
    is renamed to the backbone of `det_cfg`, the detector it initialises
    (checkpoint/torch_import.py)."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = _NumpyOnlyUnpickler(f, encoding="latin1").load()
    else:
        data = torch.load(path, map_location="cpu", weights_only=True)
    sd = data.get("model", data.get("state_dict", data))
    if any(k.startswith("modelStudent.") for k in sd):
        sd = {k[len("modelStudent."):]: v for k, v in sd.items() if k.startswith("modelStudent.")}
    sd = {re.sub(r"^module\.", "", k): torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
          for k, v in sd.items()}
    if torch_import.is_torchvision_vgg(sd):
        if det_cfg is None or det_cfg.backbone != "vgg16":
            raise ValueError(f"{path} holds torchvision VGG16 weights, which initialise a VGG16 backbone only "
                             f"(the detector's backbone: {getattr(det_cfg, 'backbone', None)})")
        sd = torch_import.import_torchvision_vgg(sd, det_cfg.vgg_bn, det_cfg.fpn)
    return sd


@torch.no_grad()
def overlay_state_dict(module: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> list:
    """Copy the tensors of `sd` into `module`'s parameters and buffers of the
    same name, in the module's dtype, non-strictly: a name `sd` lacks keeps
    its value, and so does a shape that differs (with a printed line), as
    the JAX package's `_overlay` keeps the fresh initialisation. The
    BatchNorm counters and the pixel mean and std (which the config sets)
    are not taken. Returns the names that kept their value. A file that
    matches no tensor of the module raises (the JAX package loads it
    silently and trains from the initialisation)."""
    kept, taken = [], 0
    for name, t in module.state_dict(keep_vars=True).items():
        if name.endswith("num_batches_tracked") or name in ("pixel_mean", "pixel_std"):
            continue
        new = sd.get(name)
        if new is None:
            kept.append(name)
            continue
        if tuple(new.shape) != tuple(t.shape):
            print(f"[checkpoint] shape mismatch {tuple(new.shape)} vs target {tuple(t.shape)} for {name}; "
                  "keeping fresh init for this leaf", flush=True)
            kept.append(name)
            continue
        t.data.copy_(new.to(t.dtype))
        taken += 1
    if not taken:
        raise ValueError(f"the weights match no parameter or statistic of the detector (its {len(kept)} tensors, "
                         f"for example {kept[:2]}; the file's keys, for example {sorted(sd)[:3]})")
    return kept


class Checkpointer:
    """Saves and loads `<output_dir>/<name>.pth`; see the module docstring."""

    def __init__(self, output_dir: str):
        self.dir = os.path.abspath(output_dir)
        self._pending: Optional[threading.Thread] = None
        self._save_err: Optional[BaseException] = None
        # the last save's timings: blocking_s (the caller's snapshot),
        # write_s (the file's write, on the thread), bytes
        self.last_save: Dict[str, float] = {}

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name if name.endswith(".pth") else f"{name}.pth")

    def wait(self) -> None:
        """Block until an in-flight save is on disk; raise its error."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._save_err is not None:
            err, self._save_err = self._save_err, None
            raise err

    def save(self, name: str, state: Dict[str, Any], block: bool = True) -> None:
        """Write `state` as `<name>.pth` and point the marker at it; on disk
        when this returns unless `block=False` (several processes: always
        on disk, written by rank 0)."""
        if mesh.world_size() > 1:
            try:
                if mesh.is_main():
                    self._save(name, state, block=True)
            finally:
                mesh.barrier()
            return
        self._save(name, state, block)

    def _save(self, name: str, state: Dict[str, Any], block: bool) -> None:
        t0 = time.perf_counter()
        host = to_host(state)
        blocking = time.perf_counter() - t0
        self.wait()  # one save in flight at a time; raises an earlier one's error
        os.makedirs(self.dir, exist_ok=True)
        path = self.path(name)

        def work():
            try:
                t1 = time.perf_counter()
                tmp = f"{path}.tmp"
                torch.save(host, tmp)
                os.replace(tmp, path)
                marker_tmp = os.path.join(self.dir, f".{MARKER}.tmp")
                with open(marker_tmp, "w") as f:
                    f.write(os.path.basename(path))
                os.replace(marker_tmp, os.path.join(self.dir, MARKER))
                self.last_save = {"blocking_s": blocking, "write_s": time.perf_counter() - t1,
                                  "bytes": os.path.getsize(path)}
            except BaseException as e:  # raised again by wait()
                self._save_err = e

        self._pending = threading.Thread(target=work, daemon=False, name="sfod-ckpt-save")
        self._pending.start()
        if block:
            self.wait()

    def load(self, name: str) -> Dict[str, Any]:
        self.wait()
        path = name if os.path.isabs(name) else self.path(name)
        return torch.load(path, map_location="cpu", weights_only=True)

    def last_checkpoint(self) -> Optional[str]:
        """The marker's file name, or None without a marker."""
        self.wait()
        marker = os.path.join(self.dir, MARKER)
        if not os.path.exists(marker):
            return None
        with open(marker) as f:
            return f.read().strip()

    def has_checkpoint(self) -> bool:
        return self.last_checkpoint() is not None

    def resume_or_load(self, weights_path: str, resume: bool, det_cfg=None) -> Tuple[str, Any]:
        """("resume", the newest checkpoint) when `resume` and a marker
        exist; else ("weights", the detector state dict of `weights_path`,
        `load_torch_weights` for the detector `det_cfg`) for a torch file;
        else ("none", None) without weights. An orbax directory or any other
        path raises."""
        if resume and self.has_checkpoint():
            return "resume", self.load(self.last_checkpoint())
        if not weights_path:
            return "none", None
        if weights_path.endswith(TORCH_SUFFIXES):
            return "weights", load_torch_weights(weights_path, det_cfg)
        if os.path.isdir(weights_path):
            raise ValueError(
                f"MODEL.WEIGHTS={weights_path!r} is a directory (an orbax checkpoint of the JAX package?); "
                "convert it to a .pth with the JAX package's tools/export_weights.py")
        raise ValueError(f"MODEL.WEIGHTS={weights_path!r}: expected a file ending in one of {TORCH_SUFFIXES}")
