"""Weights out to the reference stack (the port's counterpart of
`simple_sfod_tpu/checkpoint/torch_export.py`).

The reference's eval stack reads fvcore's Checkpointer file,
``torch.save({"model": state_dict, "iteration": N})``: a plain Detectron2
detector, or for a teacher-student state its EnsembleTSModel with the
`modelTeacher.` then `modelStudent.` prefixes (reference
daod/checkpoint/detection_ts_checkpointer.py:11-90). The port's checkpoints
(checkpoint/checkpointer.py) already hold that state dict under "model",
with Detectron2's names (FPN's included), beside the optimizer and the
trainer's state. Exporting therefore selects and cleans: the copy asked
for, every floating tensor as float32 (a bfloat16 teacher is stored as
float32 already; the cast is exact), `num_batches_tracked` 0 for every
BatchNorm layer, and nothing but "model" and "iteration" in the file.

`which`, as the JAX package's `export_train_state` reads it:
  auto      ensemble when the file has a teacher, else student
  student   the plain detector (the student of a teacher-student file)
  teacher   the teacher's plain detector (ValueError without a teacher)
  ensemble  modelTeacher.* then modelStudent.* (ValueError without one)

The JAX exporter raises on an FPN tree (the reference's fault, pinned in
tests/test_torch_fpn.py); the port's FPN files export like any other.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from .checkpointer import Checkpointer

TEACHER, STUDENT = "modelTeacher.", "modelStudent."
WHICH = ("auto", "student", "teacher", "ensemble")


def checkpoint_file(path: str) -> str:
    """A checkpoint file as given, or an OUTPUT_DIR's newest one (its
    `last_checkpoint` marker)."""
    if not os.path.isdir(path):
        return path
    name = Checkpointer(path).last_checkpoint()
    if name is None:
        raise FileNotFoundError(f"{path} holds no last_checkpoint marker")
    return os.path.join(path, name)


def _reference_tensors(sd: Dict[str, torch.Tensor], prefix: str = "") -> Dict[str, torch.Tensor]:
    """`sd` with `prefix` on every key, floating tensors as float32 and every
    BatchNorm counter 0."""
    out = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            v = torch.zeros((), dtype=torch.int64)
        elif v.is_floating_point():
            v = v.detach().to("cpu", torch.float32, copy=True)
        out[prefix + k] = v
    return out


def export_model_state(model: Dict[str, torch.Tensor], which: str = "auto") -> Dict[str, torch.Tensor]:
    """The "model" of a port checkpoint -> the state dict the reference
    stack loads, for `which` (module docstring)."""
    if which not in WHICH:
        raise ValueError(f"which={which!r} (expected auto|student|teacher|ensemble)")
    teacher = {k[len(TEACHER):]: v for k, v in model.items() if k.startswith(TEACHER)}
    if any(k.startswith(STUDENT) for k in model):
        student = {k[len(STUDENT):]: v for k, v in model.items() if k.startswith(STUDENT)}
    else:
        student = dict(model)
    if which == "auto":
        which = "ensemble" if teacher else "student"
    if which == "student":
        return _reference_tensors(student)
    if not teacher:
        raise ValueError(f"the checkpoint has no teacher (no {TEACHER} tensors); cannot export {which}")
    if which == "teacher":
        return _reference_tensors(teacher)
    return {**_reference_tensors(teacher, TEACHER), **_reference_tensors(student, STUDENT)}


def export_checkpoint(path: str, which: str = "auto") -> Tuple[Dict[str, torch.Tensor], Optional[int]]:
    """A port checkpoint file, or an OUTPUT_DIR, -> (the exported state dict,
    its iteration)."""
    data = torch.load(checkpoint_file(path), map_location="cpu", weights_only=True)
    iteration = data.get("iteration")
    return export_model_state(data["model"], which), None if iteration is None else int(iteration)


def save_torch_file(sd: Dict[str, torch.Tensor], path: str, iteration: Optional[int] = None) -> None:
    """Write fvcore Checkpointer's file: {"model": sd, "iteration": N} (no
    "iteration" when it is None)."""
    data = {"model": sd}
    if iteration is not None:
        data["iteration"] = int(iteration)
    torch.save(data, path)
