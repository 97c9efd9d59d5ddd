"""Training state (the port of `simple_sfod_tpu/engine/train_state.py`).

The JAX package keeps step, params, batch_stats and the optax state in one
pytree; in torch the module owns its parameters and BatchNorm buffers and
the optimizer owns its momentum, so the state is those objects. The
adaptation state adds the teacher (a second FasterRCNN), the domain
classifiers and the adaptive-threshold statistics."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..models.backbones.resnet import FrozenBatchNorm2d
from ..solver.build import SGD


@dataclasses.dataclass
class TrainState:
    step: int  # steps taken; counted on the host, so reading it never waits on the device
    model: nn.Module  # parameters and BatchNorm running statistics
    optimizer: SGD  # momentum buffers and the schedule's count


@dataclasses.dataclass
class AdaptiveThresholdState:
    """FlexMatch-style per-class threshold statistics: a rolling reserve of
    per-class pseudo-label counts over the last RESERVE steps, and
    classwise_acc = count_c / max_c(count)."""

    reserve: torch.Tensor  # [RESERVE, C] int32 rolling counts
    classwise_acc: torch.Tensor  # [C] float32
    cursor: int  # updates made, on the host

    @staticmethod
    def create(num_classes: int, reserve: int = 500, device=None) -> "AdaptiveThresholdState":
        return AdaptiveThresholdState(
            reserve=torch.zeros((reserve, num_classes), dtype=torch.int32, device=device),
            classwise_acc=torch.zeros((num_classes,), dtype=torch.float32, device=device),
            cursor=0,
        )

    def state_dict(self) -> dict:
        return {"reserve": self.reserve, "classwise_acc": self.classwise_acc, "cursor": self.cursor}

    def load_state_dict(self, state: dict) -> None:
        """Restore `state_dict()` in place (the tensors keep their device)."""
        self.reserve = state["reserve"].to(self.reserve.device, self.reserve.dtype)
        self.classwise_acc = state["classwise_acc"].to(self.classwise_acc.device, self.classwise_acc.dtype)
        self.cursor = int(state["cursor"])


@dataclasses.dataclass
class TeacherStudentState(TrainState):
    """The student in TrainState's slots (its optimizer also holds the domain
    classifiers' parameters), the teacher, the domain classifiers by name
    ("dc", "dc_ins") and the threshold statistics."""

    teacher: Optional[nn.Module] = None
    dc: Dict[str, nn.Module] = dataclasses.field(default_factory=dict)
    thresh: Optional[AdaptiveThresholdState] = None


def ema_tensors(model: nn.Module) -> List[torch.Tensor]:
    """What the EMA blends, in a fixed order: every parameter (frozen ones
    included), every FrozenBN weight and bias (parameters in the JAX
    package), then every BatchNorm and FrozenBN running mean and variance
    (not num_batches_tracked, which the JAX package does not have): the JAX
    package blends its whole params and batch_stats trees."""
    frozen_affine = [t for m in model.modules() if isinstance(m, FrozenBatchNorm2d) for t in (m.weight, m.bias)]
    buffers = [b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))]
    return [p.data for p in model.parameters()] + frozen_affine + buffers


@torch.no_grad()
def ema_update(teacher: List[torch.Tensor], student: List[torch.Tensor], keep_rate: float) -> None:
    """t = keep * t + (1 - keep) * s in place, in float32 as the JAX package
    rounds it: keep and 1 - keep are float32, each product is rounded, then
    the sum."""
    keep = float(np.float32(keep_rate))
    rest = float(np.float32(1.0) - np.float32(keep_rate))
    torch._foreach_mul_(teacher, keep)
    torch._foreach_add_(teacher, torch._foreach_mul(student, rest))
