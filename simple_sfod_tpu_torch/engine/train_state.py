"""Training state (the port of `simple_sfod_tpu/engine/train_state.py`).

The JAX package keeps step, params, batch_stats and the optax state in one
pytree; in torch the module owns its parameters and BatchNorm buffers and
the optimizer owns its momentum, so the state is the three objects."""

from __future__ import annotations

import dataclasses

from torch import nn

from ..solver.build import SGD


@dataclasses.dataclass
class TrainState:
    step: int  # steps taken; counted on the host, so reading it never waits on the device
    model: nn.Module  # parameters and BatchNorm running statistics
    optimizer: SGD  # momentum buffers and the schedule's count
