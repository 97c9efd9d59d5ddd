"""Domain classifiers (the port of `simple_sfod_tpu/models/dann.py`): their
parameters, seeded initialisation and deterministic forward, with the JAX
package's layer names.

The main configuration builds both (DOMAIN_CLASSIFIER.ENABLED with
SEMISUPNET.INS_DC) and weights both losses 0 (DOMAIN_CLASSIFIER.IMAGE and
INSTANCE False): their parameters join the optimizer, take zero gradients
and still decay. The gradient-reversal losses and the instance head's
dropout are not ported yet; the adaptation trainer refuses a configuration
that weights them.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F


def _autocast(device: torch.device, dtype: torch.dtype):
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=dtype == torch.bfloat16)


class FCDiscriminatorImg(nn.Module):
    """Image-level discriminator: three 3x3 convs with LeakyReLU(0.2) and a
    1-channel 3x3 classifier. x [B, C, h, w] -> logits [B, 1, h, w] float32."""

    def __init__(self, in_channels: int, ndf1: int = 256, ndf2: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, ndf1, 3, padding=1)
        self.conv2 = nn.Conv2d(ndf1, ndf2, 3, padding=1)
        self.conv3 = nn.Conv2d(ndf2, ndf2, 3, padding=1)
        self.classifier = nn.Conv2d(ndf2, 1, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with _autocast(x.device, self.dtype):
            for conv in (self.conv1, self.conv2, self.conv3):
                x = F.leaky_relu(conv(x), 0.2)
            return self.classifier(x).float()


class DAInsHead(nn.Module):
    """Instance-level discriminator: fc 1024 -> ReLU -> fc 1024 -> ReLU ->
    fc 1 over box-head features [N, in_dim] -> logits [N, 1] float32. The
    forward is the deterministic one (the JAX package's train=False): the
    two dropouts of its train mode are not ported."""

    def __init__(self, in_dim: int, hidden: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.fc3 = nn.Linear(hidden, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with _autocast(x.device, self.dtype):
            x = torch.relu(self.fc1(x))
            x = torch.relu(self.fc2(x))
            return self.fc3(x).float()


@torch.no_grad()
def init_dc_weights(module: nn.Module, seed: int) -> nn.Module:
    """Seeded weights with the JAX package's initialiser scales: convs
    normal with std 1/sqrt(fan_in) (flax's lecun-normal variance), the
    instance head's dense layers normal(0.01), zero biases. Drawn on the CPU
    from one torch.Generator."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = 1.0 / math.sqrt(m.weight[0].numel()) if isinstance(m, nn.Conv2d) else 0.01
            m.weight.copy_(torch.empty(m.weight.shape).normal_(0.0, std, generator=g))
            m.bias.zero_()
    return module
