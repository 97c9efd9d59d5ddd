"""Domain classifiers and gradient reversal (the port of
`simple_sfod_tpu/models/dann.py`): their parameters, seeded initialisation
and forward, with the JAX package's layer names.

`gradient_scalar(x, alpha)` is the identity whose gradient is scaled by
`alpha` (alpha < 0 reverses it, the adversarial training of every domain
classifier). The heads:

  FCDiscriminatorImg  the adaptive teachers' image-level classifier
  DAImgHead           DA-Faster's image-level head (1x1 convs)
  DAInsHead           the instance-level head of DA-Faster and the adaptive
                      teachers; its train mode has two Dropout(0.5) layers
                      whose keep masks are inputs (`DAInsHead.forward`), so a
                      caller hands over a generator's draws or the JAX
                      package's own masks
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

DROPOUT_RATE = 0.5
INS_HIDDEN = 1024


class _GradientScalar(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.alpha, None


def gradient_scalar(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """The identity forward; backward the gradient times `alpha` (a Python
    float, which takes no gradient)."""
    return _GradientScalar.apply(x, float(alpha))


def _autocast(device: torch.device, dtype: torch.dtype):
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=dtype == torch.bfloat16)


def dropout(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Dropout(0.5) with a given keep mask, as flax applies it:
    where(keep, x / 0.5, 0)."""
    return torch.where(keep, x / (1.0 - DROPOUT_RATE), torch.zeros((), dtype=x.dtype, device=x.device))


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


class DAImgHead(nn.Module):
    """DA-Faster's image-level head: 1x1 conv to 512, ReLU, 1x1 conv to 1.
    x [B, C, h, w] -> logits [B, 1, h, w] float32. Its kernels are drawn
    from normal(INIT_STD) (`init_dc_weights`)."""

    INIT_STD = 0.001

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, 512, 1)
        self.conv2 = nn.Conv2d(512, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with _autocast(x.device, self.dtype):
            return self.conv2(torch.relu(self.conv1(x))).float()


class DAInsHead(nn.Module):
    """Instance-level discriminator: fc 1024 -> ReLU -> Dropout -> fc 1024 ->
    ReLU -> Dropout -> fc 1 over box-head features [N, in_dim] -> logits
    [N, 1] float32. `keep` None is the eval mode (the JAX package's
    train=False); the train mode takes the two dropouts' keep masks, bool
    [N, 1024] each (`dropout_masks` draws them)."""

    def __init__(self, in_dim: int, hidden: int = INS_HIDDEN, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.fc3 = nn.Linear(hidden, 1)

    def forward(self, x: torch.Tensor, keep: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        with _autocast(x.device, self.dtype):
            x = torch.relu(self.fc1(x))
            if keep is not None:
                x = dropout(x, keep[0])
            x = torch.relu(self.fc2(x))
            if keep is not None:
                x = dropout(x, keep[1])
            return self.fc3(x).float()


def dropout_masks(rows: int, calls: int, generator: torch.Generator, device) -> tuple:
    """Keep masks for `calls` train-mode DAInsHead calls on `rows` features:
    2 * calls bool [rows, 1024] tensors (bernoulli 0.5), drawn on `device`."""
    return tuple(
        torch.rand((rows, INS_HIDDEN), generator=generator, device=device) >= DROPOUT_RATE for _ in range(2 * calls)
    )


@torch.no_grad()
def init_dc_weights(module: nn.Module, seed: int) -> nn.Module:
    """Seeded weights with the JAX package's initialiser scales: convs
    normal with std 1/sqrt(fan_in) (flax's lecun-normal variance), except
    DAImgHead's, normal(0.001); the instance head's dense layers
    normal(0.01); zero biases. Drawn on the CPU from one torch.Generator."""
    g = torch.Generator().manual_seed(seed)
    img_head = {id(c) for m in module.modules() if isinstance(m, DAImgHead) for c in (m.conv1, m.conv2)}
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            if id(m) in img_head:
                std = DAImgHead.INIT_STD
            elif isinstance(m, nn.Conv2d):
                std = 1.0 / math.sqrt(m.weight[0].numel())
            else:
                std = 0.01
            m.weight.copy_(torch.empty(m.weight.shape).normal_(0.0, std, generator=g))
            m.bias.zero_()
    return module
