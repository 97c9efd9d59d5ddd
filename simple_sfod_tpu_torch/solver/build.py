"""Optimizer and learning-rate schedule (the port of
`simple_sfod_tpu/solver/build.py`): detectron2's WarmupMultiStepLR with the
FACTOR_LIST extension, and SGD with momentum and weight decay in the optax
chain's order:

    g  = clip(g, -CLIP_VALUE, CLIP_VALUE)          (CLIP_GRADIENTS.ENABLED)
    g  = g + wd * p      wd = WEIGHT_DECAY, or WEIGHT_DECAY_NORM on BatchNorm
    mu = MOMENTUM * mu + g
    p  = p - lr(count) * mu                        count = steps taken so far

The JAX package's `SOLVER.FUSED` flat-buffer variant computes the same
function; the port has this one implementation.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn


def warmup_multistep_schedule(
    base_lr: float,
    steps: Sequence[int],
    gamma: float = 0.1,
    factor_list: Optional[Sequence[float]] = None,
    warmup_iters: int = 1000,
    warmup_factor: float = 1.0 / 1000,
    warmup_method: str = "linear",
) -> Callable[[int], np.float32]:
    """count -> LR(count) = base * factor(count) * warmup(count), in float32
    as the JAX package computes it. factor(count) is factor_list[k] (padded
    with its last entry) or gamma**k, where k counts the milestones
    <= count. Warmup is "linear" (warmup_factor ramping to 1) or "constant"
    (warmup_factor until warmup_iters); none at all when warmup_iters <= 0."""
    if warmup_method not in ("linear", "constant"):
        raise ValueError(f"unknown SOLVER.WARMUP_METHOD {warmup_method!r}")
    steps = list(steps)
    if factor_list is not None and len(factor_list) >= 1:
        factors = list(factor_list)
        while len(factors) < len(steps) + 1:
            factors.append(factors[-1])
    else:
        factors = [gamma**k for k in range(len(steps) + 1)]
    factors32 = np.asarray(factors, np.float32)
    f32 = np.float32

    def schedule(count: int) -> np.float32:
        factor = factors32[sum(count >= s for s in steps)]
        if warmup_iters <= 0:
            warm = f32(1.0)
        elif warmup_method == "constant":
            warm = f32(warmup_factor) if count < warmup_iters else f32(1.0)
        else:
            alpha = min(max(f32(count) / f32(max(warmup_iters, 1)), f32(0.0)), f32(1.0))
            warm = f32(warmup_factor) * (f32(1.0) - alpha) + alpha
        return f32(base_lr) * factor * warm

    return schedule


def norm_param_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True for BatchNorm affine parameters, which decay at
    SOLVER.WEIGHT_DECAY_NORM (detectron2's get_default_optimizer_params).
    Selected by module type: the JAX package selects the same leaves by its
    flax names (`bn<i>`), which the Detectron2 names do not carry."""
    norm = {
        f"{mod_name}.{p_name}" if mod_name else p_name
        for mod_name, mod in model.named_modules()
        if isinstance(mod, nn.BatchNorm2d)
        for p_name, _ in mod.named_parameters(recurse=False)
    }
    return {name: name in norm for name, _ in model.named_parameters()}


def backbone_freeze_mask(model: nn.Module, freeze_at: int) -> Dict[str, bool]:
    """Parameter name -> True when MODEL.BACKBONE.FREEZE_AT freezes it.
    detectron2 freezes the ResNet stem and res stages up to FREEZE_AT; a VGG
    backbone has neither, so for vgg16 (the one ported backbone) nothing is
    frozen, whatever FREEZE_AT says, as in the JAX package."""
    if model.cfg.backbone != "vgg16":
        raise NotImplementedError(f"FREEZE_AT for backbone {model.cfg.backbone!r} is not ported")
    return {name: False for name, _ in model.named_parameters()}


class SGD:
    """The update of the module docstring over a fixed list of parameters,
    with `torch._foreach` ops. State: the momentum buffers and `count`, the
    number of steps taken (optax's schedule count)."""

    def __init__(
        self,
        named_params: Dict[str, nn.Parameter],
        schedule: Callable[[int], np.float32],
        momentum: float,
        weight_decay: Dict[str, float],
        clip_value: Optional[float] = None,
    ):
        self.names = list(named_params)
        self.params: List[nn.Parameter] = [named_params[n] for n in self.names]
        self.schedule = schedule
        self.momentum = momentum
        self.clip_value = clip_value
        self.decay_groups = {}
        for i, name in enumerate(self.names):
            self.decay_groups.setdefault(float(weight_decay[name]), []).append(i)
        self.mu = [torch.zeros_like(p, memory_format=torch.preserve_format) for p in self.params]
        self.count = 0

    def lr(self) -> float:
        """The LR the next step applies."""
        return float(self.schedule(self.count))

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' .grad (consumed in place; a
        parameter without one takes a zero gradient)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.clip_value is not None:
            torch._foreach_clamp_min_(grads, -self.clip_value)
            torch._foreach_clamp_max_(grads, self.clip_value)
        for wd, idx in self.decay_groups.items():
            if wd:
                torch._foreach_add_([grads[i] for i in idx], [self.params[i] for i in idx], alpha=wd)
        torch._foreach_mul_(self.mu, self.momentum)
        torch._foreach_add_(self.mu, grads)
        torch._foreach_add_(self.params, self.mu, alpha=-self.lr())
        self.count += 1


def build_optimizer(cfg, model: nn.Module, extra: Optional[Dict[str, nn.Module]] = None) -> SGD:
    """SGD over the model's trainable parameters from cfg.SOLVER (and
    MODEL.BACKBONE.FREEZE_AT, which selects nothing on VGG). `extra` adds
    other modules' parameters under their name's prefix (the adaptation
    trainer's domain classifiers), decayed by the same rule."""
    s = cfg.SOLVER
    schedule = warmup_multistep_schedule(
        s.BASE_LR,
        s.STEPS,
        s.GAMMA,
        s.FACTOR_LIST if len(s.FACTOR_LIST) else None,
        s.WARMUP_ITERS,
        s.WARMUP_FACTOR,
        s.WARMUP_METHOD,
    )
    frozen = backbone_freeze_mask(model, int(cfg.MODEL.BACKBONE.FREEZE_AT))
    norm = norm_param_mask(model)
    params = {n: p for n, p in model.named_parameters() if not frozen[n]}
    for prefix, module in (extra or {}).items():
        norm.update({f"{prefix}.{n}": v for n, v in norm_param_mask(module).items()})
        params.update({f"{prefix}.{n}": p for n, p in module.named_parameters()})
    decay = {n: float(s.WEIGHT_DECAY_NORM) if norm[n] else float(s.WEIGHT_DECAY) for n in params}
    clip = float(s.CLIP_GRADIENTS.CLIP_VALUE) if s.CLIP_GRADIENTS.ENABLED else None
    return SGD(params, schedule, float(s.MOMENTUM), decay, clip)
