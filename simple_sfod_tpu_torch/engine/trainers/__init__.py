"""Trainers by the name of `cfg.TRAINER` (the JAX package's registry):
"base" (supervised), the five fixed-pseudo-label ones ("base_wq",
"base_mosaic", "base_mixup", "base_mosaic_wq", "base_mosaic_wq_new") and the
three source-free adaptive-teacher variants."""

from __future__ import annotations

from typing import Callable, Dict

TRAINER_REGISTRY: Dict[str, type] = {}


def register_trainer(name: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        TRAINER_REGISTRY[name] = cls
        return cls

    return deco


def build_trainer(cfg, **kw):
    """The trainer that `cfg.TRAINER` names ("" means "base"), built with
    `kw` (device, weights)."""
    from . import base, source_free_adaptive_teacher, wq  # noqa: F401  (they register themselves)

    name = cfg.TRAINER or "base"
    if name not in TRAINER_REGISTRY:
        raise ValueError(f"unknown or unported TRAINER {name!r}; have {sorted(TRAINER_REGISTRY)}")
    return TRAINER_REGISTRY[name](cfg, **kw)
