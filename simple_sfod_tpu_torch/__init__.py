"""PyTorch/CUDA port of simple_sfod_tpu for NVIDIA Hopper.

Imports torch, numpy and the standard library only; `yaml` and `PIL` are
imported inside the few functions that need them. The JAX package beside it
(`simple_sfod_tpu`) is the reference this package is held against.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
