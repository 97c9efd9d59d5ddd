"""PyTorch/CUDA port of simple_sfod_tpu for NVIDIA Hopper.

Imports torch, numpy and the standard library only; `PIL` is imported
inside the function that draws detections, and configs are read by the
port's own YAML reader. The JAX package beside it
(`simple_sfod_tpu`) is the reference this package is held against.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
