"""PyTorch/CUDA port of simple_sfod_tpu for NVIDIA Hopper.

Imports torch, numpy and the standard library only; `PIL` is imported
inside the function that draws detections, and configs are read by the
port's own YAML reader. The JAX package beside it
(`simple_sfod_tpu`) is the reference this package is held against.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    # torch is imported with the first module that needs it, so a tool of
    # the standard library alone (tools/prediction_to_gt.py) starts without it
    if name == "resolve_device":
        from .device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
