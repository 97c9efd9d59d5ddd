"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. Without a GPU
they raise instead of quietly carrying on on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """None -> "cuda" (raises when no GPU is present); anything else is
    taken as given, so `device="cpu"` is how tests and tools ask for the
    CPU path."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was requested but CUDA is not available")
    return device
