"""Device pick for the package's entry points.

The port's tensors live on the CUDA card. An entry point given no device
runs there, and raises when the host has no CUDA device: it never carries
on quietly on the CPU. ``device="cpu"`` is honoured only when asked for —
that is how the tests run the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device on this host; pass device='cpu' explicitly "
                "to run the plain PyTorch path"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
