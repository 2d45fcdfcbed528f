"""Device choice for the port.

``UNIKMER_TPU_TORCH_DEVICE`` names the torch device (default ``cuda``),
the counterpart of ``UNIKMER_TPU_PLATFORM``.  Asking for CUDA on a
machine without a usable card raises: the port never carries on quietly
on the CPU.  ``cpu`` selects the kernels' plain PyTorch versions, which
the CPU tests use.
"""

from __future__ import annotations

import os

from ._lazy import torch

ENV_DEVICE = "UNIKMER_TPU_TORCH_DEVICE"


def get_device(name: str | None = None) -> torch.device:
    """The device named by ``name``, else by UNIKMER_TPU_TORCH_DEVICE,
    else ``cuda``.  Raises RuntimeError when CUDA is asked for and
    ``torch.cuda.is_available()`` is False."""
    dev = torch.device(name or os.environ.get(ENV_DEVICE) or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False "
            f"(set {ENV_DEVICE}=cpu to run the plain PyTorch versions)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}: use cuda or cpu")
    return dev
