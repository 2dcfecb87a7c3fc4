"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    A CUDA device that does not exist raises: the port never moves work
    to the CPU behind the caller's back.  Pass ``device="cpu"`` to run
    the plain PyTorch versions of the kernels.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels")
    return dev
