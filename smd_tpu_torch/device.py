"""Where the port runs: ``cuda`` unless the caller asks for the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means ``cuda``. A CUDA device that is not there raises: the port
    never carries on quietly on the CPU. Pass ``device="cpu"`` to run there.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "smd_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU")
    return device
