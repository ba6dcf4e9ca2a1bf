"""Architecture registry (port of ``smd_tpu/models/registry.py``)."""
from __future__ import annotations

import inspect

from smd_tpu_torch.device import resolve_device
from smd_tpu_torch.models import autoregressive, ddpm

__all__ = ["MODEL_REGISTRY", "get_model"]

MODEL_REGISTRY = {
    "TransformerDDPM": ddpm.TransformerDDPM,
    "TransformerDDPM4": ddpm.TransformerDDPM4,
    "DenseDDPM": ddpm.DenseDDPM,
    "DenseNCSN": ddpm.DenseNCSN,
    "ConvNCSN": ddpm.ConvNCSN,
    "ToyDDPM": ddpm.ToyDDPM,
    "ToyNCSN": ddpm.ToyNCSN,
    "TransformerMDN": autoregressive.TransformerMDN,
}


def get_model(name: str, device=None, **kwargs):
    """Instantiate a registered architecture on ``device``, dropping kwargs
    it rejects (the CLIs pass one uniform set).

    ``device`` is ``cuda`` unless the caller passes ``"cpu"``; without a GPU
    that is an error (``device.resolve_device``).
    """
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"Unknown architecture {name!r}; known: {sorted(MODEL_REGISTRY)}")
    device = resolve_device(device)
    cls = MODEL_REGISTRY[name]
    accepted = inspect.signature(cls.__init__).parameters
    return cls(**{k: v for k, v in kwargs.items() if k in accepted}).to(device)
