"""Replay buffer for EBM-style sampling (port of
``smd_tpu/diffusion/replay.py``).

Immutable, as the JAX struct is: ``add`` returns a new buffer. The draws
come from a ``torch.Generator``; the semantics are the JAX buffer's, the
draws are not.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from smd_tpu_torch.device import resolve_device

__all__ = ["ReplayBuffer"]


@dataclasses.dataclass(frozen=True)
class ReplayBuffer:
    buffer_size: int
    dims: int
    data: torch.Tensor

    @classmethod
    def create(cls, buffer_size: int, dims: int,
               generator: Optional[torch.Generator] = None,
               device=None) -> "ReplayBuffer":
        """A buffer of U[0, 1) vectors on ``device`` (``cuda`` unless the
        caller passes ``"cpu"``)."""
        data = torch.rand((buffer_size, dims), generator=generator,
                          device=resolve_device(device))
        return cls(buffer_size, dims, data)

    def add(self, samples: torch.Tensor) -> "ReplayBuffer":
        """``samples`` first, then the buffer's newest entries; the oldest
        ``len(samples)`` fall out."""
        n = samples.shape[0]
        data = torch.cat((samples.to(self.data), self.data[:-n]))
        return dataclasses.replace(self, data=data)

    def sample(self, generator: Optional[torch.Generator], n: int,
               p: float = 0.95) -> torch.Tensor:
        """``n`` vectors: each, with probability ``p``, a distinct entry of
        the buffer, else a fresh U[0, 1) vector."""
        device = self.data.device
        from_buffer = torch.rand(n, generator=generator, device=device) < p
        idx = torch.randperm(self.buffer_size, generator=generator,
                             device=device)[:n]
        fresh = torch.rand((n, self.dims), generator=generator,
                           device=device)
        return torch.where(from_buffer[:, None], self.data[idx], fresh)
