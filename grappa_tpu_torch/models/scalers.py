"""Output scaling layers mapping N(0,1)-ish network outputs onto the
empirical distribution of MM parameters.

Same functional forms as `grappa_tpu.models.scalers` (reference:
src/grappa/models/final_layer.py:11-97):
  to_positive(x)  = std * (elu(mean/std + x - 1) + 1) + min      -> (min, inf)
  to_range(x)     = max * sigmoid(std/max * x)                   -> (0, max)
  hard_cutoff(x)  = x if |x| > cutoff else 0

The modules keep their statistics in buffers with the reference's names
(`to_k.mean_over_std`, `to_eq.std_over_max`, ...).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def hard_cutoff(x: torch.Tensor, cutoff: float) -> torch.Tensor:
    return torch.where(x.abs() > cutoff, x, torch.zeros_like(x))


def sigmoid_gate(x: torch.Tensor) -> torch.Tensor:
    """Gate in (0, 2) with value ~1 + x for small x (harmonic_gate)."""
    return 2.0 * torch.sigmoid(2.0 * x)


class ToPositive(nn.Module):
    def __init__(self, mean: float = 1.0, std: float = 1.0,
                 min_: float = 0.0):
        super().__init__()
        self.register_buffer('mean_over_std', torch.tensor(mean / std))
        self.register_buffer('std', torch.tensor(float(std)))
        self.register_buffer('min_', torch.tensor(float(min_)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.std * (F.elu(self.mean_over_std + x - 1.0) + 1.0) \
            + self.min_


class ToRange(nn.Module):
    def __init__(self, max_: float, std: float = 1.0):
        super().__init__()
        self.register_buffer('std_over_max', torch.tensor(std / max_))
        self.register_buffer('max', torch.tensor(float(max_)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.max * torch.sigmoid(self.std_over_max * x)
