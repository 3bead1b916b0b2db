"""Observed scaling relations."""

from __future__ import annotations

import torch

__all__ = ["f_gas"]


def f_gas(M500, hubble=0.7):
    """Vikhlinin+09 gas fraction within r500."""
    m = M500 * 1.0e-15 / hubble
    return ((0.72 / hubble) ** 1.5) * (0.125 + 0.037 * torch.log10(m))
