"""Observed scaling relations.  Each takes a float or a tensor and returns
the same kind, a tensor on its own device."""

from __future__ import annotations

import math

import torch

from ..core import units

__all__ = ["f_gas", "m_bcg", "m_sat", "r_bcg", "convert_ne_to_density"]


def _log10(x):
    return torch.log10(x) if isinstance(x, torch.Tensor) else math.log10(x)


def f_gas(M500, hubble=0.7):
    """Vikhlinin+09 gas fraction within r500."""
    m = M500 * 1.0e-15 / hubble
    return ((0.72 / hubble) ** 1.5) * (0.125 + 0.037 * _log10(m))


def m_bcg(M500):
    """BCG stellar mass from M500."""
    x = _log10(M500) - 14.5
    return 10.0 ** (0.39 * x + 12.15)


def m_sat(M500):
    """Satellite stellar mass from M500."""
    x = _log10(M500) - 14.5
    return 10.0 ** (0.87 * x + 12.42)


def r_bcg(r200):
    """BCG radius from r200."""
    x = _log10(r200) - 1.0
    return 10.0 ** (0.95 * x - 0.3)


def convert_ne_to_density(ne):
    """n_e [cm^-3] -> mass density [Msun/kpc^3]."""
    return units.ne_to_density(ne)
