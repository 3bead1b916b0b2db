"""Radial profiles as plain callables on tensors.

A :class:`Profile` is ``eval_fn(params, r)`` with ``params`` a (nested)
tuple of Python floats and tensors.  Tensor parameters carry a leading
batch shape (one entry per halo) and the radii passed in carry that batch
shape followed by any sample axes; each tensor parameter is given trailing
unit axes at call time so it broadcasts over the samples.  Profiles
compose with scalars by ``*``, the one operation the model build needs.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["Profile"]


def _expand(params, ndim: int):
    """Trailing unit axes on every tensor leaf so it broadcasts against
    radii of ``ndim`` dimensions."""
    if isinstance(params, torch.Tensor):
        if params.ndim < ndim:
            return params.reshape(params.shape + (1,) * (ndim - params.ndim))
        return params
    if isinstance(params, tuple):
        return tuple(_expand(p, ndim) for p in params)
    return params


def _scaled(params, r, fn):
    p1, c = params
    return fn(p1, r) * c


class Profile:
    """A radial profile: ``profile(r)`` evaluates ``eval_fn(params, r)``."""

    def __init__(self, eval_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                 params: Any = ()):
        self.eval_fn = eval_fn
        self.params = params

    def __call__(self, r):
        r = torch.as_tensor(r, dtype=torch.float64)
        return self.eval_fn(_expand(self.params, r.ndim), r)

    def __mul__(self, other):
        if isinstance(other, Profile):
            raise TypeError("only scalar multiples of a Profile are ported")
        fn = self.eval_fn
        return Profile(lambda p, r: _scaled(p, r, fn), (self.params, other))

    __rmul__ = __mul__
