"""Radial profiles as plain callables on tensors.

A :class:`Profile` is ``eval_fn(params, r)`` with ``params`` a (nested)
tuple of Python floats and tensors.  Tensor parameters carry a leading
batch shape (one entry per halo) and the radii passed in carry that batch
shape followed by any sample axes; each tensor parameter is given trailing
unit axes at call time so it broadcasts over the samples.  Profiles
compose with profiles and scalars by ``+ - * / **`` and the modifiers
``add_core`` and ``cutoff`` into new profiles whose parameters are the
operands' parameters, so a composed profile of batched operands stays
batched.

A profile is a tree for the captured programs (:mod:`..core.compiled`),
as the JAX package's ``Profile`` is a pytree: its parameters are leaves
and its ``eval_fn`` is structure, keyed by its ``signature``.  A module's
eval function is keyed by its name; a composed one by the op and the
operands' signatures.  The closures of the composition capture only
functions and ops, never values (those are parameters), so two composed
profiles with equal signatures compute the same function of their
parameters, and a freshly composed profile replays the program of an
equal one.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..core import compiled
from ..core.device import tensor_on
from ..core.interp import CubicSpline, cubic_spline, spline_eval

__all__ = ["Profile", "RadialProfile", "constant_profile",
           "power_law_profile", "from_array_profile"]


def _expand(params, ndim: int):
    """Trailing unit axes on every tensor leaf so it broadcasts against
    radii of ``ndim`` dimensions.  A spline's coefficient tables are not
    parameters of that kind and pass through."""
    if isinstance(params, CubicSpline):
        return params
    if isinstance(params, torch.Tensor):
        if params.ndim < ndim:
            return params.reshape(params.shape + (1,) * (ndim - params.ndim))
        return params
    if isinstance(params, tuple):
        return tuple(_expand(p, ndim) for p in params)
    return params


def _composed(op, f1, f2):
    """``op(f1(p1, r), f2(p2, r))``, or ``op(f1(p1, r), c)`` with ``c`` a
    parameter when ``f2`` is None."""
    if f2 is None:
        def fn(params, r):
            p1, c = params
            return op(f1(p1, r), c)
    else:
        def fn(params, r):
            p1, p2 = params
            return op(f1(p1, r), f2(p2, r))
    fn.signature = ("composed", compiled.signature(op),
                    compiled.signature(f1),
                    None if f2 is None else compiled.signature(f2))
    return fn


def _composed_r(op, f1):
    """``op(f1(p1, r), c, r)``: a modifier whose envelope needs the
    radius."""
    def fn(params, r):
        p1, c = params
        return op(f1(p1, r), c, r)
    fn.signature = ("composed_r", compiled.signature(op),
                    compiled.signature(f1))
    return fn


def _add(a, b):
    return a + b


def _sub(a, b):
    return a - b


def _mul(a, b):
    return a * b


def _div(a, b):
    return a / b


def _pow_op(val, p):
    return val ** p


def _core_op(val, c, r):
    rc, al = c
    return val * (1.0 - torch.exp(-((r / rc) ** al)))


def _cutoff_op(val, c, r):
    rc, kk = c
    step = 1.0 / (1.0 + torch.exp(-2.0 * kk * (r / rc - 1.0)))
    return val * (1.0 - step)


class Profile:
    """A radial profile: ``profile(r)`` evaluates ``eval_fn(params, r)``
    on a float64 tensor of radii, on the tensor's device.  Radii given as
    anything else are made a tensor on ``device``.  Tensor parameters must
    live where the radii do."""

    def __init__(self, eval_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                 params: Any = ()):
        self.eval_fn = eval_fn
        self.params = params

    def __call__(self, r, device="cuda"):
        r = tensor_on(r, device)
        return self.eval_fn(_expand(self.params, r.ndim), r)

    # ------------------------------------------------------------ operators
    def _binary(self, other, op):
        if isinstance(other, Profile):
            return Profile(_composed(op, self.eval_fn, other.eval_fn),
                           (self.params, other.params))
        return Profile(_composed(op, self.eval_fn, None),
                       (self.params, other))

    def __add__(self, other):
        return self._binary(other, _add)

    __radd__ = __add__

    def __mul__(self, other):
        return self._binary(other, _mul)

    __rmul__ = __mul__

    def __sub__(self, other):
        return self._binary(other, _sub)

    def __truediv__(self, other):
        return self._binary(other, _div)

    def __pow__(self, power):
        return self._binary(power, _pow_op)

    # ---------------------------------------------------------- modifiers
    def add_core(self, r_core, alpha):
        """Multiply by ``1 - exp(-(r/r_core)^alpha)``."""
        return Profile(_composed_r(_core_op, self.eval_fn),
                       (self.params, (r_core, alpha)))

    def cutoff(self, r_cut, k=5):
        """Multiply by a reversed logistic step at ``r_cut``."""
        return Profile(_composed_r(_cutoff_op, self.eval_fn),
                       (self.params, (r_cut, float(k))))

    @classmethod
    def from_array(cls, r, f_r, device="cuda"):
        """Profile interpolating tabulated (r, f_r) with a cubic spline."""
        return from_array_profile(r, f_r, device=device)

    # --------------------------------------------------------------- plot
    def plot(self, rmin, rmax, num_points=1000, fig=None, ax=None, lw=2,
             device="cuda", **kwargs):
        """Quick loglog matplotlib plot, evaluated on ``device``."""
        import matplotlib.pyplot as plt

        if fig is None:
            fig = plt.figure(figsize=(10, 10))
        if ax is None:
            ax = fig.add_subplot(111)
        rr = np.logspace(np.log10(rmin), np.log10(rmax), num_points)
        ax.loglog(rr, self(rr, device=device).cpu().numpy(), lw=lw,
                  **kwargs)
        ax.set_xlabel("Radius (kpc)")
        return fig, ax


compiled.register_node(Profile, lambda p: ((p.params,), p.eval_fn),
                       lambda eval_fn, children: Profile(eval_fn,
                                                         children[0]))

#: alias matching the upstream class name
RadialProfile = Profile


def _constant_fn(p, r):
    return p * torch.ones_like(r)


def constant_profile(const):
    """Constant profile."""
    return Profile(_constant_fn, const)


def _power_law_fn(p, r):
    A_, rs_, al_ = p
    return A_ * (r / rs_) ** al_


def power_law_profile(A, r_s, alpha):
    """A * (r/r_s)^alpha."""
    return Profile(_power_law_fn, (A, r_s, alpha))


def _from_array_fn(p, rq):
    return spline_eval(p, rq)


def from_array_profile(r, f_r, device="cuda"):
    """Profile through tabulated (r, f_r) points with an interpolating
    not-a-knot cubic spline (exact at the points, no smoothing).  The
    spline is built once, on the device of ``r`` when that is a tensor and
    on ``device`` otherwise, and is evaluated only at radii that live
    there."""
    r = tensor_on(r, device)
    f_r = tensor_on(f_r, r.device)
    if f_r.device != r.device:
        raise ValueError(f"r lives on {r.device}, f_r on {f_r.device}")
    return Profile(_from_array_fn, cubic_spline(r, f_r))
