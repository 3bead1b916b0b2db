"""Debug sanitizers: a NaN guard for torch ops, and physics validation of
built models."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .logging import mylog

__all__ = ["nan_guard", "validate_model_fields"]


def _outputs(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (list, tuple)):
        for o in out:
            yield from _outputs(o)


class _NanGuard(TorchDispatchMode):
    """Raises at the first op whose floating output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _outputs(out):
            if (t.is_floating_point() or t.is_complex()) and bool(
                    torch.isnan(t).any()):
                raise FloatingPointError(
                    f"nan_guard: {func} produced a NaN (output shape "
                    f"{tuple(t.shape)}, {t.dtype}, on {t.device})")
        return out


@contextlib.contextmanager
def nan_guard():
    """Raise ``FloatingPointError`` at the first torch op inside the scope
    whose floating output holds a NaN, naming that op.

    Every op's outputs are checked on their device and the answer brought
    to the host: one synchronization per op, so this is for debugging, not
    for timed runs."""
    with _NanGuard():
        yield


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def validate_model_fields(fields: dict, raise_on_error: bool = True) -> list:
    """Physics sanity of a built model field dict (tensors or arrays).

    Checks: finiteness everywhere; positive density/pressure/temperature;
    non-decreasing enclosed masses; negative potential; non-negative DM
    density.  Returns the list of violated checks.
    """
    problems = []

    def chk(cond, msg):
        if not cond:
            problems.append(msg)

    fields = {name: _host(arr) for name, arr in fields.items()}
    for name, a in fields.items():
        chk(np.isfinite(a).all(), f"{name} contains non-finite values")
    for name in ["density", "pressure", "temperature", "total_density"]:
        if name in fields:
            chk((fields[name] > 0).all(), f"{name} not positive")
    for name in ["total_mass", "gas_mass", "stellar_mass"]:
        if name in fields:
            m = fields[name]
            chk((np.diff(m) >= -1e-8 * m[-1]).all(),
                f"{name} not non-decreasing")
    if "gravitational_potential" in fields:
        chk((fields["gravitational_potential"] < 0).all(),
            "gravitational_potential not negative")
    if "dark_matter_density" in fields:
        dd = fields["dark_matter_density"]
        chk((dd >= 0).all(), "dark_matter_density negative")
        if dd.sum() <= 0:
            mylog.warning(
                "The total dark matter mass is either zero or negative!!")

    if problems and raise_on_error:
        raise ValueError("model validation failed: " + "; ".join(problems))
    for p in problems:
        mylog.warning("model validation: %s", p)
    return problems
