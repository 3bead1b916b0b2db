"""Speed-CDF rows from the float32 f(E) node table.

For each row energy psi, the CDF C(s) ∝ int_0^s u^2 f(psi (1 - u^2)) du on
the uniform grid s_k = k / (n_s - 1), with f read from a node table
(:func:`~..virial.speed_cdf_rows` with ``table_dtype=torch.float32``).
On a CUDA tensor :func:`speed_cdf_rows_f32` launches the hand-written
kernel ``csrc/speed_cdf_rows.cu`` (one launch for every row of every
halo); on a CPU tensor it runs :func:`speed_cdf_rows_f32_plain`, the same
operations written literally in torch.  The kernel replaces no TPU kernel;
the source note in the ``.cu`` file gives why it was added, its design and
its bound.

The launch goes on PyTorch's current stream, so inside a captured program
(:mod:`..core.compiled`) it is recorded into the graph;
``speed_cdf_rows_f32.launches`` counts the launches the card runs, a
replay adding the nodes of its graph.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.quadrature import cumsum
from .build import SMEM_OPTIN_BYTES, launch

__all__ = ["speed_cdf_rows_f32", "speed_cdf_rows_f32_plain", "trapezoid_cdf",
           "MAX_N_S"]

# The kernel keeps two float64 rows of a scan in shared memory (the pdf
# row shares the second), and a block may opt in to 227 KB of it on the
# card; 1 KB of that is left for the block reduction's static shared
# memory.
MAX_N_S = (SMEM_OPTIN_BYTES - 1024) // 16

# the C entry point's arguments before the stream: row_ee, s, eps, fu, b,
# e_max, out, n_rows, rows, n_s, nf1, nf2, then as float32 nf1, nf2 - 1
# and the two clamps' upper ends
ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5
            + (ctypes.c_float,) * 4)


def _ramp(n_s: int, dtype, device) -> torch.Tensor:
    """The strictly increasing ramp that keeps every bin invertible."""
    eps_val = 1e-12 if dtype == torch.float64 else 1e-7
    return torch.arange(n_s, dtype=dtype, device=device) * eps_val


def trapezoid_cdf(pdf: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """CDF rows (..., n_s) of the pdf rows on the grid ``s`` (in the pdf's
    dtype): trapezoid increments summed in float64, normalised to end at
    1 and made strictly increasing by a ramp of 1e-7 (float32) or 1e-12
    (float64) per bin."""
    ds = s[1] - s[0]
    # the trapezoid increments are summed in float64 and rounded once: the
    # card's float32 scan and the CPU's sum in another order differ by
    # ~1e-6 at the top of a row, which a flat CDF stretches to ~1e-4 in s
    inc = 0.5 * (pdf[..., 1:] + pdf[..., :-1]) * ds
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]),
                     cumsum(inc.to(torch.float64)).to(pdf.dtype)], dim=-1)
    total = cdf[..., -1:]
    cdf = cdf / torch.where(total > 0.0, total, torch.ones_like(total))
    cdf = cdf + _ramp(pdf.shape[-1], cdf.dtype, pdf.device)
    return cdf / cdf[..., -1:]


def _check(row_ee, s, fu, b, e_max, nf1: int, nf2: int) -> None:
    for name, t, dtype in (("row_ee", row_ee, torch.float64),
                           ("s", s, torch.float64),
                           ("fu", fu, torch.float32),
                           ("b", b, torch.float64),
                           ("e_max", e_max, torch.float64)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != row_ee.device:
            raise ValueError(f"{name} is on {t.device}, row_ee on "
                             f"{row_ee.device}")
    lead = row_ee.shape[:-1]
    if row_ee.ndim < 1 or s.ndim != 1:
        raise ValueError(f"row_ee must be (..., rows) and s (n_s,), got "
                         f"{tuple(row_ee.shape)} and {tuple(s.shape)}")
    if not 2 <= s.shape[0] <= MAX_N_S:
        raise ValueError(f"n_s must be in [2, {MAX_N_S}] (shared memory of "
                         f"one block), got {s.shape[0]}")
    if nf1 < 2 or nf2 < 2:
        raise ValueError(f"df node grids need >= 2 nodes per segment (got "
                         f"nf1={nf1}, nf2={nf2})")
    if fu.shape != lead + (nf1 + nf2,):
        raise ValueError(f"fu must be {tuple(lead) + (nf1 + nf2,)}, got "
                         f"{tuple(fu.shape)}")
    if b.shape != lead or e_max.shape != lead:
        raise ValueError(f"b and e_max must be {tuple(lead)}, got "
                         f"{tuple(b.shape)} and {tuple(e_max.shape)}")


def speed_cdf_rows_f32_plain(row_ee, s, fu, b, e_max, nf1: int, nf2: int):
    """Float32 CDF rows (..., rows, n_s) at the row energies ``row_ee``
    (..., rows) on the float64 grid ``s``.  ``fu`` (..., nf1 + nf2) holds
    f scaled into float32 range at NF1 uniform nodes over [0, b) and NF2
    over [b, e_max] (``b = 0.9 e_max``); each query E = psi (1 - s^2) is
    rounded to float32 and takes one lerp between its two nodes."""
    _check(row_ee, s, fu, b, e_max, nf1, nf2)
    NF1, NF2 = nf1, nf2
    E = row_ee[..., :, None] * (1.0 - (s * s))  # (..., rows, n_s)
    s = s.to(torch.float32)
    Ef = E.to(torch.float32).reshape(E.shape[:-2] + (-1,))
    bt = b.to(torch.float32)[..., None]
    et = e_max.to(torch.float32)[..., None]
    # segment 1: interval k covers [k, k+1) * b/NF1; its last interval
    # ends at b, the first segment-2 node
    x1 = torch.clamp(Ef / bt * NF1, 0.0, NF1 - 1e-4)
    k1 = torch.clamp_max(x1.to(torch.int64), NF1 - 1)
    w1 = x1 - k1.to(torch.float32)
    x2 = torch.clamp((Ef - bt) / (et - bt) * (NF2 - 1), 0.0,
                     NF2 - 1 - 1e-4)
    k2 = torch.clamp_max(x2.to(torch.int64), NF2 - 2)
    w2 = x2 - k2.to(torch.float32)
    in1 = Ef < bt
    k = torch.where(in1, k1, NF1 + k2)
    w = torch.where(in1, w1, w2)
    f_lo = torch.gather(fu, -1, k)
    f_hi = torch.gather(fu, -1, k + 1)
    f_E = ((1.0 - w) * f_lo + w * f_hi).reshape(E.shape)
    pdf = (s * s) * f_E
    pdf = pdf / torch.clamp_min(torch.amax(pdf, dim=-1, keepdim=True),
                                1e-30)
    return trapezoid_cdf(pdf, s)


def _launch(row_ee, s, fu, b, e_max, nf1: int, nf2: int) -> torch.Tensor:
    lead, rows, n_s = row_ee.shape[:-1], row_ee.shape[-1], s.shape[0]
    halos = int(np.prod(lead, dtype=np.int64))
    out = torch.empty(lead + (rows, n_s), dtype=torch.float32,
                      device=row_ee.device)
    if out.numel() == 0:
        return out
    ee = row_ee.reshape(halos, rows).contiguous()
    fu = fu.reshape(halos, nf1 + nf2).contiguous()
    b = b.reshape(halos).contiguous()
    e_max = e_max.reshape(halos).contiguous()
    s = s.contiguous()
    eps = _ramp(n_s, torch.float32, s.device)
    # the clamps' upper ends as the float32 values the plain version's
    # torch.clamp casts its Python scalars to
    hi1, hi2 = float(np.float32(nf1 - 1e-4)), float(np.float32(nf2 - 1 - 1e-4))
    launch(speed_cdf_rows_f32, "speed_cdf_rows", ARGTYPES, row_ee.device,
           ee.data_ptr(), s.data_ptr(), eps.data_ptr(), fu.data_ptr(),
           b.data_ptr(), e_max.data_ptr(), out.data_ptr(), halos * rows,
           rows, n_s, nf1, nf2, float(nf1), float(nf2 - 1), hi1, hi2)
    return out


def speed_cdf_rows_f32(row_ee, s, fu, b, e_max, nf1: int, nf2: int):
    """Float32 speed-CDF rows (..., rows, n_s) from the node table ``fu``
    (arguments of :func:`speed_cdf_rows_f32_plain`).

    A CUDA tensor goes through the CUDA kernel
    (``speed_cdf_rows_f32.launches`` counts its launches on the card, a
    graph's on each replay), bit for bit the plain version's result; a
    CPU tensor through :func:`speed_cdf_rows_f32_plain`.  Any other device
    raises, as does ``n_s`` above :data:`MAX_N_S` on any device.
    """
    _check(row_ee, s, fu, b, e_max, nf1, nf2)
    if row_ee.device.type == "cuda":
        return _launch(row_ee, s, fu, b, e_max, nf1, nf2)
    if row_ee.device.type == "cpu":
        return speed_cdf_rows_f32_plain(row_ee, s, fu, b, e_max, nf1, nf2)
    raise ValueError(f"speed_cdf_rows_f32: unsupported device "
                     f"{row_ee.device}")


speed_cdf_rows_f32.launches = 0
