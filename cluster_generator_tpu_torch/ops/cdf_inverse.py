"""Inverse of monotone CDF rows at uniform quantiles (kernel K1).

Replaces the TPU kernel ``cluster_generator_tpu/ops/pallas_kernels.py::
invert_cdf_rows``.  On a CUDA tensor :func:`invert_cdf_rows` launches the
hand-written kernel ``csrc/invert_cdf_rows.cu`` (one launch for all rows
given); on a CPU tensor it runs :func:`invert_cdf_rows_plain`, the same
masked-sum formula written literally in torch.  The source note in the
``.cu`` file gives the kernel's design and bound.

The launch goes on PyTorch's current stream, so inside a captured batch
program (:mod:`..core.compiled`) it is recorded into the graph; the
launcher's one-time set-up (device attributes, the shared-memory opt-in,
the occupancy per shared-memory size) is done by the program's eager
warm-up before the capture.  ``invert_cdf_rows.launches`` counts the
launches the card runs: a replay adds the K1 nodes of its graph.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .build import SMEM_OPTIN_BYTES, launch

__all__ = ["invert_cdf_rows", "invert_cdf_rows_plain", "MAX_N_S"]

# The kernel keeps two input rows and one output row of a team in shared
# memory, and a block may opt in to 227 KB of it on the card:
# 2 n_s + n_q floats (each rounded up to a multiple of 4) must fit.
_SMEM_FLOATS = SMEM_OPTIN_BYTES // 4
MAX_N_S = (_SMEM_FLOATS - 4) // 2

# the C entry point's arguments before the stream: cdf, out, n_rows, n_s,
# n_q, ds, dq
ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float)

# elements of one (rows, n_q, n_s) chunk of the plain version's mask
_PLAIN_CHUNK = 1 << 22


@functools.lru_cache(maxsize=64)
def _steps(n_s: int, n_q: int):
    """ds = 1/(n_s-1) and dq = 1/(n_q-1), rounded to float32 once."""
    return (float(np.float32(1.0 / (n_s - 1))),
            float(np.float32(1.0 / (n_q - 1))))


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def _check(cdf: torch.Tensor, n_q: int) -> None:
    if not isinstance(cdf, torch.Tensor):
        raise TypeError("cdf must be a torch.Tensor")
    if cdf.dtype != torch.float32:
        raise TypeError(f"cdf must be float32, got {cdf.dtype}")
    if cdf.ndim != 2:
        raise ValueError(f"cdf must be (rows, n_s), got shape "
                         f"{tuple(cdf.shape)}")
    if not 2 <= cdf.shape[1] <= MAX_N_S:
        raise ValueError(f"n_s must be in [2, {MAX_N_S}], got {cdf.shape[1]}")
    if n_q < 2:
        raise ValueError(f"n_q must be >= 2, got {n_q}")
    if 2 * _pad4(cdf.shape[1]) + _pad4(n_q) > _SMEM_FLOATS:
        raise ValueError(
            f"2 n_s + n_q must be <= {_SMEM_FLOATS} (shared memory of one "
            f"block), got n_s={cdf.shape[1]}, n_q={n_q}")
    if not cdf.is_contiguous():
        raise ValueError("cdf must be contiguous")


def invert_cdf_rows_plain(cdf: torch.Tensor, n_q: int) -> torch.Tensor:
    """The masked sum in plain torch, in row chunks that bound the
    (rows, n_q, n_s-1) mask to ~16 MB:

        s_inv[m] = sum_k [c_k <= q_m < c_{k+1}] (s_k + (q_m - c_k) ds / max(c_{k+1} - c_k, 1e-30))

    with the last bin right-closed.  Same float32 operations, in the same
    order, as the kernel.
    """
    _check(cdf, n_q)
    n_rows, n_s = cdf.shape
    ds, dq = _steps(n_s, n_q)
    dev = cdf.device
    q = (torch.arange(n_q, dtype=torch.float32, device=dev) * dq)[:, None]
    s_lo = torch.arange(n_s - 1, dtype=torch.float32, device=dev) * ds
    last = torch.arange(n_s - 1, device=dev) == (n_s - 2)
    out = torch.empty((n_rows, n_q), dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_CHUNK // (n_q * n_s))
    for r0 in range(0, n_rows, step):
        c = cdf[r0:r0 + step]
        c_lo = c[:, None, :-1]
        c_hi = c[:, None, 1:]
        inv_dc = 1.0 / torch.clamp_min(c_hi - c_lo, 1e-30)
        mask = (c_lo <= q) & ((q < c_hi) | last)
        val = torch.where(mask, s_lo + (q - c_lo) * inv_dc * ds,
                          torch.zeros((), dtype=torch.float32, device=dev))
        out[r0:r0 + step] = val.sum(dim=-1)
    return out


def _launch(cdf: torch.Tensor, n_q: int) -> torch.Tensor:
    n_rows, n_s = cdf.shape
    ds, dq = _steps(n_s, n_q)
    out = torch.empty((n_rows, n_q), dtype=torch.float32, device=cdf.device)
    launch(invert_cdf_rows, "invert_cdf_rows", ARGTYPES, cdf.device,
           cdf.data_ptr(), out.data_ptr(), n_rows, n_s, n_q, ds, dq)
    return out


def invert_cdf_rows(cdf: torch.Tensor, n_q: int = 512) -> torch.Tensor:
    """Invert monotone float32 CDF rows ``(rows, n_s)`` sampled on a uniform
    [0, 1] s-grid; returns ``(rows, n_q)`` float32, s at the quantiles
    ``m / (n_q - 1)``.

    A CUDA tensor goes through the CUDA kernel (``invert_cdf_rows.launches``
    counts its launches on the card, a graph's on each replay); a CPU
    tensor through :func:`invert_cdf_rows_plain`.
    Any other device raises.
    """
    _check(cdf, n_q)
    if cdf.device.type == "cuda":
        return _launch(cdf, n_q)
    if cdf.device.type == "cpu":
        return invert_cdf_rows_plain(cdf, n_q)
    raise ValueError(f"invert_cdf_rows: unsupported device {cdf.device}")


invert_cdf_rows.launches = 0
