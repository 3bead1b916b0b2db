"""Bytes and operations of the port's hand-written kernels, from their
shapes alone.

K1 (``invert_cdf_rows``) inverts ``rows`` float32 CDF rows of ``n_s``
points at ``n_q`` uniform quantiles: it must read each input float once
and write each output float once, so its least traffic is
``4 rows (n_s + n_q)`` bytes.  Its work is about ``log2(n_s) + 8``
float32 operations per output, which at the card's float32 rate takes far
less time than the bytes at its memory rate: K1 is bound by memory.
"""

from __future__ import annotations

K1_NAME = "invert_cdf_rows_kernel"


def k1_bytes(rows, n_s, n_q):
    return 4 * rows * (n_s + n_q)
