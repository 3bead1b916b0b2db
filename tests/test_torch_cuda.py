"""The port's CUDA kernels on the card (marker ``cuda``).

Without a card every test here skips.  On a machine with one, run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

``--noconftest`` because tests/conftest.py sets up JAX, which this file
does not use (it imports only torch and the port).
"""

import numpy as np
import pytest
import torch

from cluster_generator_tpu_torch import pipeline as P
from cluster_generator_tpu_torch.ops.cdf_inverse import (
    invert_cdf_rows,
    invert_cdf_rows_plain,
)

TOL = 5e-6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _random_rows(n_rows, n_s, seed=0):
    rng = np.random.RandomState(seed)
    pdf = rng.rand(n_rows, n_s - 1) + 0.05
    cdf = np.concatenate([np.zeros((n_rows, 1)), np.cumsum(pdf, axis=1)],
                         axis=1)
    return (cdf / cdf[:, -1:]).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,n_s,n_q", [(512, 512, 512),
                                            (128, 256, 256),
                                            (17, 1024, 512)])
def test_k1_matches_plain_version(n_rows, n_s, n_q):
    _card()
    cdf = torch.from_numpy(_random_rows(n_rows, n_s)).cuda()
    before = invert_cdf_rows.launches
    got = invert_cdf_rows(cdf, n_q=n_q)
    want = invert_cdf_rows_plain(cdf, n_q)
    torch.cuda.synchronize()
    assert invert_cdf_rows.launches == before + 1
    assert got.shape == (n_rows, n_q) and got.dtype == torch.float32
    assert float((got - want).abs().max()) < TOL


@pytest.mark.cuda
def test_main_path_launches_k1_and_stays_finite():
    _card()
    before = invert_cdf_rows.launches
    parts, _ = P.merger_ic_fused(
        [1.5e15, 1.0e15], [4.0, 5.0], [[-1500.0, 0, 0], [1500.0, 0, 0]],
        [[0.3, 0, 0], [-0.45, 0, 0]], 5000.0, (30_000, 20_000),
        (24_000, 16_000), (6_000, 4_000),
        generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    assert invert_cdf_rows.launches == before + 2  # DM and stars
    for v in parts.values():
        assert v.is_cuda and bool(torch.isfinite(v).all())
