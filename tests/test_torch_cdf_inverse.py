"""Kernel K1 of the PyTorch port (inverse of monotone CDF rows).

On the CPU the port's wrapper runs the kernel's plain version; it is held
against the JAX package's Pallas kernel (interpret mode) and its jnp
reference on the same numpy-made rows, at max |difference| < 5e-6 in s
(the bound tests/test_pallas.py holds the Pallas kernel to).  The CUDA
kernel itself is held against the plain version in
tests/test_torch_cuda.py, which needs a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_generator_tpu.ops.pallas_kernels import (
    invert_cdf_rows as pallas_invert_cdf_rows,
)
from cluster_generator_tpu.ops.pallas_kernels import (
    invert_cdf_rows_reference,
)
from cluster_generator_tpu_torch.ops.cdf_inverse import (
    MAX_N_S,
    invert_cdf_rows,
    invert_cdf_rows_plain,
)

torch.set_num_threads(1)

TOL = 5e-6


def _random_rows(n_rows, n_s, seed=0):
    """Monotone CDF rows as tests/test_pallas.py builds them (float64)."""
    rng = np.random.RandomState(seed)
    pdf = rng.rand(n_rows, n_s - 1) + 0.05
    cdf = np.concatenate([np.zeros((n_rows, 1)), np.cumsum(pdf, axis=1)],
                         axis=1)
    return cdf / cdf[:, -1:]


def _f32_step(k, n):
    """k / (n - 1) as the kernel forms it: k times float32(1 / (n - 1))."""
    return float(torch.tensor(float(k)) * torch.tensor(1.0 / (n - 1)))


@pytest.mark.parametrize("n_s,n_q", [(256, 128), (1024, 512)])
def test_plain_matches_pallas_and_reference(n_s, n_q):
    cdf = _random_rows(17, n_s)  # 17 rows: ragged against any row tiling
    got = invert_cdf_rows(torch.from_numpy(cdf.astype(np.float32)),
                          n_q=n_q).numpy()
    pallas = np.asarray(pallas_invert_cdf_rows(jnp.asarray(cdf), n_q=n_q,
                                               interpret=True))
    ref = np.asarray(invert_cdf_rows_reference(jnp.asarray(cdf), n_q=n_q))
    assert got.shape == (17, n_q) and got.dtype == np.float32
    assert np.abs(got - pallas).max() < TOL
    assert np.abs(got - ref).max() < TOL


def test_identity_rows():
    c = np.linspace(0.0, 1.0, 64)[None, :].repeat(3, axis=0)
    got = invert_cdf_rows(torch.from_numpy(c.astype(np.float32)),
                          n_q=33).numpy()
    pallas = np.asarray(pallas_invert_cdf_rows(jnp.asarray(c), n_q=33,
                                               interpret=True))
    assert np.abs(got - np.linspace(0.0, 1.0, 33)[None, :]).max() < 1e-6
    assert np.abs(got - pallas).max() < TOL


def test_flat_bins_and_top_quantile():
    """A flat bin is never chosen for q < 1; q = 1 lands in the
    right-closed last bin, flat or not."""
    row = np.array([[0.0, 0.2, 0.2, 0.2, 0.5, 0.5, 1.0, 1.0]], np.float32)
    n_s, n_q = row.shape[1], 11  # q_2 = 0.2 sits exactly on the flat run
    got = invert_cdf_rows(torch.from_numpy(row), n_q=n_q).numpy()
    pallas = np.asarray(pallas_invert_cdf_rows(jnp.asarray(row), n_q=n_q,
                                               interpret=True))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, pallas)
    # q = 0.2: bins 1 and 2 are flat at 0.2, so the pick is bin 3 (0.2->0.5)
    assert got[0, 2] == _f32_step(3, n_s)
    # q = 1: last bin (k = n_s - 2), whose lerp weight is 0
    assert got[0, -1] == _f32_step(n_s - 2, n_s)


def test_rows_with_flat_runs_match_pallas():
    """Random rows with long flat runs (a pdf that is zero over stretches,
    like a speed pdf near v_esc before the eps ramp)."""
    rng = np.random.RandomState(4)
    pdf = rng.rand(9, 255) * (rng.rand(9, 255) > 0.6)
    pdf[:, 0] += 1e-3
    cdf = np.concatenate([np.zeros((9, 1)), np.cumsum(pdf, axis=1)], axis=1)
    cdf = (cdf / cdf[:, -1:]).astype(np.float32)
    got = invert_cdf_rows(torch.from_numpy(cdf), n_q=200).numpy()
    pallas = np.asarray(pallas_invert_cdf_rows(jnp.asarray(cdf), n_q=200,
                                               interpret=True))
    assert np.isfinite(got).all()
    assert np.abs(got - pallas).max() < TOL


def test_plain_chunks_rows_without_changing_results():
    """The plain version works in row chunks; chunking must not change a
    bit (many rows at a wide shape force several chunks)."""
    cdf = torch.from_numpy(_random_rows(40, 512, seed=3).astype(np.float32))
    whole = torch.cat([invert_cdf_rows_plain(cdf[i:i + 1], 512)
                       for i in range(40)])
    np.testing.assert_array_equal(invert_cdf_rows_plain(cdf, 512).numpy(),
                                  whole.numpy())


@pytest.mark.parametrize("bad,err", [
    (lambda: torch.zeros((4, 16), dtype=torch.float64), TypeError),
    (lambda: torch.zeros((4, 16, 2)), ValueError),
    (lambda: torch.zeros((16, 4)).t(), ValueError),
    (lambda: torch.zeros((4, 1)), ValueError),
    (lambda: torch.zeros((4, MAX_N_S + 1)), ValueError),
    (lambda: torch.zeros((4, 16), device="meta"), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        invert_cdf_rows(bad(), n_q=8)


def test_cpu_tensor_takes_the_plain_version_and_counts_nothing():
    before = invert_cdf_rows.launches
    cdf = torch.from_numpy(_random_rows(3, 32).astype(np.float32))
    np.testing.assert_array_equal(invert_cdf_rows(cdf, n_q=16).numpy(),
                                  invert_cdf_rows_plain(cdf, 16).numpy())
    assert invert_cdf_rows.launches == before
    with pytest.raises(ValueError):
        invert_cdf_rows(cdf, n_q=1)
