"""The speed-CDF rows of the float32 node table (``ops.speed_cdf``).

On the CPU the wrapper runs the kernel's plain version.  It is held here,
bit for bit, against a NumPy transcription of the same float32 and
float64 operations, and :func:`virial.speed_cdf_rows` against the
float32-table branch as it was written before the kernel's plain version
was split out of it.  The CUDA kernel itself is held against the plain
version in tests/test_torch_cuda.py, which needs a card.
"""

import numpy as np
import pytest
import torch

import cluster_generator_tpu_torch.virial as V
from cluster_generator_tpu_torch.core.grid import linspace
from cluster_generator_tpu_torch.core.interp import (cubic_spline,
                                                     spline_eval_uniform)
from cluster_generator_tpu_torch.core.quadrature import cumsum
from cluster_generator_tpu_torch.ops.speed_cdf import (
    MAX_N_S,
    speed_cdf_rows_f32,
    speed_cdf_rows_f32_plain,
)

torch.set_num_threads(1)


def _inputs(halos, rows, n_s, nf1, nf2, seed, zero_halo=None):
    """Seeded arguments of the plain version: row energies of each halo
    with one row at its maximum and one on the segment boundary b, and a
    node table of non-negative floats (all zero for ``zero_halo``)."""
    rng = np.random.RandomState(seed)
    e_top = rng.uniform(1e-2, 1e2, size=halos)
    row_ee = rng.uniform(0.01, 0.99, size=(halos, rows)) * e_top[:, None]
    row_ee[:, -1] = e_top
    row_ee[:, 0] = 0.9 * e_top  # the query at s = 0 lands on b exactly
    fu = rng.rand(halos, nf1 + nf2).astype(np.float32)
    fu[fu < 0.1] = 0.0
    if zero_halo is not None:
        fu[zero_halo] = 0.0
    row_ee = torch.from_numpy(row_ee)
    e_max = torch.amax(row_ee, dim=-1)
    return (row_ee, linspace(0.0, 1.0, n_s, device="cpu"),
            torch.from_numpy(fu), 0.9 * e_max, e_max, nf1, nf2)


def _numpy_branch(row_ee, s, fu, b, e_max, nf1, nf2):
    """The float32-table branch, operation by operation, in NumPy."""
    f4 = np.float32
    row_ee, s, fu, b, e_max = (t.numpy() for t in (row_ee, s, fu, b, e_max))
    n_s = s.shape[0]
    E = row_ee[..., :, None] * (1.0 - s * s)
    s4 = s.astype(f4)
    Ef = E.astype(f4).reshape(E.shape[:-2] + (-1,))
    bt = b.astype(f4)[..., None]
    et = e_max.astype(f4)[..., None]
    x1 = np.clip(Ef / bt * f4(nf1), f4(0.0), f4(nf1 - 1e-4))
    k1 = np.minimum(x1.astype(np.int64), nf1 - 1)
    w1 = x1 - k1.astype(f4)
    x2 = np.clip((Ef - bt) / (et - bt) * f4(nf2 - 1), f4(0.0),
                 f4(nf2 - 1 - 1e-4))
    k2 = np.minimum(x2.astype(np.int64), nf2 - 2)
    w2 = x2 - k2.astype(f4)
    in1 = Ef < bt
    k = np.where(in1, k1, nf1 + k2)
    w = np.where(in1, w1, w2)
    f_e = ((f4(1.0) - w) * np.take_along_axis(fu, k, -1)
           + w * np.take_along_axis(fu, k + 1, -1)).reshape(E.shape)
    pdf = (s4 * s4) * f_e
    pdf = pdf / np.maximum(pdf.max(axis=-1, keepdims=True), f4(1e-30))
    ds = s4[1] - s4[0]
    x = (f4(0.5) * (pdf[..., 1:] + pdf[..., :-1]) * ds).astype(np.float64)
    step = 1
    while step < x.shape[-1]:  # the log-depth scan of core.quadrature
        x = np.concatenate([x[..., :step], x[..., step:] + x[..., :-step]],
                           axis=-1)
        step *= 2
    cdf = np.concatenate([np.zeros_like(pdf[..., :1]), x.astype(f4)], -1)
    total = cdf[..., -1:]
    cdf = cdf / np.where(total > 0.0, total, f4(1.0))
    cdf = cdf + np.arange(n_s, dtype=f4) * f4(1e-7)
    return cdf / cdf[..., -1:]


@pytest.mark.parametrize("halos,rows,n_s,nf1,nf2,zero_halo", [
    (2, 5, 33, 64, 64, None),
    (3, 7, 100, 128, 32, 1),     # odd n_s; a halo whose f_E is all zero
    (1, 4, 257, 4096, 4096, None),
    (2, 3, 2, 8, 2, 0),          # the narrowest rows and node grids
])
def test_plain_version_equals_a_numpy_transcription(halos, rows, n_s, nf1,
                                                    nf2, zero_halo):
    args = _inputs(halos, rows, n_s, nf1, nf2, seed=n_s, zero_halo=zero_halo)
    got = speed_cdf_rows_f32_plain(*args)
    want = _numpy_branch(*args)
    assert got.shape == (halos, rows, n_s) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(torch.isfinite(got).all())
    assert bool((torch.diff(got, dim=-1) > 0).all())  # strictly increasing
    if zero_halo is not None:  # the ramp alone, normalised
        ramp = np.arange(n_s, dtype=np.float32) * np.float32(1e-7)
        np.testing.assert_array_equal(
            got[zero_halo].numpy(),
            np.broadcast_to(ramp / ramp[-1], (rows, n_s)))


@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_the_wrapper_runs_the_plain_version_on_the_cpu(lead):
    halos = int(np.prod(lead, dtype=np.int64))
    row_ee, s, fu, b, e_max, nf1, nf2 = _inputs(halos, 6, 65, 32, 16, seed=2)
    args = (row_ee.reshape(lead + (6,)), s, fu.reshape(lead + (48,)),
            b.reshape(lead), e_max.reshape(lead), nf1, nf2)
    before = speed_cdf_rows_f32.launches
    got = speed_cdf_rows_f32(*args)
    assert speed_cdf_rows_f32.launches == before  # no kernel on the CPU
    assert got.shape == lead + (6, 65)
    assert torch.equal(got, speed_cdf_rows_f32_plain(*args))


def _branch_before_split(ee, f_vals, n_s, row_ee, nf1, nf2):
    """``virial.speed_cdf_rows`` with ``table_dtype=torch.float32`` as it
    read before its float32 part became ``ops.speed_cdf``."""
    f_sp = cubic_spline(ee, f_vals)
    dev = ee.device
    s = linspace(0.0, 1.0, n_s, device=dev)
    E = row_ee[..., :, None] * (1.0 - (s * s))
    NF1, NF2 = nf1, nf2
    fmax = torch.amax(torch.abs(f_vals), dim=-1, keepdim=True)
    e_max = torch.amax(row_ee, dim=-1)
    b = 0.9 * e_max
    step1 = b / NF1
    step2 = (e_max - b) / (NF2 - 1)
    fu = torch.cat([
        spline_eval_uniform(f_sp, torch.zeros_like(b), step1, NF1),
        spline_eval_uniform(f_sp, b, step2, NF2)], dim=-1)
    fu = torch.clamp_min(fu / fmax, 0.0).to(torch.float32)
    s = s.to(torch.float32)
    Ef = E.to(torch.float32).reshape(E.shape[:-2] + (-1,))
    bt = b.to(torch.float32)[..., None]
    et = e_max.to(torch.float32)[..., None]
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
    ds = s[1] - s[0]
    inc = 0.5 * (pdf[..., 1:] + pdf[..., :-1]) * ds
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]),
                     cumsum(inc.to(torch.float64)).to(pdf.dtype)], dim=-1)
    total = cdf[..., -1:]
    cdf = cdf / torch.where(total > 0.0, total, torch.ones_like(total))
    cdf = cdf + torch.arange(n_s, dtype=cdf.dtype, device=dev) * 1e-7
    return cdf / cdf[..., -1:]


@pytest.mark.parametrize("n_s,nf", [(512, 4096), (256, 4096), (100, 256)])
def test_speed_cdf_rows_keeps_its_bits_through_the_wrapper(n_s, nf):
    """Two halos of an isochrone-like f(E) on a 160-point grid: the rows
    that ``speed_cdf_rows`` builds through the wrapper are the bits of the
    branch before the split."""
    ee = torch.from_numpy(np.stack([np.geomspace(1e-3, 2.0, 160),
                                    np.geomspace(2e-3, 3.5, 160)]))
    f_vals = ee ** 2.5 * torch.exp(-ee) + 1e-3 * ee
    row_ee = ee[:, ::5].contiguous()
    got = V.speed_cdf_rows(ee, f_vals, n_s=n_s, table_dtype=torch.float32,
                           row_ee=row_ee, nf1=nf, nf2=nf)
    want = _branch_before_split(ee, f_vals, n_s, row_ee, nf, nf)
    assert got.dtype == torch.float32 and got.shape == (2, 32, n_s)
    assert torch.equal(got, want)


def test_the_kernel_takes_rows_of_8192_and_the_wrapper_refuses_wider():
    assert MAX_N_S >= 8192
    args = list(_inputs(1, 1, MAX_N_S + 1, 4, 4, seed=0))
    with pytest.raises(ValueError, match="n_s must be in"):
        speed_cdf_rows_f32(*args)
    args = list(_inputs(1, 1, 16, 4, 4, seed=0))
    for i, value, err in ((2, args[2].double(), TypeError),      # fu dtype
                          (2, args[2][:, :-1], ValueError),      # fu width
                          (0, args[0].float(), TypeError),       # row_ee
                          (3, args[3][None], ValueError)):       # b's shape
        with pytest.raises(err):
            speed_cdf_rows_f32(*args[:i], value, *args[i + 1:])
    ee = torch.from_numpy(np.geomspace(1e-3, 2.0, 16))
    with pytest.raises(ValueError, match="table_dtype"):
        V.speed_cdf_rows(ee, ee, n_s=16, table_dtype=torch.float16)


@pytest.mark.parametrize("n_s,nf", [(512, 4096), (100, 256)])
def test_speed_cdf_rows_takes_float32_energies(n_s, nf):
    """Float32 ``ee``, ``f_vals`` and ``row_ee`` (as the JAX package
    takes them): the energies are taken in float64 for the kernel's plain
    version, and the rows agree with the branch before the split, which
    computed b and e_max in float32, to a few float32 ulps."""
    ee = torch.from_numpy(np.stack([np.geomspace(1e-3, 2.0, 160),
                                    np.geomspace(2e-3, 3.5, 160)])).float()
    f_vals = ee ** 2.5 * torch.exp(-ee) + 1e-3 * ee
    row_ee = ee[:, ::5].contiguous()
    got = V.speed_cdf_rows(ee, f_vals, n_s=n_s, table_dtype=torch.float32,
                           row_ee=row_ee, nf1=nf, nf2=nf)
    want = _branch_before_split(ee, f_vals, n_s, row_ee, nf, nf)
    assert got.dtype == torch.float32 and got.shape == (2, 32, n_s)
    assert bool((got[..., 1:] > got[..., :-1]).all())
    assert torch.allclose(got, want, rtol=0.0, atol=1e-6)
