"""The port's core modules against the JAX package's: constants,
cosmology, grid, quadrature and interpolation.

Inputs are made with numpy from a seed and given to both packages.  The
port works along the last axis with a leading halo axis; its batched
results are compared row by row with the JAX functions.  Float64 results
agree to rtol 1e-9 (most to ~1e-15: the two run the same formulas, with
another summation order in the cumulative sums and other libm calls).
"""

import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cluster_generator_tpu.core.constants as JC
import cluster_generator_tpu.core.quadrature as JQ
import cluster_generator_tpu.profiles.library as JL
import cluster_generator_tpu_torch.core.constants as TC
import cluster_generator_tpu_torch.core.quadrature as TQ
import cluster_generator_tpu_torch.profiles.library as TL
from cluster_generator_tpu.core.cosmology import default_cosmology as j_cosmo
from cluster_generator_tpu.core.grid import log_radius_grid as j_grid
from cluster_generator_tpu.core.units import density_to_ne as j_ne
from cluster_generator_tpu_torch.core.cosmology import (
    default_cosmology as t_cosmo,
)
from cluster_generator_tpu_torch.core.grid import linspace
from cluster_generator_tpu_torch.core.grid import log_radius_grid as t_grid
from cluster_generator_tpu_torch.core.units import density_to_ne as t_ne

# the JAX package's core/__init__ exports a function named ``interp``
JI = importlib.import_module("cluster_generator_tpu.core.interp")
TI = importlib.import_module("cluster_generator_tpu_torch.core.interp")

torch.set_num_threads(1)

RTOL = 1e-9


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ------------------------------------------------- constants, cosmology, grid
@pytest.mark.parametrize("name", ["G", "mp", "kboltz", "kpc_to_cm", "keV",
                                  "km_s", "X_H", "mu", "mue", "KPC_M",
                                  "MYR_S", "MSUN_KG", "MP_SI"])
def test_constants_are_the_same_numbers(name):
    assert getattr(TC, name) == getattr(JC, name)


def test_critical_density_and_units():
    for z in (0.0, 0.1, 1.3):
        _close(t_cosmo().critical_density(z),
               float(j_cosmo().critical_density(z)), rtol=1e-14)
    rho = np.geomspace(1e2, 1e8, 7)
    _close(t_ne(_t(rho)).numpy(), np.asarray(j_ne(jnp.asarray(rho))),
           rtol=1e-15)


def test_log_radius_grid_and_linspace():
    _close(t_grid(0.1, 1.0e4, 1000, device="cpu").numpy(),
           np.asarray(j_grid(0.1, 1.0e4, 1000)), rtol=1e-14)
    # batched linspace: one row per (start, stop), jnp.linspace's arithmetic
    lo, hi = np.array([-2.0, 0.5]), np.array([3.0, 7.25])
    got = linspace(_t(lo), _t(hi), 257).numpy()
    for i in range(2):
        _close(got[i], np.asarray(jnp.linspace(lo[i], hi[i], 257)),
               rtol=1e-15, atol=1e-15)
    assert got[0, -1] == hi[0] and got[1, 0] == lo[1]


def test_log_radius_grid_runs_on_the_card_unless_asked(monkeypatch):
    """The public grid resolves its device like every entry point: the
    card by default (an error without one), the CPU when asked.  At
    (1, 1e4, 5) the points are the exact powers of ten, so the two
    packages agree to rtol 1e-15; at 1000 points XLA's CPU compiler fuses
    jnp.linspace into multiply-adds, which moves some exponents by one
    ulp (1.1e-15 in the grid), hence 1e-14 above."""
    import cluster_generator_tpu_torch as cg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cg.log_radius_grid(1, 1e4, 5)
    got = cg.log_radius_grid(1, 1e4, 5, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float64
    _close(got.numpy(), np.asarray(j_grid(1, 1e4, 5)), rtol=1e-15)


# the public callables whose ``device=None`` means "the device of the
# tensors they are given" (their fields), not the CPU
DEVICE_FROM_TENSORS = {"ClusterModel", "HydrostaticEquilibrium",
                       "ClusterParticles", "ClusterParticles.from_fields"}


def _public_callables():
    import inspect

    import cluster_generator_tpu_torch as cg
    from cluster_generator_tpu_torch import parallel, pipeline

    for mod in (cg, parallel, pipeline):
        for name in mod.__all__:
            obj = getattr(mod, name)
            if inspect.isclass(obj):
                yield name, obj
                for member in vars(obj):
                    if not member.startswith("_"):
                        yield f"{name}.{member}", getattr(obj, member)
            elif callable(obj):
                yield name, obj


def test_every_public_device_parameter_defaults_to_the_card():
    import inspect

    seen, odd = 0, {}
    for name, fn in _public_callables():
        try:
            param = inspect.signature(fn).parameters.get("device")
        except (TypeError, ValueError):
            continue
        if param is None:
            continue
        seen += 1
        if param.default != "cuda":
            odd[name] = param.default
    assert seen > 50
    assert odd == dict.fromkeys(DEVICE_FROM_TENSORS), odd


# ----------------------------------------------------------------- quadrature
RR = np.geomspace(0.1, 1.0e4, 1000)
RR2 = np.stack([RR, np.geomspace(0.2, 5.0e3, 1000)])  # two halos' grids


@pytest.mark.parametrize("kind", ["snfw", "vikhlinin"])
def test_integrate_mass_batched(kind):
    """Two halos in one call; each row equals the JAX package's integral
    of that halo's profile."""
    if kind == "snfw":
        M, a = np.array([1.2e15, 6.0e14]), np.array([500.0, 300.0])
        t_prof = TL.snfw_density_profile(_t(M), _t(a))
        j_profs = [JL.snfw_density_profile(M[i], a[i]) for i in range(2)]
    else:
        rc = np.array([100.0, 60.0])
        t_prof = TL.vikhlinin_density_profile(1.0e7, _t(rc), 1000.0, 1.0,
                                              0.67, 3)
        j_profs = [JL.vikhlinin_density_profile(1.0e7, rc[i], 1000.0, 1.0,
                                                0.67, 3) for i in range(2)]
    got = TQ.integrate_mass(t_prof, _t(RR2)).numpy()
    for i in range(2):
        _close(got[i], np.asarray(JQ.integrate_mass(j_profs[i],
                                                    jnp.asarray(RR2[i]))))


def test_integrate_from_tail_and_cumtrapz():
    prof_t = TL.snfw_density_profile(1.0e15, 400.0)
    prof_j = JL.snfw_density_profile(1.0e15, 400.0)
    _close(TQ.integrate_from(lambda r: prof_t(r) * r, _t(RR)).numpy(),
           np.asarray(JQ.integrate_from(lambda r: prof_j(r) * r,
                                        jnp.asarray(RR))), atol=1e-300)
    rmax = RR[-1]
    _close(float(TQ.integrate_tail_to_inf(
        lambda r: prof_t(r) * (rmax / r) ** 2, rmax)),
        float(JQ.integrate_tail_to_inf(
            lambda r: prof_j(r) * (rmax / r) ** 2, rmax)))
    y = np.sin(RR2 / 1000.0)
    got = TQ.cumtrapz(_t(y), _t(RR2)).numpy()
    for i in range(2):
        _close(got[i], np.asarray(JQ.cumtrapz(jnp.asarray(y[i]),
                                              jnp.asarray(RR2[i]))),
               atol=1e-12)


def test_cumulative_integral_from_grid_start():
    fn_t = lambda r: torch.exp(-r / 3000.0) * r  # noqa: E731
    fn_j = lambda r: jnp.exp(-r / 3000.0) * r  # noqa: E731
    _close(TQ.cumulative_integral(fn_t, _t(RR), from_zero=False).numpy(),
           np.asarray(JQ.cumulative_integral(fn_j, jnp.asarray(RR),
                                             from_zero=False)), atol=1e-9)


# -------------------------------------------------------------- interpolation
def test_pcr_matches_jax():
    rng = np.random.default_rng(7)
    for n in (2, 5, 1023):
        dl = rng.uniform(0.5, 1.5, n - 1)
        du = rng.uniform(0.5, 1.5, n - 1)
        dm = rng.uniform(4.0, 6.0, n)
        rhs = rng.normal(size=n)
        _close(TI._pcr(_t(dl), _t(dm), _t(du), _t(rhs)).numpy(),
               np.asarray(jax.jit(JI._pcr)(jnp.asarray(dl), jnp.asarray(dm),
                                           jnp.asarray(du),
                                           jnp.asarray(rhs))),
               rtol=1e-12, atol=1e-12)


def test_cubic_spline_values_and_derivatives_batched():
    """Two random grids of one length splined in one call; values and
    first and second derivatives (inside and beyond the knots) match the
    JAX spline of each row."""
    rng = np.random.default_rng(42)
    xs = np.stack([np.sort(np.geomspace(1e-2, 1e3, 257)
                           * np.exp(rng.normal(0, 0.05, 257)))
                   for _ in range(2)])
    ys = np.sin(np.log(xs)) * xs**0.3
    q = np.stack([np.sort(rng.uniform(0.5 * x[0], 1.5 * x[-1], 500))
                  for x in xs])
    sp_t = TI.cubic_spline(_t(xs), _t(ys))
    for nu in (0, 1, 2):
        got = TI.spline_eval(sp_t, _t(q), nu=nu).numpy()
        for i in range(2):
            sp_j = JI.cubic_spline(jnp.asarray(xs[i]), jnp.asarray(ys[i]))
            want = np.asarray(JI.spline_eval(sp_j, jnp.asarray(q[i]), nu=nu))
            _close(got[i], want, atol=1e-9 * np.abs(want).max())


def test_spline_eval_uniform_bit_identical_to_searched_route():
    """As tests/test_interp.py pins for the JAX package: the scatter-and-
    cumsum bracketing gives the searched route's bits, including nodes
    below the knots and nodes on a knot; and both match JAX."""
    j_uniform = jax.jit(JI.spline_eval_uniform, static_argnums=3)
    rng = np.random.default_rng(5)
    n_knots = 150  # one knot count: one compile of the JAX spline
    for _ in range(3):
        x = np.sort(rng.uniform(0.1, 10.0, n_knots))
        y = rng.standard_normal(n_knots)
        sp_t = TI.cubic_spline(_t(x), _t(y))
        sp_j = JI.cubic_spline(jnp.asarray(x), jnp.asarray(y))
        for lo, step, n in [(0.0, x[-1] / 500, 501),
                            (x[0], (x[-1] - x[0]) / 63, 64),
                            (x[3], 1e-3, 17)]:
            nodes = _t(lo) + _t(step) * torch.arange(n, dtype=torch.float64)
            searched = TI.spline_eval(sp_t, nodes).numpy()
            got = TI.spline_eval_uniform(sp_t, lo, step, n).numpy()
            np.testing.assert_array_equal(got, searched)
            want = np.asarray(j_uniform(sp_j, jnp.asarray(lo),
                                        jnp.asarray(step), n))
            _close(got, want, atol=1e-12 * np.abs(want).max())


def test_interp_bracket_indices_and_interp_monotone():
    rng = np.random.default_rng(11)
    for _ in range(4):
        n = int(rng.integers(8, 300))
        x = np.sort(rng.uniform(0.0, 10.0, n))
        y = rng.standard_normal(n)
        q = np.concatenate([rng.uniform(-1.0, 11.0, 400),
                            x[rng.integers(0, n, 20)],
                            [x[0], x[-1], -5.0, 50.0]])
        jref = np.clip(np.searchsorted(x, q, side="right") - 1, 0, n - 2)
        np.testing.assert_array_equal(
            TI.bracket_indices(_t(x), _t(q)).numpy(), jref)
        want = np.asarray(jnp.interp(jnp.asarray(q), jnp.asarray(x),
                                     jnp.asarray(y)))
        _close(TI.interp_monotone(_t(q), _t(x), _t(y)).numpy(), want,
               rtol=0, atol=1e-12)
        _close(TI.interp(_t(q), _t(x), _t(y)).numpy(), want, rtol=0,
               atol=1e-12)
    # flat interval: interp_monotone takes the left value, no 0/0
    out = TI.interp_monotone(_t([1.0]), _t([0.0, 1.0, 1.0, 2.0]),
                             _t([0.0, 10.0, 20.0, 30.0]))
    assert torch.isfinite(out).all()


def _matrix_brackets(grid, queries):
    """The comparison-matrix definition of the bracket: count the nodes at
    or below each query."""
    j = torch.sum(grid[..., None, :] <= queries[..., :, None], dim=-1) - 1
    return torch.clamp(j, 0, grid.shape[-1] - 2)


def _bracket_case(case, dtype, rng):
    """(grid, queries) of one shape case; queries below the first node,
    above the last, on nodes, infinite and in between."""
    n = 37
    if case == "1d-grid":
        grid = np.sort(rng.uniform(0.5, 9.0, n))
    else:
        grid = np.sort(rng.uniform(0.5, 9.0, (3, n)), axis=-1)
    if case == "repeated-nodes":
        # flat runs inside each row, one three nodes long
        grid[:, [5, 6, 20, 21, 22]] = grid[:, [4, 4, 19, 19, 19]]
    g = grid.reshape(-1, n)
    q = np.concatenate([rng.uniform(-1.0, 10.0, (g.shape[0], 60)),
                        g[:, rng.integers(0, n, 15)], g[:, :1], g[:, -1:],
                        np.tile([-5.0, 50.0, -np.inf, np.inf],
                                (g.shape[0], 1))], axis=-1)
    if case == "1d-grid":
        q = q.reshape(3, 3, -1)
    return (torch.tensor(grid, dtype=dtype), torch.tensor(q, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["1d-grid", "batched-grid",
                                  "repeated-nodes"])
def test_searched_brackets_equal_the_comparison_matrix(case, dtype,
                                                       monkeypatch):
    """The searched brackets equal the comparison-matrix count at every
    query that is not NaN, and ``interp_monotone`` and
    ``build_joint_speed_pairs`` built on them equal, bit for bit, the same
    functions run on the matrix brackets; a NaN query still gives NaN."""
    import cluster_generator_tpu_torch.virial as TV

    rng = np.random.default_rng(23)
    grid, q = _bracket_case(case, dtype, rng)
    j = TI.bracket_indices(grid, q)
    assert j.dtype == torch.int64
    assert torch.equal(j, _matrix_brackets(grid, q))
    y = torch.tensor(rng.standard_normal(grid.shape), dtype=dtype)
    qn = q.clone()
    qn.view(-1)[::7] = float("nan")
    searched = TI.interp_monotone(qn, grid, y)

    # the joint fold: psi falls with radius, its energy rows ascend
    B, N, rows, n_q, rq = 3, 64, 16, 12, 20
    rr = torch.tensor(np.logspace(0.0, 3.0, N), dtype=torch.float64)
    rr = rr * torch.tensor(rng.uniform(0.8, 1.2, (B, 1)))
    psi = 1.0 / (1.0 + rr) + torch.tensor(rng.uniform(0.0, 0.1, (B, 1)))
    row_ee = torch.flip(psi, (-1,))[..., ::N // rows]
    s_inv = torch.sort(torch.tensor(rng.uniform(0.0, 1.0, (B, rows, n_q))),
                       dim=-1).values
    r_q = torch.cat([torch.tensor(rng.uniform(0.5, 1200.0, (B, rq - 4))),
                     rr[:, :1], rr[:, -1:], rr[:, 7:9]], dim=-1)
    r_q[1, 3] = float("nan")
    # queries on the energy rows themselves too
    psi_q = torch.cat([TI.interp_monotone(r_q, rr, psi), row_ee[:, 2:5]],
                      dim=-1)
    joint = TV.build_joint_speed_pairs(rr, psi, row_ee, s_inv, r_q,
                                       dtype=dtype)
    joint_q = TV.build_joint_speed_pairs(rr, psi, row_ee, s_inv, None,
                                         dtype=dtype, psi_q=psi_q)

    monkeypatch.setattr(TI, "bracket_indices", _matrix_brackets)
    monkeypatch.setattr(TV, "bracket_indices", _matrix_brackets)
    matrix = TI.interp_monotone(qn, grid, y)
    ok = ~torch.isnan(qn)
    assert torch.equal(searched[ok], matrix[ok])
    assert torch.isnan(searched[~ok]).all() and torch.isnan(matrix[~ok]).all()
    for got, want in [(joint, TV.build_joint_speed_pairs(
            rr, psi, row_ee, s_inv, r_q, dtype=dtype)),
            (joint_q, TV.build_joint_speed_pairs(
                rr, psi, row_ee, s_inv, None, dtype=dtype, psi_q=psi_q))]:
        assert got.dtype == dtype
        assert torch.isnan(got[1, 3]).all() and torch.isnan(want[1, 3]).all()
        got[1, 3] = want[1, 3] = 0.0
        assert torch.equal(got, want)


def test_a_first_bracket_imports_no_sympy():
    """The brackets' first call in a process imports nothing beyond what
    the port's import did: ``torch.broadcast_shapes`` imports sympy at its
    first call, which is seconds of a program's set-up."""
    code = ("import sys, torch\n"
            "from cluster_generator_tpu_torch.core.interp import (\n"
            "    bracket_indices, interp_monotone)\n"
            "g = torch.sort(torch.rand(3, 9, dtype=torch.float64), -1).values\n"
            "bracket_indices(g, torch.rand(5, dtype=torch.float64))\n"
            "interp_monotone(torch.rand(3, 4, dtype=torch.float64), g, g)\n"
            "assert 'sympy' not in sys.modules\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
