"""The port's CUDA kernels and captured programs on the card (marker
``cuda``).

Without a card every test here skips.  On a machine with one, run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

``--noconftest`` because tests/conftest.py sets up JAX, which this file
does not use (it imports only torch and the port).
"""

import os
import sys

import numpy as np
import pytest
import torch

from cluster_generator_tpu_torch import pipeline as P
from cluster_generator_tpu_torch import virial as V
from cluster_generator_tpu_torch.core import compiled as C
from cluster_generator_tpu_torch.ops import abel as A
from cluster_generator_tpu_torch.ops.abel import (
    abel_g_rows,
    abel_g_rows_plain,
)
from cluster_generator_tpu_torch.ops import draw_particles as D
from cluster_generator_tpu_torch.ops.cdf_inverse import (
    invert_cdf_rows,
    invert_cdf_rows_plain,
)
from cluster_generator_tpu_torch.ops.speed_cdf import (
    MAX_N_S,
    speed_cdf_rows_f32,
    speed_cdf_rows_f32_plain,
)
from cluster_generator_tpu_torch.parallel import ensemble as E
from cluster_generator_tpu_torch.parallel import mergers as MG

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the case builders of the card's smoke run)


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
                                            (256, 512, 512),
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
    assert torch.equal(got, want)  # the same float32 operations, in order


@pytest.mark.cuda
def test_k1_is_bit_identical_at_the_path_shapes_and_edge_rows():
    """The main-path inputs (merger and ensemble batch, DM and stars; the
    class path's DM, stars and Osipkov-Merritt DM), built by the port on
    the card, and the rows that probe the bin selection: ties, flat runs,
    a first value above 0, odd widths."""
    _card()
    cases = (chip_smoke.k1_path_cases(P, V, E)
             + chip_smoke.k1_edge_cases(torch.device("cuda")))
    shapes = {(name, tuple(cdf.shape), n_q) for name, cdf, n_q in cases}
    assert {("class_dm", (256, 512), 512), ("class_star", (256, 512), 512),
            ("class_dm_om", (256, 512), 512),
            ("merger_dm", (512, 512), 512), ("merger_star", (128, 256), 256),
            ("datagen_dm", (32768, 512), 512),
            ("datagen_star", (16384, 256), 256)} <= shapes
    for name, cdf, n_q in cases:
        got = invert_cdf_rows(cdf, n_q)
        want = invert_cdf_rows_plain(cdf, n_q)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name


@pytest.mark.cuda
def test_speed_cdf_kernel_is_bit_identical_at_the_path_shapes():
    """The kernel's arguments as the port builds them on the card (the
    merger's, the scene batch's and the 256-cluster ensemble batch's DM
    and star rows), one launch each, equal to the plain version."""
    _card()
    cases = chip_smoke.speed_cdf_path_cases(P, V, E)
    shapes = {(name, tuple(a[0].shape) + (a[1].shape[0],))
              for name, a in cases}
    assert {("merger_dm", (2, 256, 512)), ("merger_star", (2, 64, 256)),
            ("datagen_dm", (256, 128, 512)),
            ("datagen_star", (256, 64, 256))} <= shapes
    for name, args in cases:
        before = speed_cdf_rows_f32.launches
        got = speed_cdf_rows_f32(*args)
        want = speed_cdf_rows_f32_plain(*args)
        torch.cuda.synchronize()
        assert speed_cdf_rows_f32.launches == before + 1, name
        assert got.shape == want.shape and got.is_cuda, name
        assert torch.equal(got, want), name  # the same operations, in order


@pytest.mark.cuda
def test_speed_cdf_kernel_is_bit_identical_at_the_edge_rows():
    """Rows at e_max and on the segment boundary b, a halo whose f_E is
    all zero, one halo, no leading axis, n_s of 100, 1000 and 8192."""
    _card()
    for name, args in chip_smoke.speed_cdf_edge_cases(torch.device("cuda")):
        got = speed_cdf_rows_f32(*args)
        want = speed_cdf_rows_f32_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name


@pytest.mark.cuda
def test_speed_cdf_wrapper_refuses_rows_above_its_limit():
    _card()
    args = chip_smoke.speed_cdf_edge_cases(torch.device("cuda"))[0][1]
    wide = torch.linspace(0.0, 1.0, MAX_N_S + 1, dtype=torch.float64,
                          device="cuda")
    before = speed_cdf_rows_f32.launches
    with pytest.raises(ValueError, match="n_s must be in"):
        speed_cdf_rows_f32(args[0], wide, *args[2:])
    assert speed_cdf_rows_f32.launches == before


@pytest.mark.cuda
def test_abel_kernel_matches_the_plain_sums_at_the_path_shapes():
    """The DFs' Abel sums as the port builds them on the card (ensemble
    batches of 256 and 64, the 704-point Osipkov-Merritt batch, the
    merger's two halos on 1000 and 1192 points, the class path's one
    cluster): one launch each, within 1e-12 of each row's largest |g| of
    the plain version (the same terms, summed in another order), the same
    bits on a second launch and at every lane count."""
    _card()
    cases = chip_smoke.abel_path_cases(P, V, E)
    shapes = {(name, tuple(a[4].shape), a[0].shape[-1]) for name, a in cases}
    assert {("datagen_dm", (256, 512), 512),
            ("datagen_b64_dm", (64, 512), 512),
            ("datagen_om_dm", (256, 704), 704),
            ("merger_dm", (2, 1000), 1000), ("merger_om_dm", (2, 1192), 1192),
            ("class_dm", (1000,), 1000)} <= shapes
    for name, args in cases:
        before = abel_g_rows.launches
        got = abel_g_rows(*args)
        torch.cuda.synchronize()
        assert abel_g_rows.launches == before + 1, name
        want = abel_g_rows_plain(*args)
        assert got.shape == want.shape and got.is_cuda, name
        err = chip_smoke.abel_row_err(got, want)
        assert err <= chip_smoke.ABEL_RTOL, (name, err)
        assert torch.equal(got, abel_g_rows(*args)), name
        lead = A._check(*args)
        for log_s in range(6):
            assert torch.equal(got, A._launch(*args, lead, log_s=log_s)), \
                (name, log_s)


@pytest.mark.cuda
def test_abel_kernel_at_the_edge_rows():
    """N of 777 and of 4096 + 192 (past one group of shared memory), a
    flat density (g = 0 exactly), rows at 0, inside interval 0 and above
    the last knot, an odd row count, one row, no leading axis, knots
    shared by the entries."""
    _card()
    for name, args in chip_smoke.abel_edge_cases(torch.device("cuda")):
        got = abel_g_rows(*args)
        want = abel_g_rows_plain(*args)
        torch.cuda.synchronize()
        assert got.shape == want.shape, name
        err = chip_smoke.abel_row_err(got, want)
        assert err <= chip_smoke.ABEL_RTOL, (name, err)
        if name == "flat_density":
            assert not bool(got.any()) and not bool(want.any())
        lead = A._check(*args)
        for log_s in range(6):
            assert torch.equal(got, A._launch(*args, lead, log_s=log_s)), \
                (name, log_s)


@pytest.mark.cuda
def test_a_halo_has_the_same_abel_sums_alone_and_in_its_batch():
    """The kernel's summation order is fixed per row: a cluster's g has
    the same bits in a batch of 256, of 64 and alone."""
    _card()
    args = dict(chip_smoke.abel_path_cases(P, V, E))["datagen_dm"]
    whole = abel_g_rows(*args)
    for sl in (slice(0, 64), slice(100, 101), slice(255, 256)):
        assert torch.equal(whole[sl], abel_g_rows(*(t[sl] for t in args)))


def _datagen_density(n):
    prog = E._datagen_full_batch_fn(512, 1, 0, 1)
    M, c = E.sample_ensemble_params(
        torch.Generator(device="cuda").manual_seed(13), n)
    f = prog.models(M, c)
    return (-torch.flip(f["gravitational_potential"], (-1,)),
            torch.flip(f["dark_matter_density"], (-1,)))


@pytest.mark.cuda
def test_compute_df_through_the_kernel_against_the_plain_sums(monkeypatch):
    """f(E) of a 256-cluster batch within 1e-10 of each row's largest |f|
    of the DF built on the plain sums, and the gradient through
    ``compute_df`` (the kernel inside an autograd function) within 1e-9
    of the plain version's."""
    _card()
    ee, pden = _datagen_density(256)
    with C.eager():
        got = V.compute_df(ee, pden)
    gen = torch.Generator("cuda").manual_seed(1)
    w = torch.rand(pden.shape, generator=gen, dtype=torch.float64,
                   device="cuda")

    def grad():
        p = pden.clone().requires_grad_()
        (V.compute_df(ee, p) * w).sum().backward()
        return p.grad

    before = abel_g_rows.launches
    g_kernel = grad()
    torch.cuda.synchronize()
    assert abel_g_rows.launches == before + 1
    monkeypatch.setattr(V, "abel_g_rows", abel_g_rows_plain)
    with C.eager():
        want = V.compute_df(ee, pden)
    g_plain = grad()
    assert chip_smoke.abel_row_err(got, want) <= 1e-10
    scale = float(g_plain.abs().max())
    assert float((g_kernel - g_plain).abs().max()) <= 1e-9 * scale


@pytest.mark.cuda
def test_compute_df_replays_equal_its_eager_body():
    """``compute_df`` as a program: the capture call and two replays with
    new densities, each equal to the eager body bit for bit, the kernel
    one graph node counted once a replay."""
    _card()
    ee, pden = _datagen_density(32)
    C.clear()
    for k in range(3):
        p = pden * (1.0 + 0.1 * k)
        before = abel_g_rows.launches
        out = V.compute_df(ee, p)
        torch.cuda.synchronize()
        assert abel_g_rows.launches == before + 1
        with C.eager():
            assert torch.equal(out, V.compute_df(ee, p)), k
    prog = [q for q in C.programs() if q.nodes.get(abel_g_rows)]
    assert len(prog) == 1 and prog[0].nodes[abel_g_rows] == 1


@pytest.mark.cuda
def test_abel_wrapper_refuses_float32_and_mixed_devices():
    _card()
    x, b, c, d, ee = chip_smoke.abel_edge_cases(torch.device("cuda"))[0][1]
    before = abel_g_rows.launches
    with pytest.raises(TypeError, match="float64"):
        abel_g_rows(x, b.float(), c, d, ee)
    with pytest.raises(ValueError, match="is on cpu"):
        abel_g_rows(x, b, c, d, ee.cpu())
    with pytest.raises(ValueError, match="coefficients"):
        abel_g_rows(x, b[..., :-1], c, d, ee)
    assert abel_g_rows.launches == before


@pytest.mark.cuda
def test_main_path_launches_k1_and_stays_finite():
    _card()
    before = invert_cdf_rows.launches
    before_cdf = speed_cdf_rows_f32.launches
    before_abel = abel_g_rows.launches
    parts, _ = P.merger_ic_fused(
        [1.5e15, 1.0e15], [4.0, 5.0], [[-1500.0, 0, 0], [1500.0, 0, 0]],
        [[0.3, 0, 0], [-0.45, 0, 0]], 5000.0, (30_000, 20_000),
        (24_000, 16_000), (6_000, 4_000),
        generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    assert invert_cdf_rows.launches == before + 2  # DM and stars
    assert speed_cdf_rows_f32.launches == before_cdf + 2
    assert abel_g_rows.launches == before_abel + 2
    for v in parts.values():
        assert v.is_cuda and bool(torch.isfinite(v).all())


@pytest.mark.cuda
def test_datagen_batch_launches_k1_twice_and_stays_finite():
    _card()
    gen = torch.Generator("cuda").manual_seed(3)
    M200, conc = E.sample_ensemble_params(gen, 64)
    before = invert_cdf_rows.launches
    before_cdf = speed_cdf_rows_f32.launches
    before_abel = abel_g_rows.launches
    (b0, out), = E.datagen_batches(
        M200, conc, {"dm": 5000, "gas": 4000, "star": 1000}, batch_size=64,
        seed=3)
    torch.cuda.synchronize()
    assert b0 == 0 and invert_cdf_rows.launches == before + 2
    assert speed_cdf_rows_f32.launches == before_cdf + 2
    assert abel_g_rows.launches == before_abel + 2
    assert out["dm"][1].shape == (64, 5000, 3) and out["dm"][1].is_cuda
    assert sum(E.nonfinite_counts(out).values()) == 0


def _same_bits(a, b):
    """Two tensor trees with the same leaves, dtypes and bits (-0.0 and
    NaN included)."""
    la, lb = C._leaves(a), C._leaves(b)

    def bits(t):
        return t.contiguous().view(torch.int32 if t.element_size() == 4
                                   else torch.int64)

    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(bits(x), bits(y)) for x, y in zip(la, lb))


_DRAWS = {"collisionless": (D.draw_collisionless, D.draw_collisionless_plain),
          "gas": (D.draw_gas, D.draw_gas_plain)}


def _check_draw_case(name, kind, args, r_a):
    """One launch, the plain version's bits, the same bits on a second
    launch."""
    wrap, plain = _DRAWS[kind]
    extra = (r_a,) if kind == "collisionless" else ()
    before = wrap.launches
    got = wrap(*args, *extra)
    torch.cuda.synchronize()
    assert wrap.launches == before + 1, name
    assert all(t.is_cuda for t in got), name
    assert _same_bits(got, plain(*args, *extra)), name
    assert _same_bits(got, wrap(*args, *extra)), name


@pytest.mark.cuda
def test_draw_kernel_is_bit_identical_at_the_path_shapes():
    """The datagen draws as the program calls them on the card: cfg5c's
    batch of 256 (DM 5e4 on a 2048 x 512 joint table, stars 1e4 on
    512 x 256, gas 4e4 on 2048 nodes and a 512-point grid), the batch of
    64 at 1e6 a cluster, and the Osipkov-Merritt DM batch of 256: the
    plain version's bits on each."""
    _card()
    cases = chip_smoke.draw_path_cases(E)
    shapes = {(name, tuple(a[0][0].shape), a[1].shape[-1], a[3].shape[-1])
              for name, _, a, _ in cases}
    assert {("datagen_dm", (256, 50_000), 2048, 512),
            ("datagen_star", (256, 10_000), 512, 256),
            ("datagen_gas", (256, 40_000), 2048, 512),
            ("datagen_b64_dm", (64, 500_000), 2048, 512),
            ("datagen_b64_star", (64, 100_000), 512, 256),
            ("datagen_b64_gas", (64, 400_000), 2048, 512),
            ("datagen_om_dm", (256, 50_000), 2048, 512)} <= shapes
    for case in cases:
        _check_draw_case(*case)


@pytest.mark.cuda
def test_draw_kernel_at_the_edge_uniforms():
    """Uniforms at 0 and one ulp below 1 and cos_theta at -1, counts no
    multiple of a block and under one, one cluster, the fewest nodes, many
    blocks a cluster; each collisionless case also Osipkov-Merritt; the
    plain version's bits on each."""
    _card()
    for case in chip_smoke.draw_edge_cases(torch.device("cuda")):
        _check_draw_case(*case)


@pytest.mark.cuda
@pytest.mark.parametrize("full", [True, False], ids=["full", "dm_only"])
def test_datagen_batches_keep_the_torch_chains_bits(full, monkeypatch):
    """cfg5c's program at B = 32 (512 points; DM 2048 radius nodes and a
    512-quantile joint table, stars 512 and 256, gas 2048): eager, at the
    capture and replayed, each batch equals bit for bit the batch drawn by
    the torch chain (the plain versions patched in); a full-species call
    launches the draw kernel three times (dm and stars, then gas), the
    DM-only program (``_datagen_batch_fn``) once."""
    _card()
    dev = "cuda"
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    M, c = E.sample_ensemble_params(gen(9), 96)
    counts = (5000, 4000, 1000) if full else (5000, 0, 0)
    prog = E._datagen_full_batch_fn(512, *counts)
    call = prog if full else E._datagen_batch_fn(512, counts[0])

    def eager(k):
        sl = slice(32 * k, 32 * k + 32)
        out = prog.run(M[sl], c[sl], None, prog.uniforms(32, gen(k), dev))
        return out if full else out["dm"]

    monkeypatch.setattr(E, "draw_collisionless", D.draw_collisionless_plain)
    monkeypatch.setattr(E, "draw_gas", D.draw_gas_plain)
    want = [eager(k) for k in range(3)]
    monkeypatch.undo()
    C.clear()
    n_c, n_g = (2, 1) if full else (1, 0)
    for k in range(3):
        sl = slice(32 * k, 32 * k + 32)
        before = (D.draw_collisionless.launches, D.draw_gas.launches)
        out = call(M[sl], c[sl], gen(k))
        torch.cuda.synchronize()
        assert (D.draw_collisionless.launches - before[0],
                D.draw_gas.launches - before[1]) == (n_c, n_g), k
        assert _same_bits(out, want[k]), k
        assert _same_bits(eager(k), want[k]), k
    nodes = C.programs()[-1].nodes
    assert (nodes.get(D.draw_collisionless), nodes.get(D.draw_gas, 0)) == \
        (n_c, n_g)
    C.clear()


@pytest.mark.cuda
def test_draw_wrappers_refuse_float64_mixed_devices_and_non_contiguous():
    _card()
    cases = chip_smoke.draw_edge_cases(torch.device("cuda"))
    u, r_q, v_esc, joint = cases[0][2]
    g = cases[2][2]
    before = (D.draw_collisionless.launches, D.draw_gas.launches)
    with pytest.raises(TypeError, match="float32"):
        D.draw_collisionless(u, r_q, v_esc.double(), joint)
    with pytest.raises(TypeError, match="float32"):
        D.draw_gas(g[0], g[1], g[2], g[3].double())
    with pytest.raises(ValueError, match="is on cpu"):
        D.draw_collisionless(u, r_q, v_esc, joint.cpu())
    with pytest.raises(ValueError, match="is on cpu"):
        D.draw_gas((g[0][0], (g[0][1][0].cpu(), g[0][1][1])), g[1], g[2],
                   g[3])
    with pytest.raises(ValueError, match="contiguous"):
        D.draw_collisionless((u[0].t().contiguous().t(),) + u[1:], r_q,
                             v_esc, joint)
    with pytest.raises(ValueError, match="contiguous"):
        D.draw_gas(g[0], g[1], g[2].t().contiguous().t(), g[3])
    assert (D.draw_collisionless.launches, D.draw_gas.launches) == before


@pytest.mark.cuda
def test_class_path_on_the_card_against_the_cpu():
    """The single-cluster class path at a small size: every tensor on the
    card, one K1 launch per species and model, and model fields, DFs,
    speed table and draws (from the same uniforms) equal to the CPU's
    within the bounds of the smoke run."""
    import cluster_generator_tpu_torch as cg

    _card()
    # floats in, no device named: the solvers answer on the card
    r500, m500 = cg.find_radius_mass(cg.snfw_mass_profile(1.7e15, 560.0),
                                     500.0, z=0.1)
    assert r500.is_cuda and m500.is_cuda and r500.ndim == 0
    assert cg.mass_within(cg.snfw_density_profile(1.7e15, 560.0),
                          1300.0).is_cuda
    before = invert_cdf_rows.launches
    models = {dev: chip_smoke.build_class_model(cg, device=dev,
                                                num_points=256)
              for dev in ("cuda", "cpu")}
    m, c = models["cuda"], models["cpu"]
    for k in c.keys():
        assert m[k].is_cuda and m[k].dtype == torch.float64
        torch.testing.assert_close(m[k].cpu(), c[k], rtol=1e-11,
                                   atol=1e-12 * float(c[k].abs().max()))
    for vm, vc in ((m.dm_virial, c.dm_virial), (m.star_virial,
                                                c.star_virial)):
        assert vm.df.is_cuda
        torch.testing.assert_close(vm.df.cpu(), vc.df, rtol=1e-6,
                                   atol=1e-9 * float(vc.df.abs().max()))
    n = 20_000
    gen = torch.Generator().manual_seed(9)

    def u(dtype=torch.float64):
        return torch.rand(n, generator=gen, dtype=dtype)

    unif = (u(), (u() * 2 - 1, u()), (u(torch.float32), u(torch.float32)),
            (u() * 2 - 1, u()))

    def to(tree, dev):
        if isinstance(tree, tuple):
            return tuple(to(x, dev) for x in tree)
        return tree.to(dev)

    p_gpu = m.generate_dm_particles(n, r_max=5000.0, compute_potential=True,
                                    uniforms=to(unif, "cuda"))
    held = m.dm_virial._draw_tables
    m.generate_dm_particles(n, r_max=5000.0, prng=1)   # cached tables
    assert m.dm_virial._draw_tables is held
    m.generate_star_particles(n, r_max=5000.0, prng=2)
    torch.cuda.synchronize()
    assert invert_cdf_rows.launches == before + 2
    p_cpu = c.generate_dm_particles(n, r_max=5000.0, compute_potential=True,
                                    uniforms=unif)
    diff = (m.dm_virial._speed_table()[1].cpu()
            - c.dm_virial._speed_table()[1]).abs()
    assert float(diff.max()) < 2e-5 and int((diff > 5e-6).sum()) <= 4
    for key, want in p_cpu.fields.items():
        got = p_gpu[key]
        assert got.is_cuda and got.dtype == torch.float64
        if key[1] == "particle_velocity":
            sa, sb = want.norm(dim=1), got.cpu().norm(dim=1)
            rel = (sa - sb).abs() / sa.clamp_min(1e-30)
            assert float((rel > 1e-4).double().mean()) <= 1e-4
        else:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-9,
                                       atol=1e-9 * float(want.abs().max()))
    parts = p_gpu + m.generate_gas_particles(n, r_max=5000.0, prng=3)
    parts.add_offsets([10.0, 0.0, 0.0], [0.0, 0.1, 0.0])
    assert parts.device.type == "cuda"
    assert all(v.is_cuda for v in parts.fields.values())


@pytest.mark.cuda
def test_fields_on_the_card_against_the_cpu():
    """Float64 fields from the same noise on the card and on the CPU: the
    constant-rms vector potential at an odd z size and a two-halo radial
    field; cuFFT and the CPU's FFT agree to roundoff."""
    from cluster_generator_tpu_torch import fields as F

    _card()
    r = torch.logspace(0, 4, 200, dtype=torch.float64)
    g = 1e-6 * (1.0 + r / 300.0) ** -1.5
    cases = {
        "vector_potential": (dict(B_rms=1e-6), F.RandomMagneticVectorPotential,
                             (24, 24, 21)),
        "radial": (dict(ctr1=[-200.0] * 3, profile1=(r, g), ctr2=[300.0] * 3,
                        profile2=(r, 2 * g)), F.RadialRandomMagneticField,
                   (24, 24, 24)),
    }
    for name, (kw, cls, dims) in cases.items():
        shape = tuple(d + 2 * int(np.ceil(0.05 * d)) for d in dims)
        noise = torch.randn((3,) + shape, dtype=torch.float64,
                            generator=torch.Generator().manual_seed(1))
        a = cls([-1000.0] * 3, [1000.0] * 3, dims, 100.0, 800.0,
                noise=noise.cuda(), device="cuda", **kw)
        b = cls([-1000.0] * 3, [1000.0] * 3, dims, 100.0, 800.0,
                noise=noise, device="cpu", **kw)
        for ga, gb in ((a.gx, b.gx), (a.gy, b.gy), (a.gz, b.gz)):
            assert ga.is_cuda and ga.dtype == torch.float64
            err = float((ga.cpu() - gb).abs().max() / gb.abs().max())
            assert err < 1e-10, (name, err)


@pytest.mark.cuda
def test_scene_batch_on_the_card_against_the_cpu():
    """Two scenes with the same uniforms on both devices: one K1 launch
    per species, every output finite, draws within float32 roundoff (a
    speed may move one joint-table row where u and w tie)."""
    from cluster_generator_tpu_torch.parallel import mergers as MG

    _card()
    p = MG.sample_merger_scene_params(torch.Generator().manual_seed(4), 2,
                                      device="cpu")
    ctr, vel = MG.binary_scene_geometry(p["M200"], p["d"], p["b"],
                                        p["v_rel"])
    ng, nd, ns = (3000, 2000), (2500, 2500), (600, 400)
    gen = torch.Generator().manual_seed(5)

    def u(n):
        return torch.rand((2, n), generator=gen, dtype=torch.float32)

    unif = {}
    for i in range(2):
        unif["gas", i] = (u(ng[i]), (u(ng[i]) * 2 - 1, u(ng[i])))
        for kind, n in (("dm", nd[i]), ("star", ns[i])):
            unif[kind, i] = (u(n), u(n), u(n), (u(n) * 2 - 1, u(n)),
                             (u(n) * 2 - 1, u(n)))

    def to(tree, dev):
        if isinstance(tree, tuple):
            return tuple(to(x, dev) for x in tree)
        return tree.to(dev)

    out = {}
    for dev in ("cuda", "cpu"):
        fn = MG._merger_batch_fn(256, ng, nd, ns, device=dev)
        before = invert_cdf_rows.launches
        out[dev] = fn(p["M200"], p["conc"], ctr, vel, [5000.0, 5000.0],
                      uniforms={k: to(v, dev) for k, v in unif.items()})
        launched = invert_cdf_rows.launches - before
        assert launched == (2 if dev == "cuda" else 0)
    for k, a in out["cpu"].items():
        b = out["cuda"][k].cpu()
        assert b.shape == a.shape and bool(torch.isfinite(b).all()), k
        a, b = a.double(), b.double()
        if k.endswith("_velocity") and not k.startswith("gas"):
            bulk = torch.cat([torch.as_tensor(vel[:, i, None, :]).expand(
                -1, (nd if k.startswith("dm") else ns)[i], -1)
                for i in range(2)], dim=1)
            sa, sb = (a - bulk).norm(dim=-1), (b - bulk).norm(dim=-1)
            assert int(((sa - sb).abs() > 1e-4 * sa).sum()) <= 2, k
        elif k == "gas_velocity":
            assert float((a - b).abs().max()) < 2e-5 * float(
                np.abs(vel).max()), k
        elif a.ndim == 3:
            rel = (a - b).norm(dim=-1) / a.norm(dim=-1)
            assert float(rel.max()) < 2e-5, k
        else:
            assert float(((a - b).abs() / a.abs()).max()) < 2e-5, k


@pytest.mark.cuda
def test_ic_scene_on_the_card_against_the_cpu():
    """The same particles, drawn on the CPU, through combine_two_clusters
    and resample_two_clusters on the card and on the CPU: every field
    within 1e-12 of its largest CPU value."""
    import cluster_generator_tpu_torch as cg
    from cluster_generator_tpu_torch import ics as I
    from cluster_generator_tpu_torch import particles as PA

    _card()
    errs = chip_smoke.ic_device_agreement(
        cg, I, PA, counts={"dm": 3000, "gas": 5000, "star": 1000,
                           "tracer": 500})
    assert len(errs) >= 20
    assert all(v < chip_smoke.IC_CPU_RTOL for v in errs.values()), errs


# ------------------------------------------------- the captured programs
def _equal(a, b):
    la, lb = C._leaves(a), C._leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["merger", "datagen", "scenes"])
def test_capture_and_replays_equal_the_eager_body(program):
    """First call (eager warm-up, capture) and two replays with new inputs
    and seeds, each equal to the eager body bit for bit; K1, the
    speed-CDF kernel and the Abel kernel counted twice per call each, from
    the graph's two nodes of each on a replay."""
    _card()
    dev = "cuda"
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    if program == "merger":
        def graph(k):
            return P.merger_ic_fused(
                [1.5e15 * (1 + 0.2 * k), 1.0e15], [4.0, 5.0 - 0.3 * k],
                [[-1500.0, 0, 0], [1500.0, 0, 0]],
                [[0.3, 0, 0], [-0.45, 0, 0]], 5000.0 - 100 * k,
                (30_000, 20_000), (24_000, 16_000), (6_000, 4_000),
                generator=gen(k))

        def eager(k):
            t = lambda v: torch.tensor(v, dtype=torch.float64,  # noqa: E731
                                       device=dev)
            u = P.merger_uniforms(gen(k), (), (30_000, 20_000),
                                   (24_000, 16_000), (6_000, 4_000))
            return P._merger_ic(
                t([1.5e15 * (1 + 0.2 * k), 1.0e15]), t([4.0, 5.0 - 0.3 * k]),
                t([[-1500.0, 0, 0], [1500.0, 0, 0]]),
                t([[0.3, 0, 0], [-0.45, 0, 0]]),
                t([5000.0 - 100 * k] * 2), t(0.1), u,
                n_gas=(30_000, 20_000), n_dm=(24_000, 16_000),
                n_star=(6_000, 4_000), n_tracer=None, num_points=1000,
                dtype=torch.float32,
                compute_potential=False, r_a=None, gravity="newtonian")
    elif program == "datagen":
        M, c = E.sample_ensemble_params(gen(5), 96)
        prog = E._datagen_full_batch_fn(512, 5000, 4000, 1000)

        def graph(k):
            return prog(M[32 * k:32 * k + 32], c[32 * k:32 * k + 32], gen(k))

        def eager(k):
            return prog.run(M[32 * k:32 * k + 32], c[32 * k:32 * k + 32],
                            None, prog.uniforms(32, gen(k), dev))
    else:
        p = MG.sample_merger_scene_params(gen(6), 24)
        M, c, ctr, vel = MG._scene_inputs(p, torch.device(dev))
        fn = MG._merger_batch_fn(512, (2000, 2000), (2500, 2500), (500, 500))
        r_max = torch.full((2,), 5000.0, dtype=torch.float64, device=dev)

        def graph(k):
            sl = slice(8 * k, 8 * k + 8)
            return fn(M[sl], c[sl], ctr[sl], vel[sl], r_max, gen(k))

        def eager(k):
            sl = slice(8 * k, 8 * k + 8)
            return fn.run(M[sl], c[sl], ctr[sl], vel[sl], r_max, None,
                          fn.uniforms(8, gen(k), dev))
    held = None
    for k in range(3):
        before = invert_cdf_rows.launches
        before_cdf = speed_cdf_rows_f32.launches
        before_abel = abel_g_rows.launches
        out = graph(k)
        torch.cuda.synchronize()
        assert invert_cdf_rows.launches == before + 2
        assert speed_cdf_rows_f32.launches == before_cdf + 2
        assert abel_g_rows.launches == before_abel + 2
        if k == 1:
            held, snap = out, C.tree_map(torch.clone, out)
        assert _equal(out, eager(k)), k
    prog_ = C.programs()[-1]
    assert prog_.graph is not None
    want_nodes = {invert_cdf_rows: 2, speed_cdf_rows_f32: 2, abel_g_rows: 2}
    if program == "datagen":  # the draw kernel: dm and stars, then gas
        want_nodes.update({D.draw_collisionless: 2, D.draw_gas: 1})
    assert prog_.nodes == want_nodes
    assert _equal(held, snap)


@pytest.mark.cuda
def test_batches_held_while_the_next_replays():
    """``datagen_batches`` enqueues batch k+1 before it yields batch k:
    every batch held equals its eager body after the later ones ran."""
    _card()
    dev = "cuda"
    M, c = E.sample_ensemble_params(
        torch.Generator(device=dev).manual_seed(3), 80)
    prog = E._datagen_full_batch_fn(512, 5000, 4000, 1000)
    outs = list(E.datagen_batches(M, c, {"dm": 5000, "gas": 4000,
                                          "star": 1000}, batch_size=32,
                                   seed=3))
    for b0, out in outs:
        sl = slice(b0, b0 + 32)
        want = prog.run(M[sl], c[sl], E._batch_generator(3, b0, M.device))
        assert _equal(out, want), b0


@pytest.mark.cuda
def test_field_painter_and_workspace_programs_equal_their_eager_bodies():
    """The field programs (constant rms, radial, trilinear sampling), a
    painter batch and an in-place workspace program: the first call
    (capture) and two replays with seeds, points or chunks of their own,
    each equal to its eager body bit for bit; an in-place buffer is handed
    back as itself."""
    from cluster_generator_tpu_torch import data_structures as DS
    from cluster_generator_tpu_torch import fields as F
    from cluster_generator_tpu_torch.core.interp import cubic_spline

    _card()
    dev = "cuda"
    C.clear()
    r = torch.logspace(0, 4, 200, dtype=torch.float64, device=dev)
    g = 1e-6 * (1.0 + r / 300.0) ** -1.5
    sp = cubic_spline(r, g)
    starts = torch.as_tensor(DS.construct_chunks([32] * 3, 8)[:, 0, :].T,
                             dtype=torch.float64, device=dev)
    step = torch.full((3,), 100.0, dtype=torch.float64, device=dev)
    box = [-1000.0] * 3, [1000.0] * 3

    def comps(f):
        return f.gx, f.gy, f.gz

    cases = {
        "constant": lambda k: comps(F.RandomMagneticVectorPotential(
            *box, (40, 40, 38), 100.0, 800.0, 1e-6, prng=k, device=dev,
            dtype=torch.float32)),
        "radial": lambda k: comps(F.RadialRandomMagneticField(
            *box, (32,) * 3, 100.0, 800.0, [-200.0 * k] * 3, (r, g),
            ctr2=[300.0] * 3, profile2=(r, 2 * g), prng=k, device=dev)),
        "trilinear": lambda k: F.grf._trilinear(
            *(torch.linspace(-900.0, 900.0, 32, dtype=torch.float64,
                             device=dev),) * 3,
            torch.ones((3, 32, 32, 32), dtype=torch.float64, device=dev),
            torch.rand((5000, 3), dtype=torch.float64, device=dev,
                       generator=torch.Generator(dev).manual_seed(k))
            * 2000.0 - 1000.0),
        "paint": lambda k: DS._paint_batch(sp, starts[8 * k:8 * k + 8],
                                           step, -step * 16, 8),
    }
    for name, fn in cases.items():
        for k in range(3):
            got = fn(k)
            with C.eager():
                want = fn(k)
            assert _equal(got, want), (name, k)
    assert all(p.graph is not None for p in C.programs())
    ws = C.workspace("cuda_ws_test", 8, dev,
                     lambda: torch.zeros(8, device=dev))
    buf = ws.buffers

    def body(buf, x, uniforms):
        buf.add_(x)
        return buf, x * 2

    for k in range(3):
        out, twice = ws.run(("cuda_inplace_test",), body,
                            (buf, torch.full((8,), float(k), device=dev)),
                            inplace=1)
        assert out is buf and torch.equal(twice,
                                          torch.full_like(buf, 2.0 * k))
    torch.cuda.synchronize()
    assert torch.equal(buf, torch.full_like(buf, 3.0))
    C.clear()


@pytest.mark.cuda
def test_a_program_that_does_not_fit_releases_another():
    """Under a memory fraction that holds one of two programs, the second
    program's first call releases the first (least recently used) and
    the first's next call releases the second; each call equals its eager
    body bit for bit."""
    _card()
    C.clear()
    dev = torch.device("cuda", torch.cuda.current_device())
    size = 1 << 30                       # bytes of each program's input
    gen = torch.Generator(dev).manual_seed(0)
    x = {"a": torch.randn((size // 4096, 1024), device=dev, generator=gen),
         "b": torch.randn((size // 8192, 2048), device=dev, generator=gen)}

    def body(x, uniforms):
        y = x * 2.0                      # a peak of twice the input
        return (y + 1.0).sum(0)

    def call(name):
        return C.run(("cuda_room_test_" + name,), body, (x[name],))

    with C.eager():
        want = {k: call(k) for k in x}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # room for the inputs and one program (static copy and pool: 3 sizes)
    # and the other's first call's copy, not for its warm-up too
    cap = torch.cuda.memory_reserved(dev) + 4.5 * size
    total = torch.cuda.get_device_properties(dev).total_memory
    try:
        torch.cuda.set_per_process_memory_fraction(cap / total, dev)
        # (name, programs it releases): a capture, a replay, b's capture
        # releases a, b's replay, a's capture releases b
        for name, released in (("a", 0), ("a", 0), ("b", 1), ("b", 0),
                               ("a", 1)):
            before = C.releases
            got = call(name)
            torch.cuda.synchronize()
            assert torch.equal(got, want[name]), name
            assert C.releases - before == released, name
            assert [h.what.key[0][0] for h in C.held(dev)] == [
                "cuda_room_test_" + name], name
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        C.clear()


@pytest.mark.cuda
def test_clear_leaves_no_more_memory_after_each_capture_again():
    """A program with a GEMM (the scene batch's joint fold) captured,
    replayed and cleared three times: the memory allocated after each
    ``clear`` is what it was after the first, and does not grow by a
    cuBLAS workspace for a new side stream each time."""
    _card()
    C.clear()
    dev = "cuda"
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    M, c, ctr, vel = MG._scene_inputs(
        MG.sample_merger_scene_params(gen(6), 4), torch.device(dev))
    prog = MG._merger_batch_fn(256, (500, 500), (600, 600), (100, 100))
    r_max = torch.full((2,), 5000.0, dtype=torch.float64, device=dev)
    left = []
    for k in range(3):
        prog(M, c, ctr, vel, r_max, gen(k))      # captures
        prog(M, c, ctr, vel, r_max, gen(k + 3))  # replays
        C.clear()
        left.append(torch.cuda.memory_allocated(dev))
    assert left[1] == left[0] and left[2] == left[0], left


@pytest.mark.cuda
def test_an_eager_join_releases_a_workspace_that_leaves_no_room():
    """Under a memory fraction that leaves beside a held workspace less
    room than a join of two particle containers needs, the package's
    eager ``ClusterParticles.__add__`` releases the workspace first and
    equals the same join on a clean card bit for bit."""
    from cluster_generator_tpu_torch.particles import ClusterParticles

    _card()
    C.clear()
    dev = torch.device("cuda", torch.cuda.current_device())
    n = 1 << 24                          # particles of each container
    gen = torch.Generator(dev).manual_seed(1)

    def container():
        return ClusterParticles(["dm"], {
            ("dm", "particle_position"): torch.rand(
                (n, 3), device=dev, dtype=torch.float64, generator=gen),
            ("dm", "particle_velocity"): torch.randn(
                (n, 3), device=dev, dtype=torch.float64, generator=gen),
            ("dm", "particle_mass"): torch.rand(
                n, device=dev, dtype=torch.float64, generator=gen)})

    a, b = container(), container()
    want = {k: v.cpu() for k, v in (a + b).fields.items()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    size = 2 << 30                       # the workspace's bytes
    C.workspace("cuda_eager_room_test", 0, dev, lambda: torch.empty(
        size, dtype=torch.uint8, device=dev), nbytes=size)
    # the join needs 112 n bytes (1.75 GiB); 1 GiB is left beside the
    # workspace
    cap = torch.cuda.memory_reserved(dev) + (1 << 30)
    total = torch.cuda.get_device_properties(dev).total_memory
    try:
        torch.cuda.set_per_process_memory_fraction(cap / total, dev)
        before = C.releases
        got = a + b
        torch.cuda.synchronize()
        assert C.releases - before == 1 and C.workspaces() == []
        assert list(got.fields) == list(want)
        assert all(torch.equal(got[k].cpu(), v) for k, v in want.items())
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        C.clear()


# every reckonable eager site of the package (PERF.md section 3): its
# inputs, handed out by a program, and its run, as tensors or arrays
def _eager_site_cases():
    from cluster_generator_tpu_torch import codes as CO
    from cluster_generator_tpu_torch import particles as PA
    from cluster_generator_tpu_torch.fields import grf as G
    from cluster_generator_tpu_torch.parallel import export as EX

    def container(parts, ptypes=("gas", "dm")):
        return PA.ClusterParticles(list(ptypes), {
            k: v for k, v in parts.items() if k[0] in ptypes})

    def fields_of(p):
        return list(p.fields.values())

    def field(parts, dtype):
        """A field over the particles' box, made before the run is
        measured (it is not the site's allocation)."""
        dev = parts["gas", "particle_position"].device
        f = G.ClusterField([0.0] * 3, [100.0] * 3, (256,) * 3, padding=0.0,
                           dtype=dtype, device=dev)
        f.x, f.y, f.z = (torch.linspace(0.0, 100.0, 256, dtype=dtype,
                                        device=dev),) * 3
        f.gx, f.gy, f.gz = (parts["grid"][i].to(dtype) for i in range(3))
        return f

    fields = {}

    def field_of(parts, dtype):
        if dtype not in fields:
            fields[dtype] = field(parts, dtype)
        return fields[dtype]

    def amr(parts, tmp):
        out = tmp / "dm.dat"
        CO.write_amr_particles(container(parts, ("dm", "star")), out,
                               ["dm", "star"], {"dm": 1, "star": 2},
                               in_cgs=True, format="fortran")
        return [np.fromfile(out, dtype=np.uint8)]

    def plan(parts):
        n_files, total, mine = EX._export_plan(
            {k: v for k, v in parts.items() if k != "grid"}, 200.0,
            center_offset=[100.0] * 3)
        return [torch.as_tensor(total.astype(np.int64))] + fields_of(
            mine[0][1])

    def blocks(parts):
        b, _, _ = container(parts).gadget_blocks(200.0)
        return [a for arrays in b.values() for a in arrays.values()]

    def moved(parts):
        p = container(parts)
        p.add_offsets([100.0] * 3, [0.5, 0.0, 0.0])
        return fields_of(p)

    def cut(parts):
        p = container(parts)
        p.make_radial_cut(40.0, center=[50.0] * 3)
        return fields_of(p)

    def units(parts):
        p = container(parts)
        p.set_field("dm", "metallicity", parts["dm", "particle_mass"],
                    units="Msun")
        return fields_of(p)

    def mapped(parts):
        p = container(parts)
        field_of(parts, torch.float64).map_field_to_particles(p)
        return fields_of(p)

    def attached(parts):
        f = field_of(parts, torch.float32)
        out = P.attach_field_to_particles(
            {k: v for k, v in parts.items() if k[0] == "gas"}, f)
        return [out["gas", f._name]]

    return {"add": lambda parts, tmp: fields_of(
                container(parts) + container(parts, ("dm", "star"))),
            "conversions": lambda parts, tmp: fields_of(container(parts)),
            "add_offsets": lambda parts, tmp: moved(parts),
            "make_radial_cut": lambda parts, tmp: cut(parts),
            "set_field_units": lambda parts, tmp: units(parts),
            "gadget_blocks": lambda parts, tmp: blocks(parts),
            "arepo_background": lambda parts, tmp: list(
                CO._arepo_background([[50.0] * 3], [30.0], 100.0, 192,
                                     container(parts, ("gas",))).values()),
            "amr_fortran": amr,
            "attach_field": lambda parts, tmp: attached(parts),
            "map_field": lambda parts, tmp: mapped(parts),
            "export_plan": lambda parts, tmp: plan(parts)}


EAGER_SITES = ("add", "conversions", "add_offsets", "make_radial_cut",
               "set_field_units", "gadget_blocks", "arepo_background",
               "amr_fortran", "attach_field", "map_field", "export_plan")


def _site_inputs(x, grid, uniforms):
    """A program's outputs for the eager sites: float32 particle fields in
    a box of 100 kpc and a (3, 256, 256, 256) field."""
    parts = {}
    for k, pt in enumerate(("gas", "dm", "star")):
        parts[pt, "particle_position"] = x[k] * 100.0
        parts[pt, "particle_velocity"] = x[k] - 0.5
        parts[pt, "particle_mass"] = x[k, :, 0] * 1e9
    for name in ("density", "thermal_energy"):
        parts["gas", name] = x[0, :, 1] + 1.0
    parts["grid"] = grid * 2.0
    return parts


@pytest.mark.cuda
@pytest.mark.parametrize("site", EAGER_SITES)
def test_an_eager_site_after_a_release_equals_its_run_with_room(site,
                                                                tmp_path):
    """Each eager site, its inputs handed out by a program, under a memory
    fraction that leaves beside that program and a held workspace less
    room than the site needs: it releases them (the program first, as
    least recently used) and equals its run with room to spare bit for
    bit, its inputs intact."""
    _card()
    C.clear()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(dev).manual_seed(2)
    x = torch.rand((3, 1 << 22, 3), device=dev, generator=gen)
    grid = torch.randn((3, 256, 256, 256), device=dev, generator=gen)
    parts = C.run(("cuda_eager_site_inputs",), _site_inputs, (x, grid))
    del x, grid
    before = {k: v.clone() for k, v in parts.items()}
    run = _eager_site_cases()[site]

    def host(outs):
        return [o.cpu() if isinstance(o, torch.Tensor) else o for o in outs]

    want = host(run(parts, tmp_path))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    size = 4 << 30
    C.workspace("cuda_eager_site_test", 0, dev, lambda: torch.empty(
        size, dtype=torch.uint8, device=dev), nbytes=size)
    cap = torch.cuda.memory_reserved(dev) + (32 << 20)
    total = torch.cuda.get_device_properties(dev).total_memory
    try:
        torch.cuda.set_per_process_memory_fraction(cap / total, dev)
        released = C.releases
        got = host(run(parts, tmp_path))
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    assert C.releases > released, site
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), site
        else:
            assert np.array_equal(g, w), site
    assert all(torch.equal(parts[k], v) for k, v in before.items())
    C.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["merger", "datagen", "scenes"])
def test_a_replay_marks_its_stages_in_order(program, monkeypatch):
    """One replay under the profiler's device activity: the stage marks
    the capture recorded, in the body's order; the stages hold at least
    85% of the call's device work other than the copies to the host; the
    outputs equal the eager body's run with no marks, bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    from cluster_generator_tpu_torch.core import profiling
    from portbench.yardstick import stages as S
    from portbench.yardstick import trace as T

    _card()
    dev = "cuda"
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    if program == "merger":
        args = ([1.5e15, 1.0e15], [4.0, 5.0],
                [[-1500.0, 0, 0], [1500.0, 0, 0]],
                [[0.3, 0, 0], [-0.45, 0, 0]], 5000.0, (30_000, 20_000),
                (24_000, 16_000), (6_000, 4_000))

        def call(k):
            return P.merger_ic_fused(*args, generator=gen(k))
    elif program == "datagen":
        M, c = E.sample_ensemble_params(gen(5), 32)
        prog = E._datagen_full_batch_fn(512, 5000, 4000, 1000)

        def call(k):
            return prog(M, c, gen(k))
    else:
        M, c, ctr, vel = MG._scene_inputs(
            MG.sample_merger_scene_params(gen(6), 8), torch.device(dev))
        prog = MG._merger_batch_fn(512, (2000, 2000), (2500, 2500),
                                   (500, 500))
        r_max = torch.full((2,), 5000.0, dtype=torch.float64, device=dev)

        def call(k):
            return prog(M, c, ctr, vel, r_max, gen(k))
    call(0)
    call(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = call(2)
        torch.cuda.synchronize()
    ev = [e for e in T.events_of(prof) if e.kind in T.DEVICE_KINDS]
    window = T.extent(ev)
    assert [s for _, s in S.marks(ev, window)] == [
        "models", "dfs", "models", "dfs", "models", "end", "tables", "end",
        "draws", "end"]
    stages = S.stage_us(ev, window)
    assert set(stages) == {"models", "dfs", "tables", "draws"}
    assert all(n == 1 for _, n in stages.values())
    work = T.busy_us([e for e in ev if S.stage_of(e.name) is None and not (
        e.kind == "gpu_memcpy" and "DtoH" in e.name)], window)
    assert 0.85 * work <= sum(us for us, _ in stages.values()) <= work
    monkeypatch.setattr(profiling, "_mark", lambda name, device: None)
    with C.eager():
        want = call(2)
    assert _equal(got, want)


def _matrix_brackets(grid, queries):
    """The comparison-matrix bracket: count the nodes at or below each
    query."""
    j = torch.sum(grid[..., None, :] <= queries[..., :, None], dim=-1) - 1
    return torch.clamp(j, 0, grid.shape[-1] - 2)


@pytest.mark.cuda
def test_searched_brackets_leave_the_datagen_tables_bit_for_bit(monkeypatch):
    """cfg5c's table shapes (512-point models; DM 128 speed rows and 2048
    radius nodes, stars 64 and 512, gas 2048) at B = 4: the draw tables,
    eager, at the capture and replayed, equal bit for bit those built on
    the comparison-matrix brackets; a replay's tables stage launches no
    int64 reduction, which the matrix brackets' replay does (their count
    of ``grid <= q``)."""
    from torch.profiler import ProfilerActivity, profile

    from cluster_generator_tpu_torch.core import interp as I
    from cluster_generator_tpu_torch.core.profiling import device_stage
    from portbench.yardstick import stages as S
    from portbench.yardstick import trace as T

    _card()
    dev = "cuda"
    prog = E._DatagenProgram(512, 5000, 4000, 1000)
    M, c = E.sample_ensemble_params(
        torch.Generator(device=dev).manual_seed(7), 12)

    def body(M200, conc, _):
        with device_stage("models", M200):
            f = prog.models(M200, conc)
            dfs = prog.dfs(f)
        with device_stage("tables", M200):
            tabs = prog.draw_tables(f, prog.speed_tables(f, dfs))
        return {sp: {k: t[k] for k in ("r_q", "v_esc", "joint") if k in t}
                for sp, t in tabs.items()}

    def eager(k):
        with C.inline():
            return body(M[4 * k:4 * k + 4], c[4 * k:4 * k + 4], None)

    def calls(key):
        """Three calls of the program of ``key`` (a capture, then two
        replays, the last under the profiler): their outputs, and the
        names of the kernels in the last one's tables stage."""
        outs = [C.run(key, body, (M[4 * k:4 * k + 4], c[4 * k:4 * k + 4]))
                for k in range(2)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            outs.append(C.run(key, body, (M[8:], c[8:])))
            torch.cuda.synchronize()
        ev = [e for e in T.events_of(prof) if e.kind in T.DEVICE_KINDS]
        (_, _, a, b), = [s for s in S.stretches(ev, T.extent(ev))
                         if s[1] == "tables"]
        return outs, [e.name for e in ev
                      if e.kind == "kernel" and a <= e.start_us < b]

    monkeypatch.setattr(I, "bracket_indices", _matrix_brackets)
    monkeypatch.setattr(V, "bracket_indices", _matrix_brackets)
    want = [eager(k) for k in range(3)]
    outs, names = calls(("brackets", "matrix"))
    assert all(_equal(o, w) for o, w in zip(outs, want))
    assert any("ReduceOp<long" in n for n in names)
    monkeypatch.undo()
    assert sorted(want[0]) == ["dm", "gas", "star"]
    assert set(want[0]["dm"]) == {"r_q", "v_esc", "joint"}
    for k in range(3):
        assert _equal(eager(k), want[k]), k
    outs, names = calls(("brackets", "search"))
    for k in range(3):
        assert _equal(outs[k], want[k]), k
    assert names and not any("ReduceOp<long" in n for n in names)
    C.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["B", "A"])
def test_a_field_program_replays_its_eager_body_with_its_marks(kind,
                                                               monkeypatch):
    """The cell ``field-512``'s two programs at a small float64 grid: the
    capture and two replays, each with a seed of its own, equal their
    eager bodies bit for bit; a replay under the profiler's device activity
    runs the marks noise, fft, kspace, fft, end, of which the host launches
    only the noise draw's (the rest are the graph's nodes); the stages hold
    at least 85% of the call's device work other than its output copy."""
    from torch.profiler import ProfilerActivity, profile

    from cluster_generator_tpu_torch import fields as F
    from cluster_generator_tpu_torch.core import profiling
    from portbench.yardstick import stages as S
    from portbench.yardstick import trace as T

    _card()
    dev = "cuda"
    cls = {"B": F.RandomMagneticField,
           "A": F.RandomMagneticVectorPotential}[kind]
    C.clear()

    def call(k):
        f = cls([-1000.0] * 3, [1000.0] * 3, (128, 112, 96), 50.0, 500.0,
                1e-6, padding=0.0,
                prng=torch.Generator(device=dev).manual_seed(k), device=dev)
        return f.gx, f.gy, f.gz

    got = [call(k) for k in range(2)]
    torch.cuda.synchronize()
    launched = []
    mark = profiling._mark
    monkeypatch.setattr(profiling, "_mark", lambda name, device: (
        launched.append(name), mark(name, device)))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got.append(call(2))
        torch.cuda.synchronize()
    monkeypatch.undo()
    assert launched == ["noise"]
    ev = [e for e in T.events_of(prof) if e.kind in T.DEVICE_KINDS]
    window = T.extent(ev)
    assert [s for _, s in S.marks(ev, window)] == [
        "noise", "fft", "kspace", "fft", "end"]
    stages = S.stage_us(ev, window)
    assert set(stages) == {"noise", "fft", "kspace"}
    work = T.busy_us([e for e in ev if S.stage_of(e.name) is None and not (
        e.kind == "gpu_memcpy" and "DtoH" in e.name)], window)
    assert 0.85 * work <= sum(us for us, _ in stages.values()) <= work
    assert all(p.graph is not None for p in C.programs())
    for k in range(3):
        with C.eager():
            want = call(k)
        assert _equal(got[k], want), k
    C.clear()


@pytest.mark.cuda
def test_the_references_noise_redraw_on_the_card_is_the_programs_draw():
    """The cell's reference redraws a call's normals on the card from the
    call's seed (``portbench/reference/field.py``): the same numbers as the
    program's draw into its buffer, at the cell's own 512^3 grid."""
    import json

    from cluster_generator_tpu_torch.fields import grf
    from portbench.reference import field as R

    _card()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs",
                           "bfield-512.json")) as f:
        cfg = json.load(f)
    dims, _ = R.grid(cfg)
    for seed in (0, 2**62 + 3):
        draw = grf._noise_drawer(
            None, torch.Generator(device="cuda").manual_seed(seed), dims,
            torch.float64, "cuda", spectra=True)
        got = grf._head(draw(None), dims)
        assert torch.equal(got, R.noise(cfg, seed, "cuda")), seed
        del draw, got
    torch.cuda.empty_cache()
