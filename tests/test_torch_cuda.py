"""The port's CUDA kernels on the card (marker ``cuda``).

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
from cluster_generator_tpu_torch.ops.cdf_inverse import (
    invert_cdf_rows,
    invert_cdf_rows_plain,
)
from cluster_generator_tpu_torch.parallel import ensemble as E

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


@pytest.mark.cuda
def test_datagen_batch_launches_k1_twice_and_stays_finite():
    _card()
    gen = torch.Generator("cuda").manual_seed(3)
    M200, conc = E.sample_ensemble_params(gen, 64)
    before = invert_cdf_rows.launches
    (b0, out), = E.datagen_batches(
        M200, conc, {"dm": 5000, "gas": 4000, "star": 1000}, batch_size=64,
        seed=3)
    torch.cuda.synchronize()
    assert b0 == 0 and invert_cdf_rows.launches == before + 2
    assert out["dm"][1].shape == (64, 5000, 3) and out["dm"][1].is_cuda
    assert sum(E.nonfinite_counts(out).values()) == 0


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
