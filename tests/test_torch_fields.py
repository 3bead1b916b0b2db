"""The port's random fields against the JAX package's, on the CPU.

Both packages get the same white noise: the port takes
``jax.random.normal(jax.random.key(prng), (3, nx, ny, nz), dtype)`` as its
``noise=``, which is exactly the JAX package's draw for ``prng``.
Tolerances:

* float64: max |port - JAX| <= 1e-10 of max |JAX| per component (the same
  arithmetic; only the FFT differs, half spectra against full ones);
* float32: <= 1e-4 of max |JAX|, the JAX tests' own bound between their
  two float32 routes.  The port's vector potential is held to the JAX
  package's full-spectrum route: its half-spectrum route keeps the
  non-Hermitian Nyquist part of i k x g~, which the real part of a full
  inverse transform (and the port) drops;
* trilinear sampling: 1e-12 (float64) and 1e-5 (float32) of max |g|: a
  float32 position near 1000 kpc locates its cell weight to ~3e-6;
* files: coordinates equal, field values within 1e-10 of max |JAX|.

The physics checks of tests/test_fields.py then run on the port's own
``torch.Generator`` draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cluster_generator_tpu as jcg
import cluster_generator_tpu.fields.grf as JG
import cluster_generator_tpu.pipeline as JPL
import cluster_generator_tpu_torch as tcg
import cluster_generator_tpu_torch.fields.grf as TG
from cluster_generator_tpu_torch import pipeline as TP
from cluster_generator_tpu_torch.convert import cluster_model_from_numpy

torch.set_num_threads(1)

LE, RE, DD = [0.0] * 3, [1000.0] * 3, [48, 48, 48]
CPU = dict(device="cpu")


def _noise(prng, shape, jdtype):
    """The JAX package's white noise for ``prng``, as a writable array."""
    return np.array(jax.random.normal(jax.random.key(prng), (3,) + shape,
                                      jdtype))


def _max_rel(j, t):
    """Largest component difference over the largest |JAX| value."""
    out = 0.0
    for c in "xyz":
        a = np.asarray(getattr(j, f"g{c}"), np.float64)
        b = getattr(t, f"g{c}").numpy().astype(np.float64)
        assert b.shape == a.shape
        out = max(out, np.abs(a - b).max() / np.abs(a).max())
    return out


CONSTANT = {"magnetic": ("RandomMagneticField", 1.0e-6),
            "vector_potential": ("RandomMagneticVectorPotential", 1.0e-6),
            "velocity": ("RandomVelocityField", 100.0)}


def _pair(kind, dims, dtype, **jkw):
    cls, amp = CONSTANT[kind]
    jd, td = ((jnp.float64, torch.float64) if dtype == "f64"
              else (jnp.float32, torch.float32))
    j = getattr(JG, cls)(LE, RE, dims, 50.0, 500.0, amp, prng=11, dtype=jd,
                         **jkw)
    t = getattr(TG, cls)(LE, RE, dims, 50.0, 500.0, amp, dtype=td,
                         noise=_noise(11, tuple(int(n) for n in j.ddims), jd),
                         **CPU)
    return j, t


@pytest.mark.parametrize("dims", [(48, 48, 48), (16, 16, 14)])
@pytest.mark.parametrize("kind", sorted(CONSTANT))
def test_constant_rms_float64_matches_jax(kind, dims):
    j, t = _pair(kind, dims, "f64")
    assert t.gx.dtype == torch.float64 and tuple(t.ddims) == tuple(j.ddims)
    assert _max_rel(j, t) <= 1e-10


@pytest.mark.parametrize("dims", [(32, 32, 32), (16, 16, 14)])
@pytest.mark.parametrize("kind", sorted(CONSTANT))
def test_constant_rms_float32_matches_jax(kind, dims):
    # the JAX half-spectrum route for B and v; its full-spectrum route for
    # the vector potential (see the module docstring)
    jkw = ({} if kind == "velocity"
           else {"use_rfft": kind != "vector_potential"})
    j, t = _pair(kind, dims, "f32", **jkw)
    assert t.gx.dtype == torch.float32
    assert _max_rel(j, t) <= 1e-4


@pytest.fixture(scope="module")
def models(canonical_model):
    """The canonical JAX model, and a second halo with twice its field,
    carried into the port; both with a stand-in velocity dispersion."""
    fields = {k: np.asarray(v) for k, v in canonical_model.fields.items()}
    fields["velocity_dispersion"] = np.sqrt(fields["pressure"]
                                            / fields["density"])
    twice = {k: 2.0 * v if k in ("magnetic_field_strength",
                                 "velocity_dispersion") else v
             for k, v in fields.items()}
    return ((canonical_model, None),
            (cluster_model_from_numpy(fields, **CPU),
             cluster_model_from_numpy(twice, **CPU)), twice)


@pytest.mark.parametrize("cls", ["RadialRandomMagneticField",
                                 "RadialRandomMagneticVectorPotential",
                                 "RadialRandomVelocityField"])
def test_radial_two_halos_matches_jax(models, cls):
    (jm, _), (tm1, tm2), twice = models
    rr = np.asarray(twice["radius"])
    prof_field = getattr(JG, cls)._profile_field
    j2 = (rr, np.asarray(twice[prof_field]))
    if prof_field not in jm.fields:
        # the JAX model has no velocity dispersion: the tuple form
        jm = (rr, np.asarray(tm1[prof_field]))
    kw = dict(padding=0.1, ctr2=[700.0, 400.0, 600.0], r_max=800.0, prng=23)
    j = getattr(JG, cls)(LE, RE, [24, 24, 24], 50.0, 500.0,
                         [300.0, 500.0, 450.0], jm, profile2=j2, **kw)
    kw.pop("prng")
    t = getattr(TG, cls)(LE, RE, [24, 24, 24], 50.0, 500.0,
                         [300.0, 500.0, 450.0], tm1, profile2=tm2,
                         noise=_noise(23, tuple(int(n) for n in j.ddims),
                                      jnp.float64), **kw, **CPU)
    assert _max_rel(j, t) <= 1e-10


def _points(n, dtype, seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-60.0, 1060.0, (n, 3))
    # exactly on the first and the last cell centre, and just outside
    c0, c1 = 1000.0 / 48 * 0.5, 1000.0 - 1000.0 / 48 * 0.5
    pts[:4] = [[c1, c1, c1], [c0, c0, c0], [c1, 500.0, c0],
               [c1 + 1e-3, 500.0, 500.0]]
    return pts.astype(dtype)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
def test_trilinear_matches_jax(dtype, tol):
    """Both packages' trilinear sampling of one field at the same points,
    with points outside the grid and on its last coordinate."""
    j, t = _pair("magnetic", tuple(DD), "f64")
    g = np.stack([np.asarray(j.gx), np.asarray(j.gy),
                  np.asarray(j.gz)]).astype(dtype)
    xyz = [np.asarray(c, dtype) for c in (j.x, j.y, j.z)]
    pts = _points(3000, dtype)
    want = np.asarray(JG._trilinear(*(jnp.asarray(c) for c in xyz),
                                    jnp.asarray(g), jnp.asarray(pts)))
    got = TG._trilinear(*(torch.from_numpy(c) for c in xyz),
                        torch.from_numpy(g), torch.from_numpy(pts)).numpy()
    assert got.shape == (3, 3000) and got.dtype == dtype
    assert np.abs(got - want).max() <= tol * np.abs(g).max()
    outside = ((pts < xyz[0][0]) | (pts > xyz[0][-1])).any(axis=1)
    assert outside.any() and not got[:, outside].any()
    assert got[:, :3].all()  # the last (and first) centres are inside


def test_attach_field_to_particles_matches_jax():
    j, t = _pair("magnetic", tuple(DD), "f64")
    pts = _points(2000, np.float32, seed=1)
    jparts = JPL.attach_field_to_particles(
        {("gas", "particle_position"): jnp.asarray(pts)}, j)
    tparts = TP.attach_field_to_particles(
        {("gas", "particle_position"): torch.from_numpy(pts)}, t)
    want = np.asarray(jparts["gas", "magnetic_field"])
    got = tparts["gas", "magnetic_field"].numpy()
    assert got.shape == (2000, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _particle_pair(n=500, seed=2):
    pts = _points(n, np.float64, seed=seed)
    fields = {("gas", "particle_position"): pts,
              ("gas", "particle_velocity"): np.zeros_like(pts),
              ("gas", "particle_mass"): np.ones(n)}
    return (jcg.ClusterParticles("gas", dict(fields)),
            tcg.ClusterParticles("gas", dict(fields), **CPU))


@pytest.mark.parametrize("units", [None, "uG"])
def test_map_field_to_particles_matches_jax(units):
    j, t = _pair("magnetic", tuple(DD), "f64")
    jp, tp = _particle_pair()
    j.map_field_to_particles(jp, ptype="gas", units=units)
    t.map_field_to_particles(tp, ptype="gas", units=units)
    want = np.asarray(jp["gas", "magnetic_field"])
    got = tp["gas", "magnetic_field"].numpy()
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    with pytest.raises(ValueError, match="not convertible"):
        t.map_field_to_particles(tp, ptype="gas", units="kpc/Myr")
    with pytest.raises(KeyError):
        t.map_field_to_particles(tp, ptype="gas", units="furlongs")


@pytest.mark.parametrize("kw", [{}, {"field_unit": "uG",
                                     "length_unit": "Mpc"}])
def test_write_file_matches_jax(tmp_path, kw):
    import h5py
    from scipy.io import FortranFile

    j, t = _pair("magnetic", (16, 16, 16), "f64")
    names = ["x", "y", "z"] + t.comps
    for fmt in ("hdf5", "fortran"):
        fj, ft = (str(tmp_path / f"{who}.{fmt}") for who in ("j", "t"))
        j.write_file(fj, format=fmt, **kw)
        t.write_file(ft, format=fmt, **kw)
        with pytest.raises(IOError):
            t.write_file(ft, format=fmt)
        if fmt == "hdf5":
            with h5py.File(fj, "r") as a, h5py.File(ft, "r") as b:
                assert dict(a.attrs) == dict(b.attrs)
                pairs = [(a[n][()], b[n][()], a[n].attrs["units"],
                          b[n].attrs["units"]) for n in names]
        else:
            with FortranFile(fj, "r") as a, FortranFile(ft, "r") as b:
                assert a.read_ints()[0] == b.read_ints()[0] == j.ddims[0]
                pairs = [(a.read_reals(), b.read_reals(), "", "")
                         for _ in names]
        for (va, vb, ua, ub), n in zip(pairs, names):
            assert ua == ub and va.shape == vb.shape and va.dtype == vb.dtype
            if n in "xyz":
                np.testing.assert_array_equal(vb, va)
            else:
                assert np.abs(va - vb).max() <= 1e-10 * np.abs(va).max()


# ---------------------------------------------------------------- physics
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-5)])
def test_rms_scaling(dtype, rtol):
    f = TG.RandomMagneticField(LE, RE, DD, 50.0, 500.0, 1.0e-6, prng=11,
                               dtype=dtype, **CPU)
    g2 = sum((getattr(f, f"g{c}").double() ** 2).mean() for c in "xyz")
    assert float(g2.sqrt()) == pytest.approx(1.0e-6, rel=rtol)


@pytest.mark.parametrize("dims", [(48, 48, 48), (16, 16, 14)])
def test_divergence_free(dims):
    """Central-difference divergence (the operator the sin(k d)/d
    projection nulls) vanishes to roundoff, for even and odd sizes."""
    f = TG.RandomMagneticField(LE, RE, dims, 50.0, 500.0, 1.0e-6, prng=3,
                               **CPU)
    gx, gy, gz = f.gx, f.gy, f.gz
    div = ((torch.roll(gx, -1, 0) - torch.roll(gx, 1, 0)) / (2 * f.dx)
           + (torch.roll(gy, -1, 1) - torch.roll(gy, 1, 1)) / (2 * f.dy)
           + (torch.roll(gz, -1, 2) - torch.roll(gz, 1, 2)) / (2 * f.dz))
    scale = float(gx.abs().mean()) / f.dx
    assert float(div.abs().max()) / scale < 1e-10


@pytest.mark.parametrize("padding", [0.0, 0.1, 0.25])
def test_padding_and_grid(padding):
    f = TG.RandomVelocityField(LE, RE, DD, 50.0, 500.0, 100.0,
                               padding=padding, prng=3, **CPU)
    pad = 2 * np.ceil(0.5 * padding * np.array(DD))
    assert (f.ddims == np.array(DD) + pad).all()
    assert f["x"].numel() == f.ddims[0] and f["velocity_x"].shape == tuple(
        f.ddims)
    if padding:
        assert f.left_edge[0] < 0.0 and f.right_edge[0] > 1000.0


def test_vector_potential_curl_recovers_field():
    """Spectral curl of A equals the continuous-k projection of B on every
    non-Nyquist mode (tests/test_fields.py's identity)."""
    kw = dict(prng=5, **CPU)
    B = TG.RandomMagneticField(LE, RE, DD, 100.0, 500.0, 1.0e-6, **kw)
    A = TG.RandomMagneticVectorPotential(LE, RE, DD, 100.0, 500.0, 1.0e-6,
                                         **kw)
    assert A.units == "gauss*kpc"
    kx, ky, kz = A._compute_waves()
    ah = [np.fft.fftn(getattr(A, f"g{c}").numpy()) for c in "xyz"]
    bh = [np.fft.fftn(getattr(B, f"g{c}").numpy()) for c in "xyz"]
    curl = [1j * (ky * ah[2] - kz * ah[1]), 1j * (kz * ah[0] - kx * ah[2]),
            1j * (kx * ah[1] - ky * ah[0])]
    curl = [np.fft.fftn(np.fft.ifftn(c).real) for c in curl]
    k2 = kx**2 + ky**2 + kz**2
    kb = (kx * bh[0] + ky * bh[1] + kz * bh[2]) / np.where(k2 > 0, k2, 1.0)
    n = B.ddims
    mask = np.ones(tuple(n), bool)
    mask[n[0] // 2], mask[:, n[1] // 2], mask[:, :, n[2] // 2] = (False,) * 3
    scale = np.abs(bh[0][mask]).max()
    for c, b, k in zip(curl, bh, (kx, ky, kz)):
        assert np.abs(c[mask] - (b - k * kb)[mask]).max() / scale < 1e-8
    rms = np.sqrt((B.gx.numpy() ** 2).mean())
    assert np.sqrt(((np.fft.ifftn(curl[0]).real - B.gx.numpy()) ** 2)
                   .mean()) / rms < 0.1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_spectrum_slope(dtype):
    """The power spectrum follows k^alpha between k1 and k0."""
    f = TG.RandomVelocityField([0] * 3, [1000.0] * 3, [64] * 3, 31.25,
                               1000.0, 1.0, padding=0.0, prng=17, dtype=dtype,
                               **CPU)
    W = np.abs(np.fft.fftn(f["velocity_x"].numpy().astype(np.float64))) ** 2
    kx, ky, kz = f._compute_waves()
    kk = np.sqrt(kx**2 + ky**2 + kz**2)
    k1, k0 = 2 * np.pi / 1000.0, 2 * np.pi / 31.25
    sel = (kk > 4 * k1) & (kk < k0 / 4)
    slope = np.polyfit(np.log(kk[sel]), np.log(W[sel]), 1)[0]
    assert -4.5 < slope < -3.0, slope


def test_halo_slots_bind_by_position():
    """A partly given halo slot raises; a fully given later slot counts."""
    rr = np.linspace(1.0, 800.0, 64)
    gg = 1e-6 * np.exp(-rr / 300.0)
    base = (LE, RE, [16] * 3, 50.0, 500.0)
    with pytest.raises(ValueError, match="partially specified"):
        TG.GaussianRandomField(*base, ctr1=[500.0] * 3, g1=gg, prng=1, **CPU)
    with pytest.raises(ValueError, match="halo 2"):
        TG.GaussianRandomField(*base, ctr1=[500.0] * 3, r1=rr, g1=gg,
                               ctr2=[200.0] * 3, g2=gg, prng=1, **CPU)
    with pytest.raises(RuntimeError, match="ctr2"):
        TG.GaussianRandomField(*base, r1=rr, g1=gg, r2=rr, g2=gg, prng=1,
                               **CPU)
    f2 = TG.GaussianRandomField(*base, ctr1=[300.0] * 3, r1=rr, g1=gg,
                                ctr2=[700.0] * 3, r2=rr, g2=gg, prng=5, **CPU)
    f1 = TG.GaussianRandomField(*base, ctr1=[300.0] * 3, r1=rr, g1=gg,
                                prng=5, **CPU)
    assert not torch.allclose(f2["vector_x"], f1["vector_x"])
    TG.GaussianRandomField(*base, ctr1=[300.0] * 3, r1=rr, g1=gg,
                           r_max=(0.4, "Mpc"), prng=5, **CPU)
    with pytest.raises(ValueError, match="noise has shape"):
        TG.RandomMagneticField(*base, 1e-6, noise=np.zeros((3, 8, 8, 8)),
                               **CPU)


def test_tuple_unit_inputs(models):
    """(value, unit) tuples convert for amplitudes and halo centres."""
    kw = dict(prng=7, **CPU)
    f1 = TG.RandomMagneticField(LE, RE, [16] * 3, 50.0, 500.0, (5.0, "uG"),
                                **kw)
    f2 = TG.RandomMagneticField(LE, RE, [16] * 3, 50.0, 500.0, 5.0e-6, **kw)
    np.testing.assert_allclose(f1.gx.numpy(), f2.gx.numpy(), rtol=1e-12,
                               atol=1e-20)
    tm = models[1][0]
    rb = (tm["radius"], tm["magnetic_field_strength"])
    g1 = TG.RadialRandomMagneticField(LE, RE, [16] * 3, 50.0, 500.0,
                                      ((0.5, 0.5, 0.5), "Mpc"), rb, **kw)
    g2 = TG.RadialRandomMagneticField(LE, RE, [16] * 3, 50.0, 500.0,
                                      [500.0] * 3, rb, **kw)
    np.testing.assert_allclose(g1.gx.numpy(), g2.gx.numpy(), rtol=1e-12,
                               atol=1e-20)
    assert TG.parse_value((2.0, "Mpc"), "kpc") == pytest.approx(2000.0)


def test_fields_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.RandomMagneticField(LE, RE, [8] * 3, 50.0, 500.0, 1e-6, prng=1)
