"""The random fields, the grid painter, the mesh batch forms and the sharded
field builder as captured programs (``core/compiled``), on the CPU at a
small size.

* Each program's body against the JAX package's jitted function on the
  same numpy-seeded inputs, at tests/test_torch_fields.py's tolerances:
  the constant-rms field (``_constant_rms_field``) against
  ``_grf_core_fused`` given its white noise, float64 within 1e-10 of the
  largest |JAX| value and float32 within 1e-4 (the full-spectrum complex64
  route); the radial field (``_radial_field``) against the JAX class's
  route of ``_grf_core``, ``_div_clean_k`` and ``_vector_potential_k``,
  1e-10; the trilinear sampling 1e-12 (float64) and 1e-5 (float32) of
  max |g|; the painter (``_paint_program``) against ``_paint_chunk`` on
  the JAX spline's coefficients, 1e-12 of the largest value (f8) and
  float32 rounding (f4); the sharded builder's three stages, with the
  transposes done by hand for one and two ranks, against JAX's
  ``sharded_gaussian_random_field`` given its noise, 1e-10.
* Every body under ``_NoHostReads`` (tests/test_torch_draw_programs.py):
  no read of a tensor's value on the host, which a capture refuses.
* The memo, from the keys of the calls (tests/test_torch_class_programs.py
  records them): a new ``g_rms``, ``l_min``, centre, ``r_max`` or profile
  value replays a program, a new shape, dtype, switch, halo count,
  profile length, ``r_max is None``, particle count, ``cs``, ``f32`` or
  chunk count makes one; the grid's ragged last batch is a second program.
* The noise and the uniforms drawn in the eager order; the constant-rms
  route's transforms in place in the noise's buffer, in slabs of any size.
* A workspace: its programs take its buffers in place, and another key
  drops it with its programs.
* On gloo worlds of one and two CPU processes: ``_mesh_call``'s rows equal
  the unsharded batch's rows and run as the program at the rank's row
  count; the sharded merger draw runs ``sample_merger_ic``'s program at
  the shard's counts; the sharded builder makes its three programs once,
  replays them for another ``g_rms``, ``l_min`` or box, equals its eager
  run bit for bit, and on another grid drops its workspace and
  programs.

Capture and replay need the card: ``chip_smoke.py`` phase 24 holds every
program against its eager body there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cluster_generator_tpu.fields.grf as JG
from cluster_generator_tpu import data_structures as JD
from cluster_generator_tpu.core.interp import cubic_spline as j_spline
from cluster_generator_tpu.parallel.fields import (
    sharded_gaussian_random_field as j_sharded_grf,
)
import cluster_generator_tpu_torch.fields.grf as TG
import cluster_generator_tpu_torch.parallel.fields as TF
from cluster_generator_tpu_torch import data_structures as TD
from cluster_generator_tpu_torch.core import compiled as C
from cluster_generator_tpu_torch.core.interp import CubicSpline
from tests.test_torch_class_programs import _fresh_memo  # noqa: F401
from tests.test_torch_class_programs import CALLS
from tests.test_torch_draw_programs import _guarded_bodies, _NoHostReads
from tests.test_torch_fields import _noise, _points
from tests.test_torch_parallel_fft import finish_world, start_world

torch.set_num_threads(1)

LE, RE = [0.0] * 3, [1000.0] * 3
CPU = {"device": "cpu"}
F64, F32 = torch.float64, torch.float32


def _max_rel(want, got):
    """Largest difference over the largest |want|, over components."""
    return max(np.abs(np.asarray(w, np.float64)
                      - np.asarray(g, np.float64)).max()
               / np.abs(np.asarray(w)).max() for w, g in zip(want, got))


def _keys(name):
    """The distinct memo keys of the recorded calls of ``name``."""
    return {memo for memo, _, _ in CALLS if memo[0][0] == name}


# ------------------------------------------------ the constant-rms field
def _grid(dims):
    f = TG.ClusterField(LE, RE, dims, padding=0.0, **CPU)
    return f.deltas, f._compute_waves()


@pytest.mark.parametrize("dtype,dims,tol", [
    ("f64", (16, 16, 14), 1e-10), ("f64", (24, 24, 24), 1e-10),
    ("f32", (16, 16, 14), 1e-4)])
@pytest.mark.parametrize("div_clean,vec_pot", [(True, False), (True, True),
                                               (False, False),
                                               (False, True)])
def test_constant_rms_program_matches_jax(dtype, dims, tol, div_clean,
                                          vec_pot):
    jd, td = (jnp.float64, F64) if dtype == "f64" else (jnp.float32, F32)
    deltas, (kx, ky, kz) = _grid(dims)
    k0, k1, alpha, g_rms = 2 * np.pi / 60.0, 2 * np.pi / 400.0, -11 / 3, 3.0
    kd = [jnp.asarray(np.sin(k * d) / d, jd) for k, d in zip((kx, ky, kz),
                                                             deltas)]
    want = JG._grf_core_fused(jax.random.key(5), dims, jnp.asarray(kx),
                              jnp.asarray(ky), jnp.asarray(kz), *kd, k0, k1,
                              alpha, g_rms, div_clean, vec_pot, jd)
    noise = _noise(5, dims, jd)
    with _guarded_bodies() as called:
        got = TG._constant_rms_field(
            torch.from_numpy(TG._wave_vector((kx, ky, kz), deltas)), k0, k1,
            alpha, g_rms, shape=dims, dtype=td, div_clean=div_clean,
            vec_pot=vec_pot,
            noise=TG._noise_drawer(noise, None, dims, td, "cpu",
                                   spectra=True))
    assert called == ["_constant_rms_field"]
    assert all(g.dtype == td and tuple(g.shape) == dims for g in got)
    assert _max_rel(want, [g.numpy() for g in got]) <= tol


# ----------------------------------------------------- the radial field
RR = np.linspace(1.0, 900.0, 80)
GG = 1e-6 * np.exp(-RR / 300.0)


def _radial(pk, halos, r_max, div_clean, vec_pot, dims=(16, 16, 16),
            profile=(RR, GG), **kw):
    slots = {}
    for i, ctr in enumerate(halos, 1):
        slots.update({f"ctr{i}": ctr, f"r{i}": profile[0],
                      f"g{i}": profile[1] * i})
    return pk.GaussianRandomField(LE, RE, dims, 50.0, 500.0, r_max=r_max,
                                  divergence_clean=div_clean,
                                  vector_potential=vec_pot, **slots, **kw)


@pytest.mark.parametrize("halos,r_max,div_clean,vec_pot", [
    ([[500.0] * 3], None, True, False),
    ([[300.0, 500.0, 450.0], [700.0, 400.0, 600.0]], 800.0, True, True),
    ([[300.0, 500.0, 450.0], [700.0, 400.0, 600.0]], 800.0, False, False),
    ([[400.0] * 3, [600.0] * 3, [500.0, 300.0, 700.0]], None, False, True)])
def test_radial_program_matches_jax(halos, r_max, div_clean, vec_pot):
    j = _radial(JG, halos, r_max, div_clean, vec_pot, prng=23)
    with _guarded_bodies() as called:
        t = _radial(TG, halos, r_max, div_clean, vec_pot,
                    noise=_noise(23, tuple(int(n) for n in j.ddims),
                                 jnp.float64), **CPU)
    assert called == ["_radial_field"]
    assert _max_rel([j.gx, j.gy, j.gz],
                    [t.gx.numpy(), t.gy.numpy(), t.gz.numpy()]) <= 1e-10


# ------------------------------------------- the trilinear sampling
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
def test_trilinear_program_matches_jax(dtype, tol):
    rng = np.random.default_rng(3)
    g = rng.standard_normal((3, 48, 48, 48)).astype(dtype)
    xyz = [np.linspace(1000.0 / 96, 1000.0 - 1000.0 / 96, 48).astype(dtype)
           for _ in range(3)]
    pts = _points(1500, dtype, seed=4)
    want = np.asarray(JG._trilinear(*map(jnp.asarray, xyz), jnp.asarray(g),
                                    jnp.asarray(pts)))
    with _guarded_bodies() as called:
        got = TG._trilinear(*map(torch.from_numpy, xyz), torch.from_numpy(g),
                            torch.from_numpy(pts))
    assert called == ["_trilinear"]
    assert got.dtype == torch.from_numpy(g).dtype
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(g).max()


# ------------------------------------------------------- the painter
def _splines():
    """One spline in both packages: the JAX package's coefficients, so
    that both painters evaluate the same polynomial."""
    rr = np.geomspace(1.0, 3000.0, 120)
    sp = j_spline(jnp.asarray(rr), jnp.asarray(1e-26 * (1 + rr / 200) ** -3))
    return sp, CubicSpline(*(torch.from_numpy(np.array(a)) for a in sp))


@pytest.mark.parametrize("f32", [False, True])
def test_painter_program_matches_jax(f32):
    """4 chunks of 8^3 over a box whose corners lie beyond the spline."""
    jsp, tsp = _splines()
    cs, box = 8, np.array([[-2500.0, 2500.0]] * 3)
    deltas = (box[:, 1] - box[:, 0]) / 16
    starts = TD.construct_chunks((16, 16, 16), cs)[:, 0, :].T[[0, 3, 5, 7]]
    starts = starts.astype(np.float64)
    want = np.stack([np.asarray(JD._paint_chunk(
        jsp, jnp.asarray(s), jnp.asarray(deltas), jnp.asarray(box[:, 0]),
        cs)) for s in starts])
    with _guarded_bodies() as called:
        got = TD._paint_batch(tsp, starts, deltas, box[:, 0], cs,
                              f32=f32).numpy()
    assert called == ["_paint_program"]
    assert got.shape == (4, cs, cs, cs)
    if f32:
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-6)
    else:
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


# ------------------------------------------- the in-place transforms
@pytest.mark.parametrize("shape", [(12, 10, 9), (8, 6, 10)])
def test_in_place_transforms_over_many_slabs(monkeypatch, shape):
    """The constant-rms route's transforms in place in the noise's buffer,
    in slabs and chunks of one row up to one slab, equal ``rfftn`` and give
    the noise back; the field is the same in any slabs."""
    noise = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3,) + shape))
    f = TG.ClusterField(LE, RE, shape, padding=0.0, **CPU)
    waves = torch.from_numpy(TG._wave_vector(f._compute_waves(), f.deltas))
    fields = []
    for slab in (1, 7, 1 << 24):
        monkeypatch.setattr(TG, "_SLAB", slab)
        draw = TG._noise_drawer(noise, None, shape, F64, "cpu", spectra=True)
        buf = draw(None)
        spec = TG._rfftn_in_place(buf, shape)
        assert max(float((s - torch.fft.rfftn(n)).abs().max())
                   for s, n in zip(spec, noise)) <= 1e-12
        back = TG._irfftn_in_place(buf, shape)
        assert all(b.data_ptr() == h.data_ptr()
                   for b, h in zip(back, TG._head(buf, shape)))
        assert max(float((b - n).abs().max())
                   for b, n in zip(back, noise)) <= 1e-14
        fields.append(TG._constant_rms_field(
            waves, 0.1, 0.01, -11 / 3, 2.0, shape=shape, dtype=F64,
            div_clean=True, vec_pot=True, noise=draw))
    scale = max(float(g.abs().max()) for g in fields[-1])
    for other in fields[:-1]:
        assert max(float((a - b).abs().max())
                   for a, b in zip(other, fields[-1])) <= 1e-13 * scale


# --------------------------------------------------------------- the memo
def test_constant_field_statics_make_programs_floats_replay():
    base = dict(padding=0.0, prng=1, **CPU)
    TG.RandomMagneticField(LE, RE, [16] * 3, 50.0, 500.0, 1e-6, **base)
    TG.RandomMagneticField(LE, RE, [16] * 3, 40.0, 700.0, 3e-6,
                           alpha=-3.0, **dict(base, prng=2))
    assert len(_keys("_constant_rms_field")) == 1
    TG.RandomMagneticField(LE, RE, [16] * 3, 50.0, 500.0, 1e-6,
                           **dict(base, dtype=F32))
    TG.RandomMagneticVectorPotential(LE, RE, [16] * 3, 50.0, 500.0, 1e-6,
                                     **base)
    TG.RandomVelocityField(LE, RE, [16] * 3, 50.0, 500.0, 1.0, **base)
    TG.RandomMagneticField(LE, RE, [16, 16, 14], 50.0, 500.0, 1e-6, **base)
    assert len(_keys("_constant_rms_field")) == 5


def test_radial_field_statics_make_programs_floats_replay():
    two = [[300.0] * 3, [700.0] * 3]
    _radial(TG, two, 800.0, True, False, prng=1, **CPU)
    _radial(TG, [[350.0] * 3, [650.0, 700.0, 600.0]], 700.0, True, False,
            profile=(RR * 1.1, GG * 2), prng=2, **CPU)
    assert len(_keys("_radial_field")) == 1
    _radial(TG, two[:1], 800.0, True, False, prng=1, **CPU)
    _radial(TG, two, None, True, False, prng=1, **CPU)
    _radial(TG, two, 800.0, True, False, profile=(RR[:60], GG[:60]), prng=1,
            **CPU)
    _radial(TG, two, 800.0, True, True, prng=1, **CPU)
    assert len(_keys("_radial_field")) == 5


def test_trilinear_and_painter_statics_make_programs():
    g = torch.zeros((3, 8, 8, 8), dtype=F64)
    x = torch.linspace(0.0, 70.0, 8, dtype=F64)
    for n, scale in ((100, 1.0), (100, 2.0), (200, 1.0)):
        TG._trilinear(x, x, x, g, torch.rand((n, 3), dtype=F64) * scale)
    TG._trilinear(x, x, x, g.float(), torch.rand((100, 3)))
    assert len(_keys("_trilinear")) == 3

    _, sp = _splines()
    starts = TD.construct_chunks((16, 16, 16), 8)[:, 0, :].T.astype(float)
    deltas, left = np.full(3, 100.0), np.full(3, -800.0)
    TD._paint_batch(sp, starts[:4], deltas, left, 8)
    TD._paint_batch(sp, starts[4:], deltas, left * 2, 8)
    assert len(_keys("_paint_program")) == 1
    TD._paint_batch(sp, starts[:4], deltas, left, 8, f32=True)
    TD._paint_batch(sp, starts[:4] * 2, deltas, left, 4)
    TD._paint_batch(sp, starts[:3], deltas, left, 8)
    assert len(_keys("_paint_program")) == 4


def test_ragged_last_batch_is_a_second_program():
    """A grid of 8 chunks in batches of 3: batches of 3, 3 and 2 chunks,
    two programs; the stream equals one batch of all 8."""
    _, sp = _splines()
    starts = TD.construct_chunks((16, 16, 16), 8)[:, 0, :].T.astype(float)
    deltas, left = np.full(3, 100.0), np.full(3, -800.0)
    got = [(i0, b.copy()) for i0, b in TD._paint_blocks(
        sp, starts, deltas, left, 8, batch=3)]
    assert [i0 for i0, _ in got] == [0, 3, 6]
    assert len(_keys("_paint_program")) == 2
    whole = TD._paint_batch(sp, starts, deltas, left, 8).numpy()
    np.testing.assert_array_equal(np.concatenate([b for _, b in got]), whole)


# ------------------------------------------------- the eager draw order
@pytest.mark.parametrize("dtype", [F64, F32])
def test_noise_is_drawn_in_the_eager_order(dtype):
    """The noise at the head of a new buffer and of a program's buffer
    filled in place, with or without room for the spectra, equals one
    ``torch.randn`` draw, and a field from a seed equals the field given
    that draw as its noise."""
    shape = (16, 16, 14)
    fresh = torch.randn((3,) + shape, generator=torch.Generator().manual_seed(
        4), dtype=dtype)
    for spectra, size in ((False, 3 * 16 * 16 * 14), (True, 3 * 16 * 16 * 16)):
        new = TG._noise_drawer(None, torch.Generator().manual_seed(4), shape,
                               dtype, "cpu", spectra)(None)
        buf = torch.empty(size, dtype=dtype)
        filled = TG._noise_drawer(None, torch.Generator().manual_seed(4),
                                  shape, dtype, "cpu", spectra)(buf)
        assert new.shape == (size,) and filled is buf
        assert torch.equal(TG._head(new, shape), fresh)
        assert torch.equal(TG._head(buf, shape), fresh)
    for cls in ("RandomMagneticField", "RandomMagneticVectorPotential"):
        a = getattr(TG, cls)(LE, RE, shape, 50.0, 500.0, 1e-6, padding=0.0,
                             prng=4, dtype=dtype, **CPU)
        b = getattr(TG, cls)(LE, RE, shape, 50.0, 500.0, 1e-6, padding=0.0,
                             noise=fresh, dtype=dtype, **CPU)
        assert all(torch.equal(getattr(a, f"g{c}"), getattr(b, f"g{c}"))
                   for c in "xyz")
    two = [[300.0] * 3, [700.0] * 3]
    a = _radial(TG, two, 800.0, True, False, dims=shape, padding=0.0,
                prng=4, dtype=dtype, **CPU)
    b = _radial(TG, two, 800.0, True, False, dims=shape, padding=0.0,
                noise=fresh, dtype=dtype, **CPU)
    assert torch.equal(a.gx, b.gx) and torch.equal(a.gz, b.gz)


# ------------------------------------- the sharded builder's stages
N, DELTA, L_MIN, L_MAX, G_RMS = 32, 10.0, 20.0, 80.0, 2.0


def _jax_noise_and_field():
    """JAX's white noise of key 3 (the three splits of its builder) and its
    field over four virtual devices."""
    from jax.sharding import Mesh

    key = jax.random.key(3)
    keys = jax.random.split(key, 3)
    noise = np.stack([np.asarray(jax.random.normal(keys[i], (N,) * 3,
                                                   dtype=jnp.float64))
                      for i in range(3)])
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("ens",))
    ref = j_sharded_grf(key, (N,) * 3, (DELTA,) * 3, L_MIN, L_MAX, mesh,
                        g_rms=G_RMS, dtype=jnp.float64)
    return noise, np.stack([np.asarray(c) for c in ref])


def _stages_by_hand(noise, p):
    """The sharded builder's three stages for ``p`` ranks in one process,
    each stage's body under ``_NoHostReads``, the all-to-all transposes
    and the sum's all-reduce done by hand; returns the whole field."""
    shape, deltas = (N,) * 3, (DELTA,) * 3
    nxl = N // p
    k0, k1 = 2 * np.pi / L_MIN, 2 * np.pi / L_MAX
    ws = [TF._workspace(shape, p, F64, "cpu") for r in range(p)]
    params = [torch.from_numpy(TF._kspace_params(
        shape, deltas, p, r, k0, k1, -11.0 / 3.0)) for r in range(p)]

    def transpose(src, dst):
        # block j of rank i's send buffer goes to block i of rank j's
        for i in range(p):
            for j in range(p):
                dst(j)[i].copy_(src(i)[j])

    def a2a_view(r, c):
        return ws[r]["spectra"][c].view(ws[r]["a2a"].shape)

    with _NoHostReads():
        for c in range(3):
            for r in range(p):
                ws[r]["noise"].copy_(torch.from_numpy(
                    noise[c, r * nxl:(r + 1) * nxl]))
                TF._forward_stage(ws[r]["noise"], ws[r]["a2a"], None)
            transpose(lambda i: ws[i]["a2a"], lambda j, c=c: a2a_view(j, c))
        for r in range(p):
            TF._kspace_stage(*ws[r]["spectra"], params[r], None,
                             div_clean=True)
        comps, sumsq = [], 0.0
        for c in range(3):
            transpose(lambda i, c=c: a2a_view(i, c), lambda j: ws[j]["a2a"])
            slabs = []
            for r in range(p):
                sumsq = sumsq + TF._backward_stage(ws[r]["a2a"],
                                                   ws[r]["noise"], None)
                slabs.append(ws[r]["noise"].clone())
            comps.append(torch.cat(slabs))
    scale = G_RMS / torch.sqrt(sumsq / N**3)
    return np.stack([(g * scale).numpy() for g in comps])


def test_sharded_stages_match_jax():
    noise, want = _jax_noise_and_field()
    one, two = _stages_by_hand(noise, 1), _stages_by_hand(noise, 2)
    assert np.abs(one - want).max() / np.abs(want).max() <= 1e-10
    assert np.abs(two - one).max() / np.abs(one).max() <= 1e-12


# ------------------------------------------------ in-place buffers
def test_in_place_buffers_and_eager_runs():
    """A workspace's programs take its buffers in place (no copy in, an
    output that is one of them handed back as itself); a device holds one
    workspace of a name, which another key drops with its programs;
    ``compiled.eager()`` runs a program's body and makes none; ``clear``
    drops the workspaces."""
    def body(buf, x, uniforms):
        buf.add_(x)
        return buf, x * 2

    ws = C.workspace("ws_test", 4, "cpu", lambda: torch.zeros(4))
    assert C.workspace("ws_test", 4, "cpu", lambda: torch.ones(4)) is ws
    buf, x = ws.buffers, torch.arange(4.0)
    out, twice = ws.run(("inplace_test",), body, (buf, x), inplace=1)
    assert out is buf and torch.equal(buf, x) and torch.equal(twice, 2 * x)
    ws.run(("inplace_test",), body, (buf, x + 1), inplace=1)
    assert torch.equal(buf, 2 * x + 1)
    assert len(ws.programs) == 1 and "inplace_test" not in C._MEMOS
    assert C.programs() == list(ws.programs.values())
    with C.eager():
        out, _ = ws.run(("eager_test",), body, (buf, x), inplace=1)
    assert out is buf and len(ws.programs) == 1
    other = C.workspace("ws_test", 8, "cpu", lambda: torch.zeros(8))
    assert other is not ws and C.workspaces() == [other]
    assert not other.programs and C.programs() == []
    C.clear()
    assert C.workspaces() == []


# ------------------------------------------ gloo worlds of one and two
_WORLD = """
import contextlib
from torch.utils._python_dispatch import TorchDispatchMode
from cluster_generator_tpu_torch import pipeline as P
from cluster_generator_tpu_torch.core import compiled as C
from cluster_generator_tpu_torch.parallel import ensemble as E
from cluster_generator_tpu_torch.parallel import mergers as MG
from cluster_generator_tpu_torch.parallel.fields import (
    sharded_gaussian_random_field)
from cluster_generator_tpu_torch.parallel.mesh import (ens_rows, fold_in,
                                                        make_mesh)

READS = (torch.ops.aten._local_scalar_dense.default,
         torch.ops.aten.is_nonzero.default, torch.ops.aten.nonzero.default)


class NoHostReads(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        assert func not in READS, f"a program body read a value: {func}"
        return func(*args, **(kwargs or {}))


def guarded(body):
    def run(*a):
        with NoHostReads():
            return body(*a)
    return run


# every program body (batch programs, stages, decorated functions) guarded
names = []
real_run, real_call, real_ws_run = C.run, C._Function._call, C.Workspace.run
def run(key, body, inputs, draw=None):
    names.append(key[0])
    return real_run(key, guarded(body), inputs, draw)
def ws_run(self, key, body, inputs, draw=None, inplace=0):
    names.append(key[0])
    return real_ws_run(self, key, guarded(body), inputs, draw, inplace)
def call(self, args, kwargs):
    key, inputs, body, draw = real_call(self, args, kwargs)
    names.append(self.name)
    return key, inputs, guarded(body), draw
C.run, C._Function._call, C.Workspace.run = run, call, ws_run

mesh = make_mesh(device_type="cpu")
B = 4
lo, hi = ens_rows(mesh, B)
M, c = E.sample_ensemble_params(torch.Generator().manual_seed(1), B,
                                device="cpu")
full = E._datagen_full_batch_fn(64, 30, 20, 10, n_rows=16, rq=32,
                                star_n_rows=8, star_rq=16, star_n_s=32,
                                star_n_q=32)
gen = lambda: E._batch_generator(2, 0, "cpu")
got_out, got = E._mesh_call(full, mesh, (M, c), (), gen())
want = full(M, c, gen())
RESULT["datagen_rows"] = np.asarray(got)
for sp, arrays in want.items():
    for i, (a, b) in enumerate(zip(got_out[sp], arrays)):
        RESULT[f"datagen_{sp}{i}"] = np.asarray(
            [float((a - b[lo:hi]).abs().max()), float(b.abs().max())])
RESULT["datagen_program_rows"] = np.asarray(sorted(
    p.key[3][0][0][0] for p in C.programs() if p.key[0][0] == "datagen"))

sc = MG.sample_merger_scene_params(torch.Generator().manual_seed(3), B,
                                   device="cpu")
ctr, vel = MG.binary_scene_geometry(sc["M200"], sc["d"], sc["b"],
                                    sc["v_rel"])
ctr, vel = (torch.as_tensor(np.asarray(a), dtype=torch.float64)
            for a in (ctr, vel))
fn = MG._merger_batch_fn(64, (12, 12), (16, 16), (4, 4), device="cpu")
r_max = torch.tensor([3000.0, 3000.0], dtype=torch.float64)
inputs = (sc["M200"], sc["conc"], ctr, vel)
srows, _ = E._mesh_call(fn, mesh, inputs, (r_max,), gen())
swant = fn(*inputs, r_max, gen())
RESULT["scene_diff"] = np.asarray(
    [max(float((srows[k] - v[lo:hi]).abs().max()) for k, v in swant.items()),
     max(float(v.abs().max()) for v in swant.values())])

# the sharded merger draw: sample_merger_ic's program at the shard counts
from cluster_generator_tpu_torch.parallel.mesh import make_mesh as mk
mp = mk(1, WORLD, device_type="cpu")
fields = P.build_merger_models([1.5e15, 1e15], [4.0, 5.0], num_points=128,
                               device="cpu")
tables = P.build_speed_tables(fields)
tables["radius"] = P.build_radius_tables(fields, [3000.0, 3000.0])
counts = ((40, 20), (40, 20), (8, 4))
del names[:]
parts = P.sample_merger_ic_sharded(mp, fields, tables,
                                   [[-1000.0, 0, 0], [1000.0, 0, 0]],
                                   [[0.2, 0, 0], [-0.3, 0, 0]],
                                   [3000.0, 3000.0], 9, *counts)
RESULT["sharded_names"] = np.asarray(sorted(set(names)))
plain = P.sample_merger_ic(fields, tables, [[-1000.0, 0, 0], [1000.0, 0, 0]],
                           [[0.2, 0, 0], [-0.3, 0, 0]], [3000.0, 3000.0],
                           *(tuple(n // WORLD for n in t) for t in counts),
                           generator=fold_in(9, mp.get_local_rank("part"),
                                             "cpu"))
RESULT["sharded_draw_equal"] = np.asarray(
    all(torch.equal(parts[k].to_local(), v) for k, v in plain.items()))

# the sharded builder
def field(g_rms=2.0, l_min=20.0, seed=7, n=16, d=10.0):
    g = sharded_gaussian_random_field(seed, (n,) * 3, (d,) * 3, l_min, 80.0,
                                      mesh, g_rms=g_rms,
                                      dtype=torch.float64)
    return [x.to_local() for x in g]

def stage_programs():
    return sorted(p.key[0][0] for p in C.programs()
                  if p.key[0][0].startswith("sharded_grf"))

del names[:]
first = field()
RESULT["stage_names"] = np.asarray(sorted(set(names)))
RESULT["programs_first"] = np.asarray(stage_programs())
again = field(g_rms=4.0)
RESULT["programs_g_rms"] = np.asarray(stage_programs())
RESULT["g_rms_ratio"] = np.asarray(
    max(float((2 * a - b).abs().max()) for a, b in zip(first, again)))
field(l_min=30.0)
RESULT["programs_l_min"] = np.asarray(stage_programs())
field(d=12.0)
RESULT["programs_box"] = np.asarray(stage_programs())
with C.eager():
    eager = field()
RESULT["eager_equal"] = np.asarray(all(torch.equal(a, b)
                                       for a, b in zip(first, eager)))
ws = C.workspaces()
RESULT["workspaces"] = np.asarray(len(ws))
bufs = ws[0].buffers
owned = {t.untyped_storage().data_ptr() for t in
         (bufs["noise"], bufs["a2a"], *bufs["spectra"])}
RESULT["aliased"] = np.asarray(
    any(g.untyped_storage().data_ptr() in owned for g in first))
RESULT["field"] = np.stack([g.numpy() for g in first])
# another grid drops the workspace and its programs
key = ws[0].key
del ws, bufs
field(n=8)
RESULT["programs_other_grid"] = np.asarray(stage_programs())
RESULT["other_grid_dropped"] = np.asarray(
    len(C.workspaces()) == 1 and C.workspaces()[0].key != key)
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("programs")
    handles = {w: start_world(d / f"w{w}", w, _WORLD) for w in (1, 2)}
    return {w: finish_world(h) for w, h in handles.items()}


@pytest.mark.parametrize("world", [1, 2])
def test_mesh_call_rows_equal_the_unsharded_batch(worlds, world):
    for rank, r in enumerate(worlds[world]):
        n = 4 // world
        assert tuple(r["datagen_rows"]) == (rank * n, (rank + 1) * n)
        diffs = {k: v for k, v in r.items() if k.startswith("datagen_")
                 and k not in ("datagen_rows", "datagen_program_rows")}
        assert len(diffs) == 9
        for k, (diff, scale) in diffs.items():
            assert diff <= 1e-12 * scale, k
        diff, scale = r["scene_diff"]
        assert diff <= 1e-12 * scale
        # the batch program ran at the rank's rows (and whole for the
        # reference)
        assert sorted(set(r["datagen_program_rows"])) == sorted({n, 4})


@pytest.mark.parametrize("world", [1, 2])
def test_sharded_merger_draw_runs_its_program(worlds, world):
    for r in worlds[world]:
        assert "sample_merger_ic" in set(r["sharded_names"])
        assert bool(r["sharded_draw_equal"])


@pytest.mark.parametrize("world", [1, 2])
def test_sharded_builder_programs(worlds, world):
    stages = ["sharded_grf_backward", "sharded_grf_forward",
              "sharded_grf_kspace"]
    for r in worlds[world]:
        assert set(stages) <= set(r["stage_names"])
        assert list(r["programs_first"]) == stages
        assert list(r["programs_g_rms"]) == stages
        assert list(r["programs_l_min"]) == stages
        assert list(r["programs_box"]) == stages
        assert float(r["g_rms_ratio"]) == 0.0
        assert bool(r["eager_equal"]) and not bool(r["aliased"])
        assert int(r["workspaces"]) == 1
        assert list(r["programs_other_grid"]) == stages
        assert bool(r["other_grid_dropped"])
    if world == 2:
        one = worlds[1][0]["field"]
        two = np.concatenate([r["field"] for r in worlds[2]], axis=1)
        assert np.abs(two - one).max() / np.abs(one).max() <= 1e-12
