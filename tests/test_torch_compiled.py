"""The port's captured batch programs (``core/compiled.py``): the memo rules
of tests/test_recompilation.py, held by the port's three programs.

* the same configuration and shape give the same program object, for the
  factories (as the JAX package's ``lru_cache``) and for the programs the
  entry points run;
* a changed count, batch size, ``cgparams['numerical']`` table knob or
  ``cgparams['gravity']`` constant gives a new program;
* masses, concentrations, centers, bulk velocities, ``r_max``, ``z`` and
  seeds are inputs: they reuse the program (``z`` as the JAX package
  traces it), and the result at each ``z`` is the JAX package's;
* on the CPU each program runs its eager body, and equals the function it
  wraps (the stages with the caller's generator) bit for bit;
* the memo is bounded; uniforms drawn into static buffers equal the
  uniforms drawn anew.

Capture and replay need the card: their tests are in
tests/test_torch_cuda.py (marker ``cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_generator_tpu import pipeline as JP
from cluster_generator_tpu.core.config import cgparams as jcgparams
from cluster_generator_tpu.parallel import ensemble as JE
from cluster_generator_tpu_torch import pipeline as TP
from cluster_generator_tpu_torch.core import compiled as C
from cluster_generator_tpu_torch.core.config import cgparams
from cluster_generator_tpu_torch.ops.cdf_inverse import invert_cdf_rows
from cluster_generator_tpu_torch.parallel import ensemble as TE
from cluster_generator_tpu_torch.parallel import mergers as TM
from tests.test_torch_pipeline import _check_draws, _jax_uniforms

torch.set_num_threads(1)

CPU = {"device": "cpu"}
POINTS = 128
NG, ND, NS = (300, 200), (240, 160), (60, 40)
COUNTS = {"dm": 300, "gas": 200, "star": 80}
SCENE_COUNTS = {"gas": (200, 200), "dm": (250, 250), "star": (50, 50)}
KNOB = "df_node_grid_body"


def _merger(M=(1.5e15, 1.0e15), c=(4.0, 5.0), ctr=((-1500.0, 0, 0),
            (1500.0, 0, 0)), vel=((0.3, 0, 0), (-0.45, 0, 0)), r_max=5000.0,
            seed=0, counts=(NG, ND, NS), z=0.1):
    return TP.merger_ic_fused(
        list(M), list(c), [list(x) for x in ctr], [list(x) for x in vel],
        r_max, *counts, z=z, num_points=POINTS,
        generator=torch.Generator().manual_seed(seed), **CPU)


def _ensemble(n=4):
    return TE.sample_ensemble_params(torch.Generator().manual_seed(5), n,
                                     **CPU)


def _datagen(M, c, seed=0, counts=COUNTS):
    return TE._datagen_full_batch_fn(POINTS, counts["dm"], counts["gas"],
                                     counts["star"])(
        M, c, torch.Generator().manual_seed(seed))


def _scenes(n=2):
    p = TM.sample_merger_scene_params(torch.Generator().manual_seed(6), n,
                                      **CPU)
    return TM._scene_inputs(p, torch.device("cpu"))


def _scene_batch(M, c, ctr, vel, r_max=(5000.0, 5000.0), seed=0,
                 counts=SCENE_COUNTS):
    fn = TM._merger_batch_fn(POINTS, counts["gas"], counts["dm"],
                             counts["star"], **CPU)
    return fn(M, c, ctr, vel, list(r_max), torch.Generator().manual_seed(seed))


def _n_programs(name):
    return sum(p.key[0][0] == name for p in C.programs())


@pytest.fixture(autouse=True)
def _fresh_memo():
    C.clear()
    yield
    C.clear()


@pytest.fixture
def knob():
    """Set the speed-table knob in both packages; restored after."""
    old = cgparams["numerical"].get(KNOB, 4096)
    jold = jcgparams["numerical"].get(KNOB, 4096)

    def set_(value):
        cgparams["numerical"][KNOB] = value
        jcgparams["numerical"][KNOB] = value

    yield set_
    cgparams["numerical"][KNOB] = old
    jcgparams["numerical"][KNOB] = jold


# ------------------------------------------------------------ the factories
@pytest.mark.parametrize("case", ["datagen_full", "datagen_dm", "scenes"])
def test_factories_are_memoized_like_the_jax_package(case):
    """The same configuration gives the same program object in both
    packages; a changed count gives a new one."""
    if case == "datagen_full":
        for mod in (JE, TE):
            a = mod._datagen_full_batch_fn(POINTS, 500, 400, 100)
            assert mod._datagen_full_batch_fn(POINTS, 500, 400, 100) is a
            assert mod._datagen_full_batch_fn(POINTS, 501, 400, 100) is not a
    elif case == "datagen_dm":
        for mod in (JE, TE):
            a = mod._datagen_batch_fn(POINTS, 1000)
            assert mod._datagen_batch_fn(POINTS, 1000) is a
            assert mod._datagen_batch_fn(POINTS, 2000) is not a
    else:
        a = TM._merger_batch_fn(POINTS, (1, 1), (2, 2), (1, 1), **CPU)
        assert TM._merger_batch_fn(POINTS, (1, 1), (2, 2), (1, 1), **CPU) is a
        assert TM._merger_batch_fn(POINTS, (1, 1), (3, 2), (1, 1),
                                   **CPU) is not a


@pytest.mark.parametrize("case", ["datagen_full", "datagen_dm", "scenes"])
def test_factories_see_config_changes(case, knob):
    """The memo key holds ``cgparams['numerical']``'s table knobs, as the
    JAX package's does: a changed knob is a new program, and restoring it
    gives the first one back."""
    make = {"datagen_full": lambda mod: mod._datagen_full_batch_fn(
                POINTS, 500, 400, 100),
            "datagen_dm": lambda mod: mod._datagen_batch_fn(POINTS, 1000),
            "scenes": lambda mod: mod._merger_batch_fn(
                POINTS, (1, 1), (2, 2), (1, 1), **CPU)}[case]
    mods = (TM,) if case == "scenes" else (JE, TE)
    first = [make(m) for m in mods]
    old = cgparams["numerical"].get(KNOB, 4096)
    knob(old // 2)
    assert all(make(m) is not a for m, a in zip(mods, first))
    knob(old)
    assert all(make(m) is a for m, a in zip(mods, first))


# -------------------------------------------------- the programs' memo keys
@pytest.mark.parametrize("vary", ["masses", "centers", "velocities", "r_max",
                                  "seed", "z"])
def test_merger_physical_params_are_runtime(vary):
    """Sweeping a physical parameter, ``z`` or the seed reuses ONE program
    (tests/test_recompilation.py's merger case)."""
    base = _merger()
    changed = {"masses": dict(M=(2.5e15, 0.8e15), c=(6.5, 3.1)),
               "centers": dict(ctr=((-1200.0, 50.0, 0), (1800.0, 0, -20.0))),
               "velocities": dict(vel=((-0.1, 0.2, 0), (0.7, 0, 0))),
               "r_max": dict(r_max=(5000.0, 4000.0)),
               "seed": dict(seed=3), "z": dict(z=0.3)}[vary]
    other = _merger(**changed)
    assert _n_programs("merger_ic_fused") == 1
    assert any(not torch.equal(base[0][k], other[0][k]) for k in base[0])


@pytest.mark.parametrize("vary", ["counts", "tracers", "knob"])
def test_merger_statics_make_new_programs(vary, knob):
    """A count, tracers or a table knob is baked in: a new program."""
    _merger()
    if vary == "counts":
        _merger(counts=(NG, (250, 160), NS))
    elif vary == "tracers":
        TP.merger_ic_fused([1.5e15, 1.0e15], [4.0, 5.0],
                           [[-1500.0, 0, 0], [1500.0, 0, 0]],
                           [[0.3, 0, 0], [-0.45, 0, 0]], 5000.0, NG, ND, NS,
                           n_tracer=(30, 20), num_points=POINTS, **CPU)
    else:
        knob(cgparams["numerical"].get(KNOB, 4096) // 2)
        _merger()
    assert _n_programs("merger_ic_fused") == 2


def _jax_merger(z, key, gravity="newtonian"):
    M, c = [1.5e15, 1.0e15], [4.0, 5.0]
    ctr = [[-1500.0, 0, 0], [1500.0, 0, 0]]
    vel = [[0.3, 0, 0], [-0.45, 0, 0]]
    parts, fields = JP.merger_ic_fused(
        jnp.asarray(M), jnp.asarray(c), jnp.asarray(ctr), jnp.asarray(vel),
        jnp.asarray([5000.0, 5000.0]), key, NG, ND, NS, z=z,
        num_points=POINTS, gravity=gravity)
    return ({k: np.asarray(v) for k, v in parts.items()},
            {k: np.asarray(v) for k, v in fields.items()})


def _port_merger(z, uniforms, gravity="newtonian"):
    parts, fields = TP.merger_ic_fused(
        [1.5e15, 1.0e15], [4.0, 5.0], [[-1500.0, 0, 0], [1500.0, 0, 0]],
        [[0.3, 0, 0], [-0.45, 0, 0]], 5000.0, NG, ND, NS, z=z,
        num_points=POINTS, gravity=gravity, uniforms=uniforms, **CPU)
    return ({k: v.numpy() for k, v in parts.items()},
            {k: v.numpy() for k, v in fields.items()})


def _fields_close(got, want, df_floor=0.0):
    """Fields rtol 1e-9, DFs rtol 1e-6 (tests/test_torch_pipeline.py);
    ``df_floor``: an absolute floor for the DFs, of their largest value."""
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("_df"):
            np.testing.assert_allclose(got[k], w, rtol=1e-6, err_msg=k,
                                       atol=df_floor * np.abs(w).max())
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-9, err_msg=k)


def test_z_is_an_input_and_moves_the_result():
    """``z`` is an input of the program, as the JAX package traces it: two
    ``z`` replay one program, their results differ, and each is the JAX
    package's ``merger_ic_fused`` at that ``z`` (given its uniforms), at
    the tolerances of tests/test_torch_pipeline.py."""
    key = jax.random.key(7)
    unif = _jax_uniforms(key, NG, ND, NS)
    got = {z: _port_merger(z, unif) for z in (0.1, 0.3)}
    assert _n_programs("merger_ic_fused") == 1
    assert not np.array_equal(got[0.1][0]["dm", "particle_position"],
                              got[0.3][0]["dm", "particle_position"])
    for z, (parts, fields) in got.items():
        j_parts, j_fields = _jax_merger(z, key)
        _fields_close(fields, j_fields)
        _check_draws(parts, j_parts, nd=ND, ns=NS)


# ------------------------------------ the gravity constants (MOND a0) key
A0 = 1.2e-10


@pytest.fixture
def a0():
    """Set the MOND a0 in both packages; restored after."""
    old = cgparams["gravity"]["mond"]["a0_m_s2"]
    jold = jcgparams["gravity"]["mond"]["a0_m_s2"]

    def set_(value):
        cgparams["gravity"]["mond"]["a0_m_s2"] = value
        jcgparams["gravity"]["mond"]["a0_m_s2"] = value

    yield set_
    cgparams["gravity"]["mond"]["a0_m_s2"] = old
    jcgparams["gravity"]["mond"]["a0_m_s2"] = jold
    jax.clear_caches()


@pytest.mark.parametrize("case", ["datagen_full", "datagen_dm", "scenes"])
def test_factories_see_gravity_changes(case, a0):
    """The factories' memo key holds ``cgparams['gravity']``: after a
    changed MOND ``a0`` a factory gives a new program object, and
    restoring ``a0`` gives the first one back."""
    make = {"datagen_full": lambda: TE._datagen_full_batch_fn(
                POINTS, 500, 400, 100, gravity="qumond"),
            "datagen_dm": lambda: TE._datagen_batch_fn(POINTS, 1000,
                                                       gravity="qumond"),
            "scenes": lambda: TM._merger_batch_fn(
                POINTS, (1, 1), (2, 2), (1, 1), gravity="qumond", **CPU)}[case]
    first = make()
    a0(2.0 * A0)
    second = make()
    assert second is not first
    a0(A0)
    assert make() is first


@pytest.mark.parametrize("case", ["merger", "datagen", "scenes"])
def test_programs_see_gravity_changes(case, a0):
    """F3: after a QUMOND program ran, a changed ``a0`` makes a new
    program (the old one would replay the old ``a0`` on the card) whose
    result moves; the merger's fields equal the JAX package's at that
    ``a0`` (its caches cleared, so that it traces again).  The QUMOND DFs
    of a 128-point grid at twice ``a0`` turn negative and noisy in the
    outer tail, where the two packages differ by 4e-10 of the DF's
    largest value: the DFs get an absolute floor of 1e-9 of it."""
    if case == "merger":
        key = jax.random.key(7)
        unif = _jax_uniforms(key, NG, ND, NS)
        first = _port_merger(0.1, unif, "qumond")[1]
        a0(2.0 * A0)
        jax.clear_caches()
        second = _port_merger(0.1, unif, "qumond")[1]
        _fields_close(second, _jax_merger(0.1, key, "qumond")[1],
                      df_floor=1e-9)
        name = "merger_ic_fused"
        moved = first["gravitational_field"] - second["gravitational_field"]
    elif case == "datagen":
        M, c = _ensemble(2)

        def run():
            return TE._datagen_full_batch_fn(POINTS, 300, 200, 80,
                                             gravity="qumond")(
                M, c, torch.Generator().manual_seed(0))["dm"][1]
        first = run()
        a0(2.0 * A0)
        second = run()
        name, moved = "datagen", (first - second).numpy()
    else:
        M, c, ctr, vel = _scenes(2)

        def run():
            return TM._merger_batch_fn(POINTS, *SCENE_COUNTS.values(),
                                       gravity="qumond", **CPU)(
                M, c, ctr, vel, [5000.0, 5000.0],
                torch.Generator().manual_seed(0))["dm_velocity"]
        first = run()
        a0(2.0 * A0)
        second = run()
        name, moved = "scene_batch", (first - second).numpy()
    assert _n_programs(name) == 2
    assert np.abs(moved).max() > 0


@pytest.mark.parametrize("vary", ["masses", "seed", "batch_size", "counts"])
def test_datagen_program_per_shape(vary):
    """Masses and seeds reuse a batch program; a batch size (a remainder
    batch) or a count is another program."""
    M, c = _ensemble(6)
    _datagen(M[:4], c[:4])
    if vary == "masses":
        _datagen(M[2:6], c[2:6])
    elif vary == "seed":
        _datagen(M[:4], c[:4], seed=9)
    elif vary == "batch_size":
        _datagen(M[:2], c[:2])
    else:
        _datagen(M[:4], c[:4], counts=dict(COUNTS, star=90))
    want = 1 if vary in ("masses", "seed") else 2
    assert _n_programs("datagen") == want


@pytest.mark.parametrize("vary", ["masses", "centers", "r_max", "seed",
                                  "batch_size", "counts"])
def test_scene_program_per_shape(vary):
    M, c, ctr, vel = _scenes(3)
    _scene_batch(M[:2], c[:2], ctr[:2], vel[:2])
    if vary == "masses":
        _scene_batch(M[1:], c[1:], ctr[:2], vel[:2])
    elif vary == "centers":
        _scene_batch(M[:2], c[:2], ctr[1:], vel[1:])
    elif vary == "r_max":
        _scene_batch(M[:2], c[:2], ctr[:2], vel[:2], r_max=(4000.0, 4500.0))
    elif vary == "seed":
        _scene_batch(M[:2], c[:2], ctr[:2], vel[:2], seed=4)
    elif vary == "batch_size":
        _scene_batch(M[:1], c[:1], ctr[:1], vel[:1])
    else:
        _scene_batch(M[:2], c[:2], ctr[:2], vel[:2],
                     counts=dict(SCENE_COUNTS, star=(40, 60)))
    want = 2 if vary in ("batch_size", "counts") else 1
    assert _n_programs("scene_batch") == want


def test_datagen_stream_runs_the_memoized_program():
    """``datagen_batches`` calls the memoized program: full batches share
    one, the remainder has its own."""
    M, c = _ensemble(5)
    outs = list(TE.datagen_batches(M, c, COUNTS, batch_size=2,
                                   num_points=POINTS, seed=3, **CPU))
    assert [b0 for b0, _ in outs] == [0, 2, 4]
    assert _n_programs("datagen") == 2
    prog = TE._datagen_full_batch_fn(POINTS, 300, 200, 80)
    assert all(p.body.__self__ is prog for p in C.programs())


# ------------------------------------------- the eager body is the function
@pytest.mark.parametrize("switches", [{}, {"r_a": 1500.0, "n_tracer": (30, 20),
                                          "compute_potential": True}])
def test_merger_program_equals_its_stages(switches):
    """On the CPU the program's output equals the four stages with the
    caller's generator, bit for bit."""
    args = ([1.5e15, 1.0e15], [4.0, 5.0], [[-1500.0, 0, 0], [1500.0, 0, 0]],
            [[0.3, 0, 0], [-0.45, 0, 0]])
    parts, fields = TP.merger_ic_fused(
        *args, 5000.0, NG, ND, NS, num_points=POINTS,
        generator=torch.Generator().manual_seed(2), **switches, **CPU)
    f = TP.build_merger_models(args[0], args[1], num_points=POINTS,
                               r_a=switches.get("r_a"), **CPU)
    tables = TP.build_speed_tables(f)
    tables["radius"] = TP.build_radius_tables(f, 5000.0)
    want = TP.sample_merger_ic(f, tables, args[2], args[3], 5000.0, NG, ND,
                               NS, generator=torch.Generator().manual_seed(2),
                               **switches)
    assert set(parts) == set(want) and set(fields) == set(f)
    assert all(torch.equal(parts[k], want[k]) for k in want)
    assert all(torch.equal(fields[k], f[k]) for k in f)


def test_datagen_program_equals_its_eager_body():
    M, c = _ensemble(4)
    prog = TE._datagen_full_batch_fn(POINTS, 300, 200, 80)
    got = prog(M, c, torch.Generator().manual_seed(4))
    want = prog.run(M, c, torch.Generator().manual_seed(4))
    for sp in want:
        assert all(torch.equal(a, b) for a, b in zip(got[sp], want[sp])), sp


def test_scene_program_equals_its_eager_body():
    M, c, ctr, vel = _scenes(2)
    fn = TM._merger_batch_fn(POINTS, *SCENE_COUNTS.values(), **CPU)
    got = fn(M, c, ctr, vel, [5000.0, 5000.0],
             torch.Generator().manual_seed(8))
    want = fn.run(M, c, ctr, vel, [5000.0, 5000.0],
                  torch.Generator().manual_seed(8))
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


# --------------------------------------------------------------- mechanics
@pytest.mark.parametrize("kind", ["collisionless", "gas", "merger",
                                  "datagen", "class_gas",
                                  "class_collisionless"])
def test_uniforms_drawn_in_place_equal_fresh_ones(kind):
    """The static buffers are filled with the numbers a fresh draw gives
    (the class draws': ``num // sub_sample`` radii and speeds)."""
    def draw(seed, out=None):
        g = torch.Generator().manual_seed(seed)
        if kind.startswith("class"):
            from cluster_generator_tpu_torch import sampling as S
            if kind == "class_gas":
                return S._gas_uniforms(g, 70, 23, "cpu", out=out)
            return S._collisionless_uniforms(g, 70, 23, torch.float32,
                                             "cpu", out=out)
        if kind == "collisionless":
            from cluster_generator_tpu_torch.core.draws import (
                collisionless_uniforms)
            return collisionless_uniforms(g, (3, 50), torch.float32, "cpu",
                                          out=out)
        if kind == "gas":
            from cluster_generator_tpu_torch.core.draws import gas_uniforms
            return gas_uniforms(g, 70, torch.float32, "cpu", out=out)
        if kind == "merger":
            return TP.merger_uniforms(g, (2,), NG, ND, NS, (5, 0), out=out,
                                      **CPU)
        prog = TE._datagen_full_batch_fn(POINTS, 30, 20, 8)
        return prog.uniforms(3, g, "cpu", out=out)

    fresh = draw(1)
    buf = C.tree_map(torch.empty_like, fresh)
    filled = draw(1, out=buf)
    assert all(a is b for a, b in zip(C._leaves(filled), C._leaves(buf)))
    assert all(torch.equal(a, b)
               for a, b in zip(C._leaves(filled), C._leaves(fresh)))


def test_memo_is_bounded_least_recent_first():
    x = torch.zeros(2)
    progs = [C.program(("t", i), lambda *a: a[0], (x,))
             for i in range(C.MAX_PROGRAMS + 2)]
    assert len(C.programs()) == C.MAX_PROGRAMS
    assert C.program(("t", 2), None, (x,)) is progs[2]   # still held
    assert C.programs()[-1] is progs[2]
    assert all(p is not progs[0] and p is not progs[1] for p in C.programs())
    assert C.program(("t", 2), None, (x[:1],)) is not progs[2]  # a shape


def test_given_uniforms_and_devices():
    u = {"a": (torch.arange(3.0), torch.ones(2))}
    draw = C.drawer(u, None, "cpu", None)
    fresh = draw(None)
    assert fresh["a"][0] is not u["a"][0] and torch.equal(fresh["a"][0],
                                                          u["a"][0])
    buf = C.tree_map(torch.zeros_like, u)
    assert draw(buf) is buf and torch.equal(buf["a"][1], u["a"][1])
    with pytest.raises(ValueError, match="cuda or cpu"):
        C.Program("k", lambda *a: a)((torch.zeros(1, device="meta"),),
                                     lambda out: None)
    with pytest.raises(ValueError, match="lack the sites"):
        TP.merger_ic_fused([1e15], [4.0], [[0, 0, 0]], [[0, 0, 0]], 5000.0,
                           (10,), (10,), (10,), num_points=POINTS,
                           uniforms={}, **CPU)


def test_count_launch_counts_outside_a_capture():
    before = invert_cdf_rows.launches
    C.count_launch(invert_cdf_rows)
    assert invert_cdf_rows.launches == before + 1
    invert_cdf_rows.launches = before
