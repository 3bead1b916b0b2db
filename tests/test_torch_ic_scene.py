"""The IC scene through the class path, as a user of ``ClusterICs`` runs
it, on the CPU at a small size.

* ``ClusterICs`` over two models in memory (``h5py`` blocked) gives, bit
  for bit, the scene of the module functions (``halo_particle_counts``,
  ``draw_halo_particles``, ``combine_two_clusters``) and writes no file;
  ``to_file`` refuses it.
* ``ClusterParticles.gadget_blocks`` is what ``write_to_gadget_file``
  writes, with the IDs 1..N over the types in order.
* Capacity classes (``core.compiled.capacity``): a draw and a gas mixing
  at two counts of one class equal the programs at the exact count bit
  for bit and use one program; a stream of scenes whose counts change
  makes each program once, none again after the first of its class.
* The stage marks of a scene in one ``device_sequence``: models, dfs,
  ..., mix, export, end; the merger's and the datagen's as they were.
* The cell ``ic-scene-2h-1e7`` at small sizes, run by the benchmark's
  harness against ``portbench/reference/scene.py``.

On the CPU a decorated call runs its eager body and makes no program, so
the program tests read the memo keys of the calls, as
tests/test_torch_class_programs.py does; capture and replay on the card:
``chip_smoke.py`` phase 23.
"""

import sys

import h5py
import numpy as np
import pytest
import torch

import cluster_generator_tpu_torch as tcg
import cluster_generator_tpu_torch.ics as TI
import cluster_generator_tpu_torch.particles as TP
from cluster_generator_tpu_torch.core import compiled as C
from cluster_generator_tpu_torch.core import profiling
from cluster_generator_tpu_torch.sampling import parse_prng

torch.set_num_threads(2)

POINTS = 256
R_MAX = 3000.0
TOTALS = {"gas": 3000, "dm": 2400, "star": 600}
BOX = 10000.0
CENTERS = [[3500.0, 4800.0, 5000.0], [6500.0, 5200.0, 5000.0]]
VELOCITIES = [[0.3, 0.0, 0.0], [-0.45, 0.0, 0.0]]
CALLS = []


def _model(m200, conc, points=POINTS):
    """A class-path halo with its DFs, on the CPU."""
    r200 = tcg.find_overdensity_radius(m200, 200.0, z=0.1)
    a = r200 / conc
    M = tcg.snfw_total_mass(m200, r200, a)
    rhot = tcg.snfw_density_profile(M, a)
    r500, M500 = tcg.find_radius_mass(tcg.snfw_mass_profile(M, a), z=0.1,
                                      delta=500.0, device="cpu")
    rhog = tcg.rescale_profile_by_mass(
        tcg.vikhlinin_density_profile(1.0, 100.0, r200, 1.0, 0.67, 3),
        tcg.f_gas(M500) * M500, r500)
    m = tcg.ClusterModel.from_dens_and_tden(
        0.1, 1e4, rhog, rhot, stellar_density=0.02 * rhot,
        num_points=points, device="cpu")
    m.dm_virial, m.star_virial
    return m


@pytest.fixture(scope="module")
def models():
    return [_model(1.2e15, 4.2), _model(4e14, 5.0)]


@pytest.fixture
def recorded(monkeypatch):
    """Every decorated call recorded in ``CALLS`` as ``(memo key, key,
    inputs, memo size)``: the program the card would use."""
    real = C._Function._call

    def record(self, args, kwargs):
        key, inputs, body, draw = real(self, args, kwargs)
        CALLS.append((C._memo_key(key, inputs), key, inputs, self.memo))
        return key, inputs, body, draw

    C.clear()
    CALLS.clear()
    monkeypatch.setattr(C._Function, "_call", record)
    yield CALLS
    CALLS.clear()
    C.clear()


def _keys(name):
    return {memo for memo, _, _, _ in CALLS if memo[0][0] == name}


def _equal(a, b):
    assert a.particle_types == b.particle_types
    assert list(a.fields) == list(b.fields)
    for k in a.fields:
        assert torch.equal(a[k], b[k]), k


def _scene(models, seed=7, output_directory=None):
    ics = tcg.ClusterICs("s", 2, models, CENTERS, VELOCITIES, r_max=R_MAX,
                         num_particles=dict(TOTALS), device="cpu")
    return ics, ics.setup_particle_ics(output_directory=output_directory,
                                       prng=seed)


# ------------------------------------------------- ClusterICs in memory
def test_cluster_ics_of_models_in_memory_is_the_module_functions_scene(
        models, monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.chdir(tmp_path)
    ics, got = _scene(models)
    assert ics.load_model(0) is models[0] and ics.load_model(1) is models[1]
    assert ics.particle_files == [None] * 3 and list(tmp_path.iterdir()) == []
    counts = TI.halo_particle_counts(models, [R_MAX] * 2, TOTALS)
    assert ics.num_particles == counts
    base = parse_prng(7, "cpu")
    halos = [TI.draw_halo_particles(
        m, {k: counts[k][i] for k in TI.SPECIES}, R_MAX, R_MAX,
        TI.halo_generators(base)) for i, m in enumerate(models)]
    want = TP.combine_two_clusters(*halos, *models, *CENTERS, *VELOCITIES)
    _equal(got, want)
    with pytest.raises(ValueError, match="in memory"):
        ics.to_file(str(tmp_path / "s.yaml"))


def test_a_scene_in_memory_writes_particle_files_where_asked(models,
                                                             tmp_path):
    ics, got = _scene(models, output_directory=str(tmp_path))
    assert [f is not None for f in ics.particle_files] == [True, True,
                                                           False]
    again = tcg.ClusterICs("s", 2, models, CENTERS, VELOCITIES, r_max=R_MAX,
                           num_particles=dict(TOTALS),
                           particle_files=ics.particle_files[:2],
                           device="cpu").setup_particle_ics()
    # read back from the files: the same fields, in the files' type order
    assert set(again.fields) == set(got.fields)
    for k in got.fields:
        assert torch.equal(again[k], got[k]), k


def test_gadget_blocks_are_what_the_gadget_writer_writes(models, tmp_path):
    _, parts = _scene(models)
    blocks, counts, table = parts.gadget_blocks(BOX)
    assert list(blocks) == ["dm", "star", "gas"] == parts.particle_types
    n = parts.write_to_gadget_file(str(tmp_path / "ic.h5"), BOX)
    assert n == counts
    with h5py.File(tmp_path / "ic.h5", "r") as f:
        np.testing.assert_array_equal(f["Header"].attrs["MassTable"], table)
        for sp, arrays in blocks.items():
            group = f[TP.rptype_map[sp]]
            assert list(group) == sorted(arrays)
            for name, arr in arrays.items():
                assert group[name].dtype == arr.dtype
                np.testing.assert_array_equal(group[name][()], arr)
    ids = np.concatenate([blocks[sp]["ParticleIDs"] for sp in blocks])
    np.testing.assert_array_equal(ids, np.arange(1, ids.size + 1))
    for sp, arrays in blocks.items():
        pos = parts[sp, "particle_position"].numpy()
        inside = ((pos >= 0.0) & (pos <= BOX)).all(-1)
        assert counts[sp] == inside.sum() == len(arrays["Coordinates"])
        np.testing.assert_array_equal(arrays["Coordinates"],
                                      pos[inside].astype(np.float32))


# ------------------------------------------------------- capacity classes
def test_capacity_classes():
    assert [C.capacity(n) for n in (1, 16, 17, 100, 1000, 1024, 1025)] == \
        [1, 16, 17, 100, 1024, 1024, 1088]
    for n in range(17, 5000, 7):
        c = C.capacity(n)
        assert n <= c <= n * 1.0625 and C.capacity(c) == c


@pytest.mark.parametrize("species", ["gas", "dm", "star", "tracer"])
def test_draws_inside_one_class_are_the_exact_count_draws(
        models, recorded, monkeypatch, species):
    m = models[0]
    fn = {"gas": m.generate_gas_particles, "dm": m.generate_dm_particles,
          "star": m.generate_star_particles,
          "tracer": m.generate_tracer_particles}[species]
    counts = (1000, 1010)
    assert C.capacity(counts[0]) == C.capacity(counts[1]) == 1024
    got = [fn(n, r_max=R_MAX, prng=11) for n in counts]
    name = {"gas": "_draw_gas", "tracer": "_draw_tracers"}.get(
        species, "_draw_collisionless")
    assert len(_keys(name)) == 1
    monkeypatch.setattr(C, "CAPACITY_CLASSES", 0)
    for n, g in zip(counts, got):
        _equal(g, fn(n, r_max=R_MAX, prng=11))
        assert g.num_particles[species] == n
    assert len(_keys(name)) == 3


def test_mixing_inside_one_class_is_the_exact_count_mixing(models, recorded,
                                                          monkeypatch):
    def combined(n_gas):
        halos = [m.generate_gas_particles(n, r_max=R_MAX, prng=3 + i)
                 for i, (m, n) in enumerate(zip(models, n_gas))]
        return TP.combine_two_clusters(*halos, *models, *CENTERS,
                                       *VELOCITIES)

    pairs = ((500, 500), (520, 490))     # 1000 and 1010 gas particles
    got = [combined(p) for p in pairs]
    assert len(_keys("sample_clusters")) == 1
    monkeypatch.setattr(C, "CAPACITY_CLASSES", 0)
    for p, g in zip(pairs, got):
        _equal(g, combined(p))
    assert len(_keys("sample_clusters")) == 3


def test_a_stream_of_scenes_makes_each_program_once(recorded):
    rng = np.random.default_rng(5)
    gas = set()
    for _ in range(10):
        m1 = 10.0 ** rng.uniform(14.8, 15.2)
        m2 = m1 / rng.choice([1.0, 3.0, 10.0])
        ics, _ = _scene([_model(m1, 4.5, 128), _model(m2, 5.0, 128)],
                        seed=int(rng.integers(2**31)))
        gas |= set(ics.num_particles["gas"])
    made, again = {}, 0
    for memo, key, inputs, size in CALLS:
        prog = C.program(key, None, inputs, size)
        again += memo in made and made[memo] is not prog
        made[memo] = prog
    # a program per key, none made again once its class was captured
    assert again == 0
    assert len(_keys("_draw_gas")) == len({C.capacity(n) for n in gas})
    for name in ("_draw_gas", "_draw_collisionless", "sample_clusters",
                 "_collisionless_tables_program", "compute_df"):
        assert len(C._MEMOS[name]) == len(_keys(name)), name


# ----------------------------------------------------------- stage marks
@pytest.fixture
def marks(monkeypatch):
    got = []
    monkeypatch.setattr(profiling, "_mark",
                        lambda name, device: got.append(name))
    return got


def test_a_scene_in_one_sequence_marks_each_stage_in_order(marks):
    with profiling.device_sequence("cpu"):
        models = [_model(1.2e15, 4.2, 128), _model(4e14, 5.0, 128)]
        _, parts = _scene(models)
        parts.gadget_blocks(BOX)
    assert marks == (["models", "dfs", "dfs"] * 2 + ["tables", "draws"] * 6
                     + ["mix", "export", "end"])
    assert profiling._open_stages() == []
    del marks[:]
    # without a sequence each stage closes itself; nested, the sequence
    # hands back to its stage
    parts.gadget_blocks(BOX)
    x = torch.zeros(1)
    with profiling.device_stage("models", x):
        with profiling.device_sequence("cpu"):
            with profiling.device_stage("dfs", x):
                pass
    assert marks == ["export", "end", "models", "dfs", "models", "end"]


def test_the_merger_and_datagen_marks_are_as_they_were(marks):
    from tests.test_torch_tracing import ORDER, _datagen, _merger

    _merger()
    assert marks == ORDER
    del marks[:]
    _datagen()
    assert marks == ORDER * 2


# ------------------------------------------------------ the benchmark cell
def test_the_cell_at_a_small_size_is_correct_against_the_reference(
        monkeypatch):
    from portbench.tests._small_scene import run_small_scene

    result, lines = run_small_scene(monkeypatch, trace=True)
    assert result["correct"], lines
    got = result["metrics"]
    assert got["captures_per_call.scene"]["value"] == 0.0
    # per call: four model fields a halo, a halo's seeds, a type's count
    assert got["host_reads_per_call.scene"]["value"] == 2 * 4 + 2 + 3
