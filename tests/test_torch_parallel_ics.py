"""The port's sharded merger draw and sharded Gadget export against the JAX
package's.

The dry run's sizes: two halos on the 64-point grid, 64 particles per
shard per halo and species.  JAX draws over an (ens 4, part 2) mesh, where
shard i draws from ``fold_in(key, i)``.  The port's rank at ``part``
coordinate i, given JAX's fields and tables and the uniforms of
``fold_in(key, i)`` at ``sample_merger_ic``'s own splits, draws JAX's shard
i at the tolerances of tests/test_torch_pipeline.py:10-16; ranks that
differ only in ``ens`` hold equal replicas.  At world 1 the port's draw is
JAX's over a one-device mesh.

The export: JAX's sharded draw over four devices (with potentials) goes
into JAX's ``write_sharded_gadget_files`` and, split four ways, into the
port's at world 4.  The box clips some particles.  The files agree on the
header counts and the IDs (globally unique, 1..N), and their datasets are
equal; the port's ``from_gadget_files`` reads the union back.  A (2, 2)
mesh writes two files, one per distinct shard, with the blocks the
no-``h5py`` path builds.
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from cluster_generator_tpu import pipeline as JP
from cluster_generator_tpu.parallel.export import (
    write_sharded_gadget_files as jax_write,
)
from cluster_generator_tpu_torch.particles import ClusterParticles
from tests.test_torch_parallel_fft import finish_world, start_world
from tests.test_torch_pipeline import _jax_uniforms

torch.set_num_threads(1)

CENTERS = [[-500.0, 0.0, 0.0], [500.0, 0.0, 0.0]]
VELS = [[0.1, 0.0, 0.0], [-0.1, 0.0, 0.0]]
RMAX = [3000.0, 3000.0]
PER = 64  # per shard, halo and species
BOX = 5000.0  # < 2 (500 + 3000): the box clips some draws


def _jax_state():
    fields = JP.build_merger_models(jnp.asarray([1.5e15, 1.0e15]),
                                    jnp.asarray([4.0, 5.0]), num_points=64)
    tables = JP.build_speed_tables(fields)
    tables["radius"] = JP.build_radius_tables(fields, jnp.asarray(RMAX))
    return fields, tables


def _jax_sharded(fields, tables, key, n_ens, n_part, **kw):
    devs = np.asarray(jax.devices()[:n_ens * n_part])
    mesh = Mesh(devs.reshape(n_ens, n_part), ("ens", "part"))
    n = (PER * n_part,) * 2
    parts = JP.sample_merger_ic_sharded(
        mesh, fields, tables, jnp.asarray(CENTERS), jnp.asarray(VELS),
        jnp.asarray(RMAX), key, n, n, n, axis="part", **kw)
    return parts, mesh


_DRAW = """
from cluster_generator_tpu_torch.convert import (fields_from_numpy,
                                                 tables_from_numpy)
from cluster_generator_tpu_torch.parallel.mesh import make_mesh
from cluster_generator_tpu_torch.pipeline import sample_merger_ic_sharded
state = torch.load(ARGS["state"], weights_only=False)
fields = fields_from_numpy(state["fields"], device="cpu")
tables = tables_from_numpy(state["tables"], device="cpu")
n_part = ARGS["n_part"]
mesh = make_mesh(n_part=n_part, device_type="cpu")
i = mesh.get_local_rank("part")
n = (ARGS["per"] * n_part,) * 2
parts = sample_merger_ic_sharded(mesh, fields, tables, ARGS["centers"],
                                 ARGS["vels"], ARGS["rmax"], 0, n, n, n,
                                 uniforms=state["unif"][i])
for (sp, name), v in parts.items():
    RESULT[f"{sp}/{name}"] = v.to_local().numpy()
    RESULT[f"{sp}/{name}/shape"] = np.asarray(v.shape)
RESULT["part"] = np.asarray(i)
try:
    sample_merger_ic_sharded(mesh, fields, tables, ARGS["centers"],
                             ARGS["vels"], ARGS["rmax"], 0, (3, 3), n, n)
    RESULT["raised"] = np.asarray(WORLD == 1)
except ValueError:
    RESULT["raised"] = np.asarray(True)
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every port world of this file, started at once: the draws at
    world 4 and world 1, and the export at world 4 (whose JAX files are
    written while the worlds run)."""
    d = tmp_path_factory.mktemp("ics")
    fields, tables = _jax_state()
    key = jax.random.key(0)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    layouts = ((4, 4, 2), (1, 1, 1))  # world, JAX's ens and part sizes
    handles = {}
    for world, _, n_part in layouts:
        unif = [_jax_uniforms(jax.random.fold_in(key, i), (PER,) * 2,
                              (PER,) * 2, (PER,) * 2) for i in range(n_part)]
        state = d / f"state{world}.pt"
        torch.save({"fields": to_np(fields), "tables": to_np(tables),
                    "unif": unif}, state)
        handles[world] = start_world(d / f"w{world}", world, _DRAW,
                                     state=str(state), n_part=n_part, per=PER,
                                     centers=CENTERS, vels=VELS, rmax=RMAX)
    parts, _ = _jax_sharded(fields, tables, jax.random.key(2), 1, 4,
                            compute_potential=True)
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in parts.items()},
               d / "parts.pt")
    (d / "port").mkdir()
    handles["export"] = start_world(
        d / "export", 4, _EXPORT, parts=str(d / "parts.pt"), box=BOX,
        base=str(d / "port" / "ic"), base2=str(d / "port" / "two"))
    (d / "jax").mkdir()
    jax_files = jax_write(parts, BOX, d / "jax" / "ic",
                          center_offset=[BOX / 2] * 3)
    assert len(jax_files) == 4
    out = {}
    for world, n_ens, n_part in layouts:
        jparts, _ = _jax_sharded(fields, tables, key, n_ens, n_part)
        out[world] = (to_np(jparts), finish_world(handles[world]), n_part)
    out["export"] = (d, finish_world(handles["export"]))
    return out


def _check_shard(got, want, bulk):
    for (sp, name), a in want.items():
        b = got[f"{sp}/{name}"]
        assert b.shape == a.shape and b.dtype == np.float32, (sp, name)
        a, b = a.astype(np.float64), b.astype(np.float64)
        if name == "particle_velocity" and sp == "gas":
            assert np.abs(a - b).max() < 2e-5 * 0.1, sp
        elif name == "particle_velocity":
            sa = np.linalg.norm(a - bulk, axis=1)
            sb = np.linalg.norm(b - bulk, axis=1)
            rel = np.abs(sa - sb) / sa
            assert (rel > 1e-4).mean() <= 1e-4, (sp, rel.max())
        elif a.ndim == 2:
            rel = np.linalg.norm(a - b, axis=1) / np.linalg.norm(a, axis=1)
            assert rel.max() < 2e-5, (sp, name, rel.max())
        else:
            np.testing.assert_allclose(b, a, rtol=2e-5,
                                       err_msg=f"{sp} {name}")


@pytest.mark.parametrize("world", [4, 1])
def test_sharded_draw_matches_jax_shard_by_shard(worlds, world):
    jparts, ranks, n_part = worlds[world]
    bulk = np.concatenate([np.repeat(np.asarray(VELS[i])[None], PER, 0)
                           for i in range(2)])
    for r in ranks:
        i = int(r["part"])
        shard = {k: v.reshape((n_part, -1) + v.shape[1:])[i]
                 for k, v in jparts.items()}
        _check_shard(r, shard, bulk)
        for k, v in jparts.items():
            assert tuple(r[f"{k[0]}/{k[1]}/shape"]) == v.shape


def test_sharded_draw_replicas_along_ens_are_equal(worlds):
    _, ranks, _ = worlds[4]
    by_part = {}
    for r in ranks:
        by_part.setdefault(int(r["part"]), []).append(r)
    assert sorted(by_part) == [0, 1]
    for reps in by_part.values():
        assert len(reps) == 2
        for k, v in reps[0].items():
            np.testing.assert_array_equal(reps[1][k], v, err_msg=k)


def test_sharded_draw_refuses_counts_the_axis_does_not_divide(worlds):
    assert all(bool(r["raised"]) for r in worlds[4][1])


# ------------------------------------------------------------------ export
_EXPORT = """
from cluster_generator_tpu_torch.parallel.export import (
    _export_plan, write_sharded_gadget_files)
from cluster_generator_tpu_torch.parallel.mesh import make_mesh, sharded
parts = torch.load(ARGS["parts"], weights_only=False)

def split(mesh, axis, k):
    out = {}
    for key, v in parts.items():
        n = v.shape[0] // k
        i = mesh.get_local_rank(axis)
        out[key] = sharded(mesh, v[i * n:(i + 1) * n], axis, v.shape[0])
    return out

mesh = make_mesh(1, 4, device_type="cpu")
files = write_sharded_gadget_files(split(mesh, "part", 4), ARGS["box"],
                                   ARGS["base"],
                                   center_offset=[ARGS["box"] / 2] * 3)
RESULT["files"] = np.asarray([str(f) for f in files])
mesh = make_mesh(2, 2, device_type="cpu")
files = write_sharded_gadget_files(split(mesh, "part", 2), ARGS["box"],
                                   ARGS["base2"],
                                   center_offset=[ARGS["box"] / 2] * 3)
RESULT["files2"] = np.asarray([str(f) for f in files])
n_files, total, plan = _export_plan(split(mesh, "part", 2), ARGS["box"],
                                    [ARGS["box"] / 2] * 3)
RESULT["plan_total"] = total
for rank, sp, id_offset, expect in plan:
    blocks, counts, _ = sp.gadget_blocks(ARGS["box"], id_offset=id_offset)
    RESULT["block_rank"] = np.asarray(rank)
    for ptype, arrays in blocks.items():
        for name, arr in arrays.items():
            RESULT[f"{ptype}/{name}"] = arr
"""


def _read(fn):
    with h5py.File(fn, "r") as f:
        hdr = dict(f["Header"].attrs)
        data = {f"{g}/{k}": f[g][k][()] for g in f if g.startswith("PartType")
                for k in f[g]}
    return hdr, data


def test_sharded_export_matches_jax_files(worlds):
    d, ranks = worlds["export"]
    assert [list(r["files"]) for r in ranks] == [
        [str(d / "port" / f"ic.{k}.h5")] for k in range(4)]
    totals, ids = [], []
    for k in range(4):
        jh, jd = _read(d / "jax" / f"ic.{k}.h5")
        th, td = _read(d / "port" / f"ic.{k}.h5")
        assert th["NumFilesPerSnapshot"] == jh["NumFilesPerSnapshot"] == 4
        for key in ("NumPart_Total", "NumPart_ThisFile", "MassTable"):
            np.testing.assert_array_equal(th[key], jh[key], err_msg=key)
        assert set(td) == set(jd)
        for key, a in jd.items():
            np.testing.assert_array_equal(td[key], a, err_msg=f"{k} {key}")
        totals.append(th["NumPart_Total"])
        ids += [a for key, a in td.items() if key.endswith("ParticleIDs")]
    total = totals[0]
    assert 0 < total.sum() < 6 * 4 * PER * 2  # the box clipped some
    ids = np.concatenate(ids)
    np.testing.assert_array_equal(np.sort(ids), np.arange(1, len(ids) + 1))
    back = ClusterParticles.from_gadget_files(d / "port" / "ic.0.h5",
                                              device="cpu")
    assert sum(back.num_particles.values()) == int(total.sum())
    assert back.num_particles["dm"] == int(total[1])


def test_sharded_export_writes_one_file_per_distinct_shard(worlds):
    """Over a (2, 2) mesh sharded on 'part' the replicas along 'ens' write
    nothing; the two files make one snapshot, and the blocks the
    no-h5py path builds are what the file holds."""
    d, ranks = worlds["export"]
    wrote = [list(r["files2"]) for r in ranks]
    assert sorted(sum(wrote, [])) == [str(d / "port" / f"two.{k}.h5")
                                      for k in range(2)]
    assert sum(len(w) for w in wrote) == 2
    hdrs = [_read(d / "port" / f"two.{k}.h5") for k in range(2)]
    for h, _ in hdrs:
        assert h["NumFilesPerSnapshot"] == 2
        np.testing.assert_array_equal(h["NumPart_Total"],
                                      ranks[0]["plan_total"])
    np.testing.assert_array_equal(
        sum(h["NumPart_ThisFile"] for h, _ in hdrs),
        hdrs[0][0]["NumPart_Total"])
    ptype = {"gas": "PartType0", "dm": "PartType1", "star": "PartType4"}
    for r in ranks:
        if "block_rank" not in r:
            continue
        _, data = hdrs[int(r["block_rank"])]
        for key, a in r.items():
            if "/" in key:
                sp, name = key.split("/")
                np.testing.assert_array_equal(
                    data[f"{ptype[sp]}/{name}"], a, err_msg=key)
    back = ClusterParticles.from_gadget_files(d / "port" / "two.0.h5",
                                              device="cpu")
    assert sum(back.num_particles.values()) == int(
        hdrs[0][0]["NumPart_Total"].sum())
