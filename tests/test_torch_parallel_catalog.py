"""The port's catalogs over a mesh against its own catalogs without one.

19 clusters of the full-species product in batches of 8 (8 + 8 + 3, as
tests/workers/mesh_datagen_worker.py:35-37) and 8 merger scenes in one
batch.  Over four gloo ranks on the CPU (an (ens 4, part 1) mesh) each rank
computes its rows of every batch that 4 divides; the catalogs equal the
port's one-process catalogs without a mesh within rtol 5e-7 and atol 1e-6
(the JAX package's bound for its mesh catalogs), the short final batch bit
for bit.  Over one rank with a mesh they are equal bit for bit.  The mesh's
``ens`` size is recorded as ``mesh_ens``, a resume with another size
raises, a resume with the same size completes a cut catalog, and an
existing file is refused on every rank.  ``datagen_batches(mesh=)`` yields
DTensors; the multi-process writers over a (2, 2) mesh write one shard per
``part`` coordinate.  The JAX package's ``verify_catalog`` passes the
port's mesh catalog.
"""

import shutil

import h5py
import numpy as np
import pytest
import torch

from cluster_generator_tpu.parallel import ensemble as JE
from cluster_generator_tpu_torch.parallel import ensemble as TE
from cluster_generator_tpu_torch.parallel import mergers as TM
from tests.test_torch_parallel_fft import finish_world, start_world

torch.set_num_threads(1)

COUNTS = {"dm": 256, "gas": 192, "star": 64}
KW = dict(n_particles_per_cluster=COUNTS, batch_size=8, num_points=128,
          seed=6)
MKW = dict(counts={"dm": 64, "gas": 48, "star": 16}, batch_size=8,
           num_points=128, seed=7)

_CATALOGS = """
from cluster_generator_tpu_torch.parallel import ensemble as TE
from cluster_generator_tpu_torch.parallel import mergers as TM
from cluster_generator_tpu_torch.parallel.mesh import make_mesh
M, c = np.asarray(ARGS["M"]), np.asarray(ARGS["c"])
params = torch.load(ARGS["params"], weights_only=False)
kw = ARGS["kw"]
mkw = ARGS["mkw"]
mesh = make_mesh(device_type="cpu")
RESULT["fn"] = np.asarray(TE.ensemble_datagen(M, c, OUT + "/mesh.h5",
                                              mesh=mesh, device="cpu", **kw))
TM.merger_datagen(params, OUT + "/m_mesh.h5", mesh=mesh, device="cpu", **mkw)
if WORLD > 1:
    try:
        TE.ensemble_datagen(M, c, OUT + "/mesh.h5", mesh=mesh, **kw)
        RESULT["refused"] = np.asarray(False)
    except OSError:
        RESULT["refused"] = np.asarray(True)
    # a cut catalog resumed over the same mesh
    if RANK == 0:
        import h5py
        import shutil
        shutil.copy(OUT + "/mesh.h5", OUT + "/cut.h5")
        with h5py.File(OUT + "/cut.h5", "a") as f:
            del f.attrs["complete"]
            del f["cluster_000009"]
    dist.barrier()
    TE.ensemble_datagen(M, c, OUT + "/cut.h5", mesh=mesh, resume=True, **kw)
    sizes = []
    for b0, out in TE.datagen_batches(M, c, kw["n_particles_per_cluster"],
                                      batch_size=8, num_points=128, seed=6,
                                      mesh=mesh):
        pos = out["dm"][0]
        sizes.append([b0, pos.shape[0], pos.to_local().shape[0],
                      int(pos.placements[0].is_shard())])
        RESULT[f"batch{b0}"] = pos.full_tensor().numpy()
    RESULT["sizes"] = np.asarray(sizes)
"""

_MULTIHOST = """
from cluster_generator_tpu_torch.parallel import ensemble as TE
from cluster_generator_tpu_torch.parallel import mergers as TM
from cluster_generator_tpu_torch.parallel.mesh import make_mesh
M, c = np.asarray(ARGS["M"]), np.asarray(ARGS["c"])
params = torch.load(ARGS["params"], weights_only=False)
mesh22 = make_mesh(2, 2, device_type="cpu")
RESULT["mh"] = np.asarray(TE.ensemble_datagen_multihost(
    M, c, OUT + "/mh.h5", mesh=mesh22, **ARGS["kw"]))
RESULT["mmh"] = np.asarray(TM.merger_datagen_multihost(
    params, OUT + "/mmh.h5", mesh=mesh22, **ARGS["mkw"]))
"""


@pytest.fixture(scope="module")
def catalogs(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshcat")
    M, c = TE.sample_ensemble_params(torch.Generator().manual_seed(21), 19,
                                     device="cpu")
    M, c = M.numpy(), c.numpy()
    params = TM.sample_merger_scene_params(torch.Generator().manual_seed(33),
                                           8, device="cpu")
    torch.save(params, d / "params.pt")
    args = dict(M=M.tolist(), c=c.tolist(), params=str(d / "params.pt"),
                kw=KW, mkw=MKW)
    runs = {1: (1, _CATALOGS), 4: (4, _CATALOGS), "mh": (4, _MULTIHOST)}
    handles = {k: start_world(d / f"w{k}", w, code, **args)
               for k, (w, code) in runs.items()}
    ref = {"single": TE.ensemble_datagen(M, c, str(d / "single.h5"),
                                         device="cpu", **KW),
           "m_single": TM.merger_datagen(params, str(d / "m_single.h5"),
                                         device="cpu", **MKW)}
    worlds = {k: (d / f"w{k}", finish_world(h)) for k, h in handles.items()}
    return M, c, ref, worlds


def _read(fn, reader=TE.read_catalog):
    return dict(reader(fn))


def _close(got, want, exact=()):
    assert sorted(got) == sorted(want)
    for i in want:
        assert sorted(got[i]) == sorted(want[i])
        for k in want[i]:
            if i in exact:
                np.testing.assert_array_equal(got[i][k], want[i][k],
                                              err_msg=f"{i} {k}")
            else:
                np.testing.assert_allclose(got[i][k], want[i][k], rtol=5e-7,
                                           atol=1e-6, err_msg=f"{i} {k}")


def test_world_one_with_a_mesh_is_bit_identical(catalogs):
    _, _, ref, worlds = catalogs
    d, _ = worlds[1]
    single = _read(ref["single"])
    _close(_read(str(d / "mesh.h5")), single, exact=set(single))
    m_single = _read(ref["m_single"], TM.read_merger_catalog)
    _close(_read(str(d / "m_mesh.h5"), TM.read_merger_catalog), m_single,
           exact=set(m_single))


def test_world_four_matches_world_one(catalogs):
    """Every rank returns the filename; the short final batch (3
    clusters, computed whole) is exact."""
    _, _, ref, worlds = catalogs
    d, ranks = worlds[4]
    assert [str(r["fn"]) for r in ranks] == [str(d / "mesh.h5")] * 4
    _close(_read(str(d / "mesh.h5")), _read(ref["single"]),
           exact={16, 17, 18})
    _close(_read(str(d / "m_mesh.h5"), TM.read_merger_catalog),
           _read(ref["m_single"], TM.read_merger_catalog))


def test_mesh_ens_is_recorded_and_checked_on_resume(catalogs, tmp_path):
    M, c, ref, worlds = catalogs
    for w in (1, 4):
        d, _ = worlds[w]
        for name in ("mesh.h5", "m_mesh.h5"):
            with h5py.File(d / name, "r") as f:
                assert int(f.attrs["mesh_ens"]) == w
    with h5py.File(ref["single"], "r") as f:
        assert int(f.attrs["mesh_ens"]) == 0
    d, ranks = worlds[4]
    assert all(bool(r["refused"]) for r in ranks)
    # the cut catalog resumed over the same mesh is whole again
    _close(_read(str(d / "cut.h5")), _read(str(d / "mesh.h5")),
           exact=set(range(19)))
    cut = tmp_path / "cut.h5"
    shutil.copy(d / "mesh.h5", cut)
    with h5py.File(cut, "a") as f:
        del f.attrs["complete"]
    with pytest.raises(ValueError, match="mesh_ens"):
        TE.ensemble_datagen(M, c, str(cut), resume=True, device="cpu", **KW)


def test_datagen_batches_over_a_mesh_yield_dtensors(catalogs):
    """Sharded over 'ens' where 4 divides the batch, replicated for the
    short one; the draws are the catalog's."""
    _, _, ref, worlds = catalogs
    _, ranks = worlds[4]
    want = [[0, 8, 2, 1], [8, 8, 2, 1], [16, 3, 3, 0]]
    single = _read(ref["single"])
    for r in ranks:
        np.testing.assert_array_equal(r["sizes"], want)
        for b0, n, _, _ in want:
            got = r[f"batch{b0}"]
            assert got.shape == (n, COUNTS["dm"], 3)
            np.testing.assert_allclose(
                got, np.stack([single[b0 + i]["dm_position"]
                               for i in range(n)]), rtol=5e-7, atol=1e-6)


def test_multihost_writers_over_a_mesh(catalogs):
    """Over a (2, 2) mesh the ranks at 'part' coordinate j write shard j
    of 2 together; the shard set is the one-process catalog."""
    _, _, ref, worlds = catalogs
    d, ranks = worlds["mh"]
    shards = [str(d / f"mh.{j}of2.h5") for j in range(2)]
    assert [str(r["mh"]) for r in ranks] == [shards[j] for j in (0, 1, 0, 1)]
    for j, fn in enumerate(shards):
        with h5py.File(fn, "r") as f:
            assert int(f.attrs["mesh_ens"]) == 2
            assert int(f.attrs["shard_rank"]) == j
    _close(_read(shards), _read(ref["single"]), exact={16, 17, 18})
    mshards = [str(d / f"mmh.{j}of2.h5") for j in range(2)]
    assert [str(r["mmh"]) for r in ranks] == [mshards[j] for j in (0, 1, 0, 1)]
    _close(_read(mshards, TM.read_merger_catalog),
           _read(ref["m_single"], TM.read_merger_catalog))


def test_jax_verify_catalog_passes_the_mesh_catalog(catalogs):
    d, _ = catalogs[3][4]
    rep = JE.verify_catalog(str(d / "mesh.h5"), strict=True)
    assert rep["violations"] == [] and rep["n_clusters_checked"] == 19
    assert TE.verify_catalog(str(d / "mesh.h5"),
                             device="cpu")["violations"] == []


def test_cumsum_scan_is_a_cumulative_sum_and_row_invariant():
    """The model build's cumulative sum (a log-depth scan, so that a rank's
    slice of a batch sums each row as the whole batch does) against numpy,
    float64 within 1e-13 of the row totals; a slice of rows equals the
    same rows of the whole, bit for bit."""
    from cluster_generator_tpu_torch.core.quadrature import cumsum

    x = torch.tensor(np.random.RandomState(4).standard_normal((9, 511)))
    got = cumsum(x)
    want = np.cumsum(x.numpy(), axis=-1)
    assert np.abs(got.numpy() - want).max() <= 1e-13 * np.abs(
        x.numpy()).sum(-1).max()
    assert torch.equal(cumsum(x[2:5]), got[2:5])
    assert cumsum(x[:, :1]).shape == (9, 1)
    assert cumsum(x[:, :0]).shape == (9, 0)
