"""The port's grid-sharded random field against the JAX package's.

32^3 cells of 10 kpc, l_min 20, l_max 80, float64.  Given JAX's own white
noise (the three ``jax.random.split`` normals of parallel/fields.py:66-70,
passed as ``noise=``), the port's field over four gloo ranks and over one
equals JAX's ``sharded_gaussian_random_field`` over four devices within
1e-10 of its largest value.  From a seed, the port's field does not depend
on the mesh: four ranks, a (2, 2) mesh and one rank agree within 1e-12; its
rms is ``g_rms`` within 1e-4 and its divergence is at roundoff (the check of
``__graft_entry__.py:227-232``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from cluster_generator_tpu.parallel.fields import (
    sharded_gaussian_random_field,
)
from tests.test_torch_parallel_fft import finish_world, start_world

N, DELTA, L_MIN, L_MAX, G_RMS = 32, 10.0, 20.0, 80.0, 2.0

_GRF = """
from cluster_generator_tpu_torch.parallel.dryrun import grf_checks
from cluster_generator_tpu_torch.parallel.fields import (
    sharded_gaussian_random_field)
from cluster_generator_tpu_torch.parallel.mesh import (all_gather_rows,
                                                        make_mesh)
n, d = ARGS["n"], ARGS["delta"]
kw = dict(g_rms=ARGS["g_rms"], dtype=torch.float64)
shape, deltas = (n, n, n), (d, d, d)
mesh = make_mesh(device_type="cpu")
lo, hi = RANK * n // WORLD, (RANK + 1) * n // WORLD
slabs = [torch.tensor(w[lo:hi]) for w in np.load(ARGS["noise"])]
g = sharded_gaussian_random_field(0, shape, deltas, ARGS["l_min"],
                                  ARGS["l_max"], mesh, noise=slabs, **kw)
RESULT["given"] = np.stack([c.to_local().numpy() for c in g])
RESULT["given_shape"] = np.asarray(g[0].shape)
g = sharded_gaussian_random_field(7, shape, deltas, ARGS["l_min"],
                                  ARGS["l_max"], mesh, **kw)
whole = [all_gather_rows(mesh, c.to_local()) for c in g]
RESULT["seeded"] = np.stack([w.numpy() for w in whole])
RESULT["checks"] = np.asarray(grf_checks(*whole, d))
if WORLD == 4:
    mesh2 = make_mesh(2, 2, device_type="cpu")
    g = sharded_gaussian_random_field(7, shape, deltas, ARGS["l_min"],
                                      ARGS["l_max"], mesh2, **kw)
    RESULT["mesh22"] = np.stack([all_gather_rows(mesh2, c.to_local()).numpy()
                                 for c in g])
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("grf")
    key = jax.random.key(3)
    keys = jax.random.split(key, 3)
    noise = np.stack([np.asarray(jax.random.normal(keys[i], (N,) * 3,
                                                   dtype=jnp.float64))
                      for i in range(3)])
    np.save(d / "noise.npy", noise)
    args = dict(n=N, delta=DELTA, l_min=L_MIN, l_max=L_MAX, g_rms=G_RMS,
                noise=str(d / "noise.npy"))
    handles = {w: start_world(d / f"w{w}", w, _GRF, **args) for w in (1, 4)}
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("ens",))
    ref = sharded_gaussian_random_field(key, (N,) * 3, (DELTA,) * 3, L_MIN,
                                        L_MAX, mesh, g_rms=G_RMS,
                                        dtype=jnp.float64)
    return {"jax": np.stack([np.asarray(c) for c in ref]),
            **{w: finish_world(h) for w, h in handles.items()}}


@pytest.mark.parametrize("world", [1, 4])
def test_sharded_grf_matches_jax_given_its_noise(worlds, world):
    ranks = worlds[world]
    got = np.concatenate([r["given"] for r in ranks], axis=1)
    ref = worlds["jax"]
    assert tuple(ranks[0]["given_shape"]) == (N,) * 3
    assert ranks[0]["given"].shape == (3, N // world, N, N)
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-10


def test_sharded_grf_from_a_seed_does_not_depend_on_the_mesh(worlds):
    one = worlds[1][0]["seeded"]
    scale = np.abs(one).max()
    for r in worlds[4]:
        assert np.abs(r["seeded"] - one).max() / scale <= 1e-12
        assert np.abs(r["mesh22"] - one).max() / scale <= 1e-12


@pytest.mark.parametrize("world", [1, 4])
def test_sharded_grf_rms_and_divergence(worlds, world):
    for r in worlds[world]:
        rms, div = r["checks"]
        assert abs(rms - G_RMS) < 1e-4
        assert div < 1e-4
