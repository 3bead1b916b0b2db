"""The port's meshes and pencil FFT against the JAX package's.

The JAX side runs here on conftest's virtual CPU devices.  The port's side
runs in ``torch.distributed`` worlds of gloo processes on the CPU, each
started with ``python -c`` and joined through a file store under
``tmp_path`` (:func:`start_world`; :func:`run_worlds` runs the worlds of
one and four ranks at once; the other ``test_torch_parallel_*`` files use
them too).  Tolerances: the pencil FFT of a 32x24x16 float64 grid
within 1e-10 of the largest |F| against JAX's ``pencil_fftn`` and
``np.fft.fftn``; the round trip within 1e-12.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cluster_generator_tpu.parallel.fft import pencil_fftn
from cluster_generator_tpu.parallel.mesh import make_mesh as jax_make_mesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
RANK, WORLD, OUT = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
ARGS = json.loads(sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + OUT + "/store",
                        rank=RANK, world_size=WORLD)
RESULT = {}
"""

_EPILOGUE = """
np.savez(f"{OUT}/rank{RANK}.npz", **RESULT)
dist.barrier()
dist.destroy_process_group()
"""


def start_world(directory, world, code, **args):
    """Start ``code`` in ``world`` gloo processes on the CPU, joined through
    a file store in ``directory`` (made fresh).  The code sees ``RANK``,
    ``WORLD``, ``OUT`` (the directory), ``ARGS`` (the keyword arguments,
    through JSON) and fills the dict ``RESULT`` with numpy arrays.  Returns
    a handle for :func:`finish_world`."""
    os.makedirs(directory)
    program = _PRELUDE + textwrap.dedent(code) + _EPILOGUE
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", program, str(r), str(world), str(directory),
         json.dumps(args)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in range(world)]
    return directory, procs


def finish_world(handle, timeout=240):
    """Wait for a world of :func:`start_world`; returns each rank's
    ``RESULT``, in rank order, and fails with the ranks' errors."""
    directory, procs = handle
    errors = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            if p.returncode:
                errors.append(err.decode()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errors, "\n".join(errors)
    out = []
    for r in range(len(procs)):
        with np.load(os.path.join(directory, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def run_worlds(directory, code, worlds=(1, 4), **args):
    """:func:`start_world` for each world size at once (in
    ``directory/w<size>``), then their results by size."""
    handles = {w: start_world(os.path.join(directory, f"w{w}"), w, code,
                              **args) for w in worlds}
    return {w: finish_world(h) for w, h in handles.items()}


_FFT = """
from cluster_generator_tpu_torch.parallel.fft import pencil_fftn, pencil_ifftn
from cluster_generator_tpu_torch.parallel.mesh import make_mesh, sharded

mesh = make_mesh(device_type="cpu")
RESULT["mesh"] = np.asarray(mesh.shape)
x = np.random.RandomState(0).standard_normal((32, 24, 16))
lo, hi = RANK * 32 // WORLD, (RANK + 1) * 32 // WORLD
xd = sharded(mesh, torch.tensor(x[lo:hi]), "ens", 32)
k = pencil_fftn(xd, mesh)
RESULT["k"] = k.to_local().numpy()
RESULT["k_shape"] = np.asarray(k.shape)
RESULT["back"] = pencil_ifftn(k, mesh).to_local().real.numpy()
RESULT["x"] = x[lo:hi]
# complex input keeps its type; float32 transforms in complex64
z = sharded(mesh, torch.tensor(x[lo:hi] + 1j * x[lo:hi, ::-1]), "ens", 32)
RESULT["kz"] = pencil_fftn(z, mesh).to_local().numpy()
f32 = sharded(mesh, torch.tensor(x[lo:hi], dtype=torch.float32), "ens", 32)
RESULT["k32_dtype"] = np.asarray(str(pencil_fftn(f32, mesh).to_local().dtype))
if WORLD > 1:
    bad = sharded(mesh, torch.zeros(2, 30, 16, dtype=torch.float64), "ens",
                  2 * WORLD)
    try:
        pencil_fftn(bad, mesh)
        RESULT["raised"] = np.asarray(False)
    except ValueError:
        RESULT["raised"] = np.asarray(True)
    # the shapes and assertion of make_mesh
    RESULT["shapes"] = np.asarray([
        make_mesh(n_ens=2, device_type="cpu").shape,
        make_mesh(n_part=4, device_type="cpu").shape,
        make_mesh(4, 1, device_type="cpu").shape])
    try:
        make_mesh(3, 1, device_type="cpu")
        RESULT["asserted"] = np.asarray(False)
    except AssertionError:
        RESULT["asserted"] = np.asarray(True)
"""


@pytest.fixture(scope="module")
def fft_worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("fft")
    return run_worlds(d, _FFT)


def _jax_fft(x):
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("ens",))
    xd = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh, P("ens", None, None)))
    return np.asarray(pencil_fftn(xd, mesh))


@pytest.mark.parametrize("world", [1, 4])
def test_pencil_fftn_matches_jax_and_numpy(fft_worlds, world):
    """The Y-slabs of the port's ranks tile JAX's pencil_fftn and
    np.fft.fftn of an asymmetric grid; the round trip comes back."""
    ranks = fft_worlds[world]
    x = np.random.RandomState(0).standard_normal((32, 24, 16))
    got = np.concatenate([r["k"] for r in ranks], axis=1)
    assert tuple(ranks[0]["k_shape"]) == (32, 24, 16)
    assert ranks[0]["k"].shape == (32, 24 // world, 16)
    for ref in (_jax_fft(x), np.fft.fftn(x)):
        assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-10
    back = np.concatenate([r["back"] for r in ranks], axis=0)
    assert np.abs(back - x).max() <= 1e-12
    z = x + 1j * x[:, ::-1]
    gz = np.concatenate([r["kz"] for r in ranks], axis=1)
    ref = _jax_fft(z)
    assert np.abs(gz - ref).max() / np.abs(ref).max() <= 1e-10
    assert str(ranks[0]["k32_dtype"]) == "torch.complex64"


def test_pencil_fft_refuses_a_size_the_ranks_do_not_divide(fft_worlds):
    assert all(bool(r["raised"]) for r in fft_worlds[4])


def test_make_mesh_shapes_and_assertion_match_jax(fft_worlds):
    """Over four ranks and over four JAX devices the same (ens, part)
    shapes, and the same assertion on a product that is not the world."""
    devs = jax.devices()[:4]
    want = [jax_make_mesh(devices=devs).devices.shape,
            jax_make_mesh(n_ens=2, devices=devs).devices.shape,
            jax_make_mesh(n_part=4, devices=devs).devices.shape,
            jax_make_mesh(4, 1, devices=devs).devices.shape]
    r0 = fft_worlds[4][0]
    got = [tuple(r0["mesh"])] + [tuple(s) for s in r0["shapes"]]
    assert got == want
    assert bool(r0["asserted"])
    with pytest.raises(AssertionError):
        jax_make_mesh(3, 1, devices=devs)
    assert tuple(fft_worlds[1][0]["mesh"]) == (1, 1)


def test_make_mesh_without_a_process_group_raises():
    """No world of one is invented: the message says how to start one."""
    import torch.distributed as dist

    from cluster_generator_tpu_torch.parallel.mesh import make_mesh

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="init_process_group") as e:
        make_mesh(device_type="cpu")
    assert "world_size=1" in str(e.value)
