"""One step of the whole sharded pipeline over a device mesh, at small sizes.

:func:`dryrun_step` runs, on every rank of an ``(ens, part)`` mesh:

1. an ens-sharded cluster build with DFs (:func:`~.ensemble.build_ensemble`
   on the rank's rows) and its global sum;
2. the merger draws sharded over ``part``
   (:func:`~..pipeline.sample_merger_ic_sharded`);
3. a cross-mesh reduction of the sharded outputs;
4. the sharded Gadget export (:mod:`.export`): the files where ``h5py`` is
   present, else the blocks each file would hold;
5. the full-species datagen batch (cfg5c) and the merger-scene batch (cfg6)
   over ``ens``;
6. the slab-sharded random field through the pencil FFT, with its rms and
   divergence checks.

:func:`dryrun_multichip` provisions its own world: ``n`` processes on the
CPU joined by gloo through a file store in a temporary directory.  Callers
with cards start their own process groups and call :func:`dryrun_step`.
"""

from __future__ import annotations

import math
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["dryrun_step", "dryrun_multichip", "grf_checks"]

NUM_POINTS = 64


def _check(cond, what):
    if not cond:
        raise RuntimeError(f"dry run: {what}")


def grf_checks(gx, gy, gz, delta):
    """``(rms, divergence ratio)`` of a whole field (tensors): the rms of
    |g|, and the largest central-difference divergence over mean|gx| /
    delta, which a divergence-cleaned field keeps at roundoff."""
    rms = math.sqrt(float((gx.square() + gy.square() + gz.square())
                          .sum(dtype=torch.float64)) / gx.numel())
    div = ((torch.roll(gx, -1, 0) - torch.roll(gx, 1, 0))
           + (torch.roll(gy, -1, 1) - torch.roll(gy, 1, 1))
           + (torch.roll(gz, -1, 2) - torch.roll(gz, 1, 2))) / (2.0 * delta)
    scale = float(gx.abs().mean(dtype=torch.float64)) / delta
    return rms, float(div.abs().max()) / scale


def _sum_over(t, group):
    s = t.sum(dtype=torch.float64).reshape(1)
    dist.all_reduce(s, group=group)
    return float(s)


def dryrun_step(mesh, workdir=None):
    """The six steps on this rank of ``mesh``; raises on the first failed
    check.  ``workdir``: a directory every rank sees, for the Gadget files
    (None, or no ``h5py``: the blocks are built and checked instead).
    Returns this rank's ``{step: seconds}``."""
    from ..pipeline import (build_merger_models, build_radius_tables,
                            build_speed_tables, sample_merger_ic_sharded)
    from .ensemble import _datagen_full_batch_fn, _mesh_call, build_ensemble
    from .export import _export_plan, write_sharded_gadget_files
    from .fields import sharded_gaussian_random_field
    from .mergers import (_merger_batch_fn, binary_scene_geometry,
                          sample_merger_scene_params)
    from .mesh import all_gather_rows, ens_rows, mesh_device

    dev = mesh_device(mesh)
    n_ens = mesh.size(0)
    n_part = mesh.size(1)
    seconds = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        seconds[name] = t - t0
        t0 = t

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # 1) ensemble axis: one cluster batch, each rank its ens rows
    n_clusters = 2 * n_ens
    M200 = torch.linspace(8.0e14, 2.0e15, n_clusters, dtype=torch.float64,
                          device=dev)
    conc = torch.linspace(4.0, 6.0, n_clusters, dtype=torch.float64,
                          device=dev)
    lo, hi = ens_rows(mesh, n_clusters)
    ens_fields = build_ensemble(M200[lo:hi], conc[lo:hi],
                                num_points=NUM_POINTS, with_df=True,
                                device=dev)
    ens_sum = _sum_over(ens_fields["dm_df"], mesh.get_group("ens"))
    _check(math.isfinite(ens_sum), f"ensemble DF sum {ens_sum}")
    lap("ensemble")

    # 2) particle axis: the sharded merger draw
    M2 = torch.tensor([1.5e15, 1.0e15], dtype=torch.float64, device=dev)
    c2 = torch.tensor([4.0, 5.0], dtype=torch.float64, device=dev)
    centers = [[-500.0, 0.0, 0.0], [500.0, 0.0, 0.0]]
    vels = [[0.1, 0.0, 0.0], [-0.1, 0.0, 0.0]]
    rmax = [3000.0, 3000.0]
    fields = build_merger_models(M2, c2, num_points=NUM_POINTS, device=dev)
    tables = build_speed_tables(fields)
    tables["radius"] = build_radius_tables(fields, rmax)
    per = 64 * n_part
    parts = sample_merger_ic_sharded(mesh, fields, tables, centers, vels,
                                     rmax, 0, (per, per), (per, per),
                                     (per, per), axis="part")
    lap("merger_draw")

    # 3) cross-mesh reduction over the sharded outputs
    total = sum(_sum_over(v.to_local(), mesh.get_group("part"))
                for v in parts.values())
    _check(math.isfinite(total), f"particle sum {total}")
    lap("reduction")

    # 4) sharded export: one Gadget file per particle shard
    box = 8000.0
    try:
        import h5py  # noqa: F401
    except ImportError:
        workdir = None
    if workdir is not None:
        from ..particles import ClusterParticles

        base = os.path.join(workdir, "ic")
        write_sharded_gadget_files(parts, box, base,
                                   center_offset=[box / 2] * 3,
                                   overwrite=True)
        dist.barrier()
        files = [f for f in os.listdir(workdir) if f.startswith("ic.")]
        _check(len(files) == n_part, f"{len(files)} files for {n_part}")
        re = ClusterParticles.from_gadget_files(base + ".0.h5", device=dev)
        _check(re.num_particles["dm"] == 2 * per, re.num_particles)
    else:
        n_files, npart_total, plan = _export_plan(parts, box, [box / 2] * 3)
        _check(n_files == n_part and int(npart_total[1]) == 2 * per,
               f"{n_files} files, totals {npart_total}")
        for _, sp, id_offset, expect in plan:
            _, counts, _ = sp.gadget_blocks(box, id_offset=id_offset)
            _check(counts == expect, f"blocks {counts} != {expect}")
    lap("export")

    # 5) the cfg5c datagen batch and the cfg6 scene batch over 'ens'
    full_fn = _datagen_full_batch_fn(NUM_POINTS, 32, 24, 8, n_rows=32, rq=64,
                                     star_n_rows=16, star_rq=32,
                                     star_n_s=64, star_n_q=64)
    out, _ = _mesh_call(full_fn, mesh, (M200, conc), (), gen(4))
    for sp in ("dm", "gas", "star"):
        _check(all(bool(torch.isfinite(a).all()) for a in out[sp]), sp)
    _check(tuple(out["dm"][0].shape) == (hi - lo, 32, 3),
           f"datagen rows {tuple(out['dm'][0].shape)}")
    mp = sample_merger_scene_params(gen(9), n_clusters, device=dev)
    mctr, mvel = binary_scene_geometry(mp["M200"], mp["d"], mp["b"],
                                       mp["v_rel"])
    merger_fn = _merger_batch_fn(NUM_POINTS, (12, 12), (16, 16), (4, 4),
                                 device=dev)
    as_dev = [torch.as_tensor(np.asarray(a), dtype=torch.float64, device=dev)
              for a in (mctr, mvel)]
    mout, _ = _mesh_call(merger_fn, mesh,
                         (mp["M200"], mp["conc"], *as_dev),
                         (torch.tensor([3000.0, 3000.0], dtype=torch.float64,
                                       device=dev),), gen(5))
    _check(tuple(mout["dm_position"].shape) == (hi - lo, 32, 3),
           f"scene rows {tuple(mout['dm_position'].shape)}")
    for k, v in mout.items():
        _check(bool(torch.isfinite(v).all()), k)
    lap("datagen")

    # 6) grid axis: the slab-sharded field through the pencil FFT
    n_grid = 4 * n_ens
    g = sharded_gaussian_random_field(1, (n_grid,) * 3, (10.0,) * 3, 20.0,
                                      80.0, mesh, g_rms=1.0)
    whole = [all_gather_rows(mesh, c.to_local()) for c in g]
    rms, div = grf_checks(*whole, 10.0)
    _check(abs(rms - 1.0) < 1e-4, f"field rms {rms}")
    _check(div < 1e-4, f"divergence not cleaned ({div})")
    lap("grf")
    return seconds


def _cpu_rank(rank, n, store, workdir):
    """One rank of :func:`dryrun_multichip`: a gloo process on the CPU."""
    from .mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=n)
    try:
        n_part = 2 if n % 2 == 0 else 1
        dryrun_step(make_mesh(n // n_part, n_part, device_type="cpu"),
                    workdir)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> None:
    """One step of the sharded pipeline (:func:`dryrun_step`) over an
    ``(n/2, 2)`` mesh (``(n, 1)`` for odd n) of ``n_devices`` gloo
    processes on the CPU, which it starts itself; raises if any rank
    fails or the run outlasts ``timeout`` seconds."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as td:
        ctx = mp.start_processes(
            _cpu_rank, args=(n_devices, os.path.join(td, "store"), td),
            nprocs=n_devices, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"dry run over {n_devices} ranks "
                                       f"outlasted {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
