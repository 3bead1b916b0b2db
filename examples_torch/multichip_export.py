"""Multi-device merger IC end to end: sharded draws -> per-rank Gadget export.

Every particle array stays sharded along the mesh's 'part' axis from the
draw to the disk: each rank samples its share from its own generator
(seeded by ``fold_in(seed, rank)``), and writes only its shard as one file
of a standard multi-file Gadget snapshot.  One process per rank, started
by ``torchrun``:

    torchrun --nproc-per-node 4 examples_torch/multichip_export.py
    torchrun --nproc-per-node 4 examples_torch/multichip_export.py --device cpu

The script joins the world itself, from torchrun's ``RANK`` /
``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``: NCCL with one card per
rank on ``cuda``, gloo on ``--device cpu``.
"""

import argparse
import os

import torch
import torch.distributed as dist

from cluster_generator_tpu_torch.parallel import make_mesh
from cluster_generator_tpu_torch.parallel.export import (
    write_sharded_gadget_files,
)
from cluster_generator_tpu_torch.particles import ClusterParticles
from cluster_generator_tpu_torch.pipeline import (
    build_merger_models,
    build_radius_tables,
    build_speed_tables,
    sample_merger_ic_sharded,
)

ap = argparse.ArgumentParser(description="sharded merger IC export")
ap.add_argument("--device", default="cuda", help="torch device type")
DEV = ap.parse_args().device

rank, n_dev = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
if DEV == "cuda":
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
dist.init_process_group("nccl" if DEV == "cuda" else "gloo", rank=rank,
                        world_size=n_dev)
mesh = make_mesh(n_part=n_dev, device_type=DEV)

SCALE = float(os.environ.get("CG_EXAMPLE_SCALE", "1"))
M200 = [1.5e15, 1.0e15]
conc = [4.0, 5.0]
centers = [[-1500.0, 0, 0], [1500.0, 0, 0]]
velocities = [[0.3, 0, 0], [-0.45, 0, 0]]
r_max = [3000.0, 3000.0]

fields = build_merger_models(M200, conc, num_points=512, device=DEV)
tables = build_speed_tables(fields)
tables["radius"] = build_radius_tables(fields, r_max)

per = max(n_dev, int(2_000_000 / SCALE) // n_dev * n_dev)
per_star = max(n_dev, per // 4 // n_dev * n_dev)  # must divide the mesh too
parts = sample_merger_ic_sharded(
    mesh, fields, tables, centers, velocities, r_max, 11,
    n_gas=(per, per), n_dm=(per, per), n_star=(per_star, per_star))

box = 14_000.0
mine = write_sharded_gadget_files(parts, box, "merger_ic",
                                  center_offset=[box / 2] * 3)
everyone = [None] * n_dev   # also waits until every shard is on disk
dist.all_gather_object(everyone, [str(fn) for fn in mine])
files = sorted((fn for fns in everyone for fn in fns),
               key=lambda fn: int(fn.rsplit(".", 2)[-2]))
if rank == 0:
    print(f"wrote {len(files)} Gadget shard files "
          f"({2 * per:,} gas + {2 * per:,} dm + {2 * per_star:,} star "
          "particles)")
    back = ClusterParticles.from_gadget_files(files[0], device=DEV)
    print("reassembled:", back)
    assert back.num_particles["dm"] == 2 * per
dist.destroy_process_group()
