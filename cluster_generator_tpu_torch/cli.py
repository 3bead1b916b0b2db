"""Command-line interface of the PyTorch port: the main workflows without
writing a script.

::

    python -m cluster_generator_tpu_torch info
    python -m cluster_generator_tpu_torch build --m200 1.5e15 --conc 4 \
        -o model.h5
    python -m cluster_generator_tpu_torch particles model.h5 -o parts.h5 \
        --dm 1000000 --gas 500000 --star 100000 --r-max 5000
    python -m cluster_generator_tpu_torch ics params.yaml -o merger_parts.h5
    python -m cluster_generator_tpu_torch datagen -n 1024 --dm 50000 \
        --gas 40000 --star 10000 -o catalog.h5
    python -m cluster_generator_tpu_torch mergers -n 256 --dm 60000 \
        --gas 40000 -o mergers.h5
    python -m cluster_generator_tpu_torch verify catalog.h5
    python -m cluster_generator_tpu_torch grid model.h5 -o grid.h5 --dims 512

The subcommands, flags, printed lines, JSON reports and exit codes (2 for
a usage error, 1 for a failed gate) are those of
``python -m cluster_generator_tpu``.  Every subcommand that computes also
takes ``--device`` (default ``cuda``: without a card it raises; pass
``--device cpu`` to run on the CPU).  Each subcommand is a thin shell over
the port's Python API.
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["main"]

_SEED_HELP = (
    "seed: the parameters are drawn by a torch.Generator on --device "
    "seeded with SEED, the particles by batch generators seeded from "
    "(SEED + 1, batch offset), so the two streams never share a seed; "
    "the draws differ from the JAX CLI's for the same SEED (torch's "
    "generators are not threefry) and from one device to another")


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on (default cuda; without "
                   "a card it raises: pass cpu to run on the CPU)")


def _refuse_aot(args):
    """The JAX CLI's ahead-of-time program cache has no counterpart here:
    the port captures its batch programs as CUDA graphs in the process
    (eager on the CPU), and a CUDA graph cannot be saved for another
    process.  Usage error (2) rather than a silently ignored flag."""
    if args.aot_dir is None and not args.prime_aot:
        return False
    print("--aot-dir/--prime-aot: the PyTorch port captures its batch "
          "programs as CUDA graphs in the process at their first call "
          "(on the CPU they run eagerly); a CUDA graph cannot be saved for "
          "another process, so there is nothing to load or prime; drop the "
          "flag", file=sys.stderr)
    return True


def _add_aot(p):
    p.add_argument("--aot-dir", default=None,
                   help="not supported by the PyTorch port (its programs "
                   "are captured in the process): exits 2")
    p.add_argument("--prime-aot", action="store_true",
                   help="not supported by the PyTorch port: exits 2")


def _add_build(sub):
    p = sub.add_parser(
        "build", help="build one equilibrium cluster model -> HDF5",
        description="Build the flagship (M200, conc) cluster: sNFW total "
        "profile, Vikhlinin gas at the observed gas fraction, 2%% stars; "
        "HSE fields + dark-matter distribution function.")
    p.add_argument("--m200", type=float, required=True,
                   help="M200 in Msun, e.g. 1.5e15")
    p.add_argument("--conc", type=float, required=True,
                   help="halo concentration c200, e.g. 4.0")
    p.add_argument("--z", type=float, default=0.1, help="redshift")
    p.add_argument("--fgas", type=float, default=None,
                   help="gas fraction (default: f_gas(M500) relation)")
    p.add_argument("--rmin", type=float, default=0.1)
    p.add_argument("--rmax", type=float, default=10000.0)
    p.add_argument("--num-points", type=int, default=1000)
    p.add_argument("--beta", type=float, default=None,
                   help="also set a magnetic field with this beta")
    p.add_argument("--no-df", action="store_true",
                   help="skip the Eddington inversion")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--overwrite", action="store_true")
    _add_device(p)
    p.set_defaults(fn=_cmd_build)


def _cmd_build(args):
    import torch

    from .core.device import resolve_device
    from .model import ClusterModel
    from .parallel.ensemble import build_one_cluster
    from .virial import VirialEquilibrium

    dev = resolve_device(args.device)
    M200, conc = (torch.tensor([v], dtype=torch.float64, device=dev)
                  for v in (args.m200, args.conc))
    fields = {k: v[0] for k, v in build_one_cluster(
        M200, conc, z=args.z, f_g=args.fgas, rmin=args.rmin, rmax=args.rmax,
        num_points=args.num_points, with_df=not args.no_df).items()}
    # dm_df is not a radial field: it goes into the virial object, so that
    # check_dm_virial reuses it and the writer stores it once, as the
    # top-level dm_df dataset
    dm_df = fields.pop("dm_df", None)
    model = ClusterModel.from_arrays(fields, device=dev)
    if dm_df is not None:
        model._dm_virial = VirialEquilibrium(model, "dark_matter", df=dm_df)
    if args.beta is not None:
        model.set_magnetic_field_from_beta(args.beta)
    print(f"HSE residual: {float(model.check_hse().abs().max()):.3e}")
    if not args.no_df:
        print("virial residual: "
              f"{float(model.check_dm_virial()[1].abs().max()):.3e}")
    model.write_model_to_h5(args.output, overwrite=args.overwrite)
    print(f"wrote {args.output}")
    return 0


def _add_particles(sub):
    p = sub.add_parser(
        "particles", help="sample particles from a model file",
        description="Draw gas/DM/star/tracer particles from a model HDF5 "
        "(written by `build` or the Python API) into a native particle "
        "file, or --gadget for a Gadget/AREPO-style snapshot.")
    p.add_argument("model", help="model HDF5 path")
    p.add_argument("--dm", type=int, default=0)
    p.add_argument("--gas", type=int, default=0)
    p.add_argument("--star", type=int, default=0)
    p.add_argument("--tracer", type=int, default=0)
    p.add_argument("--r-max", type=float, default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="species i (dm, gas, star, tracer) draws from a "
                   "torch.Generator seeded with SEED + i")
    p.add_argument("--compute-potential", action="store_true")
    p.add_argument("--gadget", type=float, metavar="BOX_SIZE", default=None,
                   help="write a Gadget-HDF5 snapshot with this box size "
                   "(kpc); the cluster is placed at the box center")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--overwrite", action="store_true")
    _add_device(p)
    p.set_defaults(fn=_cmd_particles)


def _cmd_particles(args):
    from .model import ClusterModel

    if not (args.dm or args.gas or args.star or args.tracer):
        print("nothing to draw: pass --dm/--gas/--star/--tracer counts",
              file=sys.stderr)
        return 2
    model = ClusterModel.from_h5_file(args.model, device=args.device)
    kw = dict(r_max=args.r_max, compute_potential=args.compute_potential)
    parts = None
    for i, (sp, n) in enumerate((("dm", args.dm), ("gas", args.gas),
                                 ("star", args.star),
                                 ("tracer", args.tracer))):
        if not n:
            continue
        gen = getattr(model, f"generate_{sp}_particles")
        skw = dict(kw) if sp != "tracer" else {"r_max": args.r_max}
        p = gen(n, prng=args.seed + i, **skw)
        parts = p if parts is None else parts + p
    if args.gadget is not None:
        parts.add_offsets([args.gadget / 2.0] * 3, [0.0] * 3)
        parts.write_to_gadget_file(args.output, args.gadget,
                                   overwrite=args.overwrite)
    else:
        parts.write_particles(args.output, overwrite=args.overwrite)
    print(f"wrote {args.output}: {parts.num_particles}")
    return 0


def _add_ics(sub):
    p = sub.add_parser(
        "ics", help="build merger ICs from a YAML param file",
        description="Run ClusterICs.setup_particle_ics on a scene "
        "described by a YAML param file, or hand the scene to a "
        "simulation-code exporter with --code.")
    p.add_argument("params", help="ICs YAML param file")
    p.add_argument("--code", choices=["gamer", "flash", "ramses", "arepo"],
                   default=None, help="run this code's exporter instead "
                   "of writing a particle file")
    p.add_argument("--boxsize", type=float, default=None,
                   help="(arepo) box size in kpc")
    p.add_argument("--nx", type=int, default=64,
                   help="(arepo) background-grid cells per side")
    p.add_argument("-o", "--output", default=None,
                   help="particle output (default <basename>_parts.h5); "
                   "for --code arepo: the IC filename")
    p.add_argument("--overwrite", action="store_true")
    _add_device(p)
    p.set_defaults(fn=_cmd_ics)


def _cmd_ics(args):
    from . import codes
    from .ics import ClusterICs

    if args.code == "arepo" and (args.boxsize is None or args.output is None):
        print("--code arepo needs --boxsize and -o", file=sys.stderr)
        return 2
    ics = ClusterICs.from_file(args.params, device=args.device)
    if args.code is None:
        import os

        out = args.output or f"{ics.basename}_parts.h5"
        # per-halo particle files land next to the output, not in cwd
        parts = ics.setup_particle_ics(
            output_directory=os.path.dirname(out) or ".")
        parts.write_particles(out, overwrite=args.overwrite)
        print(f"wrote {out}: {parts.num_particles}")
        return 0
    if args.code == "arepo":
        codes.setup_arepo_ics(ics, args.boxsize, args.nx, args.output,
                              overwrite=args.overwrite)
    else:
        getattr(codes, f"setup_{args.code}_ics")(ics)
    print(f"{args.code} setup complete")
    return 0


def _add_sharding(p):
    p.add_argument("--rank", type=int, default=None,
                   help="multi-process sharding: this process's rank "
                   "(writes <stem>.<rank>of<nproc>.h5)")
    p.add_argument("--nproc", type=int, default=None,
                   help="multi-process sharding: total process count")


def _add_datagen(sub):
    p = sub.add_parser(
        "datagen", help="ensemble datagen: N clusters -> one HDF5 catalog",
        description="Draw an (M200, conc) ensemble and stream per-cluster "
        "particle draws to a catalog (parallel.ensemble_datagen). "
        "Pass --dm alone for the DM-phase-space product, or any of "
        "--dm/--gas/--star for the full-species product.")
    p.add_argument("-n", "--n-clusters", type=int, required=True)
    p.add_argument("--dm", type=int, default=0)
    p.add_argument("--gas", type=int, default=0)
    p.add_argument("--star", type=int, default=0)
    p.add_argument("--prorate", type=int, metavar="N_TOTAL", default=None,
                   help="instead of explicit counts: split N_TOTAL per "
                   "cluster across species by mass fraction")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--num-points", type=int, default=512)
    p.add_argument("--logm-range", type=float, nargs=2,
                   default=(14.0, 15.3), metavar=("LO", "HI"))
    p.add_argument("--conc-range", type=float, nargs=2, default=(3.0, 8.0),
                   metavar=("LO", "HI"))
    p.add_argument("--seed", type=int, default=0, help=_SEED_HELP)
    p.add_argument("--r-a", type=float, default=None, dest="r_a",
                   help="Osipkov-Merritt anisotropy radius (kpc) for the "
                   "collisionless species; default isotropic")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted run")
    _add_sharding(p)
    p.add_argument("--gravity", default="newtonian",
                   choices=["newtonian", "aqual", "qumond", "emond"],
                   help="gravity law for the equilibrium builds "
                   "(model/gravity.py; recorded in the catalog attrs)")
    _add_aot(p)
    _add_device(p)
    p.set_defaults(fn=_cmd_datagen)


def _param_generator(seed, device):
    import torch

    from .core.device import resolve_device

    dev = resolve_device(device)
    return torch.Generator(device=dev).manual_seed(int(seed)), dev


def _cmd_datagen(args):
    from .parallel.ensemble import (
        ensemble_datagen,
        ensemble_datagen_multihost,
        prorate_species_counts,
        sample_ensemble_params,
    )

    if _refuse_aot(args):
        return 2
    if args.prorate is not None:
        if args.dm or args.gas or args.star:
            print("--prorate and explicit counts are mutually exclusive",
                  file=sys.stderr)
            return 2
        counts = prorate_species_counts(args.prorate,
                                        num_points=args.num_points,
                                        device=args.device)
        print(f"pro-rated counts: {counts}")
    elif args.gas or args.star:
        counts = {"dm": args.dm, "gas": args.gas, "star": args.star}
    elif args.dm:
        counts = args.dm  # int: the DM-phase-space product
    else:
        print("pass --dm/--gas/--star counts or --prorate N",
              file=sys.stderr)
        return 2
    if (args.rank is None) != (args.nproc is None):
        print("--rank and --nproc go together", file=sys.stderr)
        return 2
    gen, dev = _param_generator(args.seed, args.device)
    M200, conc = sample_ensemble_params(
        gen, args.n_clusters, logM_range=tuple(args.logm_range),
        conc_range=tuple(args.conc_range), device=dev)
    kw = dict(batch_size=args.batch_size, num_points=args.num_points,
              seed=args.seed + 1, overwrite=args.overwrite,
              resume=args.resume, anisotropy_radius=args.r_a,
              gravity=args.gravity, device=dev)
    if args.rank is not None:
        out = ensemble_datagen_multihost(M200, conc, args.output, counts,
                                         rank=args.rank, nproc=args.nproc,
                                         **kw)
        print(f"wrote shard {out} ({args.rank} of {args.nproc})")
        return 0
    ensemble_datagen(M200, conc, args.output, counts, **kw)
    print(f"wrote {args.output}: {args.n_clusters} clusters")
    return 0


def _add_mergers(sub):
    p = sub.add_parser(
        "mergers", help="merger-scene datagen: N binary mergers -> catalog",
        description="Draw a binary-merger scene-parameter ensemble "
        "(log-uniform primary mass, uniform ratio/separation/impact/"
        "speed; zero-momentum geometry) and stream full-species merger "
        "ICs to one HDF5 catalog (parallel.merger_datagen).")
    p.add_argument("-n", "--n-scenes", type=int, required=True)
    p.add_argument("--dm", type=int, default=0,
                   help="DM particles per scene (split across halos)")
    p.add_argument("--gas", type=int, default=0)
    p.add_argument("--star", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--num-points", type=int, default=512)
    p.add_argument("--r-max", type=float, default=5000.0,
                   help="per-halo sampling radius (kpc)")
    p.add_argument("--logm-range", type=float, nargs=2,
                   default=(14.2, 15.3), metavar=("LO", "HI"))
    p.add_argument("--ratio-range", type=float, nargs=2, default=(0.2, 1.0),
                   metavar=("LO", "HI"), help="secondary/primary mass ratio")
    p.add_argument("--d-range", type=float, nargs=2,
                   default=(2000.0, 4000.0), metavar=("LO", "HI"),
                   help="separation range (kpc)")
    p.add_argument("--b-frac-range", type=float, nargs=2, default=(0.0, 0.5),
                   metavar=("LO", "HI"),
                   help="impact parameter as a fraction of separation")
    p.add_argument("--v-rel-range", type=float, nargs=2, default=(0.5, 1.5),
                   metavar=("LO", "HI"),
                   help="relative speed range (kpc/Myr)")
    p.add_argument("--conc-range", type=float, nargs=2, default=(3.0, 8.0),
                   metavar=("LO", "HI"),
                   help="clip range for the sampled concentrations")
    p.add_argument("--seed", type=int, default=0, help=_SEED_HELP)
    p.add_argument("--r-a", type=float, default=None, dest="r_a",
                   help="Osipkov-Merritt anisotropy radius (kpc) for the "
                   "collisionless species; default isotropic")
    p.add_argument("--even-split", action="store_true",
                   help="split species counts evenly across halos "
                   "instead of by ensemble-mean mass fraction")
    p.add_argument("--gravity", default="newtonian",
                   choices=["newtonian", "aqual", "qumond", "emond"],
                   help="gravity law for the equilibrium builds "
                   "(model/gravity.py; recorded in the catalog attrs)")
    _add_aot(p)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted run")
    _add_sharding(p)
    _add_device(p)
    p.set_defaults(fn=_cmd_mergers)


def _cmd_mergers(args):
    from .parallel.mergers import (
        merger_datagen,
        merger_datagen_multihost,
        sample_merger_scene_params,
    )

    if _refuse_aot(args):
        return 2
    if not (args.dm or args.gas or args.star):
        print("pass --dm/--gas/--star counts", file=sys.stderr)
        return 2
    if (args.rank is None) != (args.nproc is None):
        print("--rank and --nproc go together", file=sys.stderr)
        return 2
    counts = {"dm": args.dm, "gas": args.gas, "star": args.star}
    gen, dev = _param_generator(args.seed, args.device)
    params = sample_merger_scene_params(
        gen, args.n_scenes, logM_range=tuple(args.logm_range),
        mass_ratio_range=tuple(args.ratio_range),
        d_range=tuple(args.d_range),
        b_frac_range=tuple(args.b_frac_range),
        v_rel_range=tuple(args.v_rel_range),
        conc_range=tuple(args.conc_range), device=dev)
    kw = dict(batch_size=args.batch_size, num_points=args.num_points,
              r_max=args.r_max, seed=args.seed + 1,
              overwrite=args.overwrite, resume=args.resume,
              anisotropy_radius=args.r_a, prorate=not args.even_split,
              gravity=args.gravity, device=dev)
    if args.rank is not None:
        out = merger_datagen_multihost(params, args.output, counts,
                                       rank=args.rank, nproc=args.nproc,
                                       **kw)
        print(f"wrote shard {out} ({args.rank} of {args.nproc})")
        return 0
    merger_datagen(params, args.output, counts, **kw)
    print(f"wrote {args.output}: {args.n_scenes} scenes")
    return 0


def _add_catalog(sub):
    p = sub.add_parser(
        "catalog", help="inspect a datagen catalog",
        description="Print a catalog's recorded config, completeness, "
        "and per-cluster dataset shapes as JSON.")
    p.add_argument("catalog", nargs="+",
                   help="catalog file (or a multihost shard list)")
    p.set_defaults(fn=_cmd_catalog)


def _attr(v):
    import numpy as np

    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.generic):
        return v.item()
    return v


def _cmd_catalog(args):
    import os

    import h5py

    info = {"files": []}
    total_groups = 0
    for fn in args.catalog:
        with h5py.File(fn, "r") as f:
            attrs = {k: _attr(v) for k, v in f.attrs.items()}
            groups = [k for k in f if k.startswith(("cluster_", "scene_"))]
            total_groups += len(groups)
            entry = {"file": fn,
                     "size_bytes": os.path.getsize(fn),
                     "n_cluster_groups": len(groups),
                     "attrs": attrs}
            if groups:
                g = f[groups[0]]
                entry["datasets"] = {k: [list(g[k].shape), str(g[k].dtype)]
                                     for k in g}
            info["files"].append(entry)
    n_cl = info["files"][0]["attrs"].get("n_clusters")
    info["n_clusters"] = n_cl
    info["groups_present"] = total_groups
    info["complete"] = all(e["attrs"].get("complete", False)
                           for e in info["files"])
    # a plain catalog must carry every group; a shard set must supply
    # EVERY rank 0..shard_count-1 (a lost shard would otherwise pass with
    # part of the clusters), and then the union must cover n_clusters
    shard_count = max(int(e["attrs"].get("shard_count", 1))
                      for e in info["files"])
    missing_ranks = []
    if shard_count > 1:
        ranks = {int(e["attrs"].get("shard_rank", -1))
                 for e in info["files"]}
        missing_ranks = sorted(set(range(shard_count)) - ranks)
        info["missing_shard_ranks"] = missing_ranks
    print(json.dumps(info, indent=2, default=str))
    if not info["complete"] or missing_ranks:
        return 1
    if n_cl is not None and total_groups < int(n_cl):
        return 1
    return 0


def _add_verify(sub):
    p = sub.add_parser(
        "verify", help="physics QA gate for a datagen catalog",
        description="Rebuild each cluster's equilibrium model and check "
        "the stored draws against it (parallel.verify_catalog). Exits "
        "non-zero on violations.")
    p.add_argument("catalog", nargs="+",
                   help="catalog file (or a multihost shard list)")
    p.add_argument("--indices", type=int, nargs="+", default=None,
                   help="cluster indices to check (default: all); a bare "
                   "--indices is rejected rather than vacuously passing "
                   "zero clusters")
    _add_device(p)
    p.set_defaults(fn=_cmd_verify)


def _cmd_verify(args):
    from .parallel.ensemble import verify_catalog

    fn = args.catalog[0] if len(args.catalog) == 1 else args.catalog
    report = verify_catalog(fn, indices=args.indices, strict=False,
                            device=args.device)
    print(json.dumps(report, indent=2, default=float))
    return 1 if report["violations"] else 0


def _add_grid(sub):
    p = sub.add_parser(
        "grid", help="model -> chunked uniform-grid HDF5 (yt-loadable)",
        description="Paint a model file onto the chunked 3D grid dataset "
        "the yt frontend reads (ClusterModel.create_dataset).")
    p.add_argument("model", help="model HDF5 path")
    p.add_argument("--dims", type=int, default=512,
                   help="cells per side")
    p.add_argument("--chunksize", type=int, default=64)
    p.add_argument("--dtype", choices=["f8", "f4"], default="f8")
    p.add_argument("--engine", choices=["device", "native"],
                   default="device",
                   help="device: paint on --device; native: the host C++ "
                   "painter (native/cg_native.cpp, built at first use; "
                   "raises when it cannot be built)")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--overwrite", action="store_true")
    _add_device(p)
    p.set_defaults(fn=_cmd_grid)


def _cmd_grid(args):
    from .model import ClusterModel

    model = ClusterModel.from_h5_file(args.model, device=args.device)
    out = model.create_dataset(args.output,
                               domain_dimensions=(args.dims,) * 3,
                               chunksize=args.chunksize, dtype=args.dtype,
                               engine=args.engine,
                               overwrite=args.overwrite)
    print(f"wrote {out}")
    return 0


def _cmd_info(args):
    import torch

    from . import __version__
    from .profiles import library

    print(f"cluster_generator_tpu_torch {__version__}")
    cuda = torch.cuda.is_available()
    n = torch.cuda.device_count() if cuda else 0
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"backend={'cuda' if cuda else 'cpu'}  devices={n}")
    names = [torch.cuda.get_device_name(i) for i in range(n)]
    for name in dict.fromkeys(names):
        print(f"device {name} x{names.count(name)}")
    n_prof = len([k for k in vars(library) if k.endswith("_profile")])
    print(f"{n_prof} registered radial profiles; "
          "exporters: gamer flash ramses arepo gadget ythdf5")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m cluster_generator_tpu_torch",
        description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("info", help="versions, backend, devices") \
       .set_defaults(fn=_cmd_info)
    _add_build(sub)
    _add_particles(sub)
    _add_ics(sub)
    _add_datagen(sub)
    _add_mergers(sub)
    _add_catalog(sub)
    _add_verify(sub)
    _add_grid(sub)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
