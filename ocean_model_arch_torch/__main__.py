"""Command line: ``python -m ocean_model_arch_torch [config_dir] [overrides]``
(counterpart of ``ocean_model_arch_tpu/__main__.py``).

Mirrors the reference's invocation (./model with basin.par/sw.par/
parallel.par/ocean_run.par in the working directory + positional CLI
overrides, configs/cmd.f90). The run is on the CUDA device unless
``--device cpu`` asks for the CPU: without a card and without that
option it raises.

N processes run one model over a mesh that spans them
(``parallel/multihost.py``): launch them under ``python -m
torch.distributed.run --nproc-per-node N -m ocean_model_arch_torch
...`` (torchrun's environment names the rank, the world and the
rendezvous), or start each with ``--rank r --world-size N --init-method
tcp://host:port`` (or ``file:///path``). ``--backend`` picks the
transport: ``nccl`` (a card a process) or ``gloo`` (the CPU, or
processes sharing one card).
"""

import argparse
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="ocean_model_arch_torch",
        description="shallow-water ocean model, PyTorch + CUDA")
    p.add_argument("config_dir", nargs="?", default=".",
                   help="directory with basin.par/sw.par/parallel.par/"
                        "ocean_run.par")
    p.add_argument("overrides", nargs="*",
                   help="positional overrides: mod_decomposition bppnx bppny")
    p.add_argument("--mesh", default=None,
                   help="shard mesh as PXxPY (e.g. 2x2), or 'auto' to "
                        "pick the wet-balance-optimal factorization of "
                        "the world's devices, one a process "
                        "(choose_mesh_dims)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--ckpt-format", choices=("npz", "orbax"),
                   default="npz",
                   help="npz = one gathered file; orbax = a per-shard "
                        "directory, every process writing its own shards "
                        "(the port's format, not orbax)")
    p.add_argument("--f32", action="store_true",
                   help="f32 production precision (default: f64 validation)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device of the run (default: the current "
                        "CUDA device, under nccl the process's own card; "
                        "'cpu' runs the kernels' plain versions)")
    p.add_argument("--rank", type=int, default=None,
                   help="this process's rank (default: torchrun's RANK)")
    p.add_argument("--world-size", type=int, default=None,
                   help="the number of processes (default: torchrun's "
                        "WORLD_SIZE, else 1)")
    p.add_argument("--init-method", default=None,
                   help="tcp://host:port or file:///path (default: "
                        "torchrun's MASTER_ADDR:MASTER_PORT)")
    p.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                   help="the transport between processes (required with "
                        "more than one): nccl (a card a process) or gloo "
                        "(the CPU, or processes sharing a card)")
    args = p.parse_args(argv)

    import dataclasses

    import torch

    from .config import Precision
    from .host import default_device
    from .model.model import OceanModel, load_config_dir
    from .parallel import multihost

    world = (args.world_size if args.world_size is not None
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world > 1:
        if args.backend is None:
            raise SystemExit("more than one process: name the transport "
                             "with --backend gloo or --backend nccl")
        device = multihost.initialize(args.init_method, world, args.rank,
                                      backend=args.backend,
                                      device=args.device)
    else:
        # before any file is read: no card and no --device cpu is an error
        device = torch.device(args.device if args.device
                              else default_device())

    cfg = load_config_dir(args.config_dir, args.overrides)
    if args.f32:
        cfg = dataclasses.replace(cfg, precision=Precision.f32())
    if args.mesh == "auto":
        from .io.mask_io import load_mask
        from .parallel.decomposition import choose_mesh_dims
        int_mask = load_mask(cfg.basin.mask_file_name, cfg.basin.nx,
                             cfg.basin.ny, args.config_dir)
        # one device a process: the world's devices are its processes
        n_dev = multihost.process_count()
        px, py = choose_mesh_dims(int_mask, n_dev)
        print(f"MODEL: auto mesh {px}x{py} "
              f"(wet-balance-optimal for {n_dev} devices)")
        cfg = dataclasses.replace(
            cfg, parallel=dataclasses.replace(cfg.parallel,
                                              mesh_x=px, mesh_y=py))
    elif args.mesh:
        px, py = (int(v) for v in args.mesh.lower().split("x"))
        cfg = dataclasses.replace(
            cfg, parallel=dataclasses.replace(cfg.parallel,
                                              mesh_x=px, mesh_y=py))

    try:
        model = OceanModel(cfg, base_dir=args.config_dir, device=device)
        model.run(checkpoint_path=args.checkpoint, verbose=not args.quiet,
                  checkpoint_format=args.ckpt_format)
    finally:
        if world > 1:
            multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
