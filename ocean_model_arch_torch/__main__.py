"""Command line: ``python -m ocean_model_arch_torch [config_dir] [overrides]``
(counterpart of ``ocean_model_arch_tpu/__main__.py``).

Mirrors the reference's invocation (./model with basin.par/sw.par/
parallel.par/ocean_run.par in the working directory + positional CLI
overrides, configs/cmd.f90). The run is on the CUDA device unless
``--device cpu`` asks for the CPU: without a card and without that
option it raises.
"""

import argparse
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
                        "all visible CUDA devices (choose_mesh_dims)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--ckpt-format", choices=("npz", "orbax"),
                   default="npz",
                   help="npz = one file; orbax (per-shard directory) is "
                        "not ported")
    p.add_argument("--f32", action="store_true",
                   help="f32 production precision (default: f64 validation)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device of the run (default: the current "
                        "CUDA device; 'cpu' runs the kernels' plain "
                        "versions)")
    args = p.parse_args(argv)

    import dataclasses

    import torch

    from .config import Precision
    from .host import default_device
    from .model.model import OceanModel, load_config_dir

    # before any file is read: no card and no --device cpu is an error
    device = torch.device(args.device if args.device else default_device())

    cfg = load_config_dir(args.config_dir, args.overrides)
    if args.f32:
        cfg = dataclasses.replace(cfg, precision=Precision.f32())
    if args.mesh == "auto":
        from .io.mask_io import load_mask
        from .parallel.decomposition import choose_mesh_dims
        int_mask = load_mask(cfg.basin.mask_file_name, cfg.basin.nx,
                             cfg.basin.ny, args.config_dir)
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
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

    model = OceanModel(cfg, base_dir=args.config_dir, device=device)
    model.run(checkpoint_path=args.checkpoint, verbose=not args.quiet,
              checkpoint_format=args.ckpt_format)
    return 0


if __name__ == "__main__":
    sys.exit(main())
