"""Command-line entry point: ``python -m tomofastx_tpu_torch -p <Parfile>``.

Counterpart of program_tomofastx (program_tomofastx.F90:25-103), minus MPI
boilerplate: the program is one process that drives one device, or every
slot of a mesh (``--mesh``).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="tomofastx-torch",
        description="Tomofast-x on PyTorch/CUDA: 3-D joint gravity and magnetic inversion",
    )
    parser.add_argument("-p", "--parfile", help="path to the Parfile")
    parser.add_argument(
        "-j", dest="parfile_j", metavar="PARFILE", default=None,
        help="legacy alias for -p (reference: parameters_init.f90:104-119)",
    )
    parser.add_argument(
        "--base-dir", default=".", help="directory that relative Parfile paths resolve against"
    )
    parser.add_argument(
        "--precision",
        choices=("double", "single"),
        default=None,
        help="solver precision (default: single on a CUDA device, double on the CPU)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; cpu only when asked for)",
    )
    parser.add_argument(
        "--mesh", default="0", metavar="N|RxC",
        help="shard the solve over N devices along the cells axis, or over "
        "a 2-D obs x cells mesh given as RxC (e.g. 2x4: data rows over 2, "
        "model columns over 4; 0 = no mesh). On cuda the slots are distinct "
        "cards; on cpu every slot is the CPU",
    )
    parser.add_argument(
        "--profile", default=None, metavar="DIR",
        help="trace the run with torch.profiler (CPU and, on cuda, the device's "
        "kernels) and write it into DIR as a Chrome trace (trace.json), which "
        "holds the program's own ranges too: tomofastx.<phase> (read_inputs, "
        "depth_weight, build, operator, forward_data, solve, outputs, ...), "
        "tomofastx.lsqr.iteration and .lsqr.read, tomofastx.block.<kind>.<matvec|rmatvec>, "
        "tomofastx.sensit.* and tomofastx.wavelet.*",
    )
    parser.add_argument(
        "--debug-nans", action="store_true",
        help="check that each major iteration's costs, LSQR residual and model "
        "updates are finite, stop with FloatingPointError at the first that is "
        "not, and show its traceback",
    )
    parser.add_argument(
        "--fast-build", type=int, default=0, metavar="K",
        help="mixed-precision kernel build: float32 rows with the K cells nearest "
        "each observation recomputed in float64",
    )
    parser.add_argument(
        "--build-precision", choices=["double", "single"], default="double",
        help="kernel build physics precision (default double, the reference's "
        "policy). 'single' is the compensated float32 build: float32 physics "
        "with the far cells by Gauss quadrature (tpu.farFieldQuad)",
    )
    parser.add_argument(
        "--f32-compress", action="store_true",
        help="run the wavelet and threshold of a float64 kernel build in float32 "
        "(tpu.f64BuildF32Compress = 1)",
    )
    parser.add_argument(
        "--fused", type=int, default=0, metavar="M",
        help="run the major loop in on-device chunks of M iterations (on cuda one "
        "CUDA graph a major, LSQR's loop a WHILE node; no host round-trips in between)",
    )
    parser.add_argument(
        "--resume", action="store_true",
        help="resume from <output>/checkpoint.npz (written every "
        "writeModelEveryNiter iterations, by this package or the JAX one): "
        "restores models, ADMM duals, rho and the iteration counter",
    )
    parser.add_argument("-q", "--quiet", action="store_true")
    args = parser.parse_args(argv)
    if args.parfile is None:
        args.parfile = args.parfile_j
    if args.parfile is None:
        parser.error("a Parfile is required (-p/-j)")

    import torch

    from tomofastx_tpu_torch.config.parfile import config_summary, read_parfile
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag
    from tomofastx_tpu_torch.parallel.mesh import make_mesh

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(
            f"ERROR: device {args.device} asked for but no CUDA device is available "
            "(pass --device cpu to run on the CPU)", file=sys.stderr,
        )
        return 1

    mesh = None
    if args.mesh and args.mesh != "0":
        try:
            mesh = make_mesh(args.mesh, device=device.type)
        except ValueError as e:
            print(f"ERROR: --mesh {args.mesh}: {e}", file=sys.stderr)
            return 1

    try:
        cfg = read_parfile(args.parfile)
    except (FileNotFoundError, ValueError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1

    if not args.quiet:
        # Echo all parameters like the reference's rank-0 startup dump
        # (parameters_init.f90:58-88).
        print(config_summary(cfg))

    # Copy the Parfile into the output folder for provenance
    # (parameters_init.f90:144-148). Output paths are relative to the
    # current directory, like the reference binary.
    out_dir = cfg.path_output
    os.makedirs(out_dir, exist_ok=True)
    try:
        shutil.copy(args.parfile, os.path.join(out_dir, "Parfile_run.txt"))
    except shutil.SameFileError:
        pass

    precision = args.precision or ("double" if device.type == "cpu" else "single")
    solve_dtype = torch.float64 if precision == "double" else torch.float32
    compute_dtype = torch.float64 if args.build_precision == "double" else torch.float32
    if args.f32_compress:
        cfg.grav.f64_build_f32_compress = 1
        cfg.magn.f64_build_f32_compress = 1

    profiler = contextlib.nullcontext()
    if args.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
    try:
        with profiler:
            solve_problem_joint_gravmag(
                cfg, base_dir=args.base_dir, solve_dtype=solve_dtype, compute_dtype=compute_dtype,
                verbose=not args.quiet, device=device, mesh=mesh, near_field_f64=args.fast_build,
                resume=args.resume, debug_nans=args.debug_nans, fused_chunk=args.fused,
            )
    except (FileNotFoundError, ValueError, FloatingPointError, NotImplementedError) as e:
        # Clean fail-fast diagnostics, like the reference's exit_MPI banner
        # (mpi_tools.F90:30-54). Re-raise with --debug-nans for tracebacks.
        if args.debug_nans:
            raise
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    print("THE END.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
