#!/usr/bin/env python3
"""Where the PyTorch port's kernel build, cache files and packing spend their time.

    python3 scripts/profile_torch_build.py [--rows 1024] [--device cuda]

Builds the first `--rows` observations of the full-width smoke problem
(262144 cells, Haar rate 0.15; see chip_smoke.py) and prints one JSON line
with wall seconds, each taken after a device synchronise:

- build: time inside the row sink (the cache writer on the host) against the
  time between sink calls (row physics, wavelet, threshold on the device, and
  the copy of the chunk to the host);
- pack: reading the cache's records on the host alone, against the whole of
  tile_kernel_from_cache (read + copy to the device + scan + scatter);
- the dense format's pieces on the same rows: the build that accumulates on the
  device, write_kernel_cache, try_read_kernel_cache, read_kernel_cache_packed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.io import data_io, model_io
    from tomofastx_tpu_torch.io.sensit_cache import (
        SensitStreamWriter,
        iter_cache_rows,
        read_cache_meta,
        read_kernel_cache_packed,
        try_read_kernel_cache,
        write_kernel_cache,
    )
    from tomofastx_tpu_torch.ops import sensitivity as sens
    from tomofastx_tpu_torch.ops.tile_kernel import tile_kernel_from_cache

    device = torch.device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    work = tempfile.mkdtemp(prefix="tomofastx_profile_")
    try:
        inputs = chip_smoke.write_inputs(work, 64, 64, 64, 64)
        parfile = chip_smoke.write_parfile(work, "Parfile.txt", inputs, os.path.join(work, "out"), 20)
        cfg = read_parfile(parfile)
        par = cfg.grav
        t0 = time.time()
        grid = model_io.read_model_grid(par.model_grid_file, par.nx, par.ny, par.nz)
        data = data_io.read_data_points(par.data_grid_file, par.ndata, grid_only=True)
        read_s = time.time() - t0

        t0 = time.time()
        cw = cfg.inversion.column_weight_multiplier[0] * sens.calculate_depth_weight(
            par, grid, data, torch.float64, device
        )
        sync()
        depth_weight_s = time.time() - t0

        # Only the first rows: the rest of the survey costs the same per row.
        par.ndata = args.rows
        data = type(data)(ndata=args.rows, X=data.X[: args.rows], Y=data.Y[: args.rows], Z=data.Z[: args.rows])
        cache = os.path.join(work, "SENSIT")
        writer = SensitStreamWriter(cache, par, grid, cw, par.compression_type)
        in_sink, chunks = [0.0], [0]

        def sink(chunk, start):
            t = time.time()
            writer.write_chunk(chunk, start)
            in_sink[0] += time.time() - t
            chunks[0] += 1

        t0 = time.time()
        k = sens.compute_sensitivity(par, grid, data, cw, row_sink=sink, device=device)
        sync()
        build_s = time.time() - t0
        writer.finalize(k.comp_error)

        t0 = time.time()
        meta = read_cache_meta(cache, par, grid)
        n = sum(c.size for _, _, _, c, _ in iter_cache_rows(cache, meta))
        read_cache_s = time.time() - t0
        t0 = time.time()
        tk, meta = tile_kernel_from_cache(cache, par, grid, device)
        sync()
        pack_s = time.time() - t0

        def timed(fn):
            t = time.time()
            out = fn()
            sync()
            return out, time.time() - t

        dense, dense_build_s = timed(lambda: sens.compute_sensitivity(par, grid, data, cw, device=device))
        cache2 = os.path.join(work, "SENSIT_dense")
        _, cache_write_s = timed(lambda: write_kernel_cache(cache2, par, dense, cw))
        del dense
        _, dense_read_s = timed(lambda: try_read_kernel_cache(cache2, par, grid, device))
        (pk, _), packed_read_s = timed(lambda: read_kernel_cache_packed(cache2, par, grid, device=device))

        smi = ""
        if device.type == "cuda":
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True,
            ).stdout.strip()
        print(json.dumps({
            "device": str(device), "card": smi, "rows": args.rows, "cells": grid.nelements_total,
            "chunks": chunks[0], "nnz": int(n),
            "read_inputs_s": read_s, "depth_weight_s": depth_weight_s,
            "build_s": build_s, "build_in_sink_s": in_sink[0], "build_outside_sink_s": build_s - in_sink[0],
            "build_rows_per_s": args.rows / build_s,
            "pack_s": pack_s, "pack_read_cache_once_s": read_cache_s,
            "pack_shapes": [list(tk.uvals.shape), list(tk.uvalsT.shape)],
            "dense_build_s": dense_build_s, "dense_cache_write_s": cache_write_s,
            "dense_cache_read_s": dense_read_s, "packed_cache_read_s": packed_read_s,
            "packed_shapes": [list(pk.row_vals.shape), list(pk.dense_block.shape), list(pk.light_vals.shape)],
        }))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
