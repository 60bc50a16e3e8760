"""Weak-scaling harness: grid-points/s/device over an N-device mesh.

Measures the BASELINE.json north-star (≥80% weak-scaling efficiency
1 chip → N): the per-device problem size is fixed while the mesh grows.
On this environment only one real chip exists, so `--virtual N` runs the
same harness over N virtual CPU devices — validating the sharded execution
path and the scaling *methodology*; absolute numbers need a real pod slice.

Prints one JSON line per mesh size with points/s/device and efficiency
relative to the single-device run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--per-device", default="128x128x64",
                   help="per-device horizontal tile (weak scaling)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--virtual", type=int, default=0,
                   help="use N virtual CPU devices instead of real chips")
    p.add_argument("--path", choices=("gspmd", "shard_map"),
                   default="shard_map",
                   help="execution path: GSPMD partitioner or explicit "
                        "shard_map collectives (1-D x pencil)")
    p.add_argument("--out", default=None, help="write the curve to this JSON file")
    p.add_argument("--collective-share", action="store_true",
                   help="ALSO time each mesh size with ppermute/all-to-all "
                        "replaced by local wraps (BREEZE_TPU_LOCAL_HALO_"
                        "TIMING) and report the collective share of the "
                        "step (shard_map path only; wrong numerics in the "
                        "timing variant)")
    args = p.parse_args()

    if args.virtual:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.virtual}")

    import jax
    import jax.numpy as jnp

    import breeze_tpu as bz
    from breeze_tpu.parallel.mesh import (device_put_replicated_model,
                                          device_put_sharded_state, factor_mesh,
                                          make_mesh, shard_step)
    from breeze_tpu.timesteppers import ssp_rk3_step

    devices = jax.devices()
    px0, py0 = (int(s) for s in [1, 1])
    nx0, ny0, nz = (int(s) for s in args.per_device.split("x"))

    results = []
    n_avail = len(devices)
    mesh_sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]

    base_rate = None
    for n_dev in mesh_sizes:
        if args.path == "shard_map":
            px, py = n_dev, 1     # 1-D x pencil decomposition
        else:
            px, py = factor_mesh(n_dev)
        nx, ny = nx0 * px, ny0 * py
        if args.path == "shard_map":
            # pencil divisibility: px | nz and px | ny
            ny = max(ny, px) if ny % px else ny
            if nz % px or ny % px:
                print(json.dumps({"devices": n_dev,
                                  "skipped": f"px={px} must divide nz={nz}, ny={ny}"}))
                continue
        grid = bz.make_grid(size=(nx, ny, nz),
                            extent=(50.0 * nx, 50.0 * ny, 3200.0),
                            topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                            halo=3, dtype=jnp.float32)
        model = bz.make_model(grid, advection=bz.WENO(5),
                              potential_temperature=300.0)
        state = bz.initial_state(model, theta=lambda x, y, z: 300.0
                                 + 0.5 * jnp.sin(2 * jnp.pi * x / grid.Lx))
        if args.path == "shard_map":
            from breeze_tpu.parallel.shard_step import (make_shard_map_step,
                                                        make_x_mesh)
            mesh = make_x_mesh(n_dev)
            sm_step = make_shard_map_step(model, mesh)
            step = lambda _m, s, dt: sm_step(s, dt)
            model_s, state_s = model, state
        else:
            mesh = make_mesh(devices[:n_dev], (px, py))
            model_s = device_put_replicated_model(mesh, model)
            state_s = device_put_sharded_state(mesh, state)
            step = shard_step(lambda m, s, dt: ssp_rk3_step(m, s, dt), mesh,
                              model_s, state_s, donate=False)

        def time_step(step_fn):
            jax.block_until_ready(step_fn(model_s, state_s, 0.5))
            t0 = time.perf_counter()
            cur = state_s
            for _ in range(args.steps):
                cur = step_fn(model_s, cur, 0.5)
            jax.block_until_ready(cur)
            return (time.perf_counter() - t0) / args.steps

        dt_step = time_step(step)

        collective_share = None
        if args.collective_share and args.path == "shard_map" and n_dev > 1:
            # Re-trace with every ppermute/all-to-all replaced by a local
            # wrap of identical shape (parallel.halo._local_halo_timing) —
            # same local compute + DMA, zero collectives.  The delta is the
            # non-overlapped collective time per step.
            os.environ["BREEZE_TPU_LOCAL_HALO_TIMING"] = "1"
            try:
                sm_local = make_shard_map_step(model, mesh)
                dt_local = time_step(lambda _m, s, dt: sm_local(s, dt))
            finally:
                del os.environ["BREEZE_TPU_LOCAL_HALO_TIMING"]
            collective_share = max(0.0, 1.0 - dt_local / dt_step)

        rate = nx * ny * nz / dt_step
        per_dev = rate / n_dev
        if base_rate is None:
            base_rate = per_dev
        row = {
            "devices": n_dev, "mesh": [px, py], "path": args.path,
            "global_size": f"{nx}x{ny}x{nz}",
            "points_per_second": round(rate, 1),
            "points_per_second_per_device": round(per_dev, 1),
            "weak_scaling_efficiency": round(per_dev / base_rate, 4),
        }
        if collective_share is not None:
            row["collective_share"] = round(collective_share, 4)
        if args.virtual:
            # virtual CPU devices share one host's memory bus — neither the
            # absolute rate nor the collective share predicts a real
            # device interconnect
            row["indicative"] = False
        results.append(row)
        print(json.dumps(results[-1]))

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"path": args.path, "virtual": args.virtual,
                       "indicative": not args.virtual,
                       "note": ("virtual CPU mesh: methodology validation "
                                "only, timing not indicative of a real "
                                "device interconnect"
                                if args.virtual else
                                "real device mesh"),
                       "per_device_tile": args.per_device,
                       "steps": args.steps, "curve": results}, f, indent=1)

    return 0


if __name__ == "__main__":
    sys.exit(main())
