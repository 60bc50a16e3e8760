"""Benchmark: LES throughput in grid points per second on one device.

Cases (built by :mod:`breeze_tpu.cases`):

- ``--case bomex`` (default): 256³ BOMEX moist LES — saturation adjustment,
  Smagorinsky-Lilly, prescribed surface fluxes, geostrophic + subsidence +
  drying + sponge forcings, WENO5, float32 (reference
  ``benchmarking/README.md:193-208`` defines the harness;
  ``examples/bomex.jl`` the physics).
- ``--case bubble``: 256×256×128 thermal bubble in the reference's CBL
  domain; ``--dynamics compressible`` runs it on the split-explicit core
  (``--substep-floattype bfloat16`` for reduced-precision acoustic carries,
  ``--terrain`` over a Schär-type ridge).

Warm-up chunks, then timed chunks of 10 steps each, synchronised with
``jax.block_until_ready``; metric = Nx·Ny·Nz / time per step
(``benchmarking/src/result.jl:18-20``).

Runs on a GPU.  It runs on the CPU only when ``JAX_PLATFORMS`` asks for the
CPU; any other non-GPU backend is an error.  Prints ONE JSON line naming
the device's platform, kind and count.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--case", choices=("bomex", "bubble"), default="bomex")
    p.add_argument("--size", type=str, default=None,
                   help="NxNyNz override (default: 256x256x256 for bomex, "
                        "256x256x128 for bubble)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--dt", type=float, default=None,
                   help="default: 1.0 for bomex, 0.5 for bubble")
    p.add_argument("--moist", action="store_true",
                   help="bubble case: saturation-adjustment moist "
                        "thermodynamics (bomex is always moist)")
    p.add_argument("--dynamics", choices=("anelastic", "compressible"),
                   default="anelastic")
    p.add_argument("--svp", choices=("clausius_clapeyron", "flatau", "tetens"),
                   default="clausius_clapeyron",
                   help="saturation vapor pressure closure")
    p.add_argument("--terrain", action="store_true",
                   help="compressible bubble over a Schaer-type ridge")
    p.add_argument("--substep-floattype", default=None,
                   help="compressible acoustic carry dtype (e.g. bfloat16)")
    args = p.parse_args(argv)
    if args.dynamics == "compressible" or args.terrain:
        args.dynamics = "compressible"
        args.case = "bubble"
    if args.size is None:
        args.size = "256x256x256" if args.case == "bomex" else "256x256x128"
    if args.dt is None:
        args.dt = 1.0 if args.case == "bomex" else 0.5
    return args


def device_info() -> dict:
    """Platform, kind and count of the devices JAX runs on.  Raises unless
    the backend is a GPU, or the CPU that ``JAX_PLATFORMS`` asked for."""
    import jax

    dev = jax.devices()[0]
    asked_cpu = "cpu" in os.environ.get("JAX_PLATFORMS", "").split(",")
    if dev.platform != "gpu" and not (dev.platform == "cpu" and asked_cpu):
        raise RuntimeError(
            f"bench.py runs on a GPU (found {dev.platform!r}); set "
            "JAX_PLATFORMS=cpu to run on the CPU on purpose")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def build_case(args):
    import jax.numpy as jnp

    from breeze_tpu import cases

    size = tuple(int(s) for s in args.size.split("x"))
    if args.case == "bomex":
        return cases.bomex(size, jnp.float32, dt=args.dt, svp=args.svp)
    if args.dynamics == "compressible":
        return cases.compressible_bubble(
            size, jnp.float32, dt=args.dt, moist=args.moist,
            terrain=args.terrain, substep_floattype=args.substep_floattype,
            svp=args.svp)
    return cases.anelastic_bubble(size, jnp.float32, dt=args.dt,
                                  moist=args.moist, svp=args.svp)


def main(argv=None) -> int:
    args = _parse_args(argv)
    device = device_info()

    import jax

    from breeze_tpu.backend import enable_compile_cache

    enable_compile_cache()
    case = build_case(args)
    chunk = case.advance(10, donate=True)
    model, state = case.model, case.state

    t0 = time.perf_counter()
    # Two warm-up chunks at least: the first call runs on the freshly built
    # state's layouts, the second on the chunk's own (donated) outputs.
    for _ in range(max(2, args.warmup // 10)):
        state = chunk(model, state)
    jax.block_until_ready(state)
    setup_seconds = time.perf_counter() - t0

    n_chunks = max(1, args.steps // 10)
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        state = chunk(model, state)
    jax.block_until_ready(state)
    elapsed = time.perf_counter() - t0

    steps = n_chunks * 10
    nx, ny, nz = case.size
    time_per_step = elapsed / steps
    result = {
        "metric": "grid_points_per_second",
        "value": nx * ny * nz / time_per_step,
        "unit": "points/s",
        "device": device,
        "config": {
            "case": case.name,
            "size": args.size, "advection": "WENO5",
            "dynamics": args.dynamics,
            "dtype": "float32",
            "substep_floattype": args.substep_floattype,
            "moist": bool(args.moist or args.case == "bomex"),
            "terrain": "schaer_ridge" if args.terrain else None,
            "steps": steps,
            "time_per_step_seconds": time_per_step,
            "setup_seconds": setup_seconds,
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
