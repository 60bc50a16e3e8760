"""Micro-benchmarks of the BOMEX step's pieces, and the Poisson path choice.

Times, at the BOMEX size (default 256³), synchronised with
``jax.block_until_ready``, the pieces below; all but the Poisson solves are
amortized over ``--reps`` calls inside one dispatch (``lax.fori_loop``):

- the Poisson solve on each path: fourier+scan, real+scan, real+eigen
  (median of ``--reps`` separate calls);
- a whole BOMEX step on each path (10-step chunks);
- the negative-moisture fix, saturation adjustment (cold and warm start),
  the full projection and a diagnose.

The fastest full step picks the GPU's path in
``breeze_tpu.backend.poisson_path``.  Prints one JSON line per
measurement, each naming the device.

Usage: python tools/bench_micro.py [--size 256x256x256] [--reps 30]
       [--paths fourier:scan,real:eigen] [--no-extras]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

PATHS = (("fourier", "scan"), ("real", "scan"), ("real", "eigen"))


def amortized(fn, arg, n):
    """Seconds per call of ``fn`` over ``n`` calls in one dispatch."""
    looped = jax.jit(lambda a: jax.lax.fori_loop(0, n, lambda i, x: fn(x), a))
    jax.block_until_ready(looped(arg))
    t0 = time.perf_counter()
    jax.block_until_ready(looped(arg))
    return (time.perf_counter() - t0) / n


def call_time(fn, arg, n):
    """Median seconds of ``n`` separate calls of jitted ``fn``."""
    jax.block_until_ready(fn(arg))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arg))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def chunk_time(case, model, n_chunks=3):
    """Seconds per step of ``case`` with ``model``, 10-step chunks."""
    chunk = case.advance(10)
    state = chunk(model, case.state)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        state = chunk(model, state)
    jax.block_until_ready(state)
    return (time.perf_counter() - t0) / (10 * n_chunks)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", default="256x256x256")
    p.add_argument("--reps", type=int, default=30)
    p.add_argument("--paths", default=",".join(f"{t}:{v}" for t, v in PATHS),
                   help="comma-separated transform:vertical_solve pairs")
    p.add_argument("--no-extras", action="store_true",
                   help="time only the Poisson paths")
    args = p.parse_args(argv)
    paths = [tuple(pv.split(":")) for pv in args.paths.split(",")]
    size = tuple(int(s) for s in args.size.split("x"))

    from breeze_tpu import cases
    from breeze_tpu import model as M
    from breeze_tpu.backend import enable_compile_cache
    from breeze_tpu.dynamics.poisson import build_anelastic_poisson_solver
    from breeze_tpu.physics.microphysics import (fix_negative_moisture,
                                                 saturation_adjust)

    enable_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    def emit(name, seconds, **extra):
        print(json.dumps({"measurement": name, "ms": seconds * 1e3,
                          "size": args.size, "device": device, **extra}),
              flush=True)

    case = cases.bomex(size, jnp.float32)
    model, state = case.model, case.state
    ref = model.reference
    g = model.grid
    rng = np.random.default_rng(0)
    div = jnp.asarray(rng.normal(size=g.shape).astype(np.float32))

    for transform, vertical in paths:
        solver = build_anelastic_poisson_solver(
            g, ref.rho_c, ref.rho_f, transform=transform,
            vertical_solve=vertical)
        m = dataclasses.replace(model, solver=solver)
        emit("bomex_step", chunk_time(case, m), transform=transform,
             vertical_solve=vertical)
        # separate calls: a solve looped inside one program trips XLA's
        # CUDA-graph capture on the eigen path ("Traced CUDA graph is
        # empty"), which the solve inside a real step does not
        t = call_time(jax.jit(lambda x: solver.solve(x, 1.0)), div,
                      args.reps)
        emit("poisson_solve", t, transform=transform, vertical_solve=vertical)

    if args.no_extras:
        return 0
    aux = jax.jit(M.diagnose)(model, state)
    rq = state.rho_qt + jnp.asarray(
        rng.normal(0, 2e-4, g.shape).astype(np.float32))
    dz = g.dz_c_col
    emit("negative_moisture", amortized(
        lambda x: fix_negative_moisture(x, dz) + 0.0, rq, args.reps))

    theta, qt = aux.theta, aux.qt
    c, mp, p_col = model.constants, model.microphysics, ref.p_col

    def sat(x, guess):
        T, q = saturation_adjust(x, qt, p_col, c, mp, model.p_standard,
                                 T_guess=guess)
        return x + 0.0 * T + 0.0 * q.liquid

    emit("saturation_adjust_cold", amortized(lambda x: sat(x, None), theta,
                                             args.reps))
    emit("saturation_adjust_warm", amortized(lambda x: sat(x, aux.T), theta,
                                             args.reps))

    def proj(arrs):
        return M.pressure_projection(model, *arrs, 1.0)[:3]

    emit("projection", amortized(
        proj, (state.rho_u, state.rho_v, state.rho_w), args.reps))

    def diag(s):
        a = M.diagnose(model, s)
        return s.replace(rho_theta=s.rho_theta + 0.0 * a.T
                         + 0.0 * a.buoyancy_force + 0.0 * a.u)

    emit("diagnose_cold", amortized(diag, state, args.reps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
