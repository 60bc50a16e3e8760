#!/usr/bin/env python3
"""Smoke check on the GPU: the main path at full width, against float64.

    python3 chip_smoke.py           # one GPU: every one-card phase
    python3 chip_smoke.py --four    # four GPUs: the shard_map phase only

Everything runs in this one process (a JAX process reserves most of a card's
memory, so a second one would fail).  One-card phases, in order:

1. the card's name and power limit, from ``nvidia-smi`` in a child process
   that does not import JAX;
2. a check that JAX runs on a GPU (if the CUDA plugin fails to load, JAX
   falls back to the CPU without a word, so this is explicit);
3. ten steps of each canonical case in float32 — 256³ BOMEX, the
   256×256×128 compressible bubble with float32 and with bfloat16 acoustic
   carries, and the same bubble over the Schär ridge — each compared field
   by field with the same case run in float64 on the card (the bfloat16
   run also with the float32-carry run);
4. the pressure projection's divergence residual after one BOMEX step, in
   float32 and in float64, on the Poisson path the card takes;
5. compile time of every phase (set-up) and ``peak_bytes_in_use``.

``--four`` runs only the four-card phase: the ``shard_map`` step that
``Simulation`` engages on its own with several GPUs, on 256³ BOMEX over the
mesh ``auto_mesh`` picks and on the compressible bubble over that mesh and
a 2×2 ``Partition``, each compared with the dense step on card 0, and each
timed over a first and a second batch of steps (set-up, then steady
state).

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``.  Any failed
check raises :class:`SmokeFailure`, so the script exits non-zero and prints
no such line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# Bounds on max|x32 − x64| per prognostic field after STEPS steps, by case.
# A thermodynamic field (ρ, ρθ, ρqᵗ) is measured against its own maximum, a
# momentum field against the flow's momentum scale, the largest |ρu|, |ρv|
# or |ρw| (a component that stays near zero has no relative error of its
# own).  Each bound is about three times the largest reading on an H100
# (NVIDIA H100 80GB HBM3); PERF.md keeps the readings.  What sets them:
# float32 rounds at 6e-8 relative; BOMEX's ρqᵗ crosses the saturation
# threshold, where the adjustment changes branch; the compressible bubble's
# momenta carry the float32 rounding of the 1e5 Pa pressure in its gradient
# (2⁻²⁴·p/Δz), a few thousandths of the weak bubble's buoyancy.  The
# projection's residual bound sits 15 times below what TF32 products give:
# with the Poisson einsums at DEFAULT precision the H100 reads 6.7e-3.
F32_TOL = {
    "bomex": {"thermo": 2e-4, "momentum": 5e-5},
    "bubble": {"thermo": 2e-6, "momentum": 7e-3},
    "terrain": {"thermo": 5e-6, "momentum": 2.5e-4},
}
# bfloat16 acoustic carries (8 significant bits) against the float64 run,
# and against the float32-carry run, which isolates what the carries add:
# that difference must be non-zero (the carries really are bfloat16) and
# within its bound.  On the H100 it equals the float32-vs-float64 reading
# (2.2e-3): the bubble's momenta amplify any rounding-level change alike.
BF16_TOL = {"thermo": 2e-6, "momentum": 1e-2}
BF16_VS_F32_TOL = {"thermo": 2e-6, "momentum": 7e-3}
# The projection's divergence residual (``divergence_residual``): solved to
# working precision it is unit roundoff (6e-8 in float32, 1.1e-16 in
# float64) times the Poisson operator's conditioning, which grows with the
# grid (2.1e-5 in float32 at 256³ on an H100 on the real + eigen path,
# 6.7e-3 with the Poisson einsums at DEFAULT precision, i.e. in TF32).
RESIDUAL_TOL = {"float32": 1e-4, "float64": 1e-11}
# shard_map vs dense, float32 both, after two batches of STEPS steps: the
# same arithmetic, summed in another order by the pencil transposes and the
# halo exchanges.  The thermodynamic fields stay within a few units of
# float32 rounding; the momenta grow that difference as they grow any
# rounding-level change (BOMEX's saturation branches; the bubble's pressure
# rounding, as with bfloat16 carries).  About three times the largest
# reading on four H100s; a wrong halo or transpose moves the fields at the
# shard edges by whole percents.
SHARDED_TOL = {
    "bomex": {"thermo": 3e-4, "momentum": 1e-4},
    "bubble": {"thermo": 2e-6, "momentum": 5e-3},
}

FULL_SIZES = {"bomex": (256, 256, 256), "bubble": (256, 256, 128)}
STEPS = 10


class SmokeFailure(RuntimeError):
    """A check of the smoke run failed."""


def require(ok, message) -> None:
    """Raise :class:`SmokeFailure` with ``message`` unless ``ok``."""
    if not ok:
        raise SmokeFailure(message)


def card_report() -> str:
    """``nvidia-smi``'s name and power limit of every card, from a child
    process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def _sizes(scale: int) -> dict:
    return {k: tuple(n // scale for n in v) for k, v in FULL_SIZES.items()}


def _kind(name: str) -> str:
    return "momentum" if name in ("rho_u", "rho_v", "rho_w") else "thermo"


def prognostics(state) -> dict:
    """Host copies of a state's prognostic fields, by name."""
    import numpy as np

    out = {}
    for name in ("rho", "rho_u", "rho_v", "rho_w", "rho_theta", "rho_qt"):
        val = getattr(state, name, None)
        if val is not None:
            out[name] = np.asarray(val)
    for name, val in state.tracers.items():
        out[name] = np.asarray(val)
    return out


def max_rel_diff(a, b, scale=None) -> float:
    """max|a − b| / scale in float64 (``scale`` defaults to max|b|)."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if scale is None:
        scale = np.abs(b).max()
    return float(np.abs(a - b).max() / max(scale, 1e-300))


def check_fields(label, got: dict, ref: dict, tol: dict, report) -> dict:
    """Compare every field of ``got`` with ``ref`` and report each beside
    its bound (``tol`` by field kind; momenta against the momentum scale);
    raise if a field is non-finite, misshapen or out of bound."""
    import numpy as np

    diffs = {}
    require(got.keys() == ref.keys(), (label, got.keys(), ref.keys()))
    momentum_scale = max([float(np.abs(ref[n]).max()) for n in ref
                          if _kind(n) == "momentum"] + [1e-300])
    for name in got:
        a, b = got[name], ref[name]
        require(a.shape == b.shape, (label, name, a.shape, b.shape))
        require(np.isfinite(a).all(), f"{label}: {name} is not finite")
        bound = tol[_kind(name)]
        scale = None
        if _kind(name) == "momentum":
            scale = momentum_scale
        diffs[name] = max_rel_diff(a, b, scale)
        report(f"  {label:<28} {name:<10} max rel diff {diffs[name]:.3e}"
               f"  (bound {bound:.3e})")
        require(diffs[name] <= bound,
                f"{label}: {name} differs by {diffs[name]:.3e} > {bound:.3e}")
    return diffs


def _compiled(case, n_steps: int = 1):
    """AOT-compile ``case.advance(n_steps)``; return (fn, compile seconds)."""
    t0 = time.perf_counter()
    fn = case.advance(n_steps).lower(case.model, case.state).compile()
    return fn, time.perf_counter() - t0


def run_case(build, dtype, steps: int, report, label: str,
             residual: bool = False):
    """Build the case in ``dtype``, compile, take ``steps`` steps.  Returns
    the host prognostics (and the divergence residual after step 1)."""
    import jax

    from breeze_tpu.diagnostics import divergence_residual

    case = build(dtype)
    step, compile_s = _compiled(case)
    state = case.state
    res = None
    t0 = time.perf_counter()
    for i in range(steps):
        state = step(case.model, state)
        if residual and i == 0:
            res = divergence_residual(case.model, state)
    jax.block_until_ready(state)
    run_s = time.perf_counter() - t0
    name = jax.numpy.dtype(dtype).name
    report(f"  {label:<28} {name:<8} compile {compile_s:8.2f} s   "
           f"{steps} steps {run_s:8.3f} s")
    fields = prognostics(state)
    for k, v in fields.items():
        require(v.dtype == jax.numpy.dtype(dtype), (label, k, v.dtype))
    return fields, res, case


def one_card_phases(scale: int = 1, steps: int = STEPS, report=print):
    """Every one-card phase.  ``scale`` divides the canonical sizes (1 on
    the card; the CPU tests pass a larger one)."""
    import jax
    import jax.numpy as jnp

    from breeze_tpu import cases

    sz = _sizes(scale)
    f64 = jnp.float64

    report("phase bomex: 256^3-class BOMEX moist LES, float32 vs float64"
           f" ({'x'.join(map(str, sz['bomex']))})")

    def build(dtype):
        return cases.bomex(sz["bomex"], dtype)

    got, res32, case = run_case(build, jnp.float32, steps, report, "bomex",
                                residual=True)
    with jax.enable_x64(True):
        ref, res64, _ = run_case(build, f64, steps, report, "bomex",
                                 residual=True)
    check_fields("bomex", got, ref, F32_TOL["bomex"], report)
    solver = case.model.solver
    report(f"phase projection: Poisson path transform={solver.transform} "
           f"vertical_solve={solver.vertical_solve}")
    for name, res in (("float32", res32), ("float64", res64)):
        report(f"  divergence residual after one BOMEX step, {name}: "
               f"{res:.3e}  (bound {RESIDUAL_TOL[name]:.0e})")
        require(res <= RESIDUAL_TOL[name], (name, res))
    _memory(report)

    report("phase compressible: bubble, float32 and bfloat16 acoustic "
           f"carries vs float64 ({'x'.join(map(str, sz['bubble']))})")

    def bubble(dtype, **kw):
        return cases.compressible_bubble(sz["bubble"], dtype, **kw)

    with jax.enable_x64(True):
        ref, _, _ = run_case(bubble, f64, steps, report, "bubble")
    f32, _, _ = run_case(bubble, jnp.float32, steps, report, "bubble")
    check_fields("bubble f32 carries", f32, ref, F32_TOL["bubble"], report)
    bf16, _, _ = run_case(
        lambda dtype: bubble(dtype, substep_floattype="bfloat16"),
        jnp.float32, steps, report, "bubble bf16")
    check_fields("bubble bf16 carries", bf16, ref, BF16_TOL, report)
    own = check_fields("bf16 vs f32 carries", bf16, f32, BF16_VS_F32_TOL,
                       report)
    require(max(own.values()) > 0.0,
            "bfloat16 carries gave the float32-carry result bit for bit")
    _memory(report)

    report("phase terrain: bubble over the Schaer ridge, float32 vs float64")

    def terrain(dtype):
        return bubble(dtype, terrain=True)

    got, _, _ = run_case(terrain, jnp.float32, steps, report, "terrain")
    with jax.enable_x64(True):
        ref, _, _ = run_case(terrain, f64, steps, report, "terrain")
    check_fields("terrain", got, ref, F32_TOL["terrain"], report)
    _memory(report)


def _timed_steps(step, state, steps: int):
    """Take ``steps`` steps; return (state, seconds)."""
    import jax

    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state)
    jax.block_until_ready(state)
    return state, time.perf_counter() - t0


def four_card_phase(scale: int = 1, steps: int = STEPS, report=print):
    """shard_map step vs the dense step on device 0, on four devices.

    Each step runs two batches of ``steps`` steps: the first call of a
    program carries one-time set-up (collective communicators, buffer
    allocation), so the second batch gives the steady-state time.  The
    fields are compared after both."""
    import jax
    import jax.numpy as jnp

    from breeze_tpu import cases
    from breeze_tpu.parallel.shard_step import (auto_mesh,
                                                make_shard_map_step,
                                                make_xy_mesh)

    n = len(jax.devices())
    require(n >= 4, f"--four needs four devices, JAX sees {n}")
    sz = _sizes(scale)
    bubble = cases.compressible_bubble(sz["bubble"], jnp.float32)
    for key, case, meshes in (
            ("bomex", cases.bomex(sz["bomex"], jnp.float32), [None]),
            ("bubble", bubble, [None, make_xy_mesh(2, 2)])):
        report(f"phase four-card {key}: size "
               f"{'x'.join(map(str, case.size))}")
        dense, compile_s = _compiled(case)
        step = lambda s: dense(case.model, s)
        ref = _timed_report("dense", step, case.state, steps, compile_s,
                            report)
        for mesh in meshes:
            label = f"{key} Partition(2,2)"
            if mesh is None:
                label = f"{key} auto_mesh"
                mesh = auto_mesh(case.model, 4)
                require(mesh is not None, "auto_mesh found no decomposition")
            report(f"  {label}: mesh "
                   f"{dict(zip(mesh.axis_names, mesh.devices.shape))}")
            t0 = time.perf_counter()
            sharded = make_shard_map_step(case.model, mesh).lower(
                case.state, case.dt).compile()
            out = _timed_report("sharded", sharded, case.state, steps,
                                time.perf_counter() - t0, report)
            check_fields(label, prognostics(out), prognostics(ref),
                         SHARDED_TOL[key], report)
    _memory(report)


def _timed_report(name, step, state, steps, compile_s, report):
    """Two timed batches of ``steps`` steps from ``state``, reported; the
    state after both."""
    state, first_s = _timed_steps(step, state, steps)
    state, steady_s = _timed_steps(step, state, steps)
    report(f"  {name:<7} compile {compile_s:8.2f} s   first {steps} steps "
           f"{first_s:8.3f} s   next {steps} steps {steady_s:8.3f} s "
           f"({1e3 * steady_s / steps:.2f} ms/step)")
    return state


def _memory(report):
    import jax

    for d in jax.devices():
        stats = d.memory_stats() or {}
        report(f"  {d}: peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-GPU shard_map phase")
    args = p.parse_args(argv)

    print("card (name, power limit):", card_report(), flush=True)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX runs on {dev.platform!r}",
              file=sys.stderr)
        return 1
    print(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}",
          flush=True)

    from breeze_tpu.backend import enable_compile_cache

    print("compile cache:", enable_compile_cache(), flush=True)
    report = lambda line: print(line, flush=True)
    t0 = time.perf_counter()
    if args.four:
        four_card_phase(report=report)
    else:
        one_card_phases(report=report)
    print(f"all phases: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
