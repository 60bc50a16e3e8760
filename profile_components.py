"""Per-layer device time of the canonical cases, from a profiler trace.

Analogue of the reference's ``benchmarking/src/tendency_profiling.jl``.
Each case (:mod:`breeze_tpu.cases`) is compiled, warmed up, and a few steps
are traced with ``jax.profiler``.  Every device operation in the trace names
the HLO instruction it ran (``hlo_op``); the compiled module's HLO carries
each instruction's ``jax.named_scope`` path, so device time is summed per
layer:

    tendencies, diagnose, pressure_projection (poisson_solve inside it),
    negative_moisture, microphysics, implicit_vertical, acoustic_substeps
    (thomas_solve inside it), scalar_transport

Operations outside every scope are reported under ``other``.  XLA's GPU
backend groups straight-line kernels into CUDA graphs ("command buffers"),
which the trace shows as one event each; this script turns them off
(``--xla_gpu_enable_command_buffer=``) so every kernel is seen and charged
to its layer.  Kernel times are unchanged by that; the busy share is that
of a run without graphs.  Run on the GPU:

    python profile_components.py --case all --steps 3 --out profile_out
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import time
import warnings

# Innermost first: an operation is charged to the first scope on its path.
LAYERS = ("thomas_solve", "poisson_solve", "negative_moisture",
          "microphysics", "implicit_vertical", "scalar_transport",
          "acoustic_substeps", "pressure_projection", "diagnose",
          "tendencies")

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?$")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_COMP = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")


def layer_of(op_name: str) -> str | None:
    """The innermost of :data:`LAYERS` on a ``named_scope`` path."""
    parts = op_name.split("/")
    for layer in LAYERS:
        if layer in parts:
            return layer
    return None


def instruction_layers(hlo_text: str) -> dict:
    """Map each HLO instruction name to its layer (or ``None``).

    A fusion or call takes the layer most of its called computation's
    instructions carry, so a kernel XLA formed from one scope's operations
    is charged to that scope."""
    own = {}               # instruction -> layer from its own metadata
    calls = {}             # instruction -> called computations
    members = collections.defaultdict(list)   # computation -> instructions
    comp = None
    for line in hlo_text.splitlines():
        m = _COMP.match(line)
        if m and "=" not in line.split("{")[0]:
            comp = m.group(1)
            continue
        m = _INSTR.match(line)
        if not m or comp is None:
            continue
        name = m.group(1)
        members[comp].append(name)
        op = _OP_NAME.search(line)
        own[name] = layer_of(op.group(1)) if op else None
        called = _CALLS.findall(line)
        if called:
            calls[name] = called

    def vote(c, depth=0):
        count = collections.Counter()
        for inst in members.get(c, ()):
            if own.get(inst):
                count[own[inst]] += 1
            elif inst in calls and depth < 4:
                for sub in calls[inst]:
                    count.update(vote(sub, depth + 1))
        return count

    out = {}
    for name, layer in own.items():
        if name in calls:
            count = vote(calls[name][0])
            if count:
                layer = count.most_common(1)[0][0]
        out[name] = layer
    return out


def device_events(xplane_path: str):
    """``(hlo_op, start_ns, duration_ns)`` of every operation on a device
    plane of a trace (GPU planes; the CPU client's thread on the CPU)."""
    from jax.profiler import ProfileData

    # the stats iterator's type warns about a missing __module__
    warnings.filterwarnings("ignore", message=".*event_stats.*",
                            category=DeprecationWarning)
    pd = ProfileData.from_file(xplane_path)
    gpu = [p for p in pd.planes if p.name.startswith("/device:GPU")]
    planes = gpu or [p for p in pd.planes if p.name == "/host:CPU"]
    for plane in planes:
        for line in plane.lines:
            if not gpu and "XLA" not in line.name and "Cpu" not in line.name:
                continue
            for ev in line.events:
                op = dict(ev.stats).get("hlo_op")
                if op is None and not gpu:
                    continue
                # a GPU kernel without the stat is named after its fusion
                yield str(op or ev.name), float(ev.start_ns), \
                    float(ev.duration_ns)


def reduce_trace(events, layers: dict, n_steps: int) -> dict:
    """Device time per layer (ms per step), the window, and the busy share
    (union of operation intervals over the window)."""
    per = collections.Counter()
    ops = collections.Counter()
    spans = []
    for op, start, dur in events:
        per[layers.get(op) or "other"] += dur
        ops[op] += dur
        spans.append((start, start + dur))
    if not spans:
        return {"layers_ms_per_step": {}, "window_ms": 0.0, "busy_share": 0.0}
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    return {
        "layers_ms_per_step": {k: v / 1e6 / n_steps
                               for k, v in per.most_common()},
        "device_ms_per_step": sum(per.values()) / 1e6 / n_steps,
        "window_ms": window / 1e6,
        "busy_share": busy / window if window else 0.0,
        "top_ops": [(op, layers.get(op) or "other", v / 1e6 / n_steps)
                    for op, v in ops.most_common(20)],
    }


def profile_case(case, n_steps: int, out_dir: str) -> dict:
    import jax

    step = case.advance(1)
    t0 = time.perf_counter()
    compiled = step.lower(case.model, case.state).compile()
    compile_s = time.perf_counter() - t0
    layers = instruction_layers(compiled.as_text())
    state = compiled(case.model, case.state)
    state = compiled(case.model, state)
    jax.block_until_ready(state)
    trace_dir = os.path.join(out_dir, case.name)
    with jax.profiler.trace(trace_dir):
        for _ in range(n_steps):
            state = compiled(case.model, state)
        jax.block_until_ready(state)
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    summary = reduce_trace(device_events(path), layers, n_steps)
    summary.update(case=case.name, size=list(case.size), steps=n_steps,
                   compile_seconds=compile_s)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--case", default="all",
                   choices=("all", "bomex", "bubble", "bubble_bf16",
                            "terrain"))
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--scale", type=int, default=1,
                   help="divide the canonical sizes (for a quick check)")
    p.add_argument("--out", default="profile_out")
    args = p.parse_args(argv)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=").strip()

    import jax
    import jax.numpy as jnp

    from breeze_tpu import cases
    from breeze_tpu.backend import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    b3 = tuple(256 // args.scale for _ in range(3))
    bb = (256 // args.scale, 256 // args.scale, 128 // args.scale)
    builders = {
        "bomex": lambda: cases.bomex(b3, jnp.float32),
        "bubble": lambda: cases.compressible_bubble(bb, jnp.float32),
        "bubble_bf16": lambda: cases.compressible_bubble(
            bb, jnp.float32, substep_floattype="bfloat16"),
        "terrain": lambda: cases.compressible_bubble(bb, jnp.float32,
                                                     terrain=True),
    }
    names = list(builders) if args.case == "all" else [args.case]
    os.makedirs(args.out, exist_ok=True)
    results = []
    for name in names:
        summary = profile_case(builders[name](), args.steps, args.out)
        summary["variant"] = name
        results.append(summary)
        print(f"\n{name} {summary['size']}: device "
              f"{summary['device_ms_per_step']:.3f} ms/step, busy share "
              f"{summary['busy_share']:.3f}, compile "
              f"{summary['compile_seconds']:.1f} s", flush=True)
        for layer, ms in summary["layers_ms_per_step"].items():
            print(f"  {layer:<20} {ms:9.3f} ms/step "
                  f"{ms / summary['device_ms_per_step']:7.1%}", flush=True)
    with open(os.path.join(args.out, "layers.json"), "w") as f:
        json.dump({"device": {"platform": dev.platform,
                              "kind": dev.device_kind,
                              "count": len(jax.devices())},
                   "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
