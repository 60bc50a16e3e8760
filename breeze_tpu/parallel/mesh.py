"""Device-mesh parallelism: 2-D horizontal domain decomposition.

Equivalent of the reference's ``Distributed(arch;
partition=Partition(px, py))`` MPI decomposition (reference
``src/Breeze.jl:171,182,208``; SURVEY.md §2.3): the horizontal (x, y) axes
shard over a ``jax.sharding.Mesh``; z is never decomposed (the implicit /
column axis).

Two execution paths:

1. **GSPMD (default)**: the whole step function is ``jit``-ed with
   ``NamedSharding`` constraints; XLA's SPMD partitioner inserts the halo
   ``collective-permute``s for every stencil and the all-to-alls for the
   FFT Poisson solve automatically.  This replaces the reference's
   hand-written MPI halo exchange wholesale.
2. **shard_map + explicit halo exchange** (perf path, see
   :mod:`breeze_tpu.parallel.halo`): per-shard stencils with ``ppermute``
   halo exchange, enabling interior/boundary overlap.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def factor_mesh(n: int) -> tuple[int, int]:
    """Split n devices into a near-square (px, py) decomposition."""
    px = int(math.isqrt(n))
    while n % px:
        px -= 1
    return n // px, px  # (x_devices, y_devices)


def make_mesh(devices=None, shape: tuple[int, int] | None = None) -> Mesh:
    """Build a 2-D ('x', 'y') device mesh for horizontal decomposition."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        shape = factor_mesh(n)
    px, py = shape
    assert px * py == n, f"mesh shape {shape} != {n} devices"
    arr = np.asarray(devices).reshape(py, px)  # (y, x) to match array order
    return Mesh(arr, ("y", "x"))


FIELD_SPEC = P(None, "y", "x")      # (z, y, x): shard horizontal axes
PROFILE_SPEC = P(None)               # 1-D z profiles: replicated
SCALAR_SPEC = P()


def state_sharding(mesh: Mesh, state):
    """NamedShardings matching a ``State`` pytree: fields sharded (y, x)."""
    fs = NamedSharding(mesh, FIELD_SPEC)
    sc = NamedSharding(mesh, SCALAR_SPEC)

    def spec(leaf):
        return fs if getattr(leaf, "ndim", 0) == 3 else sc

    return jax.tree.map(spec, state)


def model_sharding(mesh: Mesh, model):
    """Model arrays (profiles, solver factors) — replicate by default.

    The Poisson Thomas factors are (nz, ny, nxr)-shaped; replicating them is
    correct under GSPMD (the partitioner re-shards as needed around the FFT).
    """
    rep = NamedSharding(mesh, P())
    return jax.tree.map(lambda _: rep, model)


def shard_step(step_fn, mesh: Mesh, model, state, donate: bool = True):
    """jit ``step_fn(model, state, dt) -> state`` over the mesh (GSPMD path)."""
    ms = model_sharding(mesh, model)
    ss = state_sharding(mesh, state)
    return jax.jit(
        step_fn,
        in_shardings=(ms, ss, None),
        out_shardings=ss,
        donate_argnums=(1,) if donate else (),
    )


def device_put_sharded_state(mesh: Mesh, state):
    return jax.device_put(state, state_sharding(mesh, state))


def device_put_replicated_model(mesh: Mesh, model):
    return jax.device_put(model, model_sharding(mesh, model))
