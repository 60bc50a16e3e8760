"""Production shard_map execution path: explicit-collective distributed step.

Equivalent of the reference's hand-written MPI decomposition
(Oceananigans ``DistributedComputations``; SURVEY.md §2.3 item 2 and §7
phase 8) — the alternative to the GSPMD path of :mod:`.mesh` with every
communication explicit:

- **Halo exchange**: `fields.pad` reroutes sharded-axis halos through
  ``lax.ppermute`` (periodic wrap AND bounded mirror — the global-wall
  shards overwrite their outer halo locally; :mod:`.halo`).
- **Aligned-flux wraps**: the roll-based divergences exchange single slabs
  (`halo.wrap_roll`).
- **Pencil-FFT Poisson**: :class:`PencilPoissonSolver` transposes with
  ``lax.all_to_all`` (gather-x → rfft2 → regain-z → per-mode Thomas on the
  shard's factor slice → inverse), the explicit version of what the GSPMD
  partitioner inserts around the transform.

Decomposition: 1-D along x (the slab/pencil standard). The step body is the
SAME ``ssp_rk3_step`` — it runs per-shard on a local grid whose ``nx`` is
the shard width, with the context manager :func:`halo.shard_axes` marking
axis 2 as mesh-sharded.

Use :func:`make_shard_map_step` for a jitted whole-step function, or
:func:`initialize_distributed` first on multi-host deployments.

**Compute/comm overlap.** The reference hand-overlaps MPI halo exchange
with interior compute (async ``fill_halo_regions!``).  The equivalent
here is dataflow freedom + XLA's latency-hiding scheduler: each
``ppermute`` here is issued as an async collective-permute (start/done
pair), and everything that does not consume the exchanged halo — the
z-direction fluxes and tridiagonal solves (z is never sharded), the
pointwise thermodynamics, the y-direction stencils under 1-D x sharding —
is free to schedule between start and done.  The flux-divergence code
keeps those directions dependency-separate precisely so the scheduler can
do this; nothing in the program forces a bulk-synchronous exchange.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..dynamics.poisson import (AnelasticPoissonSolver, _einsum,
                                fourier_tridiagonal_scan)
from .halo import shard_axes



def _a2a(x, name, split_axis, concat_axis):
    """``lax.all_to_all(tiled=True)`` — or, under
    ``BREEZE_TPU_LOCAL_HALO_TIMING=1`` (see ``halo._local_halo_timing``),
    a LOCAL split+concat of identical shape/data volume so
    ``bench_scaling.py --collective-share`` can time the collective share
    of the pencil transpose.  Wrong numerics under the flag."""
    from .halo import _local_halo_timing
    if _local_halo_timing():
        n = jax.lax.axis_size(name)
        return jnp.concatenate(jnp.split(x, n, axis=split_axis),
                               axis=concat_axis)
    return jax.lax.all_to_all(x, name, split_axis=split_axis,
                              concat_axis=concat_axis, tiled=True)

@partial(jax.tree_util.register_dataclass,
         data_fields=["base"],
         meta_fields=["axis_x", "axis_y", "nx_global", "ny_global"])
@dataclasses.dataclass(frozen=True)
class PencilPoissonSolver:
    """shard_map-internal anelastic Poisson solve with explicit all-to-alls.

    Supports a 1-D ``Partition(px)`` (``axis_y=None``) or a 2-D
    ``Partition(px, py)`` decomposition (reference
    ``Distributed(arch, partition=Partition(px, py))``, ``src/Breeze.jl:
    208``).  Pipeline (local shard holds ``(nz, ny/py, nx/px)``):

        all_to_all split-z/concat-x over "x" → (nz/px,       ny/py, nx)
        all_to_all split-z/concat-y over "y" → (nz/(px·py),  ny,    nx)
        base._forward                        → horizontal mode space
          (rfft2, or the real/DCT eigenbasis —
          the horizontals are FULLY gathered here, so every transform the
          dense solver supports works unchanged)
        all_to_all split-my/concat-z over "y", then "x"  → full z columns
        per-mode vertical solve on the owned mode-row slice
        …inverse mirrors the forward path.

    Requires ``px·py | nz`` and ``px·py | ny`` (asserted at build).
    """

    base: AnelasticPoissonSolver
    axis_x: str = "x"
    axis_y: str | None = None
    nx_global: int = 0
    ny_global: int = 0

    def solve(self, divergence: jax.Array, dt) -> jax.Array:
        base = self.base
        ax, ay = self.axis_x, self.axis_y
        px = jax.lax.axis_size(ax)
        ix = jax.lax.axis_index(ax)
        py = jax.lax.axis_size(ay) if ay else 1
        iy = jax.lax.axis_index(ay) if ay else 0
        my = base.ny                       # horizontal y-mode count (= ny)
        rhs = (divergence * base.dz_c[:, None, None]) / dt

        # gather horizontals (split z)
        a = _a2a(rhs, ax, 0, 2)
        if ay:
            a = _a2a(a, ay, 0, 1)
        a_hat = base._forward(a)
        # regain z (split the y-mode axis over "y" then "x")
        if ay:
            a_hat = _a2a(a_hat, ay, 1, 0)
        a_hat = _a2a(a_hat, ax, 1, 0)

        nyl = my // (px * py)
        offset = iy * (my // py) + ix * nyl

        def ysl(f, axis=1):
            return jax.lax.dynamic_slice_in_dim(f, offset, nyl, axis=axis)

        if base.vertical_solve == "eigen":
            ze = base.z_eig
            coef = _einsum("mz,zyx->myx", ze["AT"], a_hat)
            coef = coef * ysl(ze["inv_tab"])
            x = _einsum("zm,myx->zyx", ze["A"], coef)
        else:
            mask = ysl(base.zero_mode_mask, axis=0)
            x = fourier_tridiagonal_scan(a_hat, ysl(base.lower),
                                         ysl(base.inv_den),
                                         ysl(base.c_prime),
                                         mask, base.nz)

        x = _a2a(x, ax, 0, 1)
        if ay:
            x = _a2a(x, ay, 0, 1)
        phi = base._inverse(x, (self.ny_global or base.ny, self.nx_global))
        if ay:
            phi = _a2a(phi, ay, 1, 0)
        phi = _a2a(phi, ax, 2, 0)
        return phi.astype(divergence.dtype)


def make_x_mesh(n_devices: int | None = None) -> Mesh:
    """1-D ('x',) device mesh for the slab/pencil decomposition."""
    devices = jax.devices()
    n = n_devices or len(devices)
    return jax.make_mesh((n,), ("x",), devices=devices[:n])


def auto_mesh(model, n_devices: int | None = None) -> Mesh | None:
    """Pick a device mesh for ``model`` — THE production multi-device
    entry, used by :class:`breeze_tpu.simulation.Simulation` when more
    than one device is visible.

    Prefers the 1-D x slab/pencil decomposition (largest halo-free
    fraction per shard, and x is the contiguous axis); falls back to
    2-D ``('x', 'y')`` when nx alone can't take all devices.  Returns
    ``None`` when no decomposition satisfies the divisibility constraints
    (callers then run single-device/replicated).

    Constraints checked per candidate: ``px | nx``, ``py | ny``, local
    shard extents no smaller than the stencil halo (the ppermute exchange
    pulls ``halo`` cells from the ADJACENT neighbor only), and — for
    anelastic models (pencil-FFT Poisson transposes) — ``px·py | nz`` and
    ``px·py | ny``.
    """
    g = model.grid
    n = n_devices or len(jax.devices())
    if n <= 1:
        return None
    has_poisson = hasattr(model, "solver")
    min_local = max(g.halo, 4)

    def pencil_ok(p):
        return not has_poisson or (g.nz % p == 0 and g.ny % p == 0)

    if g.nx % n == 0 and g.nx // n >= min_local and pencil_ok(n):
        return make_x_mesh(n)
    # 2-D: largest px | gcd-style scan
    for px in range(n - 1, 0, -1):
        if n % px or g.nx % px or g.nx // px < min_local:
            continue
        py = n // px
        if py > 1 and g.ny // py < min_local:
            continue
        if g.ny % py == 0 and pencil_ok(n):
            return make_xy_mesh(px, py)
    return None


def make_xy_mesh(px: int, py: int) -> Mesh:
    """2-D ('x', 'y') device mesh for ``Partition(px, py)``."""
    return jax.make_mesh((px, py), ("x", "y"),
                         devices=jax.devices()[: px * py])


def _local_model(model, px: int, py: int = 1):
    """Shard-local model: grid narrowed to the shard extent; anelastic
    models get the Poisson solver swapped for the pencil version
    (compressible models have no elliptic solve — the acoustic loop is
    local-plus-halos, so only the grid narrows)."""
    g = model.grid
    p = px * py
    assert g.nx % px == 0, f"px={px} must divide nx={g.nx}"
    assert g.ny % py == 0, f"py={py} must divide ny={g.ny}"
    local_grid = dataclasses.replace(g, nx=g.nx // px, ny=g.ny // py)
    kw = {"grid": local_grid}
    if hasattr(model, "solver"):
        # pencil-transpose constraints (Poisson only)
        assert g.nz % p == 0, \
            f"px·py={p} must divide nz={g.nz} (pencil z-split)"
        assert g.ny % p == 0, f"px·py={p} must divide ny={g.ny} (mode rows)"
        kw["solver"] = PencilPoissonSolver(
            base=model.solver, axis_x="x", axis_y="y" if py > 1 else None,
            nx_global=g.nx, ny_global=g.ny)
    return dataclasses.replace(model, **kw)


def _localize_terrain(terrain, ny_l: int, nx_l: int, axis_x: str,
                      axis_y: str | None):
    """Narrow the global-shaped TerrainMetrics horizontal fields to this
    shard's window (terrain metrics are closure constants — replicated —
    while the state is sharded; reference equivalence: each MPI rank's
    grid carries only its local metric slabs).

    Every ≥2-D array in TerrainMetrics is horizontally shaped
    ``(..., ny, nx)``; z-profiles are 1-D and pass through.
    """
    zero = jnp.int32(0)
    ix = jax.lax.axis_index(axis_x).astype(jnp.int32)
    iy = jax.lax.axis_index(axis_y).astype(jnp.int32) if axis_y else zero

    def narrow(a):
        if getattr(a, "ndim", 0) < 2:
            return a
        starts = (zero,) * (a.ndim - 2) + (iy * ny_l, ix * nx_l)
        sizes = a.shape[:-2] + (ny_l, nx_l)
        return jax.lax.dynamic_slice(a, starts, sizes)

    return jax.tree.map(narrow, terrain)


def make_distributed_step(model, mesh: Mesh | None = None, step_fn=None):
    """The production multi-device step: shard_map with explicit
    collectives.

    GSPMD (``jit`` + ``NamedSharding``, :mod:`.mesh`) remains available as
    a compatibility path; this one makes every exchange explicit.
    Reference equivalence: one decomposition story, ``src/Breeze.jl:208``.

    Returns a jitted ``f(state, dt) -> state`` (``dt`` static), or raises
    if no mesh fits the model's divisibility constraints.
    """
    if mesh is None:
        mesh = auto_mesh(model)
        if mesh is None:
            raise ValueError(
                "no device mesh satisfies the decomposition constraints "
                f"for grid {model.grid.shape} on {len(jax.devices())} "
                "devices (need px | nx, py | ny, and for anelastic "
                "px*py | nz and px*py | ny); pass an explicit mesh")
    return make_shard_map_step(model, mesh, step_fn=step_fn)


def make_shard_map_step(model, mesh: Mesh, step_fn=None):
    """Jitted distributed step ``f(state, dt) -> state`` running ``step_fn``
    per-shard under ``shard_map`` with explicit collectives (module
    docstring).  ``dt`` is static (as everywhere).

    ``mesh`` is 1-D ``('x',)`` or 2-D ``('x', 'y')`` (``make_xy_mesh``);
    with a 2-D mesh both horizontal axes exchange halos via ppermute
    (periodic wrap or bounded mirror per the grid topology).
    """
    if step_fn is None:
        if hasattr(model, "solver"):
            from ..timesteppers import ssp_rk3_step
            step_fn = ssp_rk3_step
        else:
            from ..dynamics.compressible import acoustic_rk3_step
            step_fn = acoustic_rk3_step
    if mesh.devices.ndim == 1:
        (px,), py = mesh.devices.shape, 1
    else:
        px, py = mesh.devices.shape
    lmodel = _local_model(model, px, py)
    axes = {2: "x"}
    yname = None
    if py > 1:
        axes[1] = "y"
        yname = "y"

    def spec(leaf):
        nd = getattr(leaf, "ndim", 0)
        if nd == 3:
            return P(None, yname, "x")
        if nd == 2:
            return P(yname, "x")
        return P()

    def local_step(state, dt):
        with shard_axes(axes):
            m = lmodel
            if getattr(m, "terrain", None) is not None:
                m = dataclasses.replace(
                    m, terrain=_localize_terrain(
                        m.terrain, m.grid.ny, m.grid.nx, "x", yname))
            return step_fn(m, state, dt)

    def stepped(state, dt):
        specs = jax.tree.map(spec, state,
                             is_leaf=lambda x: x is None)
        # dt is closed over (static at the jit level): the steppers treat
        # it as a Python float (acoustic substep counts bake into the
        # program).  check_vma=False: the step body is the dense code and
        # does not annotate which of its values vary over the mesh axes.
        return jax.shard_map(lambda s: local_step(s, dt), mesh=mesh,
                             in_specs=(specs,),
                             out_specs=specs,
                             check_vma=False)(state)

    return jax.jit(stepped, static_argnums=(1,))


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None):
    """Multi-host bring-up: ``jax.distributed.initialize`` with
    environment fallback (reference `Distributed(arch)` MPI init).

    On single-host deployments this is a no-op.  On several hosts pass the
    coordinator explicitly or set ``BREEZE_TPU_COORDINATOR`` /
    ``BREEZE_TPU_NUM_PROCESSES`` / ``BREEZE_TPU_PROCESS_ID``.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "BREEZE_TPU_COORDINATOR")
    if num_processes is None and "BREEZE_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["BREEZE_TPU_NUM_PROCESSES"])
    if process_id is None and "BREEZE_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["BREEZE_TPU_PROCESS_ID"])
    if coordinator_address is None and num_processes in (None, 1):
        return  # single host
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
