"""Field locations and halo filling.

The equivalent of the reference's ``Field`` + ``fill_halo_regions!``
machinery (reference ``src/Breeze.jl:202``, used at every kernel boundary,
e.g. ``update_atmosphere_model_state.jl:48``): fields are plain ``(nz, ny, nx)``
arrays; *location* (Center/Face per axis) is metadata, and halo filling is a
pure function producing a halo-padded array that stencil operators consume
with static slices (which XLA fuses into the consuming loop).

Halo rules per (topology, location):

- ``PERIODIC`` axis: wrap-around (single-device) or neighbor exchange
  (``ppermute`` under ``shard_map`` — see ``breeze_tpu.parallel.halo``).
- ``BOUNDED`` axis, Center location: even mirror about the wall face
  (zero-gradient / free-slip / no-flux default).
- ``BOUNDED`` axis, Face location (wall-normal velocity): odd reflection
  about the wall faces; the wall faces themselves carry 0 (impenetrability).
"""

from __future__ import annotations

import enum
from functools import partial

import jax
import jax.numpy as jnp

from .grid import Grid, Topology


class Loc(enum.Enum):
    CENTER = "c"
    FACE = "f"


C = Loc.CENTER
F = Loc.FACE

# Standard staggered locations, in (z, y, x) axis order.
CCC = (C, C, C)   # scalars, pressure
CCF = (C, C, F)   # u, rho_u  (x-face)
CFC = (C, F, C)   # v, rho_v  (y-face)
FCC = (F, C, C)   # w, rho_w  (z-face)


def _pad_periodic(a: jax.Array, axis: int, h: int) -> jax.Array:
    n = a.shape[axis]
    lo = jax.lax.slice_in_dim(a, n - h, n, axis=axis)
    hi = jax.lax.slice_in_dim(a, 0, h, axis=axis)
    return jnp.concatenate([lo, a, hi], axis=axis)


def _pad_bounded_center(a: jax.Array, axis: int, h: int) -> jax.Array:
    """Even mirror: ghost m cells beyond the wall mirror interior cells."""
    n = a.shape[axis]
    lo = jnp.flip(jax.lax.slice_in_dim(a, 0, h, axis=axis), axis=axis)
    hi = jnp.flip(jax.lax.slice_in_dim(a, n - h, n, axis=axis), axis=axis)
    return jnp.concatenate([lo, a, hi], axis=axis)


def _pad_bounded_face(a: jax.Array, axis: int, h: int) -> jax.Array:
    """Odd reflection about wall faces 0 and N for wall-normal velocities.

    Stored entries are faces ``0..N-1`` (face 0 is the lower wall, where the
    value should be 0).  The padded array has ``N + 2h`` entries; the entry at
    padded index ``h + N`` is the upper wall face (0), and ghosts mirror with
    negated sign: ``ghost[N + m] = -a[N - m]``, ``ghost[-m] = -a[m]``.
    """
    n = a.shape[axis]
    # Lower ghosts: -a[h], ..., -a[1]  (odd about face 0)
    lo = -jnp.flip(jax.lax.slice_in_dim(a, 1, h + 1, axis=axis), axis=axis)
    # Upper: wall face N (zero), then -a[N-1], ..., -a[N-h+1]
    shp = list(a.shape)
    shp[axis] = 1
    wall = jnp.zeros(shp, a.dtype)
    hi = -jnp.flip(jax.lax.slice_in_dim(a, n - h + 1, n, axis=axis), axis=axis)
    return jnp.concatenate([lo, a, wall, hi], axis=axis)


def pad_axis(a: jax.Array, axis: int, h: int, topo: Topology, loc: Loc) -> jax.Array:
    if h == 0:
        return a
    if topo == Topology.FLAT:
        # Replicate (the field must be constant along a flat axis).
        reps = [1, 1, 1]
        edge_lo = jax.lax.slice_in_dim(a, 0, 1, axis=axis)
        reps[axis] = h
        ghost = jnp.tile(edge_lo, reps)
        return jnp.concatenate([ghost, a, ghost], axis=axis)
    if topo == Topology.PERIODIC:
        from .parallel import halo as _halo
        if _halo.axis_is_sharded(axis):
            # inside shard_map: wrap halos come from mesh neighbors (ppermute)
            return _halo.pad_axis_sharded(a, axis, h)
        return _pad_periodic(a, axis, h)
    from .parallel import halo as _halo
    if _halo.axis_is_sharded(axis):
        return _halo.pad_axis_sharded_bounded(a, axis, h,
                                              face=(loc != Loc.CENTER))
    if loc == Loc.CENTER:
        return _pad_bounded_center(a, axis, h)
    return _pad_bounded_face(a, axis, h)


def pad(a: jax.Array, grid: Grid, loc=CCC, halo: int | None = None,
        axes=(0, 1, 2)) -> jax.Array:
    """Halo-pad ``a`` on the requested axes using topology+location rules.

    Note on Bounded Face axes: padding grows the axis by ``2h`` like every
    other rule, and the *upper wall face* lives at padded index ``h + n``;
    the caller's interior window ``[h, h+n)`` is unchanged.
    """
    h = grid.halo if halo is None else halo
    topos = grid.topologies()
    out = a
    for ax in axes:
        out = pad_axis(out, ax, h, topos[ax], loc[ax])
    return out


def enforce_impenetrability(w: jax.Array, grid: Grid) -> jax.Array:
    """Zero the wall-normal velocity on the bottom wall face (stored face 0).

    The top wall face is not stored (implied zero in the halo pad).
    """
    if grid.z_topology != Topology.BOUNDED:
        return w
    return w.at[0].set(0.0)


def enforce_wall_normals(grid: Grid, rho_u=None, rho_v=None, rho_w=None):
    """Zero wall-normal momenta on every bounded axis's stored wall face.

    Analogue of the reference's ``enforce_wall_impenetrability!``
    (``acoustic_substepping.jl:1423-1428``): face 0 of each bounded axis is
    a wall (the opposite wall face is implicit in the halo rule).  Returns
    the tuple in the same order, skipping None entries.
    """
    out = []
    if rho_u is not None:
        if grid.x_topology == Topology.BOUNDED:
            rho_u = rho_u.at[:, :, 0].set(0.0)
        out.append(rho_u)
    if rho_v is not None:
        if grid.y_topology == Topology.BOUNDED:
            rho_v = rho_v.at[:, 0, :].set(0.0)
        out.append(rho_v)
    if rho_w is not None:
        if grid.z_topology == Topology.BOUNDED:
            rho_w = rho_w.at[0].set(0.0)
        out.append(rho_w)
    return tuple(out)
