"""Explicit distributed halo exchange for shard_map execution.

Equivalent of the reference's MPI ``fill_halo_regions!``
(Oceananigans DistributedComputations; SURVEY.md §2.3 item 2): under
``jax.shard_map``, each device holds an interior shard of the (y, x) plane;
halo padding along a sharded periodic axis becomes a neighbor exchange via
``lax.ppermute`` between neighbouring devices (cyclic permutation =
periodic global topology).

Two ways to use it:

1. **GSPMD (default production path)**: don't use this module — jit with
   ``NamedSharding`` and XLA partitions :func:`breeze_tpu.fields.pad`'s
   concatenate-of-slices into the same collective-permutes automatically.
2. **shard_map (manual path)**: wrap per-shard step code with
   :func:`shard_axes` so :func:`pad_axis_sharded` routes the wrap halos
   through ppermute.
"""

from __future__ import annotations

import contextlib
import threading

import jax
import jax.numpy as jnp

_ctx = threading.local()


def _current_axes():
    return getattr(_ctx, "axes", {})


@contextlib.contextmanager
def shard_axes(axes: dict[int, str]):
    """Declare mesh axis names per array axis, e.g. {1: "y", 2: "x"}."""
    old = _current_axes()
    _ctx.axes = dict(axes)
    try:
        yield
    finally:
        _ctx.axes = old


def axis_is_sharded(axis: int) -> bool:
    return axis in _current_axes()


def pad_axis_sharded(a: jax.Array, axis: int, h: int) -> jax.Array:
    """Periodic halo pad along a sharded axis via neighbor ppermute.

    The local shard receives its left neighbor's top h slab and its right
    neighbor's bottom h slab; the cyclic permutation realizes the global
    periodic topology across the whole mesh axis.
    """
    name = _current_axes()[axis]
    n_shards = jax.lax.axis_size(name)
    n = a.shape[axis]
    lo_slab = jax.lax.slice_in_dim(a, n - h, n, axis=axis)   # my top → right nbr
    hi_slab = jax.lax.slice_in_dim(a, 0, h, axis=axis)       # my bottom → left nbr

    if n_shards == 1 or _local_halo_timing():
        return jnp.concatenate([lo_slab, a, hi_slab], axis=axis)

    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    bwd = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    from_left = jax.lax.ppermute(lo_slab, name, fwd)    # left nbr's top slab
    from_right = jax.lax.ppermute(hi_slab, name, bwd)   # right nbr's bottom slab
    return jnp.concatenate([from_left, a, from_right], axis=axis)


def _local_halo_timing() -> bool:
    """``BREEZE_TPU_LOCAL_HALO_TIMING=1``: replace every ppermute halo
    exchange with a LOCAL wrap of the shard.  WRONG numerics — exists only
    so ``bench_scaling.py --collective-share`` can measure the collective
    share of a sharded step (same local compute + DMA, zero collectives).
    Read at trace time; never set it for a production run."""
    import os

    return bool(os.environ.get("BREEZE_TPU_LOCAL_HALO_TIMING"))


def _exchange_slabs(a, axis, h, name, n_shards):
    """(from_left, from_right) neighbor slabs via cyclic ppermute."""
    n = a.shape[axis]
    lo_slab = jax.lax.slice_in_dim(a, n - h, n, axis=axis)
    hi_slab = jax.lax.slice_in_dim(a, 0, h, axis=axis)
    if _local_halo_timing():
        return lo_slab, hi_slab
    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    bwd = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    return (jax.lax.ppermute(lo_slab, name, fwd),
            jax.lax.ppermute(hi_slab, name, bwd))


def pad_axis_sharded_bounded(a: jax.Array, axis: int, h: int,
                             face: bool) -> jax.Array:
    """Bounded halo pad along a sharded axis: interior shard edges exchange
    with neighbors (ppermute); the GLOBAL wall shards overwrite their outer
    halo with the local mirror (even for centers; odd-about-the-wall-face
    with the implicit upper wall for faces), selected branch-free from
    ``axis_index``.  Mirrors the single-device ``_pad_bounded_*`` rules of
    :mod:`breeze_tpu.fields`.
    """
    name = _current_axes()[axis]
    n_shards = jax.lax.axis_size(name)
    n = a.shape[axis]
    if n_shards == 1:
        from .. import fields as fl
        return (fl._pad_bounded_face(a, axis, h) if face
                else fl._pad_bounded_center(a, axis, h))

    from_left, from_right = _exchange_slabs(a, axis, h, name, n_shards)
    idx = jax.lax.axis_index(name)
    is_first = (idx == 0)
    is_last = (idx == n_shards - 1)

    if not face:
        mirror_lo = jnp.flip(jax.lax.slice_in_dim(a, 0, h, axis=axis),
                             axis=axis)
        mirror_hi = jnp.flip(jax.lax.slice_in_dim(a, n - h, n, axis=axis),
                             axis=axis)
        lo = jnp.where(is_first, mirror_lo, from_left)
        hi = jnp.where(is_last, mirror_hi, from_right)
        return jnp.concatenate([lo, a, hi], axis=axis)

    # Face storage: shard 0 holds global faces starting at the lower wall
    # (face 0); the upper wall face is implicit and only materializes in the
    # LAST shard's upper halo (zero wall + negated mirror).
    mirror_lo = -jnp.flip(jax.lax.slice_in_dim(a, 1, h + 1, axis=axis),
                          axis=axis)
    shp = list(a.shape)
    shp[axis] = 1
    wall = jnp.zeros(shp, a.dtype)
    mirror_hi = jnp.concatenate(
        [wall, -jnp.flip(jax.lax.slice_in_dim(a, n - h + 1, n, axis=axis),
                         axis=axis)], axis=axis)
    lo = jnp.where(is_first, mirror_lo, from_left)
    hi = jnp.where(is_last, mirror_hi, from_right)
    return jnp.concatenate([lo, a, hi], axis=axis)


def wrap_roll(a: jax.Array, shift: int, axis: int) -> jax.Array:
    """Periodic ±1 roll that is correct under ``shard_map``: on a sharded
    axis the wrapped element comes from the mesh neighbor via ``ppermute``
    (single-slab exchange); otherwise a plain ``jnp.roll``.

    Used by the aligned-flux divergences (roll-based wrap, see
    ``advection.py``) so the SAME step code runs dense and shard-mapped.
    """
    if axis not in _current_axes():
        return jnp.roll(a, shift, axis)
    assert shift in (1, -1), "wrap_roll supports unit shifts"
    name = _current_axes()[axis]
    n_shards = jax.lax.axis_size(name)
    n = a.shape[axis]
    if n_shards == 1 or _local_halo_timing():
        return jnp.roll(a, shift, axis)
    if shift == -1:
        # element i ← i+1: my first slab goes to my LEFT neighbor
        slab = jax.lax.slice_in_dim(a, 0, 1, axis=axis)
        recv = jax.lax.ppermute(
            slab, name, [(i, (i - 1) % n_shards) for i in range(n_shards)])
        body = jax.lax.slice_in_dim(a, 1, n, axis=axis)
        return jnp.concatenate([body, recv], axis=axis)
    # shift == +1: element i ← i−1: my last slab goes to my RIGHT neighbor
    slab = jax.lax.slice_in_dim(a, n - 1, n, axis=axis)
    recv = jax.lax.ppermute(
        slab, name, [(i, (i + 1) % n_shards) for i in range(n_shards)])
    body = jax.lax.slice_in_dim(a, 0, n - 1, axis=axis)
    return jnp.concatenate([recv, body], axis=axis)
