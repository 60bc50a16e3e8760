"""Lagrangian particle tracking.

Equivalent of the reference's ``LagrangianParticles``
(re-exported ``src/Breeze.jl:220``; stepped by ``step_lagrangian_particles!``
in both time steppers): particle positions advect with trilinearly
interpolated staggered velocities (RK2 midpoint), vectorized over all
particles with ``jax.scipy.ndimage.map_coordinates`` — one gather over
all particles.

Periodic horizontal axes wrap; particles reflect at the vertical walls.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.ndimage import map_coordinates

from ..grid import Grid, Topology


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["x", "y", "z"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class LagrangianParticles:
    x: jax.Array
    y: jax.Array
    z: jax.Array

    @property
    def count(self):
        return self.x.shape[0]


def _interp(field, grid: Grid, x, y, z, x_loc, y_loc, z_loc):
    """Trilinear sample of a staggered field at particle positions.

    Fractional indices: centers sit at index (s - s0)/Δ − 0.5, faces at
    (s − s0)/Δ.  Periodic axes use wrap, bounded axes clamp.
    """
    off = lambda loc: 0.0 if loc == "f" else 0.5
    iz = (z - grid.z0) / (grid.Lz / grid.nz) - off(z_loc) \
        if grid.uniform_z else _z_index(grid, z, z_loc)
    iy = (y - grid.y0) / grid.dy - off(y_loc)
    ix = (x - grid.x0) / grid.dx - off(x_loc)
    mode = "wrap" if grid.x_topology == Topology.PERIODIC else "nearest"
    # map_coordinates applies one mode for all axes; wrap is correct for the
    # periodic horizontal axes and harmless vertically because iz is clamped.
    iz = jnp.clip(iz, 0.0, grid.nz - 1.0)
    return map_coordinates(field, [iz, iy, ix], order=1, mode=mode)


def _z_index(grid: Grid, z, z_loc):
    """Fractional index for a stretched vertical coordinate (searchsorted)."""
    ref = grid.z_c if z_loc == "c" else grid.z_f[: grid.nz]
    k = jnp.clip(jnp.searchsorted(ref, z) - 1, 0, grid.nz - 2)
    z0 = ref[k]
    z1 = ref[k + 1]
    return k + (z - z0) / (z1 - z0)


def sample_velocities(grid: Grid, aux, p: LagrangianParticles):
    u = _interp(aux.u, grid, p.x, p.y, p.z, "f", "c", "c")
    v = _interp(aux.v, grid, p.x, p.y, p.z, "c", "f", "c")
    w = _interp(aux.w, grid, p.x, p.y, p.z, "c", "c", "f")
    return u, v, w


def _apply_bcs(grid: Grid, x, y, z):
    if grid.x_topology == Topology.PERIODIC:
        x = grid.x0 + jnp.mod(x - grid.x0, grid.Lx)
    if grid.y_topology == Topology.PERIODIC:
        y = grid.y0 + jnp.mod(y - grid.y0, grid.Ly)
    # reflect at vertical walls
    z_top = grid.z0 + grid.Lz
    z = jnp.where(z < grid.z0, 2 * grid.z0 - z, z)
    z = jnp.where(z > z_top, 2 * z_top - z, z)
    z = jnp.clip(z, grid.z0, z_top)
    return x, y, z


def advect_particles(grid: Grid, aux, p: LagrangianParticles, dt) -> LagrangianParticles:
    """RK2 midpoint advection of all particles."""
    u1, v1, w1 = sample_velocities(grid, aux, p)
    mid = LagrangianParticles(*_apply_bcs(grid, p.x + 0.5 * dt * u1,
                                          p.y + 0.5 * dt * v1,
                                          p.z + 0.5 * dt * w1))
    u2, v2, w2 = sample_velocities(grid, aux, mid)
    return LagrangianParticles(*_apply_bcs(grid, p.x + dt * u2,
                                           p.y + dt * v2,
                                           p.z + dt * w2))


class ParticleTracker:
    """Simulation callback advecting a particle cloud each interval.

    Usage::

        tracker = ParticleTracker(particles)
        sim.add_callback(tracker, IterationInterval(1))
        ... tracker.particles  # final positions
    """

    def __init__(self, particles: LagrangianParticles):
        self.particles = particles
        self._advect = jax.jit(advect_particles, static_argnums=())

    def __call__(self, sim):
        from ..simulation import model_diagnose

        aux = model_diagnose(sim.model, sim.state)
        self.particles = advect_particles(sim.model.grid, aux, self.particles,
                                          sim.dt)
