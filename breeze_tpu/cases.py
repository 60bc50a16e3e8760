"""The canonical benchmark cases, built through the public entry points.

One place that builds each case, so that ``bench.py``, ``chip_smoke.py`` and
the tests drive the same configurations:

- :func:`bomex` — BOMEX moist LES (Siebesma et al. 2003 trade-cumulus
  intercomparison; reference ``examples/bomex.jl``): WENO5, warm-phase
  saturation adjustment, Smagorinsky-Lilly, prescribed surface fluxes,
  geostrophic + subsidence + drying + sponge forcings.  Canonical size
  256³.
- :func:`anelastic_bubble` — dry (or moist) thermal bubble in the
  reference's convective-boundary-layer domain (reference
  ``benchmarking/README.md:193-208``).  Canonical size 256×256×128.
- :func:`compressible_bubble` — the same bubble on the split-explicit
  compressible core, optionally with reduced-precision acoustic carries
  (``substep_floattype``) or over a Schär-type ridge (``terrain=True``).

Every builder takes ``dtype``: float64 builds of the same case (inside
``jax.enable_x64``) are the reference the float32 runs are compared with.
Random initial noise is drawn in float32 from ``seed`` and then cast, so
both precisions start from the same field.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

import breeze_tpu as bz


@dataclasses.dataclass(frozen=True)
class Case:
    """A built case: model, initial state and its time step."""

    name: str
    model: Any
    state: Any
    dt: float
    compressible: bool = False

    @property
    def size(self) -> tuple[int, int, int]:
        g = self.model.grid
        return g.nx, g.ny, g.nz

    def step_fn(self):
        """``f(model, state) -> state``: one step of ``dt`` (not jitted)."""
        dt = self.dt
        if self.compressible:
            from .dynamics.compressible import acoustic_rk3_step
            return lambda m, s: acoustic_rk3_step(m, s, dt)
        from .timesteppers import ssp_rk3_step
        return lambda m, s: ssp_rk3_step(m, s, dt)

    def advance(self, n_steps: int = 1, donate: bool = False):
        """Jitted ``f(model, state) -> state`` taking ``n_steps`` steps."""
        step = self.step_fn()
        if n_steps == 1:
            fn = step
        else:
            def fn(m, s):
                return jax.lax.fori_loop(0, n_steps,
                                         lambda _, st: step(m, st), s)
        return jax.jit(fn, donate_argnums=(1,) if donate else ())


def _grid(size, extent, dtype):
    return bz.make_grid(size=size, extent=extent,
                        topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                        halo=3, dtype=dtype)


def bomex(size=(256, 256, 256), dtype=jnp.float32, dt: float = 1.0,
          svp: str = "clausius_clapeyron", seed: int = 1) -> Case:
    """BOMEX on a 6.4 km × 6.4 km × 3 km domain (reference
    ``examples/bomex.jl``), at ``size`` cells."""
    from .physics.closures import SmagorinskyLilly
    from .physics.forcings import (DrySubsidenceTendency, GeostrophicForcing,
                                   SubsidenceForcing, UpperSponge)
    from .physics.surface import PrescribedSurfaceFluxes

    f_cor = 3.76e-5
    grid = _grid(size, (6_400.0, 6_400.0, 3_000.0), dtype)
    constants = bz.ThermodynamicConstants(saturation_formulation=svp)
    model = bz.make_model(
        grid,
        advection=bz.WENO(5),
        potential_temperature=298.7,
        surface_pressure=101_500.0,
        constants=constants,
        microphysics=bz.SaturationAdjustment(
            equilibrium=bz.WarmPhaseEquilibrium()),
        closure=SmagorinskyLilly(),
        coriolis=bz.FPlane(f=f_cor),
        boundary_fluxes=PrescribedSurfaceFluxes(
            theta_flux=8.0e-3, qt_flux=5.2e-5, friction_velocity=0.28),
        forcings=(
            GeostrophicForcing(f=f_cor,
                               u_g=lambda z: -10.0 + 1.8e-3 * z, v_g=0.0),
            SubsidenceForcing(w_profile=lambda z: jnp.where(
                z < 1500.0, -0.0065 * z / 1500.0,
                jnp.where(z < 2100.0,
                          -0.0065 * (1 - (z - 1500.0) / 600.0), 0.0))),
            DrySubsidenceTendency(tendency_profile=lambda z: jnp.where(
                z < 300.0, -1.2e-8,
                jnp.where(z < 500.0,
                          -1.2e-8 * (1 - (z - 300.0) / 200.0), 0.0))),
            UpperSponge(rate=0.05, bottom=2400.0),
        ))

    def theta0(x, y, z):
        return jnp.where(z < 520.0, 298.7,
               jnp.where(z < 1480.0, 298.7 + (z - 520.0) * (302.4 - 298.7) / 960.0,
               jnp.where(z < 2000.0, 302.4 + (z - 1480.0) * (308.2 - 302.4) / 520.0,
                         308.2 + (z - 2000.0) * 3.65e-3)))

    def qt0(x, y, z):
        return jnp.where(z < 520.0, 17.0e-3 + z * (16.3e-3 - 17.0e-3) / 520.0,
               jnp.where(z < 1480.0, 16.3e-3 + (z - 520.0) * (10.7e-3 - 16.3e-3) / 960.0,
               jnp.where(z < 2000.0, 10.7e-3 + (z - 1480.0) * (4.2e-3 - 10.7e-3) / 520.0,
                         jnp.maximum(4.2e-3 - (z - 2000.0) * 1.2e-6, 1e-4))))

    def u0(x, y, z):
        return jnp.where(z < 700.0, -8.75, -8.75 + (z - 700.0) * 1.8e-3)

    state = bz.initial_state(model, theta=theta0, qt=qt0, u=u0)
    noise = 0.1 * jax.random.normal(jax.random.key(seed), grid.shape,
                                    dtype=jnp.float32).astype(dtype)
    damp = jnp.exp(-grid.z_c_col / 500.0)
    state = state.replace(
        rho_theta=state.rho_theta + model.reference.rho_col * noise * damp)
    return Case("bomex", model, state, dt)


def _bubble_theta(x, y, z, stratified: bool):
    bubble = 0.5 * jnp.exp(-((x - 6400.0) ** 2 + (y - 6400.0) ** 2
                             + (z - 800.0) ** 2) / 500.0 ** 2)
    strat = jnp.where(z > 1000.0, 3e-3 * (z - 1000.0), 0.0) if stratified else 0.0
    return 300.0 + strat + bubble


def _moist_qt(x, y, z):
    return 0.008 * jnp.exp(-z / 1500.0)


# The reference's convective-boundary-layer domain (FastEddy CBL,
# benchmarking/README.md:193-208): 12.8 km × 12.8 km × 3.2 km.
_CBL_EXTENT = (12_800.0, 12_800.0, 3_200.0)


def anelastic_bubble(size=(256, 256, 128), dtype=jnp.float32, dt: float = 0.5,
                     moist: bool = False,
                     svp: str = "clausius_clapeyron") -> Case:
    """Anelastic thermal bubble in the CBL domain."""
    grid = _grid(size, _CBL_EXTENT, dtype)
    model = bz.make_model(
        grid, advection=bz.WENO(5), potential_temperature=300.0,
        microphysics=(bz.SaturationAdjustment(
            equilibrium=bz.WarmPhaseEquilibrium()) if moist else None),
        coriolis=bz.FPlane(1e-4),
        constants=bz.ThermodynamicConstants(saturation_formulation=svp))
    state = bz.initial_state(
        model, theta=lambda x, y, z: _bubble_theta(x, y, z, True),
        qt=_moist_qt if moist else None)
    return Case("anelastic_bubble", model, state, dt)


def schaer_ridge(x, y):
    """Schär-type ridge: 250 m Gaussian envelope × cos² ripples, centred in
    the CBL domain."""
    return (250.0 * jnp.exp(-((x - 6400.0) / 5000.0) ** 2)
            * jnp.cos(jnp.pi * (x - 6400.0) / 4000.0) ** 2)


def compressible_bubble(size=(256, 256, 128), dtype=jnp.float32,
                        dt: float = 0.5, moist: bool = False,
                        terrain: bool = False, substep_floattype=None,
                        svp: str = "clausius_clapeyron") -> Case:
    """Compressible (split-explicit) thermal bubble in the CBL domain,
    optionally over :func:`schaer_ridge` and with ``substep_floattype``
    acoustic carries (e.g. ``"bfloat16"``)."""
    from .dynamics.compressible import (SplitExplicitTimeDiscretization,
                                        compressible_initial_state,
                                        make_compressible_model)

    grid = _grid(size, _CBL_EXTENT, dtype)
    constants = bz.ThermodynamicConstants(saturation_formulation=svp)
    terr = None
    if terrain:
        from .dynamics.terrain import make_terrain
        terr = make_terrain(grid, constants, schaer_ridge)
    model = make_compressible_model(
        grid, advection=bz.WENO(5), coriolis=bz.FPlane(1e-4),
        microphysics=(bz.SaturationAdjustment(
            equilibrium=bz.WarmPhaseEquilibrium()) if moist else None),
        constants=constants, terrain=terr,
        time_discretization=SplitExplicitTimeDiscretization(
            acoustic_cfl=0.5, substep_floattype=substep_floattype))
    state = compressible_initial_state(
        model, theta=lambda x, y, z: _bubble_theta(x, y, z, False),
        qt=_moist_qt if moist else None)
    name = "terrain_bubble" if terrain else "compressible_bubble"
    return Case(name, model, state, dt, compressible=True)
