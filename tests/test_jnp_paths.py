"""Contracts of the anelastic step, one per configuration.

Each configuration runs two SSP-RK3 steps in float32 and in float64 on a
small grid; every prognostic field must agree to ``F32_TOL``, measured as
``chip_smoke.check_fields`` measures the full-size cases on the GPU.  A
second contract per configuration: a horizontally uniform atmosphere at
rest stays at rest and keeps its column budget of ρθ to rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import breeze_tpu as bz
import chip_smoke
from breeze_tpu import advection as adv
from breeze_tpu.timesteppers import ssp_rk3_step

SIZE = (32, 8, 16)
EXTENT = (6400.0, 1600.0, 2000.0)

# About three times the largest reading over the configurations on
# XLA:CPU: thermodynamic fields 6.6e-7 of their maximum (ρqᵗ through the
# saturation adjustment), momenta 6.0e-7 of the momentum scale.
F32_TOL = {"thermo": 2e-6, "momentum": 2e-6}


def _forcings():
    from breeze_tpu.physics.forcings import (DrySubsidenceTendency,
                                             GeostrophicForcing,
                                             SubsidenceForcing, UpperSponge)
    return (
        GeostrophicForcing(f=1e-4, u_g=lambda z: -10.0 + 1.8e-3 * z),
        SubsidenceForcing(w_profile=lambda z: -0.004 * z / 1500.0),
        DrySubsidenceTendency(tendency_profile=lambda z: -1.2e-8
                              * jnp.ones_like(z)),
        UpperSponge(rate=0.05, bottom=1500.0, damp_scalars=True),
    )


def _smagorinsky():
    from breeze_tpu.physics.closures import SmagorinskyLilly
    return SmagorinskyLilly()


SAT = dict(microphysics=bz.SaturationAdjustment(
    equilibrium=bz.WarmPhaseEquilibrium()))

# name -> (make_model keyword arguments, moist, tracer, stretched z)
CONFIGS = {
    "dry_fplane": (dict(coriolis=bz.FPlane(1e-4)), False, False, False),
    "no_coriolis_tracer": ({}, False, True, False),
    "moist_saturation_adjustment": (dict(coriolis=bz.FPlane(1e-4), **SAT),
                                    True, False, False),
    "bounds_preserving_scalars": (
        dict(scalar_advection=adv.WENO(5, bounds_preserving=True),
             momentum_advection=adv.WENO(5)), False, True, False),
    "smagorinsky": (dict(closure="smagorinsky", **SAT), True, False, False),
    "column_forcings": (dict(coriolis=bz.FPlane(1e-4), forcings="bomex",
                             **SAT), True, False, False),
    "stretched_z": (dict(coriolis=bz.FPlane(1e-4)), False, False, True),
    "static_energy": (dict(formulation="static_energy", **SAT), True, False,
                      False),
}


def build(name, dtype, rest=False):
    kw, moist, tracer, stretched = CONFIGS[name]
    kw = dict(kw)
    if kw.get("closure") == "smagorinsky":
        kw["closure"] = _smagorinsky()
    if kw.get("forcings") == "bomex":
        kw["forcings"] = _forcings()
    if "scalar_advection" not in kw:
        kw["advection"] = bz.WENO(5)
    z = (0.0, EXTENT[2])
    if stretched:
        z = bz.piecewise_stretched_z(SIZE[2], surface_layer_height=400.0,
                                     surface_layer_spacing=40.0,
                                     top=EXTENT[2])
    g = bz.make_grid(size=SIZE, x=(0.0, EXTENT[0]), y=(0.0, EXTENT[1]), z=z,
                     topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                     halo=3, dtype=dtype)
    model = bz.make_model(g, potential_temperature=300.0, **kw)
    if rest:
        theta = lambda x, y, z: 300.0 + 0.0 * z
        return model, bz.initial_state(
            model, theta=theta,
            qt=(lambda x, y, z: 5e-3 + 0.0 * z) if moist else None,
            tracers=({"c": jnp.ones(g.shape, dtype)} if tracer else None))
    theta = lambda x, y, z: 300.0 + 3e-3 * z + 1.0 * jnp.exp(
        -((x - 3200.0) ** 2 / 1200.0 ** 2 + (z - 700.0) ** 2 / 300.0 ** 2))
    tracers = None
    if tracer:
        xc = jnp.asarray(g.x_c(), dtype)[None, None, :]
        tracers = {"c": (0.5 + 0.5 * jnp.sin(2 * jnp.pi * xc / EXTENT[0]))
                   * jnp.ones(g.shape, dtype)
                   * model.reference.rho_col}
    state = bz.initial_state(
        model, theta=theta,
        qt=(lambda x, y, z: 12e-3 * jnp.exp(-z / 1200.0)) if moist else None,
        u=lambda x, y, z: -5.0 + 1e-3 * z + 0.0 * x,
        tracers=tracers)
    return model, state


_step = jax.jit(lambda m, s: ssp_rk3_step(m, s, 2.0))


def run(model, state, n=2):
    for _ in range(n):
        state = _step(model, state)
    return state


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_float32_matches_float64(name):
    m32, s32 = build(name, jnp.float32)
    m64, s64 = build(name, jnp.float64)
    got = chip_smoke.prognostics(run(m32, s32))
    ref = chip_smoke.prognostics(run(m64, s64))
    for k, v in got.items():
        assert v.dtype == np.float32, (k, v.dtype)
    chip_smoke.check_fields(name, got, ref, F32_TOL, lambda line: None)


# The column forcings drive a resting atmosphere by design.
@pytest.mark.parametrize("name", sorted(set(CONFIGS) - {"column_forcings"}))
def test_rest_state_and_column_budget(name):
    model, state = build(name, jnp.float64, rest=True)
    g = model.grid
    dz = np.asarray(g.dz_c)[:, None, None]
    budget0 = float(np.sum(np.asarray(state.rho_theta) * dz))
    out = run(model, state, n=3)
    for comp in ("rho_u", "rho_v", "rho_w"):
        assert float(jnp.abs(getattr(out, comp)).max()) < 1e-10, comp
    budget = float(np.sum(np.asarray(out.rho_theta) * dz))
    np.testing.assert_allclose(budget, budget0, rtol=1e-12)
