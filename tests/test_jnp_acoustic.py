"""Contracts of the split-explicit compressible step, one per configuration
of the acoustic fast loop.

Each configuration runs two steps in float32 (bfloat16 carries for
``bf16_substep_storage``) and in float64 on a small grid; every prognostic
field must agree to ``F32_TOL`` (``BF16_TOL``), measured as
``chip_smoke.check_fields`` measures the full-size cases on the GPU.  A
second contract per configuration: an atmosphere at rest (over the
terrain, where there is one) stays at rest to 1e-10 and keeps its mass to
rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import breeze_tpu as bz
import chip_smoke
from breeze_tpu.dynamics.compressible import (DirectDivergenceDamping,
                                              SplitExplicitTimeDiscretization,
                                              UpperSponge, acoustic_rk3_step,
                                              compressible_initial_state,
                                              make_compressible_model)
from breeze_tpu.dynamics.terrain import make_terrain, terrain_initial_state

SIZE = (32, 8, 16)
EXTENT = (8000.0, 2000.0, 4000.0)
DT = 2.0

# About three times the largest reading over the configurations on
# XLA:CPU: thermodynamic fields 3.4e-7 of their maximum, momenta 3.7e-5 of
# the momentum scale (the float32 rounding of the 1e5 Pa pressure in its
# gradient), 5.0e-5 with bfloat16 carries.
F32_TOL = {"thermo": 1e-6, "momentum": 1e-4}
BF16_TOL = {"thermo": 1e-6, "momentum": 1.5e-4}

# name -> (time discretization kw, model kw, terrain kind, stretched z)
CONFIGS = {
    "thermal_damping": ({}, {}, None, False),
    "direct_damping": (dict(damping=DirectDivergenceDamping(0.1)), {}, None,
                       False),
    "static_energy": ({}, dict(formulation="static_energy"), None, False),
    "gal_chen_terrain": ({}, {}, "gal_chen", False),
    "sleve_terrain": ({}, {}, "sleve", False),
    "upper_sponge": (dict(sponge=UpperSponge(depth=1500.0,
                                             damping_rate=0.05)), {}, None,
                     False),
    "bf16_substep_storage": (dict(substep_floattype="bfloat16"), {}, None,
                             False),
    "stretched_z_substep": ({}, {}, None, True),
}


def _ridge(x, y):
    return 150.0 / (1.0 + ((x - 4000.0) / 1200.0) ** 2)


def build(name, dtype, rest=False):
    td_kw, kw, terrain, stretched = CONFIGS[name]
    if dtype == jnp.float64:
        td_kw = {k: v for k, v in td_kw.items() if k != "substep_floattype"}
    z = (0.0, EXTENT[2])
    if stretched:
        z = bz.piecewise_stretched_z(SIZE[2], surface_layer_height=800.0,
                                     surface_layer_spacing=100.0,
                                     top=EXTENT[2])
    g = bz.make_grid(size=SIZE, x=(0.0, EXTENT[0]), y=(0.0, EXTENT[1]), z=z,
                     topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                     halo=3, dtype=dtype)
    terr = None
    if terrain:
        sleve = (dict(large_scale_height=2000.0, small_scale_height=1000.0,
                      sleve_smoothing_passes=4)
                 if terrain == "sleve" else {})
        terr = make_terrain(g, bz.ThermodynamicConstants(), _ridge, **sleve)
    model = make_compressible_model(
        g, advection=bz.WENO(5), coriolis=bz.FPlane(1e-4), terrain=terr,
        time_discretization=SplitExplicitTimeDiscretization(substeps=6,
                                                            **td_kw),
        **kw)
    if rest:
        state = (terrain_initial_state(model, terr) if terr is not None
                 else compressible_initial_state(model))
        return model, state
    state = compressible_initial_state(
        model, theta=lambda x, y, z: 300.0 + 1.0 * jnp.exp(
            -((x - 4000.0) ** 2 + (y - 1000.0) ** 2) / 1000.0 ** 2
            - (z - 1200.0) ** 2 / 500.0 ** 2),
        u=lambda x, y, z: 2.0 + 0.0 * x)
    return model, state


_step = jax.jit(lambda m, s: acoustic_rk3_step(m, s, DT))


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
    tol = BF16_TOL if name == "bf16_substep_storage" else F32_TOL
    chip_smoke.check_fields(name, got, ref, tol, lambda line: None)


@pytest.mark.parametrize("name", sorted(set(CONFIGS)
                                        - {"bf16_substep_storage"}))
def test_rest_state_and_mass(name):
    model, state = build(name, jnp.float64, rest=True)
    mass0 = float(jnp.sum(state.rho))
    out = run(model, state, n=3)
    w = np.asarray(out.rho_w)
    assert np.isfinite(w).all()
    assert np.abs(w[1:]).max() < 1e-10, np.abs(w[1:]).max()
    np.testing.assert_allclose(float(jnp.sum(out.rho)), mass0, rtol=1e-12)
