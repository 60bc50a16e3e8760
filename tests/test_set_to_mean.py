"""set_to_mean, reduced-precision substeps, number-concentration diagnostics."""

import jax.numpy as jnp
import numpy as np
import pytest

import breeze_tpu as bz
from breeze_tpu import diagnostics as diag
from breeze_tpu.dynamics.compressible import (
    SplitExplicitTimeDiscretization, acoustic_rk3_step, compressible_diagnose,
    compressible_initial_state, make_compressible_model)
from breeze_tpu.model import diagnose, initial_state, make_model
from breeze_tpu.physics.two_moment import TwoMomentMicrophysics
from breeze_tpu.thermo.reference import reference_state_from_profiles, set_to_mean


class TestSetToMean:
    def test_rebuilt_reference_is_hydrostatic(self):
        g = bz.make_grid(size=(8, 1, 32), extent=(4000.0, 1.0, 8000.0),
                         topology=(bz.PERIODIC, bz.FLAT, bz.BOUNDED),
                         dtype=jnp.float64)
        from breeze_tpu.thermo.constants import ThermodynamicConstants
        c = ThermodynamicConstants()
        T = 290.0 - 0.0065 * np.asarray(g.z_c)
        ref = reference_state_from_profiles(g, c, T, qv_profile=0.005)
        p = np.asarray(ref.p_c)
        rho = np.asarray(ref.rho_c)
        dz = float(g.dz_c[0])
        dpdz = (p[2:] - p[:-2]) / (2 * dz)
        np.testing.assert_allclose(dpdz, -9.81 * rho[1:-1], rtol=1e-3)

    def test_set_to_mean_reanchors(self):
        g = bz.make_grid(size=(16, 1, 16), extent=(8000.0, 1.0, 4000.0),
                         topology=(bz.PERIODIC, bz.FLAT, bz.BOUNDED),
                         dtype=jnp.float64)
        model = make_model(g, potential_temperature=300.0)
        # warm the whole domain by 5 K: the mean state drifts off reference
        state = initial_state(model, theta=lambda x, y, z: 305.0 + 0.0 * x)
        new_model, new_state = set_to_mean(model, state)
        # new reference temperature tracks the warmed state
        T_state = np.asarray(diagnose(model, state).T[:, 0, 0])
        np.testing.assert_allclose(np.asarray(new_model.reference.T_c), T_state,
                                   rtol=1e-6)
        # state stays consistent: θ unchanged after rescaling
        theta_new = np.asarray(new_state.rho_theta / new_model.reference.rho_col)
        np.testing.assert_allclose(theta_new, 305.0, rtol=1e-10)


class TestReducedPrecisionSubsteps:
    @pytest.mark.skip(reason="XLA:CPU segfaults compiling bf16 scan programs on "
                             "this host (AOT CPU-feature mismatch); the bf16 "
                             "substep path is checked on the GPU by chip_smoke.py")
    def test_bf16_substeps_close_to_f32(self):
        g = bz.make_grid(size=(32, 1, 16), extent=(20_000.0, 1.0, 8_000.0),
                         topology=(bz.PERIODIC, bz.FLAT, bz.BOUNDED),
                         dtype=jnp.float32)

        def theta0(x, y, z):
            return 300.0 + 2.0 * jnp.exp(-((x - 10_000.0) ** 2
                                           + (z - 2_000.0) ** 2) / 1_500.0 ** 2)

        def run(floattype):
            model = make_compressible_model(
                g, advection=bz.Centered(2),
                time_discretization=SplitExplicitTimeDiscretization(
                    substeps=6, substep_floattype=floattype))
            state = compressible_initial_state(model, theta=theta0)
            for _ in range(5):
                state = acoustic_rk3_step(model, state, 2.0)
            return compressible_diagnose(model, state)

        full = run(None)
        half = run("bfloat16")
        scale = float(jnp.abs(full.w).max()) + 1e-6
        np.testing.assert_allclose(np.asarray(half.w) / scale,
                                   np.asarray(full.w) / scale, atol=0.15)
        assert bool(jnp.all(jnp.isfinite(half.w)))


class TestNumberConcentrationDiag:
    def test_number_concentration(self):
        g = bz.make_grid(size=(8, 1, 12), extent=(4000.0, 1.0, 3000.0),
                         topology=(bz.PERIODIC, bz.FLAT, bz.BOUNDED),
                         dtype=jnp.float64)
        model = make_model(g, potential_temperature=300.0,
                          microphysics=TwoMomentMicrophysics())
        state = initial_state(model, qt=jnp.full(g.shape, 0.025))
        state = model.microphysics.model_update(model, state, 10.0)
        n_cl = diag.number_concentration(model, state, "cloud")
        assert float(n_cl.max()) > 0


class TestBoussinesq:
    def test_boussinesq_reference_constant_density(self):
        from breeze_tpu.thermo.constants import ThermodynamicConstants
        from breeze_tpu.thermo.reference import make_boussinesq_reference
        g = bz.make_grid(size=(16, 1, 16), extent=(2000.0, 1.0, 1000.0),
                         topology=(bz.PERIODIC, bz.FLAT, bz.BOUNDED),
                         dtype=jnp.float64)
        ref = make_boussinesq_reference(g, ThermodynamicConstants(),
                                        potential_temperature=300.0)
        rho = np.asarray(ref.rho_c)
        np.testing.assert_allclose(rho, rho[0])
        p = np.asarray(ref.p_c)
        # hydrostatic with constant density
        np.testing.assert_allclose(np.diff(p), -rho[0] * 9.81 * float(g.dz_c[0]),
                                   rtol=1e-12)

    def test_boussinesq_moist_bubble(self):
        """MoistAirBuoyancy capability (reference examples/boussinesq_bomex.jl):
        moist thermodynamics + buoyancy inside a constant-density model."""
        from breeze_tpu.thermo.constants import ThermodynamicConstants
        from breeze_tpu.thermo.reference import make_boussinesq_reference
        from breeze_tpu.timesteppers import ssp_rk3_step
        g = bz.make_grid(size=(24, 1, 24), extent=(4000.0, 1.0, 2000.0),
                         topology=(bz.PERIODIC, bz.FLAT, bz.BOUNDED),
                         dtype=jnp.float64)
        c = ThermodynamicConstants()
        ref = make_boussinesq_reference(g, c, potential_temperature=300.0)
        model = make_model(g, constants=c, reference=ref, advection=bz.WENO(5),
                          microphysics=bz.SaturationAdjustment(
                              equilibrium=bz.WarmPhaseEquilibrium()))
        state = initial_state(
            model,
            theta=lambda x, y, z: 300.0 + 1.0 * jnp.exp(
                -((x - 2000.0) ** 2 + (z - 500.0) ** 2) / 200.0 ** 2),
            qt=lambda x, y, z: 0.014 * jnp.ones_like(z * x))
        for _ in range(10):
            state = ssp_rk3_step(model, state, 2.0)
        aux = diagnose(model, state)
        assert bool(jnp.all(jnp.isfinite(aux.w)))
        assert float(aux.w.max()) > 0.05, "warm moist bubble rises (Boussinesq)"
