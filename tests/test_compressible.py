"""Compressible split-explicit dynamics tests.

Mirrors the reference's rest-state contracts
(``test/substepper_rest_state.jl``: T1 discrete balance, T3 zero tendency
at rest, T4 max|w| at machine zero over many steps) plus acoustic-wave and
mass-conservation integration tests (``test/acoustic_substepping.jl``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import breeze_tpu as bz
from breeze_tpu.dynamics.compressible import (
    SplitExplicitTimeDiscretization,
    acoustic_rk3_step as _acoustic_rk3_step,
    compressible_diagnose,
    compressible_initial_state,
    eos_pressure,
    explicit_rk3_step,
    make_compressible_model,
    sound_speed,
    substep_count,
)
from breeze_tpu.thermo.constants import ThermodynamicConstants
from breeze_tpu.thermo.reference import make_exner_reference_state


# One compiled program per model and step size.  Called eagerly, the
# acoustic loop's ``lax.fori_loop`` would compile afresh on every call (a new
# closure each time): hundreds of XLA:CPU compilations per test, one of which
# has crashed a test worker.
acoustic_rk3_step = jax.jit(_acoustic_rk3_step,
                            static_argnames=("dt", "substeps"))


@pytest.fixture
def op_by_op():
    """Step op by op, loops included.  A compiled step contracts
    multiply-adds into FMAs, which moves a rest state by ~1e-9 per step on
    these grids (with FMA instructions disabled, ``--xla_cpu_max_isa=SSE4_2``,
    it matches the op-by-op step to 1e-14).  Op by op the rest state holds
    ~1e-13, which the rest-state contracts pin at 1e-10; their compiled
    twins carry the drift's bound."""
    with jax.disable_jit():
        yield


def comp_grid(nx=32, nz=24, lx=20_000.0, lz=10_000.0, dtype=jnp.float64):
    return bz.make_grid(size=(nx, 1, nz), extent=(lx, 1.0, lz),
                        topology=(bz.PERIODIC, bz.FLAT, bz.BOUNDED),
                        halo=3, dtype=dtype)


CONST = ThermodynamicConstants()


class TestExnerReference:
    def test_discrete_balance_machine_precision(self):
        """T1: (p[k]−p[k−1])/Δzf + g(ρ[k]+ρ[k−1])/2 = 0 at every face."""
        g = comp_grid(nz=64)
        ref = make_exner_reference_state(g, CONST, potential_temperature=300.0)
        p = np.asarray(ref.p_c, np.float64)
        rho = np.asarray(ref.rho_c, np.float64)
        dz_f = np.asarray(g.dz_f, np.float64)
        res = (p[1:] - p[:-1]) / dz_f[1:-1] + 9.81 * 0.5 * (rho[1:] + rho[:-1])
        # machine precision relative to the O(10) N/m^3 hydrostatic terms
        np.testing.assert_allclose(res, 0.0, atol=1e-9)

    def test_stratified_profile(self):
        g = comp_grid(nz=48)
        ref = make_exner_reference_state(
            g, CONST, potential_temperature=lambda z: 300.0 * np.exp(1e-5 * z))
        p = np.asarray(ref.p_c, np.float64)
        rho = np.asarray(ref.rho_c, np.float64)
        dz_f = np.asarray(g.dz_f, np.float64)
        res = (p[1:] - p[:-1]) / dz_f[1:-1] + 9.81 * 0.5 * (rho[1:] + rho[:-1])
        np.testing.assert_allclose(res, 0.0, atol=1e-9)

    def test_eos_consistency(self):
        """EOS closed form inverts ρθ → p consistently with p = ρRT, T = θΠ."""
        g = comp_grid()
        model = make_compressible_model(g)
        ref = model.reference
        p = eos_pressure(model, ref.rho_c * ref.theta_c)
        np.testing.assert_allclose(np.asarray(p), np.asarray(ref.p_c), rtol=1e-12)


@pytest.mark.usefixtures("op_by_op")
class TestRestState:
    def test_rest_atmosphere_stays_at_rest(self):
        """T4: rest atmosphere over many outer steps keeps |w| at machine zero."""
        g = comp_grid(nx=16, nz=32)
        model = make_compressible_model(
            g, reference_potential_temperature=300.0,
            time_discretization=SplitExplicitTimeDiscretization(substeps=6))
        state = compressible_initial_state(model)

        for _ in range(20):
            state = acoustic_rk3_step(model, state, 10.0)
        aux = compressible_diagnose(model, state)
        assert float(jnp.abs(aux.w).max()) < 1e-10
        assert float(jnp.abs(aux.u).max()) < 1e-10
        # density unchanged
        ref_rho = np.broadcast_to(np.asarray(model.reference.rho_col), g.shape)
        np.testing.assert_allclose(np.asarray(state.rho), ref_rho, rtol=1e-12)

    def test_stratified_rest_state(self):
        g = comp_grid(nx=16, nz=32)
        theta_fn = lambda z: 300.0 + 0.004 * z
        model = make_compressible_model(
            g, reference_potential_temperature=theta_fn,
            time_discretization=SplitExplicitTimeDiscretization(substeps=6))
        state = compressible_initial_state(model)
        for _ in range(10):
            state = acoustic_rk3_step(model, state, 10.0)
        aux = compressible_diagnose(model, state)
        assert float(jnp.abs(aux.w).max()) < 1e-9


class TestConservation:
    @staticmethod
    def _bubble_totals(n_steps=10):
        """Domain totals of ρ and ρθ before and after ``n_steps`` steps."""
        g = comp_grid(nx=32, nz=24)
        model = make_compressible_model(
            g, advection=bz.WENO(5),
            time_discretization=SplitExplicitTimeDiscretization(substeps=6))

        def theta0(x, y, z):
            r = jnp.sqrt((x - 10_000.0) ** 2 + (z - 2_000.0) ** 2)
            return 300.0 + 2.0 * jnp.maximum(0.0, 1.0 - r / 2_000.0)

        state = compressible_initial_state(model, theta=theta0)
        dzc = np.asarray(g.dz_c)[:, None, None]
        totals = lambda st: (float(jnp.sum(st.rho * dzc)),
                             float(jnp.sum(st.rho_theta * dzc)))
        before = totals(state)
        for _ in range(n_steps):
            state = acoustic_rk3_step(model, state, 2.0)
        return before, totals(state)

    @pytest.mark.usefixtures("op_by_op")
    def test_mass_conserved(self):
        (m0, e0), (m1, e1) = self._bubble_totals()
        np.testing.assert_allclose(m1, m0, rtol=1e-12)
        np.testing.assert_allclose(e1, e0, rtol=1e-12)

    def test_mass_conserved_compiled(self):
        """The compiled step, whose FMA contraction moves the ρθ total: after
        ten steps on XLA:CPU it differs by 1.8e-15 (ρ) and 2.8e-11 (ρθ)
        relative, and by 3.1e-15 and 1.0e-15 with FMA instructions disabled
        (``--xla_cpu_max_isa=SSE4_2``).  The bound keeps a factor ~3.6 over
        the ρθ drift."""
        (m0, e0), (m1, e1) = self._bubble_totals()
        np.testing.assert_allclose(m1, m0, rtol=1e-10)
        np.testing.assert_allclose(e1, e0, rtol=1e-10)


class TestAcousticWave:
    def test_acoustic_pulse_propagates_at_sound_speed(self):
        """A pressure pulse spreads at ≈ c_s (BASELINE config 'acoustic_wave')."""
        g = comp_grid(nx=128, nz=16, lx=64_000.0, lz=8_000.0)
        model = make_compressible_model(
            g, advection=bz.Centered(2),
            time_discretization=SplitExplicitTimeDiscretization(substeps=12,
                                                                damping_coefficient=0.05))
        # ρθ (pressure) pulse at domain center: NOT pressure-balanced
        ref = model.reference

        def theta0(x, y, z):
            return (1.0 + 1e-3 * jnp.exp(-(x - 32_000.0) ** 2 / 2000.0 ** 2)) * 300.0

        state = compressible_initial_state(model, theta=theta0,
                                           pressure_balanced=False)
        p0 = np.asarray(compressible_diagnose(model, state).p)

        cs = sound_speed(model)
        T = 40.0
        n_steps = 8
        for _ in range(n_steps):
            state = acoustic_rk3_step(model, state, T / n_steps)
        p1 = np.asarray(compressible_diagnose(model, state).p)

        dp = (p1 - p0)[g.nz // 2, 0, :]
        x = np.asarray(g.x_c())
        # wavefront: the perturbation extremum near x = 32km ± cs*T
        expected = cs * T
        # locate the outgoing positive pulses
        half = dp[x > 32_000.0]
        xh = x[x > 32_000.0]
        front = xh[np.argmax(half)] - 32_000.0
        assert abs(front - expected) < 4 * g.dx, (
            f"front at {front:.0f} m, expected {expected:.0f} m")

    def test_explicit_matches_split_explicit(self):
        """Explicit path (tiny Δt) and split-explicit agree on a short run."""
        g = comp_grid(nx=48, nz=12, lx=24_000.0, lz=6_000.0)

        def theta0(x, y, z):
            return 300.0 * (1.0 + 5e-4 * jnp.exp(-(x - 12_000.0) ** 2 / 1500.0 ** 2))

        model_se = make_compressible_model(
            g, advection=bz.Centered(2),
            time_discretization=SplitExplicitTimeDiscretization(
                substeps=8, damping_coefficient=0.0, forward_weight=0.5))
        state_se = compressible_initial_state(model_se, theta=theta0,
                                              pressure_balanced=False)
        state_ex = compressible_initial_state(model_se, theta=theta0,
                                              pressure_balanced=False)

        T_total = 4.0
        state_se = acoustic_rk3_step(model_se, state_se, T_total, substeps=32)
        dt_ex = 0.125  # well below the acoustic CFL (cs*dt/dx ≈ 0.09)
        for _ in range(int(T_total / dt_ex)):
            state_ex = explicit_rk3_step(model_se, state_ex, dt_ex)

        p_se = np.asarray(compressible_diagnose(model_se, state_se).p)
        p_ex = np.asarray(compressible_diagnose(model_se, state_ex).p)
        p0 = np.asarray(eos_pressure(model_se, model_se.reference.rho_c
                                     * model_se.reference.theta_c))[:, None, None]
        # compare perturbation fields
        scale = np.abs(p_ex - p0).max()
        assert scale > 0
        np.testing.assert_allclose((p_se - p0) / scale, (p_ex - p0) / scale,
                                   atol=0.15)


class TestGravityWave:
    def test_inertia_gravity_wave_stable(self):
        """Stratified channel with θ perturbation: stable long integration
        (BASELINE config 'inertia_gravity_wave' capability)."""
        g = comp_grid(nx=60, nz=20, lx=300_000.0, lz=10_000.0)
        N_bv = 0.01  # Brunt-Väisälä
        g_acc = CONST.gravitational_acceleration
        theta_fn = lambda z: 300.0 * np.exp(N_bv ** 2 / g_acc * z)
        model = make_compressible_model(
            g, advection=bz.Centered(2), reference_potential_temperature=theta_fn,
            time_discretization=SplitExplicitTimeDiscretization(substeps=8))

        def theta0(x, y, z):
            base = 300.0 * jnp.exp(N_bv ** 2 / g_acc * z)
            pert = 0.01 * jnp.sin(jnp.pi * z / 10_000.0) / (
                1.0 + (x - 100_000.0) ** 2 / 5_000.0 ** 2)
            return base + pert

        state = compressible_initial_state(model, theta=theta0)
        for _ in range(30):
            state = acoustic_rk3_step(model, state, 12.0)
        aux = compressible_diagnose(model, state)
        assert bool(jnp.all(jnp.isfinite(aux.w)))
        # perturbation energy stays bounded (no blow-up)
        assert float(jnp.abs(aux.w).max()) < 1.0


class TestSubstepCount:
    def test_adaptive_substep_formula(self):
        g = comp_grid()
        model = make_compressible_model(g)
        n = substep_count(model, 2.0)
        cs = sound_speed(model)
        assert n == int(np.ceil(2.0 * cs / (0.5 * g.dx)))


class TestMoistCompressible:
    def test_density_saturation_adjust_consistency(self):
        from breeze_tpu.physics.microphysics import (SaturationAdjustment,
                                                     density_saturation_adjust)
        from breeze_tpu.thermo.constants import MoistureMassFractions
        from breeze_tpu.thermo.states import theta_li_from_temperature
        scheme = SaturationAdjustment()
        rho = jnp.full((4, 1, 4), 1.1)
        theta = jnp.full((4, 1, 4), 295.0)
        qt = jnp.full((4, 1, 4), 0.02)
        T, q, p = density_saturation_adjust(theta, rho, qt, CONST, scheme)
        # residual closed: theta_li(T, q, p) == theta
        th_back = theta_li_from_temperature(
            T, MoistureMassFractions(q.vapor, q.liquid, q.ice), p, CONST)
        np.testing.assert_allclose(np.asarray(th_back), 295.0, rtol=1e-6)
        # EOS holds
        np.testing.assert_allclose(np.asarray(p),
                                   np.asarray(rho * CONST.mixture_gas_constant(q) * T),
                                   rtol=1e-12)
        assert float(q.liquid.max()) > 1e-4, "cold dense moist air condenses"

    def test_moist_bubble_runs_and_conserves(self):
        from breeze_tpu.physics.microphysics import SaturationAdjustment
        from breeze_tpu.thermo.saturation import WarmPhaseEquilibrium
        g = comp_grid(nx=24, nz=20)
        model = make_compressible_model(
            g, advection=bz.WENO(5),
            microphysics=SaturationAdjustment(equilibrium=WarmPhaseEquilibrium()),
            time_discretization=SplitExplicitTimeDiscretization(substeps=6))

        def theta0(x, y, z):
            r = jnp.sqrt((x - 10_000.0) ** 2 + (z - 2_000.0) ** 2)
            return 300.0 + 2.0 * jnp.maximum(0.0, 1.0 - r / 2_000.0)

        state = compressible_initial_state(
            model, theta=theta0, qt=lambda x, y, z: 0.015 * jnp.exp(-z / 2500.0))
        dzc = np.asarray(g.dz_c)[:, None, None]
        m0 = float(jnp.sum(state.rho * dzc))
        q0 = float(jnp.sum(state.rho_qt * dzc))
        for _ in range(10):
            state = acoustic_rk3_step(model, state, 2.0)
        aux = compressible_diagnose(model, state)
        assert bool(jnp.all(jnp.isfinite(aux.T)))
        np.testing.assert_allclose(float(jnp.sum(state.rho * dzc)), m0, rtol=1e-10)
        np.testing.assert_allclose(float(jnp.sum(state.rho_qt * dzc)), q0, rtol=1e-10)
        assert float(aux.q.liquid.max()) > 1e-6, "moist bubble should condense"


class TestCompressiblePhysics:
    """Round-2 physics parity: Kessler / bulk fluxes / radiation / closures
    on the compressible core (VERDICT items; reference
    ``update_atmosphere_model_state.jl:418-434``, ``microphysics_interface.jl:611``)."""

    def _moist_bubble_model(self, microphysics, **kw):
        g = comp_grid(nx=24, nz=20)
        model = make_compressible_model(
            g, advection=bz.WENO(5), microphysics=microphysics,
            time_discretization=SplitExplicitTimeDiscretization(substeps=6),
            **kw)

        def theta0(x, y, z):
            r = jnp.sqrt((x - 10_000.0) ** 2 + (z - 2_000.0) ** 2)
            return 300.0 + 3.0 * jnp.maximum(0.0, 1.0 - r / 2_000.0)

        state = compressible_initial_state(
            model, theta=theta0, qt=lambda x, y, z: 0.016 * jnp.exp(-z / 2500.0))
        return model, state

    def test_kessler_on_split_explicit(self):
        """Prognostic-condensate microphysics drives the compressible core:
        condensation forms cloud, tracers advance, diagnostics stay finite."""
        from breeze_tpu.physics.kessler import KesslerMicrophysics

        model, state = self._moist_bubble_model(KesslerMicrophysics())
        assert "rho_qcl" in state.tracers and "rho_qr" in state.tracers
        assert "surface_precip_rate" in state.diagnostics
        for _ in range(10):
            state = acoustic_rk3_step(model, state, 2.0)
        aux = compressible_diagnose(model, state)
        assert bool(jnp.all(jnp.isfinite(aux.T)))
        assert bool(jnp.all(jnp.isfinite(state.tracers["rho_qcl"])))
        assert float(state.tracers["rho_qcl"].max()) > 1e-7, \
            "supersaturated bubble should form cloud water"
        assert bool(jnp.all(jnp.isfinite(state.diagnostics["accumulated_precip"])))

    def test_kessler_on_explicit(self):
        from breeze_tpu.physics.kessler import KesslerMicrophysics

        model, state = self._moist_bubble_model(KesslerMicrophysics())
        for _ in range(30):
            state = explicit_rk3_step(model, state, 0.05)
        aux = compressible_diagnose(model, state)
        assert bool(jnp.all(jnp.isfinite(aux.T)))

    def test_bulk_surface_fluxes_warm_ocean(self):
        """Bulk fluxes over a warm surface heat and moisten the lowest cells
        and drag decelerates the flow."""
        from breeze_tpu.physics.microphysics import SaturationAdjustment
        from breeze_tpu.physics.surface import BulkSurfaceFluxes
        from breeze_tpu.thermo.saturation import WarmPhaseEquilibrium

        g = comp_grid(nx=16, nz=16, lz=3000.0)
        model = make_compressible_model(
            g, advection=bz.WENO(5),
            microphysics=SaturationAdjustment(equilibrium=WarmPhaseEquilibrium()),
            boundary_fluxes=BulkSurfaceFluxes(surface_temperature=302.0,
                                              surface_theta=302.0),
            time_discretization=SplitExplicitTimeDiscretization(substeps=4))
        state = compressible_initial_state(
            model, theta=298.0, u=5.0, qt=lambda x, y, z: 0.008 + 0.0 * z)
        th0 = float((state.rho_theta / state.rho)[0].mean())
        q0 = float((state.rho_qt / state.rho)[0].mean())
        u0 = float(compressible_diagnose(model, state).u[0].mean())
        for _ in range(10):
            state = acoustic_rk3_step(model, state, 2.0)
        aux = compressible_diagnose(model, state)
        assert float(aux.theta[0].mean()) > th0, "sensible heat flux warms bottom"
        assert float(aux.qt[0].mean()) > q0, "latent flux moistens bottom"
        assert float(aux.u[0].mean()) < u0, "drag decelerates the flow"

    def test_prescribed_momentum_and_moisture_fluxes(self):
        from breeze_tpu.physics.microphysics import SaturationAdjustment
        from breeze_tpu.physics.surface import PrescribedSurfaceFluxes
        from breeze_tpu.thermo.saturation import WarmPhaseEquilibrium

        g = comp_grid(nx=16, nz=12, lz=2000.0)
        model = make_compressible_model(
            g, advection=bz.WENO(5),
            microphysics=SaturationAdjustment(equilibrium=WarmPhaseEquilibrium()),
            boundary_fluxes=PrescribedSurfaceFluxes(
                theta_flux=8e-3, qt_flux=5.2e-5,
                momentum_drag_coefficient=1.2e-3),
            time_discretization=SplitExplicitTimeDiscretization(substeps=4))
        state = compressible_initial_state(model, theta=300.0, u=4.0,
                                           qt=lambda x, y, z: 0.005 + 0.0 * z)
        q0 = float((state.rho_qt / state.rho)[0].mean())
        u0 = float(compressible_diagnose(model, state).u[0].mean())
        for _ in range(8):
            state = acoustic_rk3_step(model, state, 2.0)
        aux = compressible_diagnose(model, state)
        assert float(aux.qt[0].mean()) > q0
        assert float(aux.u[0].mean()) < u0

    def test_gray_radiation_on_compressible(self):
        """GrayRadiation composes with compressible NamedTuple tendencies
        (regression: G.replace -> _rep shim)."""
        from breeze_tpu.physics.radiation import GrayRadiation

        g = comp_grid(nx=8, nz=16)
        model = make_compressible_model(
            g, advection=bz.WENO(5),
            forcings=(GrayRadiation(),),
            time_discretization=SplitExplicitTimeDiscretization(substeps=4))
        state = compressible_initial_state(model, theta=300.0)
        rt0 = state.rho_theta
        for _ in range(4):
            state = acoustic_rk3_step(model, state, 2.0)
        assert bool(jnp.all(jnp.isfinite(state.rho_theta)))
        assert float(jnp.abs(state.rho_theta - rt0).max()) > 0.0, \
            "radiative heating must modify rho_theta"

    def test_closure_diffuses_moisture_true_density(self):
        """Closure G_qt is wired through the split-explicit scalar advance
        (true-rho weighting): a qt stripe decays at the diffusive rate."""
        from breeze_tpu.physics.closures import ConstantDiffusivity
        from breeze_tpu.physics.microphysics import SaturationAdjustment
        from breeze_tpu.thermo.saturation import WarmPhaseEquilibrium

        g = comp_grid(nx=16, nz=16, lx=4000.0, lz=2000.0)
        kappa = 400.0
        model = make_compressible_model(
            g, advection=bz.WENO(5),
            closure=ConstantDiffusivity(viscosity=kappa, diffusivity=kappa),
            microphysics=SaturationAdjustment(equilibrium=WarmPhaseEquilibrium()),
            time_discretization=SplitExplicitTimeDiscretization(substeps=6))

        kx = 2 * jnp.pi / 4000.0

        def qt0(x, y, z):
            return 0.006 + 0.002 * jnp.sin(kx * x)

        state = compressible_initial_state(model, theta=300.0, qt=qt0)
        amp0 = float((state.rho_qt / state.rho)[5].max()
                     - (state.rho_qt / state.rho)[5].min())
        n_steps, dt = 50, 2.0
        for _ in range(n_steps):
            state = acoustic_rk3_step(model, state, dt)
        aux = compressible_diagnose(model, state)
        amp = float(np.asarray(aux.qt)[5].max() - np.asarray(aux.qt)[5].min())
        expected = amp0 * float(np.exp(-kappa * float(kx) ** 2 * n_steps * dt))
        assert bool(jnp.all(jnp.isfinite(aux.T)))
        assert amp < 0.95 * amp0, "stripe must decay"
        np.testing.assert_allclose(amp, expected, rtol=0.03)

    def test_smagorinsky_moist_runs(self):
        from breeze_tpu.physics.closures import SmagorinskyLilly
        from breeze_tpu.physics.microphysics import SaturationAdjustment
        from breeze_tpu.thermo.saturation import WarmPhaseEquilibrium

        g = comp_grid(nx=16, nz=16, lx=4000.0, lz=2000.0)
        model = make_compressible_model(
            g, advection=bz.WENO(5),
            closure=SmagorinskyLilly(),
            microphysics=SaturationAdjustment(equilibrium=WarmPhaseEquilibrium()),
            time_discretization=SplitExplicitTimeDiscretization(substeps=4))
        state = compressible_initial_state(
            model, theta=300.0, qt=lambda x, y, z: 0.006 + 0.0 * z,
            u=lambda x, y, z: 2.0 * jnp.sin(2 * jnp.pi * z / 2000.0))
        for _ in range(10):
            state = acoustic_rk3_step(model, state, 1.0)
        aux = compressible_diagnose(model, state)
        assert bool(jnp.all(jnp.isfinite(aux.T)))
        assert bool(jnp.all(jnp.isfinite(state.rho_u)))


class TestSubstepperVariants:
    """Round-2 substepper completion: sponge / damping strategies /
    substep distributions / implicit_substep (reference
    ``time_discretizations.jl:60-507``, ``acoustic_runge_kutta_3.jl:151``)."""

    def _run_rest(self, td, nsteps=10, dt=2.0):
        g = comp_grid(nx=24, nz=20)
        model = make_compressible_model(g, advection=bz.WENO(5),
                                        time_discretization=td)
        state = compressible_initial_state(model)
        for _ in range(nsteps):
            state = acoustic_rk3_step(model, state, dt)
        return state

    @staticmethod
    def _variants():
        from breeze_tpu.dynamics.compressible import (
            DirectDivergenceDamping, NoDivergenceDamping, UpperSponge)

        return {
            "sponge": SplitExplicitTimeDiscretization(
                substeps=6, sponge=UpperSponge()),
            "direct_damping": SplitExplicitTimeDiscretization(
                substeps=6, damping=DirectDivergenceDamping()),
            "no_damping": SplitExplicitTimeDiscretization(
                substeps=6, damping=NoDivergenceDamping()),
            "constant": SplitExplicitTimeDiscretization(
                substeps=7, substep_distribution="constant"),
            "monolithic_first": SplitExplicitTimeDiscretization(
                substeps=7, substep_distribution="monolithic_first"),
        }

    @pytest.mark.usefixtures("op_by_op")
    def test_rest_state_invariant_under_all_variants(self):
        for name, td in self._variants().items():
            state = self._run_rest(td)
            assert float(jnp.abs(state.rho_w).max()) < 1e-10, \
                f"rest state broken by {name}"

    # The compiled step's rest state drifts by FMA contraction (see
    # ``op_by_op``): max|ρw| 1.6e-8 to 6.4e-8 after ten steps on this grid,
    # by variant, on XLA:CPU.  The bound keeps a factor ~16 over that; a
    # hydrostatic imbalance of 1e-7 relative already moves ρw by
    # g·Δρ·Δt ≈ 2e-6 in one step.
    COMPILED_REST_TOL = 1e-6

    @pytest.mark.parametrize("variant", ["sponge", "direct_damping",
                                         "no_damping", "constant",
                                         "monolithic_first"])
    def test_rest_state_invariant_compiled(self, variant):
        state = self._run_rest(self._variants()[variant])
        assert float(jnp.abs(state.rho_w).max()) < self.COMPILED_REST_TOL

    @pytest.mark.usefixtures("op_by_op")
    def test_roll_path_matches_pad_path(self, monkeypatch):
        """The aligned-roll fast loop (``BREEZE_TPU_ACOUSTIC_ROLLS=1``)
        equals the default halo-padded stencils to roundoff (same arithmetic,
        different data movement; XLA fuses the two graphs with different
        FMA groupings, so ~1e-16 relative residue is expected).  Covers
        thermal AND direct divergence damping (both have roll branches)."""
        from breeze_tpu.dynamics.compressible import DirectDivergenceDamping

        def theta0(x, y, z):
            r = jnp.sqrt((x - 10_000.0) ** 2 + (z - 4_000.0) ** 2)
            return 300.0 + 2.0 * jnp.exp(-(r / 2_000.0) ** 2)

        for damping in (None, DirectDivergenceDamping()):
            kw = {"substeps": 6}
            if damping is not None:
                kw["damping"] = damping
            td = SplitExplicitTimeDiscretization(**kw)
            g = comp_grid(nx=24, nz=20)
            model = make_compressible_model(g, advection=bz.WENO(5),
                                            time_discretization=td)
            state0 = compressible_initial_state(model, theta=theta0,
                                                pressure_balanced=False)
            monkeypatch.setenv("BREEZE_TPU_ACOUSTIC_ROLLS", "1")
            s_roll = acoustic_rk3_step(model, state0, 2.0)
            monkeypatch.delenv("BREEZE_TPU_ACOUSTIC_ROLLS")
            s_pad = acoustic_rk3_step(model, state0, 2.0)
            for name in ("rho", "rho_u", "rho_v", "rho_w", "rho_theta"):
                a = np.asarray(getattr(s_roll, name))
                b = np.asarray(getattr(s_pad, name))
                scale = np.abs(b).max()
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=1e-13 * max(scale, 1.0),
                                           err_msg=name)

    def test_substep_plan(self):
        from breeze_tpu.dynamics.compressible import stage_substep_plan

        # proportional: exact coverage of beta*dt at minimal count
        plan = stage_substep_plan("proportional", 7, 21.0)
        for (n, dtau), beta in zip(plan, (1/3, 1/2, 1.0)):
            np.testing.assert_allclose(n * dtau, beta * 21.0, rtol=1e-12)
        # constant: uniform dtau, N rounded to multiple of 6
        plan = stage_substep_plan("constant", 7, 12.0)
        assert plan == ((4, 1.0), (6, 1.0), (12, 1.0))
        # monolithic first stage
        plan = stage_substep_plan("monolithic_first", 7, 12.0)
        assert plan[0] == (1, 4.0) and plan[2] == (12, 1.0)

    def test_sponge_damps_acoustic_perturbation(self):
        """The implicit Rayleigh sponge damps the acoustic vertical-momentum
        PERTURBATION (ρw)′ inside the substep loop — the reference contract
        (sponge_rhs acts on ρw′, ``acoustic_substepping.jl:909``); the
        stage-entry state itself is untouched (rest-state test above)."""
        from breeze_tpu.dynamics import compressible as C
        from breeze_tpu.dynamics.compressible import UpperSponge

        g = comp_grid(nx=16, nz=32, lx=8_000.0, lz=16_000.0)

        def probe(sponge):
            td = SplitExplicitTimeDiscretization(substeps=6, sponge=sponge)
            model = make_compressible_model(g, advection=bz.WENO(5),
                                            time_discretization=td)
            state = compressible_initial_state(model)
            aux = compressible_diagnose(model, state)
            caches = C.stage_caches(model, state, aux)
            zero = jnp.zeros(g.shape, jnp.float64)
            k = jnp.arange(g.nz, dtype=jnp.float64)[:, None, None]
            bump = 0.1 * jnp.exp(-((k - 28.0) ** 2) / 8.0) * jnp.ones(g.shape)
            bump = bump.at[0].set(0.0)
            G = C.SlowTendencies(rho=zero, rho_u=zero, rho_v=zero,
                                 rho_w=zero, rho_theta=zero)
            pert = C.Perturbations(
                rho=zero, rho_u=zero, rho_v=zero, rho_w=bump, rho_theta=zero,
                sum_rho_u=zero, sum_rho_v=zero, sum_rho_w=zero)
            out = C.acoustic_substep_loop(model, caches, G, pert, 1.0 / 3, 6,
                                          gate_first=True)
            return float(jnp.abs(out.rho_w[24:]).max())

        base = probe(None)
        mild = probe(UpperSponge(damping_rate=0.3, depth=6000.0))
        strong = probe(UpperSponge(damping_rate=5.0, depth=6000.0))
        assert mild < 0.75 * base, (base, mild)
        assert strong < 0.05 * base, (base, strong)

    @pytest.mark.nightly
    def test_direct_damping_stable_gravity_wave(self):
        from breeze_tpu.dynamics.compressible import DirectDivergenceDamping

        g = comp_grid(nx=32, nz=24)
        model = make_compressible_model(
            g, advection=bz.WENO(5),
            time_discretization=SplitExplicitTimeDiscretization(
                substeps=6, damping=DirectDivergenceDamping(0.1)))
        state = compressible_initial_state(
            model, theta=lambda x, y, z: 300.0 + 1.0 * jnp.exp(
                -((x - 10_000.0) ** 2 + (z - 5_000.0) ** 2) / 1e6))
        for _ in range(30):
            state = acoustic_rk3_step(model, state, 2.0)
        assert bool(jnp.all(jnp.isfinite(state.rho_w)))
        assert float(jnp.abs(state.rho_w).max()) < 10.0

    def test_implicit_substep_beats_vertical_cfl(self):
        """Vertically-implicit closure diffusion inside the split-explicit
        loop: stable and quantitatively correct far beyond the explicit
        vertical diffusion CFL (kappa dt/dz^2 = 2.56)."""
        from breeze_tpu.physics.closures import ConstantDiffusivity
        from breeze_tpu.physics.microphysics import SaturationAdjustment
        from breeze_tpu.thermo.saturation import WarmPhaseEquilibrium

        g = comp_grid(nx=16, nz=16, lx=20_000.0, lz=2_000.0)
        kappa = 2.0e4
        dt = 2.0
        model = make_compressible_model(
            g, advection=bz.WENO(5),
            closure=ConstantDiffusivity(viscosity=kappa, diffusivity=kappa,
                                        vertically_implicit=True),
            microphysics=SaturationAdjustment(equilibrium=WarmPhaseEquilibrium()),
            time_discretization=SplitExplicitTimeDiscretization(substeps=6))
        kz = np.pi / 2000.0
        state = compressible_initial_state(
            model, theta=300.0,
            qt=lambda x, y, z: 0.006 + 0.002 * jnp.cos(kz * z))
        amp0 = float((state.rho_qt / state.rho)[:, 0, 0].max()
                     - (state.rho_qt / state.rho)[:, 0, 0].min())
        n = 30
        for _ in range(n):
            state = acoustic_rk3_step(model, state, dt)
        aux = compressible_diagnose(model, state)
        prof = np.asarray(aux.qt)[:, 0, 0]
        amp = float(prof.max() - prof.min())
        # scalars: the final stage applies backward-Euler over the full dt
        expected = amp0 * (1.0 / (1.0 + dt * kappa * kz * kz)) ** n
        assert bool(jnp.all(jnp.isfinite(aux.T)))
        np.testing.assert_allclose(amp, expected, rtol=0.1)
