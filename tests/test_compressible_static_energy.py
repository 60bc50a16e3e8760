"""Static-energy (ρe) formulation on the compressible split-explicit core.

The reference's acoustic substepper is formulation-generic — it advances
whatever ``thermodynamic_density(model.formulation)`` returns
(``acoustic_substepping.jl:292,746-747``) — and ``static_energy_tendency.jl``
defines the ρe slow tendency; the compressible T/p diagnostic dispatch for
ρe is absent upstream (``compressible_time_stepping.jl:216-252`` covers θˡⁱ
only), so these tests pin the completed breeze_tpu design:

- p′ = Cₑ(ρe)′ + C_ρ ρ′ is the EXACT linearization of p = ρRᵐT with
  T = (e − gz + ℒq)/cᵖᵐ at frozen (q, z) — fast waves travel at the
  ISOTHERMAL √(RᵐT), not √(γRᵐT) (MSE conservation under compression is
  isothermal at fixed height).
- T3/T4 rest-state contracts (reference ``test/substepper_rest_state.jl``)
  under ρe.
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
    make_compressible_model,
    slow_tendencies,
    stage_caches,
)
from breeze_tpu.thermo.constants import ThermodynamicConstants


# One compiled program per model and step size, as in
# ``test_compressible.py``: an eager ``acoustic_rk3_step`` would compile its
# loop afresh on every call.
acoustic_rk3_step = jax.jit(_acoustic_rk3_step,
                            static_argnames=("dt", "substeps"))


@pytest.fixture
def op_by_op():
    """Step op by op, loops included: the rest-state contracts hold 1e-10,
    which a compiled step's FMA contraction drifts past (see
    ``test_compressible.op_by_op``)."""
    with jax.disable_jit():
        yield


def comp_grid(nx=32, nz=24, lx=20_000.0, lz=10_000.0, dtype=jnp.float64):
    return bz.make_grid(size=(nx, 1, nz), extent=(lx, 1.0, lz),
                        topology=(bz.PERIODIC, bz.FLAT, bz.BOUNDED),
                        halo=3, dtype=dtype)


CONST = ThermodynamicConstants()


@pytest.mark.usefixtures("op_by_op")
class TestRestState:
    def test_rest_atmosphere_stays_at_rest(self):
        """T4 under ρe: |w| stays at near-machine zero over 20 outer steps.

        (Not bitwise zero like the ρθ contract: the e ↔ T roundtrip carries
        one rounding through p = ρRᵈT; the perturbation-form recovery in
        ``_compressible_diagnose_static_energy`` keeps it at roundoff.)
        """
        g = comp_grid(nx=16, nz=32)
        model = make_compressible_model(
            g, formulation="static_energy",
            reference_potential_temperature=300.0,
            time_discretization=SplitExplicitTimeDiscretization(substeps=6))
        state = compressible_initial_state(model)
        for _ in range(20):
            state = acoustic_rk3_step(model, state, 10.0)
        aux = compressible_diagnose(model, state)
        assert float(jnp.abs(aux.w).max()) < 1e-9
        assert float(jnp.abs(aux.u).max()) < 1e-9
        ref_rho = np.broadcast_to(np.asarray(model.reference.rho_col), g.shape)
        np.testing.assert_allclose(np.asarray(state.rho), ref_rho, rtol=1e-11)

    def test_slow_tendencies_vanish_at_rest(self):
        """T3: every Gˢ component ≈ 0 at the balanced rest state."""
        g = comp_grid(nx=16, nz=32)
        model = make_compressible_model(
            g, formulation="static_energy",
            reference_potential_temperature=300.0)
        state = compressible_initial_state(model)
        aux = compressible_diagnose(model, state)
        G = slow_tendencies(model, state, aux)
        # scales: ρe ~ 3e5 J/m^3 so compare tendencies against field scale
        assert float(jnp.abs(G.rho_w).max()) < 1e-7
        assert float(jnp.abs(G.rho_u).max()) < 1e-12
        assert float(jnp.abs(G.rho).max()) < 1e-12
        scale = float(jnp.abs(state.rho_theta).max())
        assert float(jnp.abs(G.rho_theta).max()) < 1e-10 * scale

    def test_stratified_rest_state(self):
        g = comp_grid(nx=16, nz=32)
        model = make_compressible_model(
            g, formulation="static_energy",
            reference_potential_temperature=lambda z: 300.0 + 0.004 * z,
            time_discretization=SplitExplicitTimeDiscretization(substeps=6))
        state = compressible_initial_state(model)
        for _ in range(10):
            state = acoustic_rk3_step(model, state, 10.0)
        aux = compressible_diagnose(model, state)
        assert float(jnp.abs(aux.w).max()) < 1e-8


class TestLinearization:
    def test_pressure_linearization_is_exact(self):
        """p(ρe+δ(ρe), ρ+δρ) − p == Cₑδ(ρe) + C_ρ δρ to roundoff (the
        static-energy EOS is linear in (ρe, ρ) at frozen q, z)."""
        g = comp_grid(nx=8, nz=16)
        model = make_compressible_model(g, formulation="static_energy")
        state = compressible_initial_state(model)
        aux = compressible_diagnose(model, state)
        caches = stage_caches(model, state, aux)

        rng = np.random.default_rng(0)
        d_re = jnp.asarray(rng.normal(size=g.shape) * 50.0)   # J/m^3
        d_rho = jnp.asarray(rng.normal(size=g.shape) * 1e-4)

        c = model.constants
        e_new = (state.rho_theta + d_re) / (state.rho + d_rho)
        T_new = (e_new - c.gravitational_acceleration * g.z_c_col) \
            / c.dry_air.heat_capacity
        p_new = (state.rho + d_rho) * c.Rd * T_new
        dp_exact = p_new - aux.p
        dp_lin = caches.C_L * d_re + caches.C_rho * d_rho
        np.testing.assert_allclose(np.asarray(dp_lin), np.asarray(dp_exact),
                                   rtol=1e-9, atol=1e-8)

    def test_acoustic_pulse_at_isothermal_sound_speed(self):
        """Fast waves under ρe propagate at √(RᵈT), not √(γRᵈT)."""
        g = comp_grid(nx=128, nz=16, lx=64_000.0, lz=8_000.0)
        model = make_compressible_model(
            g, formulation="static_energy", advection=bz.Centered(2),
            time_discretization=SplitExplicitTimeDiscretization(
                substeps=12, damping_coefficient=0.05))
        ref = model.reference

        def theta0(x, y, z):
            return (1.0 + 1e-3 * jnp.exp(
                -(x - 32_000.0) ** 2 / 2000.0 ** 2)) * 300.0

        state = compressible_initial_state(model, theta=theta0,
                                           pressure_balanced=False)
        p0 = np.asarray(compressible_diagnose(model, state).p)

        kmid = g.nz // 2
        T_mid = float(np.asarray(ref.T_col)[kmid, 0, 0])
        c_iso = float(np.sqrt(CONST.Rd * T_mid))
        cpd = CONST.dry_air.heat_capacity
        c_adiab = float(np.sqrt(cpd / (cpd - CONST.Rd) * CONST.Rd * T_mid))

        T_total = 60.0
        for _ in range(12):
            state = acoustic_rk3_step(model, state, T_total / 12)
        p1 = np.asarray(compressible_diagnose(model, state).p)

        dp = (p1 - p0)[kmid, 0, :]
        x = np.asarray(g.x_c())
        half = dp[x > 32_000.0]
        xh = x[x > 32_000.0]
        front = xh[np.argmax(half)] - 32_000.0
        assert abs(front - c_iso * T_total) < 4 * g.dx, (
            f"front {front:.0f} m vs isothermal {c_iso * T_total:.0f} m")
        # and clearly NOT the adiabatic speed
        assert abs(front - c_adiab * T_total) > 4 * g.dx


class TestConservation:
    def test_mass_and_energy_conserved(self):
        g = comp_grid(nx=32, nz=24)
        model = make_compressible_model(
            g, formulation="static_energy", advection=bz.WENO(5),
            time_discretization=SplitExplicitTimeDiscretization(substeps=6))

        def theta0(x, y, z):
            r = jnp.sqrt((x - 10_000.0) ** 2 + (z - 2_000.0) ** 2)
            return 300.0 + 2.0 * jnp.maximum(0.0, 1.0 - r / 2_000.0)

        state = compressible_initial_state(model, theta=theta0)
        dzc = jnp.asarray(g.dz_c)[:, None, None]
        mass0 = float(jnp.sum(state.rho * dzc))
        # ∫ρe is conserved by advection (flux form) but NOT by the
        # buoyancy-flux work term — budget it over the run.
        for _ in range(10):
            state = acoustic_rk3_step(model, state, 5.0)
        mass1 = float(jnp.sum(state.rho * dzc))
        assert abs(mass1 - mass0) / abs(mass0) < 1e-12

    def test_energy_budget_closes_without_buoyancy_work(self):
        """With w ≡ 0 (and no dynamics to excite it: uniform θ), ∫ρe is
        exactly conserved."""
        g = comp_grid(nx=16, nz=16)
        model = make_compressible_model(
            g, formulation="static_energy", advection=bz.WENO(5),
            time_discretization=SplitExplicitTimeDiscretization(substeps=4))
        state = compressible_initial_state(
            model, u=lambda x, y, z: 5.0 * jnp.ones_like(x))
        dzc = jnp.asarray(g.dz_c)[:, None, None]
        e0 = float(jnp.sum(state.rho_theta * dzc))
        for _ in range(5):
            state = acoustic_rk3_step(model, state, 5.0)
        e1 = float(jnp.sum(state.rho_theta * dzc))
        assert abs(e1 - e0) / abs(e0) < 1e-9


class TestMoist:
    def test_saturation_adjust_roundtrip(self):
        """density sat-adjust under ρe recovers (T, q) consistent with the
        forward static_energy() map at saturation."""
        from breeze_tpu.physics.microphysics import (
            SaturationAdjustment, density_saturation_adjust_static_energy)
        from breeze_tpu.thermo.constants import MoistureMassFractions
        from breeze_tpu.thermo.saturation import saturation_specific_humidity
        from breeze_tpu.thermo.states import static_energy

        scheme = bz.SaturationAdjustment(equilibrium=bz.WarmPhaseEquilibrium())
        T_true = jnp.asarray([[[285.0]]])
        rho = jnp.asarray([[[1.05]]])
        z = jnp.asarray([[[500.0]]])
        qvs = saturation_specific_humidity(T_true, rho, CONST, 1.0)
        ql_true = 0.8e-3
        qt = qvs + ql_true
        q_true = MoistureMassFractions(qvs, jnp.full_like(qvs, ql_true),
                                       jnp.zeros_like(qvs))
        e = static_energy(T_true, z, q_true, CONST)

        T, q, p = density_saturation_adjust_static_energy(
            e, z, rho, qt, CONST, scheme)
        np.testing.assert_allclose(float(T.ravel()[0]), 285.0, atol=2e-3)
        np.testing.assert_allclose(float(q.liquid.ravel()[0]),
                                   float(jnp.ravel(jnp.asarray(ql_true))[0])
                                   if hasattr(ql_true, "ravel") else ql_true,
                                   rtol=2e-2)
        np.testing.assert_allclose(
            np.asarray(p),
            np.asarray(rho * CONST.mixture_gas_constant(q) * T),
            rtol=1e-12)

    def test_moist_model_steps(self):
        """Moist ρe compressible model runs and stays finite/sane."""
        g = comp_grid(nx=16, nz=16, dtype=jnp.float64)
        model = make_compressible_model(
            g, formulation="static_energy", advection=bz.WENO(5),
            microphysics=bz.SaturationAdjustment(
                equilibrium=bz.WarmPhaseEquilibrium()),
            time_discretization=SplitExplicitTimeDiscretization(substeps=6))

        def theta0(x, y, z):
            r = jnp.sqrt((x - 10_000.0) ** 2 + (z - 3_000.0) ** 2)
            return 300.0 + 1.5 * jnp.maximum(0.0, 1.0 - r / 2_500.0)

        state = compressible_initial_state(
            model, theta=theta0, qt=lambda x, y, z: 6e-3 * jnp.exp(-z / 2500.0))
        for _ in range(5):
            state = acoustic_rk3_step(model, state, 5.0)
        aux = compressible_diagnose(model, state)
        assert bool(jnp.all(jnp.isfinite(aux.T)))
        assert float(aux.T.min()) > 200.0 and float(aux.T.max()) < 330.0
        assert float(jnp.abs(aux.w).max()) < 10.0


class TestCrossFormulation:
    def test_theta_and_energy_bubbles_agree(self):
        """Dry warm bubble: the two formulations track each other closely
        over a short run (they solve the same physics; fast-wave treatment
        differs at the acoustic scale only)."""
        g = comp_grid(nx=32, nz=24, dtype=jnp.float64)

        def theta0(x, y, z):
            r = jnp.sqrt((x - 10_000.0) ** 2 + (z - 2_000.0) ** 2)
            return 300.0 + 2.0 * jnp.maximum(0.0, 1.0 - r / 2_000.0)

        results = {}
        for form in ("potential_temperature", "static_energy"):
            model = make_compressible_model(
                g, formulation=form, advection=bz.WENO(5),
                time_discretization=SplitExplicitTimeDiscretization(
                    substeps=6))
            state = compressible_initial_state(model, theta=theta0)
            for _ in range(10):
                state = acoustic_rk3_step(model, state, 2.0)
            results[form] = compressible_diagnose(model, state)

        # ~7% w agreement measured: the formulations advect different
        # energy variables (θˡⁱ vs e) and treat fast-wave energetics
        # differently, so this pins CONSISTENCY, not equivalence.
        w_th = np.asarray(results["potential_temperature"].w)
        w_en = np.asarray(results["static_energy"].w)
        scale = np.abs(w_th).max()
        assert scale > 1e-4  # the bubble actually rose
        np.testing.assert_allclose(w_en, w_th, atol=0.10 * scale)
        T_th = np.asarray(results["potential_temperature"].T)
        T_en = np.asarray(results["static_energy"].T)
        np.testing.assert_allclose(T_en, T_th, atol=0.1)
