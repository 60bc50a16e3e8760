"""Adaptive implicit vertical advection (AIVA) tests.

Reference: ``src/AtmosphereModels/implicit_vertical_advection.jl:78-230``
(adaptive explicit/implicit split removing the vertical advective CFL
limit).  Design: CFL-scaled explicit fluxes + a fused upwind/diffusion
tridiagonal solve (``breeze_tpu/dynamics/vertical_implicit.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import breeze_tpu as bz
from breeze_tpu import model as M
from breeze_tpu.timesteppers import ssp_rk3_step


def _stretched_grid(nx=16, nz=32, dz_min=10.0, dtype=jnp.float64):
    zf = bz.piecewise_stretched_z(nz, 400.0, dz_min, 3200.0)
    return bz.make_grid((nx, 1, nz), x=(0.0, 1600.0), y=(0.0, 1.0), z=zf,
                        topology=(bz.PERIODIC, bz.FLAT, bz.BOUNDED),
                        dtype=dtype)


def _circulation_state(model, w0=5.0):
    """Divergence-free-ish x-z overturning cell whose updraft core sits in
    the fine (Δz = 10 m) surface layers, so the VERTICAL advective CFL is
    the binding one; projection cleans up the residual divergence."""
    g = model.grid
    k = 2 * jnp.pi / 1600.0

    def _G(z):
        return jnp.exp(-((z - 150.0) / 120.0) ** 2)

    def u_fn(x, y, z):
        dGdz = -2.0 * (z - 150.0) / 120.0 ** 2 * _G(z)
        return -(w0 / k) * jnp.cos(k * x) * dGdz

    def w_fn(x, y, z):
        return w0 * jnp.sin(k * x) * _G(z)

    def theta_fn(x, y, z):
        return 300.0 + 1.0 * jnp.sin(k * x) * jnp.exp(
            -((z - 150.0) / 120.0) ** 2)

    state = M.initial_state(model, u=u_fn, w=w_fn, theta=theta_fn)
    ru, rv, rw, _ = M.pressure_projection(
        model, state.rho_u, state.rho_v, state.rho_w, 1.0)
    return state.replace(rho_u=ru, rho_v=rv, rho_w=rw)


def _make(scheme, **kw):
    g = _stretched_grid()
    model = bz.make_model(g, advection=scheme, potential_temperature=300.0,
                          **kw)
    return g, model


class TestAivaSplit:
    def test_scale_is_one_below_cfl(self):
        from breeze_tpu.dynamics.vertical_implicit import aiva_split
        g = _stretched_grid()
        w = 0.01 * jnp.ones(g.shape, g.dtype)
        sp = aiva_split(g, w, dt=1.0, cfl=0.7)
        np.testing.assert_allclose(np.asarray(sp.s_scal), 1.0)
        np.testing.assert_allclose(np.asarray(sp.wI_scal), 0.0)

    def test_split_partitions_velocity(self):
        """s·w̄ (explicit) + w̄ⁱ (implicit) = w̄ exactly."""
        from breeze_tpu.dynamics.vertical_implicit import aiva_split
        g = _stretched_grid()
        rng = np.random.default_rng(3)
        w = jnp.asarray(rng.normal(size=g.shape) * 8.0)
        sp = aiva_split(g, w, dt=5.0, cfl=0.7)
        np.testing.assert_allclose(np.asarray(sp.s_scal * w + sp.wI_scal),
                                   np.asarray(w), rtol=1e-12, atol=1e-12)
        # where active, the explicit part sits exactly at the target CFL
        alpha = np.abs(np.asarray(w)) * 5.0 / np.asarray(g.dz_f_col)
        s = np.asarray(sp.s_scal)
        active = alpha > 0.7
        np.testing.assert_allclose((s * alpha)[active], 0.7, rtol=1e-12)


class TestAivaStep:
    def test_inactive_matches_plain_scheme(self):
        """Weak flow (α < cfl everywhere): AIVA step == plain WENO step."""
        g, model_p = _make(bz.WENO(5))
        _, model_a = _make(bz.AdaptiveImplicitVerticalAdvection(bz.WENO(5),
                                                                cfl=0.7))
        state = _circulation_state(model_p, w0=0.05)
        dt = 1.0   # alpha ~ 0.05*1/10 = 0.005 << 0.7
        sp = ssp_rk3_step(model_p, state, dt)
        sa = ssp_rk3_step(model_a, state, dt)
        np.testing.assert_allclose(np.asarray(sa.rho_w),
                                   np.asarray(sp.rho_w), atol=1e-12)
        np.testing.assert_allclose(np.asarray(sa.rho_theta),
                                   np.asarray(sp.rho_theta), atol=1e-10)

    @pytest.mark.nightly
    def test_stable_at_5x_vertical_cfl(self):
        """VERDICT round-1 item 4 acceptance: stable at 5× the explicit
        vertical CFL on a stretched grid; the explicit twin blows up."""
        g, model_a = _make(
            bz.AdaptiveImplicitVerticalAdvection(bz.WENO(5), cfl=0.7))
        _, model_e = _make(bz.WENO(5))
        w0 = 5.0
        dz_min = float(np.min(np.asarray(g.dz_f)[1:]))
        dt = 5.0 * 0.7 * dz_min / w0          # 5× the explicit limit
        sa = _circulation_state(model_a, w0=w0)
        se = _circulation_state(model_e, w0=w0)
        for _ in range(15):
            sa = ssp_rk3_step(model_a, sa, dt)
            se = ssp_rk3_step(model_e, se, dt)
        wa = np.asarray(sa.rho_w / model_a.reference.rho_f_col)
        assert np.all(np.isfinite(wa))
        assert np.abs(wa).max() < 4.0 * w0
        ta = np.asarray(sa.rho_theta / model_a.reference.rho_col)
        assert np.abs(ta - 300.0).max() < 10.0
        we = np.asarray(se.rho_w)
        assert (not np.all(np.isfinite(we))) or np.abs(we).max() > 1e3

    def test_conserves_scalar_mass_on_stretched_grid(self):
        g, model = _make(
            bz.AdaptiveImplicitVerticalAdvection(bz.WENO(5), cfl=0.7))
        state = _circulation_state(model, w0=5.0)
        dz = g.dz_c_col
        m0 = float(jnp.sum(state.rho_theta * dz))
        dt = 5.0
        for _ in range(10):
            state = ssp_rk3_step(model, state, dt)
        m1 = float(jnp.sum(state.rho_theta * dz))
        assert abs(m1 - m0) / abs(m0) < 1e-12

    @pytest.mark.nightly
    def test_converges_to_explicit_at_small_dt(self):
        """Shrinking dt deactivates the split → AIVA ≈ explicit solution."""
        g, model_a = _make(
            bz.AdaptiveImplicitVerticalAdvection(bz.WENO(5), cfl=0.7))
        _, model_e = _make(bz.WENO(5))
        sa = _circulation_state(model_a, w0=2.0)
        se = _circulation_state(model_e, w0=2.0)
        dt = 0.25    # alpha ~ 2*0.25/10 = 0.05 << 0.7 → identical paths
        for _ in range(8):
            sa = ssp_rk3_step(model_a, sa, dt)
            se = ssp_rk3_step(model_e, se, dt)
        np.testing.assert_allclose(np.asarray(sa.rho_theta),
                                   np.asarray(se.rho_theta),
                                   rtol=1e-10, atol=1e-10)

    def test_fused_with_implicit_closure(self):
        """AIVA + vertically-implicit diffusion share one tridiagonal."""
        from breeze_tpu.physics.closures import ConstantDiffusivity
        closure = ConstantDiffusivity(viscosity=1.0, diffusivity=1.0,
                                      vertically_implicit=True)
        g, model = _make(
            bz.AdaptiveImplicitVerticalAdvection(bz.WENO(5), cfl=0.7),
            closure=closure)
        state = _circulation_state(model, w0=5.0)
        dt = 5.0
        for _ in range(5):
            state = ssp_rk3_step(model, state, dt)
        assert bool(jnp.all(jnp.isfinite(state.rho_theta)))
        assert bool(jnp.all(jnp.isfinite(state.rho_w)))
