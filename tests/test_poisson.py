"""Anelastic Fourier-tridiagonal Poisson solver tests.

Mirrors reference ``test/anelastic_pressure_solver_analytic.jl``: build
closed-form (ρᵣ, φ) pairs, apply the discrete operator, and assert the
solver recovers φ; plus a projection contract: after projection,
∇·(ρᵣ u) = 0 to machine precision.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import breeze_tpu as bz
from breeze_tpu import fields as fl
from breeze_tpu.dynamics.poisson import build_anelastic_poisson_solver
from breeze_tpu.model import make_model, initial_state, pressure_projection
from breeze_tpu.ops import StencilOps


def make_case(nx=16, ny=12, nz=20, rho_profile=None, dtype=jnp.float64):
    g = bz.make_grid(size=(nx, ny, nz), extent=(2.0, 1.5, 1.0),
                     topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                     dtype=dtype)
    z_c = np.asarray(g.z_c, np.float64)
    z_f = np.asarray(g.z_f, np.float64)
    if rho_profile is None:
        rho_c = np.exp(-z_c)          # smooth stratified density
        rho_f = np.exp(-z_f)
    else:
        rho_c = rho_profile(z_c)
        rho_f = rho_profile(z_f)
    return g, rho_c, rho_f


def apply_discrete_operator(g, rho_c, rho_f, phi):
    """Apply ∇·(ρᵣ∇φ) with the same discretization the solver inverts."""
    nz, ny, nx = g.shape
    dz_c = np.asarray(g.dz_c, np.float64)
    dz_f = np.asarray(g.dz_f, np.float64)
    phi = np.asarray(phi, np.float64)

    lap_h = ((np.roll(phi, -1, 2) - 2 * phi + np.roll(phi, 1, 2)) / g.dx**2
             + (np.roll(phi, -1, 1) - 2 * phi + np.roll(phi, 1, 1)) / g.dy**2)
    out = rho_c[:, None, None] * lap_h

    # vertical: (1/dz_c) δz(rho_f dφ/dz) with Neumann walls
    grad_f = np.zeros((nz + 1, ny, nx))
    grad_f[1:nz] = (phi[1:] - phi[:-1]) / dz_f[1:nz, None, None]
    flux = rho_f[:, None, None] * grad_f
    out += (flux[1:] - flux[:-1]) / dz_c[:, None, None]
    return out


class TestPoissonSolver:
    def test_recovers_manufactured_solution(self):
        g, rho_c, rho_f = make_case()
        solver = build_anelastic_poisson_solver(g, rho_c, rho_f)

        x = np.asarray(g.x_c())[None, None, :]
        y = np.asarray(g.y_c())[None, :, None]
        z = np.asarray(g.z_c)[:, None, None]
        phi = (np.cos(2 * np.pi * x / 2.0) * np.cos(2 * np.pi * y / 1.5)
               * np.cos(np.pi * z / 1.0) * (1 + 0.3 * z))
        phi -= phi.mean()

        rhs = apply_discrete_operator(g, rho_c, rho_f, phi)
        dt = 0.25
        phi_solved = solver.solve(jnp.asarray(rhs * dt), dt)
        got = np.array(phi_solved)
        # Solution defined up to a constant for the Neumann problem
        got -= got.mean()
        ref = phi - phi.mean()
        np.testing.assert_allclose(got, ref, atol=1e-9)

    def test_zero_rhs_gives_zero(self):
        g, rho_c, rho_f = make_case()
        solver = build_anelastic_poisson_solver(g, rho_c, rho_f)
        phi = solver.solve(jnp.zeros(g.shape, jnp.float64), 1.0)
        np.testing.assert_allclose(np.asarray(phi), 0.0, atol=1e-14)

    def test_constant_density_reduces_to_poisson(self):
        g, rho_c, rho_f = make_case(rho_profile=lambda z: np.ones_like(z))
        solver = build_anelastic_poisson_solver(g, rho_c, rho_f)
        x = np.asarray(g.x_c())[None, None, :]
        phi = np.cos(2 * np.pi * x / 2.0) * np.ones(g.shape)
        rhs = apply_discrete_operator(g, rho_c, rho_f, phi)
        got = np.array(solver.solve(jnp.asarray(rhs), 1.0))
        got -= got.mean()
        np.testing.assert_allclose(got, phi - phi.mean(), atol=1e-10)


class TestProjection:
    def test_projection_kills_divergence(self):
        """After projection, ∇·(ρᵣu) = 0 (the anelastic constraint)."""
        g = bz.make_grid(size=(16, 12, 20), extent=(2000.0, 1500.0, 1000.0),
                         topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                         dtype=jnp.float64)
        model = make_model(g, potential_temperature=300.0)
        rng = np.random.default_rng(42)
        ru = jnp.asarray(rng.normal(size=g.shape))
        rv = jnp.asarray(rng.normal(size=g.shape))
        rw = jnp.asarray(rng.normal(size=g.shape))

        ru2, rv2, rw2, phi = pressure_projection(model, ru, rv, rw, dt=1.0)

        so = StencilOps(g)
        div = so.div_c(fl.pad(ru2, g, fl.CCF), fl.pad(rv2, g, fl.CFC),
                       fl.pad(rw2, g, fl.FCC))
        scale = float(jnp.abs(ru).max())
        np.testing.assert_allclose(np.asarray(div) * g.dx / scale, 0.0, atol=1e-10)

    def test_projection_idempotent(self):
        """Projecting an already-divergence-free field is a no-op."""
        g = bz.make_grid(size=(16, 12, 20), extent=(2000.0, 1500.0, 1000.0),
                         topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                         dtype=jnp.float64)
        model = make_model(g, potential_temperature=300.0)
        rng = np.random.default_rng(7)
        ru = jnp.asarray(rng.normal(size=g.shape))
        rv = jnp.asarray(rng.normal(size=g.shape))
        rw = jnp.asarray(rng.normal(size=g.shape))
        ru1, rv1, rw1, _ = pressure_projection(model, ru, rv, rw, dt=1.0)
        ru2, rv2, rw2, _ = pressure_projection(model, ru1, rv1, rw1, dt=1.0)
        np.testing.assert_allclose(np.asarray(ru2), np.asarray(ru1), atol=1e-10)
        np.testing.assert_allclose(np.asarray(rw2), np.asarray(rw1), atol=1e-10)


class TestMatmulDFT:
    """The matrix-product (real eigenbasis) transform against rfft2."""

    def test_periodic_real_eigenbasis_matches_fft_solver(self):
        """The all-real periodic eigenbasis == library FFT."""
        g, rho_c, rho_f = make_case()
        s_fft = build_anelastic_poisson_solver(g, rho_c, rho_f,
                                               transform="fourier")
        s_real = build_anelastic_poisson_solver(g, rho_c, rho_f,
                                                transform="real")
        assert s_real.transform == "real" and s_real.nxr == g.nx
        rng = np.random.default_rng(5)
        rhs = jnp.asarray(rng.normal(size=g.shape))
        rhs = rhs - rhs.mean()
        p1 = np.array(s_fft.solve(rhs, 0.5))
        p2 = np.array(s_real.solve(rhs, 0.5))
        p1 -= p1.mean()
        p2 -= p2.mean()
        np.testing.assert_allclose(p2, p1, atol=1e-10)

    @pytest.mark.parametrize("vertical", ["scan", "eigen"])
    def test_matmul_projection_kills_divergence(self, vertical):
        import dataclasses as dc
        g = bz.make_grid(size=(16, 12, 20), extent=(2000.0, 1500.0, 1000.0),
                         topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                         dtype=jnp.float64)
        model = make_model(g, potential_temperature=300.0)
        solver_mm = build_anelastic_poisson_solver(
            g, model.reference.rho_c, model.reference.rho_f, transform="real",
            vertical_solve=vertical)
        model = dc.replace(model, solver=solver_mm)
        rng = np.random.default_rng(9)
        ru = jnp.asarray(rng.normal(size=g.shape))
        rv = jnp.asarray(rng.normal(size=g.shape))
        rw = jnp.asarray(rng.normal(size=g.shape))
        ru2, rv2, rw2, _ = pressure_projection(model, ru, rv, rw, dt=1.0)
        so = StencilOps(g)
        div = so.div_c(fl.pad(ru2, g, fl.CCF), fl.pad(rv2, g, fl.CFC),
                       fl.pad(rw2, g, fl.FCC))
        np.testing.assert_allclose(np.asarray(div) * g.dx, 0.0, atol=1e-9)


def apply_discrete_operator_bounded_x(g, rho_c, rho_f, phi):
    """∇·(ρᵣ∇φ) with a wall (Neumann) x-axis and periodic y."""
    nz, ny, nx = g.shape
    dz_c = np.asarray(g.dz_c, np.float64)
    dz_f = np.asarray(g.dz_f, np.float64)
    phi = np.asarray(phi, np.float64)

    # x: interior face fluxes only (zero wall flux)
    gx = np.zeros((nz, ny, nx + 1))
    gx[:, :, 1:nx] = (phi[:, :, 1:] - phi[:, :, :-1]) / g.dx
    lap_x = (gx[:, :, 1:] - gx[:, :, :-1]) / g.dx
    lap_y = (np.roll(phi, -1, 1) - 2 * phi + np.roll(phi, 1, 1)) / g.dy**2
    out = rho_c[:, None, None] * (lap_x + lap_y)

    grad_f = np.zeros((nz + 1, ny, nx))
    grad_f[1:nz] = (phi[1:] - phi[:-1]) / dz_f[1:nz, None, None]
    flux = rho_f[:, None, None] * grad_f
    out += (flux[1:] - flux[:-1]) / dz_c[:, None, None]
    return out


class TestBoundedPoisson:
    """Bounded-x (channel) anelastic Poisson: DCT eigenbasis path
    (reference Bounded-topology FourierTridiagonalPoissonSolver)."""

    def _grid(self, nx=16, ny=12, nz=20):
        g = bz.make_grid(size=(nx, ny, nz), extent=(2.0, 1.5, 1.0),
                         topology=(bz.BOUNDED, bz.PERIODIC, bz.BOUNDED),
                         dtype=jnp.float64)
        z_c = np.asarray(g.z_c, np.float64)
        z_f = np.asarray(g.z_f, np.float64)
        return g, np.exp(-z_c), np.exp(-z_f)

    def test_recovers_manufactured_solution_channel(self):
        g, rho_c, rho_f = self._grid()
        solver = build_anelastic_poisson_solver(g, rho_c, rho_f)

        x = np.asarray(g.x_c())[None, None, :]
        y = np.asarray(g.y_c())[None, :, None]
        z = np.asarray(g.z_c)[:, None, None]
        # DCT mode in x (zero-slope at walls), Fourier in y, smooth in z
        phi = (np.cos(np.pi * x / 2.0) * np.cos(2 * np.pi * y / 1.5)
               * np.cos(np.pi * z))
        rhs = apply_discrete_operator_bounded_x(g, rho_c, rho_f, phi)

        got = solver.solve(jnp.asarray(rhs), 1.0)
        got = np.array(got)
        # solution defined up to a constant
        got = got - got.mean()
        phi0 = phi - phi.mean()
        np.testing.assert_allclose(got, phi0, atol=1e-9)

    def test_channel_projection_kills_divergence(self):
        g = bz.make_grid(size=(24, 1, 16), extent=(3.0, 1.0, 1.0),
                         topology=(bz.BOUNDED, bz.FLAT, bz.BOUNDED),
                         dtype=jnp.float64)
        model = make_model(g, potential_temperature=300.0)
        rng = np.random.default_rng(7)
        ru = jnp.asarray(rng.normal(size=g.shape))
        rv = jnp.zeros(g.shape)
        rw = jnp.asarray(rng.normal(size=g.shape))
        ru2, rv2, rw2, _ = pressure_projection(model, ru, rv, rw, 1.0)
        so = StencilOps(g)
        div = so.div_c(fl.pad(ru2, g, fl.CCF), fl.pad(rv2, g, fl.CFC),
                       fl.pad(rw2, g, fl.FCC))
        assert float(jnp.abs(div).max()) < 1e-10
        # walls stay impenetrable
        assert float(jnp.abs(ru2[:, :, 0]).max()) == 0.0

    def test_channel_bubble_runs_and_conserves(self):
        from breeze_tpu.timesteppers import ssp_rk3_step

        g = bz.make_grid(size=(32, 1, 24), extent=(4000.0, 1.0, 2000.0),
                         topology=(bz.BOUNDED, bz.FLAT, bz.BOUNDED),
                         halo=3, dtype=jnp.float64)
        model = make_model(g, advection=bz.WENO(5), potential_temperature=300.0)
        state = initial_state(
            model, theta=lambda x, y, z: 300.0 + 2.0 * jnp.exp(
                -((x - 2000.0) ** 2 + (z - 500.0) ** 2) / 1e5))
        dzc = np.asarray(g.dz_c)[:, None, None]
        e0 = float(jnp.sum(state.rho_theta * dzc))
        for _ in range(10):
            state = ssp_rk3_step(model, state, 1.0)
        np.testing.assert_allclose(float(jnp.sum(state.rho_theta * dzc)), e0,
                                   rtol=1e-12)
        assert bool(jnp.all(jnp.isfinite(state.rho_w)))
        assert float(jnp.abs(state.rho_u[:, :, 0]).max()) == 0.0


class TestVerticalEigenSolve:
    """The matmul z-eigenbasis vertical solve (vertical_solve='eigen') against
    the Thomas scan: same projection, machine-exact in f64."""

    def _grid_model(self, dtype):
        g = bz.make_grid(size=(64, 32, 48), extent=(6400.0, 3200.0, 3000.0),
                         topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                         halo=3, dtype=dtype)
        model = bz.make_model(g, advection=bz.WENO(5),
                              potential_temperature=300.0)
        return g, model

    def test_f64_matches_scan(self):
        from breeze_tpu.dynamics.poisson import build_anelastic_poisson_solver
        g, model = self._grid_model(jnp.float64)
        ref = model.reference
        scan = build_anelastic_poisson_solver(g, ref.rho_c, ref.rho_f,
                                              transform="real",
                                              vertical_solve="scan")
        eig = build_anelastic_poisson_solver(g, ref.rho_c, ref.rho_f,
                                             transform="real",
                                             vertical_solve="eigen")
        rng = np.random.default_rng(0)
        div = jnp.asarray(rng.normal(size=g.shape), jnp.float64)
        div = div - jnp.mean(div)
        p1 = scan.solve(div, 0.5)
        p2 = eig.solve(div, 0.5)
        d1 = p1 - jnp.mean(p1)   # solutions differ by a nullspace constant
        d2 = p2 - jnp.mean(p2)
        np.testing.assert_allclose(np.asarray(d2), np.asarray(d1),
                                   rtol=0, atol=1e-10 * float(jnp.abs(d1).max()))

    def test_f32_projection_equivalent(self):
        """Post-projection divergence and idempotency through the eigen
        solve match the scan at f32 (the production-relevant contract)."""
        import dataclasses
        from breeze_tpu import fields as fl
        from breeze_tpu import model as M
        from breeze_tpu.dynamics.poisson import build_anelastic_poisson_solver
        g, model = self._grid_model(jnp.float32)
        ref = model.reference
        so = model.stencil_ops()
        rng = np.random.default_rng(1)
        ru = jnp.asarray(rng.normal(size=g.shape), jnp.float32) * ref.rho_col
        rv = jnp.asarray(rng.normal(size=g.shape), jnp.float32) * ref.rho_col
        rw = (jnp.asarray(rng.normal(size=g.shape), jnp.float32)
              * ref.rho_f_col).at[0].set(0.0)
        for vs in ("scan", "eigen"):
            sol = build_anelastic_poisson_solver(g, ref.rho_c, ref.rho_f,
                                                 transform="real",
                                                 vertical_solve=vs)
            mm = dataclasses.replace(model, solver=sol)
            u2, v2, w2, _ = M.pressure_projection(mm, ru, rv, rw, 1.0)
            dd = so.div_c(fl.pad(u2, g, fl.CCF), fl.pad(v2, g, fl.CFC),
                          fl.pad(w2, g, fl.FCC))
            assert float(jnp.abs(dd).max()) < 5e-7, vs
            u3, v3, w3, _ = M.pressure_projection(mm, u2, v2, w2, 1.0)
            assert float(jnp.abs(u3 - u2).max()) < 5e-6, vs


class TestProjectionResidual:
    """The float32 projection reaches the float64 one's accuracy, measured
    in each precision's own unit roundoff ε: the divergence residual
    (``diagnostics.divergence_residual``) is at most FACTOR·ε in both, and
    the float32 residual in units of ε32 is within FACTOR of the float64
    one in units of ε64.  A float32 matrix product taken in TF32 (2⁻¹¹)
    would leave ~1e4·ε32 and fail.  ``chip_smoke.py`` prints the same
    check from the GPU at 256³."""

    FACTOR = 100.0

    @pytest.mark.parametrize("transform,vertical", [
        ("fourier", "scan"), ("real", "scan"), ("real", "eigen")])
    def test_float32_reaches_float64_residual(self, transform, vertical):
        import dataclasses

        from breeze_tpu.diagnostics import divergence_residual
        units = {}
        for dtype in (jnp.float32, jnp.float64):
            g = bz.make_grid(size=(32, 24, 32),
                             extent=(6400.0, 4800.0, 3000.0),
                             topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                             dtype=dtype)
            model = make_model(g, potential_temperature=300.0)
            model = dataclasses.replace(
                model, solver=build_anelastic_poisson_solver(
                    g, model.reference.rho_c, model.reference.rho_f,
                    transform=transform, vertical_solve=vertical))
            rng = np.random.default_rng(0)
            ru, rv, rw = (jnp.asarray(rng.normal(size=g.shape), dtype)
                          for _ in range(3))
            ru, rv, rw, _ = pressure_projection(model, ru, rv, rw, 1.0)
            state = initial_state(model).replace(rho_u=ru, rho_v=rv,
                                                 rho_w=rw)
            units[dtype] = (divergence_residual(model, state)
                            / np.finfo(dtype).eps)
        assert units[jnp.float64] <= self.FACTOR, units
        assert units[jnp.float32] <= self.FACTOR, units
        assert units[jnp.float32] <= self.FACTOR * max(units[jnp.float64],
                                                       1.0), units
