"""Adaptive implicit vertical advection (AIVA) support.

Equivalent of reference ``implicit_vertical_advection.jl:78-230``
(Oceananigans ``AdaptiveImplicitVerticalAdvection`` + the reference's
z-Face vertical-momentum coefficients): wherever the local vertical
advective CFL α = |w̄|Δt/Δz exceeds the target, the explicit vertical flux
is scaled by s = cfl/α (see the ``z_flux_scale`` hooks in
:mod:`breeze_tpu.advection`) and the remainder velocity w̄ⁱ = w̄(1 − s) is
applied implicitly as a density-weighted first-order-upwind backward-Euler
tridiagonal solve — fused here with the vertically-implicit closure
diffusion into ONE Thomas solve per field class (one ``lax.scan`` pair over
z, all columns vectorized).

Deviation from the reference: the reference interpolates w̄ with the
explicit scheme's symmetric reconstruction; we use the second-order average
(identical for the default even-order interpolants at these locations).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .tridiagonal import thomas_solve


def _scale(alpha, cfl):
    """s = min(1, cfl/α) without dividing by zero."""
    safe = jnp.maximum(alpha, 1e-30)
    return jnp.where(alpha > cfl, cfl / safe, 1.0)


class AivaSplit(NamedTuple):
    """Explicit-flux scales + implicit remainder velocities per location.

    ``s_*`` multiply the explicit vertical fluxes; ``wI_*`` feed the
    implicit upwind solve.  Locations: scalars/u/v at the z-face flux
    locations (u: x-face, v: y-face columns), w at z-centers.
    """

    s_scal: jax.Array
    s_u: jax.Array
    s_v: jax.Array
    s_w: jax.Array
    wI_scal: jax.Array
    wI_u: jax.Array
    wI_v: jax.Array
    wI_w: jax.Array


def aiva_split(grid, w, dt, cfl) -> AivaSplit:
    """Compute the explicit/implicit vertical-velocity split from ``w``
    (interior z-face field, faces 0..nz-1; wall face 0 carries w = 0)."""
    dz_f = grid.dz_f_col          # (nz,1,1) — hop between centers at face k
    dz_c = grid.dz_c_col

    def split(wbar, dz):
        alpha = jnp.abs(wbar) * (dt / dz)
        s = _scale(alpha, cfl)
        return s, wbar * (1.0 - s)

    from ..parallel.halo import wrap_roll
    s_scal, wI_scal = split(w, dz_f)
    s_u, wI_u = split(0.5 * (w + wrap_roll(w, 1, 2)), dz_f)
    s_v, wI_v = split(0.5 * (w + wrap_roll(w, 1, 1)), dz_f)
    # w̄ at centers: mean of faces k, k+1 (lid w = 0)
    w_up = jnp.concatenate([w[1:], jnp.zeros_like(w[:1])], axis=0)
    s_w, wI_w = split(0.5 * (w + w_up), dz_c)
    return AivaSplit(s_scal, s_u, s_v, s_w, wI_scal, wI_u, wI_v, wI_w)


def _up(a):
    """Shift k → k+1 slot (entry nz-1 gets 0: lid flux vanishes)."""
    return jnp.concatenate([a[1:], jnp.zeros_like(a[:1])], axis=0)


def _dn(a):
    """Shift k → k-1 slot (entry 0 arbitrary; wall rows are pinned)."""
    return jnp.concatenate([a[:1], a[:-1]], axis=0)


def solve_center_field(grid, rho_c, rho_f_stored, rho_f_above, wI,
                       rho_field, dt_eff, diff_coeff=None):
    """Backward-Euler solve for a z-CENTER prognostic ρc:

        (ρc)ⁿ⁺¹ + Δt ∂z(ρᶠ w̄ⁱ c_upwind)ⁿ⁺¹ − Δt ∂z(ρᶠ κ ∂z c)ⁿ⁺¹ = (ρc)★

    ``wI`` at the stored z-faces (0..nz-1; face 0 = wall, wI = 0 there);
    ``rho_f_stored``/``rho_f_above`` the face densities at faces k and k+1.
    ``diff_coeff`` (κ at centers) folds the vertically-implicit closure
    diffusion into the same tridiagonal (reference ``implicit_step!``).
    """
    dz_c = grid.dz_c_col
    dz_f = grid.dz_f_col
    lam = dt_eff / dz_c

    wp = jnp.maximum(wI, 0.0)
    wm = jnp.minimum(wI, 0.0)
    lower = -lam * rho_f_stored * wp
    upper = lam * rho_f_above * _up(wm)
    diag = (jnp.zeros_like(rho_field) + rho_c
            + lam * (rho_f_above * _up(wp) - rho_f_stored * wm))

    if diff_coeff is not None:
        coeff_f = 0.5 * (diff_coeff + _dn(diff_coeff))
        a_fac = rho_f_stored * coeff_f / dz_f
        a_fac = a_fac.at[0].set(0.0)
        a_up = _up(a_fac)
        lower = lower - lam * a_fac
        upper = upper - lam * a_up
        diag = diag + lam * (a_fac + a_up)

    c = rho_field / rho_c
    c_new = thomas_solve(lower, diag, upper, rho_c * c)
    return c_new * rho_c


def solve_w_field(grid, rho_c, rho_f_stored, wI_c, rho_w, dt_eff):
    """Backward-Euler upwind solve for vertical momentum ρw (z-FACE rows).

    Row k (face) spans centers k−1 and k; flux at center k is
    ρᶜ_k w̄ⁱᶜ_k ω_upwind with ω = ρw/ρᶠ (reference z-Face coefficients,
    ``implicit_vertical_advection.jl:219-230``).  Wall face 0 is an
    identity row (ρw = 0 there).
    """
    dz_f = grid.dz_f_col
    lam = dt_eff / dz_f

    wpc = jnp.maximum(wI_c, 0.0)
    wmc = jnp.minimum(wI_c, 0.0)
    rho_c_b = jnp.zeros_like(rho_w) + rho_c      # broadcast
    diag = rho_f_stored + lam * (rho_c * wpc - _dn(rho_c_b * wmc))
    upper = lam * rho_c * wmc
    lower = -lam * _dn(rho_c_b * wpc)

    diag = diag.at[0].set(1.0)
    lower = lower.at[0].set(0.0)
    upper = upper.at[0].set(0.0)
    rhs = rho_w.at[0].set(0.0)

    omega = thomas_solve(lower, diag, upper, rhs)
    return (omega * rho_f_stored).at[0].set(0.0)


def implicit_vertical_step(model, state, aux, new_ru, new_rv, new_rw,
                           new_rt, new_rq, new_tr, dt_eff, dt_full):
    """Combined vertically-implicit stage solve for the anelastic stepper:
    AIVA upwind advection (when the model's advection is wrapped in
    :class:`breeze_tpu.advection.AdaptiveImplicitVerticalAdvection`) and
    closure diffusion (when ``closure.vertically_implicit``), in one
    tridiagonal pass per field.  Returns
    ``(ru, rv, rw, rt, rq, tracers)``.
    """
    from .. import advection as adv
    from ..physics.closures import eddy_coefficients

    g = model.grid
    ref = model.reference
    rho_c = ref.rho_col
    rho_f_stored = ref.rho_f_col                       # faces 0..nz-1
    rho_f_above = jnp.asarray(ref.rho_f)[1:, None, None]  # faces 1..nz

    aiva_mom = isinstance(model.momentum_advection,
                          adv.AdaptiveImplicitVerticalAdvection)
    aiva_scal = isinstance(model.scalar_advection,
                           adv.AdaptiveImplicitVerticalAdvection)

    nu_c = kappa_c = None
    if model.closure is not None and getattr(model.closure,
                                             "vertically_implicit", False):
        nu_c, kappa_c = eddy_coefficients(model, state)

    split_m = split_s = None
    if aiva_mom:
        split_m = aiva_split(g, aux.w, dt_full, model.momentum_advection.cfl)
    if aiva_scal:
        split_s = (split_m if (aiva_mom and model.scalar_advection
                               is model.momentum_advection)
                   else aiva_split(g, aux.w, dt_full,
                                   model.scalar_advection.cfl))

    zeros = jnp.zeros(g.shape, g.dtype)
    wI_u = split_m.wI_u if split_m is not None else zeros
    wI_v = split_m.wI_v if split_m is not None else zeros
    wI_s = split_s.wI_scal if split_s is not None else zeros

    if split_m is not None or nu_c is not None:
        new_ru = solve_center_field(g, rho_c, rho_f_stored, rho_f_above,
                                    wI_u, new_ru, dt_eff, nu_c)
        new_rv = solve_center_field(g, rho_c, rho_f_stored, rho_f_above,
                                    wI_v, new_rv, dt_eff, nu_c)
    if split_m is not None:
        new_rw = solve_w_field(g, rho_c, rho_f_stored, split_m.wI_w,
                               new_rw, dt_eff)
    if split_s is not None or kappa_c is not None:
        new_rt = solve_center_field(g, rho_c, rho_f_stored, rho_f_above,
                                    wI_s, new_rt, dt_eff, kappa_c)
        if new_rq is not None:
            new_rq = solve_center_field(g, rho_c, rho_f_stored, rho_f_above,
                                        wI_s, new_rq, dt_eff, kappa_c)
        new_tr = {k: solve_center_field(g, rho_c, rho_f_stored, rho_f_above,
                                        wI_s, v, dt_eff, kappa_c)
                  for k, v in new_tr.items()}
    return new_ru, new_rv, new_rw, new_rt, new_rq, new_tr
