"""Kinematic driver: prescribed-velocity scalar transport for microphysics tests.

Equivalent of reference ``src/KinematicDriver/``
(`PrescribedDensity` :10, `PrescribedDynamics` :33, prognostic ρ tendency
``kinematic_driver_time_stepping.jl:79-96``): velocities are prescribed
functions of (x, y, z, t); only scalars (θ, moisture, tracers) are
prognostic, advected against the reference density — the standard testbed
for microphysics schemes without resolved dynamics.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp

from . import advection as adv
from . import fields as fl
from .grid import Grid
from .model import Aux, State, AtmosphereModel, diagnose as _model_diagnose
from .ops import StencilOps


@dataclasses.dataclass(frozen=True)
class PrescribedDynamics:
    """Prescribed velocity fields u, v, w = f(x, y, z, t).

    ``divergence_correction`` adds +c ∇·(ρU) to every scalar tendency
    (reference ``c_div_ρU``, kinematic_driver_time_stepping.jl:71-74):
    with it the transport is effectively advective-form, so a uniform
    scalar stays uniform under a DIVERGENT prescribed flow.
    ``prognostic_density`` evolves ρ by the continuity equation
    G_ρ = −∇·(ρU) (reference ``_compute_density_tendency!`` :79-96)
    instead of holding the reference column; the evolving ρ is carried in
    ``state.diagnostics['kd_rho']`` and weights the scalar transport.
    """

    u: Callable | float = 0.0
    v: Callable | float = 0.0
    w: Callable | float = 0.0
    divergence_correction: bool = False
    prognostic_density: bool = False

    def velocities(self, grid: Grid, t):
        x, y, z = grid.xyz_c()
        ones = jnp.ones(grid.shape, grid.dtype)

        def ev(f):
            if callable(f):
                return jnp.asarray(f(x, y, z, t), grid.dtype) * ones
            return jnp.full(grid.shape, f, grid.dtype)

        return ev(self.u), ev(self.v), ev(self.w)


def kinematic_step(model: AtmosphereModel, dynamics: PrescribedDynamics,
                   state: State, dt) -> State:
    """SSP-RK3 advance of scalars under prescribed velocities.

    Reuses the AtmosphereModel's thermodynamics/microphysics; the momentum
    equations and pressure projection are bypassed (reference
    ``kinematic_driver_time_stepping.jl``).
    """
    g = model.grid
    so = model.stencil_ops()
    ref = model.reference
    prognostic = dynamics.prognostic_density

    alphas = (1.0, 0.25, 2.0 / 3.0)
    s0 = state
    rho0 = (state.diagnostics.get(
        "kd_rho", jnp.broadcast_to(ref.rho_col, g.shape).astype(g.dtype))
        if prognostic
        else jnp.broadcast_to(ref.rho_col, g.shape).astype(g.dtype))
    rho_now = rho0
    for alpha in alphas:
        u, v, w = dynamics.velocities(g, state.time)
        w = fl.enforce_impenetrability(w, g)
        u_pad = fl.pad(u, g, fl.CCF)
        v_pad = fl.pad(v, g, fl.CFC)
        w_pad = fl.pad(w, g, fl.FCC)
        rho_pad = fl.pad(rho_now, g, fl.CCC)

        div_rhoU = None
        if dynamics.divergence_correction or prognostic:
            # ∇·(ρU): the mass-flux divergence (advecting c ≡ 1)
            ones_pad = fl.pad(jnp.ones(g.shape, g.dtype), g, fl.CCC)
            div_rhoU = adv.div_rho_u_c(so, adv.Centered(2), rho_pad,
                                       u_pad, v_pad, w_pad, ones_pad)

        def G_of(rho_c_field):
            c_spec = rho_c_field / rho_now
            c_pad = fl.pad(c_spec, g, fl.CCC)
            G = -adv.div_rho_u_c(so, model.scalar_advection, rho_pad,
                                 u_pad, v_pad, w_pad, c_pad)
            if dynamics.divergence_correction:
                G = G + c_spec * div_rhoU
            return G

        def sub(cur, init, G):
            return (1 - alpha) * init + alpha * (cur + dt * G)

        new_rt = sub(state.rho_theta, s0.rho_theta, G_of(state.rho_theta))
        new_rq = None
        if state.rho_qt is not None:
            new_rq = sub(state.rho_qt, s0.rho_qt, G_of(state.rho_qt))
        new_tr = {k: sub(state.tracers[k], s0.tracers[k], G_of(state.tracers[k]))
                  for k in state.tracers}
        state = state.replace(rho_theta=new_rt, rho_qt=new_rq, tracers=new_tr)
        if prognostic:
            rho_now = sub(rho_now, rho0, -div_rhoU)
            state = state.replace(diagnostics={**state.diagnostics,
                                               "kd_rho": rho_now})

    if model.microphysics is not None and hasattr(model.microphysics, "model_update"):
        state = model.microphysics.model_update(model, state, dt)

    return state.replace(time=state.time + dt)
