"""Time steppers: SSP-RK3 with per-stage pressure projection.

Equivalent of reference ``src/TimeSteppers/ssp_runge_kutta_3.jl``
(`SSPRungeKutta3` :53-97, substep kernel :113-172, `time_step!` :208-277).
The whole step is one pure function ``state -> state`` — under ``jit`` the
three stages compile into a single XLA program (the reference needs Reactant
to achieve the same, ``ext/BreezeReactantExt``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import model as M

SSP_RK3_ALPHAS = (1.0, 0.25, 2.0 / 3.0)


def ssp_rk3_step(model: M.AtmosphereModel, state: M.State, dt) -> M.State:
    """Advance one Δt with SSP-RK3 + projection each stage.

    Stage structure mirrors reference ``time_step!`` (:208-277): tendencies →
    substep → pressure correction over αΔt → (implicit diffusion step when a
    vertically-implicit closure is configured) → diagnostics refresh (fused
    into the next stage's tendency computation).  Operator-split
    microphysics (`microphysics_model_update!`) runs once after stage 3.

    Each layer runs under a ``jax.named_scope`` (``negative_moisture``,
    ``diagnose``, ``tendencies``, ``implicit_vertical``,
    ``pressure_projection``, ``microphysics``) so a profiler trace can
    attribute device time to it.
    """
    # Negative-moisture repair at step start (reference fix_negative_moisture!,
    # update_atmosphere_model_state.jl:42): species borrowing + Δz-weighted
    # vertical borrowing + number-concentration cleanup.
    if state.rho_qt is not None:
        from .physics.microphysics import apply_negative_moisture_correction
        with jax.named_scope("negative_moisture"):
            state = apply_negative_moisture_correction(model, state)

    # Filtered bulk-flux matching state: one exponential-filter update per
    # outer step (reference update_filtered_surface_state!).
    if getattr(model.boundary_fluxes, "filter", None) is not None:
        from .physics.surface import update_surface_filter
        state = update_surface_filter(model, state,
                                      M.diagnose(model, state), dt)

    from . import advection as adv
    aiva = (isinstance(model.momentum_advection,
                       adv.AdaptiveImplicitVerticalAdvection)
            or isinstance(model.scalar_advection,
                          adv.AdaptiveImplicitVerticalAdvection))
    implicit_closure = (model.closure is not None
                        and getattr(model.closure, "vertically_implicit", False))

    state0 = state
    # Warm-start chain for the saturation-adjustment Newton solve: stage 1
    # starts from the previous STEP's converged T (diagnostics["T_warm"],
    # seeded at initial_state), stages 2-3 from the previous stage's — all
    # stages run scheme.warm_iterations trips (the state moves by O(αΔt)
    # between solves; see SaturationAdjustment.warm_iterations).
    prev_T = state.diagnostics.get("T_warm")
    for alpha in SSP_RK3_ALPHAS:
        with jax.named_scope("diagnose"):
            aux = M.diagnose(model, state, T_guess=prev_T)
        prev_T = aux.T
        with jax.named_scope("tendencies"):
            ns = M.stage_update(model, state, state0, dt, alpha, aux=aux)
        new_ru, new_rv, new_rw = ns.rho_u, ns.rho_v, ns.rho_w
        new_rt, new_rq, new_tr = ns.rho_theta, ns.rho_qt, ns.tracers

        if aiva or implicit_closure:
            # Fused vertically-implicit stage solve: AIVA upwind remainder +
            # closure diffusion in one tridiagonal pass per field
            # (reference implicit_step!, ssp_runge_kutta_3.jl:139-160 +
            # implicit_vertical_advection.jl:78-230).
            from .dynamics.vertical_implicit import implicit_vertical_step
            with jax.named_scope("implicit_vertical"):
                (new_ru, new_rv, new_rw, new_rt, new_rq,
                 new_tr) = implicit_vertical_step(
                    model, state, aux, new_ru, new_rv, new_rw, new_rt,
                    new_rq, new_tr, alpha * dt, dt)

        with jax.named_scope("pressure_projection"):
            new_ru, new_rv, new_rw, _ = M.pressure_projection(
                model, new_ru, new_rv, new_rw, alpha * dt)

        state = state.replace(
            rho_u=new_ru, rho_v=new_rv, rho_w=new_rw,
            rho_theta=new_rt, rho_qt=new_rq, tracers=new_tr)

    # Operator-split microphysics once per step (reference :272; a no-op for
    # the tendency-/adjustment-interface schemes currently implemented).
    if model.microphysics is not None and hasattr(model.microphysics, "model_update"):
        with jax.named_scope("microphysics"):
            state = model.microphysics.model_update(model, state, dt)

    if prev_T is not None and "T_warm" in state.diagnostics:
        # stage-3 T becomes the next step's stage-1 warm start
        state = state.replace(
            diagnostics={**state.diagnostics, "T_warm": prev_T})

    return state.replace(time=state.time + dt)


@partial(jax.jit, static_argnames=("n_steps",))
def many_steps(model: M.AtmosphereModel, state: M.State, dt, n_steps: int) -> M.State:
    """Compile ``n_steps`` into one XLA program via ``lax.fori_loop``.

    Analogue of the reference benchmark harness's traced step loop
    (``benchmarking/src/timestepping.jl:11-31``).
    """
    def body(_, s):
        return ssp_rk3_step(model, s, dt)

    return jax.lax.fori_loop(0, n_steps, body, state)


step_jit = jax.jit(ssp_rk3_step)
