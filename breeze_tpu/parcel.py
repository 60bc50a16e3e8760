"""0-D Lagrangian parcel model for microphysics prototyping.

Equivalent of reference ``src/ParcelModels/parcel_dynamics.jl``
(`ParcelState` :69, `ParcelDynamics` :137, prescribed/prognostic vertical
velocity :34-45): a single air parcel ascends through a hydrostatic
environment, conserving θˡⁱ and qᵗ while the embedded microphysics
partitions moisture; optional buoyancy-driven prognostic w.

Microphysics coupling (reference ``parcel_dynamics.jl:245-283`` —
``materialize_parcel_microphysics_prognostics`` — and ``:578-584``, where
the parcel's vertical velocity feeds aerosol activation): the parcel
carries ANY scheme's prognostic variables in ``ParcelState.micro`` —

- ``SaturationAdjustment`` (or None): no extra prognostics; (T, qᵛ, qˡ,
  qⁱ) from the equilibrium adjustment, exactly as before.
- ``OneMomentMicrophysics``: per-mass categories ``qcl[, qci], qr[, qs]``
  stepped with the grid scheme's OWN process-rate bundle
  (:func:`~breeze_tpu.physics.one_moment._process_rates` — condensation,
  deposition, autoconversion, accretions, evaporation/sublimation,
  melting) and the grid's closed-budget clamping.
- ``TwoMomentMicrophysics``: ``qcl, qr, ncl, nr`` stepped with the grid
  scheme's pointwise SB2006 process step
  (:func:`~breeze_tpu.physics.two_moment.two_moment_process_step`),
  including ARG2000 κ-Köhler activation driven by the PARCEL's w —
  the scheme's prototyping bed, per the reference.

Sedimentation is a grid-column process and does not apply to a 0-D parcel
(condensate stays in the parcel).  The parcel trajectory integrates with
``lax.scan`` — many parcels batch for free via vmap.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .physics.microphysics import SaturationAdjustment, saturation_adjust
from .thermo.constants import MoistureMassFractions, ThermodynamicConstants
from .thermo.reference import make_reference_state
from .thermo.states import temperature_from_theta_li


class ParcelState(NamedTuple):
    z: jax.Array
    w: jax.Array
    theta_li: jax.Array    # conserved under adiabatic + all phase changes
    qt: jax.Array          # total water (vapor + all condensate categories)
    T: jax.Array
    qv: jax.Array
    ql: jax.Array
    qi: jax.Array
    time: jax.Array
    micro: dict            # scheme prognostics (per-mass), may be empty


def _scheme_prognostics(microphysics) -> tuple[str, ...]:
    """Per-mass prognostic names the parcel materializes for a scheme
    (reference ``materialize_parcel_microphysics_prognostics``)."""
    names = getattr(microphysics, "prognostic_tracer_names", ())
    return tuple(n.removeprefix("rho_") for n in names)


@dataclasses.dataclass(frozen=True)
class ParcelDynamics:
    """Parcel configuration.

    ``vertical_velocity``: a float/callable(t) for prescribed ascent, or
    ``"prognostic"`` for buoyancy-driven w (dw/dt = b).
    """

    constants: ThermodynamicConstants = dataclasses.field(
        default_factory=ThermodynamicConstants)
    microphysics: object = dataclasses.field(default_factory=SaturationAdjustment)
    vertical_velocity: object = 1.0
    surface_pressure: float = 101325.0
    environment_theta: float = 300.0
    p_standard: float = 1.0e5

    def environment_pressure(self, z):
        from .thermo.reference import adiabatic_hydrostatic_pressure

        return adiabatic_hydrostatic_pressure(
            z, self.surface_pressure, self.environment_theta, self.p_standard,
            self.constants)

    def initial_state(self, z=0.0, w=0.0, theta=300.0, qt=0.0,
                      micro=None) -> ParcelState:
        p = self.environment_pressure(jnp.asarray(z, jnp.float32))
        mu = {n: jnp.zeros((), jnp.float32)
              for n in _scheme_prognostics(self.microphysics)}
        if micro:
            for k, v in micro.items():
                assert k in mu, f"unknown parcel prognostic {k!r}"
                mu[k] = jnp.asarray(v, jnp.float32)
        if mu:
            q = self._micro_fractions(jnp.asarray(qt, jnp.float32), mu)
            T = temperature_from_theta_li(jnp.asarray(theta, jnp.float32),
                                          q, p, self.constants,
                                          self.p_standard)
        else:
            T, q = saturation_adjust(jnp.asarray(theta), jnp.asarray(qt), p,
                                     self.constants, self.microphysics,
                                     self.p_standard)
        return ParcelState(
            z=jnp.asarray(z, jnp.float32), w=jnp.asarray(w, jnp.float32),
            theta_li=jnp.asarray(theta, jnp.float32), qt=jnp.asarray(qt, jnp.float32),
            T=T.astype(jnp.float32), qv=q.vapor.astype(jnp.float32),
            ql=q.liquid.astype(jnp.float32), qi=q.ice.astype(jnp.float32),
            time=jnp.zeros((), jnp.float32), micro=mu)

    def _micro_fractions(self, qt, mu) -> MoistureMassFractions:
        """(qᵛ, qˡ, qⁱ) from the scheme prognostics: vapor is the residual
        of total water (no-sedimentation parcels conserve qᵗ)."""
        ql = mu.get("qcl", 0.0) + mu.get("qr", 0.0)
        qi = mu.get("qci", 0.0) + mu.get("qs", 0.0)
        qv = jnp.maximum(qt - ql - qi, 0.0)
        return MoistureMassFractions(qv, ql + 0.0 * qv, qi + 0.0 * qv)

    def step(self, s: ParcelState, dt) -> ParcelState:
        c = self.constants
        if self.vertical_velocity == "prognostic":
            # buoyancy vs the dry environment at the parcel's height
            p = self.environment_pressure(s.z)
            q_env = MoistureMassFractions(0.0, 0.0, 0.0)
            T_env = temperature_from_theta_li(
                jnp.asarray(self.environment_theta), q_env, p, c, self.p_standard)
            q = MoistureMassFractions(s.qv, s.ql, s.qi)
            Rm = c.mixture_gas_constant(q)
            b = c.gravitational_acceleration * (Rm * s.T / (c.Rd * T_env) - 1.0)
            w_new = s.w + dt * b
        else:
            w_new = jnp.asarray(
                self.vertical_velocity(s.time) if callable(self.vertical_velocity)
                else self.vertical_velocity, jnp.float32)

        z_new = s.z + dt * w_new
        p_new = self.environment_pressure(z_new)

        if s.micro:
            T, q, mu = self._micro_step(s, p_new, w_new, dt)
        else:
            T, q = saturation_adjust(s.theta_li, s.qt, p_new, c,
                                     self.microphysics, self.p_standard)
            mu = s.micro
        return ParcelState(
            z=z_new, w=w_new, theta_li=s.theta_li, qt=s.qt,
            T=T, qv=q.vapor, ql=q.liquid, qi=q.ice,
            time=s.time + dt, micro=mu)

    def _micro_step(self, s: ParcelState, p, w, dt):
        """Advance the scheme prognostics with the GRID scheme's own
        process rates at the parcel's (θˡⁱ, ρ, p, w)."""
        from .physics.one_moment import OneMomentMicrophysics
        from .physics.two_moment import (TwoMomentMicrophysics,
                                         two_moment_process_step)
        c = self.constants
        sch = self.microphysics
        mu = dict(s.micro)
        # parcel density from the ideal-gas law at the previous step's T
        # (explicit integration, like the trajectory itself)
        q_prev = self._micro_fractions(s.qt, mu)
        rho = p / (c.mixture_gas_constant(q_prev) * s.T)

        if isinstance(sch, TwoMomentMicrophysics):
            qv = jnp.maximum(s.qt - mu["qcl"] - mu["qr"], 0.0)
            qv1, qcl1, qr1, ncl1, nr1 = two_moment_process_step(
                sch, qv, mu["qcl"], mu["qr"], mu["ncl"], mu["nr"],
                s.theta_li, rho, p, w, dt, c, self.p_standard)
            mu.update(qcl=qcl1, qr=qr1, ncl=ncl1, nr=nr1)
        elif isinstance(sch, OneMomentMicrophysics):
            from .physics.one_moment import _process_rates
            qcl = mu["qcl"]
            qr = mu["qr"]
            qci = mu.get("qci", jnp.zeros_like(qcl))
            qs = mu.get("qs", jnp.zeros_like(qcl))
            qv = jnp.maximum(s.qt - qcl - qci - qr - qs, 0.0)
            T = temperature_from_theta_li(
                s.theta_li, MoistureMassFractions(qv, qcl + qr, qci + qs),
                p, c, self.p_standard)
            dqv, dqcl, dqci, dqr, dqs = _process_rates(
                sch, qv, qcl, qci, qr, qs, rho, T, c,
                c.gravitational_acceleration, min_timescale=dt)
            # grid scheme's closed-budget clamping (one_moment_update)
            qcl1 = jnp.maximum(qcl + dt * dqcl, 0.0)
            qci1 = jnp.maximum(qci + dt * dqci, 0.0)
            qr1 = jnp.maximum(qr + dt * dqr, 0.0)
            qs1 = jnp.maximum(qs + dt * dqs, 0.0)
            mu.update(qcl=qcl1, qr=qr1)
            if "qci" in mu:
                mu.update(qci=qci1, qs=qs1)
        else:
            raise NotImplementedError(
                f"parcel microphysics coupling for {type(sch).__name__}")

        q = self._micro_fractions(s.qt, mu)
        T = temperature_from_theta_li(s.theta_li, q, p, c, self.p_standard)
        return T, q, mu

    def integrate(self, s0: ParcelState, dt, n_steps: int):
        """Trajectory via lax.scan; returns (final, stacked trajectory)."""
        def body(s, _):
            s2 = self.step(s, dt)
            return s2, s2

        return jax.lax.scan(body, s0, None, length=n_steps)
