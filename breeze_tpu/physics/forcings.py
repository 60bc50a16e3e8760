"""Forcings: geostrophic pressure gradient, subsidence, sponge layers, custom.

Equivalent of reference ``src/Forcings/`` (`GeostrophicForcing`
``geostrophic_forcings.jl:11-138``, `SubsidenceForcing`
``subsidence_forcing.jl:14-137``, upper sponges
``time_discretizations.jl:387-507``).  Each forcing is a callable
``(model, state, aux, G) -> G`` composed in ``compute_tendencies``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from .. import fields as fl


def horizontal_mean(a):
    """GLOBAL horizontal mean, shape (nz, 1, 1).

    Under GSPMD ``jnp.mean`` is already global (XLA all-reduces).  Under
    ``shard_map`` a plain ``jnp.mean`` is the LOCAL shard's mean, so every
    mean-based forcing would do different physics per shard; here the local
    mean is ``lax.pmean``-ed over whatever mesh axes are active (the
    :func:`breeze_tpu.parallel.halo.shard_axes` context — the same pattern
    DynamicSmagorinsky uses for its statistical averaging).  Shards are
    equal-sized (shard_map requires even division), so pmean of local means
    is the exact global mean.  Reference semantics: horizontal field means
    are global under MPI (``subsidence_forcing.jl:14-137``).
    """
    m = jnp.mean(a, axis=(1, 2), keepdims=True)
    from ..parallel.halo import _current_axes
    for _ax, name in _current_axes().items():
        m = jax.lax.pmean(m, name)
    return m


def _rep(G, **kw):
    """Replace fields on either a dataclass (anelastic G) or NamedTuple
    (compressible SlowTendencies) tendency container."""
    if hasattr(G, "replace"):
        return G.replace(**kw)
    return G._replace(**kw)


@dataclasses.dataclass(frozen=True)
class GeostrophicForcing:
    """Coriolis-consistent large-scale pressure gradient.

    Adds −f × ρUᵍ so the configured Coriolis term balances the geostrophic
    wind: Fᵤ = −ρ f vᵍ(z), Fᵥ = +ρ f uᵍ(z).  ``u_g``/``v_g`` are callables
    of z or constants.
    """

    f: float
    u_g: float | Callable = 0.0
    v_g: float | Callable = 0.0

    def __call__(self, model, state, aux, G):
        g = model.grid
        z = g.z_c_col
        ug = self.u_g(z) if callable(self.u_g) else self.u_g
        vg = self.v_g(z) if callable(self.v_g) else self.v_g
        rho = model.reference.rho_col
        G = _rep(G,
            rho_u=G.rho_u - rho * self.f * vg,
            rho_v=G.rho_v + rho * self.f * ug,
        )
        return G


@dataclasses.dataclass(frozen=True)
class SubsidenceForcing:
    """Large-scale subsidence: F_c = −ρ wˢ(z) ∂z⟨c⟩ for θ and qᵗ.

    The horizontal mean is recomputed every stage (reference
    ``subsidence_forcing.jl:14-137`` recomputes means in
    ``compute_forcing!``); this is a cheap per-level reduction
    (psum-mean over the mesh when sharded).
    """

    w_profile: Callable  # w_s(z) at cell centers, callable of z column

    def __call__(self, model, state, aux, G):
        g = model.grid
        w_s = self.w_profile(g.z_c_col)
        rho = model.reference.rho_col
        # ∂z of a horizontal mean is pure COLUMN arithmetic — the previous
        # form broadcast the mean to a full field, halo-padded it, and ran
        # the 3-D stencil (~5 full-field HBM passes per scalar per stage
        # for O(nz) math).  Column equivalent of pad(CCC even-mirror) +
        # dz_cf + center interp: face derivative (m[k]−m[k−1])/Δzᶠ with the
        # wall face mirrored to zero, top face extrapolated.
        dz_f = g.dz_f_col

        def dz_mean(c):
            mean = horizontal_mean(c)                           # (nz,1,1)
            dm = (mean[1:] - mean[:-1]) / dz_f[1: g.nz]
            ddz_f = jnp.concatenate([jnp.zeros_like(dm[:1]), dm], 0)
            return 0.5 * (ddz_f + jnp.concatenate([ddz_f[1:], ddz_f[-1:]], 0))

        G = _rep(G, rho_theta=G.rho_theta - rho * w_s * dz_mean(aux.theta))
        if getattr(G, "rho_qt", None) is not None:
            G = _rep(G, rho_qt=G.rho_qt - rho * w_s * dz_mean(aux.qt))
        return G


@dataclasses.dataclass(frozen=True)
class DrySubsidenceTendency:
    """Prescribed large-scale drying: F_qt(z) added to ρqᵗ (e.g. BOMEX)."""

    tendency_profile: Callable  # dqt/dt(z)

    def __call__(self, model, state, aux, G):
        if getattr(G, "rho_qt", None) is None:
            return G
        g = model.grid
        rho = model.reference.rho_col
        return _rep(G, rho_qt=G.rho_qt + rho * self.tendency_profile(g.z_c_col))


@dataclasses.dataclass(frozen=True)
class UpperSponge:
    """Rayleigh damping toward the reference/horizontal-mean state aloft.

    Analogue of the reference's `UpperSponge` with smooth ramps
    (``time_discretizations.jl:387-507``): damping rate
    σ(z) = rate · sin²(π/2 · (z − z₀)/(L)) for z > z₀.
    Momentum damps to zero w and to the horizontal-mean u, v; θ damps to its
    horizontal mean.
    """

    rate: float
    bottom: float               # sponge start height z₀
    damp_scalars: bool = False

    def _sigma(self, model):
        g = model.grid
        z = g.z_c_col
        zf = g.z_f_col
        L = max(g.Lz - self.bottom, 1e-30)
        ramp_c = jnp.sin(0.5 * jnp.pi * jnp.clip((z - self.bottom) / L, 0, 1)) ** 2
        ramp_f = jnp.sin(0.5 * jnp.pi * jnp.clip((zf - self.bottom) / L, 0, 1)) ** 2
        return self.rate * ramp_c, self.rate * ramp_f

    def __call__(self, model, state, aux, G):
        sig_c, sig_f = self._sigma(model)
        mean_u = horizontal_mean(state.rho_u)
        mean_v = horizontal_mean(state.rho_v)
        G = _rep(G,
            rho_u=G.rho_u - sig_c * (state.rho_u - mean_u),
            rho_v=G.rho_v - sig_c * (state.rho_v - mean_v),
            rho_w=G.rho_w - sig_f * state.rho_w,
        )
        if self.damp_scalars:
            mean_t = horizontal_mean(state.rho_theta)
            G = _rep(G,rho_theta=G.rho_theta - sig_c * (state.rho_theta - mean_t))
        return G


@dataclasses.dataclass(frozen=True)
class OpenBoundaryRelaxation:
    """Flow-relaxation (Davies 1976) open lateral boundaries.

    Analogue of the reference's open-boundary relaxation
    (``acoustic_substepping.jl:1279-1356`` open-BC handling;
    ``test/open_boundary_momentum.jl``): prognostic fields in edge zones of
    a bounded horizontal axis relax toward an exterior (typically the
    initial/large-scale) state with a smoothly ramped rate, absorbing
    outgoing waves instead of reflecting them off the wall.

    ``axis``: "x" or "y"; ``width``: zone width in cells; ``rate``: peak
    inverse timescale at the outermost cell.  ``exterior``: a State-like
    pytree of target fields (None entries relax toward zero momentum).
    """

    axis: str = "x"
    width: int = 8
    rate: float = 0.05
    exterior: object = None

    def _ramp(self, grid):
        ax = 2 if self.axis == "x" else 1
        n = grid.shape[ax]
        idx = jnp.arange(n)
        d = jnp.minimum(idx, n - 1 - idx).astype(grid.dtype)
        w = jnp.maximum(0.0, 1.0 - d / self.width)
        sig = self.rate * jnp.sin(0.5 * jnp.pi * w) ** 2
        shape = [1, 1, 1]
        shape[ax] = n
        return sig.reshape(shape)

    def __call__(self, model, state, aux, G):
        sig = self._ramp(model.grid)
        G = _rep(G,
            rho_u=G.rho_u - sig * (state.rho_u - self._target("rho_u", 0.0)),
            rho_v=G.rho_v - sig * (state.rho_v - self._target("rho_v", 0.0)),
            rho_w=G.rho_w - sig * state.rho_w,
        )
        # θ (and moisture) relax only when an exterior state is provided.
        if self.exterior is not None:
            ext_t = getattr(self.exterior, "rho_theta", None)
            if ext_t is not None:
                G = _rep(G,rho_theta=G.rho_theta - sig * (state.rho_theta - ext_t))
            ext_q = getattr(self.exterior, "rho_qt", None)
            if ext_q is not None and getattr(G, "rho_qt", None) is not None:
                G = _rep(G, rho_qt=G.rho_qt - sig * (state.rho_qt - ext_q))
        return G

    def _target(self, name, default):
        if self.exterior is None:
            return default
        val = getattr(self.exterior, name, None)
        return default if val is None else val


@dataclasses.dataclass(frozen=True)
class SpecificForcing:
    """Wrap a per-mass forcing f(x, y, z, t) into a density forcing on a field.

    Analogue of reference `SpecificForcing` (``specific_forcing.jl:12-80``).
    ``field`` ∈ {"rho_u", "rho_v", "rho_w", "rho_theta", "rho_qt"}.
    """

    field: str
    func: Callable  # (x, y, z, t) -> per-mass tendency

    def __call__(self, model, state, aux, G):
        g = model.grid
        x, y, z = g.xyz_c()
        rho = (model.reference.rho_f_col if self.field == "rho_w"
               else model.reference.rho_col)
        incr = rho * self.func(x, y, z, state.time)
        return _rep(G,**{self.field: getattr(G, self.field) + incr})
