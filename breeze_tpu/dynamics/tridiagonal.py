"""Batched tridiagonal (Thomas) solver along the z axis.

Equivalent of the reference's ``BatchedTridiagonalSolver``
(used by the acoustic substepper, ``acoustic_substepping.jl:218-223,487``,
and vertically-implicit diffusion).  The solve is sequential in z (leading
axis) and vectorized across every (y, x) column via ``lax.scan`` — z is never sharded (SURVEY.md §2.3), so no communication.

Coefficients may vary per column and per call (the acoustic coefficients are
refreshed every RK stage), so no precomputed factorization here — contrast
:mod:`breeze_tpu.dynamics.poisson`, whose factors are time-independent.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.named_scope("thomas_solve")
def thomas_solve(lower, diag, upper, rhs):
    """Solve tridiagonal systems along axis 0.

    ``lower[k]`` couples row k to k-1 (lower[0] ignored), ``upper[k]``
    couples row k to k+1 (upper[-1] ignored).  All inputs share a leading
    z axis; trailing axes are batch dims.
    """
    n = rhs.shape[0]

    def fwd(carry, inputs):
        c_prev, d_prev = carry
        a_k, b_k, c_k, r_k = inputs
        den = b_k - a_k * c_prev
        inv = 1.0 / den
        c_new = c_k * inv
        d_new = (r_k - a_k * d_prev) * inv
        return (c_new, d_new), (c_new, d_new)

    zeros = jnp.zeros_like(rhs[0])
    (_, _), (c_prime, d_prime) = jax.lax.scan(
        fwd, (zeros, zeros), (lower, diag, upper, rhs))

    def bwd(x_next, inputs):
        c_k, d_k = inputs
        x_k = d_k - c_k * x_next
        return x_k, x_k

    x_last = d_prime[n - 1]
    _, x_rev = jax.lax.scan(
        bwd, x_last, (c_prime[: n - 1][::-1], d_prime[: n - 1][::-1]))
    return jnp.concatenate([x_rev[::-1], x_last[None]], axis=0)
