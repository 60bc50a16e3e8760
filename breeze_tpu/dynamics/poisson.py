"""Fourier-tridiagonal Poisson solver for the anelastic pressure projection.

Equivalent of the reference's ``FourierTridiagonalPoissonSolver``
with ρᵣ-weighted diagonals (``src/AnelasticEquations/anelastic_pressure_solver.jl:5-78``).
Solves, for each horizontal Fourier mode with eigenvalue λ = λx + λy ≥ 0,

    ρ̄ᶠ[k+1] (φ[k+1] − φ[k]) / Δzᶠ[k+1]
  − ρ̄ᶠ[k]   (φ[k]   − φ[k−1]) / Δzᶠ[k]
  − ρᶜ[k] Δzᶜ[k] λ φ[k]  =  Δzᶜ[k] δ̂[k] / Δt

with homogeneous Neumann ends (wall couplings dropped), where
δ = ∇·(ρu~) is the predictor mass-flux divergence.

x and y are the transform axes; z is the tridiagonal axis.  The Thomas
forward-elimination factors depend only on (ρᵣ, grid, λ) — all
time-independent — so they are precomputed once in float64 on the host and
the per-step solve is a single forward/backward ``lax.scan`` over z,
vectorized across every mode.  The singular (0,0) mode (Neumann nullspace)
is pinned by replacing its top-level row with φ = 0.  The alternative
vertical solve diagonalises the column operator once on the host and
applies it as two (nz, nz) matrix products over all modes.

Horizontal topologies: the real eigenbasis — DCT-II cosines on bounded
axes, the real Fourier pairs on periodic ones — applied as real matrix
products (reference Bounded-direction eigenvalues,
``anelastic_pressure_solver.jl:5-78``), or rfft2 when every horizontal
axis is periodic.  Which path a backend takes is decided in
:func:`breeze_tpu.backend.poisson_path`.  Every matrix
product runs at ``Precision.HIGHEST``: a float32 product may otherwise be
taken in TF32 (about three decimal digits) on a GPU.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import Grid, Topology

# float32 matrix products at full precision (never TF32).
_einsum = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def _periodic_eigenvalues(n: int, delta: float, rfft: bool) -> np.ndarray:
    """λ[m] = (2 sin(π m / n) / Δ)² — eigenvalues of −∂² (2nd-order, periodic)."""
    m = np.arange(n // 2 + 1 if rfft else n)
    return (2.0 * np.sin(np.pi * m / n) / delta) ** 2


def _axis_real_basis(n: int, delta: float, topology) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Real eigenbasis (F, F⁻¹, λ) of the 1-D second-difference operator.

    - PERIODIC: the real Fourier basis {1, cos(2πm i/n), sin(2πm i/n), ...}
      (circulant eigenvectors), λ = (2 sin(πm/n)/Δ)².
    - BOUNDED: DCT-II cosines cos(πm(i+½)/n) — eigenvectors of the Neumann
      (staggered wall) Laplacian — λ = (2 sin(πm/2n)/Δ)².  This is the
      reference's Bounded-direction ``FourierTridiagonalPoissonSolver``
      eigenvalue set (``anelastic_pressure_solver.jl:5-78`` via
      Oceananigans ``poisson_eigenvalues``).
    - FLAT / n == 1: identity, λ = 0.

    All matrices are real (n, n): forward rows are basis functionals, so the
    whole horizontal transform runs as real matrix products.
    """
    from ..grid import Topology

    if n == 1 or topology == Topology.FLAT:
        return np.ones((1, 1)), np.ones((1, 1)), np.zeros(1)

    i = np.arange(n)
    rows = []
    lam = []
    if topology == Topology.PERIODIC:
        rows.append(np.ones(n))
        lam.append(0.0)
        for m in range(1, (n - 1) // 2 + 1):
            ang = 2.0 * np.pi * m * i / n
            rows.append(np.cos(ang))
            lam.append((2.0 * np.sin(np.pi * m / n) / delta) ** 2)
            rows.append(np.sin(ang))
            lam.append((2.0 * np.sin(np.pi * m / n) / delta) ** 2)
        if n % 2 == 0:
            rows.append(np.cos(np.pi * i))
            lam.append((2.0 / delta) ** 2)
    elif topology == Topology.BOUNDED:
        for m in range(n):
            rows.append(np.cos(np.pi * m * (i + 0.5) / n))
            lam.append((2.0 * np.sin(np.pi * m / (2 * n)) / delta) ** 2)
    else:
        raise NotImplementedError(f"axis topology {topology}")

    F = np.stack(rows)                       # (n, n): modes × points
    Finv = np.linalg.inv(F)
    return F, Finv, np.asarray(lam)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["lower", "c_prime", "inv_den", "zero_mode_mask", "dz_c",
                 "basis", "z_eig"],
    meta_fields=["nz", "ny", "nxr", "transform", "vertical_solve"],
)
@dataclasses.dataclass(frozen=True)
class AnelasticPoissonSolver:
    nz: int
    ny: int
    nxr: int
    lower: jax.Array          # (nz, ny, nxr) sub-diagonal coupling ρ̄ᶠ[k]/Δzᶠ[k]
    c_prime: jax.Array        # (nz, ny, nxr) Thomas upper factors
    inv_den: jax.Array        # (nz, ny, nxr) Thomas pivot reciprocals
    zero_mode_mask: jax.Array  # (ny, nxr) bool
    dz_c: jax.Array            # (nz,) cell heights (volume weighting of rows)
    basis: dict                # real eigenbasis matrices (empty when unused)
    z_eig: dict                # vertical eigenbasis factors (empty when unused)
    transform: str = "fourier"  # "fourier" (rfft2) | "real"
    vertical_solve: str = "scan"  # "scan" (Thomas) | "eigen" (matmuls)

    # -- transforms ----------------------------------------------------
    def _forward(self, rhs):
        if self.transform == "real":
            m = self.basis
            return _einsum("jy,zyx,xk->zjk", m["fy"], rhs, m["fxT"])
        return jnp.fft.rfft2(rhs, axes=(1, 2))

    def _inverse(self, x_hat, out_shape):
        if self.transform == "real":
            m = self.basis
            return _einsum("yj,zjk,kx->zyx", m["ify"], x_hat, m["ifxT"])
        return jnp.fft.irfft2(x_hat, s=out_shape, axes=(1, 2))

    def solve(self, divergence: jax.Array, dt) -> jax.Array:
        """Solve for φ given δ = ∇·(ρu~); returns the kinematic pressure φ.

        ``divergence`` is the cell-centered predictor mass-flux divergence
        (interior shape); ``dt`` the projection time step.
        """
        rhs = divergence * self.dz_c[:, None, None]
        rhs_hat = self._forward(rhs) / dt
        if self.vertical_solve == "eigen":
            # Vertical diagonalization: x = A [(M − λ)⁻¹ ⊙ (Aᵀ b)] — two
            # (nz, nz) matmuls batched over all horizontal modes,
            # replacing the 2·nz-step sequential Thomas scans.  The
            # reciprocal table (nz, ny, nxr) bakes in the nullspace pin
            # (the (0,0) mode's zero z-eigenvalue entry is 0).
            ze = self.z_eig
            coef = _einsum("mz,zyx->myx", ze["AT"], rhs_hat)
            coef = coef * ze["inv_tab"]
            x = _einsum("zm,myx->zyx", ze["A"], coef)
        else:
            x = fourier_tridiagonal_scan(rhs_hat, self.lower, self.inv_den,
                                         self.c_prime, self.zero_mode_mask,
                                         self.nz)
        phi = self._inverse(x, divergence.shape[1:])
        return phi.astype(divergence.dtype)


def fourier_tridiagonal_scan(rhs_hat, lower, inv_den, c_prime,
                             zero_mode_mask, nz):
    """Per-mode Thomas solve over z (shared by the dense solver and the
    shard_map pencil path, which feeds factor slices for its y-range)."""
    # Pin the singular (0,0) mode: its top-row equation is replaced by
    # phi = 0 (compatibility makes the dropped equation redundant).
    rhs_hat = rhs_hat.at[nz - 1].set(
        jnp.where(zero_mode_mask, 0.0, rhs_hat[nz - 1]))

    # Thomas forward sweep: d[k] = (rhs[k] - lower[k] d[k-1]) * inv_den[k]
    def fwd(d_prev, inputs):
        rhs_k, lower_k, inv_den_k = inputs
        d_k = (rhs_k - lower_k * d_prev) * inv_den_k
        return d_k, d_k

    d0 = jnp.zeros_like(rhs_hat[0])   # inherits shard_map varying axes
    _, d = jax.lax.scan(fwd, d0, (rhs_hat, lower, inv_den))

    # Backward substitution: x[k] = d[k] - c'[k] x[k+1]
    def bwd(x_next, inputs):
        d_k, c_k = inputs
        x_k = d_k - c_k * x_next
        return x_k, x_k

    x_top = d[nz - 1]
    _, x_rev = jax.lax.scan(
        bwd, x_top, (d[: nz - 1][::-1], c_prime[: nz - 1][::-1]))
    return jnp.concatenate([x_rev[::-1], x_top[None]], axis=0)


def build_anelastic_poisson_solver(grid: Grid, rho_c, rho_f,
                                   transform: str | None = None,
                                   vertical_solve: str | None = None) -> AnelasticPoissonSolver:
    """Precompute Thomas factors for the ρᵣ-weighted Fourier-tridiagonal solve.

    ``rho_c``: reference density at centers ``(nz,)``; ``rho_f``: at faces
    ``(nz+1,)``.  Factorization runs in float64 on the host (survey precision
    plan); the stored factors are cast to the solve dtype at use sites via
    the complex rhs dtype promotion.

    ``transform`` selects the horizontal diagonalization: ``"real"`` (real
    eigenbasis matmuls — required for bounded axes) or ``"fourier"``
    (rfft2).  ``vertical_solve`` is ``"scan"`` (Thomas) or ``"eigen"``
    (needs the real basis).  ``None`` takes the backend's choice
    (:func:`breeze_tpu.backend.poisson_path`); with an explicit
    ``transform="fourier"`` the vertical solve is the scan.
    """
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    bounded = (grid.x_topology == Topology.BOUNDED
               or grid.y_topology == Topology.BOUNDED)
    from ..backend import poisson_path
    if transform is None:
        transform = poisson_path(bounded)[0]
    if vertical_solve is None:
        vertical_solve = (poisson_path(bounded)[1] if transform == "real"
                          else "scan")
    if bounded and transform != "real":
        raise ValueError("bounded horizontal axes require the real eigenbasis")
    basis = {}
    if transform == "real":
        # Real per-axis eigenbasis as matmuls: DCT-II cosines on bounded
        # axes (reference Bounded-topology FourierTridiagonalPoissonSolver,
        # anelastic_pressure_solver.jl:5-78), real Fourier pairs on periodic
        # ones.
        Fx, iFx, lam_x = _axis_real_basis(nx, grid.dx, grid.x_topology)
        Fy, iFy, lam_y = _axis_real_basis(ny, grid.dy, grid.y_topology)
        nxr = nx
        lam = lam_y[:, None] + lam_x[None, :]                   # (ny, nx)
        cast = lambda a: jnp.asarray(a, grid.dtype)
        basis = {"fy": cast(Fy), "fxT": cast(Fx.T),
                    "ify": cast(iFy), "ifxT": cast(iFx.T)}
    else:
        nxr = nx // 2 + 1
        # FLAT axes contribute a single zero eigenvalue (size-1 FFT trivial).
        lam_x = (_periodic_eigenvalues(nx, grid.dx, rfft=True)
                 if grid.x_topology == Topology.PERIODIC else np.zeros(nxr))
        lam_y = (_periodic_eigenvalues(ny, grid.dy, rfft=False)
                 if grid.y_topology == Topology.PERIODIC else np.zeros(ny))
        lam = lam_y[:, None] + lam_x[None, :]                   # (ny, nxr)

    rho_c = np.asarray(rho_c, np.float64)
    rho_f = np.asarray(rho_f, np.float64)
    dz_c = np.asarray(grid.dz_c, np.float64)
    dz_f = np.asarray(grid.dz_f, np.float64)

    # couplings: a[k] = rho_f[k]/dz_f[k] couples (k-1, k); a[0] and a[nz]
    # are wall couplings, dropped by the Neumann condition.
    a = rho_f / dz_f                                            # (nz+1,)
    lower = np.zeros((nz, ny, nxr))
    upper = np.zeros((nz, ny, nxr))
    diag = np.zeros((nz, ny, nxr))
    for k in range(nz):
        lo = a[k] if k > 0 else 0.0
        up = a[k + 1] if k < nz - 1 else 0.0
        lower[k] = lo
        upper[k] = up
        diag[k] = -(lo + up) - rho_c[k] * dz_c[k] * lam[None, :, :]

    # Pin the singular (0,0) mode at the top level: row -> phi = 0.
    zero_mode = np.zeros((ny, nxr), bool)
    zero_mode[0, 0] = True
    diag[nz - 1][zero_mode] = 1.0
    lower[nz - 1][zero_mode] = 0.0
    upper[nz - 2][zero_mode] = 0.0  # decouple: row nz-2 keeps its equation
    # NOTE upper[nz-2] zeroing changes the system for the (0,0) mode: row nz-2
    # then omits its coupling to phi[nz-1]; but since phi[nz-1] = 0 is pinned,
    # the coupling term is identically zero anyway — the equations agree.

    # Thomas factorization: c'[k] = upper[k] / (diag[k] - lower[k] c'[k-1])
    c_prime = np.zeros_like(diag)
    inv_den = np.zeros_like(diag)
    den = diag[0]
    inv_den[0] = 1.0 / den
    c_prime[0] = upper[0] * inv_den[0]
    for k in range(1, nz):
        den = diag[k] - lower[k] * c_prime[k - 1]
        inv_den[k] = 1.0 / den
        c_prime[k] = upper[k] * inv_den[k]

    if vertical_solve == "eigen" and transform != "real":
        raise ValueError("vertical_solve='eigen' needs the real eigenbasis "
                         "transform (real-valued mode space)")

    z_eig = {}
    if vertical_solve == "eigen":
        # Generalized symmetric eigenproblem T0 v = μ D v via the standard
        # form C = D^{-1/2} T0 D^{-1/2} (f64 host-side): the per-mode
        # vertical operator is T0 − λD, so x = A (M − λ)⁻¹ Aᵀ b with
        # A = D^{-1/2} U.  The (0,0) horizontal mode's zero eigenvalue is
        # the Neumann nullspace: its reciprocal is set to 0 (picks the
        # D-orthogonal solution — same ∇φ as the scan's pinned row).
        T0 = np.zeros((nz, nz))
        for k in range(nz):
            lo = a[k] if k > 0 else 0.0
            up = a[k + 1] if k < nz - 1 else 0.0
            T0[k, k] = -(lo + up)
            if k > 0:
                T0[k, k - 1] = lo
            if k < nz - 1:
                T0[k, k + 1] = up
        Dv = rho_c * dz_c
        d_isqrt = 1.0 / np.sqrt(Dv)
        C = d_isqrt[:, None] * T0 * d_isqrt[None, :]
        M, U = np.linalg.eigh(C)
        A = d_isqrt[:, None] * U
        den = M[:, None, None] - lam[None, :, :]
        m0 = int(np.argmax(M))           # eigenvalues ≤ 0; the ~0 one is max
        den[m0][zero_mode] = 1.0         # avoid 0/0; masked next
        inv_tab = 1.0 / den
        inv_tab[m0][zero_mode] = 0.0
        cast = lambda arr: jnp.asarray(arr, grid.dtype)
        z_eig = {"A": cast(A), "AT": cast(A.T), "inv_tab": cast(inv_tab)}

    dt = grid.dtype
    return AnelasticPoissonSolver(
        nz=nz, ny=ny, nxr=nxr,
        lower=jnp.asarray(lower, dt),
        c_prime=jnp.asarray(c_prime, dt),
        inv_den=jnp.asarray(inv_den, dt),
        zero_mode_mask=jnp.asarray(zero_mode),
        dz_c=jnp.asarray(dz_c, dt),
        basis=basis,
        z_eig=z_eig,
        transform=transform,
        vertical_solve=vertical_solve,
    )
