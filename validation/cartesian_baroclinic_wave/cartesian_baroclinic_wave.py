"""Baroclinic wave in a Cartesian channel — URJ15 validation case.

Growth of a baroclinic wave in a midlatitude f-plane channel following the
standardized test of Ullrich, Melvin, Jablonowski & Staniforth (2015, QJRMS
— "URJ15"; the reference study
``validation/cartesian_baroclinic_wave/cartesian_baroclinic_wave.jl``).

A zonally-uniform jet in thermal-wind balance with a meridional temperature
gradient (URJ15 Eqs. 1-11, all analytic in the pressure coordinate
η = p/p₀) is seeded with a localized Gaussian zonal-wind perturbation
(Eq. 12) that triggers baroclinic instability: growing Rossby waves emerge
over roughly ten days and wrap into distinct highs/lows by day 15.  The
η-coordinate balanced state is converted to height coordinates by Newton
inversion of the geopotential Φ(y, η) = gz.

Expected results (URJ15 Figs. 4-6 and the reference study): visible wave
growth by day 8, deep surface lows (Δp of tens of hPa) and sharpening
fronts by days 10-15, peak jet ≈ 30 m/s near η ≈ 0.24.

Usage:
  python cartesian_baroclinic_wave.py            # 100 km grid, 15 days (GPU)
  python cartesian_baroclinic_wave.py --days 10
  python cartesian_baroclinic_wave.py --smoke    # coarse + 6 h (CPU ok)
"""

import argparse
import math

import jax
import jax.numpy as jnp
import numpy as np

import breeze_tpu as bz
from breeze_tpu.dynamics.compressible import (
    SplitExplicitTimeDiscretization, compressible_diagnose,
    compressible_initial_state, make_compressible_model)
from breeze_tpu.simulation import (IterationInterval, Simulation,
                                   conjure_time_step_wizard)
from breeze_tpu.thermo.constants import IdealGas, ThermodynamicConstants

# ------------------------------------------------------------------ constants
G_ACC = 9.81
RD = 287.0
CPD = 1004.5
KAPPA = RD / CPD

A_EARTH = 6.371229e6
OMEGA = 7.29212e-5
P0 = 1.0e5        # surface pressure [Pa]
T0 = 288.0        # reference temperature [K]
GAMMA = 0.005     # lapse rate [K/m]
B_WIDTH = 2.0     # vertical width parameter b
U0 = 35.0         # reference zonal wind [m/s]
DT_STRAT = 4.8e5  # empirical stratospheric temperature parameter [K]
ETA_T = 0.2       # tropopause η
KAPPA_T = RD * GAMMA / G_ACC

F0 = 2.0 * OMEGA * math.sin(math.pi / 4.0)   # f at 45°N

# perturbation (URJ15 Eq. 12)
U_P = 1.0
L_P = 600.0e3
X_C = 2000.0e3
Y_C = 2500.0e3

LX, LY, LZ = 40_000.0e3, 6_000.0e3, 30.0e3

ALPHA_EXP = G_ACC / (RD * GAMMA)


# --------------------------------------------------- URJ15 analytic state
def eta_mean(z):
    """η of the lapse-rate atmosphere (first Newton guess)."""
    return (1.0 - GAMMA * z / T0) ** ALPHA_EXP


def t_bar(eta):
    """Horizontal-mean temperature (Eqs. 4-5)."""
    T = T0 * eta ** KAPPA_T
    return jnp.where(eta < ETA_T, T + DT_STRAT * (ETA_T - eta) ** 5, T)


def urj15_u(y, eta):
    """Balanced zonal wind (Eq. 1)."""
    s = jnp.log(eta)
    return -U0 * jnp.sin(jnp.pi * y / LY) ** 2 * s * jnp.exp(-((s / B_WIDTH) ** 2))


def _merid_integral(y):
    """∫ sin²(πy/Ly) dy with zero y-mean."""
    return y / 2.0 - LY / (4.0 * jnp.pi) * jnp.sin(2.0 * jnp.pi * y / LY) - LY / 4.0


def t_prime(y, eta):
    """Thermal-wind temperature perturbation: ∂T/∂y = (f₀/Rᵈ)∂u/∂lnη."""
    s = jnp.log(eta)
    Gfac = (1.0 - 2.0 * s ** 2 / B_WIDTH ** 2) * jnp.exp(-((s / B_WIDTH) ** 2))
    return -(F0 * U0 / RD) * _merid_integral(y) * Gfac


def t_full(y, eta):
    return t_bar(eta) + t_prime(y, eta)


def phi_bar(eta):
    """Mean geopotential (hydrostatic integral of T̄ from η = 1)."""
    phi = (G_ACC * T0 / GAMMA) * (1.0 - eta ** KAPPA_T)
    strat = RD * DT_STRAT * (
        ETA_T ** 5 * jnp.log(eta / ETA_T)
        - 5.0 * ETA_T ** 4 * (eta - ETA_T)
        + 5.0 * ETA_T ** 3 * (eta ** 2 - ETA_T ** 2)
        - (10.0 / 3.0) * ETA_T ** 2 * (eta ** 3 - ETA_T ** 3)
        + (5.0 / 4.0) * ETA_T * (eta ** 4 - ETA_T ** 4)
        - (1.0 / 5.0) * (eta ** 5 - ETA_T ** 5))
    return jnp.where(eta < ETA_T, phi - strat, phi)


def phi_prime(y, eta):
    """Geopotential perturbation (exact hydrostatic integral of T′)."""
    s = jnp.log(eta)
    return F0 * U0 * _merid_integral(y) * s * jnp.exp(-((s / B_WIDTH) ** 2))


def phi_total(y, eta):
    return phi_bar(eta) + phi_prime(y, eta)


def eta_at(y, z):
    """Newton inversion of Φ(y, η) = gz (10 fixed iterations)."""
    target = G_ACC * z
    eta = jnp.clip(eta_mean(z), 1e-8, 1.0)
    for _ in range(10):
        phi = phi_total(y, eta)
        T = t_full(y, eta)
        dphi = -RD * T / eta
        eta = jnp.clip(eta - (phi - target) / dphi, 1e-8, 1.0)
    return eta


def pressure(y, z):
    return P0 * eta_at(y, z)


def temperature(y, z):
    return t_full(y, eta_at(y, z))


def density_field(x, y, z):
    eta = eta_at(y, z)
    return P0 * eta / (RD * t_full(y, eta))


def potential_temperature(x, y, z):
    eta = eta_at(y, z)
    return t_full(y, eta) * eta ** (-KAPPA)


def zonal_velocity(x, y, z):
    u_bg = urj15_u(y, eta_at(y, z))
    u_pert = U_P * jnp.exp(-(((x - X_C) ** 2 + (y - Y_C) ** 2) / L_P ** 2))
    return u_bg + u_pert


# ------------------------------------------------------------------ generator
def cartesian_baroclinic_wave_simulation(resolution_km=100.0, nz=30,
                                         stop_time=15 * 86400.0,
                                         initial_dt=120.0, max_dt=600.0,
                                         cfl=1.2, verbose=True,
                                         output_path=None):
    nx = round(LX / (resolution_km * 1e3))
    ny = round(LY / (resolution_km * 1e3))
    grid = bz.make_grid(size=(nx, ny, nz), extent=(LX, LY, LZ),
                        topology=(bz.PERIODIC, bz.BOUNDED, bz.BOUNDED),
                        halo=3, dtype=jnp.float32)

    constants = ThermodynamicConstants(
        gravitational_acceleration=G_ACC,
        dry_air=IdealGas(molar_mass=8.314462618 / RD, heat_capacity=CPD))
    theta_ref = lambda z: 250.0 * np.exp(G_ACC * z / (CPD * 250.0))

    model = make_compressible_model(
        grid, advection=bz.WENO(5),
        reference_potential_temperature=theta_ref,
        surface_pressure=P0, constants=constants,
        coriolis=bz.FPlane(f=F0),
        time_discretization=SplitExplicitTimeDiscretization())

    state = compressible_initial_state(
        model, rho=density_field, theta=potential_temperature,
        u=zonal_velocity)

    sim = Simulation(model, state, dt=initial_dt, stop_time=stop_time,
                     verbose=verbose)
    conjure_time_step_wizard(sim, cfl=cfl, max_dt=max_dt)

    def progress(s):
        aux = compressible_diagnose(s.model, s.state)
        print(f"  iter {s.iteration:5d} | t={s.time / 86400.0:6.2f} d | "
              f"dt={s.dt:5.0f} s | min p(z1)="
              f"{float(jnp.min(aux.p[0])) / 100.0:7.1f} hPa | "
              f"max|u|={float(jnp.abs(aux.u).max()):5.1f} | "
              f"max|w|={float(jnp.abs(aux.w).max()):6.3f}")

    sim.add_callback(progress, IterationInterval(50))

    if output_path:
        from breeze_tpu.simulation import NetCDFWriter, TimeInterval
        # velocity + θ snapshots every 6 h (surface-pressure maps are
        # reconstructed from θ/ρ in post-processing)
        sim.add_output_writer(NetCDFWriter(
            path=output_path, schedule=TimeInterval(6 * 3600.0),
            fields=("u", "v", "w", "theta")))

    if verbose:
        print(f"Configured URJ15 channel: {nx}x{ny}x{nz} "
              f"({resolution_km:.0f} km, {LZ / nz / 1e3:.0f} km layers)")
    return sim


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--resolution-km", type=float, default=100.0)
    p.add_argument("--days", type=float, default=15.0)
    p.add_argument("--smoke", action="store_true",
                   help="coarse grid + 6 simulated hours (runs on CPU)")
    args = p.parse_args()

    if args.smoke:
        sim = cartesian_baroclinic_wave_simulation(
            resolution_km=500.0, nz=10, stop_time=6 * 3600.0,
            initial_dt=300.0, max_dt=900.0)
    else:
        sim = cartesian_baroclinic_wave_simulation(
            resolution_km=args.resolution_km,
            stop_time=args.days * 86400.0)
    sim.run()
    aux = compressible_diagnose(sim.model, sim.state)
    print(f"final min lowest-level pressure: "
          f"{float(jnp.min(aux.p[0])) / 100.0:.1f} hPa; "
          f"max wind {float(jnp.abs(aux.u).max()):.1f} m/s")


if __name__ == "__main__":
    main()
