"""DCMIP2016 tropical cyclone (Reed–Jablonowski) validation case.

Analytic balanced vortex (Reed & Jablonowski 2011; Ullrich et al. 2016,
DCMIP2016; Willson et al. 2024, GMD 17:2493) in a quiescent moist tropical
environment on a latitude–longitude grid with compressible split-explicit
dynamics. A weak warm-core vortex at (λc, φc) = (180°, 10°N) intensifies
into a tropical cyclone over ~10 days, driven by bulk surface enthalpy
fluxes over a fixed SST = 302.15 K, with the complete Reed–Jablonowski
"simple physics":

  1. wind-dependent bulk surface drag Cᴰ = min(7e-4 + 6.5e-5|v|, 2e-3)
     (``WindDependentCoefficient``),
  2. wind-dependent boundary-layer mixing (``ReedJablonowskiBoundaryLayer``),
  3. large-scale condensation with instantaneous rain-out
     (``InstantaneousPrecipitation``).

Counterpart of the reference validation study
``validation/DCMIP2016_TC/dcmip2016_tc.jl`` (the vortex equations below are
the published RJ 2011 test definition, Eqs. 1–23). Expected minimum sea-level
pressure over 10 days, from the reference's own table:

  | resolution | WENO5      | WENO9      |
  |------------|------------|------------|
  | 0.5°       | 975.8 hPa  | 963.2 hPa  |
  | 0.25°      | 937.6 hPa  | 921.4 hPa  |

Usage:
  python dcmip2016_tc.py                    # 0.5° WENO9, 10 days (GPU, long run)
  python dcmip2016_tc.py --resolution 0.25  # best configuration
  python dcmip2016_tc.py --smoke            # 4° + 1 h: build/step check (CPU ok)
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
from breeze_tpu.grid import make_latlon_grid
from breeze_tpu.physics.closures import ReedJablonowskiBoundaryLayer
from breeze_tpu.physics.coriolis import HydrostaticSphericalCoriolis
from breeze_tpu.physics.microphysics import InstantaneousPrecipitation
from breeze_tpu.physics.surface import (BulkSurfaceFluxes,
                                        WindDependentCoefficient)
from breeze_tpu.simulation import (IterationInterval, Simulation,
                                   conjure_time_step_wizard)
from breeze_tpu.thermo.constants import ThermodynamicConstants

# ------------------------------------------------------------------ constants
# DCMIP2016 Tables 2–3 (published test definition).
G_ACC = 9.80616      # m/s²
RD = 287.0           # J/kg/K
CPD = 1004.5         # J/kg/K
KAPPA = RD / CPD
A_EARTH = 6371220.0  # m
OMEGA = 7.29212e-5   # 1/s

ZT = 15000.0         # tropopause height (m)
Q0 = 0.021           # max specific humidity (kg/kg)
QT_UPPER = 1e-11     # upper-atmosphere specific humidity
T0 = 302.15          # surface air temperature (K)
TS = 302.15          # SST (K)
ZQ1 = 3000.0
ZQ2 = 8000.0
GAMMA = 0.007        # virtual-temperature lapse rate (K/m)
PB = 101500.0        # background surface pressure (Pa)
PHI_C = 10.0         # vortex-center latitude (deg)
LAM_C = 180.0        # vortex-center longitude (deg)
DP = 1115.0          # central pressure deficit (Pa)
RP = 282000.0        # horizontal half-width of the p perturbation (m)
ZP = 7000.0          # vertical decay scale of the p perturbation (m)
EPS0 = 1e-25
MV = 0.608           # virtual-temperature coefficient
P00 = 1.0e5          # reference pressure for θ (Pa)

TV0 = T0 * (1.0 + MV * Q0)                       # surface virtual temperature
TVT = TV0 - GAMMA * ZT                           # tropopause Tᵥ
PT = PB * (TVT / TV0) ** (G_ACC / (RD * GAMMA))  # tropopause pressure
FC = 2.0 * OMEGA * math.sin(math.radians(PHI_C))

PHI_C_R = math.radians(PHI_C)
LAM_C_R = math.radians(LAM_C)


# ----------------------------------------------------- analytic initial state
# RJ 2011 Eqs. 1–23 (λ, φ in RADIANS — the grid's xyz_c convention).

def q_bar(z):
    return jnp.where(z <= ZT,
                     Q0 * jnp.exp(-z / ZQ1) * jnp.exp(-(z / ZQ2) ** 2),
                     QT_UPPER)


def tv_bar(z):
    return jnp.where(z <= ZT, TV0 - GAMMA * z, TVT)


def p_bar(z):
    below = PB * ((TV0 - GAMMA * z) / TV0) ** (G_ACC / (RD * GAMMA))
    above = PT * jnp.exp(G_ACC * (ZT - z) / (RD * TVT))
    return jnp.where(z <= ZT, below, above)


def radius(lam, phi):
    """Great-circle distance from the vortex center (Eq. 7)."""
    arg = (math.sin(PHI_C_R) * jnp.sin(phi)
           + math.cos(PHI_C_R) * jnp.cos(phi) * jnp.cos(lam - LAM_C_R))
    return A_EARTH * jnp.arccos(jnp.clip(arg, -1.0, 1.0))


def _ab(lam, phi, z):
    r = radius(lam, phi)
    return (r / RP) ** 1.5, (z / ZP) ** 2, r


def pressure(lam, phi, z):
    """Full pressure p̄ + p′ (Eqs. 6, 8)."""
    A, B, _ = _ab(lam, phi, z)
    p_pert = jnp.where(
        z <= ZT,
        -DP * jnp.exp(-A - B)
        * ((TV0 - GAMMA * z) / TV0) ** (G_ACC / (RD * GAMMA)),
        0.0)
    return p_bar(z) + p_pert


def virtual_temperature(lam, phi, z):
    """T̄ᵥ + Tᵥ′ (Eqs. 11–12)."""
    A, B, _ = _ab(lam, phi, z)
    E = jnp.exp(A + B)
    inner = 1.0 + (2.0 * RD * (TV0 - GAMMA * z) * z) / (
        G_ACC * ZP ** 2 * (1.0 - (PB / DP) * E))
    tv_pert = jnp.where(z <= ZT, (TV0 - GAMMA * z) * (1.0 / inner - 1.0), 0.0)
    return tv_bar(z) + tv_pert


def density(lam, phi, z):
    return pressure(lam, phi, z) / (RD * virtual_temperature(lam, phi, z))


def temperature(lam, phi, z):
    return virtual_temperature(lam, phi, z) / (1.0 + MV * q_bar(z))


def potential_temperature(lam, phi, z):
    return temperature(lam, phi, z) * (P00 / pressure(lam, phi, z)) ** KAPPA


def tangential_velocity(lam, phi, z):
    """Gradient-wind tangential velocity (Eq. 18)."""
    A, B, r = _ab(lam, phi, z)
    E = jnp.exp(A + B)
    denom = (1.0 + (2.0 * RD * (TV0 - GAMMA * z) * z) / (G_ACC * ZP ** 2)
             - (PB / DP) * E)
    under = (FC ** 2 * r ** 2) / 4.0 - (
        1.5 * A * (TV0 - GAMMA * z) * RD) / denom
    vt = -FC * r / 2.0 + jnp.sqrt(jnp.maximum(0.0, under))
    return jnp.where(z <= ZT, vt, 0.0)


def _projection(lam, phi):
    """Unit vector of the tangential direction (Eqs. 20–23)."""
    d1 = (math.sin(PHI_C_R) * jnp.cos(phi)
          - math.cos(PHI_C_R) * jnp.sin(phi) * jnp.cos(lam - LAM_C_R))
    d2 = math.cos(PHI_C_R) * jnp.sin(lam - LAM_C_R)
    d = jnp.maximum(EPS0, jnp.sqrt(d1 ** 2 + d2 ** 2))
    return d1 / d, d2 / d


def zonal_velocity(lam, phi, z):
    p1, _ = _projection(lam, phi)
    return tangential_velocity(lam, phi, z) * p1


def meridional_velocity(lam, phi, z):
    _, p2 = _projection(lam, phi)
    return tangential_velocity(lam, phi, z) * p2


# ------------------------------------------------------------- vertical grid
def stretched_z_faces(nz=32, s=4.2, lid=30_000.0):
    """DCMIP2016 baseline vertical grid: 32 surface-refined levels
    (Δz₁ ≈ 64 m, Δz_top ≈ 3.7 km) to a 30 km rigid lid."""
    k = np.arange(nz + 1)
    return lid * (np.exp(s * k / nz) - 1.0) / (np.exp(s) - 1.0)


# ------------------------------------------------------------------ generator
def dcmip2016_tropical_cyclone_simulation(resolution=0.5, advection_order=9,
                                          z_faces=None, stop_time=10 * 86400.0,
                                          initial_dt=30.0, max_dt=180.0,
                                          cfl=0.8, substeps=6,
                                          verbose=True):
    """Build a fully configured `Simulation` of the RJ tropical cyclone.

    ``resolution`` is the horizontal spacing in degrees (0.5 / 0.25 are the
    validated values); ``advection_order`` the WENO order (5 or 9). The
    vortex, sounding, SST, 30 km lid, and vertical grid are the fixed
    DCMIP2016 test definition.
    """
    if z_faces is None:
        z_faces = stretched_z_faces()
    nlam = round(360.0 / resolution)
    phi_s, phi_n = -40.0, 60.0
    nphi = round((phi_n - phi_s) / resolution)

    grid = make_latlon_grid(
        (nlam, nphi, len(z_faces) - 1), longitude=(0.0, 360.0),
        latitude=(phi_s, phi_n), z=np.asarray(z_faces),
        radius=A_EARTH, dtype=jnp.float32)

    from breeze_tpu.thermo.constants import IdealGas
    constants = ThermodynamicConstants(
        gravitational_acceleration=G_ACC,
        dry_air=IdealGas(molar_mass=8.314462618 / RD,  # => Rᵈ = 287.0
                         heat_capacity=CPD))

    # Isothermal-250K reference column (reference study's θᵣ(z)).
    theta_ref = lambda z: 250.0 * np.exp(G_ACC * z / (CPD * 250.0))

    bulk = BulkSurfaceFluxes(
        surface_temperature=TS,
        drag_coefficient=WindDependentCoefficient(),
        heat_transfer_coefficient=1.1e-3,
        vapor_transfer_coefficient=1.1e-3,
        gustiness=1.0)

    model = make_compressible_model(
        grid, advection=bz.WENO(advection_order),
        reference_potential_temperature=theta_ref,
        surface_pressure=PB,
        constants=constants,
        coriolis=HydrostaticSphericalCoriolis(rotation_rate=OMEGA),
        microphysics=InstantaneousPrecipitation(),
        closure=ReedJablonowskiBoundaryLayer(),
        boundary_fluxes=bulk,
        time_discretization=SplitExplicitTimeDiscretization(
            substeps=substeps))

    state = compressible_initial_state(
        model, rho=density, theta=potential_temperature,
        u=zonal_velocity, v=meridional_velocity,
        qt=lambda lam, phi, z: q_bar(z) * jnp.ones_like(lam + phi))

    sim = Simulation(model, state, dt=initial_dt, stop_time=stop_time,
                     verbose=verbose)
    conjure_time_step_wizard(sim, cfl=cfl, max_dt=max_dt)

    def progress(s):
        aux = compressible_diagnose(s.model, s.state)
        msp = float(jnp.min(aux.p[0])) / 100.0
        print(f"  iter {s.iteration:5d} | t={s.time / 3600.0:7.1f} h | "
              f"dt={s.dt:5.1f} s | MSP={msp:.1f} hPa | "
              f"max|u|={float(jnp.abs(aux.u).max()):.1f} | "
              f"max|w|={float(jnp.abs(aux.w).max()):.2f}")

    sim.add_callback(progress, IterationInterval(20))
    if verbose:
        print(f"Configured DCMIP2016 TC: {nlam}x{nphi}x{len(z_faces) - 1} "
              f"({resolution} deg band {phi_s}..{phi_n}), "
              f"WENO{advection_order}")
    return sim


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--resolution", type=float, default=0.5)
    p.add_argument("--order", type=int, default=9, choices=(5, 9))
    p.add_argument("--days", type=float, default=10.0)
    p.add_argument("--smoke", action="store_true",
                   help="4 deg + 1 h: build/step check (runs on CPU)")
    args = p.parse_args()

    if args.smoke:
        sim = dcmip2016_tropical_cyclone_simulation(
            resolution=4.0, advection_order=5, stop_time=3600.0,
            initial_dt=60.0, max_dt=300.0, substeps=4)
    else:
        sim = dcmip2016_tropical_cyclone_simulation(
            resolution=args.resolution, advection_order=args.order,
            stop_time=args.days * 86400.0)

    sim.run()
    aux = compressible_diagnose(sim.model, sim.state)
    msp = float(jnp.min(aux.p[0])) / 100.0
    print(f"final minimum surface pressure: {msp:.1f} hPa")
    # track the minimum over the run via the surface-pressure history the
    # progress callback printed; for the validated numbers see README.md.


if __name__ == "__main__":
    main()
