"""Fit the LW band coefficients against the EXTERNAL standard-atmosphere
targets of validation/radiation_columns.py (published LBL broadband
values), plus the published clear-sky instantaneous 2xCO2 TOA forcing
(~2.8 W/m² tropical) so the CO2 band keeps a physical sensitivity.

Optimizes log-multipliers on each band's k_h2o / k_continuum and global
k_co2 / k_o3 / k_ch4n2o scales with Adam; prints the retuned LW_BANDS
tuple to paste into spectral_radiation.py.

Run on CPU:  JAX_PLATFORMS=cpu python tools/fit_lw_bands.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)


def main():
    from breeze_tpu.physics import spectral_radiation as sr
    from validation.radiation_columns import (LW_TARGETS, hydrostatic_column,
                                              temperature_profile,
                                              vapor_profile)

    nz, ztop = 200, 50_000.0
    dz = ztop / nz
    z = (np.arange(nz) + 0.5) * dz

    cols = {}
    for name in LW_TARGETS:
        T = temperature_profile(name, z)
        p, rho = hydrostatic_column(T, z, dz)
        qv = vapor_profile(name, z, rho, dz)
        cols[name] = (jnp.asarray(T), jnp.asarray(p), jnp.asarray(rho),
                      jnp.asarray(qv))

    # Refined band layout: the 15 um CO2 complex is split into a
    # saturated core and two wings (the wings carry the 2xCO2 forcing a
    # single gray coefficient cannot represent), and the rotation band
    # into two.  Initial k values seed the fit.
    bands = np.asarray([
        (10.0, 250.0, 80.0, 0.0, 0.0, 0.0, 0.0),
        (250.0, 410.0, 20.0, 0.0, 0.0, 0.0, 0.01),
        (410.0, 560.0, 4.0, 0.0, 0.0, 0.0, 0.01),
        (560.0, 630.0, 1.2, 8.0, 0.0, 0.0, 0.02),     # CO2 lower wing
        (630.0, 700.0, 1.0, 300.0, 0.0, 0.0, 0.02),   # CO2 core
        (700.0, 800.0, 0.8, 6.0, 0.0, 0.0, 0.02),     # CO2 upper wing
        (800.0, 980.0, 0.06, 0.0, 0.0, 0.0, 0.006),   # window
        (980.0, 1100.0, 0.06, 0.0, 60.0, 0.0, 0.005), # O3 9.6 um
        (1100.0, 1400.0, 0.25, 0.0, 0.0, 10.0, 0.003),
        (1400.0, 2200.0, 35.0, 0.0, 0.0, 0.0, 0.0),
        (2200.0, 3500.0, 6.0, 0.4, 0.0, 0.0, 0.0),
    ])
    nb = len(bands)
    nu = bands[:, :2]
    k0 = jnp.asarray(bands[:, 2:])           # kh, kc, ko, km, kcont

    D = 1.66
    M_AIR = 28.964e-3

    def lw_column(kmat, name, co2=420e-6):
        """(OLR, DLR) for the analytic column under coefficient matrix
        ``kmat`` (nb, 5) — mirrors SpectralRadiation.lw_fluxes 1-D."""
        T, p, rho, qv = cols[name]
        u_h2o = rho * qv * dz
        dm = rho * dz
        u_co2 = co2 * (44.01e-3 / M_AIR) * dm
        u_mn = (1.8e-6 * 16.04e-3 / M_AIR + 2 * 0.33e-6 * 44.01e-3 / M_AIR) * dm
        o3v = jnp.asarray(sr.standard_ozone_profile(z))
        u_o3 = o3v * (48.0e-3 / M_AIR) * dm
        pw = (p / 1.0e5) ** 0.75
        e_kpa = rho * qv * 461.5 * T / 1000.0
        sigT4 = sr.STEFAN_BOLTZMANN * T ** 4
        Ts = T[0]
        olr = 0.0
        dlr = 0.0
        for b in range(nb):
            kh, kc, ko, km, kcont = (kmat[b, i] for i in range(5))
            tau = (kh * u_h2o * pw + kc * u_co2 * pw + ko * u_o3 * pw
                   + km * u_mn * pw + kcont * u_h2o * e_kpa)
            t = jnp.exp(-D * tau)
            fB = sr.planck_band_fraction(T, float(nu[b, 0]), float(nu[b, 1]))
            B = fB * sigT4
            F0 = 0.98 * sr.planck_band_fraction(
                Ts, float(nu[b, 0]), float(nu[b, 1])) * sr.STEFAN_BOLTZMANN * Ts ** 4

            def up(F, inp):
                t_k, B_k = inp
                Fn = F * t_k + B_k * (1 - t_k)
                return Fn, Fn

            Fup, _ = jax.lax.scan(up, F0, (t, B))
            olr = olr + Fup

            def dn(F, inp):
                t_k, B_k = inp
                Fn = F * t_k + B_k * (1 - t_k)
                return Fn, Fn

            Fdn, _ = jax.lax.scan(dn, jnp.zeros(()), (t[::-1], B[::-1]))
            dlr = dlr + Fdn
        return olr, dlr

    mask = jnp.asarray(k0 > 0, jnp.float64)

    def kmat_of(params):
        mh, mcont, mc, mo, mm = params
        mult = jnp.stack([jnp.exp(mh),
                          jnp.exp(mc),
                          jnp.full(nb, jnp.exp(mo)),
                          jnp.full(nb, jnp.exp(mm)),
                          jnp.exp(mcont)], axis=1)
        return k0 * mult * mask

    def loss(params):
        kmat = kmat_of(params)
        L = 0.0
        for name, (olr_t, dlr_t) in LW_TARGETS.items():
            olr, dlr = lw_column(kmat, name)
            L = L + (olr - olr_t) ** 2 + (dlr - dlr_t) ** 2
        # 2xCO2 instantaneous clear-sky TOA forcing (tropical ~2.8 W/m²)
        o1, _ = lw_column(kmat, "tropical", co2=420e-6)
        o2, _ = lw_column(kmat, "tropical", co2=840e-6)
        L = L + 60.0 * ((o1 - o2) - 2.8) ** 2
        mh, mcont, mc, mo, mm = params
        reg = (jnp.sum(mh ** 2) + jnp.sum(mcont ** 2)
               + jnp.sum(mc ** 2) + mo ** 2 + mm ** 2)
        return L / 7.0 + 0.05 * reg

    params = (jnp.zeros(nb), jnp.zeros(nb), jnp.zeros(nb), jnp.zeros(()),
              jnp.zeros(()))
    import optax
    opt = optax.adam(0.05)
    st = opt.init(params)
    lg = jax.jit(jax.value_and_grad(loss))
    for i in range(800):
        v, grads = lg(params)
        upd, st = opt.update(grads, st)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
        if i % 100 == 0:
            print(f"iter {i:4d} loss {float(v):10.3f}", flush=True)

    kmat = np.asarray(kmat_of(params))
    print("\nfitted columns:")
    for name, (olr_t, dlr_t) in LW_TARGETS.items():
        olr, dlr = lw_column(jnp.asarray(kmat), name)
        print(f"{name:10s} OLR {float(olr):7.1f} (target {olr_t}) "
              f"DLR {float(dlr):7.1f} (target {dlr_t})")
    o1, _ = lw_column(jnp.asarray(kmat), "tropical", co2=420e-6)
    o2, _ = lw_column(jnp.asarray(kmat), "tropical", co2=840e-6)
    print(f"2xCO2 TOA forcing {float(o1 - o2):5.2f} W/m² (target 2.8)")

    print("\nLW_BANDS = (")
    for b in range(nb):
        lo, hi = bands[b, :2]
        kh, kc, ko, km, kcont = kmat[b]
        print(f"    ({lo:.1f}, {hi:.1f}, {kh:.4g}, {kc:.4g}, {ko:.4g}, "
              f"{km:.4g}, {kcont:.4g}),")
    print(")")


if __name__ == "__main__":
    main()
