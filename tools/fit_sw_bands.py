"""Fit the SW band-model free parameters to the Lacis & Hansen (1974)
external targets of validation/radiation_columns.py.

The water-vapor side of ``SW_BANDS`` is NOT fitted here — it is the
published LH74 table-1 k-distribution verbatim (weights + kₙ/10 m²/kg),
which reproduces their LBL-fit A_wv(y) identically.  The free parameters
are the ozone split (saturated-UV solar fraction f_uv, linear Chappuis
coefficient k_c) and the visible Rayleigh optical depth tray; they are
grid-searched to minimize the worst |model − LH74| residual over
{tropical, MLS, SAW} × {(μ₀=1, α=0.06), (μ₀=0.5, α=0.2)} on three fluxes
(TOA up, surface down, column absorption).

Run:  JAX_PLATFORMS=cpu PYTHONPATH=. \
          python tools/fit_sw_bands.py

Round-4 result: f_uv=0.015, k_c=1.6, tray=0.155 — worst residual 3.5 W/m²
(tolerance budget ±15 W/m²; see validation/radiation_columns.py).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import breeze_tpu.physics.spectral_radiation as sr
    from validation.radiation_columns import (LW_TARGETS, SW_GEOMETRIES,
                                              lacis_hansen_sw,
                                              sw_column_fluxes)

    water_terms = sr.SW_BANDS[2:]   # LH74 k-distribution: fixed
    best = None
    for f_uv in (0.0125, 0.015, 0.0175, 0.02):
        for k_c in (1.2, 1.4, 1.6, 1.8, 2.0):
            for tray in (0.125, 0.14, 0.155, 0.17):
                uv = (f_uv, 0.0, 600.0, 0.0)
                vis = (0.647 - f_uv, 4.0e-6, k_c, tray)
                sr.SW_BANDS = (uv, vis) + water_terms
                worst, rows = 0.0, []
                for name in LW_TARGETS:
                    for mu0, alb in SW_GEOMETRIES:
                        got = sw_column_fluxes(name, mu0, alb)
                        ref = lacis_hansen_sw(name, mu0, alb)
                        d = [g - r for g, r in zip(got, ref)]
                        rows.append((name, mu0, alb,
                                     [round(x, 1) for x in d]))
                        worst = max(worst, max(abs(x) for x in d))
                if best is None or worst < best[0]:
                    best = (worst, f_uv, k_c, tray, rows)
                print(f"f_uv={f_uv} k_c={k_c} tray={tray}: "
                      f"worst={worst:.1f}")
    print(f"\nBEST: worst={best[0]:.1f} W/m²  "
          f"f_uv={best[1]} k_c={best[2]} tray={best[3]}")
    print("residuals (TOAup, SFCdn, ABS):")
    for r in best[4]:
        print("  ", r)


if __name__ == "__main__":
    main()
