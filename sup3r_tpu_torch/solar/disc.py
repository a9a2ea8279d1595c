"""DISC direct-normal irradiance model (Maxwell 1987) + helpers.

The port's copy of ``sup3r_tpu/solar/disc.py`` (numpy): the NREL DISC
algorithm that the reference delegates to ``farms.disc`` (reference:
sup3r/solar/solar.py:13-14,:315). Estimates
DNI from GHI, solar zenith angle, day of year and pressure via the
clearness-index parameterization of Maxwell (1987), "A Quasi-Physical
Model for Converting Hourly Global Horizontal to Direct Normal
Insolation", SERI/TR-215-3087.
"""

import numpy as np

#: solar constant (W/m2)
SOLAR_CONSTANT = 1366.1


def extraterrestrial_irradiance(doy):
    """Top-of-atmosphere normal irradiance for a day of year."""
    b = 2 * np.pi * (np.asarray(doy, dtype=np.float64) - 1) / 365.0
    re = (1.00011 + 0.034221 * np.cos(b) + 0.00128 * np.sin(b)
          + 0.000719 * np.cos(2 * b) + 7.7e-5 * np.sin(2 * b))
    return SOLAR_CONSTANT * re


def relative_airmass(sza):
    """Kasten (1966) relative airmass for zenith in degrees — the
    formulation ``farms.disc`` uses (the reference delegates to it,
    sup3r/solar/solar.py:315), NOT Kasten & Young 1989; the
    exponential delta_kn term amplifies any airmass difference near
    the zenith cap."""
    sza = np.asarray(sza, dtype=np.float64)
    cosz = np.cos(np.radians(sza))
    am = 1.0 / (cosz + 0.15 * (93.885 - sza) ** -1.253)
    return np.where(sza < 90, am, np.nan)


def disc(ghi, sza, doy, pressure=101325.0, min_cos_zenith=0.065,
         max_zenith=87.0):
    """DNI (W/m2) from GHI via the DISC clearness-index model.

    ghi, sza: (time, sites) arrays; doy: (time,) day-of-year;
    pressure: scalar or (time, sites) surface pressure in Pa."""
    ghi = np.asarray(ghi, dtype=np.float64)
    sza_arr = np.asarray(sza, dtype=np.float64)
    doy = np.asarray(doy, dtype=np.float64)
    if doy.ndim == 1 and ghi.ndim == 2:
        doy = doy[:, None]
    pressure = np.asarray(pressure, dtype=np.float64)
    if np.nanmax(pressure) < 10000:  # looks like hPa/mbar
        pressure = pressure * 100

    i0 = extraterrestrial_irradiance(doy)
    # min_cos_zenith / kt clip follow pvlib's DISC hardening (farms'
    # exact clamping is unavailable offline); both only bite within
    # ~1 degree of the zenith cap, below the dark_night cutoff
    cosz = np.maximum(np.cos(np.radians(sza_arr)), min_cos_zenith)
    kt = np.clip(ghi / (i0 * cosz), 0, 2)

    am = relative_airmass(np.minimum(sza_arr, max_zenith))
    am = am * pressure / 101325.0

    is_cloudy = kt > 0.6
    a = np.where(
        is_cloudy,
        -5.743 + 21.77 * kt - 27.49 * kt**2 + 11.56 * kt**3,
        0.512 - 1.56 * kt + 2.286 * kt**2 - 2.222 * kt**3)
    b = np.where(is_cloudy, 41.4 - 118.5 * kt + 66.05 * kt**2
                 + 31.9 * kt**3, 0.370 + 0.962 * kt)
    c = np.where(is_cloudy, -47.01 + 184.2 * kt - 222.0 * kt**2
                 + 73.81 * kt**3, -0.280 + 0.932 * kt - 2.048 * kt**2)

    kn_c = (0.866 - 0.122 * am + 0.0121 * am**2 - 0.000653 * am**3
            + 1.4e-5 * am**4)
    delta_kn = a + b * np.exp(c * am)
    kn = kn_c - delta_kn
    dni = kn * i0
    dni = np.where((sza_arr < max_zenith) & (ghi > 0)
                   & np.isfinite(dni), dni, 0)
    return np.maximum(dni, 0).astype(np.float32)


def calc_dhi(dni, ghi, sza):
    """DHI from the closure DHI = GHI - DNI*cos(zenith); negative DHI is
    corrected by reducing DNI (farms.utilities.calc_dhi semantics)."""
    cosz = np.cos(np.radians(np.asarray(sza, dtype=np.float64)))
    dhi = np.asarray(ghi, dtype=np.float64) - np.asarray(
        dni, dtype=np.float64) * cosz
    bad = dhi < 0
    dni = np.asarray(dni, dtype=np.float64).copy()
    if bad.any():
        with np.errstate(divide='ignore', invalid='ignore'):
            dni_fix = np.where(cosz > 0, np.asarray(ghi) / cosz, 0)
        dni[bad] = dni_fix[bad]
        dhi[bad] = 0
    return dhi.astype(np.float32), dni.astype(np.float32)


def dark_night(irradiance, sza, zenith_limit=89.0):
    """Zero out irradiance where the sun is below/near the horizon."""
    out = np.asarray(irradiance).copy()
    out[np.asarray(sza) >= zenith_limit] = 0
    return out
