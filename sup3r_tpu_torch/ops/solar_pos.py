"""Solar position: zenith angle from time + lat/lon (NOAA simplified
algorithm, matching the rex ``SolarPosition`` formulation used by the
reference's Sza deriver and SzaRasterizer — reference:
sup3r/preprocessing/derivers/methods.py:389,
sup3r/preprocessing/rasterizers/exo.py:531). The port's copy, on the
pandas-free ``TimeIndex``."""

import numpy as np

from sup3r_tpu_torch.utilities.times import TimeIndex, seconds_since


def _days_since_j2000(time_index):
    """Fractional days since 2000-01-01 12:00 UTC."""
    return seconds_since(time_index, '2000-01-01 12:00:00') / 86400.0


def solar_angles(time_index, lon):
    """(declination, eq_of_time-corrected hour angle) in degrees.

    lon: array of longitudes (degrees east). Returns arrays broadcast to
    (n_times, *lon.shape)."""
    n = np.asarray(_days_since_j2000(time_index))[:, None]
    lon = np.asarray(lon).ravel()[None, :]

    # mean longitude / anomaly (deg)
    L = (280.460 + 0.9856474 * n) % 360
    g = np.radians((357.528 + 0.9856003 * n) % 360)
    # ecliptic longitude (deg) and obliquity (deg)
    lam = np.radians(L + 1.915 * np.sin(g) + 0.020 * np.sin(2 * g))
    eps = np.radians(23.439 - 0.0000004 * n)

    # declination
    dec = np.arcsin(np.sin(eps) * np.sin(lam))

    # equation of time (minutes): from right ascension vs mean longitude
    ra = np.arctan2(np.cos(eps) * np.sin(lam), np.cos(lam))
    eqt = 4 * np.degrees(np.radians(L) - ra)
    eqt = (eqt + 720) % 1440 - 720

    # true solar time (minutes): UTC minutes + 4*lon + eqt
    t = TimeIndex(time_index)
    utc_min = (t.hour * 60 + t.minute + t.second / 60)[:, None]
    tst = utc_min + 4 * lon + eqt
    ha = np.radians(tst / 4 - 180.0)
    return np.degrees(dec), np.degrees(ha)


def solar_zenith(time_index, lat_lon):
    """Solar zenith angle in degrees.

    lat_lon: (..., 2) coordinates. Returns (*lat_lon.shape[:-1],
    n_times) float32 array (space-first to match feature layout)."""
    lat_lon = np.asarray(lat_lon)
    spatial_shape = lat_lon.shape[:-1]
    lat = np.radians(lat_lon[..., 0].ravel())[None, :]
    lon = lat_lon[..., 1].ravel()
    dec, ha = solar_angles(time_index, lon)
    dec, ha = np.radians(dec), np.radians(ha)
    cos_zen = (np.sin(lat) * np.sin(dec)
               + np.cos(lat) * np.cos(dec) * np.cos(ha))
    zen = np.degrees(np.arccos(np.clip(cos_zen, -1, 1)))
    out = zen.T.reshape(*spatial_shape, len(np.atleast_1d(
        np.asarray(_days_since_j2000(time_index)))))
    return out.astype(np.float32)
