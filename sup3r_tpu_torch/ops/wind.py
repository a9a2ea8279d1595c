"""Wind coordinate transforms: (ws, wd) <-> grid-aligned (u, v).

The grid rotation angle theta is derived from the lat/lon raster itself
(angle of the south_north axis vs true north), so u/v are aligned with
the (possibly curvilinear) grid exactly as in the reference.

Reference parity: sup3r/preprocessing/derivers/utilities.py:146
(transform_rotate_wind), :205 (invert_uv). The port's copy of
``sup3r_tpu/ops/wind.py``.
"""

import numpy as np

from sup3r_tpu_torch.ops._dispatch import array_module


def _grid_angle(lat_lon, xp):
    """Angle (radians) of each grid column's south->north direction
    measured from true north, computed from vertical neighbor deltas."""
    dy = lat_lon[:, :, 0] - xp.roll(lat_lon[:, :, 0], 1, axis=0)
    dx = lat_lon[:, :, 1] - xp.roll(lat_lon[:, :, 1], 1, axis=0)
    dy = (dy + 90) % 180 - 90
    dx = (dx + 180) % 360 - 180
    theta = (np.pi / 2) - xp.arctan2(dy, dx)
    if theta.shape[0] > 1:
        # row 0's delta wrapped around via roll; reuse row 1's angle
        theta = xp.concatenate([theta[1:2], theta[1:]], axis=0)
    return theta


def transform_rotate_wind(ws, wd, lat_lon):
    """(windspeed, winddirection) -> grid-aligned (u, v).

    ws, wd : ``(s1, s2, t)`` arrays; wd in degrees, direction wind comes
    FROM, clockwise from north. lat_lon: ``(s1, s2, 2)`` (lat, lon last).
    """
    xp = array_module(ws, wd, lat_lon)
    invert_lat = bool(np.asarray(lat_lon[-1, 0, 0] > lat_lon[0, 0, 0]))
    if invert_lat:
        lat_lon = lat_lon[::-1]
        ws = ws[::-1]
        wd = wd[::-1]
    theta = _grid_angle(lat_lon, xp)[:, :, None]
    wd_rad = xp.radians(wd)
    u = xp.cos(theta) * ws * xp.sin(wd_rad) + xp.sin(theta) * ws * xp.cos(
        wd_rad)
    v = -xp.sin(theta) * ws * xp.sin(wd_rad) + xp.cos(theta) * ws * xp.cos(
        wd_rad)
    if invert_lat:
        u = u[::-1]
        v = v[::-1]
    return u, v


def invert_uv_core(u, v, theta, invert_lat, xp, s_axis=0):
    """Rotation core of ``invert_uv`` with the grid angle and lat
    orientation precomputed, so it can run on device tensors (``xp`` =
    ``torch_numpy``; the device-side output pack) as well as numpy
    arrays, and over a leading batch dim. ``theta``: the grid angle WITH a trailing length-1 time
    axis, already computed on flipped coords when ``invert_lat``.
    ``s_axis``: index of the south_north axis in ``u``/``v``."""
    if invert_lat:
        u = xp.flip(u, axis=s_axis)
        v = xp.flip(v, axis=s_axis)
    u_rot = xp.cos(theta) * u - xp.sin(theta) * v
    v_rot = xp.sin(theta) * u + xp.cos(theta) * v
    ws = xp.hypot(u_rot, v_rot)
    wd = (xp.degrees(xp.arctan2(u_rot, v_rot)) + 360) % 360
    if invert_lat:
        ws = xp.flip(ws, axis=s_axis)
        wd = xp.flip(wd, axis=s_axis)
    return ws, wd


def invert_uv(u, v, lat_lon):
    """Grid-aligned (u, v) -> (windspeed, winddirection degrees)."""
    xp = array_module(u, v, lat_lon)
    invert_lat = bool(np.asarray(lat_lon[-1, 0, 0] > lat_lon[0, 0, 0]))
    if invert_lat:
        lat_lon = lat_lon[::-1]
    theta = _grid_angle(lat_lon, xp)[:, :, None]
    return invert_uv_core(u, v, theta, invert_lat, xp)
