"""QA metrics: spectra and distributions for super-resolved output.

Reference parity: sup3r/qa/utilities.py:10-345. The port's copy of
``sup3r_tpu/qa/utilities.py``: numpy functions of host arrays, as there.
"""

import numpy as np


def _map_axis(vals, vrange):
    """Relabel an index axis onto the physical [min, max] range the
    caller supplies (reference: qa/utilities.py:39-43 — needed to
    compare spectra between domains with different resolutions)."""
    if vrange is None:
        return np.asarray(vals)
    return np.linspace(vrange[0], vrange[1], len(vals))


def _fold_freq_spectrum(e_f, f_range):
    """Reference frequency-spectrum convention (qa/utilities.py:10-85):
    f^2-weight the full spectrum on the (possibly physical) frequency
    axis, then fold the positive/negative halves."""
    f_full = _map_axis(np.arange(len(e_f)), f_range)
    e_f = f_full ** 2 * e_f
    n = len(e_f) // 2
    folded = e_f[:n] + e_f[-n:][::-1]
    return f_full[:n], folded


def tke_frequency_spectrum(u, v, f_range=None):
    """Turbulent kinetic energy spectrum over frequency (time axis
    last). Reference convention: |u_f|^2 + |v_f|^2 with f^2 weighting
    and folded halves (reference: qa/utilities.py:10-48);
    ``f_range=[f_min, f_max]`` maps the frequency axis to physical
    units (e.g. 1/max_time .. 1/min_time)."""
    u_f = np.abs(np.fft.fft(u, axis=-1)) ** 2
    v_f2 = np.abs(np.fft.fft(v, axis=-1)) ** 2
    # SUM over sites: the reference's fftn over (sites, time) + mean
    # over site-frequencies equals the site-SUM of per-site time
    # spectra (Parseval over the site axis) — a mean here would be a
    # factor n_sites below reference-produced artifacts
    spectrum = (u_f + v_f2).reshape(-1, u_f.shape[-1]).sum(axis=0)
    return _fold_freq_spectrum(spectrum, f_range)


def frequency_spectrum(var, f_range=None):
    """Mean power spectrum along the time axis (last axis), reference
    convention (f^2-weighted, folded halves; qa/utilities.py:50-85).
    ``f_range`` maps the frequency axis to physical units."""
    spec = np.abs(np.fft.fft(var, axis=-1)) ** 2
    # site-SUM, not mean — see tke_frequency_spectrum
    spec = spec.reshape(-1, spec.shape[-1]).sum(axis=0)
    return _fold_freq_spectrum(spec, f_range)


def wavenumber_spectrum(var, x_range=None, axis=0):
    """2D spatial power spectrum of (s1, s2[, t]) data (mean over any
    trailing axes). ``axis=0``/``1`` returns the 1D zonal/meridional
    spectrum (mean of the 2D power over that axis, folded halves —
    reference: qa/utilities.py:131-168, whose default is also
    ``axis=0``); ``axis=None`` is an extension that bins radially.
    ``x_range=[k_min, k_max]`` relabels the wavenumber axis to
    physical units."""
    if var.ndim == 3:
        var = var.mean(axis=-1)
    spec2d = np.abs(np.fft.fft2(var)) ** 2
    s1, s2 = var.shape
    if axis is not None:
        # reference 1D spectrum semantics (qa/utilities.py:131-168):
        # k^2-weight the FULL spectrum on the (possibly physical)
        # wavenumber axis, then fold the halves
        e_k = spec2d.mean(axis=axis)
        k_full = _map_axis(np.arange(len(e_k)), x_range)
        e_k = k_full ** 2 * e_k
        n = len(e_k) // 2
        folded = e_k[1:n + 1] + e_k[-n:][::-1]
        return k_full[:n], folded
    k1 = np.fft.fftfreq(s1) * s1
    k2 = np.fft.fftfreq(s2) * s2
    kmag = np.hypot(*np.meshgrid(k1, k2, indexing='ij'))
    kbins = np.arange(1, int(min(s1, s2) / 2) + 1)
    spectrum = np.array([
        spec2d[(kmag >= k - 0.5) & (kmag < k + 0.5)].mean()
        for k in kbins])
    return _map_axis(kbins, x_range), spectrum


def tke_wavenumber_spectrum(u, v, x_range=None, axis=0):
    """Spatial spectrum of turbulent kinetic energy (zonal ``axis=0``
    by default, matching the reference; ``axis=1`` meridional;
    ``axis=None`` is a radial-binning extension).
    Amplitudes follow the reference convention |u_k|^2 + |v_k|^2
    (no 1/2 factor) so spectra compare against reference QA output
    (reference: qa/utilities.py:87-128)."""
    k, su = wavenumber_spectrum(u, x_range=x_range, axis=axis)
    _, sv = wavenumber_spectrum(v, x_range=x_range, axis=axis)
    return k, su + sv


def _finish_dist(diffs, bins, range, diff_max, percentile, interpolate):
    """Shared tail of the distribution functions: percentile/diff_max
    clipping, RMS normalization factor, histogram (reference:
    qa/utilities.py:219-224)."""
    diffs = np.asarray(diffs, dtype=np.float64)
    diffs = diffs[np.isfinite(diffs)]
    diff_max = diff_max or np.percentile(np.abs(diffs), percentile)
    diffs = diffs[np.abs(diffs) < diff_max]
    norm = float(np.sqrt(np.mean(diffs ** 2)))
    counts, centers = continuous_dist(diffs, bins=bins, range=range,
                                      interpolate=interpolate)
    return centers, counts, norm


def direct_dist(var, bins=40, range=None, diff_max=None, scale=1,
                percentile=99.9, interpolate=False, period=None):
    """Distribution of raw values. With ``period`` (e.g. 360 for
    winddirection) values are wrapped into [0, period) first. Returns
    (bin centers, normalized counts, RMS normalization factor)
    (reference: qa/utilities.py:170-224)."""
    var = np.asarray(var, dtype=np.float64).ravel()
    if period is not None:
        var = (var + period) % period
    return _finish_dist(var / scale, bins, range, diff_max, percentile,
                        interpolate)


def gradient_dist(var, bins=40, range=None, diff_max=None, scale=1,
                  percentile=99.9, interpolate=False, period=None):
    """Distribution of west-east spatial gradients. With ``period``,
    differences wrap to the shortest signed arc in
    [-period/2, period/2) so e.g. 359->1 degrees is a +2 step
    (reference: qa/utilities.py:227-279)."""
    diffs = np.diff(np.asarray(var, dtype=np.float64), axis=1).ravel()
    if period is not None:
        diffs = (diffs + period / 2) % period - period / 2
    return _finish_dist(diffs / scale, bins, range, diff_max,
                        percentile, interpolate)


def time_derivative_dist(var, bins=40, range=None, diff_max=None,
                         t_steps=1, scale=1, percentile=99.9,
                         interpolate=False, period=None):
    """Distribution of temporal derivatives over ``t_steps`` (last
    axis), with the same circular-``period`` handling as
    gradient_dist (reference: qa/utilities.py:282-342)."""
    var = np.asarray(var, dtype=np.float64)
    msg = (f'Received t_steps={t_steps} for time derivative but data '
           f'only has {var.shape[-1]} time steps')
    assert t_steps < var.shape[-1], msg
    diffs = (var[..., t_steps:] - var[..., :-t_steps]).ravel()
    if period is not None:
        diffs = (diffs + period / 2) % period - period / 2
    return _finish_dist(diffs / scale, bins, range, diff_max,
                        percentile, interpolate)


def continuous_dist(diffs, bins=None, range=None, interpolate=False):
    """Histogram of ``diffs`` with sum-normalized counts. ``bins=None``
    picks a bin count from the mean nonzero value spacing;
    ``interpolate=True`` fills zero-count bins by interpolating
    between surrounding nonzero bins (reference:
    qa/utilities.py:345-387)."""
    diffs = np.asarray(diffs, dtype=np.float64)
    if bins is None:
        dx = np.abs(np.diff(diffs))
        dx = dx[dx > 0]
        dx = np.mean(dx) if dx.size else 1.0
        bins = max(int((np.max(diffs) - np.min(diffs)) / dx), 1)
    counts, edges = np.histogram(diffs, bins=bins, range=range)
    centers = edges[:-1] + np.diff(edges) / 2
    if interpolate:
        nz = np.where(counts > 0)[0]
        if len(nz) > 1:
            x, y = centers[nz], counts[nz]
            filled = np.interp(centers, x, y)
            # zero outside the support (interp1d fill_value=0)
            filled[(centers < x[0]) | (centers > x[-1])] = 0.0
            counts = filled
    total = counts.sum()
    counts = counts.astype(float) / (total if total else 1.0)
    return counts, centers
