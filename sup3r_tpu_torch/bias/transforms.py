"""Runtime bias-correction transforms applied per forward-pass chunk.

The port's copy of ``sup3r_tpu/bias/transforms.py`` on the pandas-free
``TimeIndex``. Reference parity: sup3r/bias/bias_transforms.py
(_get_factors :27, global/local/monthly linear :224-488, local_qdm_bc
:622, local_presrat_bc :958).

Bias factor files hold 2D 'latitude'/'longitude' variables, factor
rasters shaped (s1, s2, ...) and a JSON 'cfg' attribute. They are read
as H5 (h5py, which also opens NetCDF4) or as NetCDF3 (scipy), so a
machine without h5py reads the NetCDF3 form of the same contract
(``utilities.test_helpers.write_nc_factor_file``).
"""

import json
import logging
import re
from warnings import warn

import numpy as np
from scipy.ndimage import gaussian_filter

from sup3r_tpu_torch.bias.qdm_math import QuantileDeltaMapping
from sup3r_tpu_torch.preprocessing.rasterizers import get_closest_row_col
from sup3r_tpu_torch.utilities.times import (
    TimeIndex,
    date_range,
    format_timestamps,
    to_datetime64,
)

logger = logging.getLogger(__name__)

#: nanoseconds of each fixed-step frequency alias of pandas (case
#: matters: 'MS' is month start, 'ms' milliseconds)
_FREQ_NS = {'D': 86400 * 10 ** 9, 'd': 86400 * 10 ** 9, 'h': 3600 * 10 ** 9,
            'H': 3600 * 10 ** 9, 'min': 60 * 10 ** 9, 'T': 60 * 10 ** 9,
            's': 10 ** 9, 'S': 10 ** 9, 'ms': 10 ** 6, 'L': 10 ** 6,
            'us': 10 ** 3, 'U': 10 ** 3, 'ns': 1, 'N': 1}


def _freq_str(step_ns):
    """pandas' ``to_offset(Timedelta(step)).freqstr`` of a fixed step:
    whole seconds as hours, minutes or seconds (days count as hours),
    else milli-, micro- or nanoseconds, with the multiple left out when
    it is 1."""
    step_ns = int(step_ns)
    units = ((3600 * 10 ** 9, 'h'), (60 * 10 ** 9, 'min'), (10 ** 9, 's'),
             (10 ** 6, 'ms'), (10 ** 3, 'us'), (1, 'ns'))
    for per, name in units:
        if step_ns % per == 0:
            n = step_ns // per
            return name if n == 1 else f'{n}{name}'
    raise ValueError(f'Bad time step {step_ns} ns')


def _freq_ns(freq):
    """A fixed frequency string ('h', '24h', 'D', '30min', ...) as a
    ``timedelta64[ns]`` step."""
    if isinstance(freq, np.timedelta64):
        return freq.astype('timedelta64[ns]')
    match = re.fullmatch(r'\s*(\d*)\s*([A-Za-z]+)\s*', str(freq))
    unit = match.group(2) if match else None
    if unit not in _FREQ_NS:
        raise ValueError(f'Unsupported date_range frequency "{freq}": a '
                         'fixed step (days or finer) is needed')
    n = int(match.group(1) or 1)
    return np.timedelta64(n * _FREQ_NS[unit], 'ns')


def _no_leap(time_index):
    """``time_index`` without its Feb 29 stamps."""
    return time_index[~((time_index.month == 2) & (time_index.day == 29))]


def get_date_range_kwargs(time_index):
    """kwargs to rebuild a time index with ``make_time_index_from_kws``
    (pandas' ``date_range`` kwargs; reference:
    sup3r/preprocessing/utilities.py:173-220).

    Noleap-calendar data (NCforCC/CMIP) spanning a leap year has one
    irregular 2-day step at Feb 29; like the reference, that case is
    encoded as ``drop_leap=True`` (rebuild the nominal range, then
    drop Feb 29) rather than failing the regular-frequency rebuild."""
    values = to_datetime64(time_index)
    if len(values) > 1:
        deltas, counts = np.unique(np.diff(values).astype(np.int64),
                                   return_counts=True)
        freq = _freq_str(deltas[np.argmax(counts)])
    else:
        deltas = np.array([])
        freq = 'D'
    start, end = format_timestamps(values[[0, -1]])
    kwargs = {'start': start, 'end': end, 'freq': freq}
    if len(deltas) > 1:
        # only encode drop_leap when dropping Feb 29 from the nominal
        # range ACTUALLY reproduces the index: an ordinary data gap
        # also makes the nominal rebuild longer, and labeling it a
        # noleap calendar would shift every day-of-year window
        noleap = _no_leap(make_time_index_from_kws(kwargs))
        if noleap.equals(values):
            kwargs['drop_leap'] = True
        else:
            raise ValueError(
                f'Got multiple unique time steps ({deltas} ns) for time '
                f'index starting {start} — input data must have a '
                'consistent frequency (a noleap calendar is the one '
                'supported irregularity)')
    return kwargs


def make_time_index_from_kws(date_range_kwargs):
    """Rebuild the ``TimeIndex`` from ``get_date_range_kwargs`` output
    (reference: sup3r/preprocessing/utilities.py:222-245), honoring the
    ``drop_leap`` kwarg reference-produced dicts may carry. The caller's
    dict is not mutated."""
    kws = dict(date_range_kwargs)
    drop_leap = kws.pop('drop_leap', False)
    time_index = date_range(kws['start'], kws['end'], _freq_ns(kws['freq']))
    return _no_leap(time_index) if drop_leap else time_index


def _open_factor_file(bias_fp):
    """(variables, attrs, close) of a factor file: ``variables`` maps
    each name to an array-like read on slicing (h5py datasets; scipy's
    memory-mapped NetCDF3 variables), ``attrs`` the file's global
    attributes. NetCDF3 is told apart by its magic bytes."""
    with open(bias_fp, 'rb') as f:
        magic = f.read(4)
    if magic.startswith(b'CDF'):
        from scipy.io import netcdf_file

        # memory-mapped: a chunk reads only its window of each raster
        handle = netcdf_file(bias_fp, 'r', mmap=True)
        variables = {k: v.data for k, v in handle.variables.items()}
        attrs = dict(handle._attributes)

        def close():
            # drop the views of the map before scipy unmaps it
            variables.clear()
            handle.close()

        return variables, attrs, close
    import h5py

    handle = h5py.File(bias_fp, 'r')
    return dict(handle.items()), dict(handle.attrs), handle.close


def factor_file_variables(bias_fp):
    """Names of the variables in a factor file (H5 or NetCDF3)."""
    variables, _, close = _open_factor_file(bias_fp)
    try:
        return list(variables)
    finally:
        close()


def _native(arr):
    """``arr`` as an array in the machine's byte order (NetCDF3 stores
    big-endian values)."""
    arr = np.asarray(arr)
    return arr.astype(arr.dtype.newbyteorder('='), copy=False)


def _decode_attr(value):
    if isinstance(value, bytes):
        return value.decode()
    return value


def _compose(outer, inner, n):
    """The slice of an axis of length ``n`` that ``inner`` selects
    within the part ``outer`` selects."""
    sub = range(n)[outer][inner]
    return slice(sub.start, sub.stop, sub.step)


def _read_factor_file(bias_fp, var_names, lat_lon, threshold=0.1,
                      lr_padded_slice=None):
    """Read factor rasters matching the chunk's lat/lon window.

    Finds the chunk's corner in the factor file's grid and slices the
    matching window (reference: bias_transforms.py:27-118);
    ``lr_padded_slice`` (row, col slices into that window) narrows the
    read to a chunk of it, as slicing the window after the read
    would."""
    out = {}
    variables, attrs, close = _open_factor_file(bias_fp)
    try:
        if 'latitude' in variables and variables['latitude'].ndim == 1:
            raise NotImplementedError(
                'Bias factor files must have 2D latitude/longitude')
        full = np.dstack([_native(variables['latitude'][:]),
                          _native(variables['longitude'][:])])
        target = np.asarray(lat_lon[-1, 0, :])
        shape = lat_lon.shape[:2]
        row, col = get_closest_row_col(full, target, threshold)
        lat_slice = slice(max(row - shape[0] + 1, 0), row + 1)
        lon_slice = slice(col, col + shape[1])
        if lr_padded_slice is not None:
            lat_slice = _compose(lat_slice, lr_padded_slice[0],
                                 full.shape[0])
            lon_slice = _compose(lon_slice, lr_padded_slice[1],
                                 full.shape[1])
        for key, dset in var_names.items():
            if dset not in variables:
                raise KeyError(
                    f'Missing dataset "{dset}" in {bias_fp}; has '
                    f'{sorted(variables)}')
            out[key] = np.array(_native(variables[dset][lat_slice,
                                                         lon_slice]))
        cfg = {}
        if 'cfg' in attrs:
            cfg = json.loads(_decode_attr(attrs['cfg']))
        for k, v in attrs.items():
            if k != 'cfg':
                try:
                    cfg[k] = json.loads(_decode_attr(v))
                except (TypeError, json.JSONDecodeError):
                    cfg[k] = v
        out['cfg'] = cfg
    finally:
        close()
    return out


def _get_spatial_bc_factors(lat_lon, feature_name, bias_fp,
                            threshold=0.1, lr_padded_slice=None):
    return _read_factor_file(
        bias_fp,
        {'scalar': f'{feature_name}_scalar',
         'adder': f'{feature_name}_adder'},
        lat_lon, threshold, lr_padded_slice)


def _get_spatial_bc_quantiles(lat_lon, base_dset, feature_name, bias_fp,
                              threshold=0.1, lr_padded_slice=None):
    return _read_factor_file(
        bias_fp,
        {'base': f'base_{base_dset}_params',
         'bias': f'bias_{feature_name}_params',
         'bias_fut': f'bias_fut_{feature_name}_params'},
        lat_lon, threshold, lr_padded_slice)


def global_linear_bc(data, scalar, adder, out_range=None):
    """out = data * scalar + adder, optionally clipped."""
    out = data * scalar + adder
    if out_range is not None:
        out = np.clip(out, np.min(out_range), np.max(out_range))
    return out


def _smooth_factors(scalar, adder, smoothing):
    if smoothing > 0:
        for idt in range(scalar.shape[-1] if scalar.ndim == 3 else 1):
            if scalar.ndim == 3:
                scalar[..., idt] = gaussian_filter(
                    scalar[..., idt], smoothing, mode='nearest')
                adder[..., idt] = gaussian_filter(
                    adder[..., idt], smoothing, mode='nearest')
            else:
                scalar[:] = gaussian_filter(scalar, smoothing,
                                            mode='nearest')
                adder[:] = gaussian_filter(adder, smoothing,
                                           mode='nearest')
    return scalar, adder


def local_linear_bc(data, lat_lon, feature_name, bias_fp,
                    lr_padded_slice=None, out_range=None, smoothing=0,
                    threshold=0.1):
    """Site-by-site scalar/adder correction (reference:
    bias_transforms.py:251)."""
    out = _get_spatial_bc_factors(lat_lon, feature_name, bias_fp,
                                  threshold, lr_padded_slice)
    scalar, adder = np.array(out['scalar']), np.array(out['adder'])
    if scalar.ndim == 3:
        scalar = scalar.mean(axis=-1)
        adder = adder.mean(axis=-1)
    if np.isnan(scalar).any() or np.isnan(adder).any():
        warn(f'NaNs in bias factors for "{feature_name}"')
    scalar, adder = _smooth_factors(scalar, adder, smoothing)
    out = data * scalar[..., None] + adder[..., None]
    if out_range is not None:
        out = np.clip(out, np.min(out_range), np.max(out_range))
    return out.astype(np.float32)


def monthly_local_linear_bc(data, lat_lon, feature_name, bias_fp,
                            date_range_kwargs, lr_padded_slice=None,
                            temporal_avg=True, out_range=None,
                            smoothing=0, scalar_range=None,
                            adder_range=None, threshold=0.1):
    """Monthly scalar/adder correction: factor rasters are (s1, s2, 12)
    indexed by the chunk's months (reference: bias_transforms.py:351)."""
    time_index = make_time_index_from_kws(date_range_kwargs)
    out = _get_spatial_bc_factors(lat_lon, feature_name, bias_fp,
                                  threshold, lr_padded_slice)
    scalar, adder = np.array(out['scalar']), np.array(out['adder'])
    assert scalar.ndim == 3 and adder.ndim == 3, (
        'Monthly bias correction needs 3D factors')
    imonths = time_index.month - 1
    scalar = scalar[..., imonths]
    adder = adder[..., imonths]
    if temporal_avg:
        scalar = scalar.mean(axis=-1)[..., None]
        adder = adder.mean(axis=-1)[..., None]
        if len(set(time_index.month)) > 1:
            warn('Using monthly bias correction with temporal_avg over '
                 'multiple months; consider temporal_avg=False')
    scalar, adder = _smooth_factors(scalar, adder, smoothing)
    if scalar_range is not None:
        scalar = np.clip(scalar, *scalar_range)
    if adder_range is not None:
        adder = np.clip(adder, *adder_range)
    out = data * scalar + adder
    if out_range is not None:
        out = np.clip(out, np.min(out_range), np.max(out_range))
    return out.astype(np.float32)


def window_mask(doy, d0, window_size):
    """Bool index of days-of-year strictly within a (wrapping) window
    around d0 (reference: sup3r/bias/qdm.py:583)."""
    d_start = d0 - window_size / 2
    d_end = d0 + window_size / 2
    if d_start < 0:
        return (doy > 365 + d_start) | (doy < d_end)
    if d_end > 365:
        return (doy > d_start) | (doy < d_end - 365)
    return (doy > d_start) & (doy < d_end)


def _apply_qdm_windowed(data, time_index, base_params, bias_params,
                        bias_fut_params, time_window_center,
                        relative=True, sampling='linear', log_base=10,
                        no_trend=False, delta_denom_min=None,
                        delta_denom_zero=None, delta_range=None,
                        bias_tau_fut=None, k_factor=None):
    """Apply QDM per day-of-year window. params are (s1, s2, T, N).

    Each timestamp is assigned to its NEAREST window center (reference:
    bias_transforms.py:788-791 ``closest_time_idx``): a strict
    in-window mask would leave days uncovered (doy 365/366 always).
    When ``bias_tau_fut`` / ``k_factor`` are given (PresRat), zero-rate
    preservation and the K factor apply per window, and not at all
    under ``no_trend`` (reference: bias_transforms.py:1117-1120)."""
    s1, s2, _ = data.shape
    output = np.full_like(data, np.nan, dtype=np.float32)
    centers = np.asarray(time_window_center, dtype=np.float64)
    doy = np.asarray(TimeIndex(time_index).dayofyear, dtype=np.float64)
    closest = np.argmin(np.abs(doy[:, None] - centers[None, :]), axis=1)
    for nt in np.unique(closest):
        mask = closest == nt
        qdm = QuantileDeltaMapping(
            params_oh=base_params[:, :, nt].reshape(s1 * s2, -1),
            params_mh=bias_params[:, :, nt].reshape(s1 * s2, -1),
            params_mf=(None if no_trend
                       else bias_fut_params[:, :, nt].reshape(
                           s1 * s2, -1)),
            relative=relative, sampling=sampling, log_base=log_base,
            delta_denom_min=delta_denom_min,
            delta_denom_zero=delta_denom_zero, delta_range=delta_range)
        subset = data[:, :, mask].reshape(s1 * s2, -1).T  # (T_w, S)
        corrected = qdm(subset).T.reshape(s1, s2, -1)
        if bias_tau_fut is not None and not no_trend:
            corrected = np.where(
                corrected < bias_tau_fut, 0,
                corrected * k_factor[:, :, nt:nt + 1])
        output[:, :, mask] = corrected
    return output


def local_qdm_bc(data, lat_lon, base_dset, feature_name, bias_fp,
                 date_range_kwargs, lr_padded_slice=None,
                 threshold=0.1, relative=True, no_trend=False,
                 delta_denom_min=None, delta_denom_zero=None,
                 delta_range=None, out_range=None, max_workers=1):
    """Quantile delta mapping using pre-calculated windowed empirical
    CDFs (reference: bias_transforms.py:622). ``max_workers`` is
    accepted for reference-config compatibility: the transform is one
    vectorized pass over all gids, not rex's worker pool."""
    assert data.ndim == 3, f'Expected 3D data, got {data.shape}'
    time_index = make_time_index_from_kws(date_range_kwargs)
    assert data.shape[-1] == len(time_index), (
        f'Data time axis {data.shape[-1]} != time index '
        f'{len(time_index)}')
    params = _get_spatial_bc_quantiles(lat_lon, base_dset, feature_name,
                                       bias_fp, threshold, lr_padded_slice)
    base = np.asarray(params['base'])
    bias = np.asarray(params['bias'])
    bias_fut = np.asarray(params['bias_fut'])
    cfg = params['cfg']
    out = _apply_qdm_windowed(
        np.asarray(data), time_index, base, bias, bias_fut,
        cfg['time_window_center'], relative=relative,
        sampling=cfg.get('sampling', 'linear'),
        log_base=cfg.get('log_base', 10), no_trend=no_trend,
        delta_denom_min=delta_denom_min,
        delta_denom_zero=delta_denom_zero, delta_range=delta_range)
    if out_range is not None:
        out = np.clip(out, np.min(out_range), np.max(out_range))
    if not np.isfinite(out).all():
        msg = ('local_qdm_bc produced non-finite output. A relative '
               'QDM divides by the historical-bias delta, which can '
               'vanish — bound it with ``delta_denom_min`` or replace '
               'zeros with ``delta_denom_zero`` (the reference raises '
               'here too: bias_transforms.py:816-825)')
        logger.error(msg)
        raise RuntimeError(msg)
    return out


def _get_spatial_bc_presrat(lat_lon, base_dset, feature_name, bias_fp,
                            threshold=0.1, lr_padded_slice=None):
    return _read_factor_file(
        bias_fp,
        {'base': f'base_{base_dset}_params',
         'bias': f'bias_{feature_name}_params',
         'bias_fut': f'bias_fut_{feature_name}_params',
         'bias_tau_fut': f'{feature_name}_tau_fut',
         'k_factor': f'{feature_name}_k_factor'},
        lat_lon, threshold, lr_padded_slice)


def local_presrat_bc(data, lat_lon, base_dset, feature_name, bias_fp,
                     date_range_kwargs, lr_padded_slice=None,
                     threshold=0.1, relative=True, no_trend=False,
                     delta_denom_min=None, delta_denom_zero=None,
                     delta_range=None, k_range=None, out_range=None,
                     max_workers=1):
    """PresRat: QDM + zero-rate preservation + K-factor mean-trend
    preservation (reference: bias_transforms.py:958)."""
    time_index = make_time_index_from_kws(date_range_kwargs)
    assert data.ndim == 3
    assert data.shape[-1] == len(time_index)
    params = _get_spatial_bc_presrat(lat_lon, base_dset, feature_name,
                                     bias_fp, threshold, lr_padded_slice)
    cfg = params['cfg']
    base = np.asarray(params['base'])
    bias = np.asarray(params['bias'])
    bias_fut = np.asarray(params['bias_fut'])
    bias_tau_fut = np.asarray(params['bias_tau_fut'])
    k_factor = np.asarray(params['k_factor'])
    # the file's zero_rate_threshold is the default clamp for the
    # relative-delta denominator (reference: bias_transforms.py:1073):
    # without it, dry-quantile x_mh ~ 1e-12 makes delta explode
    if delta_denom_min is None:
        delta_denom_min = cfg.get('zero_rate_threshold')
    if k_range is not None:
        k_factor = np.clip(k_factor, *k_range)

    # zero-rate preservation + K factor apply per window INSIDE the QDM
    # loop, and not at all under no_trend (reference:
    # bias_transforms.py:1117-1120)
    data_unbiased = _apply_qdm_windowed(
        np.asarray(data), time_index, base, bias, bias_fut,
        cfg['time_window_center'], relative=relative,
        sampling=cfg.get('sampling', 'linear'),
        log_base=cfg.get('log_base', 10), no_trend=no_trend,
        delta_denom_min=delta_denom_min,
        delta_denom_zero=delta_denom_zero, delta_range=delta_range,
        bias_tau_fut=bias_tau_fut[..., :1], k_factor=k_factor)
    if out_range is not None:
        data_unbiased = np.clip(data_unbiased, np.min(out_range),
                                np.max(out_range))
    if np.isnan(data_unbiased).any():
        msg = ('local_presrat_bc produced NaN output. The underlying '
               'relative QDM divides by the historical-bias delta, '
               'which can vanish — bound it with ``delta_denom_min`` '
               'or replace zeros with ``delta_denom_zero`` (the '
               'reference raises here too: bias_transforms.py:1128-1135)')
        logger.error(msg)
        raise RuntimeError(msg)
    if data_unbiased.std() == 0:
        warn(f'Presrat output for {feature_name} is constant!')
    return data_unbiased.astype(np.float32)
