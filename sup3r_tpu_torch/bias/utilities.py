"""Runtime bias-correction dispatch for the forward-pass chunk path and
the handler-level corrections.

The port's copy of ``sup3r_tpu/bias/utilities.py``. Reference parity:
sup3r/bias/utilities.py:22-332 (lin_bc / qdm_bc, and
bias_correct_feature / bias_correct_features invoked from
ForwardPassStrategy.prep_chunk_data).
"""

import inspect
import logging

import numpy as np

import sup3r_tpu_torch.bias.transforms as transforms_mod
from sup3r_tpu_torch.bias.transforms import (
    _get_spatial_bc_factors,
    factor_file_variables,
    get_date_range_kwargs,
    local_qdm_bc,
)

logger = logging.getLogger(__name__)


def bias_correct_feature(source_feature, data, feature_names, lat_lon,
                         time_index, bc_method, bc_kwargs,
                         lr_padded_slice=None):
    """Bias correct one feature channel in a chunk array.

    data: (s1, s2, t, n_features) padded chunk input.
    lr_padded_slice: the chunk's padded (row, col) slices into the full
    input raster: when the bias factor rasters share that grid this
    windows them by slice directly, skipping per-chunk lat/lon matching
    (reference: bias_transforms.py lr_padded_slice args)."""
    method = getattr(transforms_mod, bc_method, None)
    if method is None or not callable(method):
        raise KeyError(
            f'Unknown bias correction method "{bc_method}"')
    kwargs = dict(bc_kwargs.get(source_feature, {}))
    idf = feature_names.index(source_feature)
    feature_data = data[..., idf]

    sig_params = inspect.signature(method).parameters
    if 'lr_padded_slice' in sig_params and lr_padded_slice is not None:
        kwargs.setdefault('lr_padded_slice', lr_padded_slice)
    if 'date_range_kwargs' in sig_params and (
            'date_range_kwargs' not in kwargs):
        kwargs['date_range_kwargs'] = get_date_range_kwargs(time_index)
    if 'lat_lon' in sig_params:
        kwargs.setdefault('lat_lon', lat_lon)
    if 'feature_name' in sig_params:
        kwargs.setdefault('feature_name', source_feature)
    if 'time_index' in sig_params:
        kwargs.setdefault('time_index', time_index)
    kwargs = {k: v for k, v in kwargs.items() if k in sig_params}
    data[..., idf] = method(feature_data, **kwargs)
    return data


def bias_correct_features(features, data, feature_names, lat_lon,
                          time_index, bc_method, bc_kwargs,
                          lr_padded_slice=None):
    """Bias correct all requested features of a copy of ``data``."""
    data = np.array(data)
    for feature in features:
        if feature not in feature_names:
            logger.warning(
                'Bias correction requested for "%s" but it is not in '
                'the chunk features %s', feature, feature_names)
            continue
        data = bias_correct_feature(
            feature, data, feature_names, lat_lon, time_index,
            bc_method, bc_kwargs, lr_padded_slice=lr_padded_slice)
    return data


def _factor_dsets(fp):
    """Lower-cased variable names in a factor file (H5 or NetCDF3)."""
    return {k.lower() for k in factor_file_variables(fp)}


def lin_bc(handler, bc_files, bias_feature=None, threshold=0.1):
    """Bias correct a DataHandler's data IN PLACE with linear factors
    from LinearCorrection / MonthlyLinearCorrection output files
    (annual factors have a length-1 last dim, monthly length-12,
    selected by each timestep's calendar month). Reference parity:
    sup3r/bias/utilities.py:22-101."""
    if isinstance(bc_files, str):
        bc_files = [bc_files]
    completed = []
    for feature in handler.features:
        ref_feature = bias_feature or feature
        dset_scalar = f'{ref_feature}_scalar'.lower()
        dset_adder = f'{ref_feature}_adder'.lower()
        for fp in bc_files:
            dsets = _factor_dsets(fp)
            if feature in completed or not (
                    dset_scalar in dsets and dset_adder in dsets):
                continue
            out = _get_spatial_bc_factors(
                np.asarray(handler.lat_lon), ref_feature, fp,
                threshold=threshold)
            scalar, adder = out['scalar'], out['adder']
            nt = handler.data[feature].shape[-1]
            if scalar.shape[-1] == 1:
                scalar = np.repeat(scalar, nt, axis=2)
                adder = np.repeat(adder, nt, axis=2)
            elif scalar.shape[-1] == 12:
                idm = handler.time_index.month - 1
                scalar = scalar[..., idm]
                adder = adder[..., idm]
            else:
                raise RuntimeError(
                    'Can only accept bias correction factors with '
                    'last dim equal to 1 or 12 but received factors '
                    f'with shape {scalar.shape}')
            logger.info('Bias correcting "%s" with linear correction '
                        'from "%s"', feature, fp)
            handler.data[feature] = (
                scalar * np.asarray(handler.data[feature]) + adder)
            completed.append(feature)
    return completed


def qdm_bc(handler, bc_files, bias_feature, relative=True,
           threshold=0.1, no_trend=False, delta_denom_min=None,
           delta_denom_zero=None, delta_range=None, out_range=None,
           max_workers=1):
    """Bias correct a DataHandler's data IN PLACE with Quantile Delta
    Mapping from QuantileDeltaMappingCorrection output files.
    Reference parity: sup3r/bias/utilities.py:104-218."""
    if isinstance(bc_files, str):
        bc_files = [bc_files]
    completed = []
    dr_kwargs = get_date_range_kwargs(handler.time_index)
    for feature in handler.features:
        dset_hist = f'bias_{feature}_params'.lower()
        dset_fut = f'bias_fut_{feature}_params'.lower()
        for fp in bc_files:
            dsets = _factor_dsets(fp)
            if feature in completed or not (
                    dset_hist in dsets and dset_fut in dsets):
                continue
            logger.info('Bias correcting "%s" with QDM correction '
                        'from "%s"', feature, fp)
            handler.data[feature] = local_qdm_bc(
                np.asarray(handler.data[feature]),
                np.asarray(handler.lat_lon), bias_feature, feature,
                bias_fp=fp, date_range_kwargs=dr_kwargs,
                threshold=threshold, relative=relative,
                no_trend=no_trend, delta_denom_min=delta_denom_min,
                delta_denom_zero=delta_denom_zero,
                delta_range=delta_range, out_range=out_range,
                max_workers=max_workers)
            completed.append(feature)
    return completed
