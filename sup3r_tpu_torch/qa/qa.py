"""Sup3rQa: re-coarsen synthetic output and difference against the
low-res source.

Reference parity: sup3r/qa/qa.py:40-513 (coarsening :331-376, error
calc :467-513, bias-corrected input option :243). The port's copy of
``sup3r_tpu/qa/qa.py``: the re-coarsening, the u / v inversion and the
differences run on ``device`` with the port's ``ops.coarsen`` and
``ops.wind`` (the card unless the caller passes ``device='cpu'``). The
output is read from NetCDF anywhere and from H5 where h5py is
installed; ``export`` writes H5 (h5py).
"""

import logging
import os

import numpy as np
import torch

from sup3r_tpu_torch.ops.coarsen import (
    spatial_coarsening,
    temporal_coarsening,
)
from sup3r_tpu_torch.ops._dispatch import torch_numpy
from sup3r_tpu_torch.ops.output_pack import theta_for
from sup3r_tpu_torch.ops.wind import invert_uv_core
from sup3r_tpu_torch.preprocessing.data_handlers import (
    get_input_handler_class,
)
from sup3r_tpu_torch.preprocessing.loaders import (
    LoaderH5,
    LoaderNC,
    get_source_type,
)
from sup3r_tpu_torch.utilities import resolve_device

logger = logging.getLogger(__name__)


class Sup3rQa:
    """Quality assurance of a forward-pass output file vs its source."""

    def __init__(self, source_file_paths, out_file_path, s_enhance,
                 t_enhance, temporal_coarsening_method='average',
                 features=None, source_features=None, output_names=None,
                 input_handler_name=None,
                 input_handler_kwargs=None, bias_correct_method=None,
                 bias_correct_kwargs=None, qa_fp=None,
                 save_sources=True, device='cuda'):
        """``source_features``: source dataset names when they differ
        from the output feature names (e.g. features='ghi',
        source_features='rsds'); ``output_names``: qa-file dataset
        names per feature; ``temporal_coarsening_method`` may be a
        list with one method per feature; ``save_sources`` also writes
        the re-coarsened synthetic + true low-res data to qa_fp
        (reference: qa.py:45-152). ``device`` runs the comparison
        (the card by default; it raises without one)."""
        self.device = resolve_device(device)
        self.s_enhance = s_enhance
        self.t_enhance = t_enhance
        self.t_method = temporal_coarsening_method
        self.qa_fp = qa_fp
        self.save_sources = save_sources
        self.output_type = get_source_type(out_file_path)
        self.out_file_path = out_file_path

        # synthetic output
        if self.output_type == 'h5':
            self.output_handler = LoaderH5(out_file_path)
            out_features = self.output_handler.features
        else:
            self.output_handler = LoaderNC(out_file_path)
            out_features = self.output_handler.data.features
        self.features = features or [
            f for f in out_features
            if f not in ('topography',)]
        if isinstance(self.features, str):
            self.features = [self.features]
        if isinstance(source_features, str):
            source_features = [source_features]
        if isinstance(output_names, str):
            output_names = [output_names]
        self._explicit_sources = list(source_features or [])
        self.output_names = list(output_names or self.features)
        assert len(self.output_names) == len(self.features), (
            'output_names must align with features')
        if self._explicit_sources:
            assert len(self._explicit_sources) == len(self.features), (
                'source_features must align with features')

        # source (low-res) data
        HandlerClass = get_input_handler_class(input_handler_name)
        source_features = [self._source_feature(f, i)
                           for i, f in enumerate(self.features)]
        flat_source = [f for grp in source_features
                       for f in (grp if isinstance(grp, list)
                                 else [grp])]
        self.input_handler = HandlerClass(
            source_file_paths, features=flat_source,
            **(input_handler_kwargs or {}))

        self.bias_correct_method = bias_correct_method
        self.bias_correct_kwargs = bias_correct_kwargs or {}
        if bias_correct_method is not None:
            from sup3r_tpu_torch.bias.utilities import bias_correct_features

            self.input_handler.data.data = bias_correct_features(
                list(self.bias_correct_kwargs),
                self.input_handler.data.data,
                self.input_handler.data.features,
                self.input_handler.lat_lon,
                self.input_handler.time_index,
                bias_correct_method, self.bias_correct_kwargs)

    def _source_feature(self, feature, idx=None):
        """Source feature name(s) for an output feature: explicit
        ``source_features`` mapping wins, else windspeed_100m output
        comes from u/v_100m source (reference: qa.py:220-282)."""
        if self._explicit_sources and idx is not None:
            return self._explicit_sources[idx]
        if self._explicit_sources and feature in self.features:
            return self._explicit_sources[self.features.index(feature)]
        if feature.startswith('windspeed_'):
            h = feature.split('_')[-1]
            return [f'u_{h}', f'v_{h}']
        if feature.startswith('winddirection_'):
            h = feature.split('_')[-1]
            return [f'u_{h}', f'v_{h}']
        return feature

    def _to_device(self, arr):
        return torch.as_tensor(np.asarray(arr, dtype=np.float32),
                               device=self.device)

    def get_dset_out(self, name):
        """(s1, s2, t) synthetic data for one feature, on the host.

        The spatial grid comes from the OUTPUT file's own meta, not
        source-shape * s_enhance: a per-chunk output file covers a
        subset of the source domain."""
        if self.output_type == 'h5':
            flat = self.output_handler.get(name)  # (t, sites)
            n_sites = flat.shape[1]
            lat = self.output_handler.lat_lon_flat[:, 0]
            s2 = int(np.sum(lat == lat[0])) or 1
            s1 = n_sites // s2
            if s1 * s2 != n_sites:
                raise RuntimeError(
                    f'Output meta of {n_sites} sites does not form a '
                    f'regular grid (inferred {s1}x{s2})')
            return flat.T.reshape(s1, s2, -1)
        return np.asarray(self.output_handler.data[name])

    def coarsen_data(self, data, idx=None):
        """HR (s1, s2, t) -> LR by block mean + temporal reduction, on
        ``device``; returns a tensor there.
        ``temporal_coarsening_method`` may be a per-feature list
        (reference: qa.py:81-86)."""
        method = self.t_method
        if isinstance(method, (list, tuple)):
            method = method[idx or 0]
        if not isinstance(data, torch.Tensor):
            data = self._to_device(data)
        out = spatial_coarsening(data[..., None], self.s_enhance,
                                 obs_axis=False)[..., 0]
        if self.t_enhance > 1:
            out = temporal_coarsening(
                out[None, ..., None], self.t_enhance, method)[0, ..., 0]
        return out

    def get_source_dset(self, feature):
        """(s1, s2, t) source data for one output feature, as a tensor
        on ``device``."""
        source = self._source_feature(feature)
        if isinstance(source, list):
            u = self._to_device(self.input_handler.data[source[0]])
            v = self._to_device(self.input_handler.data[source[1]])
            # ops.wind.invert_uv with the grid angle from the host's
            # numpy code and the rotation on the device
            lat_lon = np.asarray(self.input_handler.lat_lon)
            invert_lat = bool(lat_lon[-1, 0, 0] > lat_lon[0, 0, 0])
            theta = self._to_device(theta_for(lat_lon, invert_lat))
            ws, wd = invert_uv_core(u, v, theta[..., None], invert_lat,
                                    torch_numpy)
            return ws if feature.startswith('windspeed') else wd
        return self._to_device(self.input_handler.data[source])

    def run(self):
        """Compute per-feature error arrays (host float32); optionally
        write qa_fp (with the re-coarsened synthetic + true source data
        too when ``save_sources`` — reference: qa.py:505-510)."""
        errors = {}
        to_write = {}
        for i, feature in enumerate(self.features):
            dset_out = self.output_names[i]
            coarse = self.coarsen_data(self.get_dset_out(feature), i)
            source = self.get_source_dset(feature)
            if coarse.shape != source.shape:
                # hard error like the reference (qa.py:492-501) — a
                # silent min() crop would compare misaligned
                # timestamps and report a meaningless error value
                # (usually a wrong s_enhance/t_enhance)
                raise RuntimeError(
                    f'QA "{feature}": re-coarsened synthetic shape '
                    f'{tuple(coarse.shape)} != source shape '
                    f'{tuple(source.shape)}; check s_enhance/t_enhance '
                    'against the model that produced the output')
            err = (coarse - source).float().cpu().numpy()
            errors[f'{dset_out}_error'] = err
            to_write[f'{dset_out}_error'] = err
            if self.save_sources:
                to_write[f'{dset_out}_synthetic'] = (
                    coarse.float().cpu().numpy())
                to_write[f'{dset_out}_true'] = source.float().cpu().numpy()
            logger.info('QA "%s": mean abs error %.4f', feature,
                        float(np.abs(err).mean()))
        if self.qa_fp is not None:
            self.export(self.qa_fp, to_write)
        return errors

    def export(self, qa_fp, errors):
        """Write error arrays to an h5 file."""
        import h5py

        os.makedirs(os.path.dirname(os.path.abspath(qa_fp)),
                    exist_ok=True)
        with h5py.File(qa_fp, 'w') as f:
            lat_lon = self.input_handler.lat_lon
            f.create_dataset('latitude', data=lat_lon[..., 0])
            f.create_dataset('longitude', data=lat_lon[..., 1])
            for k, v in errors.items():
                f.create_dataset(k, data=v)
        logger.info('Wrote QA file %s', qa_fp)

    def close(self):
        """Close handles."""
        if hasattr(self.output_handler, 'close'):
            self.output_handler.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
