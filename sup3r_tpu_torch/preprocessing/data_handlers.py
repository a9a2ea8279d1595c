"""DataHandler: Loader -> Rasterizer -> Deriver composition.

Reference parity: sup3r/preprocessing/data_handlers/base.py:46
(DataHandler). The port's copy of the eager ``DataHandler`` of
``sup3r_tpu/preprocessing/data_handlers.py``. The daily and
climate-change handler variants, ``mode='lazy'`` and feature caching
come with later slices of the port and raise ``NotImplementedError``
here.
"""

import logging

from sup3r_tpu_torch.preprocessing.derivers import Deriver, RegistryBase
from sup3r_tpu_torch.preprocessing.rasterizers import Rasterizer

logger = logging.getLogger(__name__)

#: handler names of the JAX package that later slices of the port bring
_LATER_HANDLERS = ('DailyDataHandler', 'DataHandlerH5WindCC',
                   'DataHandlerH5SolarCC', 'DataHandlerNCforCC',
                   'DataHandlerNCforCCwithPowerLaw')


class DataHandler:
    """Load + rasterize + derive features for one spatiotemporal extent.

    ``.data`` is the derived GridDataset."""

    FEATURE_REGISTRY = RegistryBase

    def __init__(self, file_paths, features='all', target=None,
                 shape=None, time_slice=slice(None), threshold=None,
                 raster_file=None, time_roll=0, time_shift=None,
                 hr_spatial_coarsen=1, nan_method_kwargs=None,
                 interp_kwargs=None, cache_kwargs=None, res_kwargs=None,
                 FeatureRegistry=None, window=None, mode='eager'):
        self.file_paths = file_paths
        registry = FeatureRegistry or self.FEATURE_REGISTRY
        if mode != 'eager':
            raise NotImplementedError(
                f"DataHandler(mode={mode!r}): mode='lazy' streams through "
                'preprocessing/lazy.py, which comes with a later slice of '
                'the port (ROADMAP queue 1 item 5: chunked_io / lazy.py)')
        if cache_kwargs is not None:
            raise NotImplementedError(
                'DataHandler(cache_kwargs=...): feature caching '
                '(postprocessing/cachers.py) comes with a later slice of '
                'the port (ROADMAP queue 1 item 8)')
        self.rasterizer = Rasterizer(
            file_paths, features='all', target=target, shape=shape,
            time_slice=time_slice, threshold=threshold,
            raster_file=raster_file, res_kwargs=res_kwargs,
            window=window)
        raster_data = self.rasterizer.data
        feats = (raster_data.features if features in ('all', None)
                 else features)
        deriver = Deriver(
            raster_data, feats, time_roll=time_roll,
            time_shift=time_shift, hr_spatial_coarsen=hr_spatial_coarsen,
            nan_method_kwargs=nan_method_kwargs, FeatureRegistry=registry,
            interp_kwargs=interp_kwargs)
        self.data = deriver.data

    @property
    def features(self):
        return self.data.features

    @property
    def shape(self):
        return self.data.shape

    @property
    def lat_lon(self):
        return self.data.lat_lon

    @property
    def time_index(self):
        return self.data.time_index

    def __getitem__(self, key):
        return self.data[key]


def get_input_handler_class(input_handler_name):
    """Resolve a handler class by name (reference:
    sup3r/preprocessing/utilities.py:38)."""
    classes = {'DataHandler': DataHandler, 'Rasterizer': Rasterizer}
    if input_handler_name is None:
        return DataHandler
    if isinstance(input_handler_name, type):
        return input_handler_name
    if input_handler_name in _LATER_HANDLERS:
        raise NotImplementedError(
            f'Input handler "{input_handler_name}" comes with a later '
            'slice of the port (ROADMAP queue 1 item 5: the daily and '
            'climate-change data handlers)')
    if input_handler_name not in classes:
        raise KeyError(
            f'Unknown input handler "{input_handler_name}"; options: '
            f'{sorted(classes)}')
    return classes[input_handler_name]
