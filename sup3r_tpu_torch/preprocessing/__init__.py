"""Data plane of the port: loaders, rasterizers, derivers and the
``DataHandler`` that feed the forward pass, on numpy and scipy (h5py
only for HDF5 input)."""

from sup3r_tpu_torch.preprocessing.data_handlers import (  # noqa: F401
    DataHandler,
    get_input_handler_class,
)
from sup3r_tpu_torch.preprocessing.grid import GridDataset  # noqa: F401
from sup3r_tpu_torch.preprocessing.loaders import (  # noqa: F401
    Loader,
    LoaderH5,
    LoaderNC,
)
from sup3r_tpu_torch.preprocessing.rasterizers import Rasterizer  # noqa
