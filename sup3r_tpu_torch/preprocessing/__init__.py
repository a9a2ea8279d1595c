"""Data plane of the port: loaders, rasterizers, derivers and the
``DataHandler`` that feed the forward pass, and the training feed
(samplers, stats, batch queues and the ``BatchHandler``), on numpy and
scipy (h5py only for HDF5 input)."""

from sup3r_tpu_torch.preprocessing.batch_handlers import (  # noqa: F401
    BatchHandler,
)
from sup3r_tpu_torch.preprocessing.batch_queues import (  # noqa: F401
    Batch,
    RawBatch,
    SingleBatchQueue,
)

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
from sup3r_tpu_torch.preprocessing.samplers import Sampler  # noqa: F401
from sup3r_tpu_torch.preprocessing.stats import StatsCollection  # noqa
