"""Data plane of the port: loaders, rasterizers, derivers and the
``DataHandler`` that feed the forward pass, the exogenous rasters
(``ExoData``, ``ExoDataHandler``, topography, sza and observation
rasterizers), and the training feed (samplers, stats, batch queues, the
``BatchHandler``, the paired ``DualBatchHandler``, the climate-change
``BatchHandlerCC`` over the daily data handlers, the data-centric
``BatchHandlerDC`` and the conditional-moment ``BatchHandlerMom*``), on
numpy and scipy (h5py only for HDF5 input)."""

from sup3r_tpu_torch.preprocessing.batch_handlers import (  # noqa: F401
    BatchHandler,
    BatchHandlerCC,
    BatchHandlerDC,
    BatchHandlerMom1,
    BatchHandlerMom1SF,
    BatchHandlerMom2,
    BatchHandlerMom2Sep,
    BatchHandlerMom2SepSF,
    BatchHandlerMom2SF,
    DualBatchHandler,
)
from sup3r_tpu_torch.preprocessing.batch_queues import (  # noqa: F401
    Batch,
    BatchQueueDC,
    ConditionalBatch,
    ConditionalBatchQueue,
    DualBatchQueue,
    QueueMom1,
    QueueMom1SF,
    QueueMom2,
    QueueMom2Sep,
    QueueMom2SepSF,
    QueueMom2SF,
    RawBatch,
    SingleBatchQueue,
    ValBatchQueueDC,
)
from sup3r_tpu_torch.preprocessing.data_handlers import (  # noqa: F401
    DailyDataHandler,
    DataHandler,
    DataHandlerH5SolarCC,
    DataHandlerH5WindCC,
    DataHandlerNCforCC,
    DataHandlerNCforCCwithPowerLaw,
    get_input_handler_class,
)
from sup3r_tpu_torch.preprocessing.exo import (  # noqa: F401
    ExoData,
    ExoDataHandler,
    ExoRasterizer,
    ObsRasterizer,
    SzaRasterizer,
)
from sup3r_tpu_torch.preprocessing.grid import (  # noqa: F401
    GridDataset,
    PairedDataset,
)
from sup3r_tpu_torch.preprocessing.lazy import (  # noqa: F401
    LazyDailyDataset,
    LazyGridDataset,
)
from sup3r_tpu_torch.preprocessing.loaders import (  # noqa: F401
    Loader,
    LoaderH5,
    LoaderNC,
)
from sup3r_tpu_torch.preprocessing.rasterizers import (  # noqa: F401
    DualRasterizer,
    Rasterizer,
)
from sup3r_tpu_torch.preprocessing.samplers import (  # noqa: F401
    DualSampler,
    DualSamplerCC,
    Sampler,
    SamplerDC,
    nsrdb_reduce_daily_data,
)
from sup3r_tpu_torch.preprocessing.stats import StatsCollection  # noqa
