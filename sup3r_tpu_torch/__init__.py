"""sup3r_tpu_torch: the PyTorch / CUDA port of ``sup3r_tpu``.

A second package beside the JAX one, ported one slice at a time (see
ROADMAP.md). It serves generators through ``Sup3rGan.load`` /
``Sup3rGan.generate`` in exact fp32, with the JAX package's two Pallas
TPU kernels replaced by CUDA C++ kernels for Hopper (``csrc/``, built at
first use by ``ops/build.py``), runs the chunked forward pass
(``pipeline``: strategy, device-batched dispatch, cropped drain,
NetCDF / H5 writers), and trains ``Sup3rGan`` (``Sup3rGan.train`` over a
``preprocessing.BatchHandler``).

The port imports torch, numpy, scipy and the standard library only
(h5py where an H5 file is read or written).
Entry points run on ``device='cuda'`` unless the caller passes
``device='cpu'``; with no card they raise rather than fall back.
"""

__version__ = '0.1.0'

import os  # noqa: E402

from sup3r_tpu_torch.utilities.utilities import RANDOM_GENERATOR  # noqa: F401,E402

#: the package's architecture configs (``configs.get_config``)
CONFIG_DIR = os.path.join(os.path.dirname(__file__), 'configs')
#: the repo's test data directory, as the JAX package names it
TEST_DATA_DIR = os.path.join(os.path.dirname(__file__), '..', 'tests', 'data')
