"""Solar irradiance post-processing (Sup3rCC): GAN clearsky-ratio chunks
and NSRDB clearsky data to GHI / DNI / DHI (the port of
``sup3r_tpu/solar``)."""

from sup3r_tpu_torch.solar.disc import calc_dhi, dark_night, disc  # noqa
from sup3r_tpu_torch.solar.solar import Solar  # noqa: F401
