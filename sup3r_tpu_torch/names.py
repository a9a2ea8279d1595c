"""Feature-name helpers the serving path reaches (the port's subset of
``sup3r_tpu/names.py``)."""


def strip_obs_suffix(feature):
    """Base feature name of an ``*_obs`` observation feature — strips
    the SUFFIX only (``str.replace`` would also eat an interior
    ``'_obs'`` in the base name, e.g. ``'u_obstacle_10m_obs'``)."""
    return feature[:-4] if feature.endswith('_obs') else feature
