"""The port's streaming data plane (``preprocessing/lazy.py``, the lazy
loader variables, ``Rasterizer(lazy=True)``, ``DataHandler(mode='lazy')``
and the lazy daily / CC handlers) on the fixtures of
tests/data_handlers/test_lazy_loading.py, test_lazy_training_plane.py and
test_lazy_cc.py. Each case holds the port's lazy result to its own eager
one as the JAX test holds the JAX package's (bit-exact where that test
demands it), and to the JAX package's lazy result on the same files,
bit-exact for samples; streamed stats at the JAX tests' rtol. Also the
host-RAM budget guard and the rejections, which both packages raise
alike."""

import numpy as np
import pytest

import sup3r_tpu.preprocessing as jp
from sup3r_tpu.preprocessing import data_handlers as jdh
from sup3r_tpu.preprocessing.loaders import LoaderNC as JaxLoaderNC
from sup3r_tpu.utilities.test_helpers import (
    make_fake_h5_file,
    make_fake_nc4_file,
)
from sup3r_tpu_torch.names import Dimension
from sup3r_tpu_torch.ops import spatial_coarsening
from sup3r_tpu_torch.preprocessing import (
    DataHandler,
    DataHandlerH5SolarCC,
    DataHandlerH5WindCC,
    LazyGridDataset,
)
from sup3r_tpu_torch.preprocessing.lazy import _parse_sample_index
from sup3r_tpu_torch.preprocessing.loaders import (
    LoaderNC,
    RawDataset,
    _LazyNCVar,
    _LazyTimeConcat,
    compose_slice,
)
from sup3r_tpu_torch.utilities.times import date_range


def _sample_indices(shape, sample_shape, n, rng):
    """Deterministic random window indices over a (s1, s2, t, f)."""
    out = []
    for _ in range(n):
        r = rng.integers(0, shape[0] - sample_shape[0] + 1)
        c = rng.integers(0, shape[1] - sample_shape[1] + 1)
        t = rng.integers(0, shape[2] - sample_shape[2] + 1)
        out.append((slice(r, r + sample_shape[0]),
                    slice(c, c + sample_shape[1]),
                    slice(t, t + sample_shape[2])))
    return out


def _handlers(path, cls=DataHandler, jax_cls=jp.DataHandler, **kwargs):
    """(port eager, port lazy, JAX lazy) handlers of ``path``."""
    return (cls(path, **kwargs), cls(path, mode='lazy', **kwargs),
            jax_cls(path, mode='lazy', **kwargs))


def _same_times(got, want):
    assert [str(t) for t in np.asarray(got)] == [
        str(t) for t in np.asarray(want, dtype='datetime64[ns]')]


def _hold_samples(eager, lazy, jax, indices):
    for idx in indices:
        got = lazy.sample(idx)
        np.testing.assert_array_equal(got, eager.sample(idx),
                                      err_msg=str(idx))
        np.testing.assert_array_equal(got, jax.sample(idx),
                                      err_msg=str(idx))


# ----------------------------------------------------------------------
# the loaders' lazy variables (test_lazy_loading.py)
def test_lazy_matches_eager_full(tmp_path):
    path = make_fake_nc4_file(str(tmp_path / 'a.nc'), (8, 7, 10),
                              ['u100', 'v100'], scale_factor=1e-4)
    eager = LoaderNC(path).data
    lazy = LoaderNC(path, lazy=True)
    var = lazy.data.data_vars['u_100m']
    assert isinstance(var, _LazyNCVar)
    np.testing.assert_allclose(np.asarray(var), eager['u_100m'],
                               rtol=1e-3, atol=1e-4)
    jax = JaxLoaderNC(path, lazy=True)
    np.testing.assert_array_equal(
        np.asarray(var), np.asarray(jax.data.data_vars['u_100m']))
    lazy.close()
    jax.close()


@pytest.mark.parametrize('ascending', [False, True])
def test_lazy_window_reads(tmp_path, ascending):
    """isel windows read only the slice and match eager and the JAX
    package, including the descending-lat flip applied without
    materializing and strided / reversed time slices."""
    path = make_fake_nc4_file(str(tmp_path / 'a.nc'), (10, 9, 12),
                              ['u100'], ascending_lats=ascending)
    eager = LoaderNC(path).data
    lazy = LoaderNC(path, lazy=True)
    jax = JaxLoaderNC(path, lazy=True)
    s1, s2, t = slice(2, 7), slice(1, 6), slice(3, 9)
    win = lazy.data.isel(s1=s1, s2=s2, t=t)
    np.testing.assert_allclose(win['u_100m'], eager['u_100m'][s1, s2, t],
                               rtol=1e-6)
    np.testing.assert_array_equal(
        win['u_100m'], jax.data.isel(s1=s1, s2=s2, t=t)['u_100m'])
    np.testing.assert_allclose(win.lat_lon, eager.lat_lon[s1, s2])
    var = lazy.data.data_vars['u_100m']
    jvar = jax.data.data_vars['u_100m']
    for tsl in (slice(1, 11, 3), slice(10, 2, -2), slice(None, None, 2)):
        sel = {'south_north': s1, 'west_east': s2, 'time': tsl}
        got = var.isel(sel)
        np.testing.assert_allclose(got, eager['u_100m'][s1, s2, tsl],
                                   rtol=1e-6)
        np.testing.assert_array_equal(got, jvar.isel(sel))
    lazy.close()
    jax.close()


def test_lazy_multifile_time_concat(tmp_path):
    """Sequential files concat lazily; windows across the file boundary
    equal the eager concatenation."""
    p1 = make_fake_nc4_file(str(tmp_path / 'a.nc'), (6, 5, 8), ['u100'],
                            start='2023-01-01')
    p2 = make_fake_nc4_file(str(tmp_path / 'b.nc'), (6, 5, 8), ['u100'],
                            start='2023-01-01 08:00')
    eager = LoaderNC([p1, p2]).data
    lazy = LoaderNC([p1, p2], lazy=True)
    var = lazy.data.data_vars['u_100m']
    assert isinstance(var, _LazyTimeConcat)
    assert var.shape[2] == 16
    win = lazy.data.isel(t=slice(5, 12))
    np.testing.assert_allclose(win['u_100m'], eager['u_100m'][:, :, 5:12],
                               rtol=1e-6)
    assert lazy.data.time_index.equals(eager.time_index)
    jax = JaxLoaderNC([p1, p2], lazy=True)
    np.testing.assert_array_equal(
        win['u_100m'], jax.data.isel(t=slice(5, 12))['u_100m'])
    # files given out of order concatenate sorted (materialized, as in
    # the JAX package)
    rev = LoaderNC([p2, p1], lazy=True)
    assert rev.data.time_index.equals(eager.time_index)
    np.testing.assert_array_equal(rev.data['u_100m'], eager['u_100m'])
    for loader in (lazy, jax, rev):
        loader.close()


@pytest.mark.parametrize('outer,inner,n', [
    (slice(2, 9), slice(1, 4), 10), (slice(None), slice(3, None, 2), 9),
    (slice(8, 1, -2), slice(1, 3), 10), (slice(2, 9, 3), slice(5, 9), 12),
    (slice(5, 1, -1), slice(4, 9), 8)])
def test_compose_slice_is_range_composition(outer, inner, n):
    got = compose_slice(outer, inner, n)
    assert list(range(n)[got]) == list(range(n)[outer][inner])
    from sup3r_tpu.preprocessing.loaders import compose_slice as jax_cs

    assert got == jax_cs(outer, inner, n)


# ----------------------------------------------------------------------
# the training plane (test_lazy_training_plane.py)
def test_lazy_nc_sample_parity(tmp_path):
    """NetCDF4 lazy handler with a level-interpolated feature."""
    sfc = make_fake_nc4_file(str(tmp_path / 'era_sfc.nc'), (12, 11, 30),
                             ['u100', 'v100'], scale_factor=1e-4)
    pl = make_fake_nc4_file(str(tmp_path / 'era_pl.nc'), (12, 11, 30),
                            ['u'], levels=[1000.0, 900.0, 800.0],
                            scale_factor=1e-4)
    feats = ['u_100m', 'v_100m', 'windspeed_100m', 'u_900pa']
    eager, lazy, jax = _handlers([sfc, pl], features=feats)
    assert isinstance(lazy.data, LazyGridDataset)
    assert lazy.data.shape == eager.data.shape
    assert lazy.data.features == eager.data.features
    np.testing.assert_array_equal(lazy.lat_lon, eager.lat_lon)
    assert lazy.time_index.equals(eager.time_index)
    rng = np.random.default_rng(0)
    _hold_samples(eager.data, lazy.data, jax.data, [
        (*w, feats) for w in _sample_indices(eager.data.shape, (5, 4, 6),
                                             8, rng)])


@pytest.mark.parametrize('multifile', [False, True])
def test_lazy_h5_sample_parity(tmp_path, multifile):
    """Flattened H5: gid-window reads and windowed wind rotation (with
    its halo rows) and topography, at the edges too; with two member
    files given out of order, windows straddle the boundary."""
    kw = dict(value_range=(0, 300))
    wind = ['windspeed_100m', 'winddirection_100m']
    if multifile:
        path = [make_fake_h5_file(str(tmp_path / 'a_feb.h5'), (10, 9, 12),
                                  wind, start='2023-02-01', **kw),
                make_fake_h5_file(str(tmp_path / 'b_jan.h5'), (10, 9, 12),
                                  wind, start='2023-01-01', **kw)]
        feats = ['u_100m', 'v_100m']
        windows = [(slice(2, 8), slice(1, 7), t) for t in (
            slice(0, 6), slice(9, 15), slice(18, 24))]
    else:
        path = make_fake_h5_file(str(tmp_path / 'wtk.h5'), (14, 13, 24),
                                 wind, **kw)
        feats = ['u_100m', 'v_100m', 'topography']
        windows = _sample_indices((14, 13, 24), (6, 5, 8), 8,
                                  np.random.default_rng(1))
        windows += [(slice(0, 6), slice(0, 5), slice(0, 8)),
                    (slice(8, 14), slice(8, 13), slice(16, 24))]
    eager, lazy, jax = _handlers(path, features=feats)
    assert lazy.data.shape == eager.data.shape
    _hold_samples(eager.data, lazy.data, jax.data,
                  [(*w, feats) for w in windows])


@pytest.mark.parametrize('feats', [['u_100m'], ['u_100m', 'sza']])
def test_lazy_time_slice_and_shift(tmp_path, feats):
    """time_slice with time_shift: the labels shift, and time-dependent
    derivations (sza) stay on the raw file clock as the eager path's do."""
    path = make_fake_nc4_file(str(tmp_path / 'a.nc'), (8, 8, 20),
                              ['u100'])
    eager, lazy, jax = _handlers(path, features=feats,
                                 time_slice=slice(4, 16), time_shift=-30)
    assert lazy.time_index.equals(eager.time_index)
    _same_times(lazy.time_index, jax.time_index)
    _hold_samples(eager.data, lazy.data, jax.data,
                  [(slice(1, 7), slice(2, 8), slice(3, 9), feats)])


def test_lazy_streaming_stats_and_normalize(tmp_path):
    """Streamed feature_nanstats over several blocks give the eager
    stats (the JAX test's rtol) and the JAX package's; normalized
    windows match the eager normalized block."""
    path = make_fake_h5_file(
        str(tmp_path / 'wtk.h5'), (10, 10, 50),
        ['windspeed_100m', 'winddirection_100m'], value_range=(0, 300))
    feats = ['u_100m', 'v_100m']
    eager, lazy, jax = _handlers(path, features=feats)
    lazy.data._stats_block_elems = 10 * 10 * 7
    jax.data._stats_block_elems = 10 * 10 * 7
    for f in feats:
        mean, var = lazy.data.feature_nanstats(f)
        assert np.isclose(mean, np.nanmean(eager.data[f]), rtol=1e-5)
        assert np.isclose(var, np.nanvar(eager.data[f]), rtol=1e-4)
        assert (mean, var) == jax.data.feature_nanstats(f)
    means = {f: float(np.nanmean(eager.data[f])) for f in feats}
    stds = {f: float(np.nanstd(eager.data[f])) for f in feats}
    for h in (eager, lazy, jax):
        h.data.normalize(means, stds)
    _hold_samples(eager.data, lazy.data, jax.data,
                  [(slice(2, 8), slice(3, 9), slice(10, 20), feats)])


def test_lazy_stats_large_offset_precision():
    """Shifted accumulation keeps two-pass accuracy at mean ~1e5, std
    ~0.01, where a raw one-pass E[x^2] - mean^2 loses ~15%."""
    rng = np.random.default_rng(7)
    vals = (1e5 + 0.01 * rng.standard_normal((4, 4, 500))).astype(
        np.float32)
    lat_lon = np.dstack(np.meshgrid(
        np.linspace(40, 39, 4), np.linspace(-105, -104, 4),
        indexing='ij')).astype(np.float32)
    dims = {'u_100m': (Dimension.SOUTH_NORTH, Dimension.WEST_EAST,
                       Dimension.TIME)}
    ti = date_range('2023-01-01', '2023-01-21 19:00',
                    np.timedelta64(1, 'h'))
    assert len(ti) == 500
    ds = LazyGridDataset(RawDataset({'u_100m': vals}, dims, lat_lon,
                                    time_index=ti),
                         ['u_100m'], stats_block_elems=800)
    mean, var = ds.feature_nanstats('u_100m')
    v64 = vals.astype(np.float64)
    np.testing.assert_allclose(mean, np.nanmean(v64), rtol=1e-9)
    np.testing.assert_allclose(var, np.nanvar(v64), rtol=1e-6)


def test_stats_collection_streams_lazy_handlers(tmp_path):
    """StatsCollection over a lazy handler streams its stats and gives
    the eager handler's means / stds (the JAX test's rtol)."""
    from sup3r_tpu_torch.preprocessing.stats import (
        StatsCollection,
        unwrap_container,
    )

    path = make_fake_h5_file(
        str(tmp_path / 'wtk.h5'), (10, 10, 30),
        ['windspeed_100m', 'winddirection_100m'], value_range=(0, 300))
    feats = ['u_100m', 'v_100m']
    eager, lazy, _ = _handlers(path, features=feats)
    assert unwrap_container(lazy) is lazy.data
    got = StatsCollection([lazy])
    want = StatsCollection([eager])
    for f in feats:
        np.testing.assert_allclose(got.means[f], want.means[f], rtol=1e-5)
        np.testing.assert_allclose(got.stds[f], want.stds[f], rtol=1e-4)


@pytest.mark.parametrize('idx', [
    (slice(2, 8), slice(1, 7), slice(0, 8), 1),
    (3, slice(1, 7), slice(0, 8), 'feats'),
    (slice(2, 8), 4, slice(0, 8), 'feats'),
    (slice(2, 8), slice(1, 7), 5, 'feats'),
    (slice(1, 11, 2), slice(0, 9, 3), slice(0, 16, 4), 'feats'),
    (slice(2, 9, 3), slice(1, 7), slice(0, 8), 1),
    (slice(2, 5), 3, slice(0, 5), [1, 0]),
    (slice(2, 5), 3, slice(0, 5), np.array([1, 0])),
    (2, 3, slice(0, 5), [0, 1]),
    (slice(2, 5), slice(1, 4), 5, slice(0, 2)),
    (slice(2, 5), 3, slice(0, 5), [1, 1]),
    (slice(0, 1), slice(0, 7), slice(0, 5), 'feats'),
    (0, slice(0, 7), slice(0, 5), 'feats'),
    (slice(11, 12), slice(0, 7), slice(0, 5), 'feats'),
], ids=lambda x: str(x).replace(' ', ''))
def test_lazy_sample_numpy_semantics(tmp_path, idx):
    """sample() follows numpy's indexing as GridDataset's does: integer
    squeezing, slice steps (strided rows derive on the contiguous span),
    mixed basic / advanced indexing, duplicate features and single-row
    windows at row 0 and the last row (wind rotation's halo)."""
    path = make_fake_h5_file(
        str(tmp_path / 'wtk.h5'), (12, 10, 16),
        ['windspeed_100m', 'winddirection_100m'], value_range=(0, 300))
    feats = ['u_100m', 'v_100m']
    eager, lazy, jax = _handlers(path, features=feats)
    idx = tuple(feats if isinstance(i, str) else i for i in idx)
    want = eager.data.sample(idx)
    got = lazy.data.sample(idx)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax.data.sample(idx))
    from sup3r_tpu.preprocessing.lazy import _parse_sample_index as jax_p

    for a, b in zip(_parse_sample_index(idx, feats, lazy.data.shape),
                    jax_p(idx, feats, lazy.data.shape)):
        assert str(a) == str(b)


def test_ram_budget_guard(tmp_path, monkeypatch):
    """Eager loads over SUP3R_TPU_HOST_RAM_GB raise pointing at
    mode='lazy' (NetCDF and H5, one variable and the cumulative load
    across variables and member files); lazy handlers pass under the same
    budget."""
    nc = make_fake_nc4_file(str(tmp_path / 'a.nc'), (16, 16, 64),
                            ['u100', 'v100', 'u10', 'v10'])
    h5 = make_fake_h5_file(str(tmp_path / 'b.h5'), (16, 16, 64),
                           ['windspeed_100m', 'winddirection_100m'],
                           value_range=(0, 300))
    members = [make_fake_nc4_file(str(tmp_path / f'm{i}.nc'), (16, 16, 32),
                                  ['u100'], start=f'2023-0{i + 1}-01')
               for i in range(4)]
    monkeypatch.setenv('SUP3R_TPU_HOST_RAM_GB', '0.00003')
    with pytest.raises(MemoryError, match="mode='lazy'"):
        DataHandler(nc, features=['u_100m'])
    with pytest.raises(MemoryError, match="mode='lazy'"):
        DataHandler(h5, features=['u_100m'])
    s = DataHandler(nc, features=['u_100m'], mode='lazy').data.sample(
        (slice(0, 4), slice(0, 4), slice(0, 4), ['u_100m']))
    assert s.shape == (4, 4, 4, 1)
    s = DataHandler(h5, features=['u_100m'], mode='lazy').data.sample(
        (slice(4, 8), slice(4, 8), slice(8, 16), ['u_100m']))
    assert s.shape == (4, 4, 8, 1)
    # 200 KiB passes any one 64 KiB variable but not four of them
    monkeypatch.setenv('SUP3R_TPU_HOST_RAM_GB', str(200 / 1024 / 1024))
    four = ['u_100m', 'v_100m', 'u_10m', 'v_10m']
    with pytest.raises(MemoryError, match="mode='lazy'"):
        DataHandler(nc, features=four)
    assert DataHandler(nc, features=four, mode='lazy').data.sample(
        (slice(0, 4), slice(0, 4), slice(0, 4), ['u_100m', 'v_10m'])
    ).shape == (4, 4, 4, 2)
    # one 32.8 kB member fits a 0.00006 GB budget, four do not
    monkeypatch.setenv('SUP3R_TPU_HOST_RAM_GB', '0.00006')
    LoaderNC(members[0])
    with pytest.raises(MemoryError, match="mode='lazy'"):
        LoaderNC(members)


@pytest.mark.parametrize('kwargs,error,match', [
    ({'time_roll': 3}, NotImplementedError, 'time_roll'),
    ({'hr_spatial_coarsen': 2}, NotImplementedError, 'hr_spatial_coarsen'),
    ({'cache_kwargs': {'cache_pattern': 'c_{feature}.h5'}},
     NotImplementedError, 'cache_kwargs'),
    ({'mode': 'nope'}, ValueError, 'eager.*lazy'),
    ({'nan_method_kwargs': {'method': 'mask'}}, NotImplementedError,
     'nearest'),
])
def test_lazy_rejects_unsupported(tmp_path, kwargs, error, match):
    """Full-domain remaps fail loudly in both packages."""
    path = make_fake_nc4_file(str(tmp_path / 'a.nc'), (8, 8, 10),
                              ['u100'])
    kwargs = {'mode': 'lazy', **kwargs}
    for cls in (DataHandler, jp.DataHandler):
        with pytest.raises(error, match=match):
            cls(path, features=['u_100m'], **kwargs)


def test_lazy_rejects_nonlocal_and_accepts_identity_kwargs(tmp_path):
    """The night-mask clearsky_ratio cannot be windowed in a plain
    handler; identity values of the refused options pass."""
    solar = make_fake_h5_file(
        str(tmp_path / 'nsrdb.h5'), (8, 8, 48), ['ghi', 'clearsky_ghi'],
        freq='h', value_range=(0, 600))
    with pytest.raises(NotImplementedError, match='non-local'):
        DataHandler(solar, features=['clearsky_ratio'], mode='lazy')
    nc = make_fake_nc4_file(str(tmp_path / 'era.nc'), (6, 6, 10), ['u100'])
    dh = DataHandler(nc, features=['u_100m'], mode='lazy',
                     cache_kwargs={}, time_roll=0, hr_spatial_coarsen=1)
    assert dh.data.sample(
        (slice(0, 3), slice(0, 3), slice(0, 4), ['u_100m'])
    ).shape == (3, 3, 4, 1)
    with pytest.raises(NotImplementedError, match='negative'):
        dh.data.sample((slice(4, 1, -1), slice(0, 3), slice(0, 4),
                        ['u_100m']))


# ----------------------------------------------------------------------
# the daily / CC handlers (test_lazy_cc.py)
WIND_FEATS = ['temperature_2m', 'temperature_max_2m', 'temperature_min_2m']
SOLAR_FEATS = ['clearsky_ratio', 'ghi', 'clearsky_ghi']


def _windows(shape, n_days):
    s1, s2 = shape[:2]
    return [(slice(0, s1), slice(0, s2), slice(0, n_days)),
            (slice(1, s1 - 1), slice(2, s2), slice(1, n_days)),
            (slice(s1 - 3, s1), slice(0, 3), slice(n_days - 1, n_days))]


def _hold_daily(eager, lazy, jax, feats, hidx):
    assert lazy.daily.shape == eager.daily.shape
    assert lazy.hourly.shape == eager.hourly.shape
    _same_times(lazy.daily.time_index, jax.daily.time_index)
    assert [str(t) for t in np.asarray(lazy.daily.time_index)] == [
        str(t) for t in np.asarray(eager.daily.time_index)]
    _hold_samples(eager.daily, lazy.daily, jax.daily,
                  [(*w, feats) for w in _windows(lazy.daily.shape,
                                                 lazy.daily.shape[2])])
    _hold_samples(eager.hourly, lazy.hourly, jax.hourly, [hidx])


@pytest.mark.parametrize('n_hours', [72, 60])
def test_wind_daily_hourly_bit_parity(tmp_path, n_hours):
    """72 h, and 60 h (2.5 days) trimmed to its 2 leading whole days."""
    fp = make_fake_h5_file(str(tmp_path / 'wtk.h5'), (6, 6, n_hours),
                           ['temperature_2m'], value_range=(-10, 30))
    eager, lazy, jax = _handlers(fp, DataHandlerH5WindCC,
                                 jdh.DataHandlerH5WindCC,
                                 features=WIND_FEATS)
    assert lazy.daily.shape[2] == n_hours // 24
    _hold_daily(eager, lazy, jax, WIND_FEATS,
                (slice(0, 6), slice(1, 5), slice(3, 30), WIND_FEATS))


@pytest.fixture
def solar_file(tmp_path):
    return make_fake_h5_file(
        str(tmp_path / 'nsrdb.h5'), (8, 8, 48), ['ghi', 'clearsky_ghi'],
        start='2023-06-01', freq='h', scale_factor=1.0,
        value_range=(0, 1000))


def test_solar_csr_bit_parity(solar_file):
    """Daily csr from totals and hourly csr through the precomputed
    night-mask table, NaNs included."""
    eager, lazy, jax = _handlers(solar_file, DataHandlerH5SolarCC,
                                 jdh.DataHandlerH5SolarCC,
                                 features=SOLAR_FEATS)
    hidx = (slice(2, 7), slice(0, 8), slice(0, 48), SOLAR_FEATS)
    _hold_daily(eager, lazy, jax, SOLAR_FEATS, hidx)
    assert np.isnan(lazy.hourly.sample(hidx)[..., 0]).any()


def test_solar_coarse_view_bit_parity(solar_file):
    """The lazy coarse daily view equals coarsening the normalized eager
    daily array (normalize, then coarsen)."""
    eager, lazy, jax = _handlers(solar_file, DataHandlerH5SolarCC,
                                 jdh.DataHandlerH5SolarCC,
                                 features=SOLAR_FEATS)
    means = {f: 0.3 for f in SOLAR_FEATS}
    stds = {f: 0.7 for f in SOLAR_FEATS}
    for h in (eager, lazy, jax):
        h.daily.normalize(means, stds)
    coarse = lazy.daily.coarsen(2)
    full = spatial_coarsening(np.asarray(eager.daily.data), 2,
                              obs_axis=False)
    idx = (slice(0, 4), slice(1, 3), slice(0, 2), SOLAR_FEATS)
    np.testing.assert_array_equal(full[idx[0], idx[1], idx[2]],
                                  coarse.sample(idx))
    np.testing.assert_array_equal(coarse.sample(idx),
                                  jax.daily.coarsen(2).sample(idx))
    np.testing.assert_array_equal(
        coarse.lat_lon, spatial_coarsening(eager.daily.lat_lon, 2,
                                           obs_axis=False))


def test_solar_helper_channels_not_exposed(solar_file):
    """Requesting only clearsky_ratio: the lazy members carry only it."""
    feats = ['clearsky_ratio']
    eager, lazy, jax = _handlers(solar_file, DataHandlerH5SolarCC,
                                 jdh.DataHandlerH5SolarCC, features=feats)
    assert lazy.daily.features == eager.daily.features == feats
    assert lazy.hourly.features == feats
    idx = (slice(0, 6), slice(0, 6), slice(0, 2), feats)
    _hold_samples(eager.daily, lazy.daily, jax.daily, [idx])


def test_lazy_cc_batches_match_eager(solar_file):
    """A BatchHandlerCC over lazy SolarCC handlers (DualSamplerCC takes
    the lazy coarse view) produces the eager handler's batches on the
    same seed."""
    from sup3r_tpu_torch.preprocessing import DualSamplerCC
    from sup3r_tpu_torch.utilities import RANDOM_GENERATOR

    eager = DataHandlerH5SolarCC(solar_file, features=SOLAR_FEATS)
    lazy = DataHandlerH5SolarCC(solar_file, features=SOLAR_FEATS,
                                mode='lazy')
    out = []
    for h in (eager, lazy):
        sampler = DualSamplerCC(h.data, (4, 4, 24), s_enhance=2,
                                t_enhance=24,
                                feature_sets={'lr_only_features': [
                                    'ghi', 'clearsky_ghi']})
        RANDOM_GENERATOR.bit_generator.state = np.random.default_rng(
            3).bit_generator.state
        out.append([sampler.get_sample_index() for _ in range(2)])
        out[-1] = [(sampler.lr_data.sample(i), sampler.hr_data.sample(j))
                   for i, j in out[-1]]
    for (a_lr, a_hr), (b_lr, b_hr) in zip(*out):
        np.testing.assert_array_equal(b_lr, a_lr)
        np.testing.assert_array_equal(b_hr, a_hr)


def test_daily_lazy_still_rejects_full_domain_remaps(tmp_path):
    fp = make_fake_h5_file(str(tmp_path / 'wtk.h5'), (4, 4, 48),
                           ['temperature_2m'], value_range=(-10, 30))
    for cls in (DataHandlerH5WindCC, jdh.DataHandlerH5WindCC):
        with pytest.raises(NotImplementedError, match='time_roll'):
            cls(fp, features=['temperature_2m'], mode='lazy', time_roll=2)
