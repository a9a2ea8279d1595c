"""The port's solar irradiance module (``sup3r_tpu_torch/solar``) against
the JAX package's on the same inputs: ``disc``, ``calc_dhi`` and
``dark_night`` on seeded arrays (rtol 1e-6: the same float64 numpy
arithmetic), and ``Solar`` on fake clearsky-ratio chunk files and a fake
NSRDB file: its irradiance arrays (rtol 1e-6 of each array's largest
magnitude), its grouping of chunk files into temporal triplets, and
``run_temporal_chunks`` split over nodes, the written files equal to the
JAX package's within one storage quantum (1 W/m2) with equal meta and
time_index."""

import os

import h5py
import numpy as np
import pytest

from sup3r_tpu.solar import Solar as JaxSolar
from sup3r_tpu.solar import calc_dhi as jax_calc_dhi
from sup3r_tpu.solar import dark_night as jax_dark_night
from sup3r_tpu.solar import disc as jax_disc
from sup3r_tpu.utilities import RANDOM_GENERATOR as JAX_RNG
from sup3r_tpu.utilities.test_helpers import make_fake_h5_file
from sup3r_tpu_torch.solar import Solar, calc_dhi, dark_night, disc
from tests.solar_qa.test_solar_qa import _make_fake_nsrdb

RTOL = 1e-6


def _close(got, want, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = RTOL * max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol, what


def _irradiance(seed=0, shape=(24, 30)):
    rng = np.random.default_rng(seed)
    ghi = 1000 * rng.random(shape)
    ghi[rng.random(shape) < 0.1] = 0
    sza = 100 * rng.random(shape)
    doy = rng.integers(1, 366, shape[0])
    return ghi, sza, doy, rng


@pytest.mark.parametrize('pressure', ['sea_level', 'pa', 'hpa'])
def test_disc_matches_jax(pressure):
    ghi, sza, doy, rng = _irradiance()
    p = {'sea_level': 101325.0,
         'pa': 80000 + 20000 * rng.random(ghi.shape),
         'hpa': 800 + 200 * rng.random(ghi.shape)}[pressure]
    got = disc(ghi, sza, doy, pressure=p)
    assert got.dtype == np.float32 and (got >= 0).all()
    _close(got, jax_disc(ghi, sza, doy, pressure=p))


def test_calc_dhi_and_dark_night_match_jax():
    ghi, sza, doy, _ = _irradiance(1)
    dni = disc(ghi, sza, doy) * 1.3   # some closures go negative
    got, want = calc_dhi(dni, ghi, sza), jax_calc_dhi(dni, ghi, sza)
    for g, w in zip(got, want):
        _close(g, w)
    dhi, dni_fixed = got
    assert (dhi >= 0).all()
    day = sza < 90
    np.testing.assert_allclose(
        (dhi + dni_fixed * np.cos(np.radians(sza)))[day], ghi[day],
        rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(dark_night(ghi, sza),
                                  jax_dark_night(ghi, sza))
    np.testing.assert_array_equal(dark_night(ghi, sza, 80),
                                  jax_dark_night(ghi, sza, 80))


def _chunks(root, n_t=3, n_s=2, shape=(4, 5)):
    """Fake forward-pass chunk files: one day of hourly clearsky ratio
    per temporal chunk, ``n_s`` spatial chunks."""
    JAX_RNG.bit_generator.state = np.random.default_rng(
        3).bit_generator.state
    os.makedirs(root, exist_ok=True)
    for t in range(n_t):
        for s in range(n_s):
            make_fake_h5_file(
                os.path.join(root, f'sup3r_chunk_{t:06d}_{s:06d}.h5'),
                (*shape, 24), ['clearsky_ratio'],
                start=f'2050-06-0{t + 1}', freq='h', scale_factor=10000.0,
                value_range=(0, 1), lat_range=(40.0, 39.2),
                lon_range=(-105.4, -104.5))
    return os.path.join(root, 'sup3r_chunk_*.h5')


@pytest.fixture(scope='module')
def solar_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp('solar')
    JAX_RNG.bit_generator.state = np.random.default_rng(
        4).bit_generator.state
    nsrdb = _make_fake_nsrdb(str(root / 'nsrdb.h5'), (20, 20, 240),
                             start='2050-06-01')
    return root, nsrdb


def test_get_sup3r_fps_matches_jax(solar_inputs):
    root, _ = solar_inputs
    pattern = _chunks(str(root / 'fps'))
    got = Solar.get_sup3r_fps(pattern)
    want = JaxSolar.get_sup3r_fps(pattern)
    assert got == want
    fp_sets, t_slices = got[0], got[1]
    assert [len(s) for s in fp_sets] == [2, 2, 3, 3, 2, 2]
    assert t_slices[0] == slice(0, 24) and t_slices[2] == slice(24, 48)


@pytest.mark.parametrize('tz, agg_factor', [(-6, 1), (5, 2), (0, 1)])
def test_solar_arrays_match_jax(solar_inputs, tz, agg_factor):
    """The middle chunk of a triplet: the csr rolled by the time zone
    (both wrap directions), the NSRDB neighbours averaged."""
    root, nsrdb = solar_inputs
    pattern = _chunks(str(root / 'arrays'))
    fp_sets, t_slices, _, _, _ = Solar.get_sup3r_fps(pattern)
    kw = dict(t_slice=t_slices[2], tz=tz, agg_factor=agg_factor)
    with Solar(fp_sets[2], nsrdb, **kw) as port, \
            JaxSolar(fp_sets[2], nsrdb, **kw) as jax:
        assert port.nsrdb_tslice == jax.nsrdb_tslice
        np.testing.assert_array_equal(port.out_of_bounds, jax.out_of_bounds)
        for name in ('clearsky_ratio', 'solar_zenith_angle', 'ghi', 'dni',
                     'dhi'):
            got, want = getattr(port, name), getattr(jax, name)
            assert got.shape == (24, 20), name
            _close(got, want, name)
        assert port.ghi.max() > 0


@pytest.mark.parametrize('max_nodes', [1, 2])
def test_run_temporal_chunks_matches_jax(solar_inputs, max_nodes):
    root, nsrdb = solar_inputs
    written = {}
    for name, cls in (('port', Solar), ('jax', JaxSolar)):
        pattern = _chunks(str(root / f'run_{name}_{max_nodes}'))
        written[name] = []
        for node in range(max_nodes):
            written[name] += cls.run_temporal_chunks(
                pattern, nsrdb, tz=-7, max_nodes=max_nodes,
                node_index=node)
    assert [os.path.basename(f) for f in written['port']] == [
        os.path.basename(f) for f in written['jax']]
    assert len(written['port']) == 6
    for fp_port, fp_jax in zip(written['port'], written['jax']):
        with h5py.File(fp_port) as fp, h5py.File(fp_jax) as fj:
            assert set(fp) == set(fj)
            np.testing.assert_array_equal(fp['meta'][:], fj['meta'][:])
            np.testing.assert_array_equal(fp['time_index'][:],
                                          fj['time_index'][:])
            for var in ('ghi', 'dni', 'dhi'):
                got, want = fp[var][:], fj[var][:]
                assert got.dtype == want.dtype
                diff = got.astype(np.int64) - want.astype(np.int64)
                assert np.abs(diff).max() <= 1, var
                np.testing.assert_equal(dict(fp[var].attrs),
                                        dict(fj[var].attrs))
    # a second run skips the files that exist
    assert Solar.run_temporal_chunks(
        os.path.join(os.path.dirname(written['port'][0]),
                     'sup3r_chunk_*.h5'), nsrdb, tz=-7) == []
