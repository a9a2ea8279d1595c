"""Names the JAX package exports at its package and subpackage level that
the port now exports too: ``RANDOM_GENERATOR``, ``CONFIG_DIR`` and
``TEST_DATA_DIR`` at the top, ``models.SPATIAL_FIRST_MODELS``,
``postprocessing.Cacher`` / ``load_cached``, the array ops re-exported
from ``ops``, ``utilities.load_reference_gan`` and
``OutputHandler.write_output``. Each is held to its JAX counterpart on
the same numpy inputs (bit-equal draws, ops at rtol 1e-6, the written
file's variables within 1e-4 of their largest magnitude)."""

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.io import netcdf_file

import sup3r_tpu
import sup3r_tpu.ops as jax_ops
import sup3r_tpu_torch
import sup3r_tpu_torch.ops as ops
from sup3r_tpu.postprocessing.writers import OutputHandlerNC as JaxNC
from sup3r_tpu.utilities import load_reference_gan as jax_load_reference
from sup3r_tpu_torch.postprocessing.writers import OutputHandlerNC
from sup3r_tpu_torch.utilities import load_reference_gan
from sup3r_tpu_torch.utilities.port import export_reference_gan
from tests.models.test_port_reference import (  # noqa: F401
    source_model,
)

torch.set_num_threads(1)


def test_random_generator_at_the_package_top():
    from sup3r_tpu_torch.utilities import RANDOM_GENERATOR

    assert sup3r_tpu_torch.RANDOM_GENERATOR is RANDOM_GENERATOR
    for rng in (sup3r_tpu_torch.RANDOM_GENERATOR, sup3r_tpu.RANDOM_GENERATOR):
        rng.bit_generator.state = np.random.default_rng(
            4).bit_generator.state
    np.testing.assert_array_equal(sup3r_tpu_torch.RANDOM_GENERATOR.random(5),
                                  sup3r_tpu.RANDOM_GENERATOR.random(5))


@pytest.mark.parametrize('module', ['', 'models', 'postprocessing'])
def test_package_level_names_match_jax(module):
    """The package top, ``models`` and ``postprocessing`` export every
    public name their JAX counterparts export: ``CONFIG_DIR`` and
    ``TEST_DATA_DIR`` (the same layout under each package),
    ``SPATIAL_FIRST_MODELS`` (the port's chain classes of the same
    names), and ``Cacher`` / ``load_cached`` (the cachers module's)."""
    import importlib
    import os

    suffix = f'.{module}' if module else ''
    jax_mod = importlib.import_module(f'sup3r_tpu{suffix}')
    port_mod = importlib.import_module(f'sup3r_tpu_torch{suffix}')
    names = {n for n in dir(jax_mod) if not n.startswith('_')
             and not isinstance(getattr(jax_mod, n), type(os))}
    missing = {n for n in names if not hasattr(port_mod, n)}
    assert not missing, missing
    if not module:
        for name in ('CONFIG_DIR', 'TEST_DATA_DIR'):
            want = os.path.relpath(getattr(jax_mod, name),
                                   os.path.dirname(jax_mod.__file__))
            got = os.path.relpath(getattr(port_mod, name),
                                  os.path.dirname(port_mod.__file__))
            assert got == want, name
        assert os.path.isdir(port_mod.CONFIG_DIR)
    elif module == 'models':
        assert [c.__name__ for c in port_mod.SPATIAL_FIRST_MODELS] == [
            c.__name__ for c in jax_mod.SPATIAL_FIRST_MODELS]
        assert all(c.__module__.startswith('sup3r_tpu_torch.')
                   for c in port_mod.SPATIAL_FIRST_MODELS)
    else:
        from sup3r_tpu_torch.postprocessing import cachers

        assert port_mod.Cacher is cachers.Cacher
        assert port_mod.load_cached is cachers.load_cached


def _ops_cases():
    rng = np.random.default_rng(0)
    x5 = rng.random((2, 8, 8, 6, 3)).astype(np.float32)
    x4 = rng.random((8, 8, 6, 2)).astype(np.float32)
    lat_lon = np.dstack(np.meshgrid(np.linspace(40, 39, 8),
                                    np.linspace(-105, -104, 8),
                                    indexing='ij')).astype(np.float32)
    ws = 10 * rng.random((8, 8, 6)).astype(np.float32)
    wd = 360 * rng.random((8, 8, 6)).astype(np.float32)
    return [
        ('spatial_coarsening', (x5,), {'s_enhance': 2}),
        ('temporal_coarsening', (x5,), {'t_enhance': 3,
                                         'method': 'average'}),
        ('spatial_simple_enhancing', (x5,), {'s_enhance': 2}),
        ('temporal_simple_enhancing', (x5,), {'t_enhance': 2}),
        ('smooth_data', (x5, ['a', 'b', 'c'], ['c'], 0.6), {}),
        ('st_interp', (x4[..., 0],), {'s_enhance': 2, 't_enhance': 2}),
        ('transform_rotate_wind', (ws, wd, lat_lon), {}),
        ('invert_uv', (ws, wd - 180, lat_lon), {}),
    ]


@pytest.mark.parametrize('name,args,kwargs', _ops_cases(),
                         ids=[c[0] for c in _ops_cases()])
def test_ops_reexports_match_jax(name, args, kwargs):
    assert name in dir(ops)
    got = getattr(ops, name)(*args, **kwargs)
    want = getattr(jax_ops, name)(*args, **kwargs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6,
                                   atol=1e-5)


def test_load_reference_gan_from_utilities(source_model, tmp_path):  # noqa
    """``utilities.load_reference_gan`` is the reference importer of
    ``utilities.port``: a reference checkpoint serves the JAX package's
    output."""
    from sup3r_tpu_torch.models import Sup3rGan

    source_model.save(str(tmp_path / 'jax'))
    d = str(tmp_path / 'ref')
    export_reference_gan(Sup3rGan.load(str(tmp_path / 'jax'), device='cpu'),
                         d)
    model = load_reference_gan(d, lr_shape=(1, 8, 8, 2), device='cpu')
    jmodel = jax_load_reference(d, lr_shape=(1, 8, 8, 2))
    lr = np.random.default_rng(2).random((1, 8, 8, 2)).astype(np.float32)
    want = np.asarray(jmodel.generate(lr))
    got = model.generate(lr)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_write_output_matches_jax(tmp_path):
    """``write_output`` synthesizes the HR coordinates and times from
    the LR ones and writes: the NetCDF file equals the JAX package's."""
    rng = np.random.default_rng(3)
    data = rng.normal(0, 6, (6, 6, 8, 2)).astype(np.float32)
    lr_ll = np.dstack(np.meshgrid(np.linspace(40, 39, 3),
                                  np.linspace(-105.5, -104.3, 3),
                                  indexing='ij'))
    lr_times = pd.date_range('2023-01-01', periods=2, freq='4h')
    feats = ['u_100m', 'v_100m']
    OutputHandlerNC.write_output(data, feats, lr_ll, lr_times,
                                 str(tmp_path / 'port.nc'))
    JaxNC.write_output(data, feats, lr_ll, lr_times,
                       str(tmp_path / 'jax.nc'))
    with netcdf_file(str(tmp_path / 'port.nc'), 'r', mmap=False) as fp, \
            netcdf_file(str(tmp_path / 'jax.nc'), 'r', mmap=False) as fj:
        assert set(fp.variables) == set(fj.variables)
        for var in fj.variables:
            want = np.asarray(fj.variables[var].data, np.float64)
            got = np.asarray(fp.variables[var].data, np.float64)
            assert got.shape == want.shape, var
            assert np.abs(got - want).max() <= 1e-4 * max(
                np.abs(want).max(), 1e-30), var


BIAS_MODULES = ('base', 'bias_calc', 'bias_calc_vortex', 'presrat', 'qdm',
                'qdm_math', 'transforms', 'utilities')


@pytest.mark.parametrize('module', ('',) + BIAS_MODULES)
def test_bias_exports_match_jax(module):
    """``sup3r_tpu_torch.bias`` exports every public name of
    ``sup3r_tpu.bias``, and each of its modules every function and class
    its JAX counterpart defines (with their public methods)."""
    import importlib

    def public(mod, own):
        return {n for n in dir(mod) if not n.startswith('_') and (
            not own or getattr(getattr(mod, n), '__module__', None)
            == mod.__name__)}

    suffix = f'.{module}' if module else ''
    jax_mod = importlib.import_module(f'sup3r_tpu.bias{suffix}')
    port_mod = importlib.import_module(f'sup3r_tpu_torch.bias{suffix}')
    names = public(jax_mod, own=bool(module))
    assert names and names <= public(port_mod, own=False)
    if not module:
        assert names == public(port_mod, own=False)
    for name in names:
        want = getattr(jax_mod, name)
        if isinstance(want, type):
            got = getattr(port_mod, name)
            assert public(want, False) <= public(got, False), name


SLICE_MODULES = ('utilities.cli', 'postprocessing.collectors',
                 'postprocessing.cachers', 'qa', 'qa.qa', 'qa.utilities',
                 'utilities.flops', 'utilities.era_downloader')


@pytest.mark.parametrize('module', SLICE_MODULES)
def test_pipeline_slice_exports_match_jax(module):
    """Each module of the production-pipeline slice defines every public
    function, class (with its public methods) and constant that its JAX
    counterpart defines."""
    import importlib

    jax_mod = importlib.import_module(f'sup3r_tpu.{module}')
    port_mod = importlib.import_module(f'sup3r_tpu_torch.{module}')

    def public(mod):
        return {n for n in dir(mod) if not n.startswith('_') and (
            getattr(getattr(mod, n), '__module__', None) == mod.__name__
            or (n.isupper() and isinstance(getattr(mod, n),
                                           (int, float, str, tuple))))}

    names = public(jax_mod) | set(getattr(jax_mod, '__all__', ()))
    if module == 'qa':
        names.add('Sup3rQa')
    assert names
    for name in names:
        assert hasattr(port_mod, name), name
        want, got = getattr(jax_mod, name), getattr(port_mod, name)
        if isinstance(want, type):
            assert ({n for n in dir(want) if not n.startswith('_')}
                    <= {n for n in dir(got) if not n.startswith('_')}), name
        elif not callable(want):
            assert got == want, name


def test_cli_commands_and_options_match_jax():
    """The port's argparse CLI has the JAX click group's commands, each
    with the same options (``import-model --device`` is the port's
    own: the device a model is built on)."""
    import argparse

    from sup3r_tpu.cli import main as jax_main
    from sup3r_tpu_torch import cli

    def click_opts(cmd):
        return {o for p in cmd.params for o in getattr(p, 'opts', ())
                if o.startswith('-') and o != '--help'}

    parser = cli.build_parser()
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    assert set(sub.choices) == set(jax_main.commands)
    for name, cmd in jax_main.commands.items():
        opts = {o for a in sub.choices[name]._actions
                for o in a.option_strings if o not in ('-h', '--help')}
        assert opts - {'--device'} == click_opts(cmd), name
        assert hasattr(cli, name.replace('-', '_')), name
    top = {o for a in parser._actions for o in a.option_strings}
    assert click_opts(jax_main) - {'--version'} <= top


def test_parallel_exports_match_jax():
    """``sup3r_tpu_torch.parallel`` exports ``sup3r_tpu.parallel``'s names,
    and its ``mesh`` module defines every function the JAX module
    defines, each taking the JAX function's arguments (with the port's
    meaning: a rank is a host with one device). The byte readers take the
    mesh whose counters they read where the JAX ones take a compiled
    program."""
    import importlib
    import inspect

    for suffix in ('', '.mesh'):
        jax_mod = importlib.import_module(f'sup3r_tpu.parallel{suffix}')
        port_mod = importlib.import_module(
            f'sup3r_tpu_torch.parallel{suffix}')
        names = {n for n in dir(jax_mod) if not n.startswith('_') and (
            not inspect.ismodule(getattr(jax_mod, n))) and (
            not suffix or getattr(getattr(jax_mod, n), '__module__', None)
            == jax_mod.__name__)}
        assert names
        for name in names:
            got = getattr(port_mod, name)
            want = getattr(jax_mod, name)
            if name.endswith('_from_compiled'):
                assert list(inspect.signature(got).parameters) == ['mesh']
                continue
            assert (list(inspect.signature(got).parameters)[
                :len(inspect.signature(want).parameters)]
                == list(inspect.signature(want).parameters)), name
        if not suffix:
            assert names == {n for n in dir(port_mod)
                             if not n.startswith('_')} - {'mesh'}
