"""ERA5 acquisition + preprocessing via the CDS API.

Reference parity: sup3r/utilities/era_downloader.py:44-937. The full
request-building and monthly/yearly orchestration logic is implemented
here as pure host-side Python; the network client is injectable (any
object with ``.retrieve(dataset, entry, out_file)``) so everything is
testable without egress. Without an injected client the module gates
on the ``cdsapi`` package + ``~/.cdsapirc`` credentials. The port's
copy of ``sup3r_tpu/utilities/era_downloader.py`` on the pandas-free
``TimeIndex``. Its files are NetCDF4-style HDF5 (``write_nc4``), so
processing runs where h5py is installed.
"""

import calendar
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from warnings import warn

import numpy as np

from sup3r_tpu_torch.names import LEVEL_VARS, SFC_VARS
from sup3r_tpu_torch.utilities.times import (
    TimeIndex,
    format_timestamps,
    seconds_since,
    to_datetime64,
)

logger = logging.getLogger(__name__)

#: standard gravity used for geopotential -> height (m)
G0 = 9.80665


def geopotential_to_height(zg):
    """Convert geopotential (m2/s2) to geopotential height (m)."""
    return np.asarray(zg) / G0


def build_cds_request(variables, year, month, area, *, days=None,
                      hours=None, levels=None, level_type='single',
                      product_type='reanalysis'):
    """Build a (dataset_name, request_entry) pair for the CDS API.

    Pure function so request construction is testable offline
    (reference: era_downloader.py:303-371).

    Parameters
    ----------
    variables : list
        Long-form CDS variable names (e.g. '100m_u_component_of_wind').
    year, month : int
    area : list
        [max_lat, min_lon, min_lat, max_lon] bounding box.
    days : list | None
        Days of month (ints or strings). Omitted for monthly products.
    hours : list | None
        'HH:00' strings; defaults by product type.
    levels : list | None
        Pressure levels (hPa) when level_type == 'pressure'.
    level_type : str
        'single' or 'pressure'.
    product_type : str
        'reanalysis', 'ensemble_mean', 'ensemble_spread',
        'ensemble_members', 'monthly_averaged_reanalysis', ...
    """
    dataset = f'reanalysis-era5-{level_type}-levels'
    if 'monthly' in product_type:
        dataset += '-monthly-means'
    entry = {
        'product_type': [product_type],
        'data_format': 'netcdf',
        'download_format': 'unarchived',
        'variable': list(variables),
        'area': list(area),
        'year': str(year),
        'month': str(month).zfill(2),
        'time': list(hours) if hours is not None
        else default_hours(product_type),
    }
    if 'monthly' not in product_type:
        if days is None:
            days = range(1, calendar.monthrange(year, month)[1] + 1)
        entry['day'] = [str(d).zfill(2) for d in days]
    if level_type == 'pressure':
        assert levels, 'pressure-level request needs levels'
        entry['pressure_level'] = [str(lv) for lv in levels]
    return dataset, entry


def default_hours(product_type):
    """Request hours by product type: ERA5 reanalysis is hourly, EDA
    (ensemble) is 3-hourly, monthly means have one step (reference:
    era_downloader.py:129-144)."""
    if product_type in ('monthly_averaged_reanalysis',
                        'monthly_averaged_ensemble_members'):
        return ['00:00']
    if product_type in ('reanalysis',
                        'monthly_averaged_reanalysis_by_hour_of_day'):
        return [f'{h:02d}:00' for h in range(24)]
    return [f'{h:02d}:00' for h in range(0, 24, 3)]


class EraDownloader:
    """Download, standardize, and combine monthly/yearly ERA5 variable
    files (reference: era_downloader.py:44-937).

    One instance handles ONE (year, month, variable-set). The
    classmethod orchestrators (`run_month`, `run_for_var`, `run`)
    fan out over months/variables with skip-existing and
    corrupt-file redownload semantics.
    """

    SFC_VARS = SFC_VARS
    LEVEL_VARS = LEVEL_VARS

    #: canonical sup3r feature names -> CDS long names (an extension
    #: over the reference, which only accepts CDS names + u/v
    #: wildcards; lets configs request the names they train on)
    CANON_TO_CDS = {
        'u_10m': '10m_u_component_of_wind',
        'v_10m': '10m_v_component_of_wind',
        'u_100m': '100m_u_component_of_wind',
        'v_100m': '100m_v_component_of_wind',
        'temperature_2m': '2m_temperature',
        'dewpoint_2m': '2m_dewpoint_temperature',
        'pressure_0m': 'surface_pressure',
        'temperature': 'temperature',
        'relativehumidity': 'relative_humidity',
        'specifichumidity': 'specific_humidity',
    }

    def __init__(self, year, month, area, days=None, levels=None,
                 variables=None, monthly_file_pattern=None,
                 overwrite=False, product_type='reanalysis',
                 client=None, **compat):
        # backward-compat alias used by earlier revisions
        monthly_file_pattern = monthly_file_pattern or compat.pop(
            'combined_out_pattern', './era5_{year}_{month}_{var}.nc')
        assert not compat, f'unknown kwargs: {list(compat)}'
        self.year = year
        self.month = month
        self.area = area
        self.days = days
        self.levels = levels or []
        self.variables = list(variables or [])
        self.monthly_file_pattern = monthly_file_pattern
        self.overwrite = overwrite
        self.product_type = product_type
        self.client = client
        self.sfc_file_variables = []
        self.level_file_variables = []
        self._split_variables(self.variables)

    # -- variable classification ---------------------------------------
    @classmethod
    def _expand_variables(cls, variables):
        """Expand generic requests to downloadable CDS names: 'u'/'v'
        match all wind components ('u' -> 'u_component_of_wind',
        '10m_u_...', ...); substrings match any downloadable var;
        'orog'/'zg' pass through as geopotential markers (reference:
        era_downloader.py:177-190)."""
        out = []
        all_vars = cls.SFC_VARS + cls.LEVEL_VARS + ['zg', 'orog']
        for var in variables:
            canon = cls.CANON_TO_CDS.get(str(var).lower())
            if canon is not None:
                out.append(canon)
                continue
            pat = f'{var}_' if var in ('u', 'v') else var
            matches = [v for v in all_vars if pat in v]
            out.extend(matches if matches else [var])
        return out

    def _split_variables(self, variables):
        """Split expanded variables into surface vs pressure-level
        request lists, with geopotential handling for orog/zg
        (reference: era_downloader.py:192-225)."""
        expanded = self._expand_variables(variables)
        for var in expanded:
            if var in self.SFC_VARS and (
                    var not in self.sfc_file_variables):
                self.sfc_file_variables.append(var)
            elif var in self.LEVEL_VARS and (
                    var not in self.level_file_variables):
                self.level_file_variables.append(var)
            elif var not in ('zg', 'orog'):
                msg = f'Requested {var} is not available for download.'
                logger.warning(msg)
                warn(msg)
        both = (self.sfc_file_variables and self.level_file_variables
                and 'orog' not in expanded and 'zg' not in expanded)
        if both:
            msg = (f'Both surface and pressure level variables '
                   f'({expanded}) were requested without requesting '
                   '"orog" and "zg".')
            logger.warning(msg)
            warn(msg)
        else:
            if 'orog' in expanded and (
                    'geopotential' not in self.sfc_file_variables):
                self.sfc_file_variables.append('geopotential')
            if 'zg' in expanded and (
                    'geopotential' not in self.level_file_variables):
                self.level_file_variables.append('geopotential')

    # -- file naming -----------------------------------------------------
    @property
    def monthly_file(self):
        """Combined monthly file for this (year, month, vars)."""
        fp = self.monthly_file_pattern.replace(
            '{var}', '_'.join(self.variables)).format(
            year=self.year, month=str(self.month).zfill(2))
        d = os.path.dirname(os.path.abspath(fp))
        os.makedirs(d, exist_ok=True)
        return fp

    @property
    def surface_file(self):
        """Raw single-level download target."""
        base = os.path.basename(self.monthly_file)
        return os.path.join(os.path.dirname(self.monthly_file),
                            f'sfc_{base}')

    @property
    def level_file(self):
        """Raw pressure-level download target."""
        base = os.path.basename(self.monthly_file)
        return os.path.join(os.path.dirname(self.monthly_file),
                            f'level_{base}')

    # -- client / download ------------------------------------------------
    def get_client(self):
        """The injected client, or a real cdsapi.Client (gated)."""
        if self.client is not None:
            return self.client
        try:
            import cdsapi
        except ImportError as e:
            raise ImportError(
                'The ERA5 downloader requires the "cdsapi" package and '
                'CDS credentials (~/.cdsapirc), or an injected client '
                'object with .retrieve(dataset, entry, out_file).'
            ) from e
        req_file = os.path.join(os.path.expanduser('~'), '.cdsapirc')
        msg = ('To download ERA5 data you need ~/.cdsapirc with a '
               'valid url and api key: '
               'https://cds.climate.copernicus.eu/how-to-api')
        assert os.path.exists(req_file), msg
        return cdsapi.Client()

    # kept for API compat with earlier revisions / simple scripted use
    def download_file(self, variable, out_fp):
        """Request ONE variable-month file from CDS."""
        level_type = ('pressure' if variable in self.LEVEL_VARS
                      and self.levels else 'single')
        dataset, entry = build_cds_request(
            [variable], self.year, self.month, self.area,
            days=self.days, levels=self.levels or None,
            level_type=level_type, product_type=self.product_type)
        logger.info('Requesting %s from CDS -> %s', variable, out_fp)
        self.get_client().retrieve(dataset, entry, out_fp)
        return out_fp

    @classmethod
    def _can_skip_file(cls, fp):
        """True if fp exists AND opens cleanly; corrupt partial
        downloads are removed so they get re-requested (reference:
        era_downloader.py:850-869)."""
        if not os.path.exists(fp):
            return False
        try:
            from sup3r_tpu_torch.preprocessing.loaders import LoaderNC

            loader = LoaderNC(fp, lazy=True)
            ok = bool(loader.data.data_vars) or (
                loader.data.time_index is not None)
            loader.close()
            return ok
        except Exception as e:  # any unreadable file -> redownload
            logger.warning('Could not open %s (%s); will redownload.',
                           fp, e)
            os.remove(fp)
            return False

    def _download(self, variables, out_file, level_type):
        """Download one raw (surface or level) file with tmp+rename and
        skip-existing semantics."""
        if self._can_skip_file(out_file) and not self.overwrite:
            logger.info('File already exists: %s', out_file)
            return
        dataset, entry = build_cds_request(
            variables, self.year, self.month, self.area,
            days=self.days, levels=self.levels or None,
            level_type=level_type, product_type=self.product_type)
        logger.info('Calling CDS API: dataset=%s entry=%s', dataset,
                    entry)
        tmp = out_file + '.tmp'
        self.get_client().retrieve(dataset, entry, tmp)
        os.replace(tmp, out_file)

    def download_process_combine(self):
        """Download raw surface/level files, standardize each, and
        combine into the monthly file (reference:
        era_downloader.py:248-301)."""
        sfc_check = bool(self.sfc_file_variables)
        level_check = bool(self.level_file_variables) and bool(
            self.levels)
        if self.level_file_variables and not self.levels:
            msg = (f'{self.level_file_variables} requested but no '
                   'levels were provided.')
            logger.warning(msg)
            warn(msg)
        if sfc_check:
            self._download(self.sfc_file_variables, self.surface_file,
                           'single')
        if level_check:
            self._download(self.level_file_variables, self.level_file,
                           'pressure')
        if sfc_check or level_check:
            self.process_and_combine()

    # -- processing ---------------------------------------------------------
    def _process_raw(self, in_fp, z_name):
        """Standardize one raw download in place: canonical names/dims
        via the loader, geopotential z -> height (named ``z_name``),
        optional broadcast pressure variable, monthly time stamp."""
        from sup3r_tpu_torch.preprocessing.loaders import LoaderNC

        dset = LoaderNC(in_fp).data
        if 'z' in dset.data_vars and z_name not in dset.data_vars:
            dset.data_vars[z_name] = geopotential_to_height(
                dset.data_vars.pop('z')).astype(np.float32)
            dset.var_dims[z_name] = dset.var_dims.pop('z')
        if z_name == 'zg' and 'pressure' in [
                v.lower() for v in self.variables]:
            dset = self._add_pressure(dset)
        if 'monthly' in self.product_type and dset.time_index is not None:
            dset.time_index = TimeIndex(
                [f'{self.year}-{str(self.month).zfill(2)}-01'])
        tmp = in_fp + '.proc'
        write_nc4(tmp, dset)
        os.replace(tmp, in_fp)
        return in_fp

    @staticmethod
    def _add_pressure(dset):
        """Materialize a 'pressure' variable (Pa) broadcast from the
        level coordinate over a 4D (s1, s2, t, level) variable's shape
        (reference: era_downloader.py:400-427)."""
        if dset.levels is None or 'pressure' in dset.data_vars:
            return dset
        template = None
        for name, dims in dset.var_dims.items():
            if len(dims) == 4:
                template = name
                break
        if template is None:
            return dset
        dims = dset.var_dims[template]
        shape = np.shape(dset.data_vars[template])
        lv_ax = [i for i, d in enumerate(dims)
                 if 'level' in str(d)]
        lv_ax = lv_ax[0] if lv_ax else len(dims) - 1
        pres = 100.0 * np.asarray(dset.levels, dtype=np.float32)
        view = [1] * len(shape)
        view[lv_ax] = len(pres)
        dset.data_vars['pressure'] = np.broadcast_to(
            pres.reshape(view), shape).astype(np.float32)
        dset.var_dims['pressure'] = dims
        return dset

    def process_and_combine(self):
        """Standardize the raw surface/level files and merge them into
        the single monthly file, removing the intermediates
        (reference: era_downloader.py:473-502)."""
        from sup3r_tpu_torch.preprocessing.loaders import LoaderNC

        if self._can_skip_file(self.monthly_file) and not self.overwrite:
            logger.info('%s already exists.', self.monthly_file)
            return
        files = []
        if os.path.exists(self.level_file):
            self._process_raw(self.level_file, 'zg')
            files.append(self.level_file)
        if os.path.exists(self.surface_file):
            self._process_raw(self.surface_file, 'orog')
            files.append(self.surface_file)
        assert files, 'nothing downloaded to combine'
        dset = LoaderNC(files).data
        tmp = self.monthly_file + '.tmp2'
        write_nc4(tmp, dset)
        os.replace(tmp, self.monthly_file)
        for fp in files:
            os.remove(fp)
        logger.info('Wrote monthly file %s', self.monthly_file)

    def get_monthly_file(self):
        """Full single-month routine with skip/corrupt handling."""
        if os.path.exists(self.monthly_file) and (
                not self._can_skip_file(self.monthly_file)
                or self.overwrite):
            if os.path.exists(self.monthly_file):
                os.remove(self.monthly_file)
        if not os.path.exists(self.monthly_file):
            self.download_process_combine()
        return self.monthly_file

    # kept for API compat: per-variable month loop
    def run_variables(self):
        """Download all requested variables for the month, one file
        each, using the monthly pattern's {var} key."""
        out = []
        for var in self.variables:
            fp = self.monthly_file_pattern.format(
                year=self.year, month=str(self.month).zfill(2), var=var)
            if os.path.exists(fp):
                logger.info('%s exists, skipping', fp)
            else:
                self.download_file(var, fp)
            out.append(fp)
        return out

    # -- orchestration ------------------------------------------------------
    @classmethod
    def run_month(cls, year, month, area, days=None, levels=None,
                  monthly_file_pattern=None, overwrite=False,
                  variables=None, product_type='reanalysis',
                  client=None):
        """Run the full routine for one month, one variable at a time
        (reference: era_downloader.py:541-594)."""
        variables = (variables if isinstance(variables, list)
                     else [variables])
        for var in variables:
            cls(year=year, month=month, area=area, days=days,
                levels=levels, monthly_file_pattern=monthly_file_pattern,
                overwrite=overwrite, variables=[var],
                product_type=product_type,
                client=client).get_monthly_file()

    @classmethod
    def run_for_var(cls, year, area, levels=None,
                    monthly_file_pattern=None, yearly_file_pattern=None,
                    months=None, days=None, overwrite=False,
                    max_workers=None, variable=None,
                    product_type='reanalysis', client=None):
        """All requested months of one year for one variable; combines
        into a yearly variable file when all 12 months are present
        (reference: era_downloader.py:597-702)."""
        msg = ('monthly_file_pattern must have {year}, {month}, and '
               '{var} format keys')
        assert all(k in monthly_file_pattern
                   for k in ('{year}', '{month}', '{var}')), msg
        yearly_var_file = None
        if yearly_file_pattern is not None:
            yearly_var_file = yearly_file_pattern.format(
                year=year, var=variable)
            if os.path.exists(yearly_var_file) and not overwrite:
                logger.info('%s already exists and overwrite=False.',
                            yearly_var_file)
                return yearly_var_file
        months = list(range(1, 13)) if months is None else list(months)
        if days is None:
            days = [None] * len(months)

        def _one(i_month):
            i, month = i_month
            cls.run_month(year=year, month=month, area=area,
                          days=days[i], levels=levels,
                          monthly_file_pattern=monthly_file_pattern,
                          overwrite=overwrite, variables=[variable],
                          product_type=product_type, client=client)

        if max_workers in (None, 1):
            for item in enumerate(months):
                _one(item)
        else:
            with ThreadPoolExecutor(max_workers=max_workers) as pool:
                list(pool.map(_one, enumerate(months)))

        if yearly_var_file is not None and len(months) == 12:
            cls.make_yearly_var_file(year, monthly_file_pattern,
                                     yearly_file_pattern, variable)
        return yearly_var_file

    @classmethod
    def run(cls, year, area, levels=None, monthly_file_pattern=None,
            yearly_file_pattern=None, months=None, days=None,
            overwrite=False, max_workers=None, variables=None,
            product_type='reanalysis', combine_all_files=False,
            client=None):
        """Full-year, multi-variable routine (reference:
        era_downloader.py:705-796)."""
        for var in variables:
            cls.run_for_var(year=year, area=area, levels=levels,
                            monthly_file_pattern=monthly_file_pattern,
                            yearly_file_pattern=yearly_file_pattern,
                            months=months, days=days,
                            overwrite=overwrite,
                            max_workers=max_workers, variable=var,
                            product_type=product_type, client=client)
        if (yearly_file_pattern is not None and combine_all_files
                and cls.all_vars_exist(year, yearly_file_pattern,
                                       variables)):
            out = yearly_file_pattern.replace('_{var}', '').replace(
                '{var}_', '').format(year=year)
            cls.make_yearly_file(
                [yearly_file_pattern.format(year=year, var=v)
                 for v in variables], out)
            return out
        return None

    @classmethod
    def all_vars_exist(cls, year, file_pattern, variables):
        """True if every yearly variable file exists."""
        return all(os.path.exists(file_pattern.format(year=year, var=v))
                   for v in variables)

    @classmethod
    def make_yearly_var_file(cls, year, monthly_file_pattern,
                             yearly_file_pattern, variable):
        """Combine one variable's 12 monthly files into its yearly
        file (reference: era_downloader.py:799-848)."""
        files = [monthly_file_pattern.format(
            year=year, month=str(m).zfill(2), var=variable)
            for m in range(1, 13)]
        missing = [fp for fp in files if not os.path.exists(fp)]
        assert not missing, f'missing monthly files: {missing}'
        out_fp = yearly_file_pattern.format(year=year, var=variable)
        return cls.make_yearly_file(files, out_fp)

    # ------------------------------------------------------------------
    # offline processing (no network needed; reference parity:
    # era_downloader.py process_and_combine / make_yearly_file)
    @staticmethod
    def process_file(in_fp, out_fp):
        """Standardize one raw ERA5 file: canonical names/dims via the
        loader (descending lats/levels, short-name mapping) and
        geopotential ``z`` converted to height ``zg`` in meters."""
        from sup3r_tpu_torch.preprocessing.loaders import LoaderNC

        dset = LoaderNC(in_fp).data
        if 'z' in dset.data_vars:
            dset.data_vars['zg'] = geopotential_to_height(
                dset.data_vars.pop('z'))
            dset.var_dims['zg'] = dset.var_dims.pop('z')
        write_nc4(out_fp, dset)
        return out_fp

    @staticmethod
    def make_yearly_file(monthly_pattern, out_fp):
        """Combine monthly files (glob pattern or list) into one
        yearly file, time-sorted, using lazy per-window reads so a
        year of hourly data never fully materializes twice."""
        from sup3r_tpu_torch.preprocessing.loaders import LoaderNC

        loader = LoaderNC(monthly_pattern, lazy=True)
        write_nc4(out_fp, loader.data)
        loader.close()
        return out_fp

    @classmethod
    def run_qa(cls, fp):
        """Light QA on a produced file: opens it, logs variables /
        shape / time range, returns the summary dict (reference:
        era_downloader.py:937)."""
        from sup3r_tpu_torch.preprocessing.loaders import LoaderNC

        loader = LoaderNC(fp, lazy=True)
        ti = loader.data.time_index
        info = {'file': fp,
                'features': sorted(loader.data.data_vars),
                'shape': tuple(loader.data.shape),
                'time_range': tuple(format_timestamps([ti[0], ti[-1]]))
                if ti is not None else None}
        loader.close()
        logger.info('QA %s', info)
        return info


def write_nc4(out_fp, dset):
    """Write a RawDataset to an HDF5-backed NetCDF4-style file (h5py
    dimension scales, so it round-trips through LoaderNC and any
    netCDF4 reader)."""
    import h5py

    from sup3r_tpu_torch.names import Dimension

    os.makedirs(os.path.dirname(os.path.abspath(out_fp)), exist_ok=True)
    tmp = out_fp + '.tmp'
    with h5py.File(tmp, 'w') as f:
        scales = {}
        lat = dset.lat_lon[:, 0, 0]
        lon = dset.lat_lon[0, :, 1]
        scales[Dimension.SOUTH_NORTH] = f.create_dataset(
            'latitude', data=lat.astype(np.float32))
        scales[Dimension.WEST_EAST] = f.create_dataset(
            'longitude', data=lon.astype(np.float32))
        if dset.time_index is not None:
            times = to_datetime64(dset.time_index)
            hours = (seconds_since(times, times[0]) / 3600).astype(
                'float64')
            tv = f.create_dataset('time', data=hours)
            start = np.datetime_as_string(times[0], unit='s').replace(
                'T', ' ')
            tv.attrs['units'] = np.bytes_(f'hours since {start}')
            tv.attrs['calendar'] = np.bytes_('standard')
            scales[Dimension.TIME] = tv
        if dset.levels is not None:
            lv = f.create_dataset(
                'level', data=np.asarray(dset.levels, np.float32))
            scales[Dimension.PRESSURE_LEVEL] = lv
        for name, ds in scales.items():
            ds.make_scale(ds.name.strip('/'))
        for name, arr in dset.data_vars.items():
            dims = dset.var_dims[name]
            if hasattr(arr, 'isel') and Dimension.TIME in dims:
                # lazy: stream time slabs instead of materializing
                v = f.create_dataset(name, shape=arr.shape,
                                     dtype=np.float32)
                t_ax = dims.index(Dimension.TIME)
                nt = arr.shape[t_ax]
                step = max(1, int(2e8 // max(
                    np.prod(arr.shape) // max(nt, 1), 1)))
                for t0 in range(0, nt, step):
                    sel = {Dimension.TIME: slice(t0, min(t0 + step,
                                                         nt))}
                    idx = tuple(sel.get(d, slice(None)) for d in dims)
                    v[idx] = arr.isel(sel)
            else:
                v = f.create_dataset(
                    name, data=np.asarray(arr, dtype=np.float32))
            for i, d in enumerate(dims):
                if d in scales:
                    v.dims[i].attach_scale(scales[d])
    os.replace(tmp, out_fp)
    return out_fp
