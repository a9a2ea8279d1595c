"""A pandas-free time index on ``numpy.datetime64[ns]``.

The data plane of the port needs a small part of
``pandas.DatetimeIndex``: slicing, calendar fields, equality, a fixed-step
``date_range``, a minute ``shift`` and pandas' string form of a
timestamp. ``TimeIndex`` gives exactly that, so the forward pass runs on
machines without pandas. Scalars are ``numpy.datetime64[ns]`` values;
differences are ``numpy.timedelta64[ns]``. Each index also carries the
resolution pandas would give it (``unit``: 's', 'ms', 'us' or 'ns'), as
arithmetic on its steps floors at that resolution.
"""

import numpy as np

_NS = 'datetime64[ns]'
_NS_PER_S = 10 ** 9
#: nanoseconds per pandas resolution
_NS_PER_UNIT = {'s': 10 ** 9, 'ms': 10 ** 6, 'us': 10 ** 3, 'ns': 1}


def infer_unit(values):
    """The resolution pandas 3 gives an index built from ``values``: a
    ``TimeIndex``'s own, a datetime64 array's unit (units coarser than
    seconds become 's'), and 'us' for parsed strings."""
    if isinstance(values, TimeIndex):
        return values.unit
    arr = np.asarray(values)
    if arr.dtype.kind == 'M':
        unit = np.datetime_data(arr.dtype)[0]
        return unit if unit in _NS_PER_UNIT else 's'
    return 'us'


def to_datetime64(values):
    """``datetime64[ns]`` array from datetime64 values, ISO strings
    (bytes or str, ``T`` or space between date and time), a
    ``TimeIndex`` or anything numpy converts (a pandas index too)."""
    if isinstance(values, TimeIndex):
        return values.values
    arr = np.asarray(values)
    if arr.size == 0:
        return np.zeros(0, _NS)
    if arr.dtype.kind in 'SO':
        arr = np.asarray([v.decode() if isinstance(v, bytes) else v
                          for v in arr.ravel()]).reshape(arr.shape)
    if arr.dtype.kind == 'U':
        arr = np.char.replace(arr, ' ', 'T')
    return np.atleast_1d(arr.astype(_NS))


def timestamp(value):
    """One ``datetime64[ns]`` scalar from a string or datetime value."""
    return to_datetime64([value])[0]


def format_timestamps(values):
    """pandas' ``str(Timestamp)`` for each value: ``'YYYY-MM-DD
    HH:MM:SS'``, with ``.ffffff`` microseconds or ``.fffffffff``
    nanoseconds only where the value has them (numpy's own string form
    puts a ``T`` between date and time)."""
    ns = to_datetime64(values)
    frac = ns.astype(np.int64) % _NS_PER_S
    out = []
    for v, f in zip(ns, frac):
        unit = 's' if f == 0 else ('us' if f % 1000 == 0 else 'ns')
        out.append(np.datetime_as_string(v, unit=unit).replace('T', ' '))
    return out


def seconds_since(values, origin):
    """Float seconds of each value after ``origin``."""
    delta = to_datetime64(values) - timestamp(origin)
    return delta.astype(np.int64) / _NS_PER_S


class TimeIndex:
    """An immutable index of ``datetime64[ns]`` timestamps with the
    pandas ``DatetimeIndex`` attributes the forward pass uses and the
    resolution (``unit``) pandas would hold them at."""

    def __init__(self, values, unit=None):
        self.unit = infer_unit(values) if unit is None else unit
        self.values = to_datetime64(values)
        self.values.flags.writeable = False

    def __len__(self):
        return len(self.values)

    def __array__(self, dtype=None, copy=None):
        return self.values if dtype is None else self.values.astype(dtype)

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            return self.values[key]
        return TimeIndex(self.values[key], unit=self.unit)

    def __repr__(self):
        return f'TimeIndex({format_timestamps(self.values)})'

    def equals(self, other):
        """Same timestamps in the same order."""
        other = to_datetime64(other)
        return (len(other) == len(self.values)
                and bool((other == self.values).all()))

    def _days_into(self, unit):
        """Whole days since the start of each value's year or month."""
        days = self.values.astype('datetime64[D]')
        start = self.values.astype(f'datetime64[{unit}]')
        return (days - start.astype('datetime64[D]')).astype(np.int64)

    @property
    def month(self):
        return self.values.astype('datetime64[M]').astype(np.int64) % 12 + 1

    @property
    def day(self):
        return self._days_into('M') + 1

    @property
    def dayofyear(self):
        return self._days_into('Y') + 1

    def _seconds_of_day(self):
        ns = (self.values - self.values.astype('datetime64[D]')).astype(
            np.int64)
        return ns // _NS_PER_S

    @property
    def hour(self):
        return self._seconds_of_day() // 3600

    @property
    def minute(self):
        return self._seconds_of_day() % 3600 // 60

    @property
    def second(self):
        return self._seconds_of_day() % 60

    def shift(self, periods, freq='min'):
        """Every timestamp moved by ``periods`` of ``freq`` (a numpy
        timedelta unit name; pandas' ``'min'`` is minutes)."""
        unit = {'min': 'm', 'T': 'm', 'H': 'h', 'S': 's'}.get(freq, freq)
        return TimeIndex(self.values + np.timedelta64(int(periods), unit),
                         unit=self.unit)


def calendar_days(values):
    """The calendar day of each timestamp (``datetime64[D]``), as
    pandas' ``DatetimeIndex(ti.date)`` gives it."""
    return to_datetime64(values).astype('datetime64[D]')


def unique_days(values):
    """The distinct calendar days of ``values`` in order of appearance
    (pandas' ``DatetimeIndex(ti.date).unique()``), as
    ``datetime64[D]``."""
    days = calendar_days(values)
    _, first = np.unique(days, return_index=True)
    return days[np.sort(first)]


def floor_step(step, unit):
    """A ``timedelta64`` step floored to whole ``unit``s (pandas keeps a
    ``Timedelta`` at its index's resolution, so ``offset / 7`` of an
    index held in microseconds drops the sub-microsecond rest)."""
    per = _NS_PER_UNIT[unit]
    ns = np.timedelta64(step, 'ns').astype(np.int64)
    return np.timedelta64(int(ns // per * per), 'ns')


def date_range(start, end, freq, unit=None):
    """``pandas.date_range(start, end, freq=freq)`` for a fixed
    ``timedelta64`` step: ``start + k * freq`` for every k whose value
    does not pass ``end``. ``unit`` defaults to pandas' own: 'us' for a
    string start, else the start's resolution."""
    unit = infer_unit([start]) if unit is None else unit
    start, end = timestamp(start), timestamp(end)
    step = np.timedelta64(freq, 'ns').astype(np.int64)
    n = int((end - start).astype(np.int64) // step) + 1
    return TimeIndex(start + np.arange(n, dtype=np.int64).astype(
        'timedelta64[ns]') * step, unit=unit)
