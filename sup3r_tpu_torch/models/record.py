"""A small column store for loss records and training history (the
port's stand-in for the pandas frames the JAX package keeps; the card's
machine has no pandas).

``Record`` holds named columns of numbers over an integer index. Its CSV
form is pandas' ``to_csv`` form, so ``pd.read_csv(fp, index_col=0)`` in
the JAX package reads a port's ``history.csv`` to the frame it would have
written, and ``Record.read_csv`` reads the JAX package's.
"""

import math
import warnings

import numpy as np


def _is_int(v):
    return isinstance(v, (int, np.integer)) and not isinstance(
        v, (bool, np.bool_))


def _missing(v):
    return v is None or (isinstance(v, float) and math.isnan(v))


class Record:
    """Rows of ``{column: number}`` over an integer index."""

    def __init__(self):
        self._cols = {}
        self.index = []

    @property
    def columns(self):
        """Column names, in order of first appearance."""
        return list(self._cols)

    def __len__(self):
        return len(self.index)

    def __contains__(self, column):
        return column in self._cols

    def __getitem__(self, column):
        """The column as a float64 array (NaN where a row lacks it)."""
        return np.array([np.nan if _missing(v) else v
                         for v in self._cols[column]], dtype=np.float64)

    def append(self, row, index=None):
        """Add one row; a new column is missing (NaN) in earlier rows."""
        n = len(self.index)
        for key in row:
            self._cols.setdefault(key, [None] * n)
        for key, col in self._cols.items():
            col.append(row.get(key))
        self.index.append(n if index is None else int(index))
        return self

    def tail(self, n):
        """Keep only the last ``n`` rows, re-indexed from 0 (pandas'
        ``iloc[-n:].reset_index(drop=True)``)."""
        for key in self._cols:
            self._cols[key] = self._cols[key][-n:]
        self.index = list(range(len(self.index[-n:])))
        return self

    def mean(self):
        """{column: mean over rows}, skipping missing values."""
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', RuntimeWarning)
            return {k: float(np.nanmean(self[k])) for k in self._cols}

    # ------------------------------------------------------------------
    # pandas' CSV form
    def _cell(self, column, v):
        if _missing(v):
            return ''
        if all(_is_int(x) for x in self._cols[column]):
            return str(int(v))
        return repr(float(v))

    def to_csv(self, path):
        """Write the record as ``DataFrame.to_csv`` would."""
        lines = [','.join([''] + self.columns)]
        for i, idx in enumerate(self.index):
            lines.append(','.join([str(idx)] + [
                self._cell(k, col[i]) for k, col in self._cols.items()]))
        with open(path, 'w') as f:
            f.write('\n'.join(lines) + '\n')

    @classmethod
    def read_csv(cls, path):
        """Read a CSV of ``DataFrame.to_csv`` form with a numeric index
        and numeric columns (a column of ints stays int)."""
        with open(path) as f:
            rows = [line.rstrip('\n').split(',') for line in f
                    if line.strip()]
        header, body = rows[0][1:], rows[1:]
        out = cls()
        out.index = [int(float(r[0])) for r in body]
        for j, name in enumerate(header):
            cells = [r[j + 1] for r in body]
            ints = all(c.lstrip('-').isdigit() for c in cells)
            out._cols[name] = [int(c) if ints else
                               (None if c == '' else float(c))
                               for c in cells]
        return out
