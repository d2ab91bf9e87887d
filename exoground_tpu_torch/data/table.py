"""CSV tables as lists of records, read and written as pandas does.

The JAX readers go through ``pandas.read_csv(...).to_dict("records")`` and
``DataFrame(records).to_csv(path, index=False)``; the card's machine has no
pandas, so the port reads and writes with the ``csv`` module and infers
each column's type as pandas' default parser does:

  * empty fields and pandas' default NA strings are NaN (a float);
  * a column whose values are all integers is int; with a NaN, or with a
    value that is only a float, it is float;
  * a column of True / False is bool;
  * anything else is str, its NA fields NaN.

Written values are ``str(value)``, with NaN and None (and a missing key)
as empty fields, an integer column with such a field as floats; the columns
are the records' keys in the order they first appear. A table
written by either package reads back to the same records in both.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Dict, List, Sequence

# pandas' default na_values (pandas/_libs/parsers.pyx STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_TRUE = frozenset({"True", "TRUE", "true"})
_FALSE = frozenset({"False", "FALSE", "false"})


def _is_int(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _column(values: Sequence[str]) -> list:
    """The typed values of one column's fields."""
    present = [v for v in values if v not in NA_STRINGS]
    has_na = len(present) < len(values)
    nan = float("nan")
    if present and all(_is_int(v) for v in present):
        if has_na:
            return [nan if v in NA_STRINGS else float(int(v)) for v in values]
        return [int(v) for v in values]
    if present and all(_is_float(v) for v in present):
        return [nan if v in NA_STRINGS else float(v) for v in values]
    if present and not has_na and all(v in _TRUE or v in _FALSE for v in present):
        return [v in _TRUE for v in values]
    if not present:
        return [nan] * len(values)
    return [nan if v in NA_STRINGS else v for v in values]


def read_csv_records(path: str) -> List[Dict]:
    """The rows of a CSV file with a header line, as pandas'
    ``read_csv(path).to_dict("records")`` returns them."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        return []
    header, body = rows[0], rows[1:]
    body = [r + [""] * (len(header) - len(r)) for r in body]
    cols = [_column([r[i] for r in body]) for i in range(len(header))]
    return [dict(zip(header, vals)) for vals in zip(*cols)] if body else []


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def write_csv_records(path: str, records: Sequence[Dict]) -> None:
    """``records`` as a CSV file, as ``DataFrame(records).to_csv(path,
    index=False)`` writes them: a missing key is an empty field, and an
    integer column with one is written as floats, as pandas holds it."""
    columns: List[str] = []
    for r in records:
        columns += [k for k in r if k not in columns]
    as_float = set()
    for k in columns:
        vals = [r.get(k) for r in records]
        present = [v for v in vals if not _missing(v)]
        if len(present) < len(vals) and present and all(
                isinstance(v, int) and not isinstance(v, bool) for v in present):
            as_float.add(k)
    # written beside and renamed into place: the ranks of a data-parallel
    # run on one host write the same cache, and one that finds the file must
    # never read it half written
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns if columns else [""])
        for r in records:
            w.writerow(["" if _missing(r.get(k)) else
                        str(float(r[k]) if k in as_float else r[k]) for k in columns])
    os.replace(tmp, path)
