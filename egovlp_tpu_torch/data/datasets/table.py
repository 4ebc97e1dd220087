"""Delimited text files read as pandas reads them, with the standard
library.

``read_table(path, sep)`` reads a file as ``pandas.read_csv(path, sep=sep,
on_bad_lines='skip')`` does: quoted fields as the ``csv`` module reads
them, blank lines skipped, a row with more fields than the header
dropped, a shorter one padded with NaN, and each column typed as pandas
types it (int64 where every value is an integer, float64 where every
value is a number or missing, else strings with NaN for missing values).
Numbers are converted as pandas' default C converter converts them,
which is not always the nearest double (``0.9999999999999999`` reads
1.0).
"""

from __future__ import annotations

import csv
import math
import re
from typing import Any, Dict, List

import numpy as np

# pandas.read_csv's default missing-value strings
_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                 "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                 "NULL", "NaN", "None", "n/a", "nan", "null"})
_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"([+-]?)(\d+|\d+\.\d*|\.\d+)(?:[eE]([+-]?\d+))?")
_INF = re.compile(r"[+-]?(inf|Inf|INF|infinity|Infinity)")
_POW10 = [float(f"1e{k}") for k in range(309)]


def _to_float(s: str) -> float:
    """pandas' default float converter (``precise_xstrtod``): up to 17
    significant digits accumulated in a double, then one multiply or
    divide by a power of ten."""
    m = _FLOAT.fullmatch(s)
    if m is None:  # inf
        return float(s)
    sign, mantissa, exp = m.groups()
    whole, _, frac = mantissa.partition(".")
    number, exponent, digits = 0.0, 0, 0
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + int(ch)
            digits += 1
        else:
            exponent += 1
    for ch in frac[:max(17 - digits, 0)]:
        number = number * 10.0 + int(ch)
        exponent -= 1
    if sign == "-":
        number = -number
    exponent += int(exp or 0)
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent >= 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _column(raw: List[str]):
    """One column typed as pandas types it: int64, float64 (NaN for
    missing values) or a list of strings (NaN for missing values)."""
    na = [v in _NA for v in raw]
    vals = [v for v, missing in zip(raw, na) if not missing]
    if all(_INT.fullmatch(v) for v in vals):
        if not any(na):
            return np.array([int(v) for v in raw], np.int64)
        return np.array([math.nan if m else float(int(v))
                         for v, m in zip(raw, na)], np.float64)
    if all(_FLOAT.fullmatch(v) or _INF.fullmatch(v) for v in vals):
        return np.array([math.nan if m else _to_float(v)
                         for v, m in zip(raw, na)], np.float64)
    return [math.nan if m else v for v, m in zip(raw, na)]


def read_table(path: str, sep: str = ",") -> Dict[str, Any]:
    """``{column: values}`` of a ``sep``-separated file with a header
    row."""
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter=sep)
        header = next(reader)
        n = len(header)
        rows = [r + [""] * (n - len(r)) for r in reader if 0 < len(r) <= n]
    return {name: _column([r[j] for r in rows])
            for j, name in enumerate(header)}


def read_tsv(path: str) -> Dict[str, Any]:
    """``read_table`` of a tab-separated file."""
    return read_table(path, "\t")


def row(table: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Row ``i`` of a table as ``{column: value}``."""
    return {k: v[i] for k, v in table.items()}


def n_rows(table: Dict[str, Any]) -> int:
    return len(next(iter(table.values()), []))
