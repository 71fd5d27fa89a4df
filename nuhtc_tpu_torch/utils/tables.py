"""Row tables as the JAX package's tools write them through pandas, with the
standard library only: CSV files through ``csv`` and SQLite tables through
``sqlite3``. A table is a list of dicts; its columns are the keys in order of
first appearance (``pandas.DataFrame(rows)``), a key a row lacks is empty."""

from __future__ import annotations

import csv
import math
import re
import sqlite3
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def parse_cell(text: str):
    """A CSV cell as a number or a truth value where it reads as one; an
    empty cell is None (a missing value)."""
    text = text.strip()
    if text == "":
        return None
    if text.lower() in ("true", "false"):
        return text.lower() == "true"
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def read_csv_rows(path: str, parse: bool = True) -> List[Dict[str, object]]:
    """The rows of a CSV file with a header, each a dict by column. With
    ``parse`` each cell goes through ``parse_cell``; without, every cell
    stays the text it is (a file name such as ``0001.png`` or ``0001`` must)."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not parse:
        return [{k: v or "" for k, v in row.items()} for row in rows]
    return [{k: parse_cell(v or "") for k, v in row.items()} for row in rows]


# the cells pandas.read_csv reads as a missing value
_NA_CELLS = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
             "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_NUMBER = re.compile(r"([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?")
_POW10 = [float(f"1e{i}") for i in range(309)]


def pandas_float(text: str) -> float:
    """A number as ``pandas.read_csv`` reads it (its C parser's
    ``precise_xstrtod``): at most 17 significant digits, counted from the
    first digit (a leading 0 included), gathered as number · 10 + digit in
    doubles, then scaled by one power of ten. Not always the nearest double
    to the text (repr's 17th digit is dropped), so the CSV a pandas tool
    writes back can differ from what ``float`` would give."""
    m = _NUMBER.fullmatch(text.strip())
    if not m or not (m[2] or m[3]):
        raise ValueError(f"not a number: {text!r}")
    number, exponent, digits = 0.0, 0, 0
    for ch in m[2]:
        if digits < 17:
            number, digits = number * 10.0 + int(ch), digits + 1
        else:
            exponent += 1
    for ch in m[3] or "":
        if digits >= 17:
            break
        number, digits, exponent = number * 10.0 + int(ch), digits + 1, exponent - 1
    exponent += int(m[4] or 0)
    if m[1] == "-":
        number = -number
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0 * number
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def read_csv_columns(path: str) -> Dict[str, List[object]]:
    """A CSV file with a header as {column: values}, typed per column as
    ``pandas.read_csv`` types it: integers where every cell is one, floats
    (``pandas_float``; a missing cell NaN) where every cell is a number or
    missing, else text (a missing cell None). An unnamed column is
    "Unnamed: i"."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    names = [h if h else f"Unnamed: {i}" for i, h in enumerate(rows[0])]
    out: Dict[str, List[object]] = {}
    for i, name in enumerate(names):
        cells = [r[i] if i < len(r) else "" for r in rows[1:]]
        if cells and all(re.fullmatch(r"[+-]?\d+", c.strip()) for c in cells):
            out[name] = [int(c) for c in cells]
            continue
        try:
            out[name] = [math.nan if c in _NA_CELLS else
                         float(c) if c.strip().lower().lstrip("+-") in ("inf", "infinity")
                         else pandas_float(c) for c in cells]
        except ValueError:
            out[name] = [None if c in _NA_CELLS else c for c in cells]
    return out


def columns_of(rows: Sequence[Dict[str, object]]) -> List[str]:
    columns: Dict[str, None] = {}
    for row in rows:
        columns.update(dict.fromkeys(row))
    return list(columns)


def _value(v) -> object:
    """numpy scalars as Python values, NaN as None (a missing value)."""
    if isinstance(v, np.generic):
        v = v.item()
    return None if isinstance(v, float) and np.isnan(v) else v


def _cell(v) -> object:
    """A value as pandas writes it to CSV: a missing value as an empty cell."""
    v = _value(v)
    return "" if v is None else v


def write_csv_rows(path: str, rows: Sequence[Dict[str, object]],
                   index: Optional[Sequence[object]] = None) -> None:
    """``DataFrame(rows).to_csv(path, index=index is not None)``: with an
    index, an unnamed first column holds it."""
    columns = columns_of(rows)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(([""] if index is not None else []) + columns)
        for i, row in enumerate(rows):
            cells = [_cell(row.get(k)) for k in columns]
            writer.writerow(([_cell(index[i])] if index is not None else []) + cells)


def _sql_type(values) -> str:
    """The type pandas' ``to_sql`` gives a column: INTEGER for integers and
    truth values, REAL once a float or a missing value joins them, TEXT for
    anything else."""
    vals = [_value(v) for v in values]
    if all(isinstance(v, (bool, int)) for v in vals):
        return "INTEGER"
    if all(v is None or isinstance(v, (bool, int, float)) for v in vals):
        return "REAL"
    return "TEXT"


def write_sqlite_rows(path: str, table: str, rows: Sequence[Dict[str, object]]) -> None:
    """``DataFrame(rows).to_sql(table, conn, if_exists="replace", index=False)``."""
    columns = columns_of(rows)
    types = [_sql_type([r.get(k) for r in rows]) for k in columns]
    conn = sqlite3.connect(path)
    try:
        conn.execute(f'DROP TABLE IF EXISTS "{table}"')
        conn.execute(f'CREATE TABLE "{table}" (' + ", ".join(
            f'"{k}" {t}' for k, t in zip(columns, types)) + ")")
        marks = ", ".join("?" * len(columns))
        conn.executemany(f'INSERT INTO "{table}" VALUES ({marks})',
                         [[_value(r.get(k)) for k in columns] for r in rows])
        conn.commit()
    finally:
        conn.close()


def _format_column(values: Sequence[object], lead: bool) -> Tuple[bool, List[str]]:
    """(numeric, cells) of one column as pandas prints a frame: text as it
    is; floats with 6 decimals less the trailing zeros every value shares
    (at least one kept), or in e-notation with 6 where a value is below
    1e-6 or above 1e6, and with ``lead`` a space before a value that has no
    minus sign; NaN as "NaN"."""
    vals = [_value(v) for v in values]
    if vals and all(isinstance(v, int) and not isinstance(v, bool) for v in vals):
        return True, [(" " if lead and v >= 0 else "") + str(v) for v in vals]
    if not all(v is None or isinstance(v, float) for v in vals):
        return False, [(" " if lead else "") + ("NaN" if v is None else str(v)) for v in vals]
    finite = np.abs(np.asarray([v for v in vals if v is not None and np.isfinite(v)], float))
    if ((finite < 1e-6) & (finite > 0)).any() or (finite > 1e6).any():
        cells = [None if v is None else f"{v:.6e}" for v in vals]
    else:
        cells = [None if v is None else f"{v:.6f}" for v in vals]
        while any(c is not None for c in cells) and all(
                c is None or (c.endswith("0") and not c.endswith(".0")) for c in cells):
            cells = [None if c is None else c[:-1] for c in cells]
    return True, ["NaN" if c is None else (" " if lead and not c.startswith("-") else "") + c
                  for c in cells]


def frame_to_string(columns: Dict[str, Sequence[object]], index: bool = True) -> str:
    """``pandas.DataFrame(columns).to_string(index=index)`` (with the index
    also its ``str``) for columns of text and floats over a 0..n−1 index:
    the name of a float column led by a space, each column right-aligned to
    its widest cell or name, one space between columns; with the index a
    left-aligned index column first and a space before each cell."""
    names = list(columns)
    n = len(columns[names[0]]) if names else 0
    strcols = []
    for name in names:
        numeric, cells = _format_column(columns[name], index)
        head = " " + name if numeric else name
        width = max([len(head)] + [len(c) for c in cells])
        strcols.append([head.rjust(width)] + [c.rjust(width) for c in cells])
    if index:
        labels = [str(i) for i in range(n)]
        width = max([len(s) for s in labels] + [0])
        strcols.insert(0, [" " * width] + [s.ljust(width) for s in labels])
    return "\n".join(" ".join(col[r] for col in strcols) for r in range(n + 1))
