"""Row tables as the JAX package's tools write them through pandas, with the
standard library only: CSV files through ``csv`` and SQLite tables through
``sqlite3``. A table is a list of dicts; its columns are the keys in order of
first appearance (``pandas.DataFrame(rows)``), a key a row lacks is empty."""

from __future__ import annotations

import csv
import sqlite3
from typing import Dict, List, Optional, Sequence

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
