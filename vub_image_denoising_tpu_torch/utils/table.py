"""CSV tables written and read back as pandas writes and reads them, without
pandas (the card's machine may lack it).

- ``write_csv``: ``DataFrame.to_csv(index=False)``: floats as ``repr``, NaN
  as an empty field, ``\\n`` line ends.
- ``read_csv``: ``pandas.read_csv``'s column types: a column of integers
  is int, one of numbers (or integers with a missing field) is float, any
  other is text; a missing field is NaN.  Floats are parsed as pandas' C
  parser parses them (``pandas_float``), which keeps 17 digits, leading
  zeros included, so a value read back may differ from the one written.
- ``append_row``: read-merge-rewrite of one row, the union of the columns
  in order of appearance and the column types that ``pandas.concat`` of
  the old table and the row gives (an int column with a missing field, or
  with a float beside it, becomes float).
"""

import csv
import math
import os

NAN = float("nan")


def _missing(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def write_csv(path, header, rows):
    """Rows of values under ``header``, as pandas' ``to_csv(index=False)``."""
    def field(v):
        if isinstance(v, float):
            return "" if math.isnan(v) else repr(v)
        return v

    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows([field(v) for v in row] for row in rows)


_POW10 = [float(f"1e{k}") for k in range(309)]


def pandas_float(text: str) -> float:
    """``text`` as pandas' C parser reads a float field (its default
    ``float_precision``, ``precise_xstrtod``): at most 17 digits are
    accumulated, counting the integer part's and leading zeros, the rest
    is dropped, then the accumulated integer is scaled by a power of ten.
    So ``0.00012345678901234567`` reads as ``0.0001234567890123``."""
    t = text.strip()
    if not t or not (t.lstrip("+-")[:1].isdigit() or t.lstrip("+-")[:1] == "."):
        return float(t)  # inf, nan
    i, negative = 0, t[0] == "-"
    if t[0] in "+-":
        i = 1
    number, exponent, digits, max_digits = 0.0, 0, 0, 17
    while i < len(t) and t[i].isdigit():
        if digits < max_digits:
            number = number * 10.0 + int(t[i])
            digits += 1
        else:
            exponent += 1
        i += 1
    if i < len(t) and t[i] == ".":
        i += 1
        decimals = 0
        while digits < max_digits and i < len(t) and t[i].isdigit():
            number = number * 10.0 + int(t[i])
            i, digits, decimals = i + 1, digits + 1, decimals + 1
        while i < len(t) and t[i].isdigit():
            i += 1
        exponent -= decimals
    if negative:
        number = -number
    if i < len(t) and t[i] in "eE":
        exponent += int(t[i + 1:])
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _parse_column(fields):
    present = [v for v in fields if v != ""]
    for kind in (int, pandas_float):
        try:
            parsed = [kind(v) for v in present]
        except ValueError:
            continue
        if kind is int and len(present) == len(fields):
            return [int(v) for v in fields]
        return [pandas_float(v) if v != "" else NAN for v in fields]
    return [v if v != "" else NAN for v in fields]


def read_csv(path):
    """(header, columns): each column a list of typed values."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return header, {name: _parse_column([r[i] for r in body]) for i, name in enumerate(header)}


def _unify(values):
    """A merged column's values in the one type pandas gives it."""
    present = [v for v in values if not _missing(v)]
    numeric = all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in present)
    if numeric and (len(present) < len(values) or any(isinstance(v, float) for v in present)):
        return [float(v) for v in values]
    return values


def append_row(path, row):
    """Append ``row`` (column -> value) to the CSV at ``path``, creating it,
    as ``pd.concat([pd.read_csv(path), pd.DataFrame([row])]).to_csv(path,
    index=False)`` does."""
    header, columns, n = [], {}, 0
    if os.path.exists(path):
        header, columns = read_csv(path)
        n = len(next(iter(columns.values()), []))
    for name in row:
        if name not in columns:
            header.append(name)
            columns[name] = [NAN] * n
    for name in header:
        columns[name] = _unify(columns[name] + [row.get(name, NAN)])
    write_csv(path, header, zip(*(columns[name] for name in header)))
