"""Data loading: generic CSV, *compiled* (schema-specialized) CSV, and the
``flarecol`` binary columnar format.

Paper section 4.2: "Spark's code to read Parquet files is very generic,
resulting in undue overhead ... in reality they can be resolved by
generating specialized code.  In Flare, we implement compiled CSV and
Parquet readers that generate native code specialized to a given schema."

The three readers here mirror that experiment (Table 1):

* :func:`read_csv_generic`  -- row-at-a-time ``csv`` module reader with
  per-field dynamic dispatch through a parser table: the interpretive
  overhead being measured.
* :func:`read_csv_compiled` -- *runtime code generation*: we emit Python
  source specialized to the schema (unrolled per-column conversion,
  vectorized numpy parses, dictionary encoding inline), ``exec`` it, and
  run the result.  Same staging idea as Flare's LMS-generated C.
* ``flarecol``              -- a binary columnar format (Parquet-lite):
  raw little-endian buffers + a JSON footer; reading is ``np.frombuffer``
  per *requested* column, so projection is free.
"""
from __future__ import annotations

import io
import json
import os
import struct
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.relational import table as T

MAGIC = b"FLRC0001"

# ---------------------------------------------------------------------------
# CSV writing (for benchmark setup)
# ---------------------------------------------------------------------------


def to_csv(tbl: T.Table, path: str) -> None:
    names = tbl.schema.names
    decoded = [tbl.columns[n].decode() for n in names]
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for i in range(tbl.num_rows):
            f.write(",".join(str(c[i]) for c in decoded) + "\n")


# ---------------------------------------------------------------------------
# generic CSV reader (the overhead baseline)
# ---------------------------------------------------------------------------

_PARSERS: Dict[str, Callable[[str], object]] = {
    T.INT32: int, T.INT64: int, T.DATE: int,
    T.FLOAT32: float, T.FLOAT64: float,
    T.BOOL: lambda s: s == "True",
    T.STRING: str,
}


def read_csv_generic(path: str, schema: T.Schema,
                     columns: Optional[Sequence[str]] = None) -> T.Table:
    """Row-at-a-time reader with per-field dynamic dispatch.

    Deliberately structured like a generic framework reader: a parser
    function is looked up and invoked for every field of every row.
    """
    import csv

    keep = list(columns) if columns is not None else schema.names
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        idx = {name: header.index(name) for name in keep}
        parsers = {name: _PARSERS[schema[name].dtype] for name in keep}
        rows: Dict[str, List[object]] = {name: [] for name in keep}
        for row in reader:
            for name in keep:
                # dynamic dispatch per field -- the measured overhead
                rows[name].append(parsers[name](row[idx[name]]))
    data = {}
    for name in keep:
        f_ = schema[name]
        if f_.dtype == T.STRING:
            data[name] = np.asarray(rows[name], dtype=object)
        else:
            data[name] = np.asarray(rows[name],
                                    dtype=T.numpy_dtype(f_.dtype))
    return T.Table.from_arrays(
        data, dtypes={n: schema[n].dtype for n in keep
                      if schema[n].dtype != T.STRING},
        domains={n: schema[n].domain for n in keep})


# ---------------------------------------------------------------------------
# compiled CSV reader (runtime codegen specialized to the schema)
# ---------------------------------------------------------------------------

_NP_PARSE = {
    T.INT32: "np.int32", T.INT64: "np.int64", T.DATE: "np.int32",
    T.FLOAT32: "np.float32", T.FLOAT64: "np.float64",
}


def generate_csv_reader_source(schema: T.Schema,
                               columns: Optional[Sequence[str]] = None
                               ) -> str:
    """Emit Python source for a reader specialized to ``schema``.

    The generated function does ONE pass to split the file into a column-
    major list matrix, then one *vectorized* conversion per kept column --
    no per-field dispatch, no dtype tests at runtime.  This is the LMS
    "generate code, then run it" move, with Python source standing in
    for C.
    """
    keep = list(columns) if columns is not None else schema.names
    all_names = schema.names
    ncols = len(all_names)
    # One flat split of the whole body (C speed), then per-column strided
    # slices (also C speed): zero per-row Python work.  The column count
    # and field positions are baked in -- that is the specialization.
    lines = [
        "def _read(path):",
        "    with open(path, 'r') as f:",
        "        f.readline()  # header (schema is compiled in)",
        "        body = f.read()",
        "    if body.endswith('\\n'): body = body[:-1]",
        "    flat = body.replace('\\n', ',').split(',')",
        f"    n = len(flat) // {ncols}",
        "    out = {}",
    ]
    for name in keep:
        i = all_names.index(name)
        dt = schema[name].dtype
        if dt == T.STRING:
            lines.append(
                f"    out[{name!r}] = np.asarray(flat[{i}::{ncols}], "
                f"dtype=object)")
        else:
            lines.append(
                f"    out[{name!r}] = np.asarray(flat[{i}::{ncols}], "
                f"dtype={_NP_PARSE[dt]})")
    lines.append("    return out")
    return "\n".join(lines)


_READER_CACHE: Dict[tuple, Callable] = {}


def read_csv_compiled(path: str, schema: T.Schema,
                      columns: Optional[Sequence[str]] = None) -> T.Table:
    keep = tuple(columns) if columns is not None else tuple(schema.names)
    key = (tuple((f.name, f.dtype) for f in schema), keep)
    fn = _READER_CACHE.get(key)
    if fn is None:
        src = generate_csv_reader_source(schema, keep)
        ns: Dict[str, object] = {"np": np}
        exec(compile(src, "<flare-generated-reader>", "exec"), ns)
        fn = ns["_read"]
        _READER_CACHE[key] = fn
    data = fn(path)
    return T.Table.from_arrays(
        data, dtypes={n: schema[n].dtype for n in keep
                      if schema[n].dtype != T.STRING},
        domains={n: schema[n].domain for n in keep})


# ---------------------------------------------------------------------------
# flarecol binary columnar format (Parquet-lite)
# ---------------------------------------------------------------------------


def write_flarecol(tbl: T.Table, path: str) -> None:
    """Layout: MAGIC | 8-byte footer offset | column buffers | JSON footer."""
    meta = {"num_rows": tbl.num_rows, "columns": []}
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", 0))  # placeholder for footer offset
        for fld in tbl.schema:
            col = tbl.columns[fld.name]
            buf = np.ascontiguousarray(col.data).tobytes()
            meta["columns"].append({
                "name": fld.name, "dtype": fld.dtype,
                "domain": fld.domain, "unique": fld.unique,
                "offset": f.tell(), "nbytes": len(buf),
                "np_dtype": str(col.data.dtype),
                "dictionary": list(col.dictionary) if col.dictionary else None,
            })
            f.write(buf)
        footer_off = f.tell()
        f.write(json.dumps(meta).encode())
        f.seek(len(MAGIC))
        f.write(struct.pack("<Q", footer_off))


def read_flarecol(path: str,
                  columns: Optional[Sequence[str]] = None) -> T.Table:
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path} is not a flarecol file")
        (footer_off,) = struct.unpack("<Q", f.read(8))
        f.seek(footer_off)
        meta = json.loads(f.read().decode())
        cols: Dict[str, T.Column] = {}
        fields: List[T.Field] = []
        for cm in meta["columns"]:
            if columns is not None and cm["name"] not in columns:
                continue  # projection: untouched columns are never read
            f.seek(cm["offset"])
            raw = f.read(cm["nbytes"])
            arr = np.frombuffer(raw, dtype=np.dtype(cm["np_dtype"])).copy()
            d = tuple(cm["dictionary"]) if cm["dictionary"] else None
            cols[cm["name"]] = T.Column(arr, cm["dtype"], d)
            fields.append(T.Field(cm["name"], cm["dtype"], cm["domain"],
                                  cm.get("unique", False)))
    return T.Table(cols, T.Schema(fields))
