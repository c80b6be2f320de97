"""Columnar table runtime (host side, numpy).

Flare compiles queries against an in-memory columnar representation
(the paper's Fig. 3 loads CSV into `*_col[i]` arrays).  A ``Table`` is a
dict of ``Column`` objects, each a dense 1-D numpy array; the engines move
columns to the device as torch tensors.  Strings are dictionary-encoded at
load time (int32 codes plus a host-side dictionary) so that every string
operation the compiled engine sees is an integer operation.

Dates are stored as int32 ``yyyymmdd`` literals, matching the paper's
hand-written C for Q6 (``l_shipdate >= 19940101L``).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

#: Logical column dtypes understood by the planner.
INT32 = "int32"
INT64 = "int64"
FLOAT32 = "float32"
FLOAT64 = "float64"
BOOL = "bool"
DATE = "date"      # int32 yyyymmdd
STRING = "string"  # dictionary-encoded int32 codes

_NUMPY_OF = {
    INT32: np.int32,
    INT64: np.int64,
    FLOAT32: np.float32,
    FLOAT64: np.float64,
    BOOL: np.bool_,
    DATE: np.int32,
    STRING: np.int32,
}

NUMERIC_DTYPES = (INT32, INT64, FLOAT32, FLOAT64, DATE)


def numpy_dtype(dtype: str) -> np.dtype:
    return np.dtype(_NUMPY_OF[dtype])


def is_numeric(dtype: str) -> bool:
    return dtype in NUMERIC_DTYPES


@functools.lru_cache(maxsize=4096)
def dict_token(dictionary: Optional[Tuple[str, ...]]) -> str:
    """Process-independent digest of a string dictionary.

    Dictionary CONTENTS are baked into compiled programs (predicate
    LUTs, comparison codes), so template cache keys must cover them --
    and builtin ``hash`` (salted per process) would make those keys
    differ from process to process.  Empty/absent dictionaries share "".
    """
    if not dictionary:
        return ""
    h = hashlib.sha256()
    for s in dictionary:
        h.update(s.encode())
        h.update(b"\x00")
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class Field:
    """A named, typed column slot in a schema."""

    name: str
    dtype: str
    #: For dense integer key columns (TPC-H primary keys are 1..N), the
    #: exclusive upper bound of the key domain.  Lets the compiled engine
    #: aggregate by direct indexing instead of hashing (DESIGN.md section 3).
    domain: Optional[int] = None
    #: Declared key uniqueness (a primary-key declaration).  The join
    #: index cache relies on it for *filtered* build sides: a probe that
    #: lands on a unique key can validate the build row's filter mask
    #: post-probe exactly (DESIGN.md section 10).  Verified against the
    #: data when the index is built (engines.IndexCache).
    unique: bool = False

    def with_name(self, name: str) -> "Field":
        return Field(name, self.dtype, self.domain, self.unique)


class Schema:
    """Ordered collection of fields with name lookup."""

    def __init__(self, fields: Sequence[Field]):
        self.fields: Tuple[Field, ...] = tuple(fields)
        self._index: Dict[str, Field] = {f.name: f for f in self.fields}
        if len(self._index) != len(self.fields):
            raise ValueError("duplicate column names in schema")

    def __iter__(self):
        return iter(self.fields)

    def __len__(self):
        return len(self.fields)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __getitem__(self, name: str) -> Field:
        return self._index[name]

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def select(self, names: Sequence[str]) -> "Schema":
        return Schema([self._index[n] for n in names])

    def rename_prefixed(self, prefix: str) -> "Schema":
        return Schema([f.with_name(prefix + f.name) for f in self.fields])

    def __repr__(self):
        inner = ", ".join(f"{f.name}:{f.dtype}" for f in self.fields)
        return f"Schema({inner})"

    def __eq__(self, other):
        return isinstance(other, Schema) and self.fields == other.fields


@dataclasses.dataclass
class Column:
    """A single column: dense data plus (for strings) a dictionary.

    ``data`` is always a numpy array on the host; engines move it to device
    as needed.  For ``STRING`` columns ``data`` holds int32 codes indexing
    ``dictionary``.
    """

    data: np.ndarray
    dtype: str
    dictionary: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        want = numpy_dtype(self.dtype)
        if self.data.dtype != want:
            self.data = self.data.astype(want)
        if self.dtype == STRING and self.dictionary is None:
            raise ValueError("string column requires a dictionary")

    def __len__(self):
        return int(self.data.shape[0])

    def decode(self) -> np.ndarray:
        """Materialise strings (or pass numeric data through)."""
        if self.dtype == STRING:
            lut = np.asarray(self.dictionary, dtype=object)
            return lut[self.data]
        return self.data


def dictionary_encode(values: Iterable[str]) -> Column:
    arr = np.asarray(list(values), dtype=object)
    dictionary, codes = np.unique(arr, return_inverse=True)
    return Column(codes.astype(np.int32), STRING,
                  tuple(str(s) for s in dictionary))


class Table:
    """An immutable named-column table."""

    def __init__(self, columns: Mapping[str, Column],
                 schema: Optional[Schema] = None):
        self.columns: Dict[str, Column] = dict(columns)
        if not self.columns:
            raise ValueError("table needs at least one column")
        lengths = {len(c) for c in self.columns.values()}
        if len(lengths) != 1:
            raise ValueError(f"ragged columns: {lengths}")
        self.num_rows = lengths.pop()
        if schema is None:
            schema = Schema([Field(n, c.dtype) for n, c in self.columns.items()])
        self.schema = schema

    # -- construction helpers ------------------------------------------------

    @staticmethod
    def from_arrays(data: Mapping[str, "np.ndarray | Column"],
                    dtypes: Optional[Mapping[str, str]] = None,
                    domains: Optional[Mapping[str, int]] = None,
                    uniques: Optional[Iterable[str]] = None) -> "Table":
        cols: Dict[str, Column] = {}
        fields: List[Field] = []
        unique_set = set(uniques or ())
        for name, arr in data.items():
            if isinstance(arr, Column):
                col = arr
            elif (arr := np.asarray(arr)).dtype == object \
                    or arr.dtype.kind in ("U", "S"):
                col = dictionary_encode(arr)
            else:
                dtype = (dtypes or {}).get(name)
                if dtype is None:
                    kind = arr.dtype.kind
                    if kind == "f":
                        dtype = FLOAT64 if arr.dtype.itemsize == 8 else FLOAT32
                    elif kind in "iu":
                        dtype = INT64 if arr.dtype.itemsize == 8 else INT32
                    elif kind == "b":
                        dtype = BOOL
                    else:
                        raise TypeError(f"unsupported array dtype {arr.dtype}")
                col = Column(arr, dtype)
            cols[name] = col
            fields.append(Field(name, col.dtype, (domains or {}).get(name),
                                name in unique_set))
        return Table(cols, Schema(fields))

    # -- access ---------------------------------------------------------------

    def column(self, name: str) -> Column:
        return self.columns[name]

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name].data

    def dictionary(self, name: str) -> Optional[Tuple[str, ...]]:
        return self.columns[name].dictionary

    def head(self, n: int = 10) -> Dict[str, np.ndarray]:
        return {name: col.decode()[:n] for name, col in self.columns.items()}

    def to_pydict(self) -> Dict[str, list]:
        return {name: col.decode().tolist() for name, col in self.columns.items()}

    def nbytes(self) -> int:
        return sum(c.data.nbytes for c in self.columns.values())

    def __repr__(self):
        return f"Table(rows={self.num_rows}, {self.schema})"


def tables_from_numpy(spec: Mapping[str, Mapping[str, object]]
                      ) -> Dict[str, Table]:
    """Build tables from plain numpy dictionaries.

    ``spec`` maps table name -> ``{"columns": {name: ndarray},
    "dtypes": {name: dtype}, "dictionaries": {name: tuple-of-str},
    "domains": {name: int}, "uniques": [name, ...]}`` (all but
    ``columns`` optional).  A column listed in ``dictionaries`` holds
    int32 codes into that (sorted) dictionary.  This is how tables made
    by another program cross into this package without re-encoding.
    """
    out: Dict[str, Table] = {}
    for tname, t in spec.items():
        dtypes = dict(t.get("dtypes") or {})
        dicts = dict(t.get("dictionaries") or {})
        domains = dict(t.get("domains") or {})
        uniques = set(t.get("uniques") or ())
        cols: Dict[str, Column] = {}
        fields: List[Field] = []
        for name, arr in t["columns"].items():
            arr = np.asarray(arr)
            if name in dicts:
                col = Column(arr.astype(np.int32), STRING,
                             tuple(str(s) for s in dicts[name]))
            else:
                col = Table.from_arrays({name: arr}, dtypes).columns[name]
            cols[name] = col
            fields.append(Field(name, col.dtype, domains.get(name),
                                name in uniques))
        out[tname] = Table(cols, Schema(fields))
    return out
