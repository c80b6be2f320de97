"""Content-addressed fingerprints for captured Python functions.

Plan nodes that carry a user function (``expr.Udf``, ``MapBatches``,
``IterativeKernel``) need a stable identity for compile-cache keys.
The historical convention was ``name@id(fn)`` -- the CPython object
address -- which has two failure modes:

* **stale hit**: a function is GC'd and a *different* function is
  allocated at the same address; the new plan silently reuses the old
  compiled executable (wrong results, no error),
* **cross-process miss**: ``id()`` never matches across processes, so
  the persistent executable store had to refuse every UDF plan as
  ``unsupported``.

:func:`fn_token` replaces the address with a sha256 over what the
function will actually *do* when traced: its bytecode, its constants
(recursing into nested code objects -- lambdas and comprehensions),
its default arguments, and the current values of its closure cells.
Two textually identical definitions hash equal; editing a constant,
the body, or a captured variable changes the token.  Closure values
are hashed *by value at fingerprint time*, which is exactly the cache
semantics a compiled template gives them (they are baked in).
"""
from __future__ import annotations

import hashlib
import types
from typing import Any

#: Token length in hex chars (64 bits of sha256 -- collision-safe for
#: cache-key use, short enough for readable fingerprints).
TOKEN_HEX = 16


def _feed(h: "hashlib._Hash", tag: str, data: bytes) -> None:
    h.update(tag.encode())
    h.update(len(data).to_bytes(8, "little"))
    h.update(data)


def _hash_value(h: "hashlib._Hash", v: Any, depth: int = 0) -> None:
    """Mix one constant / closure value into the running hash."""
    if depth > 8:  # defensive: deeply nested captures degrade to type name
        _feed(h, "deep", type(v).__name__.encode())
        return
    if isinstance(v, types.CodeType):
        _hash_code(h, v, depth + 1)
    elif isinstance(v, types.FunctionType):
        _feed(h, "fn", b"")
        _hash_fn(h, v, depth + 1)
    elif isinstance(v, (tuple, frozenset, list)):
        items = sorted(v, key=repr) if isinstance(v, frozenset) else v
        _feed(h, type(v).__name__, str(len(items)).encode())
        for item in items:
            _hash_value(h, item, depth + 1)
    elif isinstance(v, dict):
        _feed(h, "dict", str(len(v)).encode())
        for k in sorted(v, key=repr):
            _hash_value(h, k, depth + 1)
            _hash_value(h, v[k], depth + 1)
    elif isinstance(v, (type(None), bool, int, float, complex, str,
                        bytes)):
        _feed(h, "lit", repr(v).encode())
    elif hasattr(v, "tobytes"):  # ndarray-likes: hash the buffer
        try:
            _feed(h, "buf", v.tobytes())
            _feed(h, "bufmeta", f"{getattr(v, 'dtype', '')}"
                                f"{getattr(v, 'shape', '')}".encode())
            return
        except Exception:
            pass
        _feed(h, "obj", _stable_repr(v).encode())
    else:
        _feed(h, "obj", _stable_repr(v).encode())


def _stable_repr(v: Any) -> str:
    """repr() with the ``0x7f...`` address stripped from default object
    reprs -- an address inside a repr would reintroduce the id() bug."""
    r = repr(v)
    if " at 0x" in r:
        r = f"<{type(v).__module__}.{type(v).__qualname__}>"
    return r


def _hash_code(h: "hashlib._Hash", code: types.CodeType,
               depth: int = 0) -> None:
    _feed(h, "co_code", code.co_code)
    _feed(h, "co_names", repr(code.co_names).encode())
    _feed(h, "co_varnames",
          repr(code.co_varnames[:code.co_argcount]).encode())
    _feed(h, "co_consts", str(len(code.co_consts)).encode())
    for c in code.co_consts:
        _hash_value(h, c, depth + 1)


def _hash_fn(h: "hashlib._Hash", fn: types.FunctionType,
             depth: int = 0) -> None:
    _hash_code(h, fn.__code__, depth)
    _feed(h, "defaults", b"")
    _hash_value(h, fn.__defaults__, depth + 1)
    _hash_value(h, fn.__kwdefaults__, depth + 1)
    cells = fn.__closure__ or ()
    _feed(h, "closure", str(len(cells)).encode())
    for name, cell in zip(fn.__code__.co_freevars, cells):
        _feed(h, "freevar", name.encode())
        try:
            _hash_value(h, cell.cell_contents, depth + 1)
        except ValueError:  # empty cell (recursive def mid-creation)
            _feed(h, "emptycell", b"")


def fn_token(fn: Any) -> str:
    """A ``TOKEN_HEX``-char content hash of ``fn``.

    For plain Python functions the token covers bytecode, constants,
    argument defaults and closure-cell values.  Bound methods hash the
    underlying function plus the receiver; other callables (callable
    objects, builtins) fall back to module-qualified name + a stable
    repr of the instance -- addressable, if coarser than bytecode.
    """
    h = hashlib.sha256()
    if isinstance(fn, types.MethodType):
        _feed(h, "method", b"")
        _hash_fn(h, fn.__func__, 0)
        _hash_value(h, fn.__self__, 1)
    elif isinstance(fn, types.FunctionType):
        _hash_fn(h, fn, 0)
    else:
        _feed(h, "callable",
              f"{type(fn).__module__}.{type(fn).__qualname__}".encode())
        _feed(h, "callable_repr", _stable_repr(fn).encode())
        call = getattr(type(fn), "__call__", None)
        if isinstance(call, types.FunctionType):
            _hash_fn(h, call, 1)
    return h.hexdigest()[:TOKEN_HEX]
