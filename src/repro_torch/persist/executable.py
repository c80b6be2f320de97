"""The codec of a compiled template's store artifact.

PyTorch runs a template's lowered function eagerly, so the port has no
whole-query executable to serialize.  What a compile pays for, and what
an ``exec`` artifact therefore carries, is the template's kernel units:
the CUDA sources its native fragments generate and the sm_90a libraries
nvcc built from them.  Two payload tiers ride in one artifact, as in the
JAX package (``repro.persist.executable``):

* **native** -- each unit's shared library, machine code for one CUDA
  toolkit and one device.  Loading writes the bytes to a file named by
  their hash and opens it with ``ctypes``
  (``repro_torch.kernels.cuda_build.load_library``): no nvcc.  Valid only
  under a full version-envelope match.
* **portable** -- each unit's CUDA source.  It also validates the
  artifact: the sources the plan generates now must equal the stored
  ones, or the artifact is stale (a ``version_miss``).  On an envelope
  miss the units are built again from these sources with nvcc.

The plan's Python function is lowered again on every load (a plan walk
that builds closures, no device work); the artifact's layout metadata
(argument and output counts, param specs) must match it.  A plain
``compiled`` template and its batched programs have no units: their
artifact carries only that metadata, and a hit saves nothing but the
check that the template was compiled before.

Plans that capture Python functions (``expr.Udf``, ``MapBatches``,
``IterativeKernel``) fingerprint the function *content*
(:mod:`repro_torch.core.fnhash`), so their cache keys are stable across
processes.  The ``@hexaddr`` regex below refuses any fingerprint that
embeds process-local identity, so such a plan is counted
``unsupported`` instead of persisted under a key that could serve a
stale closure.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Sequence, Tuple

#: Engines whose compiled templates can be persisted.  The interpreted
#: engines and ``stage`` have no compiled artifact at all.
PERSISTABLE_ENGINES = ("compiled", "compiled-native")

#: ``name@processlocalid`` markers in plan/expr fingerprints.
_LOCAL_ID = re.compile(r"@[0-9a-f]+[,)\]]")


def plan_persistable(p: Any) -> Tuple[bool, str]:
    """Can this plan's compiled form be addressed across processes?

    UDF / MapBatches / IterativeKernel plans are admitted: their
    fingerprints carry content hashes (``#token``), not addresses.  Only
    a fingerprint that still embeds ``@hexaddr`` process-local identity
    is refused.
    """
    if _LOCAL_ID.search(p.fingerprint()):
        return False, ("plan fingerprint embeds process-local function "
                       "identity (udf)")
    return True, "ok"


def unit_list(sources: Sequence[str]) -> List[str]:
    """A template's distinct kernel units in artifact order."""
    return sorted(set(sources))


def pack_units(units: Sequence[str], libraries: Sequence[bytes]
               ) -> Tuple[Dict[str, Any], List[bytes]]:
    """The artifact's unit metadata and its two sections: ``[native,
    portable]`` -- the libraries (empty when none was built) and the
    sources, each concatenated, with their lengths in the metadata."""
    texts = [s.encode() for s in units]
    meta = {"units": [len(t) for t in texts],
            "libraries": [len(b) for b in libraries]}
    return meta, [b"".join(libraries), b"".join(texts)]


def _split(blob: bytes, lens: Any) -> List[bytes]:
    if (not isinstance(lens, list)
            or any(not isinstance(n, int) or n < 0 for n in lens)
            or sum(lens) != len(blob)):
        raise ValueError("bad unit table")
    out, off = [], 0
    for n in lens:
        out.append(blob[off:off + n])
        off += n
    return out


def unpack_units(meta: Dict[str, Any], sections: Sequence[bytes]
                 ) -> Tuple[List[str], List[bytes]]:
    """Inverse of :func:`pack_units`: ``(sources, libraries)``.  Raises
    ``ValueError`` on a malformed table (the caller counts it corrupt)."""
    if len(sections) != 2:
        raise ValueError("expected native + portable sections")
    libraries = _split(sections[0], meta.get("libraries"))
    try:
        sources = [t.decode() for t in _split(sections[1],
                                               meta.get("units"))]
    except UnicodeDecodeError:
        raise ValueError("undecodable unit source") from None
    if libraries and len(libraries) != len(sources):
        raise ValueError("one library per unit")
    return sources, libraries
