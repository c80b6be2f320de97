"""The on-disk artifact store: compiled state that survives restarts.

The in-memory :class:`repro_torch.core.stages.CompileCache` and
:class:`repro_torch.core.engines.IndexCache` die with the process, so
every cold start re-pays plan lowering, an nvcc build of every kernel
unit and every join-index build.  This module is the second tier under
both caches: a content-addressed directory of versioned artifact files,
written atomically, with per-tier hit/miss/evict/corrupt telemetry.

Store layout (under ``ArtifactStore(root)``)::

    <root>/torch-v1/exec/<digest>.flare    # kernel units + layout metadata
    <root>/torch-v1/index/<digest>.flare   # build-side join indexes

The JAX package keeps its artifacts under ``<root>/v1/``, so both
packages may share one ``FLARE_CACHE_DIR`` without reading each other's
files.

Every artifact file is self-describing::

    magic "FLRA1\\n" | u32 header_len | header JSON | payload sections

The header carries the *version envelope* (artifact-format version, the
torch and CUDA versions, the nvcc release, the device name, compute
capability and count, the device dtype policy), per-section lengths, and
a sha256 over the payload.  A mismatched envelope is a ``version_miss``
(stale artifacts invalidate instead of mis-executing); a short file, bad
magic, undecodable header or checksum failure is ``corrupt`` -- both
fall back to a plain cache miss, never an error surfaced to the query.

Digests are *content* addresses: the exec digest covers the template key
(plan fingerprint, engine, table metadata incl. dictionary contents);
the index digest covers the raw key-column bytes, so changed data can
never be served a stale index.  Cache keys must therefore be
process-independent -- see :func:`stable_digest` (no builtin ``hash``,
which is salted per process).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import trace as OT
from repro_torch.resilience import faults as FZ

#: Bump on any incompatible change to the container or section layout.
FORMAT_VERSION = 1

#: Environment variable naming the default store directory.  When set,
#: every :class:`repro_torch.core.dataframe.FlareContext` (and the
#: process-wide default caches) persists through it automatically.
CACHE_DIR_ENV = "FLARE_CACHE_DIR"

_MAGIC = b"FLRA1\n"

#: Artifact kinds = store tiers.  ``exec`` holds serialized compiled
#: query executables, ``index`` holds build-side join indexes.
KINDS = ("exec", "index")


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def stable_digest(*parts: Any) -> str:
    """Process-independent content digest of ``parts``.

    ``repr`` over tuples of str/int/bool/float is deterministic across
    processes (unlike builtin ``hash``, which is salted); anything
    already-bytes hashes raw.  This is what makes one process's cache
    key find another process's artifact.
    """
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, bytes):
            h.update(b"\x00b")
            h.update(p)
        else:
            h.update(b"\x00r")
            h.update(repr(p).encode())
    return h.hexdigest()


def envelope() -> Dict[str, Any]:
    """The current process's artifact compatibility envelope.

    An exec artifact's native tier is sm_90a machine code built by one
    nvcc for one CUDA runtime; any drift here means the units must be
    rebuilt from their sources, not trusted.  ``device_dtypes`` is the
    32-bit device-dtype policy (``repro_torch.core.lower.TORCH_OF``), the
    JAX package's ``x64`` flag.  ``nvcc`` is the release of the toolkit
    this process builds units with (None without a card or a toolkit),
    and ``nvcc_flags`` the flags it builds them with
    (``cuda_build.NVCC_FLAGS``: target, optimisation, ``--fmad``), so a
    unit built under other flags is never loaded as machine code.
    Index artifacts only check ``format`` (their arrays are portable) --
    see :meth:`ArtifactStore.load`.
    """
    import torch

    from repro_torch.core.lower import TORCH_OF  # lazy: core imports persist
    from repro_torch.kernels import cuda_build as CB

    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        device = props.name
        capability = f"{props.major}.{props.minor}"
        count = torch.cuda.device_count()
        nvcc = CB.nvcc_release()
    else:
        device, capability, count, nvcc = "cpu", None, 0, None
    return {
        "format": FORMAT_VERSION,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": nvcc,
        "nvcc_flags": " ".join(CB.NVCC_FLAGS),
        "device": device,
        "capability": capability,
        "device_count": count,
        "device_dtypes": sorted({str(t).replace("torch.", "")
                                 for t in TORCH_OF.values()}),
    }


#: Envelope keys an index artifact must match (its int32 arrays are
#: toolchain-independent; only the container format gates them).
_INDEX_ENVELOPE_KEYS = ("format",)


class StoreCorrupt(Exception):
    """Internal: artifact file failed structural validation."""


class StoreVersionMiss(Exception):
    """Internal: artifact envelope does not match this process."""


@dataclasses.dataclass
class TierStats:
    """Telemetry for one store tier (``exec`` or ``index``).

    ``hits``/``misses`` mirror the in-memory caches' counters one level
    down; ``version_miss`` and ``corrupt`` are the two invalidation
    paths (both also count as misses to the caller); ``unsupported``
    counts compile artifacts that cannot be persisted (non-exportable
    engine, process-local UDFs); ``errors`` counts unexpected
    serialization failures that were swallowed into a recompile.

    ``quarantined`` counts corrupt artifacts renamed aside (to
    ``<name>.flare.quarantine``) for post-mortem instead of deleted
    blind; ``unlink_raced`` counts unlink/rename targets that were
    already gone -- a concurrent reader promoted them or a second
    evicting process won the race (benign, but worth seeing).
    """

    hits: int = 0
    misses: int = 0
    writes: int = 0
    corrupt: int = 0
    version_miss: int = 0
    unsupported: int = 0
    errors: int = 0
    evicted: int = 0
    quarantined: int = 0
    unlink_raced: int = 0
    bytes_written: int = 0
    bytes_read: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "hits": self.hits, "misses": self.misses,
            "writes": self.writes, "corrupt": self.corrupt,
            "version_miss": self.version_miss,
            "unsupported": self.unsupported, "errors": self.errors,
            "evicted": self.evicted,
            "quarantined": self.quarantined,
            "unlink_raced": self.unlink_raced,
            "bytes_written": self.bytes_written,
            "bytes_read": self.bytes_read,
            "hit_rate": round(self.hit_rate, 4),
        }


#: Every live store, for the process-wide telemetry aggregate
#: (``engines.cache_stats()`` folds their :class:`TierStats` into the
#: per-kind snapshots as a nested ``disk`` breakdown).
_LIVE_STORES: "weakref.WeakSet[ArtifactStore]" = weakref.WeakSet()


def live_store_stats() -> Dict[str, Dict[str, Any]]:
    """Summed :class:`TierStats` across every live store, per tier,
    plus the live-store count under each tier's ``stores`` key.  Zeros
    when no store is live -- the schema is stable either way."""
    totals = {k: TierStats() for k in KINDS}
    n = 0
    for store in list(_LIVE_STORES):
        n += 1
        for k in KINDS:
            src = store.stats[k]
            dst = totals[k]
            for f in dataclasses.fields(TierStats):
                setattr(dst, f.name,
                        getattr(dst, f.name) + getattr(src, f.name))
    out = {k: totals[k].to_dict() for k in KINDS}
    for d in out.values():
        d["stores"] = n
    return out


class ArtifactStore:
    """A disk-backed artifact cache shared by every process pointing at
    the same directory.

    ``save``/``load`` address artifacts by (kind, digest).  Writes are
    atomic (temp file + ``os.replace`` in the same directory), so a
    concurrent reader sees either the complete old file, the complete
    new file, or nothing -- never a torn artifact.  ``limit_bytes``
    turns on LRU eviction (by mtime) after each write.

    The store raises nothing on the read path: any malformed or
    incompatible artifact degrades to a miss and is counted in
    :class:`TierStats`.
    """

    def __init__(self, root: os.PathLike, limit_bytes: Optional[int] = None):
        self.root = os.path.abspath(os.fspath(root))
        self.limit_bytes = limit_bytes
        self._dirs = {k: os.path.join(self.root, f"torch-v{FORMAT_VERSION}",
                                      k)
                      for k in KINDS}
        for d in self._dirs.values():
            os.makedirs(d, exist_ok=True)
        self.stats: Dict[str, TierStats] = {k: TierStats() for k in KINDS}
        self._envelope = None  # resolved lazily: CUDA init is not free
        _LIVE_STORES.add(self)

    # -- paths ---------------------------------------------------------------

    def path_for(self, kind: str, digest: str) -> str:
        if kind not in self._dirs:
            raise ValueError(f"unknown artifact kind {kind!r}; "
                             f"one of {KINDS}")
        return os.path.join(self._dirs[kind], f"{digest}.flare")

    def tier(self, kind: str) -> TierStats:
        return self.stats[kind]

    def current_envelope(self) -> Dict[str, Any]:
        if self._envelope is None:
            self._envelope = envelope()
        return self._envelope

    # -- write path ----------------------------------------------------------

    def save(self, kind: str, digest: str, meta: Dict[str, Any],
             sections: Sequence[bytes]) -> Optional[str]:
        """Write one artifact (atomic, write-through).  ``meta`` must be
        JSON-serializable; ``sections`` are opaque byte payloads
        recovered in order by :meth:`load`.  Returns the path, or None
        if the write failed (counted, never raised)."""
        path = self.path_for(kind, digest)
        payload = b"".join(sections)
        header = {
            "kind": kind,
            "digest": digest,
            "envelope": self.current_envelope(),
            "meta": meta,
            "sections": [len(s) for s in sections],
            "sha256": _sha256(payload),
        }
        hdr = json.dumps(header, sort_keys=True).encode()
        blob = (_MAGIC + len(hdr).to_bytes(4, "little") + hdr + payload)
        with OT.span("store.save", tier=kind, digest=digest[:12],
                     nbytes=len(blob)) as sp:
            try:
                # trust boundary: disk writes fail for infrastructural
                # reasons (ENOSPC, permissions); injected faults take
                # the same swallowed-into-recompile path below
                FZ.fault_point("persist.save", tier=kind)
                fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                           prefix=".tmp-",
                                           suffix=".flare")
                try:
                    with os.fdopen(fd, "wb") as f:
                        f.write(blob)
                    # atomic: no reader sees a torn file
                    os.replace(tmp, path)
                except BaseException:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                    raise
            except OSError:
                self.stats[kind].errors += 1
                sp.set(outcome="error")
                return None
            self.stats[kind].writes += 1
            self.stats[kind].bytes_written += len(blob)
            sp.set(outcome="written")
        if self.limit_bytes is not None:
            self.evict(self.limit_bytes)
        return path

    # -- read path -----------------------------------------------------------

    def _parse(self, blob: bytes, kind: str
               ) -> Tuple[Dict[str, Any], List[bytes]]:
        if not blob.startswith(_MAGIC):
            raise StoreCorrupt("bad magic")
        off = len(_MAGIC)
        if len(blob) < off + 4:
            raise StoreCorrupt("truncated header length")
        hlen = int.from_bytes(blob[off:off + 4], "little")
        off += 4
        if len(blob) < off + hlen:
            raise StoreCorrupt("truncated header")
        try:
            header = json.loads(blob[off:off + hlen].decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise StoreCorrupt(f"undecodable header: {e}") from None
        off += hlen
        if not isinstance(header, dict) or header.get("kind") != kind:
            raise StoreCorrupt("header kind mismatch")
        lens = header.get("sections")
        if (not isinstance(lens, list)
                or any(not isinstance(n, int) or n < 0 for n in lens)):
            raise StoreCorrupt("bad section table")
        payload = blob[off:]
        if len(payload) != sum(lens):
            raise StoreCorrupt("truncated payload")
        if _sha256(payload) != header.get("sha256"):
            raise StoreCorrupt("payload checksum mismatch")
        sections = []
        for n in lens:
            sections.append(payload[:n])
            payload = payload[n:]
        return header, sections

    def _check_envelope(self, header: Dict[str, Any], kind: str,
                        envelope_keys: Optional[Tuple[str, ...]] = None
                        ) -> None:
        env = header.get("envelope")
        if not isinstance(env, dict):
            raise StoreCorrupt("missing envelope")
        want = self.current_envelope()
        if envelope_keys is None:
            envelope_keys = (_INDEX_ENVELOPE_KEYS if kind == "index"
                             else tuple(want))
        for k in envelope_keys:
            if env.get(k) != want[k]:
                raise StoreVersionMiss(
                    f"envelope field {k!r}: artifact {env.get(k)!r} "
                    f"!= process {want[k]!r}")

    def load(self, kind: str, digest: str,
             envelope_keys: Optional[Tuple[str, ...]] = None
             ) -> Optional[Tuple[Dict[str, Any], List[bytes]]]:
        """Read an artifact; returns ``(header, sections)`` or None.

        Every failure mode degrades to None: absent file (``misses``),
        structural damage (``corrupt`` -- the bad file is renamed to
        ``<name>.flare.quarantine`` so it is rebuilt, not
        re-tripped-over, and the evidence survives for post-mortem),
        incompatible envelope (``version_miss``).  A hit touches the
        file's mtime for LRU eviction.

        ``envelope_keys`` narrows the envelope fields checked here: the
        exec loader passes ``("format",)`` so it can inspect both
        payload tiers itself (the native tier needs a full match, the
        portable sources only the format) and calls :meth:`demote_hit`
        if neither tier is usable.
        """
        st = self.stats[kind]
        path = self.path_for(kind, digest)
        with OT.span("store.load", tier=kind, digest=digest[:12]) as sp:
            try:
                with open(path, "rb") as f:
                    blob = f.read()
            except OSError:
                st.misses += 1
                sp.set(outcome="miss")
                return None
            try:
                # trust boundary: anything read off disk is untrusted
                # until parsed + checksummed; injected corruption takes
                # the same quarantine path a real torn file would
                FZ.fault_point("persist.load", tier=kind)
                header, sections = self._parse(blob, kind)
                self._check_envelope(header, kind, envelope_keys)
            except StoreCorrupt:
                st.corrupt += 1
                st.misses += 1
                sp.set(outcome="corrupt")
                self._quarantine(kind, path)
                return None
            except StoreVersionMiss:
                st.version_miss += 1
                st.misses += 1
                sp.set(outcome="version_miss")
                return None
            st.hits += 1
            st.bytes_read += len(blob)
            sp.set(outcome="hit", nbytes=len(blob))
        try:
            os.utime(path)  # LRU recency
        except OSError:
            pass
        return header, sections

    def _quarantine(self, kind: str, path: str) -> None:
        """Move a corrupt artifact aside instead of deleting it blind.

        ``os.replace`` is atomic and keeps the bytes for post-mortem;
        the ``.quarantine`` suffix excludes the file from
        :meth:`entries`/:meth:`nbytes`/:meth:`evict`, so quarantined
        junk can never wedge the live store.  A concurrent loader may
        have quarantined (or a writer replaced) the path first -- that
        race is benign and counted as ``unlink_raced``.
        """
        st = self.stats[kind]
        try:
            os.replace(path, path + ".quarantine")
            st.quarantined += 1
        except FileNotFoundError:
            st.unlink_raced += 1
        except OSError:
            # rename refused (e.g. exotic filesystem): fall back to a
            # race-safe unlink so the corrupt file is at least rebuilt
            try:
                os.unlink(path)
            except FileNotFoundError:
                st.unlink_raced += 1
            except OSError:
                st.errors += 1

    def demote_hit(self, kind: str, reason: str) -> None:
        """Retroactively turn the last :meth:`load` hit into a miss.

        The exec loader validates the two payload tiers *after* the
        container-level load succeeded; when neither tier is usable in
        this process the artifact was not actually served, and the
        telemetry must say so.  ``reason`` is ``"version_miss"`` or
        ``"corrupt"``.
        """
        st = self.stats[kind]
        st.hits = max(0, st.hits - 1)
        st.misses += 1
        if reason == "corrupt":
            st.corrupt += 1
        else:
            st.version_miss += 1

    # -- maintenance ---------------------------------------------------------

    def entries(self, kind: Optional[str] = None) -> int:
        kinds = (kind,) if kind else KINDS
        return sum(len([f for f in os.listdir(self._dirs[k])
                        if f.endswith(".flare")]) for k in kinds)

    def nbytes(self) -> int:
        total = 0
        for d in self._dirs.values():
            for f in os.listdir(d):
                if f.endswith(".flare"):
                    try:
                        total += os.path.getsize(os.path.join(d, f))
                    except OSError:
                        pass
        return total

    def evict(self, limit_bytes: int) -> int:
        """Remove least-recently-used artifacts until the store fits in
        ``limit_bytes``.  Returns the number evicted."""
        files = []
        for k, d in self._dirs.items():
            for f in os.listdir(d):
                if not f.endswith(".flare"):
                    continue
                p = os.path.join(d, f)
                try:
                    stt = os.stat(p)
                except OSError:
                    continue
                files.append((stt.st_mtime, stt.st_size, k, p))
        total = sum(sz for _, sz, _, _ in files)
        evicted = 0
        for _, sz, k, p in sorted(files):
            if total <= limit_bytes:
                break
            try:
                os.unlink(p)
            except FileNotFoundError:
                # a second evicting process (or a corrupt-quarantine)
                # got there first: the bytes are gone either way, so
                # count them against the total and move on
                self.stats[k].unlink_raced += 1
                total -= sz
                continue
            except OSError:
                continue
            total -= sz
            evicted += 1
            self.stats[k].evicted += 1
        return evicted

    def clear(self) -> None:
        for k, d in self._dirs.items():
            for f in os.listdir(d):
                if f.endswith(".flare"):
                    try:
                        os.unlink(os.path.join(d, f))
                    except FileNotFoundError:
                        self.stats[k].unlink_raced += 1
                    except OSError:
                        pass

    def stats_dict(self) -> Dict[str, Any]:
        """Stable telemetry snapshot: one
        :class:`TierStats` dict per tier plus store-level size info."""
        out: Dict[str, Any] = {k: self.stats[k].to_dict() for k in KINDS}
        out["root"] = self.root
        out["entries"] = {k: self.entries(k) for k in KINDS}
        out["nbytes"] = self.nbytes()
        return out

    def __repr__(self):
        tiers = ", ".join(
            f"{k}: {s.hits}h/{s.misses}m/{s.writes}w"
            for k, s in self.stats.items())
        return f"ArtifactStore({self.root!r}; {tiers})"


#: One store object per (root, limit) this process has resolved from
#: the environment, so telemetry accumulates instead of scattering
#: across throwaway handles.
_DEFAULT_STORES: Dict[Tuple, ArtifactStore] = {}


def default_store() -> Optional[ArtifactStore]:
    """The store named by ``$FLARE_CACHE_DIR``, or None.

    ``$FLARE_CACHE_LIMIT_MB`` (optional) caps the directory size with
    LRU eviction.  Re-resolved per call (tests and subprocesses flip
    the environment around single contexts) but memoized per
    configuration, so repeat calls share one stats-accumulating handle.
    """
    root = os.environ.get(CACHE_DIR_ENV)
    if not root:
        return None
    limit = os.environ.get("FLARE_CACHE_LIMIT_MB")
    limit_bytes = int(float(limit) * 2 ** 20) if limit else None
    key = (os.path.abspath(root), limit_bytes)
    store = _DEFAULT_STORES.get(key)
    if store is None:
        store = _DEFAULT_STORES[key] = ArtifactStore(
            root, limit_bytes=limit_bytes)
    return store


# ---------------------------------------------------------------------------
# content digests for the two tiers
# ---------------------------------------------------------------------------


def index_digest(tbl: Any, key_cols: Tuple[str, ...],
                 doms: Tuple[int, ...]) -> str:
    """Content address of a build-side join index: the raw bytes of the
    key columns plus the combine domains.  Data-derived, so a reloaded
    table with different contents can never hit a stale index -- there
    is no separate invalidation rule to get wrong."""
    parts: List[Any] = ["index", FORMAT_VERSION, tuple(key_cols),
                        tuple(doms), tbl.num_rows]
    h = hashlib.sha256()
    h.update(repr(parts).encode())
    for c in key_cols:
        arr = np.ascontiguousarray(tbl[c])
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()
