"""repro_torch.persist -- the disk tier under the in-memory caches.

``ArtifactStore`` is the public entry point::

    store = persist.ArtifactStore("/var/cache/flare")
    compiled = df.lower(engine="compiled", native=True).compile(
        persist=store)

or ambiently, via the environment::

    FLARE_CACHE_DIR=/var/cache/flare python serve.py

See :mod:`repro_torch.persist.store` for the container format and
:mod:`repro_torch.persist.executable` for what a compiled template's
artifact carries (its kernel units).
"""
from repro_torch.persist.store import (  # noqa: F401
    ArtifactStore,
    CACHE_DIR_ENV,
    FORMAT_VERSION,
    TierStats,
    default_store,
    envelope,
    index_digest,
    stable_digest,
)
from repro_torch.persist.executable import (  # noqa: F401
    PERSISTABLE_ENGINES,
    plan_persistable,
)

__all__ = [
    "ArtifactStore", "CACHE_DIR_ENV", "FORMAT_VERSION", "TierStats",
    "default_store", "envelope", "index_digest", "stable_digest",
    "PERSISTABLE_ENGINES", "plan_persistable",
]
