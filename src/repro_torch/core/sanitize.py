"""``REPRO_SANITIZE=1``: the SessionView mutation tripwire.

Port of the view check of ``repro.core.sanitize``.  A published
``SessionView`` is frozen; ``query_view`` fingerprints the view's arrays
on first use and checks the fingerprint again at the entry and exit of
every query, raising ``SessionViewMutated`` the moment the bytes differ
(user code, a faulty verifier, an aliased buffer written by a later
ingest).  Free when the knob is off.

The reference's other check, ``maybe_install`` (``jax_debug_nans``), has
no counterpart: the port's hash chain is integer work.

The environment variable is read on every call; the fingerprint cache is
keyed by ``(id(view), view.version)`` and bounded.
"""
from __future__ import annotations

import hashlib
import os
from collections import OrderedDict

import numpy as np

_MAX_TRACKED_VIEWS = 64
_fingerprints: OrderedDict[tuple[int, int], str] = OrderedDict()


class SessionViewMutated(RuntimeError):
    """A published (immutable) SessionView changed underneath a query."""


def enabled() -> bool:
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


def view_fingerprint(view) -> str:
    """Content hash of a view's query-visible arrays (the reference's
    hash of the same fields, so equal views hash alike in both)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((view.version, view.n_docs, view.edge_threshold,
                   view.num_bands, view.rows_per_band)).encode())
    h.update(np.ascontiguousarray(view.labels).tobytes())
    h.update(np.ascontiguousarray(view.signatures).tobytes())
    if view.slot_of is not None:
        h.update(np.ascontiguousarray(view.slot_of).tobytes())
    if view.exact is not None:
        h.update(np.ascontiguousarray(view.exact.ids).tobytes())
        h.update(np.ascontiguousarray(view.exact.lengths).tobytes())
    for m in view.band_maps:
        h.update(str(len(m)).encode())
    return h.hexdigest()


def check_view(view, where: str) -> None:
    """Record or compare the view's fingerprint (no-op when disabled)."""
    if not enabled():
        return
    key = (id(view), view.version)
    fp = view_fingerprint(view)
    stored = _fingerprints.get(key)
    if stored is None:
        _fingerprints[key] = fp
        while len(_fingerprints) > _MAX_TRACKED_VIEWS:
            _fingerprints.popitem(last=False)
        return
    _fingerprints.move_to_end(key)
    if stored != fp:
        raise SessionViewMutated(
            f"SessionView v{view.version} content changed ({where}): "
            "published views are immutable; a writer mutated "
            "labels/signatures/rows in place instead of publishing a new "
            "view (REPRO_SANITIZE tripwire)")
