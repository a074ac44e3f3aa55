"""Per-container memoization with content-fingerprint invalidation
(``lssp_tpu/utils/memo.py``).

Every prepared-state cache of the port follows one discipline: the cache
dict hangs off the matrix container itself (``A.<attr>``), every entry
keeps the full-content fingerprint it was built from (``A.<attr>_fp``,
by key), and a lookup validates against the CURRENT fingerprint, so any
in-place change of the container's buffers makes its entries stale.
Bounded caches are LRU: a hit moves the entry to the back, replacing an
existing key keeps its siblings, and only a new entry can push the oldest
out (a distributed entry pins device copies of the partitioned matrix and
the PC state).
"""
from __future__ import annotations

import zlib

import numpy as np


def checksum(a) -> int:
    """crc32 over the full bytes of an array (numpy, or anything
    ``np.asarray`` takes)."""
    return zlib.crc32(np.ascontiguousarray(np.asarray(a)))


def fingerprint(A):
    """Full-content fingerprint of a host container: shape, dtype and crc32
    of its values (``data``, or a BSR's ``blocks``) and a crc32 of every
    structure buffer (``indices``, ``indptr``, ``row``, ``col``), so an
    in-place change of any of them invalidates.  Sampling was rejected in
    the reference: it "silently validated a stale device matrix".  crc32
    also beat ``zlib.adler32`` on the 128³ CSR's 183 MB (57 against 81 ms
    in one CPU run).  None when the container has no such buffers (never
    matches)."""
    try:
        vals = getattr(A, "data", None)
        if vals is None:
            vals = getattr(A, "blocks", None)
        d = np.ascontiguousarray(np.asarray(vals))
        if d.dtype == object:
            return None
        parts = [d.shape, d.dtype.str, zlib.crc32(d)]
        for name in ("indices", "indptr", "row", "col"):
            buf = getattr(A, name, None)
            if buf is not None:
                parts.append(checksum(buf))
        return tuple(parts)
    except (TypeError, ValueError):
        return None


def memo_get(A, attr, key, fp):
    """The value stored under ``key`` in ``A.<attr>`` when its fingerprint
    equals ``fp``, else None (a miss or a stale entry).  A None ``fp``
    never matches.  A hit moves to the back of the LRU order."""
    cache = getattr(A, attr, None)
    fps = getattr(A, attr + "_fp", None)
    if cache is None or fps is None or fp is None or key not in cache:
        return None
    if fps.get(key) is None or fps[key] != fp:
        return None
    out = cache.pop(key)            # LRU touch: re-insert at the back
    cache[key] = out
    return out


def memo_put(A, attr, key, fp, out, bound=None) -> None:
    """Store ``out`` under ``key`` in ``A.<attr>`` with its fingerprint
    ``fp``, creating the cache on first use.  ``bound`` caps the entry
    count (the oldest go first); replacing an existing key evicts nothing.
    A container that takes no attributes is skipped: memoization is an
    optimization, not a contract."""
    try:
        cache = getattr(A, attr, None)
        if cache is None:
            cache = {}
            object.__setattr__(A, attr, cache)
            object.__setattr__(A, attr + "_fp", {})
        fps = getattr(A, attr + "_fp")
        if key in cache:
            cache.pop(key)
        elif bound is not None:
            while len(cache) >= bound:
                old = next(iter(cache))
                cache.pop(old)
                fps.pop(old, None)
        cache[key] = out
        fps[key] = fp
    except (AttributeError, TypeError):
        pass
