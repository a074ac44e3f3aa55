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

``lookups`` counts every lookup by outcome: ``hit``, ``miss`` (no entry
under the key) and ``stale`` (an entry built from other contents: the
matrix changed in place, so the caller builds it all again).  A stale
lookup turns a request that reuses its set-up into a full set-up; the
counter is what shows it.

The fingerprint's CRC-32 is ``zlib.crc32``'s value on every route.  A
buffer of ``FOLD_MIN_BYTES`` or more takes the port's carry-less-multiply
fold (``native.crc32``, ``native/src/checksum.cpp``), several times zlib's
rate on the same bytes (zlib computes a few bytes a cycle from tables).  A
smaller buffer takes ``zlib.crc32``, since there the ctypes call would cost
more than it saves; so does every buffer where that library does not build
or load, or the CPU lacks the instruction.  A buffer of
``SPLIT_MIN_BYTES`` or more is folded in contiguous chunks on half of
this process's cores at once: the scan meets the host's memory bandwidth
well before every core reads, and with a thread on every core the last
chunk to finish sets the scan's time (on an 8-vCPU Xeon host 4 threads
scanned 183 MB as fast as 8, and a request's scan often faster).  ``checksums`` counts buffers by route (``fold``,
``zlib``) and their bytes (``fold_bytes``, ``zlib_bytes``).
"""
from __future__ import annotations

import collections
import dataclasses
import os
import zlib

import numpy as np

from lssp_tpu_torch import native
from lssp_tpu_torch.utils.profile import annotate

# memo_get's lookups by outcome ("hit", "miss", "stale"); callers reset it
lookups = collections.Counter()

# checksum's buffers by route ("fold", "zlib") and bytes ("fold_bytes",
# "zlib_bytes"); callers reset it
checksums = collections.Counter()

FOLD_MIN_BYTES = 64 << 10
SPLIT_MIN_BYTES = 16 << 20


def _cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:          # no affinity call on this platform
        return os.cpu_count() or 1


def _split_threads(nbytes: int) -> int:
    return max(1, _cores() // 2) if nbytes >= SPLIT_MIN_BYTES else 1


def checksum(a) -> int:
    """``zlib.crc32`` over the full bytes of an array (numpy, or anything
    ``np.asarray`` takes), by the route the module docstring gives."""
    d = np.ascontiguousarray(np.asarray(a))
    if d.nbytes >= FOLD_MIN_BYTES and not d.dtype.hasobject \
            and native.checksum_lib() is not None:
        checksums["fold"] += 1
        checksums["fold_bytes"] += d.nbytes
        return native.crc32(d, _split_threads(d.nbytes))
    checksums["zlib"] += 1
    checksums["zlib_bytes"] += d.nbytes
    return zlib.crc32(d)


def fingerprint(A):
    """Full-content fingerprint of a host container: shape, dtype and crc32
    of its values (``data``, or a BSR's ``blocks``) and a crc32 of every
    structure buffer (``indices``, ``indptr``, ``row``, ``col``), so an
    in-place change of any of them invalidates.  Sampling was rejected in
    the reference: it "silently validated a stale device matrix", so every
    byte is read on every call.  Each crc32 is ``checksum``'s: the fold on
    the host for a buffer of 64 KiB or more, ``zlib`` below, the
    same value either way (``checksums`` counts the routes).  None when the
    container has no such buffers (never matches).  The scan is the span
    ``lssp.memo.fingerprint``."""
    with annotate("lssp.memo.fingerprint"):
        try:
            vals = getattr(A, "data", None)
            if vals is None:
                vals = getattr(A, "blocks", None)
            d = np.ascontiguousarray(np.asarray(vals))
            if d.dtype == object:
                return None
            parts = [d.shape, d.dtype.str, checksum(d)]
            for name in ("indices", "indptr", "row", "col"):
                buf = getattr(A, name, None)
                if buf is not None:
                    parts.append(checksum(buf))
            return tuple(parts)
        except (TypeError, ValueError):
            return None


def _pc_options_key(pc_options):
    """The memo key of a ``PCOptions`` (every set-up memo that depends on
    one): array-valued fields key on their shape, dtype and ``checksum``
    of their full bytes (a repr would summarize large arrays)."""
    if pc_options is None:
        return None
    parts = []
    for f in dataclasses.fields(pc_options):
        v = getattr(pc_options, f.name)
        if (hasattr(v, "__array__") or isinstance(v, (list, tuple))) \
                and not isinstance(v, str):
            a = np.asarray(v)
            parts.append((f.name, a.shape, str(a.dtype), checksum(a)))
        else:
            parts.append((f.name, repr(v)))
    return tuple(parts)


def memo_get(A, attr, key, fp):
    """The value stored under ``key`` in ``A.<attr>`` when its fingerprint
    equals ``fp``, else None (a miss or a stale entry).  A None ``fp``
    never matches.  A hit moves to the back of the LRU order.  Counts the
    outcome in ``lookups``."""
    cache = getattr(A, attr, None)
    fps = getattr(A, attr + "_fp", None)
    if cache is None or fps is None or fp is None or key not in cache:
        lookups["miss"] += 1
        return None
    if fps.get(key) is None or fps[key] != fp:
        lookups["stale"] += 1
        return None
    lookups["hit"] += 1
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
