"""The memo's CRC-32 (``lssp_tpu_torch/native/src/checksum.cpp`` through
``utils.memo.checksum``) against ``zlib.crc32``, bit for bit.

Tests of the fold itself take the ``fold`` fixture and skip where the
library does not build or load here (no g++) or the CPU lacks PCLMULQDQ;
the tests of ``checksum`` and ``fingerprint`` then check the ``zlib``
route instead."""
import zlib

import numpy as np
import pytest

import lssp_tpu_torch as lt
from lssp_tpu_torch import native
from lssp_tpu_torch.sparse.types import BSR, COO, CSR
from lssp_tpu_torch.utils import memo


@pytest.fixture
def fold():
    lib = native.checksum_lib()
    if lib is None:
        pytest.skip("the CRC-32 fold does not build or run here (no g++ or no PCLMULQDQ)")
    return lib


@pytest.fixture
def counted():
    """``memo.checksums`` from zero for the test, restored after it."""
    saved = memo.checksums.copy()
    memo.checksums.clear()
    yield memo.checksums
    memo.checksums.clear()
    memo.checksums.update(saved)


def _bytes(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 63, 64, 65, 127, 4095, 65537])
def test_fold_equals_zlib_at_every_boundary(fold, n):
    buf = _bytes(n, seed=n)
    assert native.crc32(buf) == zlib.crc32(buf)
    for threads in (2, 3, 8):
        assert native.crc32(buf, threads) == zlib.crc32(buf)


@pytest.mark.parametrize("offset", range(1, 16))
def test_fold_equals_zlib_off_16_bytes(fold, offset):
    """A view that starts ``offset`` bytes into a larger buffer: the loads
    are unaligned."""
    big = _bytes(70_000, seed=offset)
    for n in (64, 100, 4_111, 65_536 + offset):
        view = big[offset:offset + n]
        assert view.ctypes.data % 16 == (big.ctypes.data + offset) % 16
        assert native.crc32(view) == zlib.crc32(view)


def _bsr_blocks():
    rng = np.random.default_rng(3)
    return rng.standard_normal((1_500, 3, 3))


@pytest.mark.parametrize("make", [
    lambda rng: rng.standard_normal(20_000),
    lambda rng: rng.standard_normal(20_000).astype(np.float32),
    lambda rng: rng.integers(-2**31, 2**31, 20_000, dtype=np.int32),
    lambda rng: rng.integers(-2**63, 2**63, 20_000, dtype=np.int64),
    lambda rng: rng.standard_normal(20_000) + 1j * rng.standard_normal(20_000),
    lambda rng: _bsr_blocks(),
], ids=["float64", "float32", "int32", "int64", "complex128", "bsr_blocks"])
def test_checksum_equals_zlib_for_each_dtype(counted, make):
    a = make(np.random.default_rng(11))
    assert a.nbytes >= memo.FOLD_MIN_BYTES
    assert memo.checksum(a) == zlib.crc32(a)
    route = "fold" if native.checksum_lib() is not None else "zlib"
    assert counted == {route: 1, route + "_bytes": a.nbytes}


def test_checksum_of_a_non_contiguous_view(counted):
    a = np.random.default_rng(5).standard_normal((400, 90))
    view = a[::2, 1::3]
    assert not view.flags.c_contiguous
    assert memo.checksum(view) == zlib.crc32(np.ascontiguousarray(view))
    assert memo.checksum(view) != memo.checksum(a[1::2, 1::3])


def test_fold_splits_a_large_buffer_on_every_thread_count(fold):
    """A buffer over the split size on each thread count the routine can
    take (1 to this process's cores, and past them), with a length no
    chunk size divides."""
    buf = _bytes(32 * 2**20 + 13, seed=32)
    assert buf.nbytes >= memo.SPLIT_MIN_BYTES
    want = zlib.crc32(buf)
    for threads in range(1, max(memo._cores(), 8) + 2):
        assert native.crc32(buf, threads) == want, threads
    assert memo.checksum(buf) == want


def test_split_takes_half_the_cores_from_its_size(monkeypatch):
    monkeypatch.setattr(memo, "_cores", lambda: 8)
    assert memo._split_threads(memo.SPLIT_MIN_BYTES - 1) == 1
    assert memo._split_threads(memo.SPLIT_MIN_BYTES) == 4
    monkeypatch.setattr(memo, "_cores", lambda: 1)
    assert memo._split_threads(10 * memo.SPLIT_MIN_BYTES) == 1


def test_fold_rejects_a_strided_array(fold):
    with pytest.raises(ValueError, match="contiguous"):
        native.crc32(np.zeros(200)[::2])


def _by_zlib(A):
    vals = A.blocks if isinstance(A, BSR) else A.data
    parts = [vals.shape, vals.dtype.str, zlib.crc32(np.ascontiguousarray(vals))]
    for name in ("indices", "indptr", "row", "col"):
        buf = getattr(A, name, None)
        if buf is not None:
            parts.append(zlib.crc32(np.ascontiguousarray(buf)))
    return tuple(parts)


def _containers():
    A = lt.sparse.laplacian_2d(128)
    S = A.to_scipy().tocoo()
    coo = COO(S.row.astype(np.int32), S.col.astype(np.int32), S.data, A.shape)
    bsr = CSR(A.indptr, A.indices, A.data, A.shape).to_scipy().tobsr(blocksize=(2, 2))
    bsr = BSR(bsr.indptr, bsr.indices, bsr.data, bsr.shape, 2)
    return {"csr": A, "coo": coo, "bsr": bsr}


@pytest.mark.parametrize("kind", ["csr", "coo", "bsr"])
def test_fingerprint_is_the_zlib_tuple(counted, kind):
    A = _containers()[kind]
    fp = memo.fingerprint(A)
    assert fp == _by_zlib(A)
    assert sum(counted[r] for r in ("fold", "zlib")) == len(fp) - 2
    if native.checksum_lib() is not None:
        assert counted["fold"] >= 1        # the values take the fold


@pytest.mark.parametrize("where", [0, 1, 15, 64, 4_097, 2**19 - 3, 2**20 - 64, 2**20 - 1])
def test_one_flipped_bit_or_two_swapped_values_change_the_checksum(where):
    a = np.random.default_rng(7).standard_normal(2**17)         # 1 MB
    ref = memo.checksum(a)
    raw = a.view(np.uint8)
    raw[where] ^= 1 << (where % 8)
    assert memo.checksum(a) != ref
    raw[where] ^= 1 << (where % 8)
    assert memo.checksum(a) == ref
    i = where // 8
    j = (i + 1 + where % 1_000) % a.size
    assert i != j
    a[[i, j]] = a[[j, i]]
    assert memo.checksum(a) != ref


def test_checksums_counts_routes_and_bytes(counted):
    small = np.arange(1_000, dtype=np.int32)
    big = np.arange(2**17, dtype=np.float64)
    memo.checksum(small)
    memo.checksum(big)
    memo.checksum(small)
    if native.checksum_lib() is not None:
        assert counted == {"zlib": 2, "zlib_bytes": 8_000, "fold": 1, "fold_bytes": 2**20}
    else:
        assert counted == {"zlib": 3, "zlib_bytes": 8_000 + 2**20}


@pytest.mark.parametrize("kind", ["csr", "coo", "bsr"])
def test_without_the_library_zlib_gives_the_same_tuple(counted, monkeypatch, kind):
    A = _containers()[kind]
    fp = memo.fingerprint(A)
    monkeypatch.setattr(native, "checksum_lib", lambda: None)
    counted.clear()
    assert memo.fingerprint(A) == fp == _by_zlib(A)
    assert set(counted) == {"zlib", "zlib_bytes"}
    assert counted["zlib"] == len(fp) - 2


def test_pc_options_key_takes_the_same_checksum():
    from lssp_tpu_torch.utils.memo import _pc_options_key
    sizes = np.full(20_000, 4, dtype=np.int64)
    key = dict((p[0], p) for p in _pc_options_key(lt.PCOptions(block_sizes=sizes)))
    assert key["block_sizes"] == ("block_sizes", (20_000,), "int64", zlib.crc32(sizes))
