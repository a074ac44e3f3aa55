"""The band ring's index arithmetic (K1 / K3 in bfloat16, ``csrc/band_ring.cuh``)
on the CPU, against the plain versions and against lssp_tpu.

No card runs here, so the part of the ring that can go wrong without one
is held here: the host plan (``ops/dia_spmv.band_tile_plan``: route, tile,
stages, grid, edge tiles) and a numpy emulation that walks the persistent
grid's tiles, fills each stage from exactly the copies the producer issues
(``ring_copies``, the kernel's ``issue_tile``), reads each thread's 8 rows through the window shift, and
adds K3's remainder chunk by chunk from the tile's slice of the host index,
a thread finding its rows by a binary search, as the kernel does.  Window
positions a copy leaves unfilled are NaN, so a read of one shows.

The emulation sums in float32 in diagonal order (then the row's remainder
entries in CSR order) with a rounding per product, as the plain versions
do, and rounds once to bf16: it must equal ``dia_spmv_plain`` /
``hyb_spmv_plain`` bit for bit.  (The kernel fuses each multiply-add; that
it equals the rowwise kernel bit for bit is held on the card,
``tests/test_torch_cuda.py``.)  Against JAX's XLA bf16 products, which round
every operation, the tolerance is ``test_torch_bf16.py``'s nd × 2⁻⁸ of
max|y|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lssp_tpu.ops.spmv import mv_amxy as j_amxy, spmv as jspmv
from lssp_tpu.sparse import types as jtypes
from lssp_tpu_torch import _kernels
from lssp_tpu_torch.ops.dia_spmv import (RING_ROWS, RING_SM_SMEM, RING_SMEM, band_tile_plan,
                                         dia_spmv, dia_spmv_plain, plan_launch, ring_stage_bytes)
from lssp_tpu_torch.ops.hyb_spmv import hyb_spmv, hyb_spmv_plain
from lssp_tpu_torch.sparse.convert import hyb_from_parts
from lssp_tpu_torch.sparse.types import DIA

BF16 = torch.bfloat16


def bf16(a) -> np.ndarray:
    """float32 values rounded to bf16 (nearest even), held in float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


def bits(a) -> np.ndarray:
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).view(torch.int16).numpy()


def band_case(n, ncols, offsets, seed):
    """A random bf16 band (zeros where i + off_d leaves [0, ncols), as
    csr_to_dia stores them) and a random bf16 x and z."""
    rng = np.random.default_rng(seed)
    data = bf16(rng.uniform(-1, 1, (len(offsets), n)))
    for d, off in enumerate(offsets):
        j = np.arange(n) + off
        data[d, (j < 0) | (j >= ncols)] = 0.0
    return data, bf16(rng.uniform(-1, 1, ncols)), bf16(rng.uniform(-1, 1, n))


def ring_copies(plan, n, ncols, offsets, t):
    """The bulk copies the ring's producer issues for tile t, in the
    kernel's order (``csrc/band_ring.cuh: issue_tile``), as (kind, d, src,
    src_end, dst): band row d's columns [src, src_end) to stage position
    dst; x[src:src_end] to diagonal d's window at dst, the window led by
    f_d = off_d − (off_d mod 8) and clamped to [0, ncols), left out when
    empty; then z[base:base + rows]."""
    base = t * plan.T
    rows = min(plan.T, n - base)
    out = []
    for d, off in enumerate(offsets):
        out.append(("band", d, base, base + rows, 0))
        start = base + off - off % RING_ROWS
        lo, hi = max(start, 0), min(start + rows + RING_ROWS, ncols)
        if hi > lo:
            out.append(("x", d, lo, hi, lo - start))
    out.append(("z", -1, base, base + rows, 0))
    return out


def emulate(plan, n, ncols, offsets, data, x, alpha=1.0, beta=0.0, z=None, rem=None):
    """y of the ring as ``plan`` lays it out, in float32, rounded to bf16
    (returned as float32).  ``rem``: (rows, cols, vals, block_ptr) of K3."""
    T, S, nd = plan.T, plan.S, len(offsets)
    y = np.full(n, np.nan, np.float32)
    consumed = 0
    for b in range(plan.grid):
        band = np.zeros((S, nd, T), np.float32)
        win = np.zeros((S, nd, T + RING_ROWS), np.float32)
        zs = np.zeros((S, T), np.float32)
        for k, t in enumerate(range(b, plan.ntiles, plan.grid)):
            st, base = k % S, t * T
            rows = min(T, n - base)
            band[st], win[st], zs[st] = np.nan, np.nan, np.nan
            for kind, d, lo, hi, dst in ring_copies(plan, n, ncols, offsets, t):
                if kind == "band":
                    band[st, d, dst:dst + hi - lo] = data[d, lo:hi]
                elif kind == "x":
                    win[st, d, dst:dst + hi - lo] = x[lo:hi]
                elif z is not None:
                    zs[st, dst:dst + hi - lo] = z[lo:hi]
            edge = t < plan.t_lo or t >= plan.t_hi
            r = np.arange(rows)
            acc = np.zeros(rows, np.float32)
            for d, off in enumerate(offsets):
                prod = band[st, d, :rows] * win[st, d, r + off % RING_ROWS]
                if edge:
                    j = base + r + off
                    with np.errstate(invalid="ignore"):
                        acc = np.where((j >= 0) & (j < ncols), acc + prod, acc)
                else:
                    acc = acc + prod
            if rem is not None:
                consumed += add_remainder(plan, t, base, rows, x, rem, acc)
            out = acc * np.float32(alpha)
            if z is not None:
                out = out + np.float32(beta) * zs[st, :rows]
            y[base:base + rows] = out
    if rem is not None:
        assert consumed == len(rem[0]), "every remainder entry is added exactly once"
    return bf16(y)


def add_remainder(plan, t, base, rows, x, rem, acc):
    """K3's remainder pass for tile t: its slice of the host index, in
    chunks of ``plan.chunk``; each owning thread binary-searches its first
    row and adds its rows' entries in CSR order.  Returns the entries
    added."""
    rrows, rcols, rvals, ptr = rem
    bpt, nb = plan.T // _kernels.HYB_BLOCK_ROWS, len(ptr) - 1
    lo, hi = ptr[t * bpt], ptr[min(t * bpt + bpt, nb)]
    added = 0
    for c0 in range(lo, hi, plan.chunk):
        cnt = min(hi - c0, plan.chunk)
        srow = rrows[c0:c0 + cnt] - base
        sval, sx = rvals[c0:c0 + cnt], x[rcols[c0:c0 + cnt]]
        for r0 in np.unique(srow // RING_ROWS) * RING_ROWS:
            if r0 >= rows:
                continue
            a = int(np.searchsorted(srow, r0, side="left"))
            for e in range(RING_ROWS):
                while a < cnt and srow[a] == r0 + e:
                    acc[r0 + e] = acc[r0 + e] + sval[a] * sx[a]
                    a, added = a + 1, added + 1
    return added


def brute_edges(plan, n, ncols, offsets):
    """The tiles in which some row reads x outside [0, ncols)."""
    out = []
    for t in range(plan.ntiles):
        r = np.arange(t * plan.T, min(n, (t + 1) * plan.T))
        j = r[:, None] + np.asarray(offsets)[None, :]
        out.append(bool(((j < 0) | (j >= ncols)).any()))
    return out


def lap2(N):
    return (-N, -1, 0, 1, N)


def lap3(N):
    return (-N * N, -N, -1, 0, 1, N, N * N)


# (n, ncols, offsets): the 2-D and 3-D Laplacians, diagonals past both
# ends, a tall and a wide band, a last partial tile
SHAPES = {
    "lap2d_64": (4096, 4096, lap2(64)),
    "lap3d_16": (4096, 4096, lap3(16)),
    "past_both_ends": (1024, 1024, (-1500, -13, 0, 6, 1201)),
    "tall": (4096, 2048, (-2048, -2047, 0, 3)),
    "wide": (2048, 4104, (0, 5, 2051, 4100)),
    "partial_tile": (5000, 5000, (-71, -1, 0, 1, 71)),
}
# (T, S) pinned, beside the plan's own choice (None)
PINNED = [None, (512, 2), (1024, 4), (2048, 3)]


@pytest.mark.parametrize("name", list(SHAPES))
def test_plan_geometry(name):
    """The plan's tiles, stages, shifts and edge tiles, against a brute
    force over every tile's rows and diagonals."""
    n, ncols, offs = SHAPES[name]
    for has_z in (False, True):
        plan = band_tile_plan(n, ncols, offs, 2, has_z)
        assert plan.route == "ring", plan.reason
        deep = ring_stage_bytes(1024, len(offs), has_z) * 4 + 2048 <= RING_SM_SMEM // 2
        assert (plan.T, plan.S, plan.threads) == (1024, 4 if deep else 2, 128)
        assert band_tile_plan(n, ncols, offs, 2, has_z, rem=True).S == 2
        assert plan.ntiles == -(-n // plan.T) and 1 <= plan.grid <= plan.ntiles
        assert plan.smem == plan.S * plan.stage_bytes <= RING_SMEM
        small = band_tile_plan(n, ncols, offs, 2, has_z, T=512, S=2)
        for p in (plan, small):
            edges = [t < p.t_lo or t >= p.t_hi for t in range(p.ntiles)]
            assert edges == brute_edges(p, n, ncols, offs)


def test_plan_phase32_shapes():
    """The JSON line's K1 / K3 shapes (2048², 5 diagonals) and the 128³
    7-diagonal band (offsets ±16,384): K1 2048² takes T = 1024, S = 4 (two
    blocks of 90 KB an SM), the 128³ K1 and both K3 S = 2 (the 128³ band's
    four stages would leave one block an SM); pinned to T = 2048, S = 3,
    the stages are 44 KB and 60 KB."""
    n = 2048 * 2048
    p1 = band_tile_plan(n, n, lap2(2048), 2, True)
    k3 = band_tile_plan(n, n, lap2(2048), 2, True, rem=True)
    p3 = band_tile_plan(128 ** 3, 128 ** 3, lap3(128), 2, True, rem=True)
    d3 = band_tile_plan(128 ** 3, 128 ** 3, lap3(128), 2, True)
    assert (p1.route, p1.T, p1.S, p1.ntiles, p1.grid) == ("ring", 1024, 4, 4096, 2 * 132)
    assert (k3.T, k3.S, k3.chunk, k3.grid) == (1024, 2, 256, 4 * 132)
    assert (p3.route, p3.T, p3.S, p3.ntiles, p3.chunk) == ("ring", 1024, 2, 2048, 256)
    assert (d3.T, d3.S) == (1024, 2)
    assert p1.stage_bytes == 5 * (1024 + 1032) * 2 + 2048 == 22608
    assert p3.stage_bytes == 7 * (1024 + 1032) * 2 + 2048 == 30832
    assert p3.smem == 2 * 30832 + 12 * 256
    assert (p1.t_lo, p1.t_hi) == (2, 4094) and (p3.t_lo, p3.t_hi) == (16, 2032)
    assert p3.grid == 3 * 132
    assert band_tile_plan(n, n, lap2(2048), 2, True, num_sms=7).grid == 2 * 7
    q1 = band_tile_plan(n, n, lap2(2048), 2, True, T=2048, S=3)
    q3 = band_tile_plan(128 ** 3, 128 ** 3, lap3(128), 2, True, T=2048, S=3)
    assert (q1.stage_bytes, q3.stage_bytes) == (45136, 61552)
    assert (q1.grid, q3.grid) == (132, 132)


@pytest.mark.parametrize("case,reason", [
    ((1331, 1331, (-1, 0, 1), 2, False), "not a multiple of 8"),
    ((1336, 1337, (-1, 0, 1), 2, False), "not a multiple of 8"),
    ((64, 64, tuple(range(-30, 31)), 2, False), "do not fit"),
    ((4096, 4096, tuple(range(-40, 40)), 2, False), "at most 64"),
    ((4096, 4096, lap2(64), 4, False), "bf16 kernel"),
    ((4096, 4096, (), 2, False), "empty"),
])
def test_plan_routes_rowwise_with_the_reason(case, reason):
    plan = band_tile_plan(*case)
    assert plan.route == "rowwise" and reason in plan.reason


def test_plan_is_memoized_and_checks_alignment(monkeypatch):
    """One plan object per shape (the wrapper does not rebuild it); a
    misaligned pointer, or a dtype other than bf16, takes the rowwise
    kernel, and says so.  (CPU tensors stand in for the card's: the
    wrapper plans only CUDA launches, with the card's SM count.)"""
    monkeypatch.setattr(_kernels, "num_sms", lambda device: 132)
    n = 4096
    a = band_tile_plan(n, n, lap2(64), 2, False)
    assert band_tile_plan(n, n, lap2(64), 2, False) is a
    data = torch.zeros(5, n, dtype=BF16)
    x = torch.zeros(n + 8, dtype=BF16)
    y = torch.zeros(n, dtype=BF16)
    assert plan_launch((n, n), lap2(64), data, x[:n], None, y).route == "ring"
    bad = plan_launch((n, n), lap2(64), data, x[1:n + 1], None, y)
    assert bad.route == "rowwise" and "16-byte" in bad.reason
    assert plan_launch((n, n), lap2(64), data.float(), x[:n].float(), None,
                       y.float()).route == "rowwise"


@pytest.mark.parametrize("pin", PINNED, ids=lambda p: "plan" if p is None else f"T{p[0]}S{p[1]}")
@pytest.mark.parametrize("name", list(SHAPES))
def test_dia_emulation_equals_plain_bitwise(name, pin):
    n, ncols, offs = SHAPES[name]
    data, x, z = band_case(n, ncols, offs, seed=len(name))
    kw = {} if pin is None else dict(T=pin[0], S=pin[1])
    D = DIA(offs, torch.from_numpy(data).to(BF16), (n, ncols))
    xt, zt = torch.from_numpy(x).to(BF16), torch.from_numpy(z).to(BF16)
    for alpha, beta, zz in ((1.0, 0.0, None), (0.25, 0.0, None), (-1.0, 1.0, z)):
        plan = band_tile_plan(n, ncols, offs, 2, zz is not None, **kw)
        assert plan.route == "ring", plan.reason
        y = emulate(plan, n, ncols, offs, data, x, alpha, beta, zz)
        ref = dia_spmv_plain(D.data, offs, xt, alpha, beta, None if zz is None else zt)
        assert np.array_equal(bits(y), ref.view(torch.int16).numpy())
        assert np.array_equal(bits(y), dia_spmv(D, xt, alpha, beta,
                                                None if zz is None else zt).view(torch.int16).numpy())


@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("name", ["lap2d_64", "lap3d_16", "past_both_ends", "partial_tile"])
def test_dia_emulation_agrees_with_jax(name, alpha):
    """Against JAX's ``mv_amxy`` on the same bf16 arrays (XLA rounds every
    operation in bf16): within nd × 2⁻⁸ of max|y|."""
    n, ncols, offs = SHAPES[name]
    data, x, _ = band_case(n, ncols, offs, seed=7)
    plan = band_tile_plan(n, ncols, offs, 2, False, T=512, S=2)
    y = emulate(plan, n, ncols, offs, data, x, alpha)
    Dj = jtypes.DIA(offs, jnp.asarray(data, jnp.bfloat16), (n, ncols))
    yj = np.asarray(j_amxy(alpha, Dj, jnp.asarray(x, jnp.bfloat16)), np.float64)
    assert np.abs(y - yj).max() / np.abs(yj).max() <= len(offs) * 2**-8


def hyb_case(kind, seed=3):
    """(n, offsets, rows, cols, vals) of a K3 case: a 2-D Laplacian band
    (n = 64² = 4096, or 5000 rows for the last partial tile) and its
    remainder triplets, row-sorted."""
    rng = np.random.default_rng(seed)
    n = 5000 if kind == "partial_tile" else 4096
    if kind == "empty":
        rows = np.zeros(0, np.int64)
    elif kind == "random":
        rows = np.sort(rng.integers(0, n, 300))
    elif kind == "heavy_tile":            # 700 entries in one 512-row tile
        rows = np.sort(np.concatenate([rng.integers(1024, 1536, 700), rng.integers(0, n, 40)]))
    elif kind == "heavy_row":             # one row with 300 entries
        rows = np.sort(np.concatenate([np.full(300, 2053), rng.integers(0, n, 50)]))
    else:                                 # partial_tile: strays in the last tile too
        rows = np.sort(np.concatenate([rng.integers(0, n, 200), rng.integers(4600, n, 60)]))
    cols = rng.integers(0, n, len(rows))
    vals = bf16(0.1 * rng.standard_normal(len(rows)))
    return n, lap2(64), rows, cols, vals


HYB_KINDS = ["empty", "random", "heavy_tile", "heavy_row", "partial_tile"]


@pytest.mark.parametrize("pin", PINNED, ids=lambda p: "plan" if p is None else f"T{p[0]}S{p[1]}")
@pytest.mark.parametrize("kind", HYB_KINDS)
def test_hyb_emulation_equals_plain_bitwise(kind, pin):
    n, offs, rows, cols, vals = hyb_case(kind)
    data, x, z = band_case(n, n, offs, seed=11)
    H = hyb_from_parts(DIA(offs, torch.from_numpy(data), (n, n)), rows, cols, vals,
                       (n, n)).to(dtype=BF16)
    rem = (rows, cols, vals, H.rem_block_ptr.numpy().astype(np.int64))
    kw = {} if pin is None else dict(T=pin[0], S=pin[1])
    xt, zt = torch.from_numpy(x).to(BF16), torch.from_numpy(z).to(BF16)
    for alpha, beta, zz in ((1.0, 0.0, None), (-1.0, 1.0, z)):
        plan = band_tile_plan(n, n, offs, 2, zz is not None, rem=True, **kw)
        assert plan.route == "ring" and plan.chunk == 2 * plan.threads
        y = emulate(plan, n, n, offs, data, x, alpha, beta, zz, rem)
        ref = hyb_spmv_plain(H, xt, alpha, beta, None if zz is None else zt)
        assert np.array_equal(bits(y), ref.view(torch.int16).numpy())
        got = hyb_spmv(H, xt, alpha, beta, None if zz is None else zt)
        assert np.array_equal(bits(y), got.view(torch.int16).numpy())
    if kind == "heavy_tile":             # the slice spans more than one chunk
        p = band_tile_plan(n, n, offs, 2, False, rem=True, T=512, S=2)
        ptr = rem[3]
        assert ptr[3 * 2] - ptr[2 * 2] > p.chunk


@pytest.mark.parametrize("kind", ["random", "heavy_tile", "partial_tile"])
def test_hyb_emulation_agrees_with_jax(kind):
    """Against JAX's HYB ``spmv`` (band product, then the remainder's
    sorted scatter-add, each add rounded in bf16): within (nd + k) × 2⁻⁸ of
    max|y|, k the most remainder entries a row holds (at most 6 here; the heavy
    row's 300 bf16 adds are held to plain bitwise above, not to JAX)."""
    n, offs, rows, cols, vals = hyb_case(kind, seed=5)
    data, x, _ = band_case(n, n, offs, seed=13)
    H = hyb_from_parts(DIA(offs, torch.from_numpy(data), (n, n)), rows, cols, vals,
                       (n, n)).to(dtype=BF16)
    plan = band_tile_plan(n, n, offs, 2, False, rem=True, T=512, S=3)
    y = emulate(plan, n, n, offs, data, x, rem=(rows, cols, vals,
                                                  H.rem_block_ptr.numpy().astype(np.int64)))
    Hj = jtypes.HYB(jtypes.DIA(offs, jnp.asarray(data, jnp.bfloat16), (n, n)),
                    jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32),
                    jnp.asarray(vals, jnp.bfloat16), (n, n))
    yj = np.asarray(jspmv(Hj, jnp.asarray(x, jnp.bfloat16)), np.float64)
    k = int(np.bincount(rows).max())
    assert k <= 8 and np.abs(y - yj).max() / np.abs(yj).max() <= (len(offs) + k) * 2**-8
