"""K2's plan and plain version, and the exact triangular solves, against
lssp_tpu on the CPU.

- The band/stray plan equals the TPU plan's ``_split_band`` exactly.
- ``neumann_apply_plain`` matches the Pallas kernel ``fused_neumann_apply``
  run with ``interpret=True`` in fp32 (rtol 1e-5: another summation order
  over 2k sweeps), and the JAX SpMV-composed ``neumann_ilu_apply`` in fp64
  (1e-12).
- The exact level-scheduled apply matches JAX's and a dense solve (1e-12).
"""
import collections
import contextlib
import ctypes
import dataclasses
import functools
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lssp_tpu as J
from lssp_tpu.ops import pallas_neumann as jpn
from lssp_tpu.ops import trisolve as jtri
from lssp_tpu.pc.ilu_host import iluk_factor as j_iluk
import lssp_tpu_torch as T
from lssp_tpu_torch.ops import trisolve as ttri
from lssp_tpu_torch.ops.neumann import (MAX_RANGES, RING_BYTES, THREADS, FusedNeumann,
                                        NeumannFactor, _ranges, band_reads,
                                        fused_neumann_apply, halo_rows, neumann_apply_plain,
                                        plan_fused_neumann, split_band, tile_rows,
                                        wavefront_schedule)
from lssp_tpu_torch.pc.ilu_host import iluk_factor as t_iluk


def _strayed(pkg, n1d, nstray, seed=0):
    """2-D Laplacian plus random long-range couplings: a dominant band with
    a scattered remainder (the pattern of tests/test_pallas_neumann.py)."""
    A = pkg.sparse.laplacian_2d(n1d)
    rng = np.random.default_rng(seed)
    n = A.shape[0]
    r, c = rng.integers(0, n, nstray), rng.integers(0, n, nstray)
    keep = r != c
    E = sp.coo_matrix((0.1 * rng.standard_normal(keep.sum()), (r[keep], c[keep])),
                      shape=A.shape)
    M = (A.to_scipy() + E.tocsr()).tocsr()
    M.sort_indices()
    return pkg.sparse.CSR(M.indptr, M.indices, M.data, M.shape)


def _factors(kind):
    """(JAX factors, port factors) — bit-identical, see test_torch_sparse."""
    if kind == "banded":
        return j_iluk(J.sparse.laplacian_2d(40), level=0), t_iluk(T.sparse.laplacian_2d(40), level=0)
    return j_iluk(_strayed(J, 40, 200), level=1), t_iluk(_strayed(T, 40, 200), level=1)


@pytest.mark.parametrize("kind", ["banded", "strayed"])
def test_plan_split_matches_tpu_plan(kind):
    (Lj, Uj), (Lt, Ut) = _factors(kind)
    n = Lt.shape[0]
    st_j = jpn.plan_fused_neumann(Lj, Uj, 2)
    plan = plan_fused_neumann(Lt, Ut, 2, dtype=torch.float32)
    for Fj, Ft in ((st_j.L, plan.L), (st_j.U, plan.U)):
        assert Fj.offsets == Ft.offsets
        assert np.array_equal(np.asarray(Fj.band)[:, :n], Ft.band.numpy())
        has_j, has_t = Fj.gt is not None, Ft.stray_ptr is not None
        assert has_j == has_t
        if has_t:   # the same stray entries: one per one-hot row of the TPU plan
            assert int(np.asarray(Fj.gt).sum()) == Ft.stray_cols.numel()
    assert np.array_equal(np.asarray(st_j.invdiag)[:n], plan.invdiag.numpy())
    assert (kind == "strayed") == (plan.L.stray_ptr is not None or plan.U.stray_ptr is not None)


def test_split_band_rule_on_host():
    (_, _), (Lt, _) = _factors("strayed")
    Ls, _, _ = T.sparse.split_ldu(Lt)
    n = Lt.shape[0]
    band, offs, (rows, cols, vals) = split_band(Ls, n)
    bj, oj, (rj, cj, vj) = jpn._split_band(J.sparse.CSR(Ls.indptr, Ls.indices, Ls.data, Ls.shape),
                                           n, n, 48, 0.02)
    assert offs == oj
    assert np.array_equal(band.astype(np.float32), bj)
    assert np.array_equal(rows, rj) and np.array_equal(cols, cj) and np.array_equal(vals, vj)


@pytest.mark.parametrize("sweeps", [2, 6])
@pytest.mark.parametrize("kind", ["banded", "strayed"])
def test_plain_matches_pallas_fp32(kind, sweeps):
    (Lj, Uj), (Lt, Ut) = _factors(kind)
    r = np.random.default_rng(sweeps).standard_normal(Lt.shape[0])
    z_pallas = np.asarray(jpn.fused_neumann_apply(jpn.plan_fused_neumann(Lj, Uj, sweeps),
                                                  jnp.asarray(r, jnp.float32),
                                                  interpret=True))
    plan = plan_fused_neumann(Lt, Ut, sweeps, dtype=torch.float32)
    z = fused_neumann_apply(plan, torch.from_numpy(r.astype(np.float32)))
    assert z.dtype == torch.float32
    np.testing.assert_allclose(z.numpy(), z_pallas, rtol=1e-5, atol=1e-6)
    assert fused_neumann_apply.launches == 0      # CPU tensors take the plain version


@pytest.mark.parametrize("sweeps", [2, 6])
@pytest.mark.parametrize("kind", ["banded", "strayed"])
def test_plain_matches_neumann_ilu_apply_fp64(kind, sweeps):
    (Lj, Uj), (Lt, Ut) = _factors(kind)
    r = np.random.default_rng(10 + sweeps).standard_normal(Lt.shape[0])
    z_jax = np.asarray(jtri.neumann_ilu_apply(jtri.make_neumann_tri(Lj, Uj, sweeps),
                                              jnp.asarray(r)))
    plan = plan_fused_neumann(Lt, Ut, sweeps)
    assert plan.dtype == torch.float64
    z = neumann_apply_plain(plan, torch.from_numpy(r))
    np.testing.assert_allclose(z.numpy(), z_jax, rtol=1e-12, atol=1e-12)
    # the port's own SpMV-composed apply (the transpose-capable setup)
    z2 = ttri.neumann_ilu_apply(ttri.make_neumann_tri(Lt, Ut, sweeps), torch.from_numpy(r))
    np.testing.assert_allclose(z2.numpy(), z_jax, rtol=1e-12, atol=1e-12)


def test_apply_requires_the_plan_dtype():
    (_, _), (Lt, Ut) = _factors("banded")
    plan = plan_fused_neumann(Lt, Ut, 2, dtype=torch.float32)
    with pytest.raises(TypeError, match="plan"):
        fused_neumann_apply(plan, torch.zeros(Lt.shape[0], dtype=torch.float64))


def test_complete_neumann_is_exact():
    """sweeps = dependency depth: the finite Neumann series is the exact
    triangular solve (the ilu_sweeps=-1 contract)."""
    A = T.sparse.laplacian_2d(7)
    L, U = t_iluk(A, level=1)
    depth = ttri.neumann_exact_depth(
        [(S.indptr, S.indices, 49, low) for S, low in
         ((T.sparse.split_ldu(L)[0], True), (T.sparse.split_ldu(U)[2], False))])
    r = np.random.default_rng(4).standard_normal(49)
    z = neumann_apply_plain(plan_fused_neumann(L, U, depth), torch.from_numpy(r))
    ref = np.linalg.solve(U.todense(), np.linalg.solve(L.todense() + np.eye(49), r))
    np.testing.assert_allclose(z.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("transpose", [False, True])
def test_exact_level_apply_matches_jax(transpose):
    (Lj, Uj), (Lt, Ut) = _factors("strayed")
    n = Lt.shape[0]
    r = np.random.default_rng(5).standard_normal(n)
    if transpose:
        z_jax = jtri.ilu_apply_t(*jtri.ilu_transpose_schedules(Lj, Uj), jnp.asarray(r))
        z = ttri.ilu_apply_t(*ttri.ilu_transpose_schedules(Lt, Ut), torch.from_numpy(r))
        Md = (Ut.todense().T, Lt.todense().T + np.eye(n))
    else:
        z_jax = jtri.make_ilu_apply(Lj, Uj)(jnp.asarray(r))
        z = ttri.ilu_apply(ttri.level_schedule(Lt, lower=True),
                           ttri.level_schedule(Ut, lower=False), torch.from_numpy(r))
        Md = (Lt.todense() + np.eye(n), Ut.todense())
    ref = np.linalg.solve(Md[1], np.linalg.solve(Md[0], r))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_jax), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(z.numpy(), ref, rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# the wavefront schedule of K2 / K2k (csrc/neumann.cu), run in numpy
# ---------------------------------------------------------------------------

def _host_factor(F):
    """(band (nd, n), offsets, stray ptr, cols, vals) of a CPU plan factor."""
    if F.stray_ptr is None:
        return F.band.numpy(), F.offsets, None, None, None
    return (F.band.numpy(), F.offsets, F.stray_ptr.numpy(), F.stray_cols.numpy(),
            F.stray_vals.numpy())


def _reads(fac, rows):
    """The rows a sweep reads for each of ``rows`` (band, then strays)."""
    band, offs, ptr, cols, _ = fac
    n = band.shape[1]
    out = {}
    for i in rows:
        js = [i + o for o in offs if 0 <= i + o < n]
        if ptr is not None:
            js += [int(j) for j in cols[ptr[i]:ptr[i + 1]]]
        out[i] = js
    return out


def _tile_rows(w, t):
    return range(t * w.rows, min((t + 1) * w.rows, w.n))


def _covered(waits, ph, need, u):
    """Does a wait entry make level ``need`` of item (ph, u) done first?"""
    return any(p == ph and nd >= need and lo <= u <= hi for p, nd, lo, hi in waits)


def _check_schedule(w, facs):
    """Every wait is on a smaller ticket; every value a level reads from
    another tile is awaited; every ring slot a level overwrites was read
    by levels it awaited (the previous writer found by replaying the writes
    in ticket order, the readers from the factors' pattern, not from
    ``dep``; a tile reads its own rows from shared memory)."""
    ticket = {w.item(x)[:2]: x for x in range(0, w.tickets, w.ncols)}
    reads = [_reads(facs[ph], range(w.n)) for ph in (0, 1)]
    readers = [{} for _ in (0, 1)]               # row -> other tiles u reading it
    for ph in (0, 1):
        for i, js in reads[ph].items():
            u = w.tile(ph, i // w.rows)
            for j in js:
                if j // w.rows != i // w.rows:
                    readers[ph].setdefault(j, set()).add(u)
    slot_tag = {}                                # (ph, level, slot) -> row
    for x in range(0, w.tickets, w.ncols):
        ph, u, _ = w.item(x)
        t = w.tile(ph, u)
        for s in range(1, w.sweeps + 1):
            waits = w.waits(ph, s, u)
            for p, need, lo, hi in waits:
                for v in range(lo, hi + 1):
                    assert ticket[(p, v)] < x, ((ph, s, u), (p, need, v))
            for i in _tile_rows(w, t):
                for j in reads[ph][i]:
                    if j // w.rows == t:
                        continue                 # the tile's own: shared memory
                    src_u = w.tile(ph, j // w.rows)
                    if s > 1:
                        assert _covered(waits, ph, s - 1, src_u)
                        assert slot_tag[(ph, s - 1, j & w.mask)] == j
                    elif ph == 1:
                        assert _covered(waits, 0, w.sweeps, src_u)
                if s < w.sweeps:
                    key = (ph, s, i & w.mask)
                    if key in slot_tag:
                        for v in readers[ph].get(slot_tag[key], ()):
                            assert _covered(waits, ph, s + 1, v), ((ph, s, u), slot_tag[key], v)
                    slot_tag[key] = i
            if ph == 1 and s == 1:
                assert _covered(waits, 0, w.sweeps, u)   # its own z0 rows, the base


def _emulate(w, plan, R, window, seed):
    """The kernel's items run in numpy, level by level: tickets taken in
    order, up to ``window`` items in flight, each step one level of a
    random in-flight item whose waits are met (a deadlock fails); a tile's
    own previous level from its "shared memory", the others' from the
    NaN-filled rings (a read of a slot no one wrote shows)."""
    facs = [_host_factor(plan.L), _host_factor(plan.U)]
    invd = plan.invdiag.numpy()
    n, k = R.shape
    kt = k // w.ncols
    z0, out = np.full_like(R, np.nan), np.full_like(R, np.nan)
    ring = np.full((2, w.sweeps + 1, w.ring_rows, k), np.nan, dtype=R.dtype)
    prog = np.zeros((2, w.ncols, w.tiles), dtype=np.int64)
    rng = np.random.default_rng(seed)
    nxt, flight = 0, []                          # [item, next level, shared tile]

    def ready(ph, u, c, s):
        return all((prog[p, c, [w.tile(ph, v) for v in range(lo, hi + 1)]] >= need).all()
                   for p, need, lo, hi in w.waits(ph, s, u))

    def run(entry):
        (ph, u, c), s, tile = entry
        band, offs, ptr, cols, vals = facs[ph]
        cs = slice(c * kt, (c + 1) * kt)
        rows = np.asarray(_tile_rows(w, w.tile(ph, u)))
        base = (z0 if ph else R)[rows, cs]
        if s == 1:
            tile = base.copy()                   # level 0 into shared memory
        last = s == w.sweeps
        yg, ym = ((z0 if ph else R), -1) if s == 1 else (ring[ph, s - 1], w.mask)

        def y(j):
            own = (j >= rows[0]) & (j <= rows[-1])
            v = yg[j & ym, cs]
            v[own] = tile[j[own] - rows[0]]
            return v
        acc = np.zeros((len(rows), kt), dtype=R.dtype)
        for d, o in enumerate(offs):             # band in d order, then the strays
            j = rows + o
            ok = (j >= 0) & (j < n)
            acc[ok] += band[d, rows[ok]][:, None] * y(j[ok])
        if ptr is not None:
            for a, i in enumerate(rows):
                for e in range(ptr[i], ptr[i + 1]):
                    acc[a] += vals[e] * y(np.array([cols[e]]))[0]
        v = base - acc
        if ph == 0 and last:
            v *= invd[rows][:, None]
        if last:
            (out if ph else z0)[rows, cs] = v
        else:
            ring[ph, s][rows & w.mask, cs] = v
        prog[ph, c, w.tile(ph, u)] = s
        entry[1], entry[2] = s + 1, v

    while nxt < w.tickets or flight:
        while nxt < w.tickets and len(flight) < window:
            flight.append([w.item(nxt), 1, None])
            nxt += 1
        go = [a for a, (item, s, _) in enumerate(flight) if ready(*item, s)]
        assert go, f"deadlock: {flight}"
        entry = flight[go[rng.integers(len(go))]]
        run(entry)
        if entry[1] > w.sweeps:
            flight.remove(entry)
    return out


def _wavefront_cases():
    """(plan factors, sweeps, rows per tile, blocks, ring budget) for: ILU(0)
    16³ in a ring that wraps; the strayed ILU(1), whose reach takes
    full-length rings; a ragged n; one sweep; a deep sweep count in rings
    cut by the budget."""
    lap = T.sparse.laplacian_3d(16)
    rag = T.sparse.laplacian_2d(37)                       # n = 1369
    return {"ilu0_16^3_ring": (t_iluk(lap, level=0), 6, 32, 12, None),
            "strayed_iluk1_full": (t_iluk(_strayed(T, 40, 200), level=1), 6, 64, 8, None),
            "ragged_n": (t_iluk(rag, level=0), 4, 32, 5, None),
            "sweeps_1": (t_iluk(rag, level=0), 1, 64, 4, None),
            "deep_sweeps_budget": (t_iluk(T.sparse.laplacian_2d(24), level=1), 30, 16, 20,
                                   16 * 8)}


@pytest.mark.parametrize("case", list(_wavefront_cases()))
def test_wavefront_schedule_fp64(case):
    """The schedule's tickets, waits, ring indexing and deadlock freedom,
    and the emulated apply (levels in random order within the in-flight
    window, k = 3 as three column tiles and k = 1) equal to
    neumann_apply_plain to 1e-12."""
    (L, U), sweeps, rows, blocks, budget = _wavefront_cases()[case]
    plan = plan_fused_neumann(L, U, sweeps)
    n = plan.n
    w = wavefront_schedule(n, plan.reach, sweeps, rows, blocks, ncols=3, ring_budget=budget,
                           offsets=band_reads(plan))
    for ph, F in enumerate((plan.L, plan.U)):     # strays: the whole reach
        if F.stray_ptr is not None:
            assert w.reads[ph] == ((1, w.dep),)
    assert [w.item(x) for x in range(w.tickets)] == \
        [(ph, u, c) for ph in (0, 1) for u in range(w.tiles) for c in range(3)]
    assert w.dep * rows >= plan.reach and 1 <= w.grid <= blocks
    if w.ring_tiles < w.tiles:
        assert w.ring_tiles > w.dep and w.mask == w.ring_rows - 1
        assert w.ring_tiles & (w.ring_tiles - 1) == 0
    else:
        assert w.mask == -1 and w.ring_rows >= n
    assert (w.ring_tiles < w.tiles) == (case != "strayed_iluk1_full")
    if case == "strayed_iluk1_full":
        assert plan.L.stray_ptr is not None and plan.reach > n // 2
    if case == "deep_sweeps_budget":
        assert w.ring_rows <= budget and w.grid < blocks
    _check_schedule(w, [_host_factor(plan.L), _host_factor(plan.U)])
    R = np.random.default_rng(7).standard_normal((n, 3))
    ref = neumann_apply_plain(plan, torch.from_numpy(R)).numpy()
    got = _emulate(w, plan, R, window=w.grid, seed=1)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    w1 = dataclasses.replace(w, ncols=1, grid=max(1, w.grid // 3))
    got1 = _emulate(w1, plan, R[:, :1].copy(), window=w1.grid, seed=2)
    np.testing.assert_array_equal(got1[:, 0], got[:, 0])     # each column alike


def test_wavefront_waits_name_the_tiles_read():
    """Without strays a level waits only for the tiles its diagonals read
    (16³ ILU(0) in 32-row tiles: offsets −1, −16, −256 read tiles t − 1
    and t − 8, mirrored for phase 1), a subset of the dep tiles before it;
    with strays, for all of them."""
    plan = plan_fused_neumann(*t_iluk(T.sparse.laplacian_3d(16), level=0), 6)
    w = wavefront_schedule(plan.n, plan.reach, 6, 32, 12, offsets=band_reads(plan))
    assert plan.L.offsets == (-256, -16, -1) and w.dep == 8
    assert w.reads == (((1, 1), (8, 8)), ((1, 1), (8, 8)))
    for ph in (0, 1):
        for u in (0, 1, 9, 40, w.tiles - 1):
            got = sorted({v for p, need, lo, hi in w.waits(ph, 3, u) if need == 2
                          for v in range(lo, hi + 1)})
            assert got == [v for v in (u - 8, u - 1) if v >= 0]
    ranged = wavefront_schedule(plan.n, plan.reach, 6, 32, 12)
    assert ranged.reads == (((1, 8),), ((1, 8),))
    assert ranged.waits(0, 3, 40)[0] == (0, 2, 32, 39)


def test_wavefront_wait_sets_are_the_kernel_arguments():
    """The kernel's ``waits`` argument, for 16³ ILU(0) in 32-row tiles
    and a 32-tile ring: per set its count of ranges, then the ranges, in
    the order reads[0], reads[1], base, reuse[0], reuse[1]; ``waits``
    walks the same sets."""
    plan = plan_fused_neumann(*t_iluk(T.sparse.laplacian_3d(16), level=0), 6)
    w = wavefront_schedule(plan.n, plan.reach, 6, 32, 12, offsets=band_reads(plan))
    assert w.ring_tiles == 32 < w.tiles
    assert w.base == ((0, 1), (8, 8))              # its own z0 and the tiles it reads
    assert w.reuse == (((24, 24), (31, 32)),) * 2  # tile u − 32 and its readers
    assert w.wait_sets() == [2, 1, 1, 8, 8] * 2 + [2, 0, 1, 8, 8] + [2, 24, 24, 31, 32] * 2
    assert w.waits(1, 1, 40) == [(0, 6, 39, 40), (0, 6, 32, 32), (1, 2, 16, 16), (1, 2, 8, 9)]
    assert w.waits(0, 6, 40) == [(0, 5, 39, 39), (0, 5, 32, 32)]   # the last level: no ring
    one = wavefront_schedule(plan.n, plan.reach, 1, 32, 12, offsets=band_reads(plan))
    assert one.reuse == ((), ()) and one.wait_sets()[-2:] == [0, 0]


def test_wavefront_wait_sets_capped():
    """More distances than the kernel's MAX_RANGES ranges: the nearest
    ranges merge, so a level waits for more tiles, never fewer; the
    schedule of a factor with 24 spread diagonals stays right in the
    emulation."""
    assert _ranges([1, 2, 3, 7, 9, 10]) == ((1, 3), (7, 7), (9, 10))
    assert _ranges([1, 5, 6, 20], cap=2) == ((1, 6), (20, 20))
    n = 1200
    offs = [40 * i + i * i % 7 for i in range(1, 25)]
    A = sp.diags([np.full(n, 60.0)] + [np.full(n - o, -1.0) for o in offs]
                 + [np.full(n - o, -1.0) for o in offs], [0] + [-o for o in offs] + offs,
                 format="csr")
    A.sort_indices()
    plan = plan_fused_neumann(*t_iluk(T.sparse.CSR(A.indptr, A.indices, A.data, A.shape),
                                      level=0), 3)
    assert len(plan.L.offsets) == 24 and plan.L.stray_ptr is None
    w = wavefront_schedule(n, plan.reach, 3, 8, 16, offsets=band_reads(plan))
    assert all(len(r) == MAX_RANGES for r in w.reads) and len(w.base) <= MAX_RANGES
    _check_schedule(w, [_host_factor(plan.L), _host_factor(plan.U)])
    R = np.random.default_rng(9).standard_normal((n, 1))
    got = _emulate(w, plan, R, window=w.grid, seed=4)
    ref = neumann_apply_plain(plan, torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["banded", "strayed"])
def test_wavefront_matches_pallas_fp32(kind):
    """The emulated wavefront apply in fp32 against the Pallas kernel run
    with interpret=True (rtol 1e-5, as test_plain_matches_pallas_fp32)."""
    (Lj, Uj), (Lt, Ut) = _factors(kind)
    r = np.random.default_rng(3).standard_normal(Lt.shape[0])
    z_pallas = np.asarray(jpn.fused_neumann_apply(jpn.plan_fused_neumann(Lj, Uj, 6),
                                                  jnp.asarray(r, jnp.float32),
                                                  interpret=True))
    plan = plan_fused_neumann(Lt, Ut, 6, dtype=torch.float32)
    w = wavefront_schedule(plan.n, plan.reach, 6, 32, 10, offsets=band_reads(plan))
    got = _emulate(w, plan, r.astype(np.float32)[:, None], window=w.grid, seed=3)[:, 0]
    np.testing.assert_allclose(got, z_pallas, rtol=1e-5, atol=1e-6)


def test_wavefront_schedule_at_the_kernels_shapes():
    """The planner at 128³ ILU(0) with the kernel's tiles (K2 in fp32:
    2,048 rows; K2k at k = 8: 1,024) and a card's worth of blocks: tiles
    halved only while a phase's items still fit one wave, rings past the
    reach and the tiles in flight; the ring budget of a deep sweep count
    shrinks the ring and the grid.  Tiles are halved while their band rows
    pass BAND_SMEM (48 diagonals: 256 rows); the window's halo is the
    reach of the diagonals within a tile."""
    # the kernel's rows a thread owns: fp32 8 at k = 1 and 4 at k = 8, fp64 4 and 2
    assert (tile_rows(8, 4, 3), tile_rows(4, 4, 3), tile_rows(4, 8, 3)) == (2048, 1024, 1024)
    assert tile_rows(8, 4, 48) == 256 and tile_rows(2, 8, 64) == THREADS
    assert halo_rows((-16384, -128, -1), 2048) == 128 and halo_rows((-4096,), 2048) == 0
    reach, n = 128 * 128, 128 ** 3
    for rpt, blocks in ((8, 132 * 4), (4, 132 * 2)):    # the blocks an H100 fits
        rows = THREADS * rpt
        w = wavefront_schedule(n, reach, 6, rows, blocks, ncols=1, min_rows=THREADS)
        assert w.rows == rows and w.tiles >= blocks    # enough tiles: no halving
        assert w.dep == -(-reach // w.rows) and w.grid == blocks
        assert w.ring_tiles == w.tiles or w.ring_tiles > w.dep + blocks
        assert w.ring_rows <= w.tiles * w.rows         # never more than full length
    blocks = 132 * 2
    w = wavefront_schedule(64 ** 3, 64 * 64, 6, THREADS * 8, blocks, min_rows=THREADS)
    assert w.rows == 1024 and w.tiles == 256           # 64³: halved while one wave holds it
    w = wavefront_schedule(n, reach, 381, THREADS * 8, blocks, ring_budget=1 << 18)
    assert w.ring_rows <= 1 << 18 and w.ring_tiles > w.dep and w.grid <= w.ring_tiles - w.dep - 1
    with pytest.raises(ValueError, match="sweeps"):
        wavefront_schedule(n, reach, 0, 256, 8)
    with pytest.raises(ValueError, match="power of two"):
        wavefront_schedule(n, reach, 6, 48, 8)


def test_ilu_pc_sweep_resolution():
    """ilu_sweeps None → exact on the CPU (the fused K2 plan on CUDA);
    k > 0 → the K2 plan, and with transpose=True also the transposed K2
    plan, whose apply is M.t; a setup without transpose raises on M.t
    instead of applying M⁻¹."""
    from lssp_tpu_torch.ops.neumann import plan_fused_neumann_t
    A = T.sparse.laplacian_2d(8)
    assert T.pc.setup(A, "ilu0", device="cpu").name == "ilu0"
    assert T.pc.setup(A, "ilu0", T.PCOptions(ilu_sweeps=3), device="cpu").name == "ilu0-fn3"
    Mn = T.pc.setup(A, "ilu0", T.PCOptions(ilu_sweeps=3, transpose=True), device="cpu")
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(64))
    L, U = t_iluk(A, level=0)
    assert Mn.name == "ilu0-fn3" and torch.equal(
        Mn.t(r), neumann_apply_plain(plan_fused_neumann_t(L, U, 3), r))
    assert torch.equal(Mn(r), neumann_apply_plain(plan_fused_neumann(L, U, 3), r))
    with pytest.raises(ValueError, match="transpose"):
        T.pc.setup(A, "ilu0", device="cpu").t(torch.ones(64, dtype=torch.float64))
    Mt = T.pc.setup(A, "ilu0", T.PCOptions(ilu_sweeps=0, transpose=True),
                    device="cpu")
    assert Mt.t(torch.ones(64, dtype=torch.float64)).shape == (64,)
    assert ttri.default_ilu_sweeps("cpu") == 0 and ttri.default_ilu_sweeps("cuda") == 6
    M = T.pc.setup(A, "iluk", T.PCOptions(ilu_sweeps=2), device="cpu")
    assert dataclasses.is_dataclass(M.state)


# ---------------------------------------------------------------------------
# K2 / K2k's launch, prepared once a plan (ops/neumann._apply), driven on the
# CPU through a stand-in for the kernel library
# ---------------------------------------------------------------------------

def _rows_per_thread(itemsize, kt):
    """The kernel's rows a thread owns (csrc/neumann.cu: RowsPerThread)."""
    return max((4 if kt == 8 else 8 // kt) * 4 // itemsize, 1)


def _h100_blocks(kt, rows, hmax, nd):
    """The blocks an H100 fits at once: 132 SMs, 2 a SM at kt = 8, else 4."""
    return 132 * (2 if kt == 8 else 4)


class _StubLib:
    """Stands in for ``_kernels.load()``: the kernel's rows a thread owns and
    an H100's blocks; keeps the arguments of every prepare (pointers as
    ints, the wait array as a list), run and release, and launches
    nothing.  ``fail`` makes prepare return that CUDA error."""

    def __init__(self, fail=0):
        self.prepared, self.runs, self.released, self.fail = [], [], [], fail
        self.handles = iter(range(0x1000, 0x2000))
        for suf, size in (("f32", 4), ("f64", 8)):
            setattr(self, f"lssp_neumann_rows_per_thread_{suf}",
                    functools.partial(_rows_per_thread, size))
            setattr(self, f"lssp_neumann_blocks_{suf}", _h100_blocks)
            setattr(self, f"lssp_neumann_prepare_{suf}", functools.partial(self._prepare, suf))
            setattr(self, f"lssp_neumann_run_{suf}", functools.partial(self._run, suf))
            setattr(self, f"lssp_neumann_release_{suf}", self.released.append)

    def _prepare(self, suf, *args):
        *args, handle = args
        if self.fail:
            return self.fail
        handle._obj.value = next(self.handles)
        self.prepared.append((suf, [a.value if isinstance(a, ctypes.c_void_p) else
                                    list(a) if isinstance(a, ctypes.Array) else a
                                    for a in args], handle._obj.value))
        return 0

    def _run(self, suf, *args):
        self.runs.append((suf, list(args)))
        return 0


def _any_device_check(name, t, dtype, shape=None):
    """``_kernels.check_cuda`` without its device rule, so CPU and meta
    tensors stand in for the card's."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


@pytest.fixture
def stub(monkeypatch):
    from lssp_tpu_torch import _kernels
    from lssp_tpu_torch.ops import neumann as nm
    lib = _StubLib()
    monkeypatch.setattr(_kernels, "load", lambda: lib)
    monkeypatch.setattr(_kernels, "check_cuda", _any_device_check)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda device: 77)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(nm, "_blocks_in_flight", {})
    monkeypatch.setattr(nm, "records", collections.Counter())
    return lib


class _Counter:
    launches, by_dtype = 0, {}


def _ilu0_plan_on_meta(n1d, sweeps, dtype=torch.float32):
    """The 7-point ILU(0) plan's layout at n1d³ (the factors' offsets and
    reach; no values) on the meta device, which allocates nothing."""
    n, offs = n1d ** 3, (-n1d * n1d, -n1d, -1)

    def factor(offsets):
        return NeumannFactor(band=torch.empty((3, n), dtype=dtype, device="meta"),
                             offsets=offsets,
                             offsets_t=torch.tensor(offsets, dtype=torch.int32).to("meta"))
    return FusedNeumann(L=factor(offs), U=factor(tuple(-o for o in reversed(offs))),
                        invdiag=torch.empty(n, dtype=dtype, device="meta"), n=n,
                        sweeps=sweeps, reach=n1d * n1d)


def _pre_record_args(plan, r, k, kt):
    """The prepare's arguments as the apply computed them for every launch
    before the launch was prepared once a plan (``launch_schedule`` and
    ``Wavefront.wait_sets()``), with the stand-in's rows and blocks."""
    isz = r.element_size()
    nd = max(len(plan.L.offsets), len(plan.U.offsets))
    rows = tile_rows(_rows_per_thread(isz, kt), isz, nd)
    hmax = max(halo_rows(F.offsets, rows) for F in (plan.L, plan.U))
    w = wavefront_schedule(plan.n, plan.reach, plan.sweeps, rows,
                           _h100_blocks(kt, rows, hmax, nd), k // kt, min_rows=THREADS,
                           ring_budget=RING_BYTES // (2 * max(plan.sweeps - 1, 1) * k * isz),
                           offsets=band_reads(plan))
    p = lambda t: None if t is None or t.data_ptr() == 0 else t.data_ptr()
    args = []
    for F in (plan.L, plan.U):
        args += [p(F.band), p(F.offsets_t), len(F.offsets), p(F.stray_ptr), p(F.stray_cols),
                 p(F.stray_vals)]
    return w, args + [p(plan.invdiag), plan.n, k, w.ring_rows, w.mask, w.sweeps, w.rows,
                      w.tiles, w.wait_sets(),
                      *[halo_rows(F.offsets, w.rows) for F in (plan.L, plan.U)], kt, w.grid]


def _record_cases():
    (_, (L, U)) = _factors("strayed")
    return {"ilu0_128^3_k1": (lambda: _ilu0_plan_on_meta(128, 6), None, 1),
            "ilu0_128^3_k8": (lambda: _ilu0_plan_on_meta(128, 6), 8, 8),
            "strayed_iluk1_fp64": (lambda: plan_fused_neumann(L, U, 4, dtype=torch.float64),
                                   None, 1)}


@pytest.mark.parametrize("case", ["ilu0_128^3_k1", "ilu0_128^3_k8", "strayed_iluk1_fp64"])
def test_launch_is_prepared_once_a_plan(stub, case):
    """The first apply of a plan builds its launch record, one prepare with
    exactly the arguments the apply computed for every launch before
    (schedule, wait sets, halos, kt, grid); later applies reuse it: one
    run each with the handle and that apply's own buffers, one launch
    counted each, ``records`` built 1 / reused 3."""
    from lssp_tpu_torch import _kernels
    from lssp_tpu_torch.ops import neumann as nm
    make, k, kt = _record_cases()[case]
    plan = make()
    r = torch.empty((plan.n,) if k is None else (plan.n, k), dtype=plan.dtype,
                    device=plan.invdiag.device)
    k = k or 1
    counter = _Counter()
    outs = [nm._apply(plan, r, k, counter) for _ in range(4)]
    assert dict(nm.records) == {"built": 1, "reused": 3} and counter.launches == 4
    (suf, args, handle), = stub.prepared
    w, want = _pre_record_args(plan, r, k, kt)
    assert suf == _kernels.SUFFIX[plan.dtype] and args == want
    assert list(plan._launches) == [(k, r.device, kt)]
    rec = plan._launches[(k, r.device, kt)]
    assert (rec.sched, rec.kt, rec.handle) == (w, kt, handle)
    z0_bytes = plan.n * k * r.element_size()
    levels_bytes = 2 * (plan.sweeps - 1) * w.ring_rows * k * r.element_size()
    assert rec.levels_at == z0_bytes
    assert rec.scratch - rec.flags_at == 4 * (2 * w.ncols * w.tiles + 1)
    assert rec.flags_at >= z0_bytes + levels_bytes and rec.flags_at % 16 == 0
    assert len(stub.runs) == 4
    for (s, (h, rp, z0, out, levels, flags, stream)), o in zip(stub.runs, outs):
        assert (s, h, rp, out, stream) == (suf, handle, r.data_ptr(), o.data_ptr(), 77)
        assert (levels - z0, flags - z0) == (rec.levels_at, rec.flags_at)


def test_replaced_plan_starts_without_launches(stub):
    """``dataclasses.replace`` gives a plan with no launch record: its first
    apply prepares anew, the original's record stays."""
    from lssp_tpu_torch.ops import neumann as nm
    (_, (L, U)) = _factors("banded")
    plan = plan_fused_neumann(L, U, 3, dtype=torch.float32)
    r = torch.ones(plan.n)
    nm._apply(plan, r, 1, _Counter())
    twin = dataclasses.replace(plan)
    assert twin._launches == {} and len(plan._launches) == 1
    nm._apply(twin, r, 1, _Counter())
    assert dict(nm.records) == {"built": 2} and len(stub.prepared) == 2
    assert twin._launches[(1, r.device, 1)] is not plan._launches[(1, r.device, 1)]


def test_new_k_or_alignment_prepares_a_new_launch(stub):
    """The record is keyed on (k, device, kt): k = 8 aligned (kt 8), the same
    block one float off its alignment (kt 1), k = 4 (kt 4) and k = 1 each
    prepare once; repeating any of them reuses its record."""
    from lssp_tpu_torch.ops import neumann as nm
    (_, (L, U)) = _factors("banded")
    plan = plan_fused_neumann(L, U, 6, dtype=torch.float32)
    n = plan.n
    buf = torch.zeros(n * 8 + 1)
    blocks = {8: buf[:n * 8].view(n, 8), 1: buf[1:].view(n, 8)}   # kt by alignment
    assert blocks[8].data_ptr() % 32 == 0 and blocks[1].data_ptr() % 8 == 4
    rs = [(blocks[8], 8, 8), (blocks[1], 8, 1), (torch.zeros(n, 4), 4, 4),
          (torch.zeros(n), 1, 1)]
    for _ in range(2):
        for r, k, _kt in rs:
            nm._apply(plan, r, k, _Counter())
    assert set(plan._launches) == {(k, r.device, kt) for r, k, kt in rs}
    assert dict(nm.records) == {"built": 4, "reused": 4}
    assert [args[-2] for _, args, _ in stub.prepared] == [8, 1, 4, 1]      # kt


def _broken_plans():
    (_, (L, U)) = _factors("banded")
    good = lambda: plan_fused_neumann(L, U, 2, dtype=torch.float32)
    many = dataclasses.replace(good().L, offsets=tuple(range(-65, 0)),
                               offsets_t=torch.arange(-65, 0, dtype=torch.int32),
                               band=torch.zeros(65, L.shape[0]))
    return {
        "65_diagonals": (lambda: dataclasses.replace(good(), L=many), ValueError, "diagonals"),
        "plan_on_another_device": (
            lambda: dataclasses.replace(good(), invdiag=good().invdiag.to("meta"),
                                        L=dataclasses.replace(good().L, band=good().L.band.to(
                                            "meta"))), ValueError, "plan on meta"),
        "factor_dtype": (lambda: dataclasses.replace(
            good(), U=dataclasses.replace(good().U, band=good().U.band.double())),
            TypeError, "U.band"),
        "sweeps_0": (lambda: dataclasses.replace(good(), sweeps=0), ValueError, "sweeps"),
        "float16": (lambda: plan_fused_neumann(L, U, 2, dtype=torch.float16), TypeError,
                    "float16"),
        "library_refuses": (good, RuntimeError, "lssp_neumann_prepare_f32.*error 1"),
    }


@pytest.mark.parametrize("case", list(_broken_plans()))
def test_a_plan_that_fails_its_checks_raises_on_every_apply(stub, case):
    """A plan the launch cannot take raises on its first apply and on every
    apply after (nothing is recorded), as before the launch was prepared
    once: too many diagonals, a factor on another device or of another
    dtype, no sweeps, a dtype the kernel lacks, a schedule the library
    refuses."""
    from lssp_tpu_torch.ops import neumann as nm
    make, exc, match = _broken_plans()[case]
    plan = make()
    stub.fail = 1 if case == "library_refuses" else 0
    r = torch.ones(plan.n, dtype=plan.dtype)
    for _ in range(2):
        with pytest.raises(exc, match=match):
            nm._apply(plan, r, 1, _Counter())
    assert plan._launches == {} and not nm.records and not stub.runs


def test_launch_handle_is_released_with_its_plan(stub):
    """The library's handle is freed once the plan (and so its record) is
    gone, and not before."""
    from lssp_tpu_torch.ops import neumann as nm
    (_, (L, U)) = _factors("banded")
    plan = plan_fused_neumann(L, U, 2, dtype=torch.float64)
    nm._apply(plan, torch.ones(plan.n, dtype=torch.float64), 1, _Counter())
    (_, _, handle), = stub.prepared
    assert stub.released == []
    del plan
    gc.collect()
    assert stub.released == [handle]
