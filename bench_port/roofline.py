"""The yardstick of the kernel metrics: the card's published peaks and
the least bytes each kernel of the port must move, from its shapes.

Bytes count each input once and each output once, whatever a kernel
reads again (``PERF.md``'s kernel table; the formulas are frozen here):

    K1   dia_spmv          (nd·n + 2n)·s
    K1k  dia_spmm          (nd·n + 2·k·n)·s
    K2   neumann (ILU(0))  ((ndL + ndU + 1)·n + 2n)·s
    K2k  neumann, k rhs    ((ndL + ndU + 1)·n + 2·k·n)·s

with s the element bytes of the launch (4 for fp32, 8 for fp64).  Every
one of these kernels is bound by bytes: a multiply and an add for each
byte pair is far under the card's FLOP rate.
"""
from __future__ import annotations

# published HBM bandwidth, bytes/s, of each card by the name that
# ``torch.cuda.get_device_name()`` gives (NVIDIA's data sheets)
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def k1_bytes(n: int, nd: int, s: int) -> int:
    return (nd * n + 2 * n) * s


def k1k_bytes(n: int, nd: int, k: int, s: int) -> int:
    return (nd * n + 2 * k * n) * s


def k2_bytes(n: int, nd_lower: int, nd_upper: int, s: int) -> int:
    return ((nd_lower + nd_upper + 1) * n + 2 * n) * s


def k2k_bytes(n: int, nd_lower: int, nd_upper: int, k: int, s: int) -> int:
    return ((nd_lower + nd_upper + 1) * n + 2 * k * n) * s


def share(launches, bytes_of, peak: float | None):
    """Share of the roofline in %: the least time the launches' bytes
    need at ``peak`` over their device time.  ``launches``: (element
    bytes, seconds) of each launch; ``bytes_of(s)``: the least bytes of
    one launch of element size ``s``.  None when there is nothing to
    read (no launch, an unknown card or element type)."""
    if not launches or peak is None or any(s is None for s, _ in launches):
        return None
    least = sum(bytes_of(s) for s, _ in launches) / peak
    spent = sum(sec for _, sec in launches)
    return 100.0 * least / spent if spent > 0 else None


def kernel_share(run, kernel: str, bytes_of):
    """``share`` of kernel ``kernel``'s launches in a run's traced stretch
    (``record.Run``); ``bytes_of(matrix, k, s)``: one launch's least
    bytes from ``generators.structure``, the rhs a request carries and the
    element bytes."""
    if not run.profiles or run.matrix is None:
        return None
    return share(run.profiles[0].kernel_launches(kernel),
                 lambda s: bytes_of(run.matrix, run.columns, s),
                 PEAK_BYTES_PER_S.get(run.card))
