"""Inner Krylov iterations a right-hand side: the solver's per-column
counts, averaged over every column of the window's requests."""


def read(run):
    cols = sum(len(v) for v in run.nits)
    return sum(float(sum(v)) for v in run.nits) / cols if cols else None
