"""Share of the traced stretch in which the device ran nothing: 1 - the
union of its kernel and copy intervals over the stretch's wall, in %,
averaged over the ranks."""


def read(run):
    shares = [1.0 - p.busy_s / p.wall_s for p in run.profiles if p.wall_s > 0 and p.busy_s > 0]
    return 100.0 * sum(shares) / len(shares) if shares else None
