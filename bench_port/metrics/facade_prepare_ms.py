"""The facade's prepare step a request: the program's phase ledger
(``reorder_convert`` + ``upload`` + ``pc_build``) over the window, over
the requests.  On a warm memo this is the content-fingerprint check."""

PHASES = ("reorder_convert", "upload", "pc_build")


def read(run):
    if not run.requests or not run.phases_window:
        return None
    return 1e3 * sum(run.phases_window.get(p, 0.0) for p in PHASES) / run.requests
