"""What one run of a cell recorded, as the metric readers see it."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Run:
    """One run of one cell.

    ``latencies``: seconds of each request of the window, from its start
    to the synchronise after it returned.  ``nits``: each request's inner
    iterations by column (a (k,) array).  ``window_s``: the window's
    length.  ``setup_s``: process start to the first timed request.
    ``phases_setup`` / ``phases_window``: the program's setup-phase ledger
    (``utils/profile``) of set-up's first ``prepare_ir`` and over the
    window.  ``collectives``: the program's collective calls over the
    window, by kind, on this rank.  ``profiles``: the traced stretch of
    each rank (this rank first), ``profiled``: the indices of the
    requests it covered.  ``matrix``: ``generators.structure`` of the
    system.  ``card``: the device's name."""

    cell: str
    config: dict
    traffic: dict
    latencies: list
    nits: list
    window_s: float
    setup_s: float
    phases_setup: dict = dataclasses.field(default_factory=dict)
    phases_window: dict = dataclasses.field(default_factory=dict)
    collectives: Optional[dict] = None
    profiles: list = dataclasses.field(default_factory=list)
    profiled: list = dataclasses.field(default_factory=list)
    matrix: Optional[dict] = None
    card: Optional[str] = None

    @property
    def requests(self) -> int:
        return len(self.latencies)

    @property
    def columns(self) -> int:
        """Right-hand sides a request carries."""
        return int(self.traffic.get("k", 1))

    def its(self, indices=None) -> int:
        """Inner iterations the requests ran: a block request runs as
        many as its slowest column."""
        sel = self.nits if indices is None else [self.nits[i] for i in indices]
        return int(sum(int(np.max(v)) for v in sel))
