"""Logging and wall-clock timers (``lssp_tpu/utils/log.py``; the reference's
lssp_printf tee, reference src/utils.cxx:93-112, global verbosity
:20, timer :40-46).

Every line the port prints goes through ``log``: the solvers'
per-iteration trace (``solvers/base.history_update``), the refinement
rounds (``solvers/refine.py``) and the ``Solver`` phase timers, so
``set_log`` tees all of them.
"""
from __future__ import annotations

import sys
import time
from typing import Optional, TextIO

_verbosity = 2              # reference default lssp_verbosity = 2
_log_file: Optional[TextIO] = None


def set_verbosity(v: int) -> None:
    global _verbosity
    _verbosity = int(v)


def get_verbosity() -> int:
    return _verbosity


def set_log(f: Optional[TextIO]) -> None:
    """Tee output to a file as well (reference lssp_set_log)."""
    global _log_file
    _log_file = f


def log(msg: str, level: int = 1) -> None:
    """Print ``msg`` when the verbosity is at least ``level``, and tee it to
    the ``set_log`` file."""
    if _verbosity >= level:
        line = msg if msg.endswith("\n") else msg + "\n"
        sys.stdout.write(line)
        if _log_file is not None:
            _log_file.write(line)


def warning(msg: str) -> None:
    """Non-fatal warning on stderr, tee'd like ``log`` (reference
    lssp_warning, reference src/utils.cxx:137-157: prints, does not
    exit)."""
    line = f"warning: {msg}"
    if _verbosity >= 1:
        sys.stderr.write(line + "\n")
        if _log_file is not None:
            _log_file.write(line + "\n")


class Timer:
    """Context-manager wall timer (reference lssp_get_time wrapping, e.g.
    solver-cg.cxx:42,129-133): logs ``name: seconds s`` at ``level``."""

    def __init__(self, name: str = "", level: int = 2):
        self.name = name
        self.level = level
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        if self.name:
            log(f"{self.name}: {self.elapsed:.6f} s", self.level)
        return False


def device_print_supported() -> bool:
    """Always True.  JAX probes whether its backend runs device-side print
    callbacks and otherwise prints a recorded trace after the solve; the
    port's solvers are host loops that print each line as it happens, so
    there is nothing to probe."""
    return True
