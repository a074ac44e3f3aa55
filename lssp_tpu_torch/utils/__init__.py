"""Timers, logging and observability (the reference's src/utils.cxx), a
NaN guard, and checkpoint / resume: ``lssp_tpu/utils/`` name for name."""

from lssp_tpu_torch.utils.log import Timer, get_verbosity, log, set_log, set_verbosity, warning
from lssp_tpu_torch.utils.memory import device_memory_mb, host_memory_mb
from lssp_tpu_torch.utils.checkpoint import checkpointed_solve, load_checkpoint, save_checkpoint
from lssp_tpu_torch.utils import profile
from lssp_tpu_torch.utils.debug import check_finite, nan_guard

__all__ = ["set_verbosity", "get_verbosity", "log", "warning",
           "set_log", "Timer",
           "host_memory_mb", "device_memory_mb",
           "save_checkpoint", "load_checkpoint", "checkpointed_solve",
           "profile", "nan_guard", "check_finite"]
