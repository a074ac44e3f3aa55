"""Preconditioners: ``Preconditioner`` (apply function + device state), the
registry, ``setup``, and the PCs none, jacobi, ilu0, iluk, ilut, biluk,
bilut, vbiluk, vbilut, amg, saamg and rsamg."""

from lssp_tpu_torch.pc.base import PC_REGISTRY, Preconditioner, setup
from lssp_tpu_torch.pc.ilu_host import ilu0_numeric, iluk_factor, iluk_symbolic, ilut_factor
from lssp_tpu_torch.pc import ilu as _ilu          # registers iluk/ilu0/ilut
from lssp_tpu_torch.pc import amg as _amg          # registers amg/saamg/rsamg
from lssp_tpu_torch.pc import biluk as _biluk      # registers (v)biluk/(v)bilut

__all__ = ["Preconditioner", "setup", "PC_REGISTRY",
           "iluk_symbolic", "ilu0_numeric", "iluk_factor", "ilut_factor"]
