"""Preconditioners: ``Preconditioner`` (apply function + device state), the
registry, ``setup``, and the PCs none, jacobi, user, ilu0, iluk, ilut,
ilutp, ssor, sor, gs, poly, chebyshev, ras, schwarz, bjacobi, biluk, bilut,
vbiluk, vbilut, amg, saamg, rsamg, arms and lu."""

from lssp_tpu_torch.pc.base import PC_REGISTRY, Preconditioner, setup
from lssp_tpu_torch.pc.ilu_host import (
    ilu0_numeric, iluk_factor, iluk_symbolic, ilut_factor, ilutp_factor,
)
from lssp_tpu_torch.pc import ilu as _ilu          # registers iluk/ilu0/ilut/ilutp
from lssp_tpu_torch.pc import amg as _amg          # registers amg/saamg/rsamg
from lssp_tpu_torch.pc import biluk as _biluk      # registers (v)biluk/(v)bilut
from lssp_tpu_torch.pc import poly as _poly        # registers poly/chebyshev
from lssp_tpu_torch.pc import relax as _relax      # registers ssor/sor/gs
from lssp_tpu_torch.pc import schwarz as _schwarz  # registers ras/schwarz/bjacobi
from lssp_tpu_torch.pc import lu as _lu            # registers lu
from lssp_tpu_torch.pc import arms as _arms        # registers arms

__all__ = ["Preconditioner", "setup", "PC_REGISTRY",
           "iluk_symbolic", "ilu0_numeric", "iluk_factor", "ilut_factor", "ilutp_factor"]
