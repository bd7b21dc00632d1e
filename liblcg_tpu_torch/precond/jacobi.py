"""Jacobi (diagonal) preconditioner, the PyTorch counterpart of
``liblcg_tpu/precond/jacobi.py``."""

from __future__ import annotations

import torch

from ..operators import LinearOperator
from ..types import as_torch_dtype


class JacobiPreconditioner(LinearOperator):
    """M^{-1} x = x / diag(A).  Accepts an operator (its ``diagonal()`` is
    taken) or the diagonal itself as a 1-D tensor.  ``inv_diag`` is what
    the PCG kernel reads.  ``mv`` takes a vector or an (nrhs, n) stack."""

    takes_stack = True

    def __init__(self, diag_or_operator):
        if isinstance(diag_or_operator, LinearOperator):
            diag = diag_or_operator.diagonal()
        else:
            diag = torch.as_tensor(diag_or_operator)
            if diag.ndim != 1:
                raise ValueError(
                    "JacobiPreconditioner expects an operator or a 1-D diagonal"
                )
        self._set_inv_diag(1.0 / diag)

    def _set_inv_diag(self, inv_diag: torch.Tensor):
        self.inv_diag = inv_diag
        n = inv_diag.shape[0]
        self.shape = (n, n)
        self.dtype = inv_diag.dtype
        self.device = inv_diag.device

    @classmethod
    def _from_inv_diag(cls, inv_diag: torch.Tensor):
        obj = object.__new__(cls)
        obj._set_inv_diag(inv_diag)
        return obj

    def mv(self, x):
        return self.inv_diag * x

    def rmv(self, x):
        return self.mv(x)

    def cmv(self, x):
        return self.inv_diag.conj() * x

    def hmv(self, x):
        return self.cmv(x)

    def diagonal(self):
        return self.inv_diag

    def astype(self, dtype):
        return JacobiPreconditioner._from_inv_diag(
            self.inv_diag.to(as_torch_dtype(dtype)))
