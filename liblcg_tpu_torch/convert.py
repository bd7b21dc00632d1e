"""Carry operator and preconditioner state across from the JAX package.

The JAX package's state is handed over as numpy arrays, so this module
needs no JAX: ``A.offsets``, ``np.asarray(A.diag_vals)`` and
``np.asarray(M.inv_diag)`` of a ``liblcg_tpu`` BandedOperator and
JacobiPreconditioner become the port's objects, holding the same values.
"""

from __future__ import annotations

import numpy as np
import torch

from .operators import BandedOperator
from .precond.jacobi import JacobiPreconditioner


def banded_from_arrays(shape, offsets, diag_vals, *, device) -> BandedOperator:
    """A BandedOperator on ``device`` from DIA arrays: ``offsets`` sorted
    and distinct, ``diag_vals`` of shape (len(offsets), shape[0]) with
    ``diag_vals[d, i] = A[i, i + offsets[d]]``."""
    offsets = [int(o) for o in offsets]
    diag_vals = np.asarray(diag_vals)
    if offsets != sorted(set(offsets)):
        raise ValueError("offsets must be sorted and distinct")
    if diag_vals.shape != (len(offsets), int(shape[0])):
        raise ValueError(f"diag_vals has shape {diag_vals.shape}, expected "
                         f"{(len(offsets), int(shape[0]))}")
    return BandedOperator._from_dia(
        shape, offsets, torch.tensor(diag_vals, device=device),
        nnz=int(np.count_nonzero(diag_vals)))


def jacobi_from_arrays(inv_diag, *, device) -> JacobiPreconditioner:
    """A JacobiPreconditioner on ``device`` holding ``inv_diag`` as given
    (not recomputed as 1/diag, which would round twice)."""
    inv_diag = np.asarray(inv_diag)
    if inv_diag.ndim != 1:
        raise ValueError(f"inv_diag must be 1-D, got shape {inv_diag.shape}")
    return JacobiPreconditioner._from_inv_diag(torch.tensor(inv_diag, device=device))
