"""Linear operator protocol: ``mv(x) = A x``, ``rmv(x) = A^T x``,
``cmv(x) = conj(A) x``, ``hmv(x) = A^H x``.

PyTorch counterpart of ``liblcg_tpu/operators.py``.  Every operator holds
its tensors on one ``device``; the vectors it is applied to must lie there
too.  Only ``mv`` is required: ``rmv`` defaults to the algebraic transpose
(a vector-Jacobian product of the linear map).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .ops.dia import coo_to_dia, dia_spmv, dia_spmv_transpose
from .types import as_numpy_dtype, as_torch_dtype


class LinearOperator:
    """Abstract square (or rectangular) linear operator.

    Subclasses define ``mv`` and the ``shape``/``dtype``/``device``
    attributes.
    """

    shape: Tuple[int, int]
    dtype: torch.dtype
    device: torch.device
    #: True when ``mv`` also takes an (nrhs, n) stack, row by row in one
    #: call; the batched engine otherwise applies ``mv`` to each row.
    takes_stack: bool = False

    def mv(self, x):
        raise NotImplementedError

    def rmv(self, x):
        """A^T x, the vector-Jacobian product of the linear map ``mv``."""
        zero = torch.zeros(self.shape[1], dtype=self.dtype, device=self.device)
        _, vjp = torch.func.vjp(self.mv, zero)
        (out,) = vjp(x)
        return out

    def cmv(self, x):
        """conj(A) x = conj(A conj(x))."""
        if not self.dtype.is_complex:
            return self.mv(x)
        return self.mv(x.conj()).conj()

    def hmv(self, x):
        """A^H x = conj(A^T conj(x))."""
        if not self.dtype.is_complex:
            return self.rmv(x)
        return self.rmv(x.conj()).conj()

    def diagonal(self):
        """diag(A), used by the Jacobi preconditioner.  Optional."""
        raise NotImplementedError(f"{type(self).__name__} has no diagonal()")

    def astype(self, dtype) -> "LinearOperator":
        raise NotImplementedError(
            f"{type(self).__name__} cannot be cast to another dtype "
            "automatically; construct the operator at the target dtype"
        )

    def __matmul__(self, x):
        return self.mv(x)

    @property
    def n(self) -> int:
        return self.shape[1]


class DenseOperator(LinearOperator):
    """Dense matrix operator; the product is ``torch.matmul``.  ``mv`` takes
    a vector or an (nrhs, n) stack."""

    takes_stack = True

    def __init__(self, A, *, device=None):
        self.A = torch.as_tensor(A, device=device)
        self.shape = tuple(self.A.shape)
        self.dtype = self.A.dtype
        self.device = self.A.device

    def mv(self, x):
        return self.A @ x if x.ndim == 1 else x @ self.A.mT

    def rmv(self, x):
        return self.A.T @ x

    def cmv(self, x):
        return self.A.conj() @ x

    def hmv(self, x):
        return self.A.T.conj() @ x

    def diagonal(self):
        return torch.diagonal(self.A)

    def astype(self, dtype):
        return DenseOperator(self.A.to(as_torch_dtype(dtype)))


class BandedOperator(LinearOperator):
    """Sparse operator in DIA (diagonal) storage, built from COO triplets
    (duplicates summed).  ``offsets`` is a sorted tuple of ints and
    ``diag_vals`` a (D, n_rows) tensor with ``diag_vals[d, i] =
    A[i, i + offsets[d]]``.  The CUDA kernels of ``ops/cuda_cg.py`` take
    this storage as it is.  ``mv`` takes a vector or an (nrhs, n) stack."""

    takes_stack = True

    def __init__(self, n_rows: int, n_cols: int, rows, cols, vals, *,
                 dtype=None, device=None):
        vals = np.asarray(vals)
        if dtype is not None:
            vals = vals.astype(as_numpy_dtype(dtype))
        offsets, diag_vals = coo_to_dia(n_rows, n_cols, rows, cols, vals)
        self._set_dia((n_rows, n_cols), offsets,
                      torch.as_tensor(diag_vals, device=device), len(vals))

    def _set_dia(self, shape, offsets, diag_vals: torch.Tensor, nnz: int):
        self.shape = (int(shape[0]), int(shape[1]))
        self.offsets = tuple(int(o) for o in offsets)
        self.diag_vals = diag_vals
        self.dtype = diag_vals.dtype
        self.device = diag_vals.device
        self.nnz = int(nnz)

    @classmethod
    def _from_dia(cls, shape, offsets, diag_vals: torch.Tensor, nnz: int):
        obj = object.__new__(cls)
        obj._set_dia(shape, offsets, diag_vals, nnz)
        return obj

    def mv(self, x):
        return dia_spmv(self.offsets, self.diag_vals, x)

    def rmv(self, x):
        return dia_spmv_transpose(self.offsets, self.diag_vals, x, self.shape[1])

    def cmv(self, x):
        return dia_spmv(self.offsets, self.diag_vals.conj(), x)

    def hmv(self, x):
        return dia_spmv_transpose(self.offsets, self.diag_vals, x,
                                  self.shape[1], conj=True)

    def diagonal(self):
        if 0 in self.offsets:
            return self.diag_vals[self.offsets.index(0)]
        return torch.zeros(self.shape[0], dtype=self.dtype, device=self.device)

    def astype(self, dtype):
        return BandedOperator._from_dia(
            self.shape, self.offsets,
            self.diag_vals.to(as_torch_dtype(dtype)), self.nnz)

    @property
    def n_diagonals(self) -> int:
        return len(self.offsets)


def make_sparse_operator(
    n_rows: int,
    n_cols: int,
    rows,
    cols,
    vals,
    *,
    format: str = "auto",
    max_diagonals: int = 96,
    **kw,
) -> LinearOperator:
    """Build the sparse operator ``liblcg_tpu.make_sparse_operator`` would.

    The rule is the JAX one: diagonal-plus-few-couplings patterns go to
    ``ScatteredOperator``; patterns on at most ``max_diagonals`` diagonals
    whose DIA storage is not wildly larger than ELL go to DIA; the rest go
    to ELL.  This slice of the port has DIA only: where the rule picks
    another format, it raises ``NotImplementedError``.
    """
    if format not in ("auto", "dia", "ell", "scattered"):
        raise ValueError(f"unknown sparse format {format!r}")
    if format == "scattered" and n_rows != n_cols:
        raise ValueError(
            f"format='scattered' needs a square matrix (diagonal + "
            f"couplings); got {n_rows}x{n_cols}"
        )
    if format in ("auto", "scattered") and n_rows == n_cols:
        rows_a = np.asarray(rows)
        cols_a = np.asarray(cols)
        n_off = int(np.count_nonzero(rows_a != cols_a))
        diag_full = (len(rows_a) - n_off) >= n_rows
        if format == "scattered" or (diag_full and n_off <= 0.05 * n_rows):
            # ScatteredOperator's constructor refuses a zero or missing
            # diagonal entry; the JAX rule then falls through to DIA/ELL.
            v = np.asarray(vals)
            if kw.get("dtype") is not None:
                v = v.astype(as_numpy_dtype(kw["dtype"]))
            diag = np.zeros(n_rows, dtype=v.dtype)
            isdiag = rows_a == cols_a
            np.add.at(diag, rows_a[isdiag], v[isdiag])
            missing = int(np.sum(diag == 0))
            if format == "scattered" and missing:
                raise ValueError(
                    f"{missing} zero/missing diagonal entries; the "
                    f"diagonal-plus-scattered direct solve needs an invertible D"
                )
            if not missing:
                raise NotImplementedError(
                    "ScatteredOperator is not ported yet: it arrives with "
                    "the 'pair-complex API' slice of ROADMAP.md queue 1"
                )
    if format in ("auto", "dia"):
        off = np.asarray(cols, dtype=np.int64) - np.asarray(rows, dtype=np.int64)
        n_diags = len(np.unique(off))
        dia_cells = n_diags * n_rows
        if format == "dia" or (
            n_diags <= max_diagonals and dia_cells <= 8 * max(len(np.asarray(vals)), 1)
        ):
            return BandedOperator(n_rows, n_cols, rows, cols, vals,
                                  dtype=kw.get("dtype"), device=kw.get("device"))
    raise NotImplementedError(
        "SparseOperator (ELL storage) is not ported yet: it arrives with the "
        "'remaining operators' slice of ROADMAP.md queue 1"
    )


class MatrixFreeOperator(LinearOperator):
    """Wraps a linear callable on tensors (a bare ``lcg_axfunc_ptr``,
    lcg.h:37-38).  ``rmv`` defaults to the vector-Jacobian product."""

    def __init__(
        self,
        fun: Callable,
        n: int,
        dtype=torch.float64,
        *,
        m: Optional[int] = None,
        rmv_fun: Optional[Callable] = None,
        diag=None,
        device=None,
    ):
        self._fun = fun
        self._rmv_fun = rmv_fun
        self.shape = (m if m is not None else n, n)
        self.dtype = as_torch_dtype(dtype)
        self.device = torch.device(device if device is not None else "cpu")
        self._diag_val = None if diag is None else torch.as_tensor(diag, device=self.device)

    def mv(self, x):
        return self._fun(x)

    def rmv(self, x):
        if self._rmv_fun is not None:
            return self._rmv_fun(x)
        return super().rmv(x)

    def diagonal(self):
        if self._diag_val is None:
            raise NotImplementedError("matrix-free operator without diag")
        return self._diag_val


def aslinearoperator(A, **kw) -> LinearOperator:
    """Coerce a tensor / array / callable / operator into a LinearOperator.
    ``n=`` is required for a callable; ``dtype=`` and ``device=`` are
    passed on where they apply."""
    if isinstance(A, LinearOperator):
        return A
    if callable(A):
        if "n" not in kw:
            raise ValueError("matrix-free operator requires n=")
        return MatrixFreeOperator(A, **kw)
    arr = torch.as_tensor(A, device=kw.get("device"))
    if arr.ndim != 2:
        raise ValueError(f"expected 2-D array, got shape {tuple(arr.shape)}")
    return DenseOperator(arr)
