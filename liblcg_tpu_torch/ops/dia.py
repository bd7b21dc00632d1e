"""DIA (diagonal) sparse storage: ``y[i] = sum_d vals[d, i] * x[i + off_d]``.

PyTorch counterpart of ``liblcg_tpu/ops/dia.py``.  The product pads ``x``
once and adds one shifted slice per diagonal, over the offsets in sorted
order, exactly as the JAX version does, so the two round alike.  Both
products act on the last axis, so an (nrhs, n) stack is multiplied row by
row in one pass (JAX maps the 1-D product with ``jax.vmap``).  The
host-side conversion runs once in numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def coo_to_dia(
    n_rows: int,
    n_cols: int,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """COO triplets to DIA storage.

    Returns ``(offsets, diag_vals)``: ``offsets`` int64 (D,) sorted,
    ``diag_vals`` (D, n_rows) with ``diag_vals[d, i] = A[i, i + offsets[d]]``
    (zero where out of range).  Duplicates are summed.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    off = cols - rows
    offsets = np.unique(off)
    diag_vals = np.zeros((len(offsets), n_rows), dtype=vals.dtype)
    d_idx = np.searchsorted(offsets, off)
    np.add.at(diag_vals, (d_idx, rows), vals)
    return offsets, diag_vals


def dia_spmv(offsets, diag_vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for DIA storage of an (n, m) matrix, over the last axis of
    ``x`` (shape (..., m))."""
    n = diag_vals.shape[1]
    m = x.shape[-1]
    offs = [int(o) for o in offsets]
    pad_l = max(0, max((-o for o in offs), default=0))
    pad_r = max(0, max((n + o - m for o in offs), default=0))
    x_pad = F.pad(x, (pad_l, pad_r))
    y = None
    for d, o in enumerate(offs):
        term = diag_vals[d] * x_pad[..., pad_l + o : pad_l + o + n]
        y = term if y is None else y + term
    if y is None:
        y = x.new_zeros((*x.shape[:-1], n),
                        dtype=torch.promote_types(diag_vals.dtype, x.dtype))
    return y


def dia_spmv_transpose(offsets, diag_vals: torch.Tensor, x: torch.Tensor,
                       n_cols: int, conj: bool = False) -> torch.Tensor:
    """``A^T @ x`` (or ``A^H @ x``) from the same DIA storage, over the last
    axis of ``x``: ``(A^T x)[j] = sum_d v_d[j - o_d] * x[j - o_d]``."""
    n = diag_vals.shape[1]
    offs = [int(o) for o in offsets]
    vals = diag_vals.conj() if conj else diag_vals
    pad_l = max(0, max((o for o in offs), default=0))
    pad_r = max(0, max((n_cols - o - n for o in offs), default=0))
    y = None
    for d, o in enumerate(offs):
        p_pad = F.pad(vals[d] * x[..., :n], (pad_l, pad_r))
        term = p_pad[..., pad_l - o : pad_l - o + n_cols]
        y = term if y is None else y + term
    if y is None:
        y = x.new_zeros((*x.shape[:-1], n_cols),
                        dtype=torch.promote_types(diag_vals.dtype, x.dtype))
    return y
