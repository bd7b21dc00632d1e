"""DIA (diagonal) sparse storage: ``y[i] = sum_d vals[d, i] * x[i + off_d]``.

PyTorch counterpart of ``liblcg_tpu/ops/dia.py``.  The product pads ``x``
once and adds one shifted slice per diagonal, over the offsets in sorted
order, exactly as the JAX version does, so the two round alike.  The
host-side conversion runs once in numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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


def _padded(x: torch.Tensor, pad_l: int, pad_r: int) -> torch.Tensor:
    out = x.new_zeros(pad_l + x.shape[0] + pad_r)
    out[pad_l : pad_l + x.shape[0]] = x
    return out


def dia_spmv(offsets, diag_vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for DIA storage of an (n, m) matrix (``m = len(x)``)."""
    n = diag_vals.shape[1]
    m = x.shape[0]
    offs = [int(o) for o in offsets]
    pad_l = max(0, max((-o for o in offs), default=0))
    pad_r = max(0, max((n + o - m for o in offs), default=0))
    x_pad = _padded(x, pad_l, pad_r)
    y = None
    for d, o in enumerate(offs):
        term = diag_vals[d] * x_pad[pad_l + o : pad_l + o + n]
        y = term if y is None else y + term
    if y is None:
        y = x.new_zeros(n, dtype=torch.promote_types(diag_vals.dtype, x.dtype))
    return y


def dia_spmv_transpose(offsets, diag_vals: torch.Tensor, x: torch.Tensor,
                       n_cols: int, conj: bool = False) -> torch.Tensor:
    """``A^T @ x`` (or ``A^H @ x``) from the same DIA storage:
    ``(A^T x)[j] = sum_d v_d[j - o_d] * x[j - o_d]``."""
    n = diag_vals.shape[1]
    offs = [int(o) for o in offsets]
    vals = diag_vals.conj() if conj else diag_vals
    pad_l = max(0, max((o for o in offs), default=0))
    pad_r = max(0, max((n_cols - o - n for o in offs), default=0))
    y = None
    for d, o in enumerate(offs):
        p_pad = _padded(vals[d] * x[:n], pad_l, pad_r)
        term = p_pad[pad_l - o : pad_l - o + n_cols]
        y = term if y is None else y + term
    if y is None:
        y = x.new_zeros(n_cols, dtype=torch.promote_types(diag_vals.dtype, x.dtype))
    return y
