"""Seeded test systems shared by the tests and ``chip_smoke.py`` (numpy
only, private).

- :func:`banded_spd`: a synthetic symmetric positive definite system on
  19 diagonals, the shape of the reference's ``case_10K`` (whose files are
  not in the repository), as COO triplets.
- :func:`laplacian3d_dia`: the 7-point Dirichlet Laplacian of
  ``Laplacian3DOperator`` in DIA form, built directly (the COO route costs
  ~15 M triplets through ``np.add.at`` at 128^3).
- :func:`rhs_stack`: a stack of right-hand sides that are not scalings
  of one another, with a zero row.
- :func:`spd_dense`: a dense SPD system by normal equations (the
  reference's sample1 recipe).
"""

from __future__ import annotations

import numpy as np

#: Positive offsets of :func:`banded_spd`; with their mirrors and the main
#: diagonal, 19 diagonals.
BANDED_OFFSETS = (1, 2, 3, 5, 8, 13, 50, 100, 1000)


def banded_spd(n: int = 10_000, seed: int = 0, shift: float = 1e-3):
    """``(rows, cols, vals, b)`` of a diagonally dominant SPD matrix on 19
    diagonals (offsets 0 and +-BANDED_OFFSETS) and ``b = A x_true`` with
    ``x_true`` uniform in [1, 2).  ``shift`` is the diagonal's margin over
    the off-diagonal row sums; a smaller one conditions the matrix worse."""
    rng = np.random.default_rng(seed)
    offs = [o for o in BANDED_OFFSETS if o < n]
    rows, cols, vals = [], [], []
    rowsum = np.zeros(n)
    for o in offs:
        i = np.arange(n - o)
        v = -rng.uniform(0.0, 1.0, n - o)
        rows += [i, i + o]
        cols += [i + o, i]
        vals += [v, v]
        np.add.at(rowsum, i, -v)
        np.add.at(rowsum, i + o, -v)
    i = np.arange(n)
    rows.append(i)
    cols.append(i)
    vals.append(rowsum + shift * (1.0 + rng.uniform(0.0, 1.0, n)))
    rows, cols, vals = (np.concatenate(a) for a in (rows, cols, vals))
    x_true = rng.uniform(1.0, 2.0, n)
    b = np.zeros(n)
    np.add.at(b, rows, vals * x_true[cols])
    return rows, cols, vals, b


def laplacian3d_dia(nz: int, ny: int, nx: int, dtype=np.float64):
    """``(offsets, diag_vals)`` of the 7-point Laplacian on an (nz, ny, nx)
    grid flattened z slowest: 6 on the diagonal, -1 to each face
    neighbour inside the grid (``diag_vals[d, i] = A[i, i + offsets[d]]``)."""
    z, y, x = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                          indexing="ij")
    z, y, x = z.ravel(), y.ravel(), x.ravel()
    sx, sy = 1, nx
    sz = nx * ny
    rules = {
        -sz: z > 0, -sy: y > 0, -sx: x > 0,
        sx: x < nx - 1, sy: y < ny - 1, sz: z < nz - 1,
    }
    offsets = sorted([0, *rules])
    diag_vals = np.empty((7, nz * ny * nx), dtype=dtype)
    for d, o in enumerate(offsets):
        diag_vals[d] = 6.0 if o == 0 else np.where(rules[o], -1.0, 0.0)
    return np.asarray(offsets, dtype=np.int64), diag_vals


def rhs_stack(n: int, nrhs: int, seed: int = 0):
    """An (nrhs, n) stack of right-hand sides whose systems stop at
    different iterations: ones, then a zero row (ALREADY_OPTIMIZED at
    t = 0), then rows uniform in [-1, 1) from ``seed``."""
    rng = np.random.default_rng(seed)
    B = np.empty((nrhs, n))
    B[0] = 1.0
    B[1:2] = 0.0
    B[2:] = rng.uniform(-1.0, 1.0, size=(max(nrhs - 2, 0), n))
    return B


def spd_dense(n: int = 80, seed: int = 42):
    """``(A, b)``: ``A = K^T K + 0.1 I`` with K uniform in [-1, 1) of shape
    (2n, n), and ``b = A x_true``, ``x_true`` uniform in [1, 2)."""
    rng = np.random.default_rng(seed)
    K = rng.uniform(-1.0, 1.0, size=(2 * n, n))
    A = K.T @ K + 0.1 * np.eye(n)
    return A, A @ rng.uniform(1.0, 2.0, size=n)
