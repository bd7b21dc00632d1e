"""Matrix-free 3-D 7-point Laplacian (single device).

PyTorch counterpart of ``Laplacian3DOperator`` in
``liblcg_tpu/parallel/stencil.py``: ``(A u)[z,y,x] = 6 u[z,y,x]`` minus
the six face neighbours, homogeneous Dirichlet boundaries, symmetric
positive definite.  ``mv`` takes a vector or an (nrhs, n) stack.  The
sharded classes arrive with the parallel slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..operators import LinearOperator
from ..types import as_torch_dtype


class Laplacian3DOperator(LinearOperator):
    """7-point Laplacian on an (nz, ny, nx) grid, flattened with z slowest
    (row i = z*ny*nx + y*nx + x)."""

    takes_stack = True

    def __init__(self, nz: int, ny: int, nx: int, dtype=torch.float32, *,
                 device=None):
        self.grid = (int(nz), int(ny), int(nx))
        n = nz * ny * nx
        self.shape = (n, n)
        self.dtype = as_torch_dtype(dtype)
        self.device = torch.device(device if device is not None else "cpu")
        self.nnz = 7 * n - 2 * (nx * ny + ny * nz + nz * nx)

    def mv(self, x):
        lead = x.shape[:-1]
        p = F.pad(x.reshape(*lead, *self.grid), (1, 1, 1, 1, 1, 1))
        core = p[..., 1:-1, 1:-1, 1:-1]
        return (
            6.0 * core
            - p[..., :-2, 1:-1, 1:-1]
            - p[..., 2:, 1:-1, 1:-1]
            - p[..., 1:-1, :-2, 1:-1]
            - p[..., 1:-1, 2:, 1:-1]
            - p[..., 1:-1, 1:-1, :-2]
            - p[..., 1:-1, 1:-1, 2:]
        ).reshape(*lead, -1)

    def rmv(self, x):
        return self.mv(x)  # symmetric

    def hmv(self, x):
        return self.mv(x)

    def diagonal(self):
        return torch.full((self.shape[0],), 6.0, dtype=self.dtype,
                          device=self.device)

    def astype(self, dtype):
        nz, ny, nx = self.grid
        return Laplacian3DOperator(nz, ny, nx, dtype=dtype, device=self.device)
