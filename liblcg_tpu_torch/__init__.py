"""liblcg_tpu_torch: the PyTorch and CUDA port of liblcg_tpu, for NVIDIA
Hopper (H100).

The package keeps the JAX package's module layout and public names, so
each counterpart is found where the JAX one is.  It imports ``torch`` and
never ``jax``.  Every operator holds its tensors on one device, and the
vectors of a solve lie on that device too.

This slice ports the single right-hand-side ``solve()`` for CG and
Jacobi-PCG: the DIA ``BandedOperator`` with the whole-solve CUDA kernels
that replace the TPU's ``pallas_cg_dia`` and ``pallas_pcg_dia``, the plain
engine (``solvers/real.py``) for every other operator, ``DenseOperator``,
``MatrixFreeOperator`` and the matrix-free ``Laplacian3DOperator``.  The
CUDA kernels are built with ``nvcc`` at their first use.
"""

from .types import DEFAULT_PARAMS, SolverParams, SolveResult, Status
from .operators import (
    BandedOperator,
    DenseOperator,
    LinearOperator,
    MatrixFreeOperator,
    aslinearoperator,
    make_sparse_operator,
)
from .solve import (
    BLOCK_METHODS,
    COMPLEX_METHODS,
    REAL_METHODS,
    canonical_method,
    solve,
)
from .precond import JacobiPreconditioner
from .parallel import Laplacian3DOperator
from .utils.errors import LcgError, check_status, status_message
from .convert import banded_from_arrays, jacobi_from_arrays

__all__ = [
    "DEFAULT_PARAMS",
    "SolverParams",
    "SolveResult",
    "Status",
    "LinearOperator",
    "DenseOperator",
    "BandedOperator",
    "MatrixFreeOperator",
    "aslinearoperator",
    "make_sparse_operator",
    "solve",
    "canonical_method",
    "REAL_METHODS",
    "COMPLEX_METHODS",
    "BLOCK_METHODS",
    "JacobiPreconditioner",
    "Laplacian3DOperator",
    "LcgError",
    "check_status",
    "status_message",
    "banded_from_arrays",
    "jacobi_from_arrays",
]
