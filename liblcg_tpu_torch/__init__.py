"""liblcg_tpu_torch: the PyTorch and CUDA port of liblcg_tpu, for NVIDIA
Hopper (H100).

The package keeps the JAX package's module layout and public names, so
each counterpart is found where the JAX one is.  It imports ``torch`` and
never ``jax``.  Every operator holds its tensors on one device, and the
vectors of a solve lie on that device too.

The port so far solves with CG and Jacobi-PCG: ``solve()`` for one
right-hand side, ``solve_batched()`` for an (nrhs, n) stack and
``solve_sequence()`` for a chain of dependent solves.  On the DIA
``BandedOperator`` they run whole-solve CUDA kernels that replace the
TPU's ``pallas_cg_dia``, ``pallas_pcg_dia`` and their batched forms; every
other operator (``DenseOperator``, ``MatrixFreeOperator``, the matrix-free
``Laplacian3DOperator``) runs the plain engine (``solvers/real.py``).  The
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
    BATCHED_METHODS,
    BLOCK_METHODS,
    COMPLEX_METHODS,
    REAL_METHODS,
    canonical_method,
    solve,
    solve_batched,
    solve_sequence,
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
    "solve_batched",
    "solve_sequence",
    "canonical_method",
    "REAL_METHODS",
    "COMPLEX_METHODS",
    "BLOCK_METHODS",
    "BATCHED_METHODS",
    "JacobiPreconditioner",
    "Laplacian3DOperator",
    "LcgError",
    "check_status",
    "status_message",
    "banded_from_arrays",
    "jacobi_from_arrays",
]
