"""Top-level dispatch: ``solve()`` for CG and Jacobi-PCG.

PyTorch counterpart of ``liblcg_tpu/solve.py``.  ``solve()`` keeps the JAX
signature, so one call runs against either package.  This slice of the
port solves with ``method="cg"`` and ``"pcg"``; every other method name the
JAX package knows raises ``NotImplementedError`` naming the ROADMAP.md
slice that brings it.

Routing: an eligible solve (``ops.cuda_cg.kernel_ineligibility``) on CUDA
tensors runs one whole-solve CUDA kernel (``ops/cuda_cg.py``); everything
else runs the plain engine (``solvers/real.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from .operators import LinearOperator, aslinearoperator
from .ops import cuda_cg
from .solvers import real as _real
from .types import DEFAULT_PARAMS, SolverParams, SolveResult, Status

_REAL_METHODS = ("cg", "pcg", "cg_fused", "cg_pipelined", "pcg_pipelined",
                 "cgs", "bicgstab", "bicgstab2", "pg", "spg")
_CPLX_METHODS = ("bicg", "bicg_sym", "cgs", "bicgstab", "tfqmr", "pcg",
                 "pbicg")
_EXTRA_METHODS = ("chebyshev", "gmres", "pgmres", "minres", "pminres",
                  "cacg")
_BLOCK_METHODS = ("block_cg", "block_pcg")

#: Reference enum spellings (util.cpp:39-51, :157-166) and short aliases.
_ALIASES = {
    "cgf": "cg_fused",
    "cgp": "cg_pipelined",
    "pcgp": "pcg_pipelined",
    "bcg": "block_cg",
    "bpcg": "block_pcg",
    "ca_cg": "cacg",
    "sstep_cg": "cacg",
    "LCG_CG": "cg",
    "LCG_PCG": "pcg",
    "LCG_CGS": "cgs",
    "LCG_BICGSTAB": "bicgstab",
    "LCG_BICGSTAB2": "bicgstab2",
    "LCG_PG": "pg",
    "LCG_SPG": "spg",
    "CLCG_BICG": "bicg",
    "CLCG_BICG_SYM": "bicg_sym",
    "CLCG_CGS": "cgs",
    "CLCG_BICGSTAB": "bicgstab",
    "CLCG_TFQMR": "tfqmr",
    "CLCG_PCG": "pcg",
    "CLCG_PBICG": "pbicg",
}

REAL_METHODS = _REAL_METHODS + _EXTRA_METHODS
BLOCK_METHODS = _BLOCK_METHODS
COMPLEX_METHODS = _CPLX_METHODS + ("gmres", "pgmres")

#: Methods this slice of the port solves.
PORTED_METHODS = ("cg", "pcg")

#: The ROADMAP.md queue-1 slice that ports each other method.
_SLICE_OF = {
    **{m: "other real methods" for m in (
        "cg_fused", "cg_pipelined", "pcg_pipelined", "cgs", "bicgstab",
        "bicgstab2", "pg", "spg", "chebyshev")},
    **{m: "native complex engines" for m in ("bicg", "bicg_sym", "tfqmr",
                                             "pbicg")},
    **{m: "GMRES, MINRES and block CG" for m in ("gmres", "pgmres", "minres",
                                                 "pminres")},
    "cacg": "s-step CA-CG",
}


def canonical_method(method: str) -> str:
    """Resolve a method name or reference enum spelling to its short name."""
    m = _ALIASES.get(method, method).lower()
    if (m not in _REAL_METHODS and m not in _CPLX_METHODS
            and m not in _EXTRA_METHODS and m not in _BLOCK_METHODS):
        raise ValueError(
            f"unknown solver {method!r}; real methods: {sorted(REAL_METHODS)}, "
            f"complex methods: {sorted(COMPLEX_METHODS)}, "
            f"multi-RHS-only: {sorted(_BLOCK_METHODS)}"
        )
    return m


def _not_ported(what: str, slice_name: str):
    return NotImplementedError(
        f"{what} is not ported yet: it arrives with the {slice_name!r} slice "
        f"of ROADMAP.md queue 1"
    )


def _as_vector(v, device, what: str) -> torch.Tensor:
    """``v`` as a tensor on ``device``; a tensor elsewhere is refused."""
    if isinstance(v, torch.Tensor):
        if v.device != torch.device(device):
            raise ValueError(f"{what} is on {v.device}, the operator on {device}")
        return v
    return torch.tensor(np.asarray(v), device=device)


def _error_result(x, status: Status) -> SolveResult:
    real = x.real.dtype if x.is_complex() else x.dtype
    return SolveResult(
        x=x,
        status_code=torch.tensor(int(status), dtype=torch.int32, device=x.device),
        iterations=torch.tensor(0, dtype=torch.int32, device=x.device),
        residual=torch.tensor(float("nan"), dtype=real, device=x.device),
        trace=None,
    )


def _try_pallas_cg(A, b, x0, params, monitor, trace_len, *, required,
                   M=None, method="cg"):
    """Route an eligible CG/PCG solve to its whole-solve CUDA kernel.

    The rules of the JAX function of the same name (solve.py:301-380):
    monitor and trace stay with the engine; ``kernel_ineligibility`` gives
    the reason a solve cannot run on the kernel.  On CPU tensors an
    optional route returns None (the engine runs) and a required one runs
    the kernel's plain version, as JAX runs its interpreter.  Returns a
    SolveResult, or None when the solve is ineligible and not ``required``.
    """

    def fail(msg):
        if required:
            raise ValueError(f"pallas='always' but {msg}")
        return None

    if monitor is not None or trace_len > 0:
        return fail("the kernel does not support monitor/trace")
    reason = cuda_cg.kernel_ineligibility(A, b.dtype, method, M,
                                          params.reduce_dtype)
    if reason is not None:
        return fail(reason)
    if b.device.type == "cpu" and not required:
        return None

    x0_arr = torch.zeros_like(b) if x0 is None else x0.to(b.dtype).contiguous()
    common = dict(n=A.shape[0], eps=params.epsilon,
                  max_iter=params.effective_max_iterations(),
                  abs_diff=bool(params.abs_diff))
    if method == "pcg":
        x, t, res = cuda_cg.pcg_dia(A.offsets, A.diag_vals, M.inv_diag,
                                    b.contiguous(), x0_arr, **common)
    else:
        x, t, res = cuda_cg.cg_dia(A.offsets, A.diag_vals, b.contiguous(),
                                   x0_arr, **common)
    return SolveResult(x=x, status_code=kernel_status(t, res, params.epsilon),
                       iterations=t, residual=res, trace=None)


def kernel_status(t: torch.Tensor, res: torch.Tensor, eps: float) -> torch.Tensor:
    """The status of a whole-solve kernel's ``(t, res)``, as the JAX route
    maps it (solve.py:369-378), computed on the device without a sync."""
    conv = res <= eps
    return torch.where(
        torch.isnan(res), int(Status.NAN_VALUE),
        torch.where(
            conv & (t == 0), int(Status.ALREADY_OPTIMIZED),
            torch.where(conv, int(Status.CONVERGENCE),
                        int(Status.REACHED_MAX_ITERATIONS)),
        ),
    ).to(torch.int32)


def solve(
    A: Union[LinearOperator, torch.Tensor, Callable],
    b,
    x0=None,
    *,
    method: str = "cg",
    params: SolverParams = DEFAULT_PARAMS,
    M=None,
    lower=None,
    upper=None,
    monitor: Optional[Callable] = None,
    trace_len: int = 0,
    key=None,
    lmin=None,
    lmax=None,
    restart: int = 32,
    s: int = 4,
    check: bool = False,
    lower_inclusive: bool = True,
    upper_inclusive: bool = True,
    pallas: str = "auto",
) -> SolveResult:
    """Solve ``A x = b`` with CG or Jacobi-PCG.

    The signature is ``liblcg_tpu.solve``'s.  ``A`` is a LinearOperator, a
    2-D tensor/array (wrapped in ``DenseOperator``) or a callable (with
    ``n`` taken from ``b``).  ``b`` and ``x0`` are tensors on the
    operator's device; arrays are moved there.  ``M`` applies M^{-1} for
    ``method="pcg"``.  ``monitor(x, residual, t)`` returning True stops the
    solve with Status.STOP; ``trace_len > 0`` records the first residuals.
    ``check=True`` raises LcgError on a failure status.  The arguments
    ``lower``, ``upper``, ``key``, ``lmin``, ``lmax``, ``restart``, ``s``
    and the ``*_inclusive`` flags belong to methods later slices port.

    pallas : selects the hand-written CUDA kernel (``ops/cuda_cg.py``),
        the port's counterpart of the JAX package's Pallas kernels.
        ``"auto"`` runs an eligible solve on CUDA tensors in one
        whole-solve kernel launch and everything else on the plain engine;
        ``"never"`` always runs the engine; ``"always"`` requires the kernel
        and raises ValueError with the reason when the solve is not
        eligible.  On CPU tensors ``"always"`` runs the kernel's plain
        version (the counterpart of JAX's interpreter, for tests).
    """
    m = canonical_method(method)
    if m in _BLOCK_METHODS:
        raise ValueError(
            f"method {m!r} solves a stack of right-hand sides in one shared "
            f"block Krylov space; call solve_batched(A, B, method={m!r}) "
            f"with B of shape (nrhs, n)"
        )
    if m not in PORTED_METHODS:
        raise _not_ported(f"method {m!r}", _SLICE_OF[m])
    if isinstance(A, LinearOperator):
        b = _as_vector(b, A.device, "b")
    else:
        b = b if isinstance(b, torch.Tensor) else torch.tensor(np.asarray(b))
        A = aslinearoperator(A, n=b.shape[0], dtype=b.dtype, device=b.device)
    if x0 is not None:
        x0 = _as_vector(x0, A.device, "x0")

    if b.is_complex() or A.dtype.is_complex:
        if m == "cg":
            raise ValueError("method 'cg' is not available in the complex domain")
        raise _not_ported("complex PCG", "native complex engines")

    err = params.validate(for_method=m)
    if err is not None:
        return _error_result(torch.zeros_like(b) if x0 is None else x0, err)
    if M is not None and m == "cg":
        raise ValueError(
            "method 'cg' does not use a preconditioner; M would be silently "
            "ignored.  Use the preconditioned variant ('pcg') or drop M."
        )
    if m == "pcg" and M is None:
        return _error_result(torch.zeros_like(b) if x0 is None else x0,
                             Status.NULL_PRECONDITION_MATRIX)
    if b.ndim != 1:
        return _error_result(b, Status.INVALID_VARIABLE_SIZE)
    if x0 is not None and x0.shape != b.shape:
        return _error_result(b, Status.SIZE_NOT_MATCH)

    if pallas not in ("auto", "never", "always"):
        raise ValueError(f"pallas must be auto/never/always, got {pallas!r}")
    result = None
    if pallas != "never":
        result = _try_pallas_cg(A, b, x0, params, monitor, trace_len,
                                required=pallas == "always",
                                M=M if m == "pcg" else None, method=m)
    if result is None:
        engine = dict(params=params, monitor=monitor, trace_len=trace_len)
        if m == "pcg":
            carry = _real.pcg(A, b, x0, M=M, **engine)
        else:
            carry = _real.cg(A, b, x0, **engine)
        result = SolveResult(x=carry["x"], status_code=carry["status"],
                             iterations=carry["t"], residual=carry["residual"],
                             trace=carry.get("trace"))
    if check:
        from .utils.errors import check_status

        check_status(result.status_code, raise_error=True, quiet=True)
    return result
