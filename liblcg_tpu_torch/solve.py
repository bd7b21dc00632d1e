"""Top-level dispatch: ``solve()``, ``solve_batched()`` and
``solve_sequence()`` for CG and Jacobi-PCG.

PyTorch counterpart of ``liblcg_tpu/solve.py``.  The entry points keep the
JAX signatures, so one call runs against either package.  The port so far
solves with ``method="cg"`` and ``"pcg"``; every other method name the JAX
package knows raises ``NotImplementedError`` naming the ROADMAP.md slice
that brings it.

Routing: an eligible solve or stack (``ops.cuda_cg.kernel_ineligibility``)
on CUDA tensors runs one whole-solve CUDA kernel (``ops/cuda_cg.py``);
everything else runs the plain engine (``solvers/real.py``).
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

#: Methods ``liblcg_tpu.solve_batched`` takes (its BATCHED_METHODS,
#: solve.py:617-622); of these the port solves PORTED_METHODS so far.
BATCHED_METHODS = frozenset(
    {"cg", "pcg", "cg_fused", "cg_pipelined", "pcg_pipelined", "cgs", "bicgstab",
     "bicgstab2", "bicg", "bicg_sym", "pbicg", "chebyshev", "pg",
     "spg", "tfqmr", "gmres", "pgmres", "minres", "pminres"}
    | set(_BLOCK_METHODS)
)

#: Methods the port solves so far.
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


def _coerce(A, b, what: str):
    """``(A, b)`` as a LinearOperator and a tensor on its device.  A
    non-operator ``A`` is wrapped (``aslinearoperator``, n from ``b``'s
    last axis) on ``b``'s device."""
    if isinstance(A, LinearOperator):
        return A, _as_vector(b, A.device, what)
    b = b if isinstance(b, torch.Tensor) else torch.tensor(np.asarray(b))
    return aslinearoperator(A, n=b.shape[-1], dtype=b.dtype, device=b.device), b


def _as_vector(v, device, what: str) -> torch.Tensor:
    """``v`` as a tensor on ``device``; a tensor elsewhere is refused."""
    if isinstance(v, torch.Tensor):
        if v.device != torch.device(device):
            raise ValueError(f"{what} is on {v.device}, the operator on {device}")
        return v
    return torch.tensor(np.asarray(v), device=device)


def _check_results(result: SolveResult):
    """``check=True``: raise LcgError on the first failure status."""
    from .utils.errors import check_status

    for code in result.status_code.reshape(-1).tolist():
        check_status(code, raise_error=True, quiet=True)


def _refuse_unported(m: str, complex_input: bool):
    """Raise for a method or domain the port does not solve yet."""
    if m not in PORTED_METHODS:
        raise _not_ported(f"method {m!r}", _SLICE_OF[m])
    if complex_input:
        if m == "cg":
            raise ValueError("method 'cg' is not available in the complex domain")
        raise _not_ported("complex PCG", "native complex engines")


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
    A, b = _coerce(A, b, "b")
    if x0 is not None:
        x0 = _as_vector(x0, A.device, "x0")
    _refuse_unported(m, b.is_complex() or A.dtype.is_complex)

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
        _check_results(result)
    return result


def _try_pallas_cg_batched(A, B, X0, params, monitor, *, required, M=None,
                           method="cg"):
    """Multi-RHS analogue of :func:`_try_pallas_cg` (JAX solve.py:625-690):
    route an eligible CG/Jacobi-PCG stack to its batched whole-solve CUDA
    kernel.  The same rules: a monitor stays with the engine, and on CPU
    tensors an optional route returns None and a required one runs the
    kernel's plain version."""

    def fail(msg):
        if required:
            raise ValueError(f"pallas='always' but {msg}")
        return None

    if monitor is not None:
        return fail("the kernel does not support monitor")
    nrhs = B.shape[0]
    reason = cuda_cg.kernel_ineligibility(A, B.dtype, method, M,
                                          params.reduce_dtype, batched=True,
                                          nrhs=nrhs)
    if reason is not None:
        return fail(reason)
    if B.device.type == "cpu" and not required:
        return None

    common = dict(n=A.shape[0], nrhs=nrhs, eps=params.epsilon,
                  max_iter=params.effective_max_iterations(),
                  abs_diff=bool(params.abs_diff))
    B, X0 = B.contiguous(), X0.contiguous()
    if method == "pcg":
        X, t, res = cuda_cg.pcg_dia_batched(A.offsets, A.diag_vals, M.inv_diag,
                                            B, X0, **common)
    else:
        X, t, res = cuda_cg.cg_dia_batched(A.offsets, A.diag_vals, B, X0,
                                           **common)
    return SolveResult(x=X, status_code=kernel_status(t, res, params.epsilon),
                       iterations=t, residual=res, trace=None)


class _StackedOperator:
    """Applies a 1-D operator, or a callable applying M^{-1}, to an
    (nrhs, n) stack: JAX's ``_VmappedOperator`` and ``jax.vmap(M)``
    (solve.py:693-713, :1015).  An operator whose ``takes_stack`` is set
    applies its own ``mv`` to the stack; any other operator or callable
    goes row by row."""

    def __init__(self, op):
        self.shape = getattr(op, "shape", None)
        self.dtype = getattr(op, "dtype", None)
        self._mv = op.mv if isinstance(op, LinearOperator) else op
        self._stacks = getattr(op, "takes_stack", False)

    def mv(self, X):
        if self._stacks:
            return self._mv(X)
        return torch.stack([self._mv(x) for x in X])


def _batched_engine(m, A, B, X0, *, params, M, monitor=None, trace_len=0):
    """The plain engine on an (nrhs, n) stack; returns the harness carry."""
    engine = dict(params=params, monitor=monitor, trace_len=trace_len)
    if m == "pcg":
        return _real.pcg(_StackedOperator(A), B, X0, M=_StackedOperator(M),
                         **engine)
    return _real.cg(_StackedOperator(A), B, X0, **engine)


def solve_batched(
    A: Union[LinearOperator, torch.Tensor, Callable],
    B,
    X0=None,
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
    pallas: str = "auto",
) -> SolveResult:
    """Solve ``A x_i = b_i`` for a stack of right-hand sides at once.

    The signature is ``liblcg_tpu.solve_batched``'s.  ``B`` is (nrhs, n)
    on the operator's device; the result's ``x`` is (nrhs, n) and
    ``status_code`` / ``iterations`` / ``residual`` are per system,
    (nrhs,).  Every iteration applies A to all systems and reduces along
    the row axis; a finished system is frozen and the loop runs until all
    have finished.  ``monitor(X, res, t)`` receives the stack with (nrhs,
    1) ``res`` and ``t`` and may stop all systems or some (Status.STOP).
    ``trace_len > 0`` records an (nrhs, trace_len) residual trace.
    ``check=True`` raises LcgError on the first system that failed.

    pallas : as in :func:`solve`.  ``"auto"`` runs an eligible CG or
        Jacobi-PCG stack on CUDA tensors in one launch of the batched
        whole-solve kernel (K3/K4), ``"never"`` runs the engine,
        ``"always"`` requires the kernel (on CPU tensors: its plain
        version) and raises ValueError with the reason otherwise.
    """
    m = canonical_method(method)
    if m == "cacg":
        raise _not_ported("batched s-step CA-CG", _SLICE_OF["cacg"])
    if m not in BATCHED_METHODS:
        raise ValueError(
            f"method {m!r} does not support batched solves; available: "
            f"{sorted(BATCHED_METHODS)}"
        )
    if m == "bicgstab2" and params.abs_diff:
        raise ValueError(
            "bicgstab2 with abs_diff uses a mid-iteration exit that is not "
            "batchable; use abs_diff=0 or solve one system at a time"
        )
    A, B = _coerce(A, B, "B")
    if B.ndim != 2:
        raise ValueError(f"B must be (nrhs, n), got shape {tuple(B.shape)}")
    if m in _BLOCK_METHODS:
        raise _not_ported(f"method {m!r}", "GMRES, MINRES and block CG")
    _refuse_unported(m, B.is_complex() or A.dtype.is_complex)
    if X0 is not None:
        X0 = _as_vector(X0, A.device, "X0").to(B.dtype)

    err = params.validate(for_method=m)
    if err is not None:
        return _error_result(B if X0 is None else X0, err)
    if M is not None and m == "cg":
        raise ValueError(
            "method 'cg' does not use a preconditioner; M would be silently "
            "ignored.  Use the preconditioned variant ('pcg') or drop M."
        )
    if m == "pcg" and M is None:
        return _error_result(B, Status.NULL_PRECONDITION_MATRIX)
    if X0 is None:
        X0 = torch.zeros_like(B)
    elif X0.shape != B.shape:
        return _error_result(B, Status.SIZE_NOT_MATCH)

    if pallas not in ("auto", "never", "always"):
        raise ValueError(f"pallas must be auto/never/always, got {pallas!r}")
    result = None
    if pallas != "never":
        if trace_len > 0:
            if pallas == "always":
                raise ValueError(
                    "pallas='always' but the batched kernels do not support "
                    "trace recording; use pallas='never' or trace_len=0"
                )
        else:
            result = _try_pallas_cg_batched(A, B, X0, params, monitor,
                                            required=pallas == "always",
                                            M=M if m == "pcg" else None,
                                            method=m)
    if result is None:
        carry = _batched_engine(m, A, B, X0, params=params, M=M,
                                monitor=monitor, trace_len=trace_len)
        result = SolveResult(x=carry["x"], status_code=carry["status"],
                             iterations=carry["t"], residual=carry["residual"],
                             trace=carry.get("trace"))
    if check:
        _check_results(result)
    return result


def solve_sequence(
    A: Union[LinearOperator, torch.Tensor, Callable],
    b0,
    next_b: Callable,
    num_steps: int,
    *,
    method: str = "cg",
    params: SolverParams = DEFAULT_PARAMS,
    M=None,
    x0=None,
    warm_start: bool = True,
    keep_solutions: bool = True,
    lmin=None,
    lmax=None,
    restart: int = 32,
    s: int = 4,
    check: bool = False,
) -> SolveResult:
    """Solve a chain of dependent systems ``A x_k = b_k``: ``b_0 = b0`` and
    ``b_{k+1} = next_b(x_k, k)``, e.g. backward-Euler steps with
    ``next_b = lambda x, k: x``.

    The signature is ``liblcg_tpu.solve_sequence``'s.  JAX runs the chain
    as one ``lax.scan``; here it is a Python loop over the plain engine
    (JAX too resolves its engine with ``pallas="never"``).  With
    ``warm_start`` each solve starts from the previous solution (the first
    from ``x0``, zeros by default).  ``x`` is (num_steps, n) with
    ``keep_solutions``, else the last solution; status, iterations and
    residual are per step, (num_steps,).  A ``b0`` of shape (nrhs, n)
    advances nrhs systems per step through the batched engine: the
    per-step leaves gain the nrhs axis and ``next_b`` receives the stack.
    """
    m = canonical_method(method)
    A, b0 = _coerce(A, b0, "b0")
    batched = b0.ndim == 2
    if b0.ndim > 2:
        raise ValueError(f"b0 must be (n,) or (nrhs, n), got {tuple(b0.shape)}")
    if batched and m not in BATCHED_METHODS:
        raise ValueError(
            f"method {m!r} does not support batched solves; available: "
            f"{sorted(BATCHED_METHODS)}"
        )
    if m in _BLOCK_METHODS or m in ("pg", "spg"):
        raise ValueError(
            f"solve_sequence supports the unconstrained single-RHS "
            f"methods; got {m!r}"
        )
    _refuse_unported(m, b0.is_complex() or A.dtype.is_complex)
    err = params.validate(for_method=m)
    if err is not None:
        return _error_result(b0, err)
    if M is not None and m == "cg":
        raise ValueError(
            "method 'cg' does not use a preconditioner; M would be silently "
            "ignored.  Use the preconditioned variant ('pcg') or drop M."
        )
    if m == "pcg" and M is None:
        return _error_result(b0, Status.NULL_PRECONDITION_MATRIX)
    x0 = torch.zeros_like(b0) if x0 is None else _as_vector(x0, A.device, "x0").to(b0.dtype)

    def run(b, x_start):
        if batched:
            return _batched_engine(m, A, b, x_start, params=params, M=M)
        if m == "pcg":
            return _real.pcg(A, b, x_start, M=M, params=params)
        return _real.cg(A, b, x_start, params=params)

    x_prev, b = x0, b0
    xs, status, t, res = [], [], [], []
    for k in range(int(num_steps)):
        c = run(b, x_prev if warm_start else x0)
        x_prev = c["x"]
        b = torch.as_tensor(next_b(x_prev, k), dtype=b.dtype, device=b.device)
        xs.append(x_prev)
        status.append(c["status"])
        t.append(c["t"])
        res.append(c["residual"])

    def steps(leaves, like):
        return torch.stack(leaves) if leaves else like.new_empty((0, *like.shape))

    per_system = b0[..., 0]
    result = SolveResult(
        x=steps(xs, b0) if keep_solutions else x_prev,
        status_code=steps(status, per_system.to(torch.int32)),
        iterations=steps(t, per_system.to(torch.int32)),
        residual=steps(res, per_system),
        trace=None,
    )
    if check:
        _check_results(result)
    return result
