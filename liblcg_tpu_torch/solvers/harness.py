"""Shared iteration harness for the single-RHS, single-device solve.

PyTorch counterpart of ``liblcg_tpu/solvers/harness.py``.  The JAX harness
compiles the loop into one ``lax.while_loop``; here the loop is plain
Python over tensors, so every iteration reads its stopping scalars back to
the host.  That is the plain engine: the whole-solve CUDA kernels of
``ops/cuda_cg.py`` are the path without the per-iteration round trip.

The semantics are the JAX ones (lcg.cpp:206-264): checks at the top of
every iteration in the order monitor -> epsilon -> max iterations; a NaN
in the recurrence poisons the residual, ends the loop and is classified
after it as NAN_VALUE; convergence at t == 0 is ALREADY_OPTIMIZED.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..types import SolverParams, Status, as_torch_dtype

Carry = Dict[str, Any]


def acc_dtype(params: SolverParams, value_dtype: torch.dtype) -> Optional[torch.dtype]:
    """The accumulation dtype ``SolverParams.reduce_dtype`` asks for, or
    None for the storage dtype."""
    if params.reduce_dtype is None:
        return None
    return torch.promote_types(value_dtype, as_torch_dtype(params.reduce_dtype))


def real_residual(r_sq, x_sq, n: int, abs_diff: bool):
    """Real-domain stopping metric (lcg.cpp:186-209).

    relative: ||r||^2 / max(||x||^2, 1)   (a ratio of squared norms)
    abs_diff: sqrt(||r||^2) / n
    """
    if abs_diff:
        return torch.sqrt(r_sq) / n
    return r_sq / torch.clamp(x_sq, min=1.0)


def _reduce_sum(v: torch.Tensor, acc: Optional[torch.dtype]) -> torch.Tensor:
    if acc is None:
        return torch.sum(v)
    return torch.sum(v, dtype=acc).to(v.dtype)


def sq_norm(v: torch.Tensor, acc: Optional[torch.dtype] = None) -> torch.Tensor:
    """||v||^2 as a real scalar."""
    if v.is_complex():
        return _reduce_sum(v.real * v.real + v.imag * v.imag, acc)
    return _reduce_sum(v * v, acc)


def dot_u(a: torch.Tensor, b: torch.Tensor,
          acc: Optional[torch.dtype] = None) -> torch.Tensor:
    """Unconjugated dot  sum_i a_i b_i  (``lcg_dot``)."""
    return _reduce_sum(a * b, acc)


def has_nan(x: torch.Tensor) -> torch.Tensor:
    """Reference NaN scan ``m[i] != m[i]`` (lcg.cpp:247-253)."""
    return torch.any(torch.isnan(x))


def init_trace(trace_len: int, dtype, device) -> Optional[torch.Tensor]:
    """Residual-trace buffer of ``trace_len`` zeros, or None."""
    if trace_len <= 0:
        return None
    return torch.zeros(trace_len, dtype=dtype, device=device)


def record_trace(trace: Optional[torch.Tensor], t: int, value) -> Optional[torch.Tensor]:
    """Write ``value`` at ``trace[t]`` in place; writes past the end are
    dropped, as the JAX harness's ``mode="drop"``."""
    if trace is not None and t < trace.shape[0]:
        trace[t] = value
    return trace


def run_loop(
    carry: Carry,
    *,
    residual_fn: Callable[[Carry], torch.Tensor],
    step_fn: Callable[[Carry], Carry],
    x_of: Callable[[Carry], torch.Tensor],
    params: SolverParams,
    monitor: Optional[Callable] = None,
) -> Carry:
    """Run the shared solve loop to completion.

    ``carry`` holds the Python int ``t`` (0 at entry), the solver's tensors
    and optionally ``trace``.  ``monitor(x, residual, t)`` returning True
    stops the solve with Status.STOP.  Returns the carry with ``status``,
    ``residual`` and ``t`` as 0-d tensors on the solve's device.
    """
    max_iter = params.effective_max_iterations()
    eps = params.epsilon

    def top_checks(c):
        res = residual_fn(c)
        stop = bool(monitor(x_of(c), res, c["t"])) if monitor is not None else False
        hit_max = params.max_iterations > 0 and c["t"] + 1 > params.max_iterations
        # NaN res compares False with everything -> the loop exits on NaN.
        keep_going = bool(res > eps) and not stop and not hit_max and c["t"] <= max_iter
        return keep_going, stop, res

    while True:
        keep_going, stop, res = top_checks(carry)
        if not keep_going:
            break
        record_trace(carry.get("trace"), carry["t"], res)
        carry = step_fn(dict(carry, t=carry["t"] + 1))

    x = x_of(carry)
    if bool(has_nan(x)) or bool(torch.isnan(res)):
        status = Status.NAN_VALUE
    elif stop:
        status = Status.STOP
    elif bool(res <= eps):
        status = Status.CONVERGENCE
    else:
        status = Status.REACHED_MAX_ITERATIONS
    record_trace(carry.get("trace"), carry["t"], res)
    carry = dict(carry, status=status, residual=res)
    return finalize(carry, device=x.device)


def finalize(carry: Carry, *, device) -> Carry:
    """Relabel convergence at t == 0 as ALREADY_OPTIMIZED (lcg.cpp:186-203)
    and turn ``status`` and ``t`` into int32 tensors on ``device``."""
    status = Status(carry["status"])
    if status == Status.CONVERGENCE and carry["t"] == 0:
        status = Status.ALREADY_OPTIMIZED
    return dict(
        carry,
        status=torch.tensor(int(status), dtype=torch.int32, device=device),
        t=torch.tensor(int(carry["t"]), dtype=torch.int32, device=device),
    )
