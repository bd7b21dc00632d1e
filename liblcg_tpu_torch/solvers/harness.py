"""Shared iteration harness for single-device solves, one right-hand side
or a stack of them.

PyTorch counterpart of ``liblcg_tpu/solvers/harness.py``.  The JAX harness
compiles the loop into one ``lax.while_loop``; here the loop is plain
Python over tensors, so every iteration reads its stopping scalars back to
the host.  That is the plain engine: the whole-solve CUDA kernels of
``ops/cuda_cg.py`` are the path without the per-iteration round trip.

The semantics are the JAX ones (lcg.cpp:206-264): checks at the top of
every iteration in the order monitor -> epsilon -> max iterations; a NaN
in the recurrence poisons the residual, ends the loop and is classified
after it as NAN_VALUE; convergence at t == 0 is ALREADY_OPTIMIZED.

Batched (``run_loop(..., batched=True)``, the JAX ``with batched()``
context): vectors are (nrhs, n) and every reduction keeps an (nrhs, 1)
axis, so the same solver code runs a stack.  Each system carries its own
``t``; a finished system is frozen (every carry entry kept as it was), and
the loop runs while any system is alive.
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
    """Sum over the solve dimension: a 0-d tensor for a vector, (nrhs, 1)
    for a stack."""
    if v.ndim > 1:
        s = torch.sum(v, dim=-1, keepdim=True, dtype=acc)
    else:
        s = torch.sum(v, dtype=acc)
    return s if acc is None else s.to(v.dtype)


def sq_norm(v: torch.Tensor, acc: Optional[torch.dtype] = None) -> torch.Tensor:
    """||v||^2 as a real scalar (per system for a stack)."""
    if v.is_complex():
        return _reduce_sum(v.real * v.real + v.imag * v.imag, acc)
    return _reduce_sum(v * v, acc)


def dot_u(a: torch.Tensor, b: torch.Tensor,
          acc: Optional[torch.dtype] = None) -> torch.Tensor:
    """Unconjugated dot  sum_i a_i b_i  (``lcg_dot``)."""
    return _reduce_sum(a * b, acc)


def has_nan(x: torch.Tensor) -> torch.Tensor:
    """Reference NaN scan ``m[i] != m[i]`` (lcg.cpp:247-253); per system,
    (nrhs, 1), for a stack."""
    if x.ndim > 1:
        return torch.any(torch.isnan(x), dim=-1, keepdim=True)
    return torch.any(torch.isnan(x))


def init_trace(trace_len: int, b: torch.Tensor) -> Optional[torch.Tensor]:
    """Residual-trace buffer of ``trace_len`` zeros in ``b``'s dtype and
    device: (trace_len,) for a vector ``b``, (nrhs, trace_len) for a
    stack.  None when ``trace_len <= 0``."""
    if trace_len <= 0:
        return None
    return b.new_zeros((*b.shape[:-1], trace_len))


def record_trace(trace: Optional[torch.Tensor], t, value) -> Optional[torch.Tensor]:
    """Write ``value`` at ``trace[t]`` in place; writes past the end are
    dropped, as the JAX harness's ``mode="drop"``.  For an (nrhs,
    trace_len) trace, ``t`` and ``value`` hold one entry per system."""
    if trace is None:
        return None
    if trace.ndim == 2:
        t, value = t.reshape(-1), value.reshape(-1)
        rows = torch.nonzero(t < trace.shape[1]).reshape(-1)
        trace[rows, t[rows].long()] = value[rows].to(trace.dtype)
    elif t < trace.shape[0]:
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
    batched: bool = False,
) -> Carry:
    """Run the shared solve loop to completion.

    ``carry`` holds the Python int ``t`` (0 at entry), the solver's tensors
    and optionally ``trace``.  ``monitor(x, residual, t)`` returning True
    stops the solve with Status.STOP.  Returns the carry with ``status``,
    ``residual`` and ``t`` as 0-d tensors on the solve's device; with
    ``batched=True``, as (nrhs,) tensors (see :func:`_run_loop_batched`).
    """
    if batched:
        return _run_loop_batched(carry, residual_fn=residual_fn,
                                 step_fn=step_fn, x_of=x_of, params=params,
                                 monitor=monitor)
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


def _run_loop_batched(carry, *, residual_fn, step_fn, x_of, params, monitor):
    """The batched loop (JAX ``run_loop`` under ``batched()``,
    harness.py:299-369): ``x`` is (nrhs, n), ``t`` an (nrhs, 1) int32
    tensor inside the loop.  ``monitor(X, res, t)`` sees the stack with
    (nrhs, 1) ``res`` and ``t`` and may stop all systems or some.  A system
    is alive while ``res > eps``, not stopped, under the iteration limits;
    a step runs every system, and each carry entry of a finished system
    keeps its old value, so a converged system's 0/0 never reaches ``x``.
    Status, residual and ``t`` come back per system, shape (nrhs,)."""
    max_iter = params.effective_max_iterations()
    eps = params.epsilon
    x = x_of(carry)
    nrhs = x.shape[0]
    carry = dict(carry, t=torch.full((nrhs, 1), int(carry["t"]),
                                     dtype=torch.int32, device=x.device))

    def top_checks(c):
        res = residual_fn(c)
        stop = torch.zeros((), dtype=torch.bool, device=x.device)
        if monitor is not None:
            stop = torch.as_tensor(monitor(x_of(c), res, c["t"]),
                                   device=x.device).to(torch.bool)
        hit_max = (c["t"] + 1 > params.max_iterations) & (params.max_iterations > 0)
        alive = (res > eps) & ~stop & ~hit_max & (c["t"] <= max_iter)
        return alive, stop, res

    def freeze(new, old, alive):
        if not isinstance(new, torch.Tensor) or new.ndim == 0:
            return new
        return torch.where(alive.reshape(nrhs, *(1,) * (new.ndim - 1)), new, old)

    while True:
        alive, stop, res = top_checks(carry)
        if not bool(torch.any(alive)):
            break
        record_trace(carry.get("trace"), carry["t"], res)
        new = step_fn(dict(carry, t=carry["t"] + alive.to(torch.int32)))
        carry = {k: freeze(v, carry[k], alive) for k, v in new.items()}

    nan = has_nan(x_of(carry)) | torch.isnan(res)
    status = torch.where(
        nan, int(Status.NAN_VALUE),
        torch.where(stop, int(Status.STOP),
                    torch.where(res <= eps, int(Status.CONVERGENCE),
                                int(Status.REACHED_MAX_ITERATIONS))))
    record_trace(carry.get("trace"), carry["t"], res)
    t = carry["t"].reshape(-1)
    status = status.reshape(-1)
    status = torch.where((status == int(Status.CONVERGENCE)) & (t == 0),
                         int(Status.ALREADY_OPTIMIZED), status)
    return dict(carry, status=status.to(torch.int32), residual=res.reshape(-1),
                t=t)


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
