"""Core types: solver parameters, status codes and solve results.

PyTorch counterpart of ``liblcg_tpu/types.py``.  ``Status`` carries the
reference's numeric codes (``lcg_return_enum``, util.h:69-90) and
``SolverParams`` the reference defaults (``defparam``, util.h:153) field for
field, so a solve reports the same codes through either package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch


class Status(enum.IntEnum):
    """Solver return codes, numerically identical to ``liblcg_tpu.Status``."""

    CONVERGENCE = 0
    STOP = 1
    ALREADY_OPTIMIZED = 2
    #: Internal sentinel: the solve is still in progress.  Never returned.
    RUNNING = 100

    UNKNOWN_ERROR = -1024
    INVALID_VARIABLE_SIZE = -1023
    INVALID_MAX_ITERATIONS = -1022
    INVALID_EPSILON = -1021
    INVALID_RESTART_EPSILON = -1020
    REACHED_MAX_ITERATIONS = -1019
    NULL_PRECONDITION_MATRIX = -1018
    NAN_VALUE = -1017
    INVALID_POINTER = -1016
    INVALID_LAMBDA = -1015
    INVALID_SIGMA = -1014
    INVALID_BETA = -1013
    INVALID_MAXIM = -1012
    SIZE_NOT_MATCH = -1011
    UNKNOWN_SOLVER = -1010

    @property
    def is_success(self) -> bool:
        return self.value >= 0

    def describe(self) -> str:
        from .utils.errors import status_message

        return status_message(self)


# Reference spelling kept as an alias (util.h:74 "LCG_ALREADY_OPTIMIZIED").
Status.ALREADY_OPTIMIZIED = Status.ALREADY_OPTIMIZED  # type: ignore[attr-defined]


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """Iteration-control parameters, the reference ``lcg_para``
    (util.h:95-148) with its defaults.  ``max_iterations == 0`` means
    "iterate until convergence", bounded by ``hard_iteration_cap``."""

    max_iterations: int = 0
    epsilon: float = 1e-6
    #: Nonzero selects ``sqrt(||r||^2)/N <= eps`` instead of the relative
    #: rule ``||r||^2 / max(||x||^2, 1) <= eps`` (lcg.cpp:186-209).
    abs_diff: int = 0
    restart_epsilon: float = 1e-6
    step: float = 1.0
    sigma: float = 0.95
    beta: float = 0.9
    maxi_m: int = 10
    hard_iteration_cap: int = 10000
    max_backtracks: int = 60
    #: Accumulate dot products in this dtype, cast back to the storage
    #: dtype.  None = storage dtype.
    reduce_dtype: Optional[str] = None

    def effective_max_iterations(self) -> int:
        return self.max_iterations if self.max_iterations > 0 else self.hard_iteration_cap

    def validate(self, for_method: str = "cg") -> Optional[Status]:
        """Pre-flight validation mirroring the engine entry checks
        (lcg.cpp:150-155, 1232-1238).  Returns an error Status or None."""
        if self.max_iterations < 0:
            return Status.INVALID_MAX_ITERATIONS
        if for_method == "bicgstab2":
            if self.epsilon <= 0.0:
                return Status.INVALID_EPSILON
            if self.restart_epsilon <= 0.0 or self.epsilon >= 1.0:
                return Status.INVALID_RESTART_EPSILON
        elif for_method == "pg":
            if self.epsilon <= 0.0:
                return Status.INVALID_EPSILON
            if self.step <= 0.0 or self.epsilon >= 1.0:
                return Status.INVALID_LAMBDA
        else:
            if self.epsilon <= 0.0 or self.epsilon >= 1.0:
                return Status.INVALID_EPSILON
        if for_method == "spg":
            if self.step <= 0.0:
                return Status.INVALID_LAMBDA
            if not (0.0 < self.sigma < 1.0):
                return Status.INVALID_SIGMA
            if not (0.0 < self.beta < 1.0):
                return Status.INVALID_BETA
            if self.maxi_m <= 0:
                return Status.INVALID_MAXIM
        return None


DEFAULT_PARAMS = SolverParams()


class SolveResult:
    """Result of a solve: ``x`` plus 0-d tensors ``status_code`` (int32),
    ``iterations`` (int32) and ``residual``, all on the solve's device, and
    an optional residual ``trace`` (``trace[t]`` is the residual at the top
    of iteration ``t``; entries past ``iterations`` hold zeros).  For
    ``solve_batched`` the three are per system, (nrhs,), and the trace is
    (nrhs, trace_len); ``solve_sequence`` adds a leading step axis."""

    __slots__ = ("x", "status_code", "iterations", "residual", "trace")

    def __init__(self, x, status_code, iterations, residual, trace=None):
        self.x = x
        self.status_code = status_code
        self.iterations = iterations
        self.residual = residual
        self.trace = trace

    @property
    def status(self) -> Status:
        return Status(int(self.status_code))

    @property
    def converged(self) -> bool:
        return int(self.status_code) in (
            Status.CONVERGENCE,
            Status.ALREADY_OPTIMIZED,
        )

    def __repr__(self):
        if self.status_code.ndim:
            names = [Status(int(c)).name for c in self.status_code.reshape(-1)]
            return (f"SolveResult(status={names}, "
                    f"iterations={self.iterations.reshape(-1).tolist()}, "
                    f"residual={self.residual.reshape(-1).tolist()})")
        s = Status(int(self.status_code)).name
        return (f"SolveResult(status={s}, iterations={int(self.iterations)}, "
                f"residual={float(self.residual):.6e})")


def as_torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def as_numpy_dtype(dtype) -> np.dtype:
    """A numpy dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)
