"""Status-code messages and the raise/print helper (``lcg_error_str``,
util.cpp:53-148): the same table and behaviour as
``liblcg_tpu/utils/errors.py``."""

from __future__ import annotations

import sys

from ..types import Status

_MESSAGES = {
    Status.CONVERGENCE: "Success! The iteration reached convergence.",
    Status.STOP: "Success! The iteration is stopped by the progress monitor.",
    Status.ALREADY_OPTIMIZED: "Success! The initial solution is already optimized.",
    Status.UNKNOWN_ERROR: "Unknown error.",
    Status.INVALID_VARIABLE_SIZE: "The size of the variables is negative.",
    Status.INVALID_MAX_ITERATIONS: "The maximal iteration times can't be negative.",
    Status.INVALID_EPSILON: "The convergence threshold can't be negative.",
    Status.INVALID_RESTART_EPSILON: "The restart threshold can't be negative.",
    Status.REACHED_MAX_ITERATIONS: "The maximal iteration times were reached.",
    Status.NULL_PRECONDITION_MATRIX: "The precondition matrix can't be null.",
    Status.NAN_VALUE: "The model values are NaN.",
    Status.INVALID_POINTER: "Invalid pointer.",
    Status.INVALID_LAMBDA: "Invalid value for lambda (initial step length).",
    Status.INVALID_SIGMA: "Invalid value for sigma.",
    Status.INVALID_BETA: "Invalid value for beta.",
    Status.INVALID_MAXIM: "Invalid value for maxi_m.",
    Status.SIZE_NOT_MATCH: "The sizes of the solution and the RHS do not match.",
    Status.UNKNOWN_SOLVER: "Unknown solver type.",
}


class LcgError(RuntimeError):
    """Raised by ``check_status(..., raise_error=True)``."""

    def __init__(self, status: Status):
        self.status = status
        super().__init__(status_message(status))


def status_message(status) -> str:
    status = Status(int(status))
    return _MESSAGES.get(status, f"Unrecognised status code {int(status)}.")


def check_status(status, raise_error: bool = False, quiet: bool = False):
    """Print (colourised like util.cpp:55-77) or raise for a status code.
    Returns the Status for chaining.  Success codes never raise."""
    status = Status(int(status))
    msg = status_message(status)
    if status.value < 0 and raise_error:
        raise LcgError(status)
    if not quiet:
        if status.value >= 0:
            prefix = "\033[1m\033[32mSuccess\033[0m" if sys.stderr.isatty() else "Success"
        else:
            prefix = "\033[1m\033[31mFail\033[0m" if sys.stderr.isatty() else "Fail"
        print(f"{prefix}: {msg}", file=sys.stderr)
    return status
