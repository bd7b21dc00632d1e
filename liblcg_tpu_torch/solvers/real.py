"""Real-domain Krylov engines of this slice: CG and PCG.

PyTorch counterpart of ``cg`` and ``pcg`` in ``liblcg_tpu/solvers/real.py``:
the same recurrences in the same order, run through
:func:`harness.run_loop`.  Each returns the harness carry, a dict with
``x``, ``status``, ``t``, ``residual`` and ``trace``.  A ``b`` of shape
(nrhs, n) solves the stack in lockstep through the batched loop; ``A.mv``
and ``M`` must then take (nrhs, n) stacks.
"""

from __future__ import annotations

import torch

from ..types import SolverParams
from . import harness as H


def _prep(b, x0):
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    return x


def cg(A, b, x0=None, *, params=SolverParams(), monitor=None, trace_len=0):
    """Conjugate gradient (Hestenes-Stiefel), reference ``lcg``
    lcg.cpp:143-274: one operator product and two reductions per
    iteration, iterating on the gradient g = Ax - b."""
    x = _prep(b, x0)
    n = b.shape[-1]
    acc = H.acc_dtype(params, b.dtype)

    gk = A.mv(x) - b
    carry = dict(
        x=x,
        gk=gk,
        dk=-gk,
        gk_mod=H.sq_norm(gk, acc),
        m_mod=torch.clamp(H.sq_norm(x, acc), min=1.0),
        t=0,
        trace=H.init_trace(trace_len, b),
    )

    def residual_fn(c):
        return H.real_residual(c["gk_mod"], c["m_mod"], n, params.abs_diff)

    def step_fn(c):
        Adk = A.mv(c["dk"])
        dTAd = H.dot_u(c["dk"], Adk, acc)
        ak = c["gk_mod"] / dTAd
        x = c["x"] + ak * c["dk"]
        gk = c["gk"] + ak * Adk
        gk1_mod = H.sq_norm(gk, acc)
        betak = gk1_mod / c["gk_mod"]
        dk = betak * c["dk"] - gk
        return dict(c, x=x, gk=gk, dk=dk, gk_mod=gk1_mod,
                    m_mod=torch.clamp(H.sq_norm(x, acc), min=1.0))

    return H.run_loop(carry, residual_fn=residual_fn, step_fn=step_fn,
                      x_of=lambda c: c["x"], params=params, monitor=monitor,
                      batched=b.ndim == 2)


def pcg(A, b, x0=None, *, M, params=SolverParams(), monitor=None, trace_len=0):
    """Preconditioned CG (Kaasschieter 1988 alg. 1), reference ``lpcg``
    lcg.cpp:293-434.  ``M`` is an operator or a callable applying M^{-1}."""
    x = _prep(b, x0)
    n = b.shape[-1]
    acc = H.acc_dtype(params, b.dtype)
    apply_M = M.mv if hasattr(M, "mv") else M

    rk = b - A.mv(x)
    zk = apply_M(rk)
    carry = dict(
        x=x,
        rk=rk,
        zk=zk,
        dk=zk,
        rk_mod=H.sq_norm(rk, acc),
        m_mod=torch.clamp(H.sq_norm(x, acc), min=1.0),
        zTr=H.dot_u(zk, rk, acc),
        t=0,
        trace=H.init_trace(trace_len, b),
    )

    def residual_fn(c):
        return H.real_residual(c["rk_mod"], c["m_mod"], n, params.abs_diff)

    def step_fn(c):
        Adk = A.mv(c["dk"])
        dTAd = H.dot_u(c["dk"], Adk, acc)
        ak = c["zTr"] / dTAd
        x = c["x"] + ak * c["dk"]
        rk = c["rk"] - ak * Adk
        zk = apply_M(rk)
        zTr1 = H.dot_u(zk, rk, acc)
        betak = zTr1 / c["zTr"]
        dk = zk + betak * c["dk"]
        return dict(c, x=x, rk=rk, zk=zk, dk=dk, rk_mod=H.sq_norm(rk, acc),
                    m_mod=torch.clamp(H.sq_norm(x, acc), min=1.0), zTr=zTr1)

    return H.run_loop(carry, residual_fn=residual_fn, step_fn=step_fn,
                      x_of=lambda c: c["x"], params=params, monitor=monitor,
                      batched=b.ndim == 2)
