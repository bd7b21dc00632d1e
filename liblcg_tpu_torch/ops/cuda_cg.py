"""Whole-solve CG and Jacobi-PCG kernels on DIA storage (CUDA, Hopper).

Counterpart of the TPU kernels of ``liblcg_tpu/ops/pallas_cg.py``:
``pallas_cg_dia`` (K1), ``pallas_pcg_dia`` (K2) and their multi-RHS forms
``pallas_cg_dia_batched`` (K3) and ``pallas_pcg_dia_batched`` (K4), all in
``csrc/cg_dia.cu``.  One cooperative launch runs the entire solve, so no
scalar crosses to the host inside the loop.

Beside each wrapper sits its plain PyTorch version (``*_reference``), with
the same signature, loop and exit rule (for K3/K4 also the per-system
freezing and zero guards).  A wrapper given CPU tensors runs
the plain version; given CUDA tensors it launches the kernel or raises.
Each wrapper counts its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .dia import dia_spmv

#: The kernel's shared-memory offset table holds this many diagonals
#: (``kMaxDiags`` in csrc/cg_dia.cu).
MAX_DIAGONALS = 256

#: Largest n: the kernel's grid-stride index ``i + gridDim.x * blockDim.x``
#: must stay below 2**31.
MAX_N = 2**31 - 2**25

#: Most right-hand sides a batched kernel takes: it keeps each system's
#: scalars in shared memory (``kMaxRhs`` in csrc/cg_dia.cu).
MAX_RHS = 64

#: Fewest stack rows per thread a batched grid is sized for.  Every block
#: reads all blocks' partials of every (sum, system) at each reduction, so
#: a grid larger than the work needs costs more in partials than it hides.
_ROWS_PER_THREAD = 4

KERNEL_METHODS = ("cg", "pcg")

# Kernel ids of csrc/cg_dia.cu (enum KernelId); a batched kernel's id is
# its single form's plus _BATCHED_ID.
_KERNEL_ID = {("cg", torch.float32): 0, ("cg", torch.float64): 1,
              ("pcg", torch.float32): 2, ("pcg", torch.float64): 3}
_BATCHED_ID = 4


def kernel_ineligibility(A, value_dtype, method: str, M, reduce_dtype, *,
                         batched: bool = False, nrhs: int = 0) -> Optional[str]:
    """None when (A, dtype, method, M) can run on a whole-solve kernel,
    else the reason; ``batched=True`` asks about the multi-RHS kernels for
    an ``nrhs``-system stack.  The JAX rule without its VMEM census (a TPU
    fact); instead the operator's diagonals must fit the kernel's offset
    table, n its 32-bit row index and a stack its per-system scalars.
    Caller-specific conditions (monitor/trace, device) stay with the
    caller."""
    from ..operators import BandedOperator

    if method not in KERNEL_METHODS:
        kind = "batched " if batched else ""
        return f"no {kind}whole-solve CUDA kernel for method {method!r}"
    if reduce_dtype is not None:
        return ("the kernel accumulates in the working dtype only "
                "(reduce_dtype is not supported)")
    if not isinstance(A, BandedOperator):
        return "the operator is not a BandedOperator (DIA)"
    if value_dtype not in (torch.float32, torch.float64):
        return f"the kernel takes float32 or float64, not {value_dtype}"
    if A.dtype != value_dtype:
        return f"the operator is {A.dtype} but the right-hand side is {value_dtype}"
    if method == "pcg" and getattr(M, "inv_diag", None) is None:
        return ("pcg kernel needs a diagonal preconditioner "
                "(JacobiPreconditioner)")
    if A.n_diagonals > MAX_DIAGONALS:
        return (f"the operator has {A.n_diagonals} diagonals; the kernel's "
                f"offset table holds {MAX_DIAGONALS}")
    if A.shape[0] > MAX_N:
        return f"n = {A.shape[0]}; the kernel's 32-bit row index takes at most {MAX_N}"
    if batched and not 1 <= nrhs <= MAX_RHS:
        return (f"{nrhs} right-hand sides; the batched kernel takes 1 to "
                f"{MAX_RHS}")
    return None


def _metric(rmod, xmod, n: int, abs_diff: bool):
    if abs_diff:
        return torch.sqrt(rmod) / n
    return rmod / xmod


def cg_dia_reference(offsets, dia_vals, b, x0, *, n: int, eps: float,
                     max_iter: int, abs_diff: bool = False):
    """Plain version of K1: CG on the gradient g = Ax - b with the loop and
    exit rule of ``_cg_kernel`` (pallas_cg.py:56-119).  Returns
    ``(x, t, res)`` with ``t`` an int32 and ``res`` a 0-d tensor."""
    x = x0.clone()
    g = dia_spmv(offsets, dia_vals, x) - b
    d = -g
    gmod = torch.sum(g * g)
    xmod = torch.clamp(torch.sum(x * x), min=1.0)
    t = 0
    while bool(_metric(gmod, xmod, n, abs_diff) > eps) and t < max_iter:
        ad = dia_spmv(offsets, dia_vals, d)
        ak = gmod / torch.sum(d * ad)
        x = x + ak * d
        g = g + ak * ad
        g1mod = torch.sum(g * g)
        d = (g1mod / gmod) * d - g
        gmod = g1mod
        xmod = torch.clamp(torch.sum(x * x), min=1.0)
        t += 1
    return (x, torch.tensor(t, dtype=torch.int32, device=x.device),
            _metric(gmod, xmod, n, abs_diff))


def pcg_dia_reference(offsets, dia_vals, inv_diag, b, x0, *, n: int,
                      eps: float, max_iter: int, abs_diff: bool = False):
    """Plain version of K2: Jacobi-PCG (Kaasschieter recurrence) with the
    loop and exit rule of ``_pcg_kernel`` (pallas_cg.py:204-262)."""
    x = x0.clone()
    r = b - dia_spmv(offsets, dia_vals, x)
    z = inv_diag * r
    d = z
    zTr = torch.sum(z * r)
    rmod = torch.sum(r * r)
    xmod = torch.clamp(torch.sum(x * x), min=1.0)
    t = 0
    while bool(_metric(rmod, xmod, n, abs_diff) > eps) and t < max_iter:
        ad = dia_spmv(offsets, dia_vals, d)
        ak = zTr / torch.sum(d * ad)
        x = x + ak * d
        r = r - ak * ad
        z = inv_diag * r
        zTr1 = torch.sum(z * r)
        d = z + (zTr1 / zTr) * d
        zTr = zTr1
        rmod = torch.sum(r * r)
        xmod = torch.clamp(torch.sum(x * x), min=1.0)
        t += 1
    return (x, torch.tensor(t, dtype=torch.int32, device=x.device),
            _metric(rmod, xmod, n, abs_diff))


def _alive(rmod, xmod, t, n: int, eps: float, max_iter: int, abs_diff: bool):
    return (_metric(rmod, xmod, n, abs_diff) > eps) & (t < max_iter)


def cg_dia_batched_reference(offsets, dia_vals, B, X0, *, n: int, nrhs: int,
                             eps: float, max_iter: int, abs_diff: bool = False):
    """Plain version of K3: the (nrhs, n) stack in lockstep with the loop,
    per-system freezing and zero guards of ``_cg_kernel_batched``
    (pallas_cg.py:350-416).  Returns ``(X, t, res)`` with (nrhs,) int32
    ``t`` and (nrhs,) ``res``."""
    X = X0.clone()
    G = dia_spmv(offsets, dia_vals, X) - B
    D = -G
    gmod = torch.sum(G * G, dim=1, keepdim=True)
    xmod = torch.clamp(torch.sum(X * X, dim=1, keepdim=True), min=1.0)
    t = torch.zeros((nrhs, 1), dtype=torch.int32, device=X.device)
    alive = _alive(gmod, xmod, t, n, eps, max_iter, abs_diff)
    while bool(alive.any()):
        AD = dia_spmv(offsets, dia_vals, D)
        dTAd = torch.sum(D * AD, dim=1, keepdim=True)
        ak = gmod / torch.where(dTAd == 0, 1.0, dTAd)
        X = torch.where(alive, X + ak * D, X)
        G = torch.where(alive, G + ak * AD, G)
        g1mod = torch.sum(G * G, dim=1, keepdim=True)
        betak = g1mod / torch.where(gmod == 0, 1.0, gmod)
        D = torch.where(alive, betak * D - G, D)
        gmod = torch.where(alive, g1mod, gmod)
        xmod = torch.where(
            alive, torch.clamp(torch.sum(X * X, dim=1, keepdim=True), min=1.0), xmod)
        t = t + alive.to(torch.int32)
        alive = _alive(gmod, xmod, t, n, eps, max_iter, abs_diff)
    return X, t.reshape(nrhs), _metric(gmod, xmod, n, abs_diff).reshape(nrhs)


def pcg_dia_batched_reference(offsets, dia_vals, inv_diag, B, X0, *, n: int,
                              nrhs: int, eps: float, max_iter: int,
                              abs_diff: bool = False):
    """Plain version of K4: batched Jacobi-PCG with the loop, freezing and
    zero guards of ``_pcg_kernel_batched`` (pallas_cg.py:933-1001)."""
    X = X0.clone()
    R = B - dia_spmv(offsets, dia_vals, X)
    Z = inv_diag * R
    D = Z
    zTr = torch.sum(Z * R, dim=1, keepdim=True)
    rmod = torch.sum(R * R, dim=1, keepdim=True)
    xmod = torch.clamp(torch.sum(X * X, dim=1, keepdim=True), min=1.0)
    t = torch.zeros((nrhs, 1), dtype=torch.int32, device=X.device)
    alive = _alive(rmod, xmod, t, n, eps, max_iter, abs_diff)
    while bool(alive.any()):
        AD = dia_spmv(offsets, dia_vals, D)
        dTAd = torch.sum(D * AD, dim=1, keepdim=True)
        ak = zTr / torch.where(dTAd == 0, 1.0, dTAd)
        X = torch.where(alive, X + ak * D, X)
        R = torch.where(alive, R - ak * AD, R)
        Z = inv_diag * R
        zTr1 = torch.sum(Z * R, dim=1, keepdim=True)
        betak = zTr1 / torch.where(zTr == 0, 1.0, zTr)
        D = torch.where(alive, Z + betak * D, D)
        zTr = torch.where(alive, zTr1, zTr)
        rmod = torch.where(alive, torch.sum(R * R, dim=1, keepdim=True), rmod)
        xmod = torch.where(
            alive, torch.clamp(torch.sum(X * X, dim=1, keepdim=True), min=1.0), xmod)
        t = t + alive.to(torch.int32)
        alive = _alive(rmod, xmod, t, n, eps, max_iter, abs_diff)
    return X, t.reshape(nrhs), _metric(rmod, xmod, n, abs_diff).reshape(nrhs)


def _check(offsets, dia_vals, vectors, n: int, stacks=(), nrhs: int = 0):
    """Device, dtype, shape and contiguity checks shared by the wrappers.
    ``vectors`` are (name, tensor) pairs of shape (n,), ``stacks`` (a
    batched wrapper's B, X0) of shape (nrhs, n)."""
    dev, dt = dia_vals.device, dia_vals.dtype
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors on {dev}; the kernel runs on CUDA, its "
                         "plain version on the CPU")
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {dt}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"n = {n}; the kernel indexes with 32-bit ints and "
                         f"takes 1 to {MAX_N}")
    if not 1 <= len(offsets) <= MAX_DIAGONALS:
        raise ValueError(f"{len(offsets)} diagonals; the kernel takes 1 to "
                         f"{MAX_DIAGONALS}")
    if list(offsets) != sorted(set(int(o) for o in offsets)):
        raise ValueError("offsets must be sorted and distinct")
    if stacks and not 1 <= nrhs <= MAX_RHS:
        raise ValueError(f"nrhs = {nrhs}; the batched kernel takes 1 to "
                         f"{MAX_RHS} right-hand sides")
    if tuple(dia_vals.shape) != (len(offsets), n):
        raise ValueError(f"dia_vals has shape {tuple(dia_vals.shape)}, "
                         f"expected {(len(offsets), n)}")
    shapes = {name: (n,) for name, _ in vectors}
    shapes.update({name: (nrhs, n) for name, _ in stacks})
    for name, v in (("dia_vals", dia_vals),) + tuple(vectors) + tuple(stacks):
        if v.device != dev:
            raise ValueError(f"{name} is on {v.device}, dia_vals on {dev}")
        if v.dtype != dt:
            raise ValueError(f"{name} is {v.dtype}, dia_vals {dt}")
        shape = shapes.get(name)
        if shape is not None and tuple(v.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(v.shape)}, expected {shape}")
        if not v.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/cg_dia.cu`` with its C interface declared."""
    from .. import _build

    lib = _build.library("cg_dia")
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.lcg_dia_max_grid.argtypes = [ci, ci, vp]
    lib.lcg_dia_max_grid.restype = ci
    for name in ("block_size", "max_diags", "max_rhs", "max_sums"):
        getattr(lib, f"lcg_dia_{name}").argtypes = []
        getattr(lib, f"lcg_dia_{name}").restype = ci
    lib.lcg_cuda_error_string.argtypes = [ci]
    lib.lcg_cuda_error_string.restype = ctypes.c_char_p
    lib.lcg_dia_solve.argtypes = [ci, ci, vp, ci, vp, vp, vp, vp, vp, vp,
                                  vp, vp, vp, vp, vp, ci, ci, cd, ci, ci, ci,
                                  vp]
    lib.lcg_dia_solve.restype = ci
    for name, expect in (("max_diags", MAX_DIAGONALS), ("max_rhs", MAX_RHS)):
        got = getattr(lib, f"lcg_dia_{name}")()
        if got != expect:
            raise RuntimeError(f"csrc/cg_dia.cu has {name} = {got}, "
                               f"ops/cuda_cg.py expects {expect}")
    return lib


def _raise_on(err: int, what: str):
    if err != 0:
        msg = _lib().lcg_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def _max_grid(kid: int, device_index: int) -> int:
    """Largest co-resident grid of kernel ``kid``: occupancy x SM count."""
    out = ctypes.c_int(0)
    _raise_on(_lib().lcg_dia_max_grid(kid, device_index, ctypes.addressof(out)),
              "occupancy query")
    return out.value


def _launch(method, offsets, dia_vals, inv_diag, b, x0, n, eps, max_iter,
            abs_diff, nrhs: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of K1/K2 on an (n,) ``b``, or of K3/K4 on an (nrhs, n)
    stack when ``nrhs`` > 0."""
    lib = _lib()
    dev = b.device
    kid = _KERNEL_ID[(method, b.dtype)] + (_BATCHED_ID if nrhs else 0)
    x, w1, d, ad = (torch.empty_like(b) for _ in range(4))
    t = torch.empty(b.shape[:-1], dtype=torch.int32, device=dev)
    res = torch.empty(b.shape[:-1], dtype=b.dtype, device=dev)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    invd_ptr = inv_diag.data_ptr() if inv_diag is not None else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows_per_thread = _ROWS_PER_THREAD if nrhs else 1
    # The library sets the device it runs on; this restores the caller's
    # current device afterwards.
    with torch.cuda.device(dev):
        rows = lib.lcg_dia_block_size() * rows_per_thread
        grid = max(1, min(_max_grid(kid, dev.index), -(-max(nrhs, 1) * n // rows)))
        part = torch.empty(2 * lib.lcg_dia_max_sums() * max(nrhs, 1) * grid,
                           dtype=b.dtype, device=dev)
        err = lib.lcg_dia_solve(
            kid, dev.index, ctypes.addressof(offs), len(offsets),
            dia_vals.data_ptr(), invd_ptr, b.data_ptr(), x0.data_ptr(),
            x.data_ptr(), w1.data_ptr(), d.data_ptr(), ad.data_ptr(),
            part.data_ptr(), t.data_ptr(), res.data_ptr(), n, nrhs, float(eps),
            int(max_iter), int(bool(abs_diff)), grid, stream)
    _raise_on(err, f"{method}_dia{'_batched' if nrhs else ''} kernel launch")
    return x, t, res


def cg_dia(offsets, dia_vals, b, x0, *, n: int, eps: float, max_iter: int,
           abs_diff: bool = False):
    """K1: one whole CG solve on DIA storage.  Returns ``(x, t, res)``, all
    on the input's device; ``t`` int32, ``res`` the final metric."""
    offsets = tuple(int(o) for o in offsets)
    _check(offsets, dia_vals, (("b", b), ("x0", x0)), n)
    if b.device.type == "cpu":
        return cg_dia_reference(offsets, dia_vals, b, x0, n=n, eps=eps,
                                max_iter=max_iter, abs_diff=abs_diff)
    out = _launch("cg", offsets, dia_vals, None, b, x0, n, eps, max_iter, abs_diff)
    cg_dia.launches += 1
    return out


def pcg_dia(offsets, dia_vals, inv_diag, b, x0, *, n: int, eps: float,
            max_iter: int, abs_diff: bool = False):
    """K2: one whole Jacobi-PCG solve on DIA storage with ``inv_diag``."""
    offsets = tuple(int(o) for o in offsets)
    _check(offsets, dia_vals, (("inv_diag", inv_diag), ("b", b), ("x0", x0)), n)
    if b.device.type == "cpu":
        return pcg_dia_reference(offsets, dia_vals, inv_diag, b, x0, n=n,
                                 eps=eps, max_iter=max_iter, abs_diff=abs_diff)
    out = _launch("pcg", offsets, dia_vals, inv_diag, b, x0, n, eps, max_iter,
                  abs_diff)
    pcg_dia.launches += 1
    return out


def cg_dia_batched(offsets, dia_vals, B, X0, *, n: int, nrhs: int, eps: float,
                   max_iter: int, abs_diff: bool = False):
    """K3: one whole CG solve of an (nrhs, n) stack on DIA storage.  Returns
    ``(X, t, res)`` on the input's device: X (nrhs, n), ``t`` (nrhs,) int32,
    ``res`` (nrhs,) the final metrics."""
    offsets = tuple(int(o) for o in offsets)
    _check(offsets, dia_vals, (), n, (("B", B), ("X0", X0)), nrhs)
    if B.device.type == "cpu":
        return cg_dia_batched_reference(offsets, dia_vals, B, X0, n=n,
                                        nrhs=nrhs, eps=eps, max_iter=max_iter,
                                        abs_diff=abs_diff)
    out = _launch("cg", offsets, dia_vals, None, B, X0, n, eps, max_iter,
                  abs_diff, nrhs)
    cg_dia_batched.launches += 1
    return out


def pcg_dia_batched(offsets, dia_vals, inv_diag, B, X0, *, n: int, nrhs: int,
                    eps: float, max_iter: int, abs_diff: bool = False):
    """K4: one whole Jacobi-PCG solve of an (nrhs, n) stack with
    ``inv_diag``."""
    offsets = tuple(int(o) for o in offsets)
    _check(offsets, dia_vals, (("inv_diag", inv_diag),), n,
           (("B", B), ("X0", X0)), nrhs)
    if B.device.type == "cpu":
        return pcg_dia_batched_reference(offsets, dia_vals, inv_diag, B, X0,
                                         n=n, nrhs=nrhs, eps=eps,
                                         max_iter=max_iter, abs_diff=abs_diff)
    out = _launch("pcg", offsets, dia_vals, inv_diag, B, X0, n, eps, max_iter,
                  abs_diff, nrhs)
    pcg_dia_batched.launches += 1
    return out


cg_dia.launches = 0
pcg_dia.launches = 0
cg_dia_batched.launches = 0
pcg_dia_batched.launches = 0
