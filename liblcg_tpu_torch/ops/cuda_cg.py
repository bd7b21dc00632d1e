"""Whole-solve CG and Jacobi-PCG kernels on DIA storage (CUDA, Hopper).

Counterpart of the TPU kernels ``pallas_cg_dia`` (K1) and ``pallas_pcg_dia``
(K2) of ``liblcg_tpu/ops/pallas_cg.py``.  The kernels live in
``csrc/cg_dia.cu``: one cooperative launch runs the entire solve, so no
scalar crosses to the host inside the loop.

Beside each wrapper sits its plain PyTorch version (``*_reference``), with
the same signature, loop and exit rule.  A wrapper given CPU tensors runs
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

KERNEL_METHODS = ("cg", "pcg")

# Kernel ids of csrc/cg_dia.cu (enum KernelId).
_KERNEL_ID = {("cg", torch.float32): 0, ("cg", torch.float64): 1,
              ("pcg", torch.float32): 2, ("pcg", torch.float64): 3}


def kernel_ineligibility(A, value_dtype, method: str, M, reduce_dtype) -> Optional[str]:
    """None when (A, dtype, method, M) can run on a whole-solve kernel,
    else the reason.  The JAX rule without its VMEM census (a TPU fact);
    instead the operator's diagonals must fit the kernel's offset table.
    Caller-specific conditions (monitor/trace, device) stay with the
    caller."""
    from ..operators import BandedOperator

    if method not in KERNEL_METHODS:
        return f"no whole-solve CUDA kernel for method {method!r}"
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


def _check(offsets, dia_vals, vectors, n: int):
    """Device, dtype, shape and contiguity checks shared by both wrappers."""
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
    if tuple(dia_vals.shape) != (len(offsets), n):
        raise ValueError(f"dia_vals has shape {tuple(dia_vals.shape)}, "
                         f"expected {(len(offsets), n)}")
    for name, v in (("dia_vals", dia_vals),) + vectors:
        if v.device != dev:
            raise ValueError(f"{name} is on {v.device}, dia_vals on {dev}")
        if v.dtype != dt:
            raise ValueError(f"{name} is {v.dtype}, dia_vals {dt}")
        if name != "dia_vals" and tuple(v.shape) != (n,):
            raise ValueError(f"{name} has shape {tuple(v.shape)}, expected ({n},)")
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
    lib.lcg_dia_max_sums.argtypes = []
    lib.lcg_dia_max_sums.restype = ci
    lib.lcg_dia_block_size.argtypes = []
    lib.lcg_dia_block_size.restype = ci
    lib.lcg_cuda_error_string.argtypes = [ci]
    lib.lcg_cuda_error_string.restype = ctypes.c_char_p
    lib.lcg_dia_solve.argtypes = [ci, ci, vp, ci, vp, vp, vp, vp, vp, vp,
                                  vp, vp, vp, vp, vp, ci, cd, ci, ci, ci, vp]
    lib.lcg_dia_solve.restype = ci
    lib.lcg_dia_max_diags.argtypes = []
    lib.lcg_dia_max_diags.restype = ci
    if lib.lcg_dia_max_diags() != MAX_DIAGONALS:
        raise RuntimeError(f"csrc/cg_dia.cu holds {lib.lcg_dia_max_diags()} "
                           f"diagonals, ops/cuda_cg.py expects {MAX_DIAGONALS}")
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
            abs_diff) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    lib = _lib()
    dev = b.device
    kid = _KERNEL_ID[(method, b.dtype)]
    x = torch.empty_like(b)
    w1, d, ad = (torch.empty_like(b) for _ in range(3))
    t = torch.empty((), dtype=torch.int32, device=dev)
    res = torch.empty((), dtype=b.dtype, device=dev)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    invd_ptr = inv_diag.data_ptr() if inv_diag is not None else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    # The library sets the device it runs on; this restores the caller's
    # current device afterwards.
    with torch.cuda.device(dev):
        grid = max(1, min(_max_grid(kid, dev.index),
                          -(-n // lib.lcg_dia_block_size())))
        part = torch.empty(2 * lib.lcg_dia_max_sums() * grid, dtype=b.dtype,
                           device=dev)
        err = lib.lcg_dia_solve(
            kid, dev.index, ctypes.addressof(offs), len(offsets),
            dia_vals.data_ptr(), invd_ptr, b.data_ptr(), x0.data_ptr(),
            x.data_ptr(), w1.data_ptr(), d.data_ptr(), ad.data_ptr(),
            part.data_ptr(), t.data_ptr(), res.data_ptr(), n, float(eps),
            int(max_iter), int(bool(abs_diff)), grid, stream)
    _raise_on(err, f"{method}_dia kernel launch")
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


cg_dia.launches = 0
pcg_dia.launches = 0
