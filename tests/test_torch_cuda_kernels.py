"""K1/K2 on a CUDA card: each kernel against its plain version, its exits,
its input checks, and solve()'s routing through it.

Every test here needs a card and skips without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

import liblcg_tpu_torch as L
from liblcg_tpu_torch import _systems
from liblcg_tpu_torch.ops import cuda_cg

torch.set_num_threads(1)

N = 4096
_WRAPPER = {"cg": cuda_cg.cg_dia, "pcg": cuda_cg.pcg_dia}
_PLAIN = {"cg": cuda_cg.cg_dia_reference, "pcg": cuda_cg.pcg_dia_reference}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _system(device, dtype):
    rows, cols, vals, b = _systems.banded_spd(N, seed=5)
    A = L.BandedOperator(N, N, rows, cols, vals, dtype=dtype, device=device)
    return A, L.JacobiPreconditioner(A), torch.tensor(b, dtype=dtype, device=device)


def _args(method, A, M, b, x0):
    if method == "pcg":
        return (A.offsets, A.diag_vals, M.inv_diag, b, x0)
    return (A.offsets, A.diag_vals, b, x0)


#: Stopping thresholds: (relative metric, abs_diff metric) per dtype.
_EPS = {torch.float32: (1e-10, 1e-6), torch.float64: (1e-20, 1e-13)}


@pytest.mark.cuda
@pytest.mark.parametrize("abs_diff", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_kernel_matches_plain_version(cuda_device, method, dtype, abs_diff):
    A, M, b = _system(cuda_device, dtype)
    x0 = torch.tensor(np.random.default_rng(3).uniform(-1, 1, N), dtype=dtype,
                      device=cuda_device)
    args = _args(method, A, M, b, x0)
    eps = _EPS[dtype][abs_diff]
    kw = dict(n=N, eps=eps, max_iter=10000, abs_diff=abs_diff)
    before = _WRAPPER[method].launches
    x, t, res = _WRAPPER[method](*args, **kw)
    torch.cuda.synchronize()
    assert _WRAPPER[method].launches == before + 1
    xp, tp, rp = _PLAIN[method](*args, **kw)
    # Reduction order and FMA contraction differ (chip_smoke.py states why).
    dt_tol, x_tol = (2, 1e-4) if dtype == torch.float32 else (1, 1e-9)
    assert abs(int(t) - int(tp)) <= dt_tol
    assert float((x - xp).norm() / xp.norm()) <= x_tol
    assert float(res) <= eps
    x2, t2, _ = _WRAPPER[method](*args, **kw)
    assert torch.equal(x, x2) and int(t) == int(t2)   # fixed-order reductions


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_kernel_exits_on_max_iter_and_on_nan(cuda_device, method):
    A, M, b = _system(cuda_device, torch.float64)
    args = _args(method, A, M, b, torch.zeros_like(b))
    x, t, res = _WRAPPER[method](*args, n=N, eps=1e-30, max_iter=7)
    xp, tp, rp = _PLAIN[method](*args, n=N, eps=1e-30, max_iter=7)
    assert int(t) == int(tp) == 7
    assert float(res) == pytest.approx(float(rp), rel=1e-9)
    b_nan = b.clone()
    b_nan[11] = float("nan")
    args = _args(method, A, M, b_nan, torch.zeros_like(b))
    x, t, res = _WRAPPER[method](*args, n=N, eps=1e-10, max_iter=50)
    assert int(t) == 0 and bool(torch.isnan(res))


@pytest.mark.cuda
def test_kernel_refuses_cpu_mixed_with_cuda(cuda_device):
    A, M, b = _system(cuda_device, torch.float64)
    with pytest.raises(ValueError, match="dia_vals on cuda"):
        cuda_cg.cg_dia(A.offsets, A.diag_vals, b.cpu(), b.cpu(), n=N, eps=1e-10,
                       max_iter=5)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_solve_routes_through_the_kernel(cuda_device, method):
    A, M, b = _system(cuda_device, torch.float64)
    Mm = M if method == "pcg" else None
    params = L.SolverParams(epsilon=1e-20)
    wrapper = _WRAPPER[method]
    before = wrapper.launches
    auto = L.solve(A, b, method=method, M=Mm, params=params)
    assert wrapper.launches == before + 1
    never = L.solve(A, b, method=method, M=Mm, params=params, pallas="never")
    assert wrapper.launches == before + 1
    assert auto.status == never.status == L.Status.CONVERGENCE
    assert abs(int(auto.iterations) - int(never.iterations)) <= 1
    assert float((auto.x - never.x).norm() / never.x.norm()) <= 1e-9
    assert auto.x.device.type == "cuda" and auto.status_code.device.type == "cuda"
    with pytest.raises(ValueError, match="pallas='always' but"):
        L.solve(A, b, method=method, M=Mm, params=params, pallas="always",
                trace_len=4)
    with pytest.raises(ValueError, match="is on cpu"):
        L.solve(A, b.cpu(), method=method, M=Mm, params=params)
