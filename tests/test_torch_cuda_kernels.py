"""K1-K4 on a CUDA card: each kernel against its plain version, its exits,
its input checks, and the routing of solve() and solve_batched() through
it.

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
from liblcg_tpu_torch.solve import kernel_status

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


NRHS = 5
_BATCHED = {"cg": cuda_cg.cg_dia_batched, "pcg": cuda_cg.pcg_dia_batched}
_BATCHED_PLAIN = {"cg": cuda_cg.cg_dia_batched_reference,
                  "pcg": cuda_cg.pcg_dia_batched_reference}


def _stack(device, dtype, nrhs=NRHS):
    """Ones, a zero row and uniform rows (_systems.rhs_stack)."""
    return torch.tensor(_systems.rhs_stack(N, nrhs, seed=4), dtype=dtype,
                        device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("abs_diff", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_batched_kernel_matches_plain_version(cuda_device, method, dtype, abs_diff):
    A, M, _ = _system(cuda_device, dtype)
    B = _stack(cuda_device, dtype)
    args = _args(method, A, M, B, torch.zeros_like(B))
    eps = _EPS[dtype][abs_diff]
    kw = dict(n=N, nrhs=NRHS, eps=eps, max_iter=10000, abs_diff=abs_diff)
    before = _BATCHED[method].launches
    X, t, res = _BATCHED[method](*args, **kw)
    torch.cuda.synchronize()
    assert _BATCHED[method].launches == before + 1
    assert X.shape == B.shape and t.shape == res.shape == (NRHS,)
    Xp, tp, rp = _BATCHED_PLAIN[method](*args, **kw)
    dt_tol, x_tol = (2, 1e-4) if dtype == torch.float32 else (1, 1e-9)
    assert torch.equal(kernel_status(t, res, eps), kernel_status(tp, rp, eps))
    assert int((t - tp).abs().max()) <= dt_tol
    assert len(set(t.tolist())) > 2           # the systems stop apart
    for r in range(NRHS):
        if r == 1:                            # the zero row: t = 0, x = x0
            assert int(t[r]) == 0 and not bool(X[r].any())
            continue
        assert float((X[r] - Xp[r]).norm() / Xp[r].norm()) <= x_tol
        assert float(res[r]) <= eps
    X2, t2, res2 = _BATCHED[method](*args, **kw)
    assert torch.equal(X, X2) and torch.equal(t, t2) and torch.equal(res, res2)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_batched_kernel_leaves_finished_systems_untouched(cuda_device, method):
    """A system frozen at t = 0 keeps its x0 bit for bit, and a run cut at
    max_iter leaves the systems that finished before the cut exactly as
    the uncut run leaves them."""
    A, M, b = _system(cuda_device, torch.float64)
    B = _stack(cuda_device, torch.float64)
    eps = 1e-20
    kw = dict(n=N, nrhs=NRHS, eps=eps, max_iter=10000)
    X, t, _ = _BATCHED[method](*_args(method, A, M, B, torch.zeros_like(B)), **kw)
    X0 = torch.zeros_like(B)
    X0[2] = X[2]                              # already converged from the start
    Xs, ts, _ = _BATCHED[method](*_args(method, A, M, B, X0),
                                 **dict(kw, eps=1e-16))
    assert int(ts[2]) == 0 and torch.equal(Xs[2], X[2])
    cut = int(t.max()) - 1
    Xc, tc, _ = _BATCHED[method](*_args(method, A, M, B, torch.zeros_like(B)),
                                 **dict(kw, max_iter=cut))
    done = t < cut
    assert bool(done.any()) and not bool(done.all())
    assert torch.equal(tc[done], t[done]) and torch.equal(Xc[done], X[done])
    assert bool((tc[~done] == cut).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,nrhs", [(300, 1), (64, 40), (1000, cuda_cg.MAX_RHS)])
@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_batched_kernel_at_the_edges_of_its_grid(cuda_device, method, n, nrhs):
    """One system; more systems than warps in the grid (a warp then takes
    several systems in turn); the most systems the kernel holds."""
    rows, cols, vals, _ = _systems.banded_spd(n, seed=6)
    A = L.BandedOperator(n, n, rows, cols, vals, device=cuda_device)
    M = L.JacobiPreconditioner(A)
    B = torch.tensor(_systems.rhs_stack(n, nrhs, seed=7), device=cuda_device)
    args = _args(method, A, M, B, torch.zeros_like(B))
    kw = dict(n=n, nrhs=nrhs, eps=1e-20, max_iter=10000)
    X, t, res = _BATCHED[method](*args, **kw)
    Xp, tp, rp = _BATCHED_PLAIN[method](*args, **kw)
    assert torch.equal(kernel_status(t, res, 1e-20), kernel_status(tp, rp, 1e-20))
    assert int((t - tp).abs().max()) <= 1
    scale = Xp.norm(dim=1).clamp(min=1e-300)
    assert float(((X - Xp).norm(dim=1) / scale).max()) <= 1e-9


@pytest.mark.cuda
def test_batched_kernel_refuses_bad_input(cuda_device):
    A, M, _ = _system(cuda_device, torch.float64)
    B = _stack(cuda_device, torch.float64)
    kw = dict(n=N, eps=1e-10, max_iter=5)
    with pytest.raises(ValueError, match="dia_vals on cuda"):
        cuda_cg.cg_dia_batched(A.offsets, A.diag_vals, B.cpu(), B.cpu(),
                               nrhs=NRHS, **kw)
    with pytest.raises(ValueError, match="expected"):
        cuda_cg.cg_dia_batched(A.offsets, A.diag_vals, B[:, :-1], B[:, :-1],
                               nrhs=NRHS, **kw)
    big = torch.zeros((cuda_cg.MAX_RHS + 1, N), dtype=torch.float64,
                      device=cuda_device)
    with pytest.raises(ValueError, match=str(cuda_cg.MAX_RHS)):
        cuda_cg.pcg_dia_batched(A.offsets, A.diag_vals, M.inv_diag, big, big,
                                nrhs=cuda_cg.MAX_RHS + 1, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_solve_batched_routes_through_the_kernel(cuda_device, method):
    A, M, _ = _system(cuda_device, torch.float64)
    B = _stack(cuda_device, torch.float64)
    Mm = M if method == "pcg" else None
    params = L.SolverParams(epsilon=1e-20)
    wrapper = _BATCHED[method]
    before = wrapper.launches
    auto = L.solve_batched(A, B, method=method, M=Mm, params=params)
    assert wrapper.launches == before + 1
    never = L.solve_batched(A, B, method=method, M=Mm, params=params,
                            pallas="never")
    assert wrapper.launches == before + 1
    assert torch.equal(auto.status_code, never.status_code)
    assert int((auto.iterations - never.iterations).abs().max()) <= 1
    assert int(auto.status_code[1]) == int(L.Status.ALREADY_OPTIMIZED)
    for r in (0, 2, 3, 4):
        assert float((auto.x[r] - never.x[r]).norm() / never.x[r].norm()) <= 1e-9
    assert auto.x.device.type == "cuda" and auto.status_code.device.type == "cuda"
    with pytest.raises(ValueError, match="trace recording"):
        L.solve_batched(A, B, method=method, M=Mm, params=params,
                        pallas="always", trace_len=4)
    with pytest.raises(ValueError, match="monitor"):
        L.solve_batched(A, B, method=method, M=Mm, params=params,
                        pallas="always", monitor=lambda X, r, t: t >= 3)
    big = B.new_zeros((cuda_cg.MAX_RHS + 1, N))
    with pytest.raises(ValueError, match="right-hand sides"):
        L.solve_batched(A, big, method=method, M=Mm, params=params,
                        pallas="always")
    with pytest.raises(ValueError, match="is on cpu"):
        L.solve_batched(A, B.cpu(), method=method, M=Mm, params=params)
