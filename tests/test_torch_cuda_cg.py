"""K1/K2 (ops/cuda_cg.py): the plain versions against the JAX Pallas kernels
in interpret mode and the JAX f64 engine, the wrappers' checks and routing,
and the lazy build.  The kernels themselves are held against their plain
versions on a CUDA card by tests/test_torch_cuda_kernels.py."""

import stat

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import liblcg_tpu as J
import liblcg_tpu_torch as L
from liblcg_tpu.ops.pallas_cg import pallas_cg_dia, pallas_pcg_dia
from liblcg_tpu.solvers import real as JR
from liblcg_tpu_torch import _build, _systems
from liblcg_tpu_torch.ops import cuda_cg

torch.set_num_threads(1)

N = 4096


def _banded(n=N, seed=5):
    rows, cols, vals, b = _systems.banded_spd(n, seed=seed)
    return J.BandedOperator(n, n, rows, cols, vals), b


_JA, _B = _banded()


def _args(method, dtype, device="cpu", x0_seed=None):
    """Port arguments (offsets, vals, [inv_diag], b, x0) at ``dtype``."""
    np_dt = np.dtype(str(dtype).split(".")[-1])
    vals = torch.tensor(np.asarray(_JA.diag_vals).astype(np_dt), device=device)
    b = torch.tensor(_B.astype(np_dt), device=device)
    x0 = (torch.zeros_like(b) if x0_seed is None else torch.tensor(
        np.random.default_rng(x0_seed).uniform(-1, 1, N).astype(np_dt), device=device))
    if method == "pcg":
        invd = torch.tensor((1.0 / np.asarray(_JA.diagonal())).astype(np_dt),
                            device=device)
        return (_JA.offsets, vals, invd, b, x0)
    return (_JA.offsets, vals, b, x0)


_WRAPPER = {"cg": cuda_cg.cg_dia, "pcg": cuda_cg.pcg_dia}
_PLAIN = {"cg": cuda_cg.cg_dia_reference, "pcg": cuda_cg.pcg_dia_reference}
_PALLAS = {"cg": pallas_cg_dia, "pcg": pallas_pcg_dia}


@pytest.mark.parametrize("x0_seed", [None, 9])
@pytest.mark.parametrize("abs_diff", [False, True])
@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_plain_f32_matches_pallas_interpret(method, abs_diff, x0_seed):
    eps = 1e-7 if abs_diff else 1e-10
    args = _args(method, torch.float32, x0_seed=x0_seed)
    kw = dict(n=N, eps=eps, max_iter=10000, abs_diff=abs_diff)
    x, t, res = _PLAIN[method](*args, **kw)
    jargs = [a if isinstance(a, tuple) else jnp.asarray(a.numpy()) for a in args]
    jx, jt, jres = _PALLAS[method](*jargs, interpret=True, **kw)
    assert abs(int(t) - int(jt)) <= 2          # as tests/test_pallas_kernel.py
    jx = np.asarray(jx, np.float64)
    assert np.linalg.norm(x.numpy() - jx) <= 1e-4 * np.linalg.norm(jx)
    assert float(res) <= eps and float(jres) <= eps
    assert x.dtype == torch.float32 and t.dtype == torch.int32


@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_plain_f32_max_iter_exit_matches_pallas_interpret(method):
    args = _args(method, torch.float32)
    kw = dict(n=N, eps=1e-12, max_iter=9, abs_diff=False)
    x, t, res = _PLAIN[method](*args, **kw)
    jargs = [a if isinstance(a, tuple) else jnp.asarray(a.numpy()) for a in args]
    jx, jt, jres = _PALLAS[method](*jargs, interpret=True, **kw)
    assert int(t) == int(jt) == 9
    assert float(res) == pytest.approx(float(jres), rel=1e-3)


@pytest.mark.parametrize("eps", [1e-20, 1e-12])
@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_plain_f64_matches_jax_engine(method, eps):
    args = _args(method, torch.float64)
    x, t, res = _PLAIN[method](*args, n=N, eps=eps, max_iter=10000)
    params = J.SolverParams(epsilon=eps)
    if method == "pcg":
        jc = JR.pcg(_JA, jnp.asarray(_B), M=J.JacobiPreconditioner(_JA), params=params)
    else:
        jc = JR.cg(_JA, jnp.asarray(_B), params=params)
    assert int(jc["status"]) == int(L.Status.CONVERGENCE)
    assert int(t) == int(jc["t"])
    jx = np.asarray(jc["x"])
    assert np.linalg.norm(x.numpy() - jx) <= 1e-8 * np.linalg.norm(jx)
    assert float(res) <= eps


@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_wrapper_on_cpu_runs_the_plain_version_without_counting(method):
    args = _args(method, torch.float64)
    kw = dict(n=N, eps=1e-16, max_iter=10000)
    before = _WRAPPER[method].launches
    x, t, res = _WRAPPER[method](*args, **kw)
    xp, tp, rp = _PLAIN[method](*args, **kw)
    assert _WRAPPER[method].launches == before
    assert int(t) == int(tp)
    assert torch.equal(x, xp) and torch.equal(res, rp)


def _bad_inputs(method):
    good = list(_args(method, torch.float64))
    b_at = 3 if method == "pcg" else 2
    cases = {}
    v = good.copy()
    v[1] = v[1].to(torch.float16)
    cases["float16 values"] = v
    v = good.copy()
    v[b_at] = v[b_at].to(torch.float32)
    cases["b of another dtype"] = v
    v = good.copy()
    v[b_at] = v[b_at][:-1]
    cases["short b"] = v
    v = good.copy()
    v[b_at] = torch.stack([v[b_at], v[b_at]], 1)[:, 0]
    cases["strided b"] = v
    v = good.copy()
    v[1] = v[1][:, :-1]
    cases["values of the wrong width"] = v
    v = good.copy()
    v[0] = tuple(reversed(v[0]))
    cases["unsorted offsets"] = v
    v = good.copy()
    v[b_at] = torch.empty(N, dtype=torch.float64, device="meta")
    cases["b on another device"] = v
    return cases


@pytest.mark.parametrize("case", sorted(_bad_inputs("cg")))
@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_wrapper_refuses_bad_input(method, case):
    args = _bad_inputs(method)[case]
    with pytest.raises(ValueError):
        _WRAPPER[method](*args, n=N, eps=1e-10, max_iter=10)


def test_wrapper_refuses_more_diagonals_than_the_offset_table():
    nd = cuda_cg.MAX_DIAGONALS + 1
    vals = torch.zeros((nd, 8 * nd), dtype=torch.float64)
    b = torch.ones(8 * nd, dtype=torch.float64)
    with pytest.raises(ValueError, match=str(cuda_cg.MAX_DIAGONALS)):
        cuda_cg.cg_dia(tuple(range(nd)), vals, b, b.clone(), n=8 * nd,
                       eps=1e-10, max_iter=1)


@pytest.mark.parametrize("n", [0, cuda_cg.MAX_N + 1])
def test_wrapper_refuses_n_outside_32_bit_indexing(n):
    vals = torch.zeros((1, 8), dtype=torch.float64)
    b = torch.ones(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="32-bit"):
        cuda_cg.cg_dia((0,), vals, b, b.clone(), n=n, eps=1e-10, max_iter=1)


def _ineligible_cases():
    n = 64
    rows, cols, vals, _ = _systems.banded_spd(n)
    A = L.BandedOperator(n, n, rows, cols, vals)
    M = L.JacobiPreconditioner(A)
    i = np.arange(n * 4)
    wide = L.BandedOperator(n * 4, n * 4, np.repeat(i[:1], 300),
                            np.arange(300), np.ones(300))
    return {
        "method": (A, torch.float64, "cgs", None, None, "method"),
        "reduce_dtype": (A, torch.float64, "cg", None, "float64", "reduce_dtype"),
        "dense": (L.DenseOperator(np.eye(n)), torch.float64, "cg", None, None,
                  "BandedOperator"),
        "float16": (A.astype(torch.float16), torch.float16, "cg", None, None,
                    "float32 or float64"),
        "mixed dtypes": (A, torch.float32, "cg", None, None, "right-hand side"),
        "pcg without inv_diag": (A, torch.float64, "pcg", lambda r: r, None,
                                 "diagonal preconditioner"),
        "too many diagonals": (wide, torch.float64, "cg", None, None, "offset table"),
        "eligible cg": (A, torch.float64, "cg", None, None, None),
        "eligible pcg f32": (A.astype(torch.float32), torch.float32, "pcg",
                             M.astype(torch.float32), None, None),
    }


_INELIGIBLE = _ineligible_cases()


@pytest.mark.parametrize("case", sorted(_INELIGIBLE))
def test_kernel_ineligibility_reasons(case):
    A, dt, method, M, reduce_dtype, reason = _INELIGIBLE[case]
    got = cuda_cg.kernel_ineligibility(A, dt, method, M, reduce_dtype)
    if reason is None:
        assert got is None
    else:
        assert reason in got


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_failed_build_raises_with_nvcc_stderr(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'cg_dia.cu(1): error: no such thing' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such thing"):
        _build.build_all()
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())


def test_build_key_follows_the_sources(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build._target("k")
    assert _build._target("k") == first
    (src / "k.cu").write_text("// two\n")
    assert _build._target("k") != first
    (src / "k.cu").write_text("// one\n")
    (src / "shared.cuh").write_text("// header\n")
    assert _build._target("k") != first
    assert _build.sources() == ["k"]
    assert first.parent == _build.BUILD_DIR
