"""The port's solve() against liblcg_tpu.solve() on the synthetic
19-diagonal system (n = 10,000), its routing and its error handling."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import liblcg_tpu as J
import liblcg_tpu_torch as L
from liblcg_tpu_torch import _systems
from liblcg_tpu_torch.ops import cuda_cg

torch.set_num_threads(1)

N = 10_000
_ROWS, _COLS, _VALS, _B = _systems.banded_spd(N)
_JA = J.make_sparse_operator(N, N, _ROWS, _COLS, _VALS)
_LA = L.make_sparse_operator(N, N, _ROWS, _COLS, _VALS)


def _pair(dtype):
    """(port operator, JAX operator, b as numpy) at ``dtype``."""
    if dtype == "float64":
        return _LA, _JA, _B
    return _LA.astype(torch.float32), _JA.astype(jnp.float32), _B.astype(np.float32)


def _precond(method, LA, JA):
    if method != "pcg":
        return None, None
    return L.JacobiPreconditioner(LA), J.JacobiPreconditioner(JA)


def _x_rel(lr, jr):
    jx = np.asarray(jr.x, np.float64)
    return np.linalg.norm(lr.x.numpy().astype(np.float64) - jx) / np.linalg.norm(jx)


@pytest.mark.parametrize("pallas", ["never", "always", "auto"])
@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_f64_solve_matches_jax_engine(method, pallas):
    """f64: JAX solves on its engine (its kernel is f32-only); the port's
    engine and its kernel's plain version give the same iteration count."""
    LA, JA, b = _pair("float64")
    LM, JM = _precond(method, LA, JA)
    params = dict(epsilon=1e-20)
    jr = J.solve(JA, b, method=method, M=JM, params=J.SolverParams(**params),
                 pallas="never")
    lr = L.solve(LA, b, method=method, M=LM, params=L.SolverParams(**params),
                 pallas=pallas)
    assert lr.status == jr.status == L.Status.CONVERGENCE
    assert int(lr.iterations) == int(jr.iterations)
    assert _x_rel(lr, jr) <= 1e-8


@pytest.mark.parametrize("pallas", ["never", "always"])
@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_f32_solve_matches_jax(method, pallas):
    """f32: both packages on their kernel route ("always": the port's plain
    version, JAX's Pallas interpreter) or both on their engines."""
    LA, JA, b = _pair("float32")
    LM, JM = _precond(method, LA, JA)
    params = dict(epsilon=1e-10)
    jr = J.solve(JA, jnp.asarray(b), method=method, M=JM,
                 params=J.SolverParams(**params), pallas=pallas)
    lr = L.solve(LA, torch.from_numpy(b), method=method, M=LM,
                 params=L.SolverParams(**params), pallas=pallas)
    assert lr.status == jr.status == L.Status.CONVERGENCE
    assert abs(int(lr.iterations) - int(jr.iterations)) <= 2
    assert _x_rel(lr, jr) <= 1e-4
    assert lr.x.dtype == torch.float32


_STATUS_CASES = {
    "CONVERGENCE": (dict(epsilon=1e-8), None),
    "ALREADY_OPTIMIZED": (dict(epsilon=1e-6), "exact_x0"),
    "REACHED_MAX_ITERATIONS": (dict(epsilon=1e-12, max_iterations=3), None),
    "NAN_VALUE": (dict(epsilon=1e-8), "nan_b"),
}


@pytest.mark.parametrize("case", sorted(_STATUS_CASES))
@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_kernel_route_status_mapping_matches_jax(method, case):
    LA, JA, b = _pair("float32")
    LM, JM = _precond(method, LA, JA)
    pkw, how = _STATUS_CASES[case]
    b = b.copy()
    x0 = None
    if how == "exact_x0":
        x0 = J.solve(JA, jnp.asarray(b), method=method, M=JM,
                     params=J.SolverParams(epsilon=1e-12), pallas="never").x
        x0 = np.asarray(x0)
    elif how == "nan_b":
        b[5] = np.nan
    jr = J.solve(JA, jnp.asarray(b), x0, method=method, M=JM,
                 params=J.SolverParams(**pkw), pallas="always")
    lr = L.solve(LA, torch.from_numpy(b), x0, method=method, M=LM,
                 params=L.SolverParams(**pkw), pallas="always")
    assert lr.status.name == jr.status.name == case
    assert int(lr.iterations) == int(jr.iterations)
    assert lr.status_code.dtype == torch.int32


_INELIGIBLE = {
    # case -> (the methods it applies to, the word both reasons contain)
    "monitor": (("cg", "pcg"), "monitor"),
    "trace": (("cg", "pcg"), "trace"),
    "dense": (("cg", "pcg"), "BandedOperator"),
    "reduce_dtype": (("cg", "pcg"), "reduce_dtype"),
    "callable M": (("pcg",), "diagonal preconditioner"),
}


@pytest.mark.parametrize("method,case", [(m, c) for c, (ms, _) in sorted(_INELIGIBLE.items())
                                         for m in ms])
def test_always_on_an_ineligible_solve_raises_like_jax(method, case):
    LA, JA, b = _pair("float32")
    lkw, jkw = {}, {}
    if case == "monitor":
        lkw["monitor"] = jkw["monitor"] = lambda x, r, t: t >= 3
    elif case == "trace":
        lkw["trace_len"] = jkw["trace_len"] = 8
    elif case == "dense":
        dense = np.eye(6, dtype=np.float32) * 4.0
        LA, JA, b = L.DenseOperator(dense), J.DenseOperator(dense), b[:6]
    elif case == "reduce_dtype":
        lkw["params"] = L.SolverParams(reduce_dtype="float64")
        jkw["params"] = J.SolverParams(reduce_dtype="float64")
    if method == "pcg":
        if case == "callable M":
            lkw["M"] = jkw["M"] = lambda r: r
        else:
            lkw["M"], jkw["M"] = L.JacobiPreconditioner(LA), J.JacobiPreconditioner(JA)
    with pytest.raises(ValueError, match="pallas='always' but") as jerr:
        J.solve(JA, jnp.asarray(b), method=method, pallas="always", **jkw)
    with pytest.raises(ValueError, match="pallas='always' but") as lerr:
        L.solve(LA, torch.from_numpy(b), method=method, pallas="always", **lkw)
    word = _INELIGIBLE[case][1]
    assert word in str(jerr.value) and word in str(lerr.value)


@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_auto_on_cpu_runs_the_engine(method):
    LA, JA, b = _pair("float64")
    LM, _ = _precond(method, LA, JA)
    before = (cuda_cg.cg_dia.launches, cuda_cg.pcg_dia.launches)
    params = L.SolverParams(epsilon=1e-14)
    auto = L.solve(LA, b, method=method, M=LM, params=params)
    never = L.solve(LA, b, method=method, M=LM, params=params, pallas="never")
    assert (cuda_cg.cg_dia.launches, cuda_cg.pcg_dia.launches) == before
    assert torch.equal(auto.x, never.x)
    assert int(auto.iterations) == int(never.iterations)


def test_the_slice_end_to_end_on_the_laplacian():
    """make_sparse_operator / banded_from_arrays / matrix-free operator all
    give JAX's answer on a small 7-point Laplacian."""
    nz, ny, nx = 6, 7, 8
    n = nz * ny * nx
    offsets, diag_vals = _systems.laplacian3d_dia(nz, ny, nx)
    D = L.banded_from_arrays((n, n), offsets, diag_vals, device="cpu")
    MF = L.Laplacian3DOperator(nz, ny, nx, dtype=torch.float64)
    JMF = J.Laplacian3DOperator(nz, ny, nx, dtype=jnp.float64)
    b = np.ones(n)
    params = dict(epsilon=1e-16, max_iterations=2000)
    for method in ("cg", "pcg"):
        jr = J.solve(JMF, b, method=method, params=J.SolverParams(**params),
                     M=J.JacobiPreconditioner(JMF) if method == "pcg" else None)
        for A, pallas in ((D, "always"), (D, "never"), (MF, "auto")):
            lr = L.solve(A, b, method=method, params=L.SolverParams(**params),
                         M=L.JacobiPreconditioner(A) if method == "pcg" else None,
                         pallas=pallas)
            assert lr.status == jr.status == L.Status.CONVERGENCE
            assert abs(int(lr.iterations) - int(jr.iterations)) <= 1
            assert _x_rel(lr, jr) <= 1e-8


@pytest.mark.parametrize("as_type", ["numpy", "tensor", "callable"])
def test_non_operator_A_is_coerced_like_jax(as_type):
    A, b = _systems.spd_dense(40, seed=3)
    if as_type == "callable":
        At = torch.from_numpy(A)
        lA, jA = (lambda x: At @ x), (lambda x: jnp.asarray(A) @ x)
    else:
        lA = torch.from_numpy(A) if as_type == "tensor" else A
        jA = A
    params = dict(epsilon=1e-20)
    lr = L.solve(lA, torch.from_numpy(b), params=L.SolverParams(**params))
    jr = J.solve(jA, b, params=J.SolverParams(**params))
    assert lr.status == jr.status
    assert int(lr.iterations) == int(jr.iterations)
    assert _x_rel(lr, jr) <= 1e-8


@pytest.mark.parametrize("name", sorted(set(J.solve.__globals__["_ALIASES"])
                                        | set(J.REAL_METHODS) | set(J.COMPLEX_METHODS)
                                        | set(J.BLOCK_METHODS) | {"nonsense"}))
def test_canonical_method_and_unported_methods(name):
    try:
        jm = J.canonical_method(name)
    except ValueError:
        with pytest.raises(ValueError, match="unknown solver"):
            L.canonical_method(name)
        return
    assert L.canonical_method(name) == jm
    A, b = _systems.spd_dense(8)
    if jm in J.BLOCK_METHODS:
        with pytest.raises(ValueError, match="solve_batched"):
            L.solve(A, b, method=name)
    elif jm not in ("cg", "pcg"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            L.solve(A, b, method=name)


_ERROR_CASES = {
    "INVALID_EPSILON": (dict(params=dict(epsilon=0.0)), "cg"),
    "INVALID_MAX_ITERATIONS": (dict(params=dict(max_iterations=-1)), "pcg"),
    "NULL_PRECONDITION_MATRIX": (dict(M=None), "pcg"),
    "INVALID_VARIABLE_SIZE": (dict(b2d=True), "cg"),
    "SIZE_NOT_MATCH": (dict(x0_short=True), "cg"),
}


@pytest.mark.parametrize("case", sorted(_ERROR_CASES))
def test_error_statuses_match_jax(case):
    kw, method = _ERROR_CASES[case]
    A, b = _systems.spd_dense(8)
    lkw, jkw = {}, {}
    if "params" in kw:
        lkw["params"] = L.SolverParams(**kw["params"])
        jkw["params"] = J.SolverParams(**kw["params"])
    if kw.get("b2d"):
        b = np.stack([b, b])
    if kw.get("x0_short"):
        lkw["x0"] = torch.zeros(7, dtype=torch.float64)
        jkw["x0"] = np.zeros(7)
    if method == "pcg" and "M" not in kw:
        lkw["M"] = L.JacobiPreconditioner(L.DenseOperator(A))
        jkw["M"] = J.JacobiPreconditioner(J.DenseOperator(A))
    lr = L.solve(L.DenseOperator(A), torch.from_numpy(b), method=method, **lkw)
    jr = J.solve(J.DenseOperator(A), b, method=method, **jkw)
    assert lr.status.name == jr.status.name == case
    assert int(lr.iterations) == 0 and np.isnan(float(lr.residual))


def test_argument_errors():
    A, b = _systems.spd_dense(8)
    LA = L.DenseOperator(A)
    with pytest.raises(ValueError, match="does not use a preconditioner"):
        L.solve(LA, b, method="cg", M=L.JacobiPreconditioner(LA))
    with pytest.raises(ValueError, match="pallas must be"):
        L.solve(LA, b, pallas="sometimes")
    with pytest.raises(ValueError, match="is on meta"):
        L.solve(LA, torch.empty(8, dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="complex domain"):
        L.solve(LA, b.astype(np.complex128))
    with pytest.raises(L.LcgError):
        L.solve(LA, b, params=L.SolverParams(epsilon=1e-30, max_iterations=2),
                check=True)


def test_import_leaves_jax_out():
    root = Path(__file__).resolve().parent.parent
    code = ("import sys, liblcg_tpu_torch, liblcg_tpu_torch.convert, "
            "liblcg_tpu_torch._build, liblcg_tpu_torch._systems; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)
    imports_jax = re.compile(r"^\s*(from|import)\s+(jax|liblcg_tpu)\b(?!_)", re.M)
    for path in [root / "chip_smoke.py", *(root / "liblcg_tpu_torch").rglob("*.py")]:
        assert not imports_jax.search(path.read_text()), path
