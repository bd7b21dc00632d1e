"""solve_batched() and solve_sequence() against liblcg_tpu: the batched
engine in f64 per system, K3/K4's plain versions against the Pallas
kernels in interpret mode, the routing and its errors, the stacked
operators, and solve_sequence()."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import liblcg_tpu as J
import liblcg_tpu_torch as L
from liblcg_tpu.ops.pallas_cg import pallas_cg_dia_batched, pallas_pcg_dia_batched
from liblcg_tpu_torch import _systems
from liblcg_tpu_torch.ops import cuda_cg
from liblcg_tpu_torch.ops.dia import dia_spmv, dia_spmv_transpose

torch.set_num_threads(1)

N = 2048
NRHS = 4
ZERO_ROW = 1                       # _systems.rhs_stack's zero right-hand side
_ROWS, _COLS, _VALS, _ = _systems.banded_spd(N, seed=3)
_LA = L.BandedOperator(N, N, _ROWS, _COLS, _VALS)
_JA = J.BandedOperator(N, N, _ROWS, _COLS, _VALS)
_B = _systems.rhs_stack(N, NRHS, seed=1)


def _precond(method, LA, JA):
    if method != "pcg":
        return None, None
    return L.JacobiPreconditioner(LA), J.JacobiPreconditioner(JA)


def _assert_rows_close(lx, jx, rtol, rows=range(NRHS)):
    """Each row of the port's (nrhs, n) x within ``rtol`` of JAX's."""
    lx, jx = np.asarray(lx, np.float64), np.asarray(jx, np.float64)
    for r in rows:
        scale = np.linalg.norm(jx[r])
        assert np.linalg.norm(lx[r] - jx[r]) <= rtol * scale, r
        if scale == 0:
            assert not lx[r].any()


def _assert_residuals_match(lres, jres, eps):
    for lr, jr in zip(np.asarray(lres), np.asarray(jres)):
        if jr <= eps:
            assert lr <= eps
        else:
            assert lr == pytest.approx(jr, rel=1e-6)


# case -> (SolverParams kwargs, extra solve_batched kwargs for (port, JAX),
#          how B/X0 are made)
_STOP_AT = np.array([[5], [0], [30], [10_000]])
_ENGINE_CASES = {
    "converge": (dict(epsilon=1e-20), ({}, {}), None),
    "abs_diff": (dict(epsilon=1e-12, abs_diff=1), ({}, {}), None),
    "max_iterations": (dict(epsilon=1e-20, max_iterations=50), ({}, {}), None),
    "monitor_per_system": (dict(epsilon=1e-20), (
        dict(monitor=lambda X, r, t: t >= torch.from_numpy(_STOP_AT)),
        dict(monitor=lambda X, r, t: t >= jnp.asarray(_STOP_AT))), None),
    "monitor_scalar": (dict(epsilon=1e-20), (
        dict(monitor=lambda X, r, t: bool(t.max() >= 7)),
        dict(monitor=lambda X, r, t: jnp.max(t) >= 7)), None),
    "trace": (dict(epsilon=1e-20), (dict(trace_len=50), dict(trace_len=50)), None),
    "x0_given": (dict(epsilon=1e-20), ({}, {}), "x0"),
    "nan_row": (dict(epsilon=1e-14), ({}, {}), "nan"),
}


@pytest.mark.parametrize("case", sorted(_ENGINE_CASES))
@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_batched_engine_matches_jax(method, case):
    """f64, per system: status, t, residual and x of solve_batched's plain
    engine against JAX's batched engine (pallas="never" on both)."""
    pkw, (lkw, jkw), how = _ENGINE_CASES[case]
    B, X0 = _B.copy(), None
    if how == "x0":
        X0 = np.random.default_rng(4).uniform(-1.0, 1.0, B.shape)
        X0[ZERO_ROW] = 0.0            # the zero system stays solved at t = 0
    elif how == "nan":
        B[2, 17] = np.nan
    LM, JM = _precond(method, _LA, _JA)
    jr = J.solve_batched(_JA, B, X0, method=method, M=JM,
                         params=J.SolverParams(**pkw), pallas="never", **jkw)
    lr = L.solve_batched(_LA, torch.from_numpy(B),
                         None if X0 is None else torch.from_numpy(X0),
                         method=method, M=LM, params=L.SolverParams(**pkw),
                         pallas="never", **lkw)
    assert lr.status_code.tolist() == np.asarray(jr.status_code).tolist()
    assert lr.iterations.tolist() == np.asarray(jr.iterations).tolist()
    assert lr.status_code.dtype == lr.iterations.dtype == torch.int32
    assert lr.x.shape == (NRHS, N) and lr.residual.shape == (NRHS,)
    rows = [r for r in range(NRHS) if how != "nan" or r != 2]
    _assert_rows_close(lr.x, jr.x, 1e-8, rows)
    _assert_residuals_match(lr.residual[rows], np.asarray(jr.residual)[rows],
                            pkw["epsilon"])
    if how != "nan":  # a monitor is asked before epsilon, after the loop too
        zero = L.Status.STOP if "monitor" in case else L.Status.ALREADY_OPTIMIZED
        assert int(lr.status_code[ZERO_ROW]) == int(zero)
    if how == "nan":
        assert int(lr.status_code[2]) == int(L.Status.NAN_VALUE)
    if case == "trace":
        assert lr.trace.shape == (NRHS, 50)
        np.testing.assert_allclose(lr.trace.numpy(), np.asarray(jr.trace),
                                   rtol=1e-6, atol=0)


def test_engine_cases_reach_every_status():
    """The cases above give each status the batched engine can return."""
    seen = set()
    for case in ("converge", "max_iterations", "monitor_per_system", "nan_row"):
        pkw, (lkw, _), how = _ENGINE_CASES[case]
        B = _B.copy()
        if how == "nan":
            B[2, 17] = np.nan
        r = L.solve_batched(_LA, torch.from_numpy(B), params=L.SolverParams(**pkw),
                            pallas="never", **lkw)
        seen |= set(r.status_code.tolist())
    assert seen == {int(s) for s in (L.Status.CONVERGENCE, L.Status.STOP,
                                      L.Status.REACHED_MAX_ITERATIONS,
                                      L.Status.ALREADY_OPTIMIZED,
                                      L.Status.NAN_VALUE)}


def _other_operators():
    """(port A, JAX A, port M, JAX M, B) for operators other than DIA."""
    A, b = _systems.spd_dense(60, seed=7)
    Bd = np.stack([b, np.zeros_like(b), np.linspace(-1.0, 1.0, 60)])
    At = torch.from_numpy(A)
    nz, ny, nx = 5, 6, 7
    Bl = _systems.rhs_stack(nz * ny * nx, 3, seed=2)
    lap_l = L.Laplacian3DOperator(nz, ny, nx, dtype=torch.float64)
    lap_j = J.Laplacian3DOperator(nz, ny, nx, dtype=jnp.float64)
    inv_d = 1.0 / np.diag(A)
    return {
        "dense": (L.DenseOperator(A), J.DenseOperator(A), None, None, Bd),
        "callable A": (lambda x: At @ x, lambda x: jnp.asarray(A) @ x, None, None, Bd),
        "laplacian": (lap_l, lap_j, None, None, Bl),
        "callable M": (L.DenseOperator(A), J.DenseOperator(A),
                       lambda r: torch.from_numpy(inv_d) * r,
                       lambda r: jnp.asarray(inv_d) * r, Bd),
    }


_OTHERS = _other_operators()


@pytest.mark.parametrize("case", sorted(_OTHERS))
def test_batched_engine_on_other_operators_matches_jax(case):
    """Operators that stack their own product and those that go row by row
    (a callable A or M, as JAX maps them with jax.vmap)."""
    LA, JA, LM, JM, B = _OTHERS[case]
    method = "pcg" if LM is not None else "cg"
    params = dict(epsilon=1e-20, max_iterations=500)
    jr = J.solve_batched(JA, B, method=method, M=JM, params=J.SolverParams(**params))
    lr = L.solve_batched(LA, torch.from_numpy(B), method=method, M=LM,
                         params=L.SolverParams(**params))
    assert lr.status_code.tolist() == np.asarray(jr.status_code).tolist()
    assert lr.iterations.tolist() == np.asarray(jr.iterations).tolist()
    _assert_rows_close(lr.x, jr.x, 1e-8, range(B.shape[0]))


_PALLAS = {"cg": pallas_cg_dia_batched, "pcg": pallas_pcg_dia_batched}
_PLAIN = {"cg": cuda_cg.cg_dia_batched_reference,
          "pcg": cuda_cg.pcg_dia_batched_reference}
_WRAPPER = {"cg": cuda_cg.cg_dia_batched, "pcg": cuda_cg.pcg_dia_batched}


def _kernel_args(method, dtype, B=_B, X0=None):
    """Port arguments (offsets, vals, [inv_diag], B, X0) at ``dtype``."""
    np_dt = np.dtype(str(dtype).split(".")[-1])
    vals = torch.tensor(np.asarray(_JA.diag_vals).astype(np_dt))
    Bt = torch.tensor(B.astype(np_dt))
    X0t = torch.zeros_like(Bt) if X0 is None else torch.tensor(X0.astype(np_dt))
    if method == "pcg":
        invd = torch.tensor((1.0 / np.asarray(_JA.diagonal())).astype(np_dt))
        return (_JA.offsets, vals, invd, Bt, X0t)
    return (_JA.offsets, vals, Bt, X0t)


def _run_pallas(method, args, **kw):
    jargs = [a if isinstance(a, tuple) else jnp.asarray(a.numpy()) for a in args]
    X, t, res = _PALLAS[method](*jargs, interpret=True, **kw)
    return np.asarray(X, np.float64), np.asarray(t), np.asarray(res)


@pytest.mark.parametrize("abs_diff", [False, True])
@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_plain_f32_matches_pallas_interpret(method, abs_diff):
    """K3/K4's plain versions against the Pallas batched kernels run by
    JAX's interpreter, f32, with their freezing and zero guards."""
    eps = 1e-7 if abs_diff else 1e-10
    args = _kernel_args(method, torch.float32)
    kw = dict(n=N, nrhs=NRHS, eps=eps, max_iter=10000, abs_diff=abs_diff)
    X, t, res = _PLAIN[method](*args, **kw)
    jX, jt, jres = _run_pallas(method, args, **kw)
    assert np.all(np.abs(t.numpy() - jt) <= 2)  # as tests/test_pallas_kernel.py
    assert int(t[ZERO_ROW]) == int(jt[ZERO_ROW]) == 0
    _assert_rows_close(X, jX, 1e-4)
    assert np.all(res.numpy() <= eps) and np.all(jres <= eps)
    assert X.dtype == torch.float32 and t.dtype == torch.int32
    assert X.shape == (NRHS, N) and t.shape == res.shape == (NRHS,)


@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_plain_f32_max_iter_exit_matches_pallas_interpret(method):
    args = _kernel_args(method, torch.float32)
    kw = dict(n=N, nrhs=NRHS, eps=1e-12, max_iter=9, abs_diff=False)
    X, t, res = _PLAIN[method](*args, **kw)
    jX, jt, jres = _run_pallas(method, args, **kw)
    assert t.tolist() == jt.tolist()
    assert t.tolist().count(9) >= 2
    np.testing.assert_allclose(res.numpy(), jres, rtol=1e-3)


@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_plain_f64_matches_jax_engine(method):
    """In f64 the plain version follows the JAX batched engine: the zero
    guards only change systems the engine's mask throws away."""
    eps = 1e-20
    X, t, res = _PLAIN[method](*_kernel_args(method, torch.float64), n=N,
                               nrhs=NRHS, eps=eps, max_iter=10000)
    _, JM = _precond(method, _LA, _JA)
    jr = J.solve_batched(_JA, _B, method=method, M=JM,
                         params=J.SolverParams(epsilon=eps), pallas="never")
    assert t.tolist() == np.asarray(jr.iterations).tolist()
    _assert_rows_close(X, jr.x, 1e-8)


@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_wrapper_on_cpu_runs_the_plain_version_without_counting(method):
    args = _kernel_args(method, torch.float64)
    kw = dict(n=N, nrhs=NRHS, eps=1e-16, max_iter=10000)
    before = _WRAPPER[method].launches
    X, t, res = _WRAPPER[method](*args, **kw)
    Xp, tp, rp = _PLAIN[method](*args, **kw)
    assert _WRAPPER[method].launches == before
    assert torch.equal(X, Xp) and torch.equal(t, tp) and torch.equal(res, rp)


def _bad_batched_inputs(method):
    good = list(_kernel_args(method, torch.float64))
    b_at = 3 if method == "pcg" else 2
    cases = {}
    v = good.copy()
    v[b_at] = v[b_at][:, :-1]
    cases["short rows"] = (v, NRHS)
    v = good.copy()
    v[b_at] = v[b_at][:-1]
    cases["fewer rows than nrhs"] = (v, NRHS)
    v = good.copy()
    v[b_at] = v[b_at].mT.contiguous().mT
    cases["column-major B"] = (v, NRHS)
    v = good.copy()
    v[b_at + 1] = v[b_at + 1].to(torch.float32)
    cases["X0 of another dtype"] = (v, NRHS)
    v = good.copy()
    v[b_at] = v[b_at][0]
    cases["a vector for B"] = (v, NRHS)
    big = torch.zeros((cuda_cg.MAX_RHS + 1, N), dtype=torch.float64)
    v = good.copy()
    v[b_at], v[b_at + 1] = big, big
    cases["more right-hand sides than the kernel holds"] = (v, cuda_cg.MAX_RHS + 1)
    return cases


@pytest.mark.parametrize("case", sorted(_bad_batched_inputs("cg")))
@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_batched_wrapper_refuses_bad_input(method, case):
    args, nrhs = _bad_batched_inputs(method)[case]
    with pytest.raises(ValueError):
        _WRAPPER[method](*args, n=N, nrhs=nrhs, eps=1e-10, max_iter=10)


@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_solve_batched_always_on_cpu_runs_the_plain_version(method):
    """pallas="always" on CPU tensors: the port runs K3/K4's plain version,
    JAX its Pallas interpreter; f32, per system."""
    LA32, JA32 = _LA.astype(torch.float32), _JA.astype(jnp.float32)
    LM, JM = _precond(method, LA32, JA32)
    B32 = _B.astype(np.float32)
    params = dict(epsilon=1e-10)
    before = _WRAPPER[method].launches
    lr = L.solve_batched(LA32, torch.from_numpy(B32), method=method, M=LM,
                         params=L.SolverParams(**params), pallas="always")
    assert _WRAPPER[method].launches == before
    jr = J.solve_batched(JA32, B32, method=method, M=JM,
                         params=J.SolverParams(**params), pallas="always")
    assert lr.status_code.tolist() == np.asarray(jr.status_code).tolist()
    assert np.all(np.abs(lr.iterations.numpy() - np.asarray(jr.iterations)) <= 2)
    assert int(lr.status_code[ZERO_ROW]) == int(L.Status.ALREADY_OPTIMIZED)
    assert int(lr.iterations[ZERO_ROW]) == 0
    _assert_rows_close(lr.x, jr.x, 1e-4)
    args = list(_kernel_args(method, torch.float32))
    if method == "pcg":
        args[2] = LM.inv_diag
    X, t, res = _PLAIN[method](*args, n=N, nrhs=NRHS, eps=1e-10, max_iter=10000)
    assert torch.equal(lr.x, X) and torch.equal(lr.iterations, t)


@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_solve_batched_auto_on_cpu_runs_the_engine(method):
    LM, _ = _precond(method, _LA, _JA)
    params = L.SolverParams(epsilon=1e-14)
    B = torch.from_numpy(_B)
    auto = L.solve_batched(_LA, B, method=method, M=LM, params=params)
    never = L.solve_batched(_LA, B, method=method, M=LM, params=params,
                            pallas="never")
    assert torch.equal(auto.x, never.x)
    assert torch.equal(auto.iterations, never.iterations)
    assert "['CONVERGENCE', 'ALREADY_OPTIMIZED'" in repr(auto)


_ROUTING = {
    # case -> (the methods it applies to, the word both errors contain)
    "monitor": (("cg", "pcg"), "monitor"),
    "trace": (("cg", "pcg"), "trace recording"),
    "dense": (("cg", "pcg"), "BandedOperator"),
    "reduce_dtype": (("cg", "pcg"), "reduce_dtype"),
    "callable M": (("pcg",), "diagonal preconditioner"),
}


@pytest.mark.parametrize("method,case", [(m, c) for c, (ms, _) in sorted(_ROUTING.items())
                                         for m in ms])
def test_always_on_an_ineligible_stack_raises_like_jax(method, case):
    LA, JA = _LA.astype(torch.float32), _JA.astype(jnp.float32)
    B = _B.astype(np.float32)
    lkw, jkw = {}, {}
    if case == "monitor":
        lkw["monitor"] = jkw["monitor"] = lambda X, r, t: t >= 3
    elif case == "trace":
        lkw["trace_len"] = jkw["trace_len"] = 8
    elif case == "dense":
        dense = np.eye(6, dtype=np.float32) * 4.0
        LA, JA, B = L.DenseOperator(dense), J.DenseOperator(dense), B[:, :6]
    elif case == "reduce_dtype":
        lkw["params"] = L.SolverParams(reduce_dtype="float64")
        jkw["params"] = J.SolverParams(reduce_dtype="float64")
    if method == "pcg":
        if case == "callable M":
            lkw["M"] = jkw["M"] = lambda r: r
        else:
            lkw["M"], jkw["M"] = L.JacobiPreconditioner(LA), J.JacobiPreconditioner(JA)
    with pytest.raises(ValueError, match="pallas='always' but") as jerr:
        J.solve_batched(JA, jnp.asarray(B), method=method, pallas="always", **jkw)
    with pytest.raises(ValueError, match="pallas='always' but") as lerr:
        L.solve_batched(LA, torch.from_numpy(B), method=method, pallas="always",
                        **lkw)
    word = _ROUTING[case][1]
    assert word in str(jerr.value) and word in str(lerr.value)


def test_batched_kernel_ineligibility_reasons():
    A = _LA
    M = L.JacobiPreconditioner(A)
    reason = cuda_cg.kernel_ineligibility
    assert reason(A, torch.float64, "cg", None, None, batched=True, nrhs=4) is None
    assert reason(A, torch.float64, "pcg", M, None, batched=True, nrhs=64) is None
    assert "right-hand sides" in reason(A, torch.float64, "cg", None, None,
                                        batched=True, nrhs=cuda_cg.MAX_RHS + 1)
    assert "batched" in reason(A, torch.float64, "cgs", None, None, batched=True,
                               nrhs=4)
    assert "float32 or float64" in reason(A.astype(torch.float16), torch.float16,
                                          "cg", None, None, batched=True, nrhs=4)
    with pytest.raises(ValueError, match="right-hand sides"):
        L.solve_batched(A, torch.zeros((cuda_cg.MAX_RHS + 1, N), dtype=torch.float64),
                        pallas="always")


# case -> (port kwargs, JAX kwargs, what both do: an exception and its words,
#          or a status name)
_ARG_CASES = {
    "bicgstab2 with abs_diff": (dict(method="bicgstab2", params=dict(abs_diff=1)),
                                (ValueError, "not batchable")),
    "B is a vector": (dict(B=_B[0]), (ValueError, "must be \\(nrhs, n\\)")),
    "M given to cg": (dict(M=True), (ValueError, "does not use a preconditioner")),
    "pallas value": (dict(pallas="sometimes"), (ValueError, "pallas must be")),
    "invalid epsilon": (dict(params=dict(epsilon=0.0)), "INVALID_EPSILON"),
    "pcg without M": (dict(method="pcg"), "NULL_PRECONDITION_MATRIX"),
}


@pytest.mark.parametrize("case", sorted(_ARG_CASES))
def test_solve_batched_argument_checks_match_jax(case):
    kw, want = _ARG_CASES[case]
    lkw, jkw = {}, {}
    for k, v in kw.items():
        if k == "params":
            lkw[k], jkw[k] = L.SolverParams(**v), J.SolverParams(**v)
        elif k == "M":
            lkw[k], jkw[k] = L.JacobiPreconditioner(_LA), J.JacobiPreconditioner(_JA)
        elif k != "B":
            lkw[k] = jkw[k] = v
    B = kw.get("B", _B)
    if isinstance(want, str):
        lr = L.solve_batched(_LA, torch.from_numpy(B), **lkw)
        jr = J.solve_batched(_JA, B, **jkw)
        assert lr.status.name == jr.status.name == want
        assert int(lr.iterations) == 0
        return
    exc, words = want
    with pytest.raises(exc, match=words):
        J.solve_batched(_JA, B, **jkw)
    with pytest.raises(exc, match=words):
        L.solve_batched(_LA, torch.from_numpy(B), **lkw)


@pytest.mark.parametrize("method,words", [
    ("cacg", "s-step CA-CG"), ("block_cg", "GMRES, MINRES and block CG"),
    ("bpcg", "GMRES, MINRES and block CG"), ("bicgstab", "other real methods"),
    ("gmres", "GMRES, MINRES and block CG"), ("tfqmr", "native complex engines")])
def test_solve_batched_refuses_unported_methods(method, words):
    with pytest.raises(NotImplementedError, match=words):
        L.solve_batched(_LA, torch.from_numpy(_B), method=method)


def test_solve_batched_check_raises_on_a_failed_system():
    with pytest.raises(L.LcgError):
        L.solve_batched(_LA, torch.from_numpy(_B),
                        params=L.SolverParams(epsilon=1e-30, max_iterations=2),
                        check=True)


def test_batched_methods_are_jax_s():
    assert L.BATCHED_METHODS == J.BATCHED_METHODS


def test_stacked_dia_products_equal_row_products_bit_for_bit():
    X = torch.from_numpy(np.random.default_rng(8).uniform(-1.0, 1.0, (5, N)))
    off, vals = _LA.offsets, _LA.diag_vals
    Y = dia_spmv(off, vals, X)
    assert torch.equal(Y, torch.stack([dia_spmv(off, vals, x) for x in X]))
    assert torch.equal(Y, torch.vmap(lambda x: dia_spmv(off, vals, x))(X))
    Yt = dia_spmv_transpose(off, vals, X, N)
    assert torch.equal(Yt, torch.stack([dia_spmv_transpose(off, vals, x, N) for x in X]))
    # A vector gives what a zero-padded 1-D image and shifted slices give.
    x = X[0]
    pad_l, pad_r = -min(off), max(off)
    x_pad = x.new_zeros(pad_l + N + pad_r)
    x_pad[pad_l:pad_l + N] = x
    y = None
    for d, o in enumerate(off):
        term = vals[d] * x_pad[pad_l + o:pad_l + o + N]
        y = term if y is None else y + term
    assert torch.equal(dia_spmv(off, vals, x), y)


def test_stacked_laplacian_and_jacobi_equal_row_products_bit_for_bit():
    nz, ny, nx = 5, 6, 7
    A = L.Laplacian3DOperator(nz, ny, nx, dtype=torch.float64)
    X = torch.from_numpy(np.random.default_rng(9).uniform(-1.0, 1.0, (4, nz * ny * nx)))
    assert torch.equal(A.mv(X), torch.stack([A.mv(x) for x in X]))
    M = L.JacobiPreconditioner(_LA)
    Xb = torch.from_numpy(_B)
    assert torch.equal(M.mv(Xb), torch.stack([M.mv(x) for x in Xb]))
    D = L.DenseOperator(_systems.spd_dense(30, seed=1)[0])
    Xd = X[:, :30]
    torch.testing.assert_close(D.mv(Xd), torch.stack([D.mv(x) for x in Xd]),
                               rtol=1e-14, atol=0)


@pytest.mark.parametrize("takes_stack", [False, True])
def test_batched_engine_gives_a_stack_only_to_an_operator_that_takes_one(takes_stack):
    """An operator's ``takes_stack`` decides whether the batched engine
    hands ``mv`` the whole stack or one row at a time; the answer is the
    same either way."""
    A = torch.from_numpy(_systems.spd_dense(40, seed=3)[0])
    seen = []

    class Op(L.MatrixFreeOperator):
        def mv(self, x):
            seen.append(x.ndim)
            return x @ A.mT

    op = Op(None, 40, torch.float64)
    op.takes_stack = takes_stack
    B = torch.from_numpy(_systems.rhs_stack(40, 3, seed=4))
    res = L.solve_batched(op, B, method="cg")
    assert set(seen) == ({2} if takes_stack else {1})
    ref = L.solve_batched(L.DenseOperator(A), B, method="cg")
    assert torch.equal(res.iterations, ref.iterations)
    torch.testing.assert_close(res.x, ref.x, rtol=1e-10, atol=1e-12)
    assert L.MatrixFreeOperator(None, 4).takes_stack is False
    assert all(cls.takes_stack for cls in (L.BandedOperator, L.DenseOperator,
                                           L.Laplacian3DOperator,
                                           L.JacobiPreconditioner))


def _sequence_pair(batched):
    """next_b for the port and for JAX: the previous solution, scaled to
    unit length (a zero row stays zero)."""
    if batched:
        return (lambda x, k: x), (lambda x, k: x)

    def lnext(x, k):
        return x / torch.linalg.vector_norm(x)

    def jnext(x, k):
        return x / jnp.sqrt(jnp.sum(x * x))

    return lnext, jnext


@pytest.mark.parametrize("keep", [True, False])
@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_solve_sequence_matches_jax(method, batched, warm, keep):
    """A chain of 3 dependent solves, single or batched b0, warm-started or
    not, keeping every solution or the last: per step status, t and x."""
    b0 = _B if batched else _B[0]
    LM, JM = _precond(method, _LA, _JA)
    lnext, jnext = _sequence_pair(batched)
    params = dict(epsilon=1e-20)
    jr = J.solve_sequence(_JA, b0, jnext, 3, method=method, M=JM,
                          params=J.SolverParams(**params), warm_start=warm,
                          keep_solutions=keep)
    lr = L.solve_sequence(_LA, torch.from_numpy(b0), lnext, 3, method=method, M=LM,
                          params=L.SolverParams(**params), warm_start=warm,
                          keep_solutions=keep)
    assert tuple(lr.x.shape) == tuple(jr.x.shape)
    assert lr.status_code.tolist() == np.asarray(jr.status_code).tolist()
    assert lr.iterations.tolist() == np.asarray(jr.iterations).tolist()
    lx = lr.x.numpy().reshape(-1, N)
    jx = np.asarray(jr.x).reshape(-1, N)
    for r in range(lx.shape[0]):
        scale = np.linalg.norm(jx[r])
        assert np.linalg.norm(lx[r] - jx[r]) <= 1e-8 * max(scale, 1e-300)


def test_solve_sequence_equals_chained_solves():
    params = L.SolverParams(epsilon=1e-20)
    seq = L.solve_sequence(_LA, torch.from_numpy(_B[0]), lambda x, k: x, 3,
                           params=params)
    x, b = torch.zeros(N, dtype=torch.float64), torch.from_numpy(_B[0])
    for k in range(3):
        r = L.solve(_LA, b, x, params=params, pallas="never")
        assert torch.equal(seq.x[k], r.x)
        assert int(seq.iterations[k]) == int(r.iterations)
        x, b = r.x, r.x


@pytest.mark.parametrize("case", ["spg", "cg with M", "stack of stacks",
                                  "cacg batched", "pcg without M"])
def test_solve_sequence_refusals_match_jax(case):
    b0, method, lkw, jkw = _B[0], "cg", {}, {}
    if case == "spg":
        method = "spg"
    elif case == "cg with M":
        lkw["M"], jkw["M"] = L.JacobiPreconditioner(_LA), J.JacobiPreconditioner(_JA)
    elif case == "stack of stacks":
        b0 = _B[None]
    elif case == "cacg batched":
        b0, method = _B, "cacg"
    elif case == "pcg without M":
        method = "pcg"
    if case == "pcg without M":
        lr = L.solve_sequence(_LA, torch.from_numpy(b0), lambda x, k: x, 2,
                              method=method)
        jr = J.solve_sequence(_JA, b0, lambda x, k: x, 2, method=method)
        assert lr.status.name == jr.status.name == "NULL_PRECONDITION_MATRIX"
        return
    with pytest.raises(ValueError) as jerr:
        J.solve_sequence(_JA, b0, lambda x, k: x, 2, method=method, **jkw)
    with pytest.raises(ValueError) as lerr:
        L.solve_sequence(_LA, torch.from_numpy(b0), lambda x, k: x, 2,
                         method=method, **lkw)
    word = {"spg": "unconstrained", "cg with M": "preconditioner",
            "stack of stacks": "b0 must be", "cacg batched": "batched"}[case]
    assert word in str(jerr.value) and word in str(lerr.value)
