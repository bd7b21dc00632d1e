"""The port's plain CG/PCG engines against liblcg_tpu.solvers.real in f64."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import liblcg_tpu as J
import liblcg_tpu_torch as L
from liblcg_tpu.solvers import real as JR
from liblcg_tpu_torch import _systems
from liblcg_tpu_torch.solvers import real as LR

torch.set_num_threads(1)

X_RTOL = 1e-8


def _system(kind):
    """(port operator, JAX operator, b, x_true) in f64."""
    if kind == "banded":
        n = 4096
        rows, cols, vals, _ = _systems.banded_spd(n, seed=1)
        LA = L.BandedOperator(n, n, rows, cols, vals)
        JA = J.BandedOperator(n, n, rows, cols, vals)
    else:
        A, _ = _systems.spd_dense(300, seed=2)
        n = 300
        LA, JA = L.DenseOperator(A), J.DenseOperator(A)
    x_true = np.random.default_rng(3).uniform(1.0, 2.0, n)
    b = LA.mv(torch.from_numpy(x_true)).numpy()
    return LA, JA, b, x_true


_SYSTEMS = {kind: _system(kind) for kind in ("banded", "dense")}

# case -> (SolverParams kwargs, extra solve kwargs, how b/x0 are made)
_CASES = {
    "converge": (dict(epsilon=1e-20), {}, None),
    "converge_loose": (dict(epsilon=1e-8), {}, None),
    "monitor_stop": (dict(epsilon=1e-20), dict(monitor=lambda x, r, t: t >= 3), None),
    "max_iterations": (dict(epsilon=1e-20, max_iterations=5), {}, None),
    "already_optimized": (dict(epsilon=1e-14), {}, "exact_x0"),
    "nan_value": (dict(epsilon=1e-14), {}, "nan_b"),
    "abs_diff": (dict(epsilon=1e-12, abs_diff=1), {}, None),
    "trace": (dict(epsilon=1e-20), dict(trace_len=40), None),
    "hard_cap": (dict(epsilon=1e-20, hard_iteration_cap=6), {}, None),
    "x0_given": (dict(epsilon=1e-20), {}, "x0"),
}


def _run_both(kind, method, case):
    LA, JA, b, x_true = _SYSTEMS[kind]
    pkw, skw, how = _CASES[case]
    b = b.copy()
    x0 = None
    if how == "exact_x0":
        x0 = x_true
    elif how == "nan_b":
        b[7] = np.nan
    elif how == "x0":
        x0 = np.random.default_rng(4).uniform(-1.0, 1.0, len(b))
    lp, jp = L.SolverParams(**pkw), J.SolverParams(**pkw)
    lx0 = None if x0 is None else torch.from_numpy(x0)
    jx0 = None if x0 is None else jnp.asarray(x0)
    if method == "pcg":
        lc = LR.pcg(LA, torch.from_numpy(b), lx0, M=L.JacobiPreconditioner(LA),
                    params=lp, **skw)
        jc = JR.pcg(JA, jnp.asarray(b), jx0, M=J.JacobiPreconditioner(JA),
                    params=jp, **skw)
    else:
        lc = LR.cg(LA, torch.from_numpy(b), lx0, params=lp, **skw)
        jc = JR.cg(JA, jnp.asarray(b), jx0, params=jp, **skw)
    return lc, jc


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("method", ["cg", "pcg"])
@pytest.mark.parametrize("kind", ["banded", "dense"])
def test_engine_matches_jax(kind, method, case):
    lc, jc = _run_both(kind, method, case)
    assert int(lc["status"]) == int(jc["status"])
    assert int(lc["t"]) == int(jc["t"])
    assert lc["status"].dtype == torch.int32 and lc["t"].dtype == torch.int32
    lx, jx = lc["x"].numpy(), np.asarray(jc["x"])
    if case == "nan_value":
        assert int(lc["status"]) == int(L.Status.NAN_VALUE)
        assert np.isnan(float(lc["residual"]))
        return
    assert np.linalg.norm(lx - jx) <= X_RTOL * np.linalg.norm(jx)
    lr, jr = float(lc["residual"]), float(jc["residual"])
    eps = _CASES[case][0]["epsilon"]
    if jr <= eps:
        assert lr <= eps
    else:
        assert lr == pytest.approx(jr, rel=1e-6)
    if case == "trace":
        lt, jt = lc["trace"].numpy(), np.asarray(jc["trace"])
        assert lt.shape == jt.shape == (40,)
        np.testing.assert_allclose(lt, jt, rtol=1e-6, atol=0)


def test_expected_statuses_are_exercised():
    """The cases above reach every status the engine can return."""
    seen = {int(_run_both("dense", "cg", case)[0]["status"]) for case in _CASES}
    assert seen == {int(s) for s in (L.Status.CONVERGENCE, L.Status.STOP,
                                      L.Status.REACHED_MAX_ITERATIONS,
                                      L.Status.ALREADY_OPTIMIZED,
                                      L.Status.NAN_VALUE)}


@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_reduce_dtype_accumulates_wider(method):
    """f32 storage with f64 dot products, as SolverParams.reduce_dtype asks."""
    LA, JA, b, _ = _SYSTEMS["banded"]
    LA32, JA32 = LA.astype(torch.float32), JA.astype(jnp.float32)
    b32 = b.astype(np.float32)
    kw = dict(epsilon=1e-10, reduce_dtype="float64")
    if method == "pcg":
        lc = LR.pcg(LA32, torch.from_numpy(b32), M=L.JacobiPreconditioner(LA32),
                    params=L.SolverParams(**kw))
        with J.solvers.harness.reduction_dtype("float64"):
            jc = JR.pcg(JA32, jnp.asarray(b32), M=J.JacobiPreconditioner(JA32),
                        params=J.SolverParams(**kw))
    else:
        lc = LR.cg(LA32, torch.from_numpy(b32), params=L.SolverParams(**kw))
        with J.solvers.harness.reduction_dtype("float64"):
            jc = JR.cg(JA32, jnp.asarray(b32), params=J.SolverParams(**kw))
    assert lc["x"].dtype == torch.float32
    assert int(lc["status"]) == int(jc["status"]) == int(L.Status.CONVERGENCE)
    assert abs(int(lc["t"]) - int(jc["t"])) <= 2
    lx, jx = lc["x"].numpy(), np.asarray(jc["x"])
    assert np.linalg.norm(lx - jx) <= 1e-4 * np.linalg.norm(jx)
