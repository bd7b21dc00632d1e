"""The port's types and status helpers against liblcg_tpu's, field for field."""

import dataclasses

import pytest
import torch

import liblcg_tpu as J
import liblcg_tpu_torch as L
from liblcg_tpu.utils import errors as J_errors
from liblcg_tpu_torch.utils import errors as L_errors

torch.set_num_threads(1)


@pytest.mark.parametrize("name", [s.name for s in J.Status])
def test_status_codes_match(name):
    assert int(getattr(L.Status, name)) == int(getattr(J.Status, name))
    assert getattr(L.Status, name).is_success == getattr(J.Status, name).is_success


def test_status_sets_and_alias_match():
    assert [s.name for s in L.Status] == [s.name for s in J.Status]
    assert L.Status.ALREADY_OPTIMIZIED is L.Status.ALREADY_OPTIMIZED


@pytest.mark.parametrize("field", [f.name for f in dataclasses.fields(J.SolverParams)])
def test_solver_params_defaults_match(field):
    assert getattr(L.SolverParams(), field) == getattr(J.SolverParams(), field)
    assert getattr(L.DEFAULT_PARAMS, field) == getattr(J.DEFAULT_PARAMS, field)


def test_solver_params_fields_match():
    assert ([f.name for f in dataclasses.fields(L.SolverParams)]
            == [f.name for f in dataclasses.fields(J.SolverParams)])


_PARAM_CASES = [
    {},
    {"max_iterations": -1},
    {"max_iterations": 7},
    {"epsilon": 0.0},
    {"epsilon": 1.0},
    {"epsilon": -1e-3},
    {"restart_epsilon": 0.0},
    {"step": 0.0},
    {"step": -1.0, "epsilon": 0.5},
    {"sigma": 1.0},
    {"sigma": 0.0},
    {"beta": 1.5},
    {"maxi_m": 0},
    {"hard_iteration_cap": 17},
    {"reduce_dtype": "float64"},
]


@pytest.mark.parametrize("method", ["cg", "pcg", "bicgstab2", "pg", "spg", "gmres"])
@pytest.mark.parametrize("kw", _PARAM_CASES, ids=lambda kw: ",".join(kw) or "default")
def test_validate_and_effective_max_iterations_match(method, kw):
    lp, jp = L.SolverParams(**kw), J.SolverParams(**kw)
    le, je = lp.validate(for_method=method), jp.validate(for_method=method)
    assert (le is None) == (je is None)
    if je is not None:
        assert int(le) == int(je)
    assert lp.effective_max_iterations() == jp.effective_max_iterations()


@pytest.mark.parametrize("name", [s.name for s in J.Status])
def test_status_messages_match(name):
    assert (L_errors.status_message(getattr(L.Status, name))
            == J_errors.status_message(getattr(J.Status, name)))


def test_check_status_raises_on_failure_only():
    with pytest.raises(L.LcgError) as info:
        L.check_status(L.Status.NAN_VALUE, raise_error=True, quiet=True)
    assert info.value.status == L.Status.NAN_VALUE
    assert L.check_status(L.Status.STOP, raise_error=True, quiet=True) is L.Status.STOP


def test_solve_result_accessors():
    r = L.SolveResult(x=torch.zeros(3), status_code=torch.tensor(2, dtype=torch.int32),
                      iterations=torch.tensor(0, dtype=torch.int32),
                      residual=torch.tensor(0.0))
    assert r.status is L.Status.ALREADY_OPTIMIZED
    assert r.converged
    assert "ALREADY_OPTIMIZED" in repr(r)
