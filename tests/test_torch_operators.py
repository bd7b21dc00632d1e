"""The port's operators against liblcg_tpu's on the same seeded inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import liblcg_tpu as J
import liblcg_tpu_torch as L
from liblcg_tpu.ops import dia as J_dia
from liblcg_tpu_torch import _systems
from liblcg_tpu_torch.ops import dia as L_dia

torch.set_num_threads(1)

RTOL = 1e-13  # f64 products; the two packages may fuse multiply-adds differently


def _close(port, ref, rtol=RTOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    assert np.linalg.norm(port - ref) <= rtol * max(np.linalg.norm(ref), 1e-300)


def _coo_with_duplicates(n_rows, n_cols, seed):
    rng = np.random.default_rng(seed)
    offs = rng.choice(np.arange(-5, 6), size=5, replace=False)
    rows, cols = [], []
    for o in offs:
        i = np.arange(max(0, -o), min(n_rows, n_cols - o))
        rows.append(i)
        cols.append(i + o)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    dup = rng.choice(len(rows), size=len(rows) // 4, replace=False)
    rows = np.concatenate([rows, rows[dup]])
    cols = np.concatenate([cols, cols[dup]])
    vals = rng.uniform(-1.0, 1.0, len(rows))
    return rows, cols, vals


@pytest.mark.parametrize("shape", [(40, 40), (40, 33), (33, 40)])
def test_coo_to_dia_matches_exactly(shape):
    rows, cols, vals = _coo_with_duplicates(*shape, seed=sum(shape))
    lo, lv = L_dia.coo_to_dia(*shape, rows, cols, vals)
    jo, jv = J_dia.coo_to_dia(*shape, rows, cols, vals)
    np.testing.assert_array_equal(lo, jo)
    np.testing.assert_array_equal(lv, jv)


@pytest.mark.parametrize("shape", [(50, 50), (50, 37), (37, 50)])
@pytest.mark.parametrize("op", ["mv", "rmv", "cmv", "hmv"])
def test_banded_products_match(shape, op):
    rows, cols, vals = _coo_with_duplicates(*shape, seed=3)
    LA = L.BandedOperator(*shape, rows, cols, vals)
    JA = J.BandedOperator(*shape, rows, cols, vals)
    m = shape[1] if op in ("mv", "cmv") else shape[0]
    x = np.random.default_rng(5).uniform(-1.0, 1.0, m)
    _close(getattr(LA, op)(torch.from_numpy(x)), getattr(JA, op)(jnp.asarray(x)))


def test_banded_structure_matches():
    rows, cols, vals, _ = _systems.banded_spd(1200)
    LA = L.BandedOperator(1200, 1200, rows, cols, vals)
    JA = J.BandedOperator(1200, 1200, rows, cols, vals)
    assert LA.offsets == JA.offsets
    assert LA.n_diagonals == JA.n_diagonals == 19
    assert LA.nnz == JA.nnz
    _close(LA.diagonal(), JA.diagonal(), rtol=0.0)
    A32 = LA.astype("float32")
    assert A32.dtype == torch.float32 and A32.offsets == LA.offsets
    np.testing.assert_array_equal(A32.diag_vals.numpy(),
                                  np.asarray(JA.astype(jnp.float32).diag_vals))


def test_banded_without_main_diagonal_has_zero_diagonal():
    rows = np.arange(9)
    LA = L.BandedOperator(10, 10, rows, rows + 1, np.ones(9))
    JA = J.BandedOperator(10, 10, rows, rows + 1, np.ones(9))
    _close(LA.diagonal(), JA.diagonal(), rtol=0.0)


@pytest.mark.parametrize("op", ["mv", "rmv"])
def test_dense_products_match(op):
    A, _ = _systems.spd_dense(60)
    A = A + np.triu(np.random.default_rng(2).uniform(-1, 1, A.shape), 1)
    x = np.random.default_rng(3).uniform(-1.0, 1.0, 60)
    _close(getattr(L.DenseOperator(A), op)(torch.from_numpy(x)),
           getattr(J.DenseOperator(A), op)(jnp.asarray(x)))
    _close(L.DenseOperator(A).diagonal(), J.DenseOperator(A).diagonal(), rtol=0.0)


@pytest.mark.parametrize("grid", [(4, 5, 6), (3, 3, 3), (8, 2, 5)])
def test_laplacian_matches_jax_and_its_dia_form(grid):
    nz, ny, nx = grid
    n = nz * ny * nx
    x = np.random.default_rng(n).uniform(-1.0, 1.0, n)
    LA = L.Laplacian3DOperator(nz, ny, nx, dtype=torch.float64)
    JA = J.Laplacian3DOperator(nz, ny, nx, dtype=jnp.float64)
    _close(LA.mv(torch.from_numpy(x)), JA.mv(jnp.asarray(x)))
    _close(LA.rmv(torch.from_numpy(x)), JA.rmv(jnp.asarray(x)))
    _close(LA.diagonal(), JA.diagonal(), rtol=0.0)
    assert LA.nnz == JA.nnz
    offsets, diag_vals = _systems.laplacian3d_dia(nz, ny, nx)
    D = L.banded_from_arrays((n, n), offsets, diag_vals, device="cpu")
    _close(D.mv(torch.from_numpy(x)), JA.mv(jnp.asarray(x)))
    assert D.nnz == LA.nnz


def _patterns():
    n = 200
    i = np.arange(n)
    rng = np.random.default_rng(11)
    tri = (np.concatenate([i, i[:-1], i[1:]]), np.concatenate([i, i[1:], i[:-1]]))
    scat_r = rng.integers(0, n, 6)
    scat_c = (scat_r + rng.integers(5, 100, 6)) % n
    wide_r = rng.integers(0, n, 600)
    wide_c = rng.integers(0, n, 600)
    hole = i[i != 17]
    return {
        "tridiagonal": tri,
        "diag_plus_scattered": (np.concatenate([i, scat_r]),
                                np.concatenate([i, scat_c])),
        "scattered_with_missing_diagonal_entry": (np.concatenate([hole, scat_r]),
                                                  np.concatenate([hole, scat_c])),
        "random_wide": (wide_r, wide_c),
        "random_wide_plus_diag": (np.concatenate([i, wide_r]),
                                  np.concatenate([i, wide_c])),
    }


_PATTERNS = _patterns()


@pytest.mark.parametrize("fmt", ["auto", "dia", "ell", "scattered"])
@pytest.mark.parametrize("pattern", sorted(_PATTERNS))
def test_make_sparse_operator_picks_dia_where_jax_does(pattern, fmt):
    rows, cols = _PATTERNS[pattern]
    n = 200
    vals = np.random.default_rng(1).uniform(0.5, 1.0, len(rows))
    try:
        JA = J.make_sparse_operator(n, n, rows, cols, vals, format=fmt)
    except ValueError:
        with pytest.raises(ValueError):
            L.make_sparse_operator(n, n, rows, cols, vals, format=fmt)
        return
    if isinstance(JA, J.BandedOperator):
        LA = L.make_sparse_operator(n, n, rows, cols, vals, format=fmt)
        assert isinstance(LA, L.BandedOperator)
        assert LA.offsets == JA.offsets
        np.testing.assert_array_equal(LA.diag_vals.numpy(), np.asarray(JA.diag_vals))
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            L.make_sparse_operator(n, n, rows, cols, vals, format=fmt)


def test_make_sparse_operator_rejects_unknown_format():
    with pytest.raises(ValueError, match="unknown sparse format"):
        L.make_sparse_operator(3, 3, [0], [0], [1.0], format="csr")


def test_banded_from_arrays_round_trips():
    rows, cols, vals, _ = _systems.banded_spd(300, seed=4)
    JA = J.BandedOperator(300, 300, rows, cols, vals)
    LA = L.banded_from_arrays(JA.shape, JA.offsets, np.asarray(JA.diag_vals),
                              device="cpu")
    assert LA.shape == JA.shape and LA.offsets == JA.offsets
    np.testing.assert_array_equal(LA.diag_vals.numpy(), np.asarray(JA.diag_vals))
    x = np.random.default_rng(6).uniform(-1.0, 1.0, 300)
    _close(LA.mv(torch.from_numpy(x)), JA.mv(jnp.asarray(x)))
    back = L.banded_from_arrays(LA.shape, LA.offsets, LA.diag_vals.numpy(),
                                device="cpu")
    np.testing.assert_array_equal(back.diag_vals.numpy(), LA.diag_vals.numpy())


def test_banded_from_arrays_checks_its_input():
    with pytest.raises(ValueError, match="sorted"):
        L.banded_from_arrays((4, 4), [1, 0], np.zeros((2, 4)), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        L.banded_from_arrays((4, 4), [0, 1], np.zeros((2, 5)), device="cpu")


def test_jacobi_from_arrays_keeps_inv_diag_exactly():
    rows, cols, vals, _ = _systems.banded_spd(300, seed=4)
    JM = J.JacobiPreconditioner(J.BandedOperator(300, 300, rows, cols, vals))
    LM = L.jacobi_from_arrays(np.asarray(JM.inv_diag), device="cpu")
    np.testing.assert_array_equal(LM.inv_diag.numpy(), np.asarray(JM.inv_diag))
    LM2 = L.JacobiPreconditioner(L.BandedOperator(300, 300, rows, cols, vals))
    np.testing.assert_array_equal(LM2.inv_diag.numpy(), np.asarray(JM.inv_diag))
    with pytest.raises(ValueError, match="1-D"):
        L.jacobi_from_arrays(np.ones((2, 2)), device="cpu")


def test_matrix_free_transpose_is_the_vjp():
    A = np.random.default_rng(8).uniform(-1, 1, (30, 20))
    At = torch.from_numpy(A)
    op = L.MatrixFreeOperator(lambda x: At @ x, 20, m=30, dtype=torch.float64)
    y = torch.from_numpy(np.random.default_rng(9).uniform(-1, 1, 30))
    _close(op.rmv(y), A.T @ y.numpy())
    x = torch.from_numpy(np.random.default_rng(10).uniform(-1, 1, 20))
    _close(op.mv(x), A @ x.numpy())
    with pytest.raises(NotImplementedError):
        op.diagonal()


def test_aslinearoperator_coerces_like_jax():
    A, _ = _systems.spd_dense(10)
    assert isinstance(L.aslinearoperator(A), L.DenseOperator)
    assert isinstance(L.aslinearoperator(torch.from_numpy(A)), L.DenseOperator)
    op = L.aslinearoperator(lambda x: 2 * x, n=10, dtype=torch.float64)
    assert isinstance(op, L.MatrixFreeOperator) and op.shape == (10, 10)
    with pytest.raises(ValueError, match="requires n="):
        L.aslinearoperator(lambda x: x)
    with pytest.raises(ValueError, match="2-D"):
        L.aslinearoperator(np.ones(3))
