#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each raising on failure (a failed phase exits non-zero and prints
no result line):
1. the card's name and power limit (nvidia-smi), and the nvcc build of
   every CUDA source of liblcg_tpu_torch;
2. K1 (cg_dia) and K2 (pcg_dia) against their plain PyTorch versions on
   the synthetic 19-diagonal SPD system, n = 10,000, in f32 and f64;
3. the main path at full size: solve() CG and Jacobi-PCG on the 128^3
   7-point Laplacian as a DIA BandedOperator in f64, through the kernels
   (launch counts checked), against pallas="never", the matrix-free
   Laplacian3DOperator and each kernel's plain version, with CUDA-event
   times (median of 3 after one warm-up);
4. one JSON line listing every ported kernel;
5. the last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

GRID = 128              # the repo's headline workload: 128^3 Laplacian
EPS_MAIN = 1e-10
MAX_ITER_MAIN = 2000
N_SMALL = 10_000        # the shape of the reference's case_10K
EPS_SMALL = {"float64": 1e-20, "float32": 1e-10}

# Kernel against plain version: (|delta t|, relative x difference).  The
# kernel sums each dot product per thread over a grid-stride range, then
# across warps, blocks and the block partials in a fixed order, and its
# compiler contracts a*b + c into FMAs; torch.sum and the plain version's
# separate multiply and add round elsewhere.  So iteration counts may move
# by one (f64) or two (f32, as tests/test_pallas_kernel.py allows).
TOL = {"float64": (1, 1e-9), "float32": (2, 1e-4)}
# solve() on the kernel against the plain engine and the matrix-free
# operator, f64 at 128^3.
TOL_MAIN = (1, 1e-8)

REPLACES = {
    "cg_dia": "liblcg_tpu/ops/pallas_cg.py:155",
    "pcg_dia": "liblcg_tpu/ops/pallas_cg.py:269",
}


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


def rel_diff(a, b) -> float:
    return float((a - b).norm() / b.norm())


def cuda_ms(torch, fn, reps: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU: "
                         "torch.cuda.is_available() is False")
    import liblcg_tpu_torch as L
    from liblcg_tpu_torch import _build, _systems
    from liblcg_tpu_torch.ops import cuda_cg
    from liblcg_tpu_torch.solve import kernel_status

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"nvcc build of {_build.sources()}: {time.perf_counter() - t0:.1f} s")
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    kernels = {"cg_dia": cuda_cg.cg_dia, "pcg_dia": cuda_cg.pcg_dia}
    plain = {"cg_dia": cuda_cg.cg_dia_reference,
             "pcg_dia": cuda_cg.pcg_dia_reference}
    max_err = {name: 0.0 for name in kernels}

    def compare(name, args, eps, max_iter, dtype_name, where):
        """Kernel against its plain version on the same inputs."""
        kw = dict(n=args[-1].shape[0], eps=eps, max_iter=max_iter)
        xk, tk, rk = kernels[name](*args, **kw)
        xp, tp, rp = plain[name](*args, **kw)
        torch.cuda.synchronize()
        dt_tol, x_tol = TOL[dtype_name]
        sk, sp = int(kernel_status(tk, rk, eps)), int(kernel_status(tp, rp, eps))
        dx = rel_diff(xk, xp)
        err = float((xk - xp).abs().max())
        max_err[name] = max(max_err[name], err)
        print(f"{name} {dtype_name} {where}: kernel t={int(tk)} res={float(rk):.3e}"
              f" status={L.Status(sk).name}; plain t={int(tp)} res={float(rp):.3e}"
              f"; rel dx={dx:.2e} max|dx|={err:.2e}")
        check(sk == sp, f"{name} {dtype_name} {where}: status {sk} != plain {sp}")
        check(abs(int(tk) - int(tp)) <= dt_tol,
              f"{name} {dtype_name} {where}: t {int(tk)} vs plain {int(tp)}")
        check(bool(torch.isfinite(xk).all()), f"{name}: non-finite x")
        check(dx <= x_tol, f"{name} {dtype_name} {where}: rel dx {dx:.2e} > {x_tol}")

    # -- 2. K1/K2 against their plain versions, n = 10,000 ------------------
    rows, cols, vals, b_np = _systems.banded_spd(N_SMALL)
    for dtype_name in ("float64", "float32"):
        dt = getattr(torch, dtype_name)
        A = L.BandedOperator(N_SMALL, N_SMALL, rows, cols, vals, dtype=dt,
                             device=dev)
        M = L.JacobiPreconditioner(A)
        b = torch.tensor(b_np, dtype=dt, device=dev)
        x0 = torch.zeros_like(b)
        eps = EPS_SMALL[dtype_name]
        kw = dict(n=N_SMALL, eps=eps, max_iter=10000)
        for name, args in (("cg_dia", (A.offsets, A.diag_vals, b, x0)),
                           ("pcg_dia", (A.offsets, A.diag_vals, M.inv_diag, b, x0))):
            compare(name, args, eps, kw["max_iter"], dtype_name, f"n={N_SMALL}")
            k_ms = cuda_ms(torch, lambda: kernels[name](*args, **kw))
            p_ms = cuda_ms(torch, lambda: plain[name](*args, **kw))
            print(f"{name} {dtype_name} n={N_SMALL}: kernel {k_ms:.3f} ms, "
                  f"plain {p_ms:.3f} ms per solve")

    # -- 3. the main path at full size: 128^3 Laplacian, f64 ----------------
    n = GRID ** 3
    offsets, diag_vals = _systems.laplacian3d_dia(GRID, GRID, GRID)
    A = L.banded_from_arrays((n, n), offsets, diag_vals, device=dev)
    del diag_vals
    M = L.JacobiPreconditioner(A)
    b = torch.ones(n, dtype=torch.float64, device=dev)
    params = L.SolverParams(epsilon=EPS_MAIN, max_iterations=MAX_ITER_MAIN)
    print(f"main path: 128^3 Laplacian, n={n}, {A.n_diagonals} diagonals, f64, "
          f"eps={EPS_MAIN}, max_iterations={MAX_ITER_MAIN}")

    for fn in kernels.values():
        fn.launches = 0
    main = {"cg": L.solve(A, b, method="cg", params=params),
            "pcg": L.solve(A, b, method="pcg", M=M, params=params)}
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"launches in the main path: {launches}")
    for name, count in launches.items():
        check(count > 0, f"the main path never launched {name}")

    A_mf = L.Laplacian3DOperator(GRID, GRID, GRID, dtype=torch.float64, device=dev)
    M_mf = L.JacobiPreconditioner(A_mf)
    timing = {}
    for method, res in main.items():
        Mm = M if method == "pcg" else None
        check(res.status == L.Status.CONVERGENCE,
              f"{method}: status {res.status.name}")
        check(tuple(res.x.shape) == (n,) and bool(torch.isfinite(res.x).all()),
              f"{method}: x is not a finite ({n},) vector")
        r_true = b - A_mf.mv(res.x)
        true_metric = float(r_true.dot(r_true) / max(float(res.x.dot(res.x)), 1.0))
        check(true_metric <= 10 * EPS_MAIN,
              f"{method}: true residual metric {true_metric:.3e}")
        others = {
            "pallas=never": L.solve(A, b, method=method, M=Mm, params=params,
                                    pallas="never"),
            "matrix-free": L.solve(A_mf, b, method=method,
                                   M=M_mf if method == "pcg" else None,
                                   params=params),
        }
        for what, o in others.items():
            dx = rel_diff(res.x, o.x)
            print(f"{method}: kernel t={int(res.iterations)} vs {what} "
                  f"t={int(o.iterations)}, rel dx={dx:.2e}")
            check(o.status == res.status, f"{method} vs {what}: status")
            check(abs(int(o.iterations) - int(res.iterations)) <= TOL_MAIN[0],
                  f"{method} vs {what}: iterations")
            check(dx <= TOL_MAIN[1], f"{method} vs {what}: rel dx {dx:.2e}")

        name = f"{method}_dia"
        args = ((A.offsets, A.diag_vals, b, torch.zeros_like(b)) if method == "cg"
                else (A.offsets, A.diag_vals, M.inv_diag, b, torch.zeros_like(b)))
        compare(name, args, EPS_MAIN, MAX_ITER_MAIN, "float64", f"{GRID}^3")
        kw = dict(n=n, eps=EPS_MAIN, max_iter=MAX_ITER_MAIN)
        t_iter = int(res.iterations)
        k_ms = cuda_ms(torch, lambda: kernels[name](*args, **kw))
        p_ms = cuda_ms(torch, lambda: plain[name](*args, **kw))
        s_auto = cuda_ms(torch, lambda: L.solve(A, b, method=method, M=Mm,
                                                params=params))
        s_never = cuda_ms(torch, lambda: L.solve(A, b, method=method, M=Mm,
                                                 params=params, pallas="never"))
        s_mf = cuda_ms(torch, lambda: L.solve(
            A_mf, b, method=method, M=M_mf if method == "pcg" else None,
            params=params))
        timing[name] = (k_ms, p_ms)
        print(f"{method} {GRID}^3 f64, {t_iter} iterations: kernel {k_ms:.2f} ms "
              f"({k_ms / t_iter * 1e3:.1f} us/iteration); plain version "
              f"{p_ms:.2f} ms ({p_ms / t_iter * 1e3:.1f} us/iteration)")
        print(f"{method} {GRID}^3 f64 solve(): pallas=auto {s_auto:.2f} ms, "
              f"pallas=never {s_never:.2f} ms, matrix-free engine {s_mf:.2f} ms")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")

    # -- 4. the kernels line, card line and the result ----------------------
    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "liblcg_tpu_torch/csrc/cg_dia.cu",
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": max_err[name], "ms": timing[name][0],
         "plain_ms": timing[name][1]}
        for name in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
