#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each raising on failure (a failed phase exits non-zero and prints
no result line):
1.  the card's name and power limit (nvidia-smi), and the nvcc build of
    every CUDA source of liblcg_tpu_torch;
2.  K1 (cg_dia) and K2 (pcg_dia) against their plain PyTorch versions on
    the synthetic 19-diagonal SPD system, n = 10,000, in f32 and f64;
2b. K3 (cg_dia_batched) and K4 (pcg_dia_batched) against their plain
    versions on the same system x 32 right-hand sides that are not
    scalings of one another (one of them zero), in f32 and f64, each
    timed also on the largest co-resident grid (one row per thread) to
    show what the batched grid cap buys;
3.  the single-RHS main path at full size: solve() CG and Jacobi-PCG on
    the 128^3 7-point Laplacian as a DIA BandedOperator in f64, through
    K1/K2 (launch counts checked), against pallas="never", the matrix-free
    Laplacian3DOperator and each kernel's plain version;
3b. the multi-RHS main path at full size: solve_batched() CG and
    Jacobi-PCG on the same operator x 16 right-hand sides, through K3/K4
    (launch counts checked), per system against pallas="never", the
    matrix-free operator, K1/K2 on single rows and the plain versions,
    and timed through solve_batched() beside the bare kernel call;
4.  solve_sequence(): a warm-started chain of 3 steps on the same
    operator against three solve(pallas="never") calls chained by hand;
5.  one JSON line listing every ported kernel, then the last line:
    {"ok": true, "device": {...}}.
Times are CUDA-event medians of 3 runs after one warm-up.
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
NRHS_MAIN = 16          # right-hand sides of the multi-RHS main path
N_SMALL = 10_000        # the shape of the reference's case_10K
NRHS_SMALL = 32         # as liblcg_tpu/bench.py's batched workloads
EPS_SMALL = {"float64": 1e-20, "float32": 1e-10}
SEQ_STEPS = 3

# Kernel against plain version: (|delta t|, relative x difference).  The
# kernel sums each dot product per thread over a grid-stride range, then
# across warps, blocks and the block partials in a fixed order, and its
# compiler contracts a*b + c into FMAs; torch.sum and the plain version's
# separate multiply and add round elsewhere.  So iteration counts may move
# by one (f64) or two (f32, as tests/test_pallas_kernel.py allows).
TOL = {"float64": (1, 1e-9), "float32": (2, 1e-4)}
# solve()/solve_batched() on the kernel against the plain engine and the
# matrix-free operator, f64 at 128^3, per system.
TOL_MAIN = (1, 1e-8)

KERNELS = {  # name -> (the TPU kernel it replaces, its CUDA source)
    "cg_dia": ("liblcg_tpu/ops/pallas_cg.py:155",
               "liblcg_tpu_torch/csrc/cg_dia.cu"),
    "pcg_dia": ("liblcg_tpu/ops/pallas_cg.py:269",
                "liblcg_tpu_torch/csrc/cg_dia.cu"),
    "cg_dia_batched": ("liblcg_tpu/ops/pallas_cg.py:424",
                       "liblcg_tpu_torch/csrc/cg_dia.cu"),
    "pcg_dia_batched": ("liblcg_tpu/ops/pallas_cg.py:1155",
                        "liblcg_tpu_torch/csrc/cg_dia.cu"),
}


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


def rel_rows(a, b):
    """Relative difference ||a - b|| / ||b|| of each row of (nrhs, n)
    stacks, or of two vectors; a zero row of ``b`` gives ||a - b||."""
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    num, den = (a - b).norm(dim=1), b.norm(dim=1)
    return [float(x) for x in (num / den.where(den > 0, 1.0)).cpu()]


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


def idle(kernel_ms: float, call_ms: float) -> str:
    """The entry point's time over the bare kernel's, both CUDA-event
    windows on the stream: the host work of the call shows as device time
    outside the kernel, so ``1 - kernel / call`` bounds the device's idle
    share in the call from above (the call's own small device ops count
    as idle)."""
    return (f"host overhead {call_ms - kernel_ms:.3f} ms, device idle share "
            f"<= {max(0.0, 1.0 - kernel_ms / call_ms):.2%}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU: "
                         "torch.cuda.is_available() is False")
    import liblcg_tpu_torch as L
    from liblcg_tpu_torch import _build, _systems
    from liblcg_tpu_torch.ops import cuda_cg
    from liblcg_tpu_torch.solve import kernel_status

    wall0 = time.perf_counter()
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
    grids = [cuda_cg._max_grid(kid, 0) for kid in range(8)]
    print(f"co-resident grid (blocks) per kernel id (cg f32, cg f64, pcg f32, "
          f"pcg f64; the same batched): {grids}")

    kernels = {name: getattr(cuda_cg, name) for name in KERNELS}
    plain = {name: getattr(cuda_cg, f"{name}_reference") for name in KERNELS}
    max_err = {name: 0.0 for name in KERNELS}
    launches, timing = {}, {}

    def compare(name, args, kw, dtype_name, where):
        """Kernel against its plain version on the same inputs, per system."""
        xk, tk, rk = kernels[name](*args, **kw)
        xp, tp, rp = plain[name](*args, **kw)
        torch.cuda.synchronize()
        dt_tol, x_tol = TOL[dtype_name]
        eps = kw["eps"]
        sk = kernel_status(tk, rk, eps).reshape(-1).tolist()
        sp = kernel_status(tp, rp, eps).reshape(-1).tolist()
        tk, tp = tk.reshape(-1).tolist(), tp.reshape(-1).tolist()
        dx = rel_rows(xk, xp)
        err = float((xk - xp).abs().max())
        max_err[name] = max(max_err[name], err)
        print(f"{name} {dtype_name} {where}: kernel t={tk} status="
              f"{[L.Status(s).name for s in sorted(set(sk))]}; plain t={tp}; "
              f"max rel dx={max(dx):.2e} max|dx|={err:.2e}")
        check(sk == sp, f"{name} {dtype_name} {where}: status {sk} != plain {sp}")
        check(all(abs(a - b) <= dt_tol for a, b in zip(tk, tp)),
              f"{name} {dtype_name} {where}: t {tk} vs plain {tp}")
        check(bool(torch.isfinite(xk).all()), f"{name}: non-finite x")
        check(max(dx) <= x_tol, f"{name} {dtype_name} {where}: rel dx {max(dx):.2e}")
        return tk

    # -- 2 and 2b. K1-K4 against their plain versions, n = 10,000 -----------
    rows, cols, vals, b_np = _systems.banded_spd(N_SMALL)
    B_np = _systems.rhs_stack(N_SMALL, NRHS_SMALL, seed=1)
    for dtype_name in ("float64", "float32"):
        dt = getattr(torch, dtype_name)
        A = L.BandedOperator(N_SMALL, N_SMALL, rows, cols, vals, dtype=dt,
                             device=dev)
        M = L.JacobiPreconditioner(A)
        b = torch.tensor(b_np, dtype=dt, device=dev)
        B = torch.tensor(B_np, dtype=dt, device=dev)
        eps = EPS_SMALL[dtype_name]
        single = dict(n=N_SMALL, eps=eps, max_iter=10000)
        stack = dict(single, nrhs=NRHS_SMALL)
        cases = (
            ("cg_dia", (A.offsets, A.diag_vals, b, torch.zeros_like(b)), single),
            ("pcg_dia", (A.offsets, A.diag_vals, M.inv_diag, b,
                         torch.zeros_like(b)), single),
            ("cg_dia_batched", (A.offsets, A.diag_vals, B, torch.zeros_like(B)),
             stack),
            ("pcg_dia_batched", (A.offsets, A.diag_vals, M.inv_diag, B,
                                 torch.zeros_like(B)), stack),
        )
        for name, args, kw in cases:
            where = f"n={N_SMALL}" + (f" x{NRHS_SMALL}" if "nrhs" in kw else "")
            t = compare(name, args, kw, dtype_name, where)
            k_ms = cuda_ms(torch, lambda: kernels[name](*args, **kw))
            p_ms = cuda_ms(torch, lambda: plain[name](*args, **kw))
            per = ""
            if "nrhs" in kw:
                cap = cuda_cg._ROWS_PER_THREAD
                cuda_cg._ROWS_PER_THREAD = 1
                try:
                    full_ms = cuda_ms(torch, lambda: kernels[name](*args, **kw))
                finally:
                    cuda_cg._ROWS_PER_THREAD = cap
                per = (f"; {k_ms / NRHS_SMALL * 1e3:.1f} / "
                       f"{p_ms / NRHS_SMALL * 1e3:.1f} us per system-solve, "
                       f"slowest system {max(t)} iterations; grid capped at "
                       f"{cap} rows per thread {k_ms:.3f} ms, on the largest "
                       f"co-resident grid {full_ms:.3f} ms")
            print(f"{name} {dtype_name} {where}: kernel {k_ms:.3f} ms, "
                  f"plain {p_ms:.3f} ms per solve{per}")

    # -- 3. the single-RHS main path at full size: 128^3 Laplacian, f64 -----
    n = GRID ** 3
    offsets, diag_vals = _systems.laplacian3d_dia(GRID, GRID, GRID)
    A = L.banded_from_arrays((n, n), offsets, diag_vals, device=dev)
    del diag_vals
    M = L.JacobiPreconditioner(A)
    A_mf = L.Laplacian3DOperator(GRID, GRID, GRID, dtype=torch.float64, device=dev)
    M_mf = L.JacobiPreconditioner(A_mf)
    b = torch.ones(n, dtype=torch.float64, device=dev)
    params = L.SolverParams(epsilon=EPS_MAIN, max_iterations=MAX_ITER_MAIN)
    print(f"main path: 128^3 Laplacian, n={n}, {A.n_diagonals} diagonals, f64, "
          f"eps={EPS_MAIN}, max_iterations={MAX_ITER_MAIN}")

    def true_metric(X, B):
        """||b - A x||^2 / max(||x||^2, 1) per system, on the matrix-free A."""
        R = B - A_mf.mv(X)
        xx = (X * X).sum(-1).clamp(min=1.0)
        return [float(v) for v in ((R * R).sum(-1) / xx).reshape(-1).cpu()]

    def hold(res, others, what_of, method):
        """Per system: same status, |dt| <= 1, rel dx <= 1e-8."""
        for what, o in others.items():
            st, so = res.status_code.reshape(-1).tolist(), o.status_code.reshape(-1).tolist()
            tt, to = res.iterations.reshape(-1).tolist(), o.iterations.reshape(-1).tolist()
            dx = rel_rows(res.x, o.x)
            print(f"{method}{what_of}: kernel t={tt} vs {what} t={to}, "
                  f"max rel dx={max(dx):.2e}")
            check(st == so, f"{method} vs {what}: status {st} vs {so}")
            check(all(abs(a - c) <= TOL_MAIN[0] for a, c in zip(tt, to)),
                  f"{method} vs {what}: iterations")
            check(max(dx) <= TOL_MAIN[1], f"{method} vs {what}: rel dx {max(dx):.2e}")

    single_names = ("cg_dia", "pcg_dia")
    for name in single_names:
        kernels[name].launches = 0
    main = {"cg": L.solve(A, b, method="cg", params=params),
            "pcg": L.solve(A, b, method="pcg", M=M, params=params)}
    torch.cuda.synchronize()
    launches.update({name: kernels[name].launches for name in single_names})
    print(f"launches in the single-RHS main path: "
          f"{ {k: launches[k] for k in single_names} }")
    for name in single_names:
        check(launches[name] > 0, f"the main path never launched {name}")

    for method, res in main.items():
        Mm, Mmf = (M, M_mf) if method == "pcg" else (None, None)
        check(res.status == L.Status.CONVERGENCE, f"{method}: status {res.status.name}")
        check(tuple(res.x.shape) == (n,) and bool(torch.isfinite(res.x).all()),
              f"{method}: x is not a finite ({n},) vector")
        check(true_metric(res.x, b)[0] <= 10 * EPS_MAIN,
              f"{method}: true residual metric {true_metric(res.x, b)}")
        hold(res, {"pallas=never": L.solve(A, b, method=method, M=Mm, params=params,
                                           pallas="never"),
                   "matrix-free": L.solve(A_mf, b, method=method, M=Mmf,
                                          params=params)}, "", method)
        name = f"{method}_dia"
        args = ((A.offsets, A.diag_vals, b, torch.zeros_like(b)) if method == "cg"
                else (A.offsets, A.diag_vals, M.inv_diag, b, torch.zeros_like(b)))
        kw = dict(n=n, eps=EPS_MAIN, max_iter=MAX_ITER_MAIN)
        compare(name, args, kw, "float64", f"{GRID}^3")
        t_iter = int(res.iterations)
        k_ms = cuda_ms(torch, lambda: kernels[name](*args, **kw))
        p_ms = cuda_ms(torch, lambda: plain[name](*args, **kw))
        s_auto = cuda_ms(torch, lambda: L.solve(A, b, method=method, M=Mm,
                                                params=params))
        s_never = cuda_ms(torch, lambda: L.solve(A, b, method=method, M=Mm,
                                                 params=params, pallas="never"))
        s_mf = cuda_ms(torch, lambda: L.solve(A_mf, b, method=method, M=Mmf,
                                              params=params))
        timing[name] = (k_ms, p_ms)
        print(f"{method} {GRID}^3 f64, {t_iter} iterations: kernel {k_ms:.2f} ms "
              f"({k_ms / t_iter * 1e3:.1f} us/iteration); plain version "
              f"{p_ms:.2f} ms ({p_ms / t_iter * 1e3:.1f} us/iteration); solve() "
              f"pallas=auto {s_auto:.2f} ms ({idle(k_ms, s_auto)}), "
              f"pallas=never {s_never:.2f} ms, matrix-free engine {s_mf:.2f} ms")

    # -- 3b. the multi-RHS main path at full size: 128^3 x 16, f64 ----------
    B = torch.tensor(_systems.rhs_stack(n, NRHS_MAIN, seed=2), device=dev)
    zero_row = 1
    print(f"multi-RHS main path: 128^3 Laplacian x {NRHS_MAIN} right-hand sides "
          f"(ones, a zero row, {NRHS_MAIN - 2} uniform rows), f64")
    torch.cuda.reset_peak_memory_stats()
    batched_names = ("cg_dia_batched", "pcg_dia_batched")
    for name in batched_names:
        kernels[name].launches = 0
    main_b = {"cg": L.solve_batched(A, B, method="cg", params=params),
              "pcg": L.solve_batched(A, B, method="pcg", M=M, params=params)}
    torch.cuda.synchronize()
    launches.update({name: kernels[name].launches for name in batched_names})
    print(f"launches in the multi-RHS main path: "
          f"{ {k: launches[k] for k in batched_names} }")
    for name in batched_names:
        check(launches[name] > 0, f"the main path never launched {name}")

    for method, res in main_b.items():
        Mm, Mmf = (M, M_mf) if method == "pcg" else (None, None)
        status = [L.Status(s) for s in res.status_code.tolist()]
        t = res.iterations.tolist()
        check(tuple(res.x.shape) == (NRHS_MAIN, n) and bool(torch.isfinite(res.x).all()),
              f"{method}: X is not a finite ({NRHS_MAIN}, {n}) stack")
        check(status[zero_row] == L.Status.ALREADY_OPTIMIZED and t[zero_row] == 0,
              f"{method}: zero row {status[zero_row].name} at t={t[zero_row]}")
        check(all(s == L.Status.CONVERGENCE for r, s in enumerate(status)
                  if r != zero_row), f"{method}: statuses {status}")
        metric = true_metric(res.x, B)
        print(f"{method} x{NRHS_MAIN}: iterations {t}, largest true residual "
              f"metric {max(metric):.3e}")
        check(max(metric) <= 10 * EPS_MAIN, f"{method}: true residual metric {metric}")
        hold(res, {"pallas=never": L.solve_batched(A, B, method=method, M=Mm,
                                                   params=params, pallas="never"),
                   "matrix-free": L.solve_batched(A_mf, B, method=method, M=Mmf,
                                                  params=params)},
             f" x{NRHS_MAIN}", method)
        for r in (0, NRHS_MAIN - 1):   # the batched kernel equals the single one
            one = L.solve(A, B[r], method=method, M=Mm, params=params)
            print(f"{method} row {r}: {method}_dia t={int(one.iterations)}, "
                  f"{method}_dia_batched t={t[r]}")
            check(abs(int(one.iterations) - t[r]) <= TOL_MAIN[0],
                  f"{method} row {r}: single kernel t={int(one.iterations)} vs {t[r]}")
        name = f"{method}_dia_batched"
        args = ((A.offsets, A.diag_vals, B, torch.zeros_like(B)) if method == "cg"
                else (A.offsets, A.diag_vals, M.inv_diag, B, torch.zeros_like(B)))
        kw = dict(n=n, nrhs=NRHS_MAIN, eps=EPS_MAIN, max_iter=MAX_ITER_MAIN)
        compare(name, args, kw, "float64", f"{GRID}^3 x{NRHS_MAIN}")
        k_ms = cuda_ms(torch, lambda: kernels[name](*args, **kw))
        p_ms = cuda_ms(torch, lambda: plain[name](*args, **kw))
        s_auto = cuda_ms(torch, lambda: L.solve_batched(
            A, B, method=method, M=Mm, params=params))
        s_never = cuda_ms(torch, lambda: L.solve_batched(
            A, B, method=method, M=Mm, params=params, pallas="never"))
        timing[name] = (k_ms, p_ms)
        print(f"{method} {GRID}^3 x{NRHS_MAIN} f64, slowest system {max(t)} "
              f"iterations: kernel {k_ms:.2f} ms per stack, "
              f"{k_ms / NRHS_MAIN:.2f} ms per system-solve, "
              f"{k_ms / max(t) * 1e3:.1f} us per iteration of the slowest system; "
              f"plain version {p_ms:.2f} ms; solve_batched pallas=auto "
              f"{s_auto:.2f} ms ({idle(k_ms, s_auto)}), pallas=never "
              f"{s_never:.2f} ms")
    print(f"peak device memory, multi-RHS phase: "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")

    # -- 4. solve_sequence: a warm-started chain of 3 steps -----------------
    seq = L.solve_sequence(A, b, lambda x, k: x, SEQ_STEPS, params=params)
    x_prev, b_k = torch.zeros_like(b), b
    for k in range(SEQ_STEPS):
        r = L.solve(A, b_k, x_prev, params=params, pallas="never")
        dx = rel_rows(seq.x[k], r.x)[0]
        print(f"solve_sequence step {k}: t={int(seq.iterations[k])} vs chained "
              f"solve() t={int(r.iterations)}, rel dx={dx:.2e}")
        check(int(seq.iterations[k]) == int(r.iterations), f"sequence step {k}: t")
        check(int(seq.status_code[k]) == int(r.status_code), f"sequence step {k}: status")
        check(dx <= TOL_MAIN[1], f"sequence step {k}: rel dx {dx:.2e}")
        x_prev, b_k = r.x, r.x

    # -- 5. the kernels line, card line and the result ----------------------
    print(f"wall time of chip_smoke.py: {time.perf_counter() - wall0:.1f} s")
    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": timing[name][0], "plain_ms": timing[name][1]}
        for name, (replaces, source) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
