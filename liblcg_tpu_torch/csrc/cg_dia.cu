// Whole-solve CG and Jacobi-PCG on a DIA matrix, for one right-hand side
// or an (nrhs, n) stack of them: one cooperative launch runs the entire
// iteration loop on the card, with no host round trip.
//
// Replaces the TPU kernels of liblcg_tpu/ops/pallas_cg.py:
//   cg_dia_kernel                <- _cg_kernel  (pallas_cg_dia)                  K1
//   pcg_dia_kernel               <- _pcg_kernel (pallas_pcg_dia)                 K2
//   batched_kernel<T, false>     <- _cg_kernel_batched  (pallas_cg_dia_batched)  K3
//   batched_kernel<T, true>      <- _pcg_kernel_batched (pallas_pcg_dia_batched) K4
// They compute what the Pallas kernels compute: the same recurrences (CG
// on the gradient g = Ax - b, PCG in Kaasschieter's form with inv_diag),
// the same stopping rule (continue while metric > eps && t < max_iter,
// metric = ||r||^2 / max(||x||^2, 1) or sqrt(||r||^2) / n) and the same
// outputs (x, t, metric).  Hopper has native f64, so every kernel is
// templated on float and double.
//
// Design.  One persistent cooperative grid, every block co-resident (the
// wrapper sizes the grid from the occupancy query times the SM count, and
// cudaLaunchCooperativeKernel refuses a larger one).  The DIA product is
//   y[i] = sum_d vals[d*n + i] * v[i + off[d]]
// over the offsets in sorted order, read from a shared-memory table, with
// a bounds test where the TPU kernel read a zero-padded image.
//
// Reductions across blocks: each block writes its partial sums to a
// scratch array, the grid syncs, and then EVERY block sums all partials in
// the same fixed order in the working type.  All blocks therefore hold
// bit-identical alpha, beta and metric, take the same loop exit, and the
// result is the same from run to run.  (Float atomics would give each
// block its own rounding; a block leaving the loop early would leave the
// others waiting at a grid sync forever.)  Partials alternate between two
// halves of the scratch, because a fast block may write the next partial
// before a slow one has read the last.  An iteration has three grid syncs
// (two reductions, and one before the next product reads d).
//
// K1/K2 use grid-stride loops over the rows, so any n works.  K3/K4 run
// the stack in lockstep while any system is alive (alive_r = metric_r >
// eps && t_r < max_iter), with the zero guards of the Pallas kernels
// (dTAd == 0, gmod == 0, zTr == 0 divide by 1); a finished system is
// frozen exactly: its x, g (or r), d, scalars and t are not written again.
// - Work items are (system, tile of 32 rows).  Each warp takes one system
//   and strides over its tiles, keeping its per-system sums in registers;
//   the warps of neighbouring ids take neighbouring systems at the same
//   tiles, so a tile of the diagonals is read from device memory once per
//   sweep and served to the other systems from L1/L2.  Only the systems
//   still alive get work items (a list every block builds identically).
// - Every warp adds its sums to its own shared-memory slot per system,
//   each block writes one partial per (sum, system), and after the grid
//   sync every block adds all partials of every (sum, system) in the same
//   fixed order.  All systems are reduced at one sync point, so the three
//   grid syncs per iteration do not grow with nrhs.
// - The stack is indexed with a 64-bit row base ((size_t)r * n + i), so
//   nrhs * n may pass 2^31; the row index i stays a 32-bit int.
//
// What bounds it on an H100.  Per CG iteration K1 streams about 18
// n-length vectors (SpMV: D diagonals + d + the A d write; x, g, d, A d
// update: 6; direction update: 3), 20 for PCG.  At 128^3 in f64 (n = 2.1M,
// D = 7) that is ~300 MB per iteration against 3.35 TB/s, part of which
// the 50 MB L2 catches between phases: memory bandwidth bounds it.  K3
// streams about 11 per alive system (SpMV: d + the A d write; d . Ad: d
// again; x, g, d, A d read and x, g written; direction update: d, g read,
// d written) plus the D diagonals once for the whole stack; K4 adds
// inv_diag twice.  At n = 10,000 everything sits in L2 and the grid syncs
// and the cross-block sums (K x nrhs x grid partials read in every block)
// set the pace.  A fused SpMV+dot pipeline, TMA loads and CUDA graphs are
// later work; these kernels are the simple, right ones.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxDiags = 256;   // the shared-memory offset table
constexpr int kMaxSums = 3;      // sums per system reduced at one sync point
constexpr int kMaxRhs = 64;      // K3/K4 keep per-system scalars in shared memory

struct DiaOffsets {
  int count;
  int off[kMaxDiags];
};

// sum_d vals[d*n + i] * v[i + off[d]] over the sorted offsets, with a
// bounds test where the TPU kernels read a zero-padded image.
template <typename T>
__device__ __forceinline__ T dia_row(const int* s_off, int nd,
                                     const T* __restrict__ vals, const T* v,
                                     int n, int i) {
  T acc = T(0);
  for (int d = 0; d < nd; ++d) {
    const int j = i + s_off[d];
    if (j >= 0 && j < n) acc += vals[(size_t)d * n + i] * v[j];
  }
  return acc;
}

// ||r||^2 / max(||x||^2, 1) (xmod arrives clamped) or sqrt(||r||^2) / n.
template <typename T>
__device__ __forceinline__ T metric(T rmod, T xmod, int n, int abs_diff) {
  return abs_diff ? sqrt(rmod) / T(n) : rmod / xmod;
}

__device__ __forceinline__ void load_offsets(const DiaOffsets& offs, int* s_off) {
  for (int k = threadIdx.x; k < offs.count; k += kBlock) s_off[k] = offs.off[k];
  __syncthreads();
}

// ---- K1, K2: one right-hand side ---------------------------------------

// Sums K per-thread values over the block; thread 0 gets the result.
template <typename T, int K>
__device__ __forceinline__ void block_sum(T (&v)[K], T* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int o = 16; o > 0; o >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) s_red[k * kWarps + warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T s = lane < kWarps ? s_red[k * kWarps + lane] : T(0);
      for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
      v[k] = s;
    }
  }
  __syncthreads();
}

// Grid-wide sum of K per-thread values, identical in every block.  The
// partials of reduction number `round` go to half (round & 1) of `part`
// (2 * kMaxSums * gridDim.x entries).
template <typename T, int K>
__device__ void grid_sum(T (&v)[K], T* part, int round, cg::grid_group& grid,
                         T* s_red, T* s_tot) {
  const int G = gridDim.x;
  T* half = part + (size_t)(round & 1) * kMaxSums * G;
  block_sum<T, K>(v, s_red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) half[k * G + blockIdx.x] = v[k];
  }
  grid.sync();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T s = T(0);
    for (int j = threadIdx.x; j < G; j += kBlock) s += __ldcg(&half[k * G + j]);
    v[k] = s;
  }
  block_sum<T, K>(v, s_red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) s_tot[k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = s_tot[k];
}

// K1: CG (pallas_cg.py:_cg_kernel).  x, g, d, ad are n-length work arrays;
// x is the output.
template <typename T>
__global__ void __launch_bounds__(kBlock)
cg_dia_kernel(DiaOffsets offs, const T* __restrict__ vals,
              const T* __restrict__ b, const T* __restrict__ x0,
              T* x, T* g, T* d, T* ad, T* part, int* t_out, T* res_out,
              int n, T eps, int max_iter, int abs_diff) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_off[kMaxDiags];
  __shared__ T s_red[kMaxSums * kWarps];
  __shared__ T s_tot[kMaxSums];
  load_offsets(offs, s_off);
  const int nd = offs.count;
  const int stride = gridDim.x * kBlock;
  const int i0 = blockIdx.x * kBlock + threadIdx.x;
  int round = 0;

  // g0 = A x0 - b, d0 = -g0 (lcg.cpp:171-183).
  T s0[2] = {T(0), T(0)};
  for (int i = i0; i < n; i += stride) {
    const T xi = x0[i];
    const T gi = dia_row(s_off, nd, vals, x0, n, i) - b[i];
    x[i] = xi;
    g[i] = gi;
    d[i] = -gi;
    s0[0] += gi * gi;
    s0[1] += xi * xi;
  }
  grid_sum<T, 2>(s0, part, round++, grid, s_red, s_tot);
  T gmod = s0[0];
  T xmod = s0[1] > T(1) ? s0[1] : T(1);
  int t = 0;

  while (metric(gmod, xmod, n, abs_diff) > eps && t < max_iter) {
    T s1[1] = {T(0)};
    for (int i = i0; i < n; i += stride) {
      const T adi = dia_row(s_off, nd, vals, d, n, i);
      ad[i] = adi;
      s1[0] += d[i] * adi;
    }
    grid_sum<T, 1>(s1, part, round++, grid, s_red, s_tot);
    const T ak = gmod / s1[0];

    T s2[2] = {T(0), T(0)};
    for (int i = i0; i < n; i += stride) {
      const T xi = x[i] + ak * d[i];
      const T gi = g[i] + ak * ad[i];
      x[i] = xi;
      g[i] = gi;
      s2[0] += gi * gi;
      s2[1] += xi * xi;
    }
    grid_sum<T, 2>(s2, part, round++, grid, s_red, s_tot);
    const T betak = s2[0] / gmod;

    for (int i = i0; i < n; i += stride) d[i] = betak * d[i] - g[i];
    grid.sync();  // the next product reads neighbours' d
    gmod = s2[0];
    xmod = s2[1] > T(1) ? s2[1] : T(1);
    ++t;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *t_out = t;
    *res_out = metric(gmod, xmod, n, abs_diff);
  }
}

// K2: Jacobi-PCG (pallas_cg.py:_pcg_kernel).  z = inv_diag * r is
// recomputed where it is needed instead of stored.
template <typename T>
__global__ void __launch_bounds__(kBlock)
pcg_dia_kernel(DiaOffsets offs, const T* __restrict__ vals,
               const T* __restrict__ invd, const T* __restrict__ b,
               const T* __restrict__ x0,
               T* x, T* r, T* d, T* ad, T* part, int* t_out, T* res_out,
               int n, T eps, int max_iter, int abs_diff) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_off[kMaxDiags];
  __shared__ T s_red[kMaxSums * kWarps];
  __shared__ T s_tot[kMaxSums];
  load_offsets(offs, s_off);
  const int nd = offs.count;
  const int stride = gridDim.x * kBlock;
  const int i0 = blockIdx.x * kBlock + threadIdx.x;
  int round = 0;

  // r0 = b - A x0, z0 = inv_diag * r0, d0 = z0.
  T s0[3] = {T(0), T(0), T(0)};
  for (int i = i0; i < n; i += stride) {
    const T xi = x0[i];
    const T ri = b[i] - dia_row(s_off, nd, vals, x0, n, i);
    const T zi = invd[i] * ri;
    x[i] = xi;
    r[i] = ri;
    d[i] = zi;
    s0[0] += zi * ri;
    s0[1] += ri * ri;
    s0[2] += xi * xi;
  }
  grid_sum<T, 3>(s0, part, round++, grid, s_red, s_tot);
  T zTr = s0[0];
  T rmod = s0[1];
  T xmod = s0[2] > T(1) ? s0[2] : T(1);
  int t = 0;

  while (metric(rmod, xmod, n, abs_diff) > eps && t < max_iter) {
    T s1[1] = {T(0)};
    for (int i = i0; i < n; i += stride) {
      const T adi = dia_row(s_off, nd, vals, d, n, i);
      ad[i] = adi;
      s1[0] += d[i] * adi;
    }
    grid_sum<T, 1>(s1, part, round++, grid, s_red, s_tot);
    const T ak = zTr / s1[0];  // lcg.cpp:390

    T s2[3] = {T(0), T(0), T(0)};
    for (int i = i0; i < n; i += stride) {
      const T xi = x[i] + ak * d[i];
      const T ri = r[i] - ak * ad[i];
      const T zi = invd[i] * ri;
      x[i] = xi;
      r[i] = ri;
      s2[0] += zi * ri;
      s2[1] += ri * ri;
      s2[2] += xi * xi;
    }
    grid_sum<T, 3>(s2, part, round++, grid, s_red, s_tot);
    const T betak = s2[0] / zTr;  // lcg.cpp:415

    for (int i = i0; i < n; i += stride) d[i] = invd[i] * r[i] + betak * d[i];
    grid.sync();
    zTr = s2[0];
    rmod = s2[1];
    xmod = s2[2] > T(1) ? s2[2] : T(1);
    ++t;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *t_out = t;
    *res_out = metric(rmod, xmod, n, abs_diff);
  }
}

// ---- K3, K4: an (nrhs, n) stack -----------------------------------------

template <typename T>
struct Shared {
  int off[kMaxDiags];
  T acc[kMaxSums * kMaxRhs * kWarps];   // [k][r][warp] per-warp sums
  T tot[kMaxSums * kMaxRhs];            // [k][r] grid sums
  T rmod[kMaxRhs], xmod[kMaxRhs], ztr[kMaxRhs], ak[kMaxRhs], beta[kMaxRhs];
  int t[kMaxRhs];
  int list[kMaxRhs];                    // the alive systems, ascending
  int count;
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {  // lane 0 gets the sum
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Runs body(r, i, acc) for every row i < n of every system r in
// list[0, cnt), and adds each warp's K per-system sums acc[] to s.acc.
// Each warp handles one system at a time, so acc stays in registers.
template <typename T, int K, typename Body>
__device__ __forceinline__ void sweep(Shared<T>& s, int cnt, int n, Body body) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = gridDim.x * kWarps;
  const int gw = blockIdx.x * kWarps + warp;
  const int ntiles = (n + 31) >> 5;
  const int P = W / cnt > 1 ? W / cnt : 1;  // warps per system
  for (int q = gw; q < P * cnt; q += W) {
    const int r = s.list[q % cnt];
    T acc[K > 0 ? K : 1] = {};
    for (int tile = q / cnt; tile < ntiles; tile += P) {
      const int i = (tile << 5) + lane;
      if (i < n) body(r, i, acc);
    }
    if constexpr (K > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T v = warp_sum(acc[k]);
        if (lane == 0) s.acc[(k * kMaxRhs + r) * kWarps + warp] += v;
      }
    }
  }
}

// Grid-wide sums of the K per-system values the last sweep left in s.acc,
// for the systems of s.list: s.tot[k * kMaxRhs + r], identical in every
// block.  The partials of reduction number `round` go to half (round & 1)
// of `part` (2 * kMaxSums * nrhs * gridDim.x entries).  Clears s.acc.
template <typename T, int K>
__device__ void grid_reduce(Shared<T>& s, int cnt, T* part, int nrhs,
                            int round, cg::grid_group& grid) {
  const int G = gridDim.x;
  T* half = part + (size_t)(round & 1) * kMaxSums * nrhs * G;
  __syncthreads();
  for (int v = threadIdx.x; v < K * cnt; v += kBlock) {
    const int k = v / cnt, r = s.list[v % cnt];
    const T* a = &s.acc[(k * kMaxRhs + r) * kWarps];
    T sum = T(0);
    for (int w = 0; w < kWarps; ++w) sum += a[w];
    half[(size_t)(k * nrhs + r) * G + blockIdx.x] = sum;
  }
  grid.sync();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int v = warp; v < K * cnt; v += kWarps) {
    const int k = v / cnt, r = s.list[v % cnt];
    const T* p = half + (size_t)(k * nrhs + r) * G;
    T sum = T(0);
    for (int j = lane; j < G; j += 32) sum += __ldcg(p + j);
    sum = warp_sum(sum);
    if (lane == 0) s.tot[k * kMaxRhs + r] = sum;
  }
  for (int v = threadIdx.x; v < kMaxSums * kMaxRhs * kWarps; v += kBlock)
    s.acc[v] = T(0);
  __syncthreads();
}

// Thread 0 lists the systems still alive; returns their count to all.
template <typename T>
__device__ int alive_systems(Shared<T>& s, int nrhs, T eps, int max_iter,
                             int n, int abs_diff) {
  if (threadIdx.x == 0) {
    int c = 0;
    for (int r = 0; r < nrhs; ++r)
      if (metric(s.rmod[r], s.xmod[r], n, abs_diff) > eps && s.t[r] < max_iter)
        s.list[c++] = r;
    s.count = c;
  }
  __syncthreads();
  return s.count;
}

template <typename T>
__device__ __forceinline__ T nonzero(T v) { return v == T(0) ? T(1) : v; }

// K3 (kPcg = false): CG on the gradient g = Ax - b, w1 = g.
// K4 (kPcg = true): Jacobi-PCG (Kaasschieter), w1 = r; z = inv_diag * r is
// recomputed where it is needed instead of stored.
// x, w1, d, ad are (nrhs, n) work arrays; x is the output.
template <typename T, bool kPcg>
__global__ void __launch_bounds__(kBlock)
batched_kernel(DiaOffsets offs, const T* __restrict__ vals,
               const T* __restrict__ invd, const T* __restrict__ B,
               const T* __restrict__ X0, T* X, T* W1, T* D, T* AD, T* part,
               int* t_out, T* res_out, int n, int nrhs, T eps, int max_iter,
               int abs_diff) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Shared<T> s;
  for (int v = threadIdx.x; v < kMaxSums * kMaxRhs * kWarps; v += kBlock)
    s.acc[v] = T(0);
  if (threadIdx.x < nrhs) s.list[threadIdx.x] = threadIdx.x;
  load_offsets(offs, s.off);
  const int nd = offs.count;
  int round = 0;

  // Every system: CG g0 = A x0 - b, d0 = -g0 (lcg.cpp:171-183);
  // PCG r0 = b - A x0, d0 = z0 = inv_diag * r0.
  sweep<T, kPcg ? 3 : 2>(s, nrhs, n, [&](int r, int i, auto& acc) {
    const size_t row = (size_t)r * n;
    const T xi = X0[row + i];
    const T axi = dia_row(s.off, nd, vals, X0 + row, n, i);
    X[row + i] = xi;
    if constexpr (kPcg) {
      const T ri = B[row + i] - axi;
      const T zi = invd[i] * ri;
      W1[row + i] = ri;
      D[row + i] = zi;
      acc[0] += zi * ri;
      acc[1] += ri * ri;
      acc[2] += xi * xi;
    } else {
      const T gi = axi - B[row + i];
      W1[row + i] = gi;
      D[row + i] = -gi;
      acc[0] += gi * gi;
      acc[1] += xi * xi;
    }
  });
  grid_reduce<T, kPcg ? 3 : 2>(s, nrhs, part, nrhs, round++, grid);
  if (threadIdx.x < nrhs) {
    const int r = threadIdx.x;
    const T* tot = s.tot;
    s.t[r] = 0;
    s.rmod[r] = tot[kPcg ? kMaxRhs + r : r];
    const T xm = tot[(kPcg ? 2 : 1) * kMaxRhs + r];
    s.xmod[r] = xm > T(1) ? xm : T(1);
    if (kPcg) s.ztr[r] = tot[r];
  }
  __syncthreads();

  int cnt;
  while ((cnt = alive_systems(s, nrhs, eps, max_iter, n, abs_diff)) > 0) {
    sweep<T, 1>(s, cnt, n, [&](int r, int i, auto& acc) {
      const size_t row = (size_t)r * n;
      const T adi = dia_row(s.off, nd, vals, D + row, n, i);
      AD[row + i] = adi;
      acc[0] += D[row + i] * adi;
    });
    grid_reduce<T, 1>(s, cnt, part, nrhs, round++, grid);
    if (threadIdx.x < cnt) {
      const int r = s.list[threadIdx.x];
      // lcg.cpp:390 for PCG; the guard is pallas_cg.py:398, :981.
      s.ak[r] = (kPcg ? s.ztr[r] : s.rmod[r]) / nonzero(s.tot[r]);
    }
    __syncthreads();

    sweep<T, kPcg ? 3 : 2>(s, cnt, n, [&](int r, int i, auto& acc) {
      const size_t row = (size_t)r * n;
      const T ak = s.ak[r];
      const T di = D[row + i];
      const T xi = X[row + i] + ak * di;
      X[row + i] = xi;
      if constexpr (kPcg) {
        const T ri = W1[row + i] - ak * AD[row + i];
        const T zi = invd[i] * ri;
        W1[row + i] = ri;
        acc[0] += zi * ri;
        acc[1] += ri * ri;
        acc[2] += xi * xi;
      } else {
        const T gi = W1[row + i] + ak * AD[row + i];
        W1[row + i] = gi;
        acc[0] += gi * gi;
        acc[1] += xi * xi;
      }
    });
    grid_reduce<T, kPcg ? 3 : 2>(s, cnt, part, nrhs, round++, grid);
    if (threadIdx.x < cnt) {
      const int r = s.list[threadIdx.x];
      const T* tot = s.tot;
      if constexpr (kPcg) {
        s.beta[r] = tot[r] / nonzero(s.ztr[r]);  // lcg.cpp:415; pallas_cg.py:986
        s.ztr[r] = tot[r];
        s.rmod[r] = tot[kMaxRhs + r];
      } else {
        s.beta[r] = tot[r] / nonzero(s.rmod[r]);  // pallas_cg.py:402
        s.rmod[r] = tot[r];
      }
      const T xm = tot[(kPcg ? 2 : 1) * kMaxRhs + r];
      s.xmod[r] = xm > T(1) ? xm : T(1);
      ++s.t[r];
    }
    __syncthreads();

    sweep<T, 0>(s, cnt, n, [&](int r, int i, auto&) {
      const size_t row = (size_t)r * n;
      const T beta = s.beta[r];
      if constexpr (kPcg)
        D[row + i] = invd[i] * W1[row + i] + beta * D[row + i];
      else
        D[row + i] = beta * D[row + i] - W1[row + i];
    });
    grid.sync();  // the next product reads neighbours' d
  }
  if (blockIdx.x == 0 && threadIdx.x < nrhs) {
    const int r = threadIdx.x;
    t_out[r] = s.t[r];
    res_out[r] = metric(s.rmod[r], s.xmod[r], n, abs_diff);
  }
}

// Kernel ids shared with ops/cuda_cg.py: even ids float, odd ids double.
enum KernelId {
  kCgF32 = 0, kCgF64 = 1, kPcgF32 = 2, kPcgF64 = 3,                    // K1, K2
  kCgBatchedF32 = 4, kCgBatchedF64 = 5, kPcgBatchedF32 = 6, kPcgBatchedF64 = 7,  // K3, K4
};

const void* kernel_ptr(int id) {
  switch (id) {
    case kCgF32: return (const void*)cg_dia_kernel<float>;
    case kCgF64: return (const void*)cg_dia_kernel<double>;
    case kPcgF32: return (const void*)pcg_dia_kernel<float>;
    case kPcgF64: return (const void*)pcg_dia_kernel<double>;
    case kCgBatchedF32: return (const void*)batched_kernel<float, false>;
    case kCgBatchedF64: return (const void*)batched_kernel<double, false>;
    case kPcgBatchedF32: return (const void*)batched_kernel<float, true>;
    case kPcgBatchedF64: return (const void*)batched_kernel<double, true>;
    default: return nullptr;
  }
}

template <typename T>
int launch(int id, int device, const int* offsets, int n_diags,
           const void* vals, const void* invd, const void* b, const void* x0,
           void* x, void* w1, void* d, void* ad, void* part, void* t_out,
           void* res_out, int n, int nrhs, double eps, int max_iter,
           int abs_diff, int grid, void* stream) {
  const bool batched = id >= kCgBatchedF32;
  if (n_diags < 1 || n_diags > kMaxDiags) return (int)cudaErrorInvalidValue;
  if (batched && (nrhs < 1 || nrhs > kMaxRhs)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  DiaOffsets offs;
  offs.count = n_diags;
  for (int k = 0; k < n_diags; ++k) offs.off[k] = offsets[k];
  T eps_t = (T)eps;
  void* args_cg[] = {&offs, &vals, &b, &x0, &x, &w1, &d, &ad, &part,
                     &t_out, &res_out, &n, &eps_t, &max_iter, &abs_diff};
  void* args_pcg[] = {&offs, &vals, &invd, &b, &x0, &x, &w1, &d, &ad, &part,
                      &t_out, &res_out, &n, &eps_t, &max_iter, &abs_diff};
  void* args_batched[] = {&offs, &vals, &invd, &b, &x0, &x, &w1, &d, &ad,
                          &part, &t_out, &res_out, &n, &nrhs, &eps_t,
                          &max_iter, &abs_diff};
  void** args = batched ? args_batched
                : (id == kPcgF32 || id == kPcgF64) ? args_pcg : args_cg;
  err = cudaLaunchCooperativeKernel(kernel_ptr(id), dim3(grid), dim3(kBlock),
                                    args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest co-resident grid for kernel `id` on `device`:
// cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count.
int lcg_dia_max_grid(int id, int device, int* grid_out) {
  const void* fn = kernel_ptr(id);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kBlock, 0);
  if (err != cudaSuccess) return (int)err;
  *grid_out = sms * per_sm;
  return 0;
}

int lcg_dia_block_size(void) { return kBlock; }
int lcg_dia_max_diags(void) { return kMaxDiags; }
int lcg_dia_max_sums(void) { return kMaxSums; }
int lcg_dia_max_rhs(void) { return kMaxRhs; }

const char* lcg_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One whole solve: of one right-hand side for ids 0-3 (vectors of n, `t_out`
// and `res_out` one entry each, `nrhs` ignored), of an (nrhs, n) stack for
// ids 4-7 (`t_out` and `res_out` nrhs entries each).  `invd` is ignored for
// CG; `w1` is g (CG) or r (PCG).  `part` holds 2 * lcg_dia_max_sums() *
// max(nrhs, 1) * grid entries of the working type.  Returns a cudaError_t:
// the launch's own, or cudaGetLastError() after it.
int lcg_dia_solve(int id, int device, const int* offsets, int n_diags,
                  const void* vals, const void* invd, const void* b,
                  const void* x0, void* x, void* w1, void* d, void* ad,
                  void* part, void* t_out, void* res_out, int n, int nrhs,
                  double eps, int max_iter, int abs_diff, int grid,
                  void* stream) {
  if (kernel_ptr(id) == nullptr) return (int)cudaErrorInvalidValue;
  if (id % 2 == 0)
    return launch<float>(id, device, offsets, n_diags, vals, invd, b, x0, x,
                         w1, d, ad, part, t_out, res_out, n, nrhs, eps,
                         max_iter, abs_diff, grid, stream);
  return launch<double>(id, device, offsets, n_diags, vals, invd, b, x0, x,
                        w1, d, ad, part, t_out, res_out, n, nrhs, eps,
                        max_iter, abs_diff, grid, stream);
}

}  // extern "C"
