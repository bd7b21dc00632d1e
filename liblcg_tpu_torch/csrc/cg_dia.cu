// Whole-solve CG and Jacobi-PCG on a DIA matrix: one cooperative launch
// runs the entire iteration loop on the card, with no host round trip.
//
// Replaces the TPU kernels of liblcg_tpu/ops/pallas_cg.py:
//   cg_dia_kernel  <- _cg_kernel  (launched by pallas_cg_dia)   K1
//   pcg_dia_kernel <- _pcg_kernel (launched by pallas_pcg_dia)  K2
// They compute what the Pallas kernels compute: the same recurrences (CG
// on the gradient g = Ax - b, PCG in Kaasschieter's form with inv_diag),
// the same stopping rule (continue while metric > eps && t < max_iter,
// metric = ||r||^2 / max(||x||^2, 1) or sqrt(||r||^2) / n) and the same
// outputs (x, t, metric).  Hopper has native f64, so both kernels are
// templated on float and double.
//
// Design.  One persistent cooperative grid, every block co-resident (the
// wrapper sizes the grid from the occupancy query times the SM count, and
// cudaLaunchCooperativeKernel refuses a larger one).  Vector loops are
// grid-stride, so any n works.  The DIA product is
//   y[i] = sum_d vals[d*n + i] * v[i + off[d]]
// over the offsets in sorted order, read from a shared-memory table, with
// a bounds test where the TPU kernel read a zero-padded image.
//
// Reductions across blocks: each block writes its partial sum to a scratch
// array, the grid syncs, and then EVERY block sums all partials in the same
// fixed order in the working type.  All blocks therefore hold bit-identical
// alpha, beta and metric, take the same loop exit, and the result is the
// same from run to run.  (Float atomics would give each block its own
// rounding; a block leaving the loop early would leave the others waiting
// at a grid sync forever.)  Partials alternate between two halves of the
// scratch, because a fast block may write the next partial before a slow
// one has read the last.
//
// What bounds it on an H100.  Per CG iteration the kernel streams about 18
// n-length vectors (SpMV: D diagonals + d + the A d write; x, g, d, A d
// update: 6; direction update: 3), 20 for PCG.  At 128^3 in f64 (n = 2.1M,
// D = 7) that is ~300 MB per iteration against 3.35 TB/s, part of which
// the 50 MB L2 catches between phases: memory bandwidth bounds it.  At
// n = 10,000 everything sits in L2 and the four grid syncs per iteration
// (three reductions, and one before the next product reads d) set the
// pace.  A fused SpMV+dot pipeline, TMA loads and CUDA graphs are
// later work; this kernel is the simple, right one.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxDiags = 256;   // the shared-memory offset table
constexpr int kMaxSums = 3;      // scalars reduced at one sync point

struct DiaOffsets {
  int count;
  int off[kMaxDiags];
};

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

template <typename T>
__device__ __forceinline__ T metric(T rmod, T xmod, int n, int abs_diff) {
  return abs_diff ? sqrt(rmod) / T(n) : rmod / xmod;
}

__device__ __forceinline__ void load_offsets(const DiaOffsets& offs, int* s_off) {
  for (int k = threadIdx.x; k < offs.count; k += kBlock) s_off[k] = offs.off[k];
  __syncthreads();
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

// Kernel ids shared with ops/cuda_cg.py.
enum KernelId { kCgF32 = 0, kCgF64 = 1, kPcgF32 = 2, kPcgF64 = 3 };

const void* kernel_ptr(int id) {
  switch (id) {
    case kCgF32: return (const void*)cg_dia_kernel<float>;
    case kCgF64: return (const void*)cg_dia_kernel<double>;
    case kPcgF32: return (const void*)pcg_dia_kernel<float>;
    case kPcgF64: return (const void*)pcg_dia_kernel<double>;
    default: return nullptr;
  }
}

template <typename T>
int launch(int id, int device, const int* offsets, int n_diags,
           const void* vals, const void* invd, const void* b, const void* x0,
           void* x, void* w1, void* d, void* ad, void* part, void* t_out,
           void* res_out, int n, double eps, int max_iter, int abs_diff,
           int grid, void* stream) {
  if (n_diags < 1 || n_diags > kMaxDiags) return (int)cudaErrorInvalidValue;
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
  const bool is_pcg = id == kPcgF32 || id == kPcgF64;
  err = cudaLaunchCooperativeKernel(kernel_ptr(id), dim3(grid), dim3(kBlock),
                                    is_pcg ? args_pcg : args_cg, 0,
                                    (cudaStream_t)stream);
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

const char* lcg_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One whole solve.  `invd` is ignored for CG; `w1` is g (CG) or r (PCG).
// `part` holds 2 * lcg_dia_max_sums() * grid entries of the working type.
// Returns a cudaError_t: the launch's own, or cudaGetLastError() after it.
int lcg_dia_solve(int id, int device, const int* offsets, int n_diags,
                  const void* vals, const void* invd, const void* b,
                  const void* x0, void* x, void* w1, void* d, void* ad,
                  void* part, void* t_out, void* res_out, int n, double eps,
                  int max_iter, int abs_diff, int grid, void* stream) {
  if (id == kCgF32 || id == kPcgF32)
    return launch<float>(id, device, offsets, n_diags, vals, invd, b, x0, x,
                         w1, d, ad, part, t_out, res_out, n, eps, max_iter,
                         abs_diff, grid, stream);
  if (id == kCgF64 || id == kPcgF64)
    return launch<double>(id, device, offsets, n_diags, vals, invd, b, x0, x,
                          w1, d, ad, part, t_out, res_out, n, eps, max_iter,
                          abs_diff, grid, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
