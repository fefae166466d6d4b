// Hand-written Hopper (sm_90a) kernels for the diagonal-split CSR operator
// of sublinear_tpu_torch/ops/csr_spmv.py.
//
// What they replace (JAX/Pallas kernels of the reference package):
//   csr_spmv      sublinear_tpu/ops/xbar.py::_fused_call (:348), and the
//                 two-kernel schedule of the same product ::_k1_call (:247) +
//                 ::_k2_call (:726).  All three compute y = R x over the
//                 crossbar-routed tables; here the product reads a plain CSR
//                 of the off-diagonal entries.  With a diagonal pointer it
//                 also adds diag[i] * x[i], which XbarOperator.matvec does in
//                 its epilogue.
//   neumann_step  sublinear_tpu/ops/xbar.py::_chain_call (:490), the full
//                 Neumann chain in one pallas_call: per step y = R t_in,
//                 t_out = -inv_d * y, acc += t_out; on the last step also
//                 res = -y (with_residual=True) or sum(y * y) into a double
//                 (with_residual="norm").  One launch runs the whole chain.
//   cg_step       sublinear_tpu/ops/xbar.py::_cg_chain_call (:619), a chain
//                 of Jacobi-preconditioned CG steps in one pallas_call.  One
//                 launch runs the whole chain.
//
// The product: a stream of row blocks (CSR-stream, as in CSR-Adaptive).
// ops/csr_spmv.py::spmv_row_blocks cuts the rows into blocks of consecutive
// rows holding at most kTile off-diagonal entries and at most kTileRows
// rows; a row of more than kLongRow entries is a block of its own.
// stream_row_block serves one row block with the kStreamThreads threads of a
// thread block and hands each finished row's sum to an epilogue:
//   - short rows: every thread loads kPerThread (index, value) pairs of the
//     block's entry range with independent coalesced loads, then issues its
//     kPerThread gathers of x, each batch before any of it is used, so that
//     8 loads and then 4 gathers per thread are in flight to cover HBM
//     latency; the values and gathered x go to shared memory, and then one
//     thread per row sums its row as an fmaf chain in CSR order from 0.
//     That is the order csr_spmm takes for each column, so for such rows
//     csr_spmv(x) equals csr_spmm(x[:, None])[:, 0] bit for bit;
//   - a long row: every thread sums its share (entries t, t + kStreamThreads,
//     ...) in CSR order, then a fixed shuffle tree and the warps' sums in
//     order: the same bits on every run.
// The three kernels differ only in their epilogues, so the Neumann step's y
// equals csr_spmv(t_in) and the CG step's q equals csr_spmv(p, diag) bit for
// bit.
//
// csr_spmv launches one thread block per row block.  Its bound on an H100:
// bytes, not arithmetic (2 flops per entry): ~8 B per stored entry of CSR
// and ~16 B per row of vectors, beside a gather of x[col] per entry that
// moves a whole 32-byte L2 sector for its 4 bytes.  Measured at n = 100k
// (density 1e-4) and n = 1M (density 1e-5) on an H100 at 700 W: 0.011 ms
// and 0.094 ms of device time, 26% and 31% of the HBM bound, about the time
// of the bare gather of every x[col] alone (torch index_select: 0.0096 and
// 0.090 ms; sweep_sparse_kernels.py).  So the gathers' L2 sectors, not the
// stream, bound it.
//
// The chains.  On the TPU a chain's grid ran in order on one core and
// carried its vectors in VMEM.  Here each chain is one persistent
// cooperative kernel: the wrapper sizes the grid from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SM count, so that
// every block is resident, launches it with cudaLaunchCooperativeKernel, and
// each block walks the row blocks grid-stride.  A grid barrier
// (cooperative_groups::this_grid().sync()) stands where a launch boundary
// stood: a step's product gathers vector entries that other blocks wrote in
// the step before.  Those gathers are plain loads, never the read-only
// path (__ldg), because the vectors change during the kernel; grid.sync()
// orders the writes of one step before the loads of the next.  Plain loads
// keep L1 hits that loads through L2 alone (__ldcg) lose, and the chains
// stream the CSR evict-first (__ldcs) so that at n = 1M the 80 MB stream
// does not push the gathered vector out of L1.  Device time per step on an
// H100 at 700 W (times.py --family chains; __ldcg gathers / plain gathers /
// plain gathers and an evict-first CSR): Neumann 0.0138 / 0.0122-0.0131 /
// 0.0131 ms at n = 100k and 0.1066 / 0.1100-0.1107 / 0.1045 ms at n = 1M;
// CG 0.0244 / 0.0177 / 0.0172-0.0176 ms and 0.1174 / 0.1128-0.1131 /
// 0.1066 ms.
//   neumann_chain  one barrier per step; t_in and t_out ping-pong between
//                  two buffers (t_out is never the buffer being gathered).
//   cg_chain       three phases per step, a barrier after each:
//                  1. q = R p + diag * p, and p.q into scal[2j+1];
//                  2. alpha = rz / max(p.q, TINY); x += alpha p;
//                     r -= alpha q; r.z (z = inv_d * r) into scal[2j+2], and
//                     r.r into scal[2*iters+1] on the last step;
//                  3. beta = r.z / max(rz, TINY); p = z + beta p.
// scal is one double array of 2*iters + 2 slots that the wrapper zeroes
// once per chain; rz of step 0 comes from the caller's f32 scalar: every dot
// has its own slot, so no phase reads a slot that the same phase writes.
// Dots accumulate in f64 (per thread, then warp shuffle, block sum, one
// atomicAdd per block and phase) and are rounded to f32 before the scalar
// arithmetic; the vector updates are f32 without FMA contraction, so the
// plain versions (ops/csr_spmv.py) differ from the kernels only in summation
// order.
// What bounds a chain.  At n = 100k (density 1e-4: ~1.1M entries, ~9 MB of
// CSR and ~2 MB of vectors) the working set stays in the 50 MB L2 across
// the chain: a step is bounded by the gathers' L2 sectors, as csr_spmv is,
// plus the grid barriers (one per Neumann step, three per CG step), and the
// single launch removes the per-step host launches that made the chains
// launch-bound.  At n = 1M (~80 MB of CSR, more than L2) a step streams the
// CSR from HBM and is bounded by the gathers, as csr_spmv at that size;
// the row-block stream keeps 4 gathers per thread in flight for that, and
// the barriers are a small share of a ~0.1 ms step.
//
// Interface: plain C, loaded with ctypes.  Every entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() or the launch's error (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cgr = cooperative_groups;

namespace {

constexpr float kTiny = 1e-30f;   // _cg_chain_call's TINY
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// The row blocks: the same numbers as SPMV_TILE, SPMV_ROWS and
// SPMV_LONG_ROW in ops/csr_spmv.py, which cuts the partition (a test holds
// the two files to each other)
constexpr int kStreamThreads = 256;
constexpr int kTile = 1024;                // entries of a block of short rows
constexpr int kTileRows = kStreamThreads;  // rows of a block: one thread each
constexpr int kLongRow = 64;               // a longer row is a block alone
constexpr int kPerThread = kTile / kStreamThreads;
static_assert(kTile % kStreamThreads == 0, "whole loads per thread");
static_assert(kLongRow <= kTile, "a short row fits a tile");

struct StreamSmem {
  float val[kTile];
  float x[kTile];
  int ptr[kTileRows + 1];
  float warp[kStreamThreads / 32];
};

// kChain: a load of a chain kernel, whose gathered vector other blocks write
// between grid barriers (grid.sync() orders those writes before the loads).
// A gather of x: a plain load in a chain, the read-only path in csr_spmv,
// where x is constant for the kernel's lifetime.
template <bool kChain>
__device__ __forceinline__ float load_x(const float* p) {
  return kChain ? *p : __ldg(p);
}

// A load of the CSR stream: evict-first in a chain, which keeps L1 for the
// gathers, the read-only path in csr_spmv.
template <bool kChain, class T>
__device__ __forceinline__ T load_csr(const T* p) {
  return kChain ? __ldcs(p) : __ldg(p);
}

// Serves row block [row_blocks[b], row_blocks[b + 1]) with the whole thread
// block: calls ep(row, sum) once for each row of it, from one thread, with
// sum = the row's sum of vals[j] * x[indices[j]] (see the note at the top).
// Every thread of the block must call it with the same b; a caller that
// serves a second row block with the same StreamSmem calls __syncthreads()
// between the two.
template <bool kChain, class Epilogue>
__device__ __forceinline__ void stream_row_block(
    int b, const int* __restrict__ row_blocks,
    const int* __restrict__ indptr, const int* __restrict__ indices,
    const float* __restrict__ vals, const float* x, StreamSmem& s,
    Epilogue& ep) {
  const int t = threadIdx.x;
  const int r0 = row_blocks[b];
  const int r1 = row_blocks[b + 1];
  const int e0 = indptr[r0];
  const int e1 = indptr[r1];
  float sum = 0.0f;

  if (r1 - r0 == 1 && e1 - e0 > kLongRow) {  // the same for the whole block
    for (int base = e0; base < e1; base += kTile) {
      int col[kPerThread];
      float val[kPerThread], xv[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int j = base + t + i * kStreamThreads;
        col[i] = j < e1 ? load_csr<kChain>(indices + j) : 0;
        val[i] = j < e1 ? load_csr<kChain>(vals + j) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int j = base + t + i * kStreamThreads;
        xv[i] = j < e1 ? load_x<kChain>(x + col[i]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        if (base + t + i * kStreamThreads < e1) sum = fmaf(val[i], xv[i], sum);
      }
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      sum += __shfl_down_sync(kFull, sum, offset);
    }
    if ((t & 31) == 0) s.warp[t / 32] = sum;
    __syncthreads();
    if (t == 0) {
      float total = s.warp[0];
#pragma unroll
      for (int w = 1; w < kStreamThreads / 32; ++w) total += s.warp[w];
      ep(r0, total);
    }
    return;
  }

  // a block of short rows: at most kTile entries and kTileRows rows
  const int cnt = e1 - e0;
  int col[kPerThread];
  float val[kPerThread], xv[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int k = t + i * kStreamThreads;
    col[i] = k < cnt ? load_csr<kChain>(indices + e0 + k) : 0;
    val[i] = k < cnt ? load_csr<kChain>(vals + e0 + k) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int k = t + i * kStreamThreads;
    xv[i] = k < cnt ? load_x<kChain>(x + col[i]) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int k = t + i * kStreamThreads;
    if (k < cnt) {
      s.val[k] = val[i];
      s.x[k] = xv[i];
    }
  }
  if (t <= r1 - r0) s.ptr[t] = indptr[r0 + t] - e0;
  if (t == 0 && r1 - r0 == kTileRows) s.ptr[kTileRows] = cnt;
  __syncthreads();
  const int row = r0 + t;
  if (row < r1) {
    const int end = s.ptr[t + 1];
    for (int k = s.ptr[t]; k < end; ++k) sum = fmaf(s.val[k], s.x[k], sum);
    ep(row, sum);
  }
}

// Adds the block's sum of v into *dst with one atomicAdd.  Every thread of
// the block must call it.
__device__ __forceinline__ void block_sum_into(double v, double* dst) {
  __shared__ double warp_sums[kStreamThreads / 32];
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(kFull, v, offset);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < kStreamThreads / 32; ++w) total += warp_sums[w];
    atomicAdd(dst, total);
  }
  __syncthreads();  // warp_sums may be reused by a second call
}

// sum + diag[row] * x_row without FMA contraction: the same rounding as
// R x + diag * x
__device__ __forceinline__ float add_diag(float sum, float diag, float x) {
  return __fadd_rn(sum, __fmul_rn(diag, x));
}

struct SpmvEpilogue {
  const float* diag;
  const float* x;
  float* y;
  __device__ void operator()(int row, float sum) const {
    y[row] = diag == nullptr ? sum : add_diag(sum, diag[row], x[row]);
  }
};

// One thread block per row block; see the note at the top.
__global__ void __launch_bounds__(kStreamThreads) csr_spmv_kernel(
    const int* __restrict__ row_blocks, const int* __restrict__ indptr,
    const int* __restrict__ indices, const float* __restrict__ vals,
    const float* __restrict__ x, const float* __restrict__ diag,
    float* __restrict__ y) {
  __shared__ StreamSmem s;
  SpmvEpilogue ep{diag, x, y};
  stream_row_block<false>(blockIdx.x, row_blocks, indptr, indices, vals, x,
                          s, ep);
}

// A Neumann step's epilogue: t_out = -inv_d * y, acc += t_out; on the last
// step res = -y (res non-null) and y * y into sq (for the "norm").
struct NeumannEpilogue {
  const float* inv_d;
  float* t_out;
  float* acc;
  float* res;
  bool last;
  double sq;
  __device__ void operator()(int row, float y) {
    const float t = -__fmul_rn(inv_d[row], y);
    t_out[row] = t;
    acc[row] = __fadd_rn(acc[row], t);
    if (last) {
      if (res != nullptr) res[row] = -y;
      sq += (double)y * (double)y;
    }
  }
};

// The chain of `iters` Neumann steps from t0 (see the note at the top):
// step j writes t_out = bufs[j % 2]; acc holds t0 on entry.
__global__ void __launch_bounds__(kStreamThreads) neumann_chain_kernel(
    int n_blocks, const int* __restrict__ row_blocks,
    const int* __restrict__ indptr, const int* __restrict__ indices,
    const float* __restrict__ vals, const float* __restrict__ inv_d,
    const float* t0, float* buf0, float* buf1, float* acc, float* res,
    double* res2, int iters) {
  __shared__ StreamSmem s;
  cgr::grid_group grid = cgr::this_grid();
  const float* t_in = t0;
  for (int j = 0; j < iters; ++j) {
    float* t_out = (j & 1) ? buf1 : buf0;
    NeumannEpilogue ep{inv_d, t_out, acc, res, j == iters - 1, 0.0};
    for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
      __syncthreads();  // the previous row block has left shared memory
      stream_row_block<true>(b, row_blocks, indptr, indices, vals, t_in, s,
                             ep);
    }
    if (j < iters - 1) {
      grid.sync();  // t_out complete before the next step gathers it
    } else if (res2 != nullptr) {
      block_sum_into(ep.sq, res2);
    }
    t_in = t_out;
  }
}

// A CG step's product epilogue: q = y + diag * p (csr_spmv's rounding), and
// p.q into part.
struct CgEpilogue {
  const float* diag;
  const float* p;
  float* q;
  double part;
  __device__ void operator()(int row, float sum) {
    const float pi = p[row];
    const float qi = add_diag(sum, diag[row], pi);
    q[row] = qi;
    part += (double)pi * (double)qi;
  }
};

// The chain of `iters` CG steps (see the note at the top): x, r, p are
// updated in place, q is the product's buffer, scal the zeroed dot slots,
// rz0 the f32 rz of step 0; out = (rz, r.r) after the last step, as f32.
__global__ void __launch_bounds__(kStreamThreads) cg_chain_kernel(
    int n, int n_blocks, const int* __restrict__ row_blocks,
    const int* __restrict__ indptr, const int* __restrict__ indices,
    const float* __restrict__ vals, const float* __restrict__ diag,
    const float* __restrict__ inv_d, float* x, float* r, float* p, float* q,
    double* scal, const float* rz0, int iters, float* out) {
  __shared__ StreamSmem s;
  cgr::grid_group grid = cgr::this_grid();
  const long long stride = (long long)gridDim.x * kStreamThreads;
  const long long first = (long long)blockIdx.x * kStreamThreads + threadIdx.x;
  for (int j = 0; j < iters; ++j) {
    const bool last = j == iters - 1;
    double* scal_j = scal + 2 * j;
    // 1. q = R p + diag * p; p.q into scal[2j+1]
    CgEpilogue ep{diag, p, q, 0.0};
    for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
      __syncthreads();
      stream_row_block<true>(b, row_blocks, indptr, indices, vals, p, s, ep);
    }
    block_sum_into(ep.part, scal_j + 1);
    grid.sync();
    // 2. x += alpha p; r -= alpha q; r.z into scal[2j+2] (r.r last)
    const float rz = j == 0 ? *rz0 : (float)__ldcg(scal_j);
    const float alpha = rz / fmaxf((float)__ldcg(scal_j + 1), kTiny);
    double rz_part = 0.0, rr_part = 0.0;
    for (long long i = first; i < n; i += stride) {
      x[i] = __fadd_rn(x[i], __fmul_rn(alpha, p[i]));
      const float ri = __fsub_rn(r[i], __fmul_rn(alpha, q[i]));
      r[i] = ri;
      rz_part += (double)ri * (double)__fmul_rn(inv_d[i], ri);
      rr_part += (double)ri * (double)ri;
    }
    block_sum_into(rz_part, scal_j + 2);
    if (last) block_sum_into(rr_part, scal + 2 * iters + 1);
    grid.sync();
    // 3. p = z + beta p, complete before the next step's product gathers p
    const float rz_new = (float)__ldcg(scal_j + 2);
    const float beta = rz_new / fmaxf(rz, kTiny);
    for (long long i = first; i < n; i += stride) {
      p[i] = __fadd_rn(__fmul_rn(inv_d[i], r[i]), __fmul_rn(beta, p[i]));
    }
    if (!last) {
      grid.sync();
    } else if (blockIdx.x == 0 && threadIdx.x == 0) {
      out[0] = rz_new;
      out[1] = (float)__ldcg(scal + 2 * iters + 1);
    }
  }
}

// The grid of a cooperative launch of `kernel`: as many blocks as are
// resident on the card at once (blocks per SM from the occupancy calculator
// times the SM count, cached per device), at most `want`, at least 1.
template <class Kernel>
cudaError_t cooperative_grid(Kernel kernel, int device, int* cache,
                             long long want, int* grid) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[device] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kStreamThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cache[device] = per_sm * sms;
  }
  *grid = (int)(want < cache[device] ? (want > 0 ? want : 1) : cache[device]);
  return cudaSuccess;
}

int neumann_grid_cache[kMaxDevices];
int cg_grid_cache[kMaxDevices];

}  // namespace

extern "C" {

// y = R x (+ diag * x) over the n_blocks row blocks of row_blocks
// (n_blocks + 1 ascending row numbers from 0 to n, cut as the note at the
// top says); diag may be null.
int slt_csr_spmv(int device, int n_blocks, const int* row_blocks,
                 const int* indptr, const int* indices, const float* vals,
                 const float* x, const float* diag, float* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_blocks < 1) return (int)cudaErrorInvalidValue;
  csr_spmv_kernel<<<n_blocks, kStreamThreads, 0, (cudaStream_t)stream>>>(
      row_blocks, indptr, indices, vals, x, diag, y);
  return (int)cudaGetLastError();
}

// The whole chain of `iters` >= 1 Neumann steps from t0, in one cooperative
// launch: acc holds t0 on entry and the sum of the terms on exit; the last
// term is in buf0 if iters is odd, else in buf1.  On the last step res = -y
// if res is non-null and sum(y * y) is added into *res2 if res2 is non-null
// (zeroed by the caller).
int slt_neumann_chain(int device, int n_blocks, const int* row_blocks,
                      const int* indptr, const int* indices,
                      const float* vals, const float* inv_d, const float* t0,
                      float* buf0, float* buf1, float* acc, float* res,
                      double* res2, int iters, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_blocks < 1 || iters < 1) return (int)cudaErrorInvalidValue;
  int grid = 0;
  err = cooperative_grid(neumann_chain_kernel, device, neumann_grid_cache,
                         n_blocks, &grid);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&n_blocks, &row_blocks, &indptr, &indices, &vals, &inv_d,
                  &t0,       &buf0,       &buf1,   &acc,     &res,  &res2,
                  &iters};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)neumann_chain_kernel, grid, kStreamThreads, args, 0,
      (cudaStream_t)stream);
}

// The whole chain of `iters` >= 1 CG steps, in one cooperative launch (see
// the note at the top): scal holds 2*iters + 2 zeroed doubles, rz0 the f32
// rz of step 0; out[0..1] = (rz, r.r) after the last step, as f32.
int slt_cg_chain(int device, int n, int n_blocks, const int* row_blocks,
                 const int* indptr, const int* indices, const float* vals,
                 const float* diag, const float* inv_d, float* x, float* r,
                 float* p, float* q, double* scal, const float* rz0,
                 int iters, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || n_blocks < 1 || iters < 1) return (int)cudaErrorInvalidValue;
  // the product walks the row blocks, the updates the n rows
  const long long rows = ((long long)n + kStreamThreads - 1) / kStreamThreads;
  int grid = 0;
  err = cooperative_grid(cg_chain_kernel, device, cg_grid_cache,
                         rows > n_blocks ? rows : n_blocks, &grid);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&n,   &n_blocks, &row_blocks, &indptr, &indices, &vals,
                  &diag, &inv_d,   &x,          &r,      &p,       &q,
                  &scal, &rz0,     &iters,      &out};
  return (int)cudaLaunchCooperativeKernel((const void*)cg_chain_kernel, grid,
                                          kStreamThreads, args, 0,
                                          (cudaStream_t)stream);
}

const char* slt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
