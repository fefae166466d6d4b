// Hand-written Hopper (sm_90a) kernels for the diagonal-split CSR operator
// of sublinear_tpu_torch/ops/csr_spmv.py.
//
// What they replace (JAX/Pallas kernels of the reference package):
//   csr_spmv      sublinear_tpu/ops/xbar.py::_fused_call, and the two-kernel
//                 schedule of the same product ::_k1_call + ::_k2_call.  All
//                 three compute y = R x over the crossbar-routed tables; here
//                 the product reads a plain CSR of the off-diagonal entries.
//                 With a diagonal pointer it also adds diag[i] * x[i], which
//                 XbarOperator.matvec does in its epilogue.
//   neumann_step  one pass of sublinear_tpu/ops/xbar.py::_chain_call:
//                 y = R t_in, t_out = -inv_d * y, acc += t_out; on the last
//                 pass of a chain also res = -y (with_residual=True) or
//                 sum(y * y) into a double accumulator (with_residual="norm").
//                 The wrapper launches it `iters` times on one stream.
//   cg_step       one Jacobi-preconditioned CG step of
//                 sublinear_tpu/ops/xbar.py::_cg_chain_call, as three
//                 launches (cg_spmv_dot, cg_update, cg_direction; see below)
//                 from one entry point, which the wrapper calls `iters` times
//                 on one stream.
//
// What bounds them on an H100: bytes, not arithmetic (2 flops per entry).
// One product streams about 8 B per stored entry of CSR (a 4 B column index
// and a 4 B value), gathers one 4 B x[col] per entry, and touches about 16 B
// per row of vectors (row pointer, y or t_out, acc, inv_d).  At n = 100k,
// density 1e-4 that is ~9 MB of matrix and ~2 MB of vectors; at n = 1M,
// density 1e-5, ~80 MB of matrix, more than the 50 MB L2.  Each gather of
// x[col] also moves a whole 32-byte L2 sector for its 4 bytes: ~320 MB of L2
// traffic at n = 1M beside the ~96 MB the product must stream from HBM, so
// once the stream runs at the HBM rate the L2 is the likely ceiling.
//
// csr_spmv streams contiguous ranges of entries (CSR-stream, as in
// CSR-Adaptive).  ops/csr_spmv.py::spmv_row_blocks cuts the rows into blocks
// of consecutive rows holding at most kTile off-diagonal entries and at most
// kTileRows rows; a row of more than kLongRow entries is a block of its own.
// One thread block of kStreamThreads threads serves one row block:
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
//     order: the same bits on every run;
//   - the epilogue __fadd_rn(sum, __fmul_rn(diag, x)) is unchanged.
// A block's 9 KB of shared memory lets 8 blocks (2048 threads) share an
// SM.  Measured at n = 100k (density 1e-4) and n = 1M (density 1e-5), the
// shapes of the Neumann and BiCGSTAB solves, on an H100 at 700 W: 0.011 ms
// and 0.094 ms of device time, 26% and 31% of the HBM bound, about the time
// of the bare gather of every x[col] alone (torch index_select: 0.0096 and
// 0.090 ms); at n = 1M every tile of 512-4096 entries and block of 128-512
// threads took 0.096-0.098 ms per back-to-back call
// (sweep_sparse_kernels.py).  So the gathers' L2 sectors, not the stream,
// bound it.
//
// neumann_step and cg_spmv_dot keep the earlier row loop (row_product): a
// group of kGroup = 8 lanes per row reads the row's indices and values in
// one or two coalesced sweeps and reduces with __shfl_down_sync, in f32
// (the precision of the JAX package's kernels); x is gathered through the
// read-only cache (__ldg).  The chain's norm is reduced inside the kernel
// (warp shuffle, then a shared-memory block sum, then one atomicAdd(double*)
// per block), so the verified solve reads back one scalar.
//
// The CG step.  On the TPU the chain's grid ran in order and carried x, r, p
// in VMEM and rz in SMEM.  Here blocks run in no order, and each of the
// step's two dot products is a grid-wide reduction whose result the next
// phase needs everywhere, so a launch boundary on one stream (no host sync)
// is the grid barrier, as in neumann_step:
//   cg_spmv_dot   q = R p + diag * p (row_product, the csr_spmv epilogue),
//                 and p.q into scal[2j+1];
//   cg_update     alpha = rz / max(p.q, TINY); x += alpha p; r -= alpha q;
//                 z = inv_d * r; r.z into scal[2j+2] (and r.r on the last
//                 step into scal[2*iters+1]);
//   cg_direction  beta = r.z / max(rz, TINY); p = z + beta p (z recomputed
//                 from r, the same bits), which must be complete before the
//                 next step's product gathers p at other rows.
// scal is one double array of 2*iters + 2 slots that the wrapper zeroes once
// per chain, with scal[0] = rz on entry: every dot has its own slot, so no
// launch reads a slot that a block of the same launch writes, and no memset
// runs between launches.  Dots accumulate in f64 (per-thread, then warp
// shuffle, block sum, one atomicAdd per block) and are rounded to f32 before
// the scalar arithmetic; the vector updates are f32 without FMA contraction,
// so the plain version (ops/csr_spmv.py::cg_chain_plain) differs from the
// kernel only in summation order.
// What bounds a step: bytes.  About 12 B per stored entry (column, value and
// the gathered p) plus about 60 B per row over the three launches (p, q, x,
// r, diag, inv_d read or written).  At n = 100k with ~1.0M off-diagonal
// entries that is ~18 MB, which stays in the 50 MB L2 across the chain.  The
// dot kernels run a grid-stride loop over at most kMaxBlocks blocks, which
// bounds the same-address atomics per launch.
//
// Interface: plain C, loaded with ctypes.  Every entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 8;    // lanes per row
constexpr int kBlock = 256;  // threads per block (32 rows)
constexpr int kMaxBlocks = 2048;  // grid cap of the CG kernels
constexpr float kTiny = 1e-30f;   // _cg_chain_call's TINY
constexpr unsigned kFull = 0xffffffffu;

// csr_spmv's row blocks: the same numbers as SPMV_TILE, SPMV_ROWS and
// SPMV_LONG_ROW in ops/csr_spmv.py, which cuts the partition (a test holds
// the two files to each other)
constexpr int kStreamThreads = 256;
constexpr int kTile = 1024;                // entries of a block of short rows
constexpr int kTileRows = kStreamThreads;  // rows of a block: one thread each
constexpr int kLongRow = 64;               // a longer row is a block alone
constexpr int kPerThread = kTile / kStreamThreads;
static_assert(kTile % kStreamThreads == 0, "whole loads per thread");
static_assert(kLongRow <= kTile, "a short row fits a tile");

// Sum over one row of vals[j] * x[indices[j]], spread over the kGroup lanes
// of the calling thread's group.  Every thread of the block must call it
// (the shuffle names the full warp); the sum is valid in lane 0 of the group.
__device__ __forceinline__ float row_product(
    int row, int lane, int n, const int* __restrict__ indptr,
    const int* __restrict__ indices, const float* __restrict__ vals,
    const float* __restrict__ x) {
  float sum = 0.0f;
  if (row < n) {
    const int end = indptr[row + 1];
    for (int j = indptr[row] + lane; j < end; j += kGroup) {
      sum = fmaf(vals[j], __ldg(x + indices[j]), sum);
    }
  }
#pragma unroll
  for (int offset = kGroup / 2; offset > 0; offset >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, offset, kGroup);
  }
  return sum;
}

// Adds the block's sum of v into *dst with one atomicAdd.  Every thread of
// the block must call it.
__device__ __forceinline__ void block_sum_into(double v, double* dst) {
  __shared__ double warp_sums[kBlock / 32];
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < kBlock / 32; ++w) total += warp_sums[w];
    atomicAdd(dst, total);
  }
  __syncthreads();  // warp_sums may be reused by a second call
}

// sum + diag[row] * x[row] without FMA contraction: the same rounding as
// R x + diag * x
__device__ __forceinline__ float add_diag(float sum, int row,
                                          const float* __restrict__ diag,
                                          const float* __restrict__ x) {
  return diag == nullptr ? sum : __fadd_rn(sum, __fmul_rn(diag[row], x[row]));
}

// One thread block per row block [row_blocks[b], row_blocks[b + 1]); see the
// note at the top.
__global__ void __launch_bounds__(kStreamThreads) csr_spmv_kernel(
    const int* __restrict__ row_blocks, const int* __restrict__ indptr,
    const int* __restrict__ indices, const float* __restrict__ vals,
    const float* __restrict__ x, const float* __restrict__ diag,
    float* __restrict__ y) {
  __shared__ float s_val[kTile];
  __shared__ float s_x[kTile];
  __shared__ int s_ptr[kTileRows + 1];
  __shared__ float s_warp[kStreamThreads / 32];
  const int t = threadIdx.x;
  const int r0 = row_blocks[blockIdx.x];
  const int r1 = row_blocks[blockIdx.x + 1];
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
        col[i] = j < e1 ? __ldg(indices + j) : 0;
        val[i] = j < e1 ? __ldg(vals + j) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int j = base + t + i * kStreamThreads;
        xv[i] = j < e1 ? __ldg(x + col[i]) : 0.0f;
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
    if ((t & 31) == 0) s_warp[t / 32] = sum;
    __syncthreads();
    if (t == 0) {
      float total = s_warp[0];
#pragma unroll
      for (int w = 1; w < kStreamThreads / 32; ++w) total += s_warp[w];
      y[r0] = add_diag(total, r0, diag, x);
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
    col[i] = k < cnt ? __ldg(indices + e0 + k) : 0;
    val[i] = k < cnt ? __ldg(vals + e0 + k) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int k = t + i * kStreamThreads;
    xv[i] = k < cnt ? __ldg(x + col[i]) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int k = t + i * kStreamThreads;
    if (k < cnt) {
      s_val[k] = val[i];
      s_x[k] = xv[i];
    }
  }
  if (t <= r1 - r0) s_ptr[t] = indptr[r0 + t] - e0;
  if (t == 0 && r1 - r0 == kTileRows) s_ptr[kTileRows] = cnt;
  __syncthreads();
  const int row = r0 + t;
  if (row < r1) {
    const int end = s_ptr[t + 1];
    for (int k = s_ptr[t]; k < end; ++k) sum = fmaf(s_val[k], s_x[k], sum);
    y[row] = add_diag(sum, row, diag, x);
  }
}

__global__ void __launch_bounds__(kBlock) neumann_step_kernel(
    int n, const int* __restrict__ indptr, const int* __restrict__ indices,
    const float* __restrict__ vals, const float* __restrict__ t_in,
    const float* __restrict__ inv_d, float* __restrict__ t_out,
    float* __restrict__ acc, float* __restrict__ res,
    double* __restrict__ res2) {
  const long long tid = (long long)blockIdx.x * kBlock + threadIdx.x;
  const int row = (int)(tid / kGroup);
  const int lane = (int)(tid % kGroup);
  const float y = row_product(row, lane, n, indptr, indices, vals, t_in);
  double sq = 0.0;
  if (lane == 0 && row < n) {
    const float t = -__fmul_rn(inv_d[row], y);
    t_out[row] = t;
    acc[row] = __fadd_rn(acc[row], t);
    if (res != nullptr) res[row] = -y;
    sq = (double)y * (double)y;
  }
  // the same for every block of the launch
  if (res2 != nullptr) block_sum_into(sq, res2);
}

__global__ void __launch_bounds__(kBlock) cg_spmv_dot_kernel(
    int n, const int* __restrict__ indptr, const int* __restrict__ indices,
    const float* __restrict__ vals, const float* __restrict__ diag,
    const float* __restrict__ p, float* __restrict__ q,
    double* __restrict__ pq) {
  const long long lanes = (long long)n * kGroup;
  double part = 0.0;
  // base is the same for every thread of the block, so the loop (and the
  // shuffle inside row_product) is block-uniform
  for (long long base = (long long)blockIdx.x * kBlock; base < lanes;
       base += (long long)gridDim.x * kBlock) {
    const long long tid = base + threadIdx.x;
    const int row = (int)(tid / kGroup);
    const int lane = (int)(tid % kGroup);
    float sum = row_product(row, lane, n, indptr, indices, vals, p);
    if (lane == 0 && row < n) {
      const float pi = p[row];
      sum = __fadd_rn(sum, __fmul_rn(diag[row], pi));
      q[row] = sum;
      part += (double)pi * (double)sum;
    }
  }
  block_sum_into(part, pq);
}

__global__ void __launch_bounds__(kBlock) cg_update_kernel(
    int n, float* __restrict__ x, float* __restrict__ r,
    const float* __restrict__ p, const float* __restrict__ q,
    const float* __restrict__ inv_d, const double* __restrict__ scal_j,
    double* __restrict__ rz_next, double* __restrict__ rr) {
  // scal_j[0] = rz of this step, scal_j[1] = its finished p.q
  const float alpha = (float)scal_j[0] / fmaxf((float)scal_j[1], kTiny);
  double rz_part = 0.0, rr_part = 0.0;
  for (long long i = (long long)blockIdx.x * kBlock + threadIdx.x; i < n;
       i += (long long)gridDim.x * kBlock) {
    x[i] = __fadd_rn(x[i], __fmul_rn(alpha, p[i]));
    const float ri = __fsub_rn(r[i], __fmul_rn(alpha, q[i]));
    r[i] = ri;
    rz_part += (double)ri * (double)__fmul_rn(inv_d[i], ri);
    rr_part += (double)ri * (double)ri;
  }
  block_sum_into(rz_part, rz_next);
  if (rr != nullptr) block_sum_into(rr_part, rr);  // uniform per launch
}

__global__ void __launch_bounds__(kBlock) cg_direction_kernel(
    int n, const float* __restrict__ r, const float* __restrict__ inv_d,
    float* __restrict__ p, const double* __restrict__ scal_j,
    const double* __restrict__ rr, float* __restrict__ out) {
  // scal_j[0] = rz of this step, scal_j[2] = the finished r.z after it
  const float rz_new = (float)scal_j[2];
  const float beta = rz_new / fmaxf((float)scal_j[0], kTiny);
  for (long long i = (long long)blockIdx.x * kBlock + threadIdx.x; i < n;
       i += (long long)gridDim.x * kBlock) {
    p[i] = __fadd_rn(__fmul_rn(inv_d[i], r[i]), __fmul_rn(beta, p[i]));
  }
  if (out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    out[0] = rz_new;
    out[1] = (float)*rr;
  }
}

int grid_for(int n) {
  return (int)(((long long)n * kGroup + kBlock - 1) / kBlock);
}

int capped(int blocks) { return blocks < kMaxBlocks ? blocks : kMaxBlocks; }

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

int slt_neumann_step(int device, int n, const int* indptr, const int* indices,
                     const float* vals, const float* t_in, const float* inv_d,
                     float* t_out, float* acc, float* res, double* res2,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  neumann_step_kernel<<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      n, indptr, indices, vals, t_in, inv_d, t_out, acc, res, res2);
  return (int)cudaGetLastError();
}

// One CG step j of a chain of `iters` (see the note at the top): scal holds
// 2*iters + 2 doubles, zeroed, with scal[0] = rz on entry.  On the last step
// (last != 0) r.r goes into scal[2*iters+1] and out[0..1] = (rz, r.r) as f32.
int slt_cg_step(int device, int n, const int* indptr, const int* indices,
                const float* vals, const float* diag, const float* inv_d,
                float* x, float* r, float* p, float* q, double* scal, int j,
                int iters, int last, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  double* scal_j = scal + 2 * j;
  double* rr = last ? scal + 2 * iters + 1 : nullptr;
  cg_spmv_dot_kernel<<<capped(grid_for(n)), kBlock, 0, s>>>(
      n, indptr, indices, vals, diag, p, q, scal_j + 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int blocks = capped((n + kBlock - 1) / kBlock);
  cg_update_kernel<<<blocks, kBlock, 0, s>>>(n, x, r, p, q, inv_d, scal_j,
                                             scal_j + 2, rr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  cg_direction_kernel<<<blocks, kBlock, 0, s>>>(n, r, inv_d, p, scal_j, rr,
                                                last ? out : nullptr);
  return (int)cudaGetLastError();
}

const char* slt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
