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
// per row of vectors (row pointer, y or t_out, acc, inv_d).  At the slice's
// n = 100k, density 1e-4 that is ~9 MB of matrix and ~2 MB of vectors.
//
// What the design does about it:
//   - a group of kGroup = 8 lanes per row: rows hold ~10 off-diagonal entries
//     at the slice's density, so the group reads one row's indices and values
//     in one or two coalesced sweeps and reduces with __shfl_down_sync, in
//     f32 (the precision of the JAX package's kernels);
//   - x is gathered through the read-only cache (__ldg); the whole matrix of
//     the n = 100k slice (~9 MB) stays in the 50 MB L2 across the launches of
//     one chain, as the TPU kernel kept its tables resident in VMEM;
//   - the chain's norm is reduced inside the kernel (warp shuffle, then a
//     shared-memory block sum, then one atomicAdd(double*) per block), so the
//     verified solve reads back one scalar.
// A persistent grid-synchronised chain kernel, CUDA graphs, cp.async/TMA and
// a tuned row split are left to later work.
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

__global__ void __launch_bounds__(kBlock) csr_spmv_kernel(
    int n, const int* __restrict__ indptr, const int* __restrict__ indices,
    const float* __restrict__ vals, const float* __restrict__ x,
    const float* __restrict__ diag, float* __restrict__ y) {
  const long long tid = (long long)blockIdx.x * kBlock + threadIdx.x;
  const int row = (int)(tid / kGroup);
  const int lane = (int)(tid % kGroup);
  float sum = row_product(row, lane, n, indptr, indices, vals, x);
  if (lane == 0 && row < n) {
    if (diag != nullptr) {
      // no FMA contraction: the same rounding as R x + diag * x
      sum = __fadd_rn(sum, __fmul_rn(diag[row], x[row]));
    }
    y[row] = sum;
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

int slt_csr_spmv(int device, int n, const int* indptr, const int* indices,
                 const float* vals, const float* x, const float* diag,
                 float* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  csr_spmv_kernel<<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      n, indptr, indices, vals, x, diag, y);
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
