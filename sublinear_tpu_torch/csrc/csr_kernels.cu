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
// Interface: plain C, loaded with ctypes.  Every entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 8;    // lanes per row
constexpr int kBlock = 256;  // threads per block (32 rows)

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
  __shared__ double warp_sums[kBlock / 32];
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
  if (res2 != nullptr) {  // the same for every block of the launch
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      sq += __shfl_down_sync(0xffffffffu, sq, offset);
    }
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x / 32] = sq;
    __syncthreads();
    if (threadIdx.x == 0) {
      double total = 0.0;
#pragma unroll
      for (int w = 0; w < kBlock / 32; ++w) total += warp_sums[w];
      atomicAdd(res2, total);
    }
  }
}

int grid_for(int n) {
  return (int)(((long long)n * kGroup + kBlock - 1) / kBlock);
}

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

const char* slt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
