// Hand-written Hopper (sm_90a) sparse-times-dense kernel of
// sublinear_tpu_torch/ops/csr_spmv.py::csr_spmm.
//
// What it replaces: sublinear_tpu/ops/pallas_spmv.py::onehot_spmm (body
// _spmm_kernel), the tiled one-hot SpMM Y = A X.  On the TPU it routes both
// the gather of X's rows and the scatter into Y's rows through the matrix
// unit, as one-hot matmuls over (row-block, col-block) tiles, because the TPU
// has no fast gather.  Hopper gathers directly, so this kernel reads a plain
// row-sorted int32 CSR and keeps only what onehot_spmm computes per entry:
//   F32    p = v * x (with an FMA into the row sum): the solver product of
//          CsrOperator.matmat;
//   SPLIT  onehot_spmm(precise=True): v and x split into bf16 halves,
//          p = (vh*xh + vh*xl) + vl*xh, then ph = bf16(p), plo = bf16(p - ph),
//          and the row sum takes ph + plo (exact in f32);
//   BF16   onehot_spmm(precise=False): p = bf16(bf16(v) * bf16(x)).
// A product of two bf16 values is exact in f32, so FMA contraction cannot
// change SPLIT or BF16; the bf16 rounding is __float2bfloat16_rn, the
// round-to-nearest-even of astype(bfloat16).  With a diagonal pointer the
// epilogue adds diag[i] * X[i, :] (no FMA), as csr_spmv does, for the
// diagonal-split operator.
//
// Layout: X is (m, B) and Y is (n, B), f32, row-major, contiguous, any
// B >= 1.  Offsets into X and Y are 64-bit: m * B passes 2^31 at n = 1M,
// B >= 2148.
//
// What bounds it on an H100: bytes.  Each stored entry costs 8 B of CSR and
// a gather of one row of X (4 * B bytes); at the batch path's n = 100k,
// B = 128, X and Y are 51.2 MB each and the ~1.0M entries gather ~0.5 GB
// from L2.
//
// What the design does about it:
//   - a group of G lanes per row, G = the smallest power of two that covers
//     the B columns (in float4 chunks when B % 4 == 0 and both X and Y are
//     16-byte aligned, scalars otherwise), at most 32; 32 / G rows per warp.
//     At B = 128 one warp owns a row and every gathered row of X is one
//     512-byte coalesced float4 load; at B = 8 sixteen rows share a warp;
//   - each lane of a group loads one (col, val) pair of its row and the
//     group shares them by __shfl_sync, so the CSR is read once per pass
//     over the columns (one pass for B <= 128 in float4, B <= 32 in
//     scalars);
//   - each row's sum runs in CSR order with no atomics, so runs repeat bit
//     for bit.
// Tensor-core SpMM, shared-memory staging of X's rows and a row split tuned
// to the row lengths are left to later work.
//
// Interface: plain C, loaded with ctypes.  The entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;  // threads per block (8 warps)
constexpr unsigned kFull = 0xffffffffu;

enum Mode : int { kF32 = 0, kSplit = 1, kBf16 = 2 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc += the product of one stored entry (value v, its bf16 halves vh, vl)
// and one element x of X, in mode M.
template <int M>
__device__ __forceinline__ void accumulate(float& acc, float v, float vh,
                                           float vl, float x) {
  if constexpr (M == kF32) {
    acc = fmaf(v, x, acc);
  } else if constexpr (M == kSplit) {
    const float xh = bf16_round(x);
    const float xl = bf16_round(__fsub_rn(x, xh));
    const float p = __fadd_rn(__fadd_rn(__fmul_rn(vh, xh), __fmul_rn(vh, xl)),
                              __fmul_rn(vl, xh));
    const float ph = bf16_round(p);
    const float plo = bf16_round(__fsub_rn(p, ph));
    acc = __fadd_rn(acc, __fadd_rn(ph, plo));
  } else {
    acc = __fadd_rn(acc, bf16_round(__fmul_rn(vh, bf16_round(x))));
  }
}

// V = 4: float4 columns (B % 4 == 0, X and Y 16-byte aligned); V = 1:
// scalar columns.  `group` lanes per row, a power of two <= 32.
template <int M, int V>
__global__ void __launch_bounds__(kBlock) csr_spmm_kernel(
    int n, int B, int group, const int* __restrict__ indptr,
    const int* __restrict__ indices, const float* __restrict__ vals,
    const float* __restrict__ X, const float* __restrict__ diag,
    float* __restrict__ Y) {
  const int lane = threadIdx.x & 31;
  const int gl = lane & (group - 1);  // lane within the row's group
  const long long warp = ((long long)blockIdx.x * kBlock + threadIdx.x) >> 5;
  const long long row_ll = warp * (32 / group) + lane / group;
  const bool has_row = row_ll < n;
  const int row = has_row ? (int)row_ll : 0;
  const int start = has_row ? indptr[row] : 0;
  const int end = has_row ? indptr[row + 1] : 0;
  // B and group are the same for every lane, so this loop, and with it every
  // shuffle below, is warp-uniform
  for (int c0 = 0; c0 < B; c0 += group * V) {
    const int c = c0 + gl * V;
    const bool has_col = has_row && c < B;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    for (int base = start; __any_sync(kFull, base < end); base += group) {
      const int j = base + gl;
      int col = 0;
      float v = 0.0f;
      if (j < end) {
        col = __ldg(indices + j);
        v = __ldg(vals + j);
      }
      const int cnt = end - base;  // entries left in this row (may be <= 0)
      const int steps = __reduce_max_sync(kFull, max(min(cnt, group), 0));
      for (int k = 0; k < steps; ++k) {
        const int ck = __shfl_sync(kFull, col, k, group);
        const float vk = __shfl_sync(kFull, v, k, group);
        if (k < cnt && has_col) {
          float vh = 0.0f, vl = 0.0f;
          if constexpr (M != kF32) {
            vh = bf16_round(vk);
            if constexpr (M == kSplit) vl = bf16_round(__fsub_rn(vk, vh));
          }
          const float* xr = X + (long long)ck * B + c;
          if constexpr (V == 4) {
            const float4 x4 = __ldg(reinterpret_cast<const float4*>(xr));
            accumulate<M>(acc[0], vk, vh, vl, x4.x);
            accumulate<M>(acc[1], vk, vh, vl, x4.y);
            accumulate<M>(acc[2], vk, vh, vl, x4.z);
            accumulate<M>(acc[3], vk, vh, vl, x4.w);
          } else {
            accumulate<M>(acc[0], vk, vh, vl, __ldg(xr));
          }
        }
      }
    }
    if (has_col) {
      if (diag != nullptr) {
        // no FMA contraction: the same rounding as R X + diag * X
        const float d = diag[row];
        const float* xd = X + (long long)row * B + c;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          acc[i] = __fadd_rn(acc[i], __fmul_rn(d, xd[i]));
        }
      }
      float* yr = Y + (long long)row * B + c;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(yr) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
        yr[0] = acc[0];
      }
    }
  }
}

template <int M, int V>
cudaError_t launch(int n, int B, const int* indptr, const int* indices,
                   const float* vals, const float* X, const float* diag,
                   float* Y, cudaStream_t stream) {
  const int chunks = (B + V - 1) / V;
  int group = 1;
  while (group < chunks && group < 32) group <<= 1;
  const long long rows_per_block = (long long)(kBlock / 32) * (32 / group);
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  csr_spmm_kernel<M, V><<<(unsigned)blocks, kBlock, 0, stream>>>(
      n, B, group, indptr, indices, vals, X, diag, Y);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_mode(int n, int B, const int* indptr, const int* indices,
                        const float* vals, const float* X, const float* diag,
                        float* Y, cudaStream_t stream) {
  const bool vec = B % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(Y) % 16 == 0;
  return vec ? launch<M, 4>(n, B, indptr, indices, vals, X, diag, Y, stream)
             : launch<M, 1>(n, B, indptr, indices, vals, X, diag, Y, stream);
}

}  // namespace

extern "C" {

// Y (n, B) = R X (+ diag[:, None] * X) for the row-sorted CSR
// (indptr, indices, vals) of n rows and X (m, B); `mode` is 0 (F32),
// 1 (SPLIT) or 2 (BF16).  diag may be null; when it is not, X has at least
// n rows.
int slt_csr_spmm(int device, int mode, int n, int B, const int* indptr,
                 const int* indices, const float* vals, const float* X,
                 const float* diag, float* Y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kF32:
      return (int)launch_mode<kF32>(n, B, indptr, indices, vals, X, diag, Y, s);
    case kSplit:
      return (int)launch_mode<kSplit>(n, B, indptr, indices, vals, X, diag, Y,
                                      s);
    case kBf16:
      return (int)launch_mode<kBf16>(n, B, indptr, indices, vals, X, diag, Y,
                                     s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* slt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
