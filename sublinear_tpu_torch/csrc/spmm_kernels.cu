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
// B = 128, X and Y are 51.2 MB each and the ~1.0M entries gather ~0.5 GB.
// X alone fills the 50 MB L2, so while Y is written, a gather over all 128
// columns would miss L2 and go to HBM at random.
//
// What the design does about it:
//   - column slabs: X's columns are cut into slabs of S columns.  For the
//     F32 product S is chosen from the card's L2 size
//     (cudaDevAttrL2CacheSize, queried once per device) so that a slab of X
//     and of Y, (m + n) * S * 4 bytes, takes at most half of L2: S = 32 at
//     n = 100k, so B = 128 runs as four slabs of 12.8 MB of X and 12.8 MB
//     of Y, and B = 8 as one slab.  S is at least 8 columns (a gathered row
//     then fills a 32-byte L2 sector) unless B is narrower, a multiple of 4
//     on the float4 path, and at most 32 lanes' worth of columns.  The two
//     bf16 products take the widest slab instead: they issue ~17
//     instructions per element and are bound by issue, not by L2, and a
//     narrower slab puts several rows of random length in one warp, which
//     then waits for the longest (at n = 100k, B = 128 on an H100 at 700 W,
//     S = 32 made SPLIT 0.224 ms and S = 128 0.179 ms, while F32 took
//     0.102 ms at S = 32 and 0.124 ms at S = 128; sweep_sparse_kernels.py);
//   - slab-major order: one launch numbers its blocks slab by slab, so the
//     rows of one slab run before the next slab starts; its gathers then hit
//     L2, and HBM sees X and Y about once (and the CSR once per slab);
//   - a group of G lanes per row, G the smallest power of two that covers
//     the slab's columns (in float4 chunks when B % 4 == 0 and both X and Y
//     are 16-byte aligned, scalars otherwise); at S = 32 eight lanes own a
//     row, and each gathered row of the slab is one 128-byte line;
//   - gathers in flight: a lane issues the gathers of X for kUnroll = 4
//     entries, and only then accumulates them, in CSR order, with the loop
//     unrolled.  Where a row has at least 4 lanes, each lane loads one
//     (col, val) pair of the row's next `group` entries and the group shares
//     them by __shfl_sync; with 1 or 2 lanes per row (B <= 8 on the float4
//     path) each lane loads the 4 pairs it uses itself, so that 4 gathers
//     are in flight all the same.  At n = 100k on an H100 at 700 W, shared
//     loads took F32 at B = 128 from 0.113 ms (private) to 0.102 ms, and
//     private loads took B = 8 from 0.016 ms (shared) to 0.013 ms
//     (sweep_sparse_kernels.py);
//   - each element of Y is one fmaf chain (or the bf16 products' adds) in
//     CSR order from 0, with no atomics: two runs repeat bit for bit, and
//     the result depends on neither B nor S, so csr_spmm(X)[:, s] equals
//     csr_spmm(X[:, s:s+1].contiguous()) bit for bit.
// What bounds it then: the L2.  At n = 100k, B = 128 (the batch path's
// shape) the gathers move 512 MB from L2 for the 111 MB the product must
// move to and from HBM, and the kernel took 0.103 ms of device time (an
// H100 at 700 W), 32% of the HBM bound; at B = 8, 0.013 ms.  A gathered
// row is reused only where two rows of a block share a column, which the
// random columns of these matrices almost never do.
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
constexpr int kUnroll = 4;   // entries whose gathers are in flight together
constexpr int kMinSlab = 8;  // columns: one 32-byte sector per gathered row
constexpr int kMaxDevices = 64;

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

// V columns of one row of X: a float4 (V = 4) or a scalar (V = 1).
template <int V>
struct Cols {
  float v[V];
};

template <int V>
__device__ __forceinline__ Cols<V> load_cols(const float* p) {
  Cols<V> out;
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    out.v[0] = q.x;
    out.v[1] = q.y;
    out.v[2] = q.z;
    out.v[3] = q.w;
  } else {
    out.v[0] = __ldg(p);
  }
  return out;
}

// acc[0..V) += the products of one stored entry (value v) and the V
// columns xs of its row of X, in mode M.
template <int M, int V>
__device__ __forceinline__ void add_entry(float (&acc)[V], float v,
                                          const Cols<V>& xs) {
  float vh = 0.0f, vl = 0.0f;
  if constexpr (M != kF32) {
    vh = bf16_round(v);
    if constexpr (M == kSplit) vl = bf16_round(__fsub_rn(v, vh));
  }
#pragma unroll
  for (int i = 0; i < V; ++i) accumulate<M>(acc[i], v, vh, vl, xs.v[i]);
}

// V = 4: float4 columns (B % 4 == 0, X and Y 16-byte aligned); V = 1:
// scalar columns.  Block b serves slab b / blocks_per_slab (columns
// [slab * S, slab * S + S) of X and Y) and the kBlock / group rows
// (b % blocks_per_slab) * (kBlock / group) onwards, `group` lanes per row.
// kShare (group >= kUnroll): each lane loads one (col, val) pair of the next
// `group` entries and the group shares them by __shfl_sync, in a loop that
// is warp-uniform; otherwise each lane loads the kUnroll pairs it uses.
template <int M, int V, bool kShare>
__global__ void __launch_bounds__(kBlock) csr_spmm_kernel(
    int n, int B, int S, int group, int blocks_per_slab,
    const int* __restrict__ indptr, const int* __restrict__ indices,
    const float* __restrict__ vals, const float* __restrict__ X,
    const float* __restrict__ diag, float* __restrict__ Y) {
  const int slab = blockIdx.x / blocks_per_slab;
  const int part = blockIdx.x - slab * blocks_per_slab;
  const int gl = threadIdx.x & (group - 1);  // lane within the row's group
  const long long row_ll =
      (long long)part * (kBlock / group) + threadIdx.x / group;
  const int c = slab * S + gl * V;
  const bool has_row = row_ll < n;
  const bool has_col = has_row && gl * V < S && c < B;
  const int row = has_row ? (int)row_ll : 0;
  const int start = has_row ? indptr[row] : 0;
  const int end = has_row ? indptr[row + 1] : 0;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  if constexpr (kShare) {
    for (int base = start; __any_sync(kFull, base < end); base += group) {
      const int j = base + gl;
      const int col = j < end ? __ldg(indices + j) : 0;
      const float v = j < end ? __ldg(vals + j) : 0.0f;
      const int cnt = min(end - base, group);  // this row's (may be <= 0)
      const int steps = __reduce_max_sync(kFull, max(cnt, 0));
      for (int k0 = 0; k0 < steps; k0 += kUnroll) {
        int ck[kUnroll];
        float vk[kUnroll];
        Cols<V> xs[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          ck[u] = __shfl_sync(kFull, col, k0 + u, group);
          vk[u] = __shfl_sync(kFull, v, k0 + u, group);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (has_col && k0 + u < cnt) {
            xs[u] = load_cols<V>(X + (long long)ck[u] * B + c);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (has_col && k0 + u < cnt) add_entry<M, V>(acc, vk[u], xs[u]);
        }
      }
    }
  } else if (has_col) {
    for (int base = start; base < end; base += kUnroll) {
      int col[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        col[u] = base + u < end ? __ldg(indices + base + u) : 0;
        v[u] = base + u < end ? __ldg(vals + base + u) : 0.0f;
      }
      Cols<V> xs[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (base + u < end) {
          xs[u] = load_cols<V>(X + (long long)col[u] * B + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (base + u < end) add_entry<M, V>(acc, v[u], xs[u]);
      }
    }
  }
  if (!has_col) return;
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

// The card's L2 size in bytes, queried once per device (0 if unknown).
int l2_bytes(int device) {
  static int cached[kMaxDevices] = {0};
  if (device >= 0 && device < kMaxDevices && cached[device] > 0) {
    return cached[device];
  }
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrL2CacheSize, device) !=
      cudaSuccess) {
    return 0;
  }
  if (device >= 0 && device < kMaxDevices) cached[device] = bytes;
  return bytes;
}

// The slab width S for X (m, B) and Y (n, B) in V-column chunks: for F32
// the most columns whose X and Y rows, (m + n) * S * 4 bytes, take at most
// half of L2 (l2 bytes), for the bf16 products the widest; a multiple of V,
// within [kMinSlab, 32 * V], and no wider than B.
template <int M, int V>
int slab_width(int m, int n, int B, int l2) {
  long long fit = 32 * V;
  if (M == kF32) fit = (long long)l2 / 2 / (4LL * ((long long)m + n));
  fit = fit / V * V;
  if (fit < kMinSlab) fit = kMinSlab;
  if (fit > 32 * V) fit = 32 * V;
  const int whole = (B + V - 1) / V * V;
  return fit >= whole ? whole : (int)fit;
}

template <int M, int V>
cudaError_t launch(int device, int n, int m, int B, const int* indptr,
                   const int* indices, const float* vals, const float* X,
                   const float* diag, float* Y, cudaStream_t stream) {
  const int S = slab_width<M, V>(m, n, B, l2_bytes(device));
  int group = 1;
  while (group * V < S) group <<= 1;
  const long long rows_per_block = kBlock / group;
  const long long blocks_per_slab = (n + rows_per_block - 1) / rows_per_block;
  const long long slabs = (B + S - 1) / S;
  if (blocks_per_slab * slabs > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(blocks_per_slab * slabs);
  if (group >= kUnroll) {
    csr_spmm_kernel<M, V, true><<<grid, kBlock, 0, stream>>>(
        n, B, S, group, (int)blocks_per_slab, indptr, indices, vals, X, diag,
        Y);
  } else {
    csr_spmm_kernel<M, V, false><<<grid, kBlock, 0, stream>>>(
        n, B, S, group, (int)blocks_per_slab, indptr, indices, vals, X, diag,
        Y);
  }
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_mode(int device, int n, int m, int B, const int* indptr,
                        const int* indices, const float* vals, const float* X,
                        const float* diag, float* Y, cudaStream_t stream) {
  const bool vec = B % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(Y) % 16 == 0;
  return vec ? launch<M, 4>(device, n, m, B, indptr, indices, vals, X, diag,
                            Y, stream)
             : launch<M, 1>(device, n, m, B, indptr, indices, vals, X, diag,
                            Y, stream);
}

}  // namespace

extern "C" {

// Y (n, B) = R X (+ diag[:, None] * X) for the row-sorted CSR
// (indptr, indices, vals) of n rows and X (m, B); `mode` is 0 (F32),
// 1 (SPLIT) or 2 (BF16).  diag may be null; when it is not, m >= n.
int slt_csr_spmm(int device, int mode, int n, int m, int B, const int* indptr,
                 const int* indices, const float* vals, const float* X,
                 const float* diag, float* Y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || m < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kF32:
      return (int)launch_mode<kF32>(device, n, m, B, indptr, indices, vals, X,
                                    diag, Y, s);
    case kSplit:
      return (int)launch_mode<kSplit>(device, n, m, B, indptr, indices, vals,
                                      X, diag, Y, s);
    case kBf16:
      return (int)launch_mode<kBf16>(device, n, m, B, indptr, indices, vals,
                                     X, diag, Y, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* slt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
