// Hand-written Hopper (sm_90a) kernels for the dense fused iterations of
// sublinear_tpu_torch/ops/dense_fused.py.
//
// What they replace (Pallas kernels of sublinear_tpu/ops/pallas_kernels.py,
// each of which keeps a dense operator resident in VMEM for T iterations):
//   dense_neumann_fused         T Neumann steps on a dense A;
//   dense_neumann_fused_bf16x3  the same with A = A_hi + A_lo (two bf16
//                               halves) and a three-pass product;
//   dense_jacobi_fused          T Jacobi sweeps on a dense A;
//   dense_power_fused           T PageRank power steps with P^T resident.
// All four are T iterations of one dense product P = A t over an (n, B)
// block of columns, accumulated with f32 FMAs, followed by a short
// elementwise epilogue per entry (i, c):
//   kNeuInit  term = inv_d (b - A x0); x = x0 + term
//   kNeuStep  term' = -inv_d (A term - diag term); x += term'
//   kJacobi   x' = inv_d (b - (A x - diag x))
//   kPower    x' = (1 - alpha) v + alpha (P^T x + mass v), with mass =
//             sum(dang * x) over all n * B entries (columns mixed, as in
//             the Pallas kernel)
// The bf16x3 product is d(a_hi, th) + d(a_hi, tl) + d(a_lo, th): three
// f32 sums added in that order, with th = bf16_rn(t) and
// tl = bf16_rn(t - th) recomputed from t every iteration.  A bf16 x bf16
// product is exact in f32, so f32 FMAs on the converted halves carry out
// the TPU's arithmetic.  The epilogues use __fmul_rn / __fadd_rn, so no
// FMA contraction changes a rounding: the plain PyTorch versions differ
// from these kernels only in the order of the product's sums.
//
// What bounds them on an H100: bytes.  For the path's widest case (n = 1536,
// B = 1, T = 8) A is 9.44 MB, 2.8 us at 3.35 TB/s, while the products are
// 2 n^2 B (T + 1) = 42.5 MFLOP, 0.63 us at 67 TFLOP/s f32 (#7's halves are
// also 9.44 MB together).  The TPU read A from HBM once per call and kept it
// in VMEM.
//
// What this design does (correct and simple first): one launch per
// iteration on one stream, the launch boundary being the grid barrier that
// every iteration needs, since each row's product reads all of t.  t (or x)
// ping-pongs between two buffers.  A block of kWarps warps takes kWarps
// rows, one warp per row; a lane reads four consecutive entries of its row
// per step (one 16-byte load of f32, or one 8-byte load of each bf16 half).
// The block stages the current vector in shared memory in chunks of
// kSmem / CB rows of CB columns, column-major, so that a lane reads its four
// entries of one column as one float4 without bank conflicts; columns are
// tiled CB = 1, 4 or 8 at a time over gridDim.y.  A row count that is not a
// multiple of 4 (or an unaligned A) takes scalar loads.  So A is re-read
// every iteration, from L2 (9.44 MB of its 50 MB at n = 1536), and a call
// sits well above the bound: T + 1 launches of a few microseconds each.
// The design that matches the TPU's, a persistent cooperative grid holding
// A's row slabs in the SMs' shared memory for all T iterations (9.44 MB fits
// in 132 x 227 KB) with one grid barrier per iteration, and bf16 mma/wgmma
// for the bf16x3 product, is later work.
//
// kPower's mass: a one-block launch before each power launch sums dang * x
// in one fixed order (f64 per thread, then a fixed tree) into a float slot
// of its own for that iteration, so every block of the power launch reads
// the same value and the sum does not change from run to run.
//
// Interface: plain C, loaded with ctypes.  Each entry point issues all the
// launches of one call (one block of T iterations, as one pallas_call ran
// it) on the given stream, checks cudaGetLastError() after each launch,
// does not synchronise, allocates nothing, and returns 0 or the CUDA error.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // rows per block, one warp each
constexpr int kBlock = kWarps * 32;
constexpr int kSmem = 4096;            // floats per staged array (16 KB)
constexpr int kMassBlock = 1024;

enum Mode { kNeuInit, kNeuStep, kJacobi, kPower };

struct Args {
  int n, B;
  const float* a;                // f32 A (n, n), row-major
  const uint16_t* a_hi;          // bf16x3: the two bf16 halves of A
  const uint16_t* a_lo;
  const float* diag;             // (n)
  const float* inv_d;            // (n)
  const float* b;                // (n, B); v for kPower
  const float* t_in;             // (n, B): the product's input
  float* t_out;                  // (n, B): term (Neumann) or the next x
  float* x;                      // (n, B): Neumann's running x
  const float* mass;             // kPower: this iteration's slot
  float one_minus_alpha, alpha;  // kPower
};

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const uint16_t* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  // little-endian: entry 0 is the low half of u.x
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const uint16_t* p) {
  return bf16_bits_to_float(__ldg(p));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void fma4(float& acc, const float4 a,
                                     const float4 t) {
  acc = fmaf(a.x, t.x, acc);
  acc = fmaf(a.y, t.y, acc);
  acc = fmaf(a.z, t.z, acc);
  acc = fmaf(a.w, t.w, acc);
}

// One iteration: rows blockIdx.x * kWarps + warp, columns
// blockIdx.y * CB + [0, CB).  X3 selects the bf16x3 product.
template <int CB, int MODE, bool X3>
__global__ void __launch_bounds__(kBlock) dense_iter_kernel(Args p,
                                                            int vec) {
  constexpr int NT = X3 ? 2 : 1;  // staged arrays: t, or th and tl
  constexpr int NP = X3 ? 3 : 1;  // partial sums per column
  constexpr int KC = kSmem / CB;  // rows of t per staged chunk
  __shared__ __align__(16) float ts[NT][kSmem];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = p.n, B = p.B;
  const int row = blockIdx.x * kWarps + warp;
  const int col0 = blockIdx.y * CB;

  float acc[NP][CB];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[q][c] = 0.0f;
  }

  for (int kbase = 0; kbase < n; kbase += KC) {
    const int len = min(KC, n - kbase);
    __syncthreads();  // the previous chunk has been read
    for (int i = threadIdx.x; i < CB * KC; i += kBlock) {
      const int k = i / CB, c = i % CB;
      float v = 0.0f;
      if (k < len && col0 + c < B) {
        v = p.t_in[(size_t)(kbase + k) * B + col0 + c];
      }
      if constexpr (X3) {
        const float hi = bf16_round(v);
        ts[0][c * KC + k] = hi;
        ts[1][c * KC + k] = bf16_round(v - hi);
      } else {
        ts[0][c * KC + k] = v;
      }
    }
    __syncthreads();
    if (row >= n) continue;
    const size_t off = (size_t)row * n + kbase;
    if (vec) {
      // len is a multiple of 4 here (n % 4 == 0, KC % 4 == 0)
      for (int k = lane * 4; k < len; k += 128) {
        if constexpr (X3) {
          const float4 h = load4(p.a_hi + off + k);
          const float4 l = load4(p.a_lo + off + k);
#pragma unroll
          for (int c = 0; c < CB; ++c) {
            const float4 th = *reinterpret_cast<const float4*>(&ts[0][c * KC + k]);
            const float4 tl = *reinterpret_cast<const float4*>(&ts[1][c * KC + k]);
            fma4(acc[0][c], h, th);
            fma4(acc[1][c], h, tl);
            fma4(acc[2][c], l, th);
          }
        } else {
          const float4 a = load4(p.a + off + k);
#pragma unroll
          for (int c = 0; c < CB; ++c) {
            fma4(acc[0][c], a,
                 *reinterpret_cast<const float4*>(&ts[0][c * KC + k]));
          }
        }
      }
    } else {
      for (int k = lane; k < len; k += 32) {
        if constexpr (X3) {
          const float h = load1(p.a_hi + off + k);
          const float l = load1(p.a_lo + off + k);
#pragma unroll
          for (int c = 0; c < CB; ++c) {
            const float th = ts[0][c * KC + k], tl = ts[1][c * KC + k];
            acc[0][c] = fmaf(h, th, acc[0][c]);
            acc[1][c] = fmaf(h, tl, acc[1][c]);
            acc[2][c] = fmaf(l, th, acc[2][c]);
          }
        } else {
          const float a = load1(p.a + off + k);
#pragma unroll
          for (int c = 0; c < CB; ++c) {
            acc[0][c] = fmaf(a, ts[0][c * KC + k], acc[0][c]);
          }
        }
      }
    }
  }
  if (row >= n) return;  // no barrier follows

  // butterfly sums: every lane ends with the same totals
#pragma unroll
  for (int q = 0; q < NP; ++q) {
#pragma unroll
    for (int c = 0; c < CB; ++c) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        acc[q][c] += __shfl_xor_sync(0xffffffffu, acc[q][c], o);
      }
    }
  }

  // lane c finishes column col0 + c
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    if (lane != c || col0 + c >= B) continue;
    float prod = acc[0][c];
    if constexpr (X3) prod = __fadd_rn(__fadd_rn(acc[0][c], acc[1][c]), acc[2][c]);
    const size_t i = (size_t)row * B + col0 + c;
    if constexpr (MODE == kNeuInit) {
      const float term = __fmul_rn(p.inv_d[row], __fsub_rn(p.b[i], prod));
      p.t_out[i] = term;
      p.x[i] = __fadd_rn(p.t_in[i], term);
    } else if constexpr (MODE == kNeuStep) {
      const float t = p.t_in[i];
      const float term = __fmul_rn(-p.inv_d[row],
                                   __fsub_rn(prod, __fmul_rn(p.diag[row], t)));
      p.t_out[i] = term;
      p.x[i] = __fadd_rn(p.x[i], term);
    } else if constexpr (MODE == kJacobi) {
      const float xi = p.t_in[i];
      p.t_out[i] = __fmul_rn(
          p.inv_d[row],
          __fsub_rn(p.b[i], __fsub_rn(prod, __fmul_rn(p.diag[row], xi))));
    } else {
      const float vi = p.b[i];
      p.t_out[i] = __fadd_rn(
          __fmul_rn(p.one_minus_alpha, vi),
          __fmul_rn(p.alpha, __fadd_rn(prod, __fmul_rn(*p.mass, vi))));
    }
  }
}

// *mass = sum(dang * x) over `total` entries, in one fixed order.
__global__ void __launch_bounds__(kMassBlock) mass_kernel(
    long long total, const float* __restrict__ dang,
    const float* __restrict__ x, float* __restrict__ mass) {
  __shared__ double part[kMassBlock];
  double s = 0.0;
  for (long long i = threadIdx.x; i < total; i += kMassBlock) {
    s += (double)dang[i] * (double)x[i];
  }
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = kMassBlock / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *mass = (float)part[0];
}

template <int MODE, bool X3>
cudaError_t launch_iter(const Args& p, int vec, cudaStream_t s) {
  const unsigned rows = (unsigned)((p.n + kWarps - 1) / kWarps);
  if (p.B == 1) {
    dense_iter_kernel<1, MODE, X3><<<dim3(rows, 1), kBlock, 0, s>>>(p, vec);
  } else if (p.B <= 4) {
    dense_iter_kernel<4, MODE, X3><<<dim3(rows, 1), kBlock, 0, s>>>(p, vec);
  } else {
    dense_iter_kernel<8, MODE, X3>
        <<<dim3(rows, (unsigned)((p.B + 7) / 8)), kBlock, 0, s>>>(p, vec);
  }
  return cudaGetLastError();
}

bool aligned16(const void* q) {
  return q == nullptr || reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

Args base_args(int n, int B, const float* diag, const float* inv_d,
               const float* b) {
  Args p{};
  p.n = n;
  p.B = B;
  p.diag = diag;
  p.inv_d = inv_d;
  p.b = b;
  return p;
}

}  // namespace

extern "C" {

// One call of dense_neumann_fused (a_lo == nullptr: a is f32) or of
// dense_neumann_fused_bf16x3 (a and a_lo are the bf16 halves): iters + 1
// launches.  x0, b: (n, B); diag, inv_d: (n); x receives the result; t0 and
// t1 (n, B) are scratch for the ping-ponged term.
int slt_dense_neumann(int device, int n, int B, const void* a,
                      const void* a_lo, const float* diag, const float* inv_d,
                      const float* b, const float* x0, int iters, float* x,
                      float* t0, float* t1, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const bool x3 = a_lo != nullptr;
  Args p = base_args(n, B, diag, inv_d, b);
  if (x3) {
    p.a_hi = static_cast<const uint16_t*>(a);
    p.a_lo = static_cast<const uint16_t*>(a_lo);
  } else {
    p.a = static_cast<const float*>(a);
  }
  p.x = x;
  const int vec = n % 4 == 0 && aligned16(a) && aligned16(a_lo);
  float* bufs[2] = {t0, t1};
  p.t_in = x0;
  p.t_out = bufs[0];
  err = x3 ? launch_iter<kNeuInit, true>(p, vec, s)
           : launch_iter<kNeuInit, false>(p, vec, s);
  if (err != cudaSuccess) return (int)err;
  for (int j = 1; j <= iters; ++j) {
    p.t_in = bufs[(j - 1) & 1];
    p.t_out = bufs[j & 1];
    err = x3 ? launch_iter<kNeuStep, true>(p, vec, s)
             : launch_iter<kNeuStep, false>(p, vec, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// One call of dense_jacobi_fused: iters >= 1 launches; iteration j reads x0
// (j = 0) or its predecessor's buffer and writes x1 (j even) or x2 (j odd).
int slt_dense_jacobi(int device, int n, int B, const float* a,
                     const float* diag, const float* inv_d, const float* b,
                     const float* x0, int iters, float* x1, float* x2,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  Args p = base_args(n, B, diag, inv_d, b);
  p.a = a;
  const int vec = n % 4 == 0 && aligned16(a);
  float* bufs[2] = {x1, x2};
  for (int j = 0; j < iters; ++j) {
    p.t_in = j == 0 ? x0 : bufs[(j - 1) & 1];
    p.t_out = bufs[j & 1];
    err = launch_iter<kJacobi, false>(p, vec, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// One call of dense_power_fused: 2 * iters launches (iters >= 1), starting
// from x = v; buffers as in slt_dense_jacobi; mass holds iters floats of
// scratch, one slot per iteration.
int slt_dense_power(int device, int n, int B, const float* pt,
                    const float* v, const float* dang, float one_minus_alpha,
                    float alpha, int iters, float* x1, float* x2, float* mass,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  Args p = base_args(n, B, nullptr, nullptr, v);
  p.a = pt;
  p.one_minus_alpha = one_minus_alpha;
  p.alpha = alpha;
  const int vec = n % 4 == 0 && aligned16(pt);
  float* bufs[2] = {x1, x2};
  for (int j = 0; j < iters; ++j) {
    p.t_in = j == 0 ? v : bufs[(j - 1) & 1];
    p.t_out = bufs[j & 1];
    p.mass = mass + j;
    mass_kernel<<<1, kMassBlock, 0, s>>>((long long)n * B, dang, p.t_in,
                                         mass + j);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    err = launch_iter<kPower, false>(p, vec, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* slt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
