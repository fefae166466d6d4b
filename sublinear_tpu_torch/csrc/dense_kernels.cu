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
// All four are iterations of one dense product P = A t over an (n, B) block
// of columns, accumulated with f32 FMAs, followed by a short elementwise
// epilogue per entry (i, c):
//   Neumann init  term = inv_d (b - A x0); x = x0 + term
//   Neumann step  term' = -inv_d (A term - diag term); x += term'
//   kJacobi       x' = inv_d (b - (A x - diag x))
//   kPower        x' = (1 - alpha) v + alpha (P^T x + mass v), with mass =
//                 sum(dang * x) over all n * B entries (columns mixed, as in
//                 the Pallas kernel)
// The bf16x3 product is d(a_hi, th) + d(a_hi, tl) + d(a_lo, th): three f32
// sums added in that order, with th = bf16_rn(t) and tl = bf16_rn(t - th)
// recomputed from t every iteration.  A bf16 x bf16 product is exact in f32,
// so f32 FMAs on the converted halves carry out the TPU's arithmetic.  The
// epilogues use __fmul_rn / __fadd_rn, so no FMA contraction changes a
// rounding: the plain PyTorch versions differ from these kernels only in the
// order of the product's sums.
//
// The two Neumann kernels (#6, #7): one persistent cooperative launch per
// call, dense_neumann_kernel, as the TPU ran one pallas_call with A in VMEM.
// The grid is about one block per SM (132 on an H100, capped by n); block k
// owns R = ceil(n / grid) consecutive rows and loads their slab of A (f32,
// or the two bf16 halves: 4 bytes per entry either way) into dynamic shared
// memory once, with one cp.async.bulk copy per row completing on that row's
// mbarrier (plain loads where rows are not 16-byte aligned), so a warp
// starts the init product on its row while later rows arrive.  n = 768
// gives R = 6 over 128 blocks (18.4 KB each), n = 1536 R = 12 over 128
// blocks (73.7 KB).  Rows past the block's shared-memory
// budget (f32 above n ~ 2.6k) are read from global memory every iteration
// in the same kernel.  inv_d and diag of the block's rows go to shared
// memory once, and so does x of its rows where they fit (16 KB; else x
// stays in global memory, read and written only by the thread that owns the
// entry).  Each of the T + 1 products then:
//   1. stages t (x0 for the init product) into shared memory, in chunks of
//      up to 48 KB, each thread with kStageBatch loads in flight, with
//      ld.global.cg: other blocks wrote t since the last barrier, so neither
//      __ldg nor L1 may serve it; the block's own rows of t are kept aside
//      for the epilogue;
//   2. forms each of the block's rows' sums from the slab, one warp per row
//      (16 warps: a block's rows in one round up to n ~ 2.1k), a lane
//      reading four entries as one 16- or 8-byte shared load, reduced by a
//      fixed butterfly: no atomics, so two runs are equal bit for bit;
//   3. runs the epilogue for the block's rows from shared memory alone,
//      writing term into the other of two ping-pong buffers (and x into
//      global memory after the last product);
//   4. meets the other blocks at grid.sync().
// One barrier per iteration is enough with two term buffers: iteration j
// reads buffer (j - 1) & 1 and writes buffer j & 1; a block that has passed
// barrier j and writes buffer (j + 1) & 1 = (j - 1) & 1 in iteration j + 1
// knows that every block finished reading it, in iteration j, before
// arriving at barrier j.  So a call is T grid barriers and one launch;
// iters = 0 has no barrier.  Columns are tiled CB = 1, 4 or 8 at a time
// inside the block.
//
// What bounds them on an H100.  The bytes: A once (2.36 MB at n = 768,
// 9.44 MB at n = 1536), 0.7 and 2.8 us at 3.35 TB/s; the products
// (2 n^2 B (T + 1) flops) take less.  But at these sizes a call is a chain
// of latencies: per iteration an L2 round trip to stage t, the product and
// its syncs, the stores of term, and a grid barrier.  Measured on an H100
// at 700 W (times.py --family dense, device time, B = 1): a call without
// iterations (launch, slab load, init product) takes 3.6 us at n = 768
// (f32) and 6.2 us at n = 1536 (bf16x3); each iteration adds 2.5 and
// 3.3 us.  So the barrier's round, not the bytes, is the floor.
//
// The bf16x3 product runs on f32 FMAs at every B.  A version on bf16
// mma.sync.m16n8k16 tiles (the MXU's arithmetic) was slower at B = 1, where
// 7 of the n8 tile's 8 columns are padding, and faster only from B = 4,
// which the fused solver never passes (PERF.md, open questions).
//
// Jacobi and power (#8, #9), not yet redesigned: one launch of
// dense_iter_kernel per iteration on one stream, the launch boundary being
// the grid barrier.  A block of kWarps warps takes kWarps rows, one warp per
// row; a lane reads four consecutive entries of its row per step.  The
// block stages the current vector in shared memory in chunks of kSmem / CB
// rows of CB columns, column-major, so that a lane reads its four entries of
// one column as one float4 without bank conflicts; columns are tiled
// CB = 1, 4 or 8 at a time over gridDim.y.  A row count that is not a
// multiple of 4 (or an unaligned A) takes scalar loads.  A is re-read from
// L2 every iteration.  kPower's mass: a one-block launch before each power
// launch sums dang * x in one fixed order (f64 per thread, then a fixed
// tree) into a float slot of its own for that iteration, so every block of
// the power launch reads the same value and the sum does not change from
// run to run.
//
// Interface: plain C, loaded with ctypes.  Each entry point issues all the
// launches of one call on the given stream, checks the launch's error, does
// not synchronise, allocates nothing, and returns 0 or the CUDA error.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cgr = cooperative_groups;

namespace {

constexpr int kWarps = 8;              // rows per block, one warp each
constexpr int kBlock = kWarps * 32;
constexpr int kSmem = 4096;            // dense_iter_kernel: floats per array
constexpr int kMassBlock = 1024;
constexpr int kMaxResident = 64;       // slab rows of a block, one mbarrier
                                       // each
constexpr int kBarBytes = kMaxResident * 8;
constexpr int kVecFloats = 12288;      // staged vector of a chunk: 48 KB

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ float4 bf16x4(const uint2 u) {
  // little-endian: entry 0 is the low half of u.x
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// global loads of A, which no kernel writes: the read-only path
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const uint16_t* p) {
  return bf16x4(__ldg(reinterpret_cast<const uint2*>(p)));
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const uint16_t* p) {
  return bf16_bits_to_float(__ldg(p));
}

// shared-memory reads of the slab and the staged vector
__device__ __forceinline__ float4 smem4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 smem4(const uint16_t* p) {
  return bf16x4(*reinterpret_cast<const uint2*>(p));
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

// ------------------------------------------------- Jacobi and power (#8, #9)

enum Mode { kJacobi, kPower };

struct Args {
  int n, B;
  const float* a;                // A or P^T (n, n), row-major
  const float* diag;             // (n)
  const float* inv_d;            // (n)
  const float* b;                // (n, B); v for kPower
  const float* t_in;             // (n, B): the product's input
  float* t_out;                  // (n, B): the next x
  const float* mass;             // kPower: this iteration's slot
  float one_minus_alpha, alpha;  // kPower
};

// One iteration: rows blockIdx.x * kWarps + warp, columns
// blockIdx.y * CB + [0, CB).
template <int CB, int MODE>
__global__ void __launch_bounds__(kBlock) dense_iter_kernel(Args p,
                                                            int vec) {
  constexpr int KC = kSmem / CB;  // rows of t per staged chunk
  __shared__ __align__(16) float ts[kSmem];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = p.n, B = p.B;
  const int row = blockIdx.x * kWarps + warp;
  const int col0 = blockIdx.y * CB;

  float acc[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) acc[c] = 0.0f;

  for (int kbase = 0; kbase < n; kbase += KC) {
    const int len = min(KC, n - kbase);
    __syncthreads();  // the previous chunk has been read
    for (int i = threadIdx.x; i < CB * KC; i += kBlock) {
      const int k = i / CB, c = i % CB;
      float v = 0.0f;
      if (k < len && col0 + c < B) {
        v = p.t_in[(size_t)(kbase + k) * B + col0 + c];
      }
      ts[c * KC + k] = v;
    }
    __syncthreads();
    if (row >= n) continue;
    const size_t off = (size_t)row * n + kbase;
    if (vec) {
      // len is a multiple of 4 here (n % 4 == 0, KC % 4 == 0)
      for (int k = lane * 4; k < len; k += 128) {
        const float4 a = load4(p.a + off + k);
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          fma4(acc[c], a, *reinterpret_cast<const float4*>(&ts[c * KC + k]));
        }
      }
    } else {
      for (int k = lane; k < len; k += 32) {
        const float a = load1(p.a + off + k);
#pragma unroll
        for (int c = 0; c < CB; ++c) acc[c] = fmaf(a, ts[c * KC + k], acc[c]);
      }
    }
  }
  if (row >= n) return;  // no barrier follows

  // butterfly sums: every lane ends with the same totals
#pragma unroll
  for (int c = 0; c < CB; ++c) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
    }
  }

  // lane c finishes column col0 + c
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    if (lane != c || col0 + c >= B) continue;
    const float prod = acc[c];
    const size_t i = (size_t)row * B + col0 + c;
    if constexpr (MODE == kJacobi) {
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

template <int MODE>
cudaError_t launch_iter(const Args& p, int vec, cudaStream_t s) {
  const unsigned rows = (unsigned)((p.n + kWarps - 1) / kWarps);
  if (p.B == 1) {
    dense_iter_kernel<1, MODE><<<dim3(rows, 1), kBlock, 0, s>>>(p, vec);
  } else if (p.B <= 4) {
    dense_iter_kernel<4, MODE><<<dim3(rows, 1), kBlock, 0, s>>>(p, vec);
  } else {
    dense_iter_kernel<8, MODE>
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

// -------------------------------------------------------- Neumann (#6, #7)

constexpr int kNeuWarps = 16;  // a block's rows (up to 16 in one round)
constexpr int kNeuBlock = kNeuWarps * 32;
constexpr int kStageBatch = 4;  // staged loads each thread has in flight
constexpr size_t kXsBytes = 16384;  // x kept in shared memory up to this

struct NeuArgs {
  int n, B, iters;
  int rows;      // rows per block (the last block may have fewer)
  int resident;  // rows of a block held in shared memory, at most
  int ldn;       // row stride of the slab: n rounded up to 4 entries
  int kc;        // rows of t per staged chunk, a multiple of 4
  int bulk;      // the slab arrives by cp.async.bulk (else plain loads)
  int vec;       // rows read from global take 16- or 8-byte loads
  int xs;        // the block's rows of x live in shared memory (else global)
  const float* a;          // f32 A (n, n), row-major
  const uint16_t* a_hi;    // bf16x3: the two bf16 halves of A
  const uint16_t* a_lo;
  const float* diag;       // (n)
  const float* inv_d;      // (n)
  const float* b;          // (n, B)
  const float* x0;         // (n, B)
  float* x;                // (n, B): the result
  float* t0;               // (n, B) x 2: the ping-ponged term
  float* t1;
};

__host__ __device__ constexpr size_t round16(size_t v) {
  return (v + 15) / 16 * 16;
}

// Byte offsets in a block's dynamic shared memory, in this order after
// kMaxResident mbarriers: the staged chunk of t (CB columns of kc floats:
// t, or th then tl in CB more); the rows' partial sums (rows x NP x CB, NP
// = 3 for bf16x3, else 1); the rows' own entries of t (rows x CB); inv_d
// and diag of the rows; x of the rows (rows x B, if p.xs); the slab
// (resident x ldn floats, or resident x ldn bf16 of a_hi, then those of
// a_lo), 4 bytes an entry either way.
struct Regions {
  size_t ts, part, own, cst, xs, slab;
};

template <int CB, bool X3>
__host__ __device__ Regions regions(const NeuArgs& p) {
  constexpr int NT = X3 ? 2 : 1, NP = X3 ? 3 : 1;
  Regions g;
  size_t o = kBarBytes;
  g.ts = o;
  o += round16((size_t)NT * CB * p.kc * 4);
  g.part = o;
  o += round16((size_t)p.rows * NP * CB * 4);
  g.own = o;
  o += round16((size_t)p.rows * CB * 4);
  g.cst = o;
  o += round16((size_t)p.rows * 2 * 4);
  g.xs = o;
  o += p.xs ? round16((size_t)p.rows * p.B * 4) : 0;
  g.slab = o;
  return g;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the slab row whose copy completes phase 0 of `bar`.
__device__ __forceinline__ void bar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}

// Load the block's `res` slab rows (from row0): one bulk copy per row (two
// for bf16x3) on the row's mbarrier, or plain loads.  Entries [n, ldn) of a
// row are zero.  Also inv_d and diag of the block's `here` rows into cst.
template <bool X3>
__device__ void load_slab(const NeuArgs& p, unsigned char* slab,
                          uint64_t* bars, float* cst, int row0, int here,
                          int res) {
  const int n = p.n, ldn = p.ldn;
  float* af = reinterpret_cast<float*>(slab);
  uint16_t* hs = reinterpret_cast<uint16_t*>(slab);
  uint16_t* ls = hs + (size_t)p.resident * ldn;
  if (p.bulk) {
    if (threadIdx.x == 0) {
      for (int r = 0; r < res; ++r) bar_init(bars + r);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      for (int r = 0; r < res; ++r) {
        const size_t g = (size_t)(row0 + r) * n;
        bar_expect(bars + r, 4u * n);
        if constexpr (X3) {
          bulk_load(hs + (size_t)r * ldn, p.a_hi + g, 2u * n, bars + r);
          bulk_load(ls + (size_t)r * ldn, p.a_lo + g, 2u * n, bars + r);
        } else {
          bulk_load(af + (size_t)r * ldn, p.a + g, 4u * n, bars + r);
        }
      }
    }
    const int pad = ldn - n;  // bytes no copy writes
    for (int i = threadIdx.x; i < res * pad; i += kNeuBlock) {
      const size_t e = (size_t)(i / pad) * ldn + n + i % pad;
      if constexpr (X3) {
        hs[e] = 0;
        ls[e] = 0;
      } else {
        af[e] = 0.0f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < res * ldn; i += kNeuBlock) {
      const int r = i / ldn, k = i % ldn;
      const size_t g = (size_t)(row0 + r) * n + k;
      if constexpr (X3) {
        hs[i] = k < n ? __ldg(p.a_hi + g) : (uint16_t)0;
        ls[i] = k < n ? __ldg(p.a_lo + g) : (uint16_t)0;
      } else {
        af[i] = k < n ? __ldg(p.a + g) : 0.0f;
      }
    }
  }
  for (int r = threadIdx.x; r < here; r += kNeuBlock) {
    cst[r] = __ldg(p.inv_d + row0 + r);
    cst[p.rows + r] = __ldg(p.diag + row0 + r);
  }
  __syncthreads();  // the barriers' init, cst (and the plain loads) seen
}

// Stage rows [kbase, kbase + lenp) of columns [col0, col0 + CB) of t:
// column-major, zero past row len or column B; bf16x3 stores th in the
// first CB columns and tl in the next CB.  The block's own rows of t also
// go to own (rows x CB), for the epilogue.  Each thread has kStageBatch
// loads in flight.
template <int CB, bool X3>
__device__ void stage(const NeuArgs& p, const float* t, int col0, int kbase,
                      int len, int lenp, float* ts, float* own, int row0,
                      int here) {
  const int B = p.B, kc = p.kc, total = CB * lenp;
  for (int i0 = threadIdx.x; i0 < total; i0 += kNeuBlock * kStageBatch) {
    float v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * kNeuBlock, k = i / CB, c = i % CB;
      v[u] = i < total && k < len && col0 + c < B
                 ? __ldcg(t + (size_t)(kbase + k) * B + col0 + c)
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * kNeuBlock, k = i / CB, c = i % CB;
      if (i >= total) break;
      if constexpr (X3) {
        const float hi = bf16_round(v[u]);
        ts[c * kc + k] = hi;
        ts[(CB + c) * kc + k] = bf16_round(v[u] - hi);
      } else {
        ts[c * kc + k] = v[u];
      }
      const int r = kbase + k - row0;
      if (r >= 0 && r < here && k < len) own[r * CB + c] = v[u];
    }
  }
}

template <int CB, bool X3>
__device__ __forceinline__ void fma_step4(float (&acc)[X3 ? 3 : 1][CB],
                                          const float4 h, const float4 l,
                                          const float* ts, int kc, int k) {
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    const float4 th = smem4(ts + c * kc + k);
    if constexpr (X3) {
      const float4 tl = smem4(ts + (CB + c) * kc + k);
      fma4(acc[0][c], h, th);
      fma4(acc[1][c], h, tl);
      fma4(acc[2][c], l, th);
    } else {
      fma4(acc[0][c], h, th);
    }
  }
}

template <int CB, bool X3>
__device__ __forceinline__ void fma_step1(float (&acc)[X3 ? 3 : 1][CB],
                                          float h, float l, const float* ts,
                                          int kc, int k) {
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    const float th = ts[c * kc + k];
    if constexpr (X3) {
      const float tl = ts[(CB + c) * kc + k];
      acc[0][c] = fmaf(h, th, acc[0][c]);
      acc[1][c] = fmaf(h, tl, acc[1][c]);
      acc[2][c] = fmaf(l, th, acc[2][c]);
    } else {
      acc[0][c] = fmaf(h, th, acc[0][c]);
    }
  }
}

// One warp's sums of one row over the staged chunk: from the slab (row r <
// res) or from global memory.
template <int CB, bool X3>
__device__ __forceinline__ void row_sums(const NeuArgs& p, const float* af,
                                         const uint16_t* hs,
                                         const uint16_t* ls, const float* ts,
                                         int r, int res, int grow, int kbase,
                                         int len, int lenp,
                                         float (&acc)[X3 ? 3 : 1][CB]) {
  const int lane = threadIdx.x & 31, kc = p.kc;
  if (r < res) {
    // the slab is zero past n and the chunk past len: lenp % 4 == 0
    const size_t off = (size_t)r * p.ldn + kbase;
    for (int k = lane * 4; k < lenp; k += 128) {
      if constexpr (X3) {
        fma_step4<CB, X3>(acc, smem4(hs + off + k), smem4(ls + off + k), ts,
                          kc, k);
      } else {
        fma_step4<CB, X3>(acc, smem4(af + off + k), float4{}, ts, kc, k);
      }
    }
    return;
  }
  const size_t off = (size_t)grow * p.n + kbase;
  if (p.vec) {
    // len is a multiple of 4 here (n % 4 == 0, kc % 4 == 0)
    for (int k = lane * 4; k < len; k += 128) {
      if constexpr (X3) {
        fma_step4<CB, X3>(acc, load4(p.a_hi + off + k),
                          load4(p.a_lo + off + k), ts, kc, k);
      } else {
        fma_step4<CB, X3>(acc, load4(p.a + off + k), float4{}, ts, kc, k);
      }
    }
  } else {
    for (int k = lane; k < len; k += 32) {
      if constexpr (X3) {
        fma_step1<CB, X3>(acc, load1(p.a_hi + off + k),
                          load1(p.a_lo + off + k), ts, kc, k);
      } else {
        fma_step1<CB, X3>(acc, load1(p.a + off + k), 0.0f, ts, kc, k);
      }
    }
  }
}

// Butterfly-sum a warp's row sums and add them into the row's partials
// (assigned on the first chunk).
template <int CB, int NP>
__device__ __forceinline__ void store_sums(float (&acc)[NP][CB], float* part,
                                           int r, bool first) {
  const int lane = threadIdx.x & 31;
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
#pragma unroll
  for (int q = 0; q < NP; ++q) {
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      if (lane == q * CB + c) {
        float* d = part + (r * NP + q) * CB + c;
        *d = first ? acc[q][c] : *d + acc[q][c];
      }
    }
  }
}

// The epilogue of the block's rows for columns [col0, col0 + CB): term
// into t_out; x in shared memory (p.xs) or global memory, into p.x on the
// last product.
template <int CB, bool X3>
__device__ void epilogue(const NeuArgs& p, const float* part,
                         const float* own, const float* cst, float* xs,
                         int row0, int here, int col0, float* t_out,
                         bool init, bool last) {
  constexpr int NP = X3 ? 3 : 1;
  for (int i = threadIdx.x; i < here * CB; i += kNeuBlock) {
    const int r = i / CB, c = i % CB, col = col0 + c;
    if (col >= p.B) continue;
    const float* s = part + r * NP * CB + c;
    float prod = s[0];
    if constexpr (X3) prod = __fadd_rn(__fadd_rn(s[0], s[CB]), s[2 * CB]);
    const size_t e = (size_t)(row0 + r) * p.B + col;
    float* xe = p.xs ? xs + r * p.B + col : p.x + e;
    float term, x;
    if (init) {
      term = __fmul_rn(cst[r], __fsub_rn(__ldg(p.b + e), prod));
      x = __fadd_rn(__ldg(p.x0 + e), term);
    } else {
      term = __fmul_rn(-cst[r], __fsub_rn(prod, __fmul_rn(cst[p.rows + r],
                                                          own[r * CB + c])));
      x = __fadd_rn(*xe, term);
    }
    t_out[e] = term;
    if (last) {
      p.x[e] = x;
    } else {
      *xe = x;
    }
  }
}

// The whole call: the init product and p.iters steps, a grid barrier
// between each two (see the note at the top).
template <int CB, bool X3>
__global__ void __launch_bounds__(kNeuBlock, 1)
    dense_neumann_kernel(NeuArgs p) {
  constexpr int NP = X3 ? 3 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const Regions g = regions<CB, X3>(p);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ts = reinterpret_cast<float*>(smem + g.ts);
  float* part = reinterpret_cast<float*>(smem + g.part);
  float* own = reinterpret_cast<float*>(smem + g.own);
  float* cst = reinterpret_cast<float*>(smem + g.cst);
  float* xs = reinterpret_cast<float*>(smem + g.xs);
  unsigned char* slab = smem + g.slab;
  const float* af = reinterpret_cast<const float*>(slab);
  const uint16_t* hs = reinterpret_cast<const uint16_t*>(slab);
  const uint16_t* ls = hs + (size_t)p.resident * p.ldn;

  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * p.rows;
  const int here = min(p.rows, p.n - row0);
  const int res = min(here, p.resident);
  load_slab<X3>(p, slab, bars, cst, row0, here, res);

  cgr::grid_group grid = cgr::this_grid();
  for (int j = 0; j <= p.iters; ++j) {
    const bool init = j == 0;
    const float* t_in = init ? p.x0 : ((j & 1) ? p.t0 : p.t1);
    float* t_out = (j & 1) ? p.t1 : p.t0;
    for (int col0 = 0; col0 < p.B; col0 += CB) {
      for (int kbase = 0; kbase < p.n; kbase += p.kc) {
        const int len = min(p.kc, p.n - kbase);
        const int lenp = (len + 3) / 4 * 4;
        const bool first = kbase == 0;
        __syncthreads();  // the previous chunk has been read
        stage<CB, X3>(p, t_in, col0, kbase, len, lenp, ts, own, row0, here);
        __syncthreads();
        for (int r = warp; r < here; r += kNeuWarps) {
          float acc[NP][CB] = {};
          if (init && p.bulk && r < res) bar_wait(bars + r);
          row_sums<CB, X3>(p, af, hs, ls, ts, r, res, row0 + r, kbase, len,
                           lenp, acc);
          store_sums<CB, NP>(acc, part, r, first);
        }
      }
      __syncthreads();  // every row's sums are in part
      epilogue<CB, X3>(p, part, own, cst, xs, row0, here, col0, t_out, init,
                       j == p.iters);
    }
    if (j < p.iters) grid.sync();  // t_out complete before it is staged
  }
}

struct DeviceInfo {
  int sms;
  size_t budget;  // dynamic shared memory a block of the kernel may take
};

std::mutex g_mutex;
// (device, kernel) -> its SM count and budget, with the kernel's
// MaxDynamicSharedMemorySize attribute set to that budget
std::map<std::pair<int, const void*>, DeviceInfo> g_info;
// (device, kernel, dynamic shared bytes) -> blocks resident on the card
std::map<std::tuple<int, const void*, size_t>, int> g_capacity;

// Plan and issue one cooperative launch of dense_neumann_kernel<CB, X3>:
// grid about one block per SM, the rows that fit the block's budget
// resident, the grid checked against the occupancy calculator at the call's
// dynamic shared-memory size.
template <int CB, bool X3>
cudaError_t launch_neumann(NeuArgs p, int device, cudaStream_t s) {
  auto kernel = dense_neumann_kernel<CB, X3>;
  const void* key = reinterpret_cast<const void*>(kernel);
  cudaError_t err;
  std::lock_guard<std::mutex> lock(g_mutex);
  auto it = g_info.find({device, key});
  if (it == g_info.end()) {
    int coop = 0, sms = 0, optin = 0;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                      device)) != cudaSuccess)
      return err;
    if (!coop) return cudaErrorNotSupported;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
        cudaSuccess)
      return err;
    cudaFuncAttributes fa;
    if ((err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) return err;
    const size_t budget = (size_t)optin - fa.sharedSizeBytes;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)budget)) != cudaSuccess)
      return err;
    it = g_info.emplace(std::make_pair(device, key),
                        DeviceInfo{sms, budget}).first;
  }
  const DeviceInfo info = it->second;
  const int n = p.n;
  p.rows = (n + info.sms - 1) / info.sms;
  const int grid = (n + p.rows - 1) / p.rows;
  p.ldn = (n + 3) / 4 * 4;
  const int cap = kVecFloats / ((X3 ? 2 : 1) * CB) / 4 * 4;
  p.kc = std::min(p.ldn, cap);
  p.xs = (size_t)p.rows * p.B * 4 <= kXsBytes;
  const size_t fixed = regions<CB, X3>(p).slab;
  if (fixed > info.budget) return cudaErrorInvalidValue;
  const size_t row_bytes = 4 * (size_t)p.ldn;  // f32, or two bf16
  p.resident = (int)std::min<size_t>(
      {(size_t)p.rows, (size_t)kMaxResident,
       (info.budget - fixed) / row_bytes});
  const size_t smem = fixed + (size_t)p.resident * row_bytes;
  auto cap_it = g_capacity.find({device, key, smem});
  if (cap_it == g_capacity.end()) {
    int per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kNeuBlock, smem)) != cudaSuccess)
      return err;
    cap_it = g_capacity.emplace(std::make_tuple(device, key, smem),
                                per_sm * info.sms).first;
  }
  if (cap_it->second < grid) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(key, grid, kNeuBlock, args, smem, s);
}

template <bool X3>
cudaError_t launch_neumann_cols(const NeuArgs& p, int device,
                                cudaStream_t s) {
  if (p.B == 1) return launch_neumann<1, X3>(p, device, s);
  if (p.B <= 4) return launch_neumann<4, X3>(p, device, s);
  return launch_neumann<8, X3>(p, device, s);
}

}  // namespace

extern "C" {

// One call of dense_neumann_fused (a_lo == nullptr: a is f32) or of
// dense_neumann_fused_bf16x3 (a and a_lo are the bf16 halves): one
// cooperative launch.  x0, b: (n, B); diag, inv_d: (n); x receives the
// result; t0 and t1 (n, B) are scratch for the ping-ponged term.
int slt_dense_neumann(int device, int n, int B, const void* a,
                      const void* a_lo, const float* diag, const float* inv_d,
                      const float* b, const float* x0, int iters, float* x,
                      float* t0, float* t1, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || B < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  const bool x3 = a_lo != nullptr;
  NeuArgs p{};
  p.n = n;
  p.B = B;
  p.iters = iters;
  p.diag = diag;
  p.inv_d = inv_d;
  p.b = b;
  p.x0 = x0;
  p.x = x;
  p.t0 = t0;
  p.t1 = t1;
  cudaStream_t s = (cudaStream_t)stream;
  if (x3) {
    p.a_hi = static_cast<const uint16_t*>(a);
    p.a_lo = static_cast<const uint16_t*>(a_lo);
    const bool al = aligned16(a) && aligned16(a_lo);
    p.bulk = n % 8 == 0 && al;
    p.vec = n % 4 == 0 && al;
    err = launch_neumann_cols<true>(p, device, s);
  } else {
    p.a = static_cast<const float*>(a);
    p.bulk = p.vec = n % 4 == 0 && aligned16(a);
    err = launch_neumann_cols<false>(p, device, s);
  }
  return (int)err;
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
    err = launch_iter<kJacobi>(p, vec, s);
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
    err = launch_iter<kPower>(p, vec, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* slt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
