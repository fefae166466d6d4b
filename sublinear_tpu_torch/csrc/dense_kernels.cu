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
// order of the product's sums (and, for kPower, of mass's).
//
// One kernel template runs all four, dense_fused_kernel<CB, MODE>, with one
// persistent cooperative launch per call, as the TPU ran one pallas_call
// with A in VMEM.  The grid is about one block per SM (132 on an H100,
// capped by n); block k owns R = ceil(n / grid) consecutive rows and loads
// their slab of A (f32, or the two bf16 halves: 4 bytes per entry either
// way) into dynamic shared memory once, with one cp.async.bulk copy per row
// completing on that row's mbarrier (plain loads where rows are not 16-byte
// aligned), so a warp starts the first product on its row while later rows
// arrive.  n = 768 gives R = 6 over 128 blocks (18.4 KB each), n = 1536
// R = 12 over 128 blocks (73.7 KB).  Rows past the block's shared-memory
// budget (f32 above n ~ 2.6k) are read from global memory every iteration
// in the same kernel.  The rows' per-row and per-entry constants go to
// shared memory once: inv_d and diag (not kPower), and where the block's
// rows of an (n, B) block fit in 16 KB, the Neumann x, the Jacobi b, or the
// power v and dang (else those stay in global memory, x read and written
// only by the thread that owns the entry).  Each product then:
//   1. stages t (x0, or v, for the first product) into shared memory, in
//      chunks of up to 48 KB, each thread with kStageBatch loads in flight,
//      with ld.global.cg: other blocks wrote t since the last barrier, so
//      neither __ldg nor L1 may serve it; the block's own rows of t are kept
//      aside for the epilogue;
//   2. forms each of the block's rows' sums from the slab, one warp per row
//      (16 warps: a block's rows in one round up to n ~ 2.1k), a lane
//      reading four entries as one 16- or 8-byte shared load, reduced by a
//      fixed butterfly: no atomics, so two runs are equal bit for bit;
//   3. runs the epilogue for the block's rows from shared memory alone,
//      writing its result into the other of two ping-pong buffers;
//   4. meets the other blocks at grid.sync().
// One barrier per iteration is enough with two buffers: iteration j reads
// buffer (j - 1) & 1 and writes buffer j & 1; a block that has passed
// barrier j and writes buffer (j + 1) & 1 = (j - 1) & 1 in iteration j + 1
// knows that every block finished reading it, in iteration j, before
// arriving at barrier j.  Neumann: T + 1 products (the init product and T
// steps), T barriers, the term ping-ponged and x written after the last.
// Jacobi and power: T products and T - 1 barriers, x_j ping-ponged with no
// accumulator; the host makes the output one of the two buffers, the one
// the last product writes.  Columns are tiled CB = 1, 4 or 8 at a time
// inside the block.
//
// kPower's mass without a second barrier.  Iteration j needs mass(x_{j-1})
// before its epilogue, and x_{j-1} is complete only at barrier j - 1.  So
// in its epilogue each block also sums dang * x_j over its rows and all its
// column tiles, each thread in a fixed order in f64, then the block in a
// fixed order (each warp's butterfly, then thread 0 adds the warps' sums
// in warp order), and writes this partial to slot [j & 1][blockIdx.x] of a
// small f64 array.  After the barrier every block reads all gridDim.x
// partials of that slot (ld.global.cg, as t is staged): lane l adds
// partials l, l + 32, ... in index order in f64, then a fixed f64
// butterfly; every block does the same operations on the same values, so
// all get the same mass, with no atomics, and two runs are equal bit for
// bit.  The block's last warp does the read after its rows of the first
// chunk (up to n ~ 2.1k it has none), while the others form their sums.
// Two slots are enough for the reason two buffers are: slot j & 1 is
// written in iteration j and read in iteration j + 1, and a block writing
// it again in iteration j + 2 has passed barrier j + 1, which every block
// reached only after its reads of iteration j + 1.  mass(v) of iteration
// 0 needs no barrier: each block sums dang * v over all n * B entries
// itself, in one fixed order, while its slab arrives.
//
// What bounds them on an H100.  The bytes: A once (2.36 MB at n = 768,
// 9.44 MB at n = 1536), 0.7 and 2.8 us at 3.35 TB/s; the products
// (2 n^2 B flops each) take less.  But at these sizes a call is a chain of
// latencies: per iteration an L2 round trip to stage t, the product and its
// syncs, the stores, and a grid barrier.  Measured on an H100 at 700 W
// (times.py --family dense, device time, B = 1): a Neumann call without
// iterations (launch, slab load, init product) takes 3.6 us at n = 768
// (f32) and 6.2 us at n = 1536 (bf16x3); each iteration adds 2.5 and
// 3.3 us.  At n = 1536, B = 1 a Jacobi call of one product takes 5.0 us
// and each further iteration 2.9 us; power 6.2 and 3.2 us (its mass(v)
// and the read of the partials).  So the barrier's round, not the bytes,
// is the floor, for Jacobi and power as for Neumann: all four stay far
// under half of their byte bound (8 iterations at n = 1536: 25 us and
// 29 us against 2.8 us of bytes).
//
// The bf16x3 product runs on f32 FMAs at every B.  A version on bf16
// mma.sync.m16n8k16 tiles (the MXU's arithmetic) was slower at B = 1, where
// 7 of the n8 tile's 8 columns are padding, and faster only from B = 4,
// which the fused solver never passes (PERF.md, open questions).
//
// Interface: plain C, loaded with ctypes.  Each entry point issues the one
// cooperative launch of a call on the given stream, checks the launch's
// error, does not synchronise, allocates nothing, and returns 0 or the CUDA
// error.

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

bool aligned16(const void* q) {
  return q == nullptr || reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

// The epilogue of a call: #6, #7, #8, #9.
enum Mode { kNeumann, kNeumann3, kJacobi, kPower };

constexpr int kWarps = 16;  // a block's rows (up to 16 in one round)
constexpr int kBlock = kWarps * 32;
constexpr int kStageBatch = 4;  // staged loads each thread has in flight
constexpr size_t kXsBytes = 16384;  // an (n, B) block's rows kept in shared
                                    // memory up to this

struct Args {
  int n, B, iters;
  int rows;      // rows per block (the last block may have fewer)
  int resident;  // rows of a block held in shared memory, at most
  int ldn;       // row stride of the slab: n rounded up to 4 entries
  int kc;        // rows of t per staged chunk, a multiple of 4
  int bulk;      // the slab arrives by cp.async.bulk (else plain loads)
  int vec;       // rows read from global take 16- or 8-byte loads
  int xs;        // the block's rows of x (Neumann), b (Jacobi) or v and
                 // dang (power) live in shared memory (else global)
  const float* a;          // f32 A (n, n), row-major; P^T for kPower
  const uint16_t* a_hi;    // bf16x3: the two bf16 halves of A
  const uint16_t* a_lo;
  // kPower has no diagonal: its two operands take those slots, so the
  // struct grows by its two scalars only.  (Grown by 24 bytes, the
  // parameter changed nvcc's code for the Neumann kernels, and #7 ran
  // about 1.5% slower; grown by 8 their code is what it was before Jacobi
  // and power joined them.)
  union {
    const float* diag;     // (n): Neumann and Jacobi
    const float* dang;     // kPower: (n, B)
  };
  union {
    const float* inv_d;    // (n): Neumann and Jacobi
    double* part;          // kPower: 2 x gridDim.x partials of mass
  };
  const float* b;          // (n, B); v for kPower
  const float* x0;         // (n, B): t of the first product (v for kPower)
  float* x;                // (n, B): Neumann's result
  float* t0;               // (n, B) x 2: the ping-pong buffers (Jacobi and
  float* t1;               // power: one of them is the result)
  float one_minus_alpha, alpha;  // kPower
};

__host__ __device__ constexpr size_t round16(size_t v) {
  return (v + 15) / 16 * 16;
}

// Byte offsets in a block's dynamic shared memory, in this order after
// kMaxResident mbarriers: the staged chunk of t (CB columns of kc floats:
// t, or th then tl in CB more); the rows' partial sums (rows x NP x CB, NP
// = 3 for bf16x3, else 1); the rows' own entries of t (rows x CB); inv_d
// and diag of the rows; the rows of x (Neumann), b (Jacobi) or v then dang
// (power), rows x B each, if p.xs; kPower's block sums (kWarps doubles) and
// mass; the slab (resident x ldn floats, or resident x ldn bf16 of a_hi,
// then those of a_lo), 4 bytes an entry either way.
struct Regions {
  size_t ts, part, own, cst, xs, red, slab;
};

template <int CB, int MODE>
__host__ __device__ Regions regions(const Args& p) {
  constexpr bool X3 = MODE == kNeumann3;
  constexpr int NT = X3 ? 2 : 1, NP = X3 ? 3 : 1;
  constexpr int NX = MODE == kPower ? 2 : 1;
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
  o += p.xs ? round16((size_t)NX * p.rows * p.B * 4) : 0;
  g.red = o;
  o += MODE == kPower ? round16(kWarps * 8 + 4) : 0;
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
// row are zero.  Also inv_d and diag of the block's `here` rows into cst
// (not kPower), and b (Jacobi) or v and dang (power) of those rows into xs
// where they fit (p.xs).
template <int MODE>
__device__ void load_slab(const Args& p, unsigned char* slab,
                          uint64_t* bars, float* cst, float* xs, int row0,
                          int here, int res) {
  constexpr bool X3 = MODE == kNeumann3;
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
    for (int i = threadIdx.x; i < res * pad; i += kBlock) {
      const size_t e = (size_t)(i / pad) * ldn + n + i % pad;
      if constexpr (X3) {
        hs[e] = 0;
        ls[e] = 0;
      } else {
        af[e] = 0.0f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < res * ldn; i += kBlock) {
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
  if constexpr (MODE != kPower) {
    for (int r = threadIdx.x; r < here; r += kBlock) {
      cst[r] = __ldg(p.inv_d + row0 + r);
      cst[p.rows + r] = __ldg(p.diag + row0 + r);
    }
  }
  if constexpr (MODE == kJacobi || MODE == kPower) {
    if (p.xs) {
      const size_t e0 = (size_t)row0 * p.B;
      for (int i = threadIdx.x; i < here * p.B; i += kBlock) {
        xs[i] = __ldg(p.b + e0 + i);
        if constexpr (MODE == kPower) {
          xs[p.rows * p.B + i] = __ldg(p.dang + e0 + i);
        }
      }
    }
  }
  __syncthreads();  // the barriers' init, cst (and the plain loads) seen
}

// Stage rows [kbase, kbase + lenp) of columns [col0, col0 + CB) of t:
// column-major, zero past row len or column B; bf16x3 stores th in the
// first CB columns and tl in the next CB.  The block's own rows of t also
// go to own (rows x CB), for the epilogue.  Each thread has kStageBatch
// loads in flight.
template <int CB, bool X3>
__device__ void stage(const Args& p, const float* t, int col0, int kbase,
                      int len, int lenp, float* ts, float* own, int row0,
                      int here) {
  const int B = p.B, kc = p.kc, total = CB * lenp;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBlock * kStageBatch) {
    float v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * kBlock, k = i / CB, c = i % CB;
      v[u] = i < total && k < len && col0 + c < B
                 ? __ldcg(t + (size_t)(kbase + k) * B + col0 + c)
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * kBlock, k = i / CB, c = i % CB;
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
__device__ __forceinline__ void row_sums(const Args& p, const float* af,
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

__device__ __forceinline__ double warp_sum(double s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// The block's sum of each thread's s, in a fixed order: each warp's
// butterfly, then the warps' sums in warp order.  Thread 0 gets the total;
// every thread must call it.
__device__ double block_sum(double s, double* red) {
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) total += red[w];
  }
  return total;
}

// kPower: *mass = the sum of the gridDim.x partials of `slot` that the
// blocks wrote before the last barrier; called by one whole warp.
__device__ void read_mass(const Args& p, int slot, float* mass) {
  const int lane = threadIdx.x & 31;
  const double* q = p.part + (size_t)slot * gridDim.x;
  double s = 0.0;
  for (int k = lane; k < (int)gridDim.x; k += 32) s += __ldcg(q + k);
  s = warp_sum(s);
  if (lane == 0) *mass = (float)s;
}

// The epilogue of the block's rows for columns [col0, col0 + CB), into
// t_out.  Neumann: term into t_out; x in shared memory (p.xs) or global
// memory, into p.x on the last product.  Jacobi and power: the next x into
// t_out; kPower adds dang * x' to msum (not after the last product).
template <int CB, int MODE>
__device__ void epilogue(const Args& p, const float* part, const float* own,
                         const float* cst, float* xs, int row0, int here,
                         int col0, float* t_out, bool init, bool last,
                         float mass, double& msum) {
  constexpr bool X3 = MODE == kNeumann3;
  constexpr int NP = X3 ? 3 : 1;
  for (int i = threadIdx.x; i < here * CB; i += kBlock) {
    const int r = i / CB, c = i % CB, col = col0 + c;
    if (col >= p.B) continue;
    const float* s = part + r * NP * CB + c;
    float prod = s[0];
    if constexpr (X3) prod = __fadd_rn(__fadd_rn(s[0], s[CB]), s[2 * CB]);
    const size_t e = (size_t)(row0 + r) * p.B + col;
    if constexpr (MODE == kJacobi) {
      const float bi = p.xs ? xs[r * p.B + col] : __ldg(p.b + e);
      t_out[e] = __fmul_rn(
          cst[r], __fsub_rn(bi, __fsub_rn(prod, __fmul_rn(cst[p.rows + r],
                                                          own[r * CB + c]))));
    } else if constexpr (MODE == kPower) {
      const float vi = p.xs ? xs[r * p.B + col] : __ldg(p.b + e);
      const float xn = __fadd_rn(
          __fmul_rn(p.one_minus_alpha, vi),
          __fmul_rn(p.alpha, __fadd_rn(prod, __fmul_rn(mass, vi))));
      t_out[e] = xn;
      if (!last) {
        const float di =
            p.xs ? xs[(p.rows + r) * p.B + col] : __ldg(p.dang + e);
        msum += (double)di * (double)xn;
      }
    } else {
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
}

// The whole call: the products j = 0..last, a grid barrier between each
// two (see the note at the top).
template <int CB, int MODE>
__global__ void __launch_bounds__(kBlock, 1) dense_fused_kernel(Args p) {
  constexpr bool X3 = MODE == kNeumann3;
  constexpr bool NEU = MODE == kNeumann || X3;
  constexpr int NP = X3 ? 3 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const Regions g = regions<CB, MODE>(p);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ts = reinterpret_cast<float*>(smem + g.ts);
  float* part = reinterpret_cast<float*>(smem + g.part);
  float* own = reinterpret_cast<float*>(smem + g.own);
  float* cst = reinterpret_cast<float*>(smem + g.cst);
  float* xs = reinterpret_cast<float*>(smem + g.xs);
  double* red = reinterpret_cast<double*>(smem + g.red);  // kPower
  float* mass = reinterpret_cast<float*>(red + kWarps);   // kPower
  unsigned char* slab = smem + g.slab;
  const float* af = reinterpret_cast<const float*>(slab);
  const uint16_t* hs = reinterpret_cast<const uint16_t*>(slab);
  const uint16_t* ls = hs + (size_t)p.resident * p.ldn;

  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * p.rows;
  const int here = min(p.rows, p.n - row0);
  const int res = min(here, p.resident);
  load_slab<MODE>(p, slab, bars, cst, xs, row0, here, res);
  if constexpr (MODE == kPower) {
    // mass(v), the same in every block, while the slab arrives
    double s = 0.0;
    const size_t total = (size_t)p.n * p.B;
    for (size_t i = threadIdx.x; i < total; i += kBlock) {
      s += (double)__ldg(p.dang + i) * (double)__ldg(p.x0 + i);
    }
    s = block_sum(s, red);
    if (threadIdx.x == 0) *mass = (float)s;
  }

  cgr::grid_group grid = cgr::this_grid();
  const int last = NEU ? p.iters : p.iters - 1;
  for (int j = 0; j <= last; ++j) {
    const bool init = j == 0;
    const float* t_in = init ? p.x0 : ((j & 1) ? p.t0 : p.t1);
    float* t_out = (j & 1) ? p.t1 : p.t0;
    double msum = 0.0;  // kPower: this thread's dang * x' in a fixed order
    for (int col0 = 0; col0 < p.B; col0 += CB) {
      for (int kbase = 0; kbase < p.n; kbase += p.kc) {
        const int len = min(p.kc, p.n - kbase);
        const int lenp = (len + 3) / 4 * 4;
        const bool first = kbase == 0;
        __syncthreads();  // the previous chunk has been read
        stage<CB, X3>(p, t_in, col0, kbase, len, lenp, ts, own, row0, here);
        __syncthreads();
        for (int r = warp; r < here; r += kWarps) {
          float acc[NP][CB] = {};
          if (init && p.bulk && r < res) bar_wait(bars + r);
          row_sums<CB, X3>(p, af, hs, ls, ts, r, res, row0 + r, kbase, len,
                           lenp, acc);
          store_sums<CB, NP>(acc, part, r, first);
        }
        if constexpr (MODE == kPower) {
          // the last warp (idle here while here < kWarps) reads mass(x_{j-1})
          if (!init && col0 == 0 && first && warp == kWarps - 1) {
            read_mass(p, (j - 1) & 1, mass);
          }
        }
      }
      __syncthreads();  // every row's sums are in part (and mass is read)
      epilogue<CB, MODE>(p, part, own, cst, xs, row0, here, col0, t_out,
                         init, j == last, MODE == kPower ? *mass : 0.0f,
                         msum);
    }
    if (j < last) {
      if constexpr (MODE == kPower) {
        msum = block_sum(msum, red);
        const size_t slot = (size_t)(j & 1) * gridDim.x;
        if (threadIdx.x == 0) p.part[slot + blockIdx.x] = msum;
      }
      grid.sync();  // t_out (and the partials) complete before they are read
    }
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

// Plan and issue one cooperative launch of dense_fused_kernel<CB, MODE>:
// grid about one block per SM, the rows that fit the block's budget
// resident, the grid checked against the occupancy calculator at the call's
// dynamic shared-memory size.
template <int CB, int MODE>
cudaError_t launch_fused(Args p, int device, cudaStream_t s) {
  constexpr bool X3 = MODE == kNeumann3;
  auto kernel = dense_fused_kernel<CB, MODE>;
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
  const size_t fixed = regions<CB, MODE>(p).slab;
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
             &per_sm, kernel, kBlock, smem)) != cudaSuccess)
      return err;
    cap_it = g_capacity.emplace(std::make_tuple(device, key, smem),
                                per_sm * info.sms).first;
  }
  if (cap_it->second < grid) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(key, grid, kBlock, args, smem, s);
}

template <int MODE>
cudaError_t launch_cols(const Args& p, int device, cudaStream_t s) {
  if (p.B == 1) return launch_fused<1, MODE>(p, device, s);
  if (p.B <= 4) return launch_fused<4, MODE>(p, device, s);
  return launch_fused<8, MODE>(p, device, s);
}

// Jacobi and power: the ping-pong buffers of a call of `iters` products,
// the last of which writes buffer (iters - 1) & 1: that one is x.
void result_buffers(Args& p, int iters, float* x, float* t) {
  float* bufs[2];
  bufs[(iters - 1) & 1] = x;
  bufs[iters & 1] = t;
  p.t0 = bufs[0];
  p.t1 = bufs[1];
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
  Args p{};
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
    err = launch_cols<kNeumann3>(p, device, s);
  } else {
    p.a = static_cast<const float*>(a);
    p.bulk = p.vec = n % 4 == 0 && aligned16(a);
    err = launch_cols<kNeumann>(p, device, s);
  }
  return (int)err;
}

// One call of dense_jacobi_fused (iters >= 1): one cooperative launch of
// iters sweeps from x0.  b, x0: (n, B); diag, inv_d: (n); x receives the
// result; t (n, B) is scratch.
int slt_dense_jacobi(int device, int n, int B, const float* a,
                     const float* diag, const float* inv_d, const float* b,
                     const float* x0, int iters, float* x, float* t,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || B < 1 || iters < 1) return (int)cudaErrorInvalidValue;
  Args p{};
  p.n = n;
  p.B = B;
  p.iters = iters;
  p.a = a;
  p.diag = diag;
  p.inv_d = inv_d;
  p.b = b;
  p.x0 = x0;
  result_buffers(p, iters, x, t);
  p.bulk = p.vec = n % 4 == 0 && aligned16(a);
  return (int)launch_cols<kJacobi>(p, device, (cudaStream_t)stream);
}

// One call of dense_power_fused (iters >= 1): one cooperative launch of
// iters power steps from x = v.  v, dang: (n, B); x receives the result;
// t (n, B) is scratch, and part 2 * n doubles (the grid has at most n
// blocks) of scratch for the partials of mass.
int slt_dense_power(int device, int n, int B, const float* pt,
                    const float* v, const float* dang, float one_minus_alpha,
                    float alpha, int iters, float* x, float* t, double* part,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || B < 1 || iters < 1) return (int)cudaErrorInvalidValue;
  Args p{};
  p.n = n;
  p.B = B;
  p.iters = iters;
  p.a = pt;
  p.b = v;
  p.dang = dang;
  p.x0 = v;
  p.part = part;
  p.one_minus_alpha = one_minus_alpha;
  p.alpha = alpha;
  result_buffers(p, iters, x, t);
  p.bulk = p.vec = n % 4 == 0 && aligned16(pt);
  return (int)launch_cols<kPower>(p, device, (cudaStream_t)stream);
}

const char* slt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
