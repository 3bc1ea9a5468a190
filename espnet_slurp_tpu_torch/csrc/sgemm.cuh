// A float32 GEMM mainloop on the CUDA cores for the port's fp32 kernels: C
// += A * B over a range of K, for one 128 x BN block tile (BN 128 or 64),
// with exact fp32 FMAs (no TF32) into accumulators in registers. K2's and
// K4's fp32 launches (csrc/ffn.cu, ffn_f32; csrc/ctc_head.cu, ctc_head_f32)
// are built on it.
//
//   - 256 threads in a 16 x 16 grid. Thread (ty, tx) owns rows 64 p + 4 ty
//     + i (p < 2, i < 4) and columns 64 q + 4 tx + j (q < BN / 64, j < 4):
//     an 8 x 8 micro-tile (8 x 4 at BN 64) made of 2 x 2 (2 x 1) quads of
//     4 x 4. A warp holds 4 ty x 8 tx.
//   - Both shared tiles are k-major, each k row padded by 4 floats: A as
//     [BK][128 + 4], B as [BK][BN + 4]. Each k step reads the thread's 8 A
//     values and 8 (4) B values as float4s: a warp's loads of one k row
//     touch 4 (A) and 8 (B) distinct float4s, one wavefront each, no bank
//     conflicts. 16 floats loaded per 64 FMAs.
//   - An operand whose K is its contiguous axis (Major::K) is read from
//     global memory as float4s along K into registers, neighbouring lanes
//     along K (a warp reads 64 contiguous bytes of each of 8 rows: whole
//     sectors), and written transposed into its k-major tile; the padding
//     puts those stores at most two to a bank. (Lanes along the rows, 16
//     bytes of each of 32 rows a warp, read half sectors: the launches with
//     a K-major operand took 3-18% longer that way; PERF.md, PR 15.) An
//     operand whose M (or N) is contiguous goes by cp.async, 16 bytes a
//     thread, straight into place.
//   - A 2-stage ring: k tile t + 1's cp.async copies and register loads are
//     in flight while tile t is multiplied; its registers are written to
//     shared memory after the products. One barrier per k tile of 16.
//   - Ragged M, N and K edges are zero-filled, so the products there add
//     nothing; the contiguous axis of each operand must be a multiple of 4
//     (and its pointer 16-byte aligned). The epilogue masks its stores.
//   - Layouts are template parameters (mma_gemm.cuh's Major), the epilogue
//     a functor that receives each thread's accumulators four columns at a
//     time with their (row, column), and a per-stage hook may read each
//     landed stage (dW2's blocks sum g's columns from it). A K-major B may
//     take a row map: the block tile's row n reads B's row brows(n) past
//     the tile's origin (K6's GLU product pairs W1's a and gate rows so).
//
// With 64 (32) accumulators, the fragments and the staged registers a
// thread stays within 128 registers, so two blocks of 256 threads fit an SM
// (33 KB of shared memory each at BN 128).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "mma_gemm.cuh"

namespace espnet {
namespace sgemm {

using mma::Major;
constexpr int kThreads = 256;
constexpr int BM = 128;  // rows of a block tile
constexpr int BK = 16;   // K of a stage

__device__ __forceinline__ int thread_ty() {
  return ((threadIdx.x >> 5) >> 1) * 4 + ((threadIdx.x & 31) >> 3);
}
__device__ __forceinline__ int thread_tx() {
  return ((threadIdx.x >> 5) & 1) * 8 + (threadIdx.x & 7);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A per-stage hook that does nothing.
struct NoHook {
  __device__ __forceinline__ void operator()(const float*, const float*) {}
};

// The row map that changes nothing: tile row i is the operand's row i past
// the tile's origin.
struct SameRows {
  __device__ __forceinline__ int operator()(int i) const { return i; }
};

template <int BN, Major AL, Major BL>
struct Gemm {
  static_assert(BN == 64 || BN == 128, "tile width");
  static constexpr int MI = 8;        // rows a thread
  static constexpr int NQ = BN / 64;  // column quads a thread
  static constexpr int NJ = 4 * NQ;   // columns a thread
  // Shared tile rows are padded by 4 floats: a K-major operand's transposed
  // stores then meet at most two to a bank.
  static constexpr int LDA = BM + 4;  // floats a k row of the A tile
  static constexpr int LDB = BN + 4;  // floats a k row of the B tile
  static constexpr int A_ELEMS = BK * LDA;
  static constexpr int STAGE = A_ELEMS + BK * LDB;  // floats
  static constexpr int kRingFloats = 2 * STAGE;
  // float4s a thread stages through registers per k tile (1 when unused).
  static constexpr int AV = AL == Major::K ? BM * BK / 4 / kThreads : 1;
  static constexpr int BV = BL == Major::K ? BN * BK / 4 / kThreads : 1;
  static_assert(BM * BK / 4 % kThreads == 0 && BN * BK / 4 % kThreads == 0, "chunks a thread");

  using Acc = float[MI][NJ];

  // The block tile's row of acc[i][.] and the column of acc[.][4 q].
  __device__ __forceinline__ static int row(int i) {
    return 64 * (i >> 2) + 4 * thread_ty() + (i & 3);
  }
  __device__ __forceinline__ static int col(int q) { return 64 * q + 4 * thread_tx(); }

  __device__ __forceinline__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  // The k-major tile [BK][LD] of an MN-major operand X(i, k) = p[k * ld +
  // i], p at the block tile's origin, k tile at kb, by cp.async; chunks at
  // or past irem rows or krem of K are zero-filled (reading p itself, which
  // lies inside the operand).
  template <int ROWS, int LD>
  __device__ __forceinline__ static void copy_mn(float* s, const float* p, int ld, int kb,
                                                 int irem, int krem) {
    constexpr int CH = ROWS / 4;
#pragma unroll
    for (int v = 0; v < BK * CH / kThreads; ++v) {
      const int idx = threadIdx.x + v * kThreads;
      const int k = idx / CH;
      const int c = (idx - k * CH) * 4;
      const bool ok = kb + k < krem && c < irem;
      mma::cp_async16(s + k * LD + c, ok ? p + (long)(kb + k) * ld + c : p, ok);
    }
  }

  // A K-major operand X(i, k) = p[i * ld + k], p at the block tile's
  // origin: the thread's float4s along K of the k tile at kb into registers
  // (zero at or past irem rows or krem of K; tile row i reads p's row
  // rows(i)), neighbouring lanes along K (a warp reads 64 contiguous bytes
  // of each of 8 rows) ...
  template <int V, class RowMap = SameRows>
  __device__ __forceinline__ static void fetch_k(float4 (&r)[V], const float* p, int ld, int kb,
                                                 int irem, int krem,
                                                 const RowMap& rows = RowMap()) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int idx = threadIdx.x + v * kThreads;
      const int kq = idx % (BK / 4);
      const int i = idx / (BK / 4);
      const bool ok = i < irem && kb + 4 * kq < krem;
      r[v] = ok ? __ldg(reinterpret_cast<const float4*>(p + (long)rows(i) * ld + kb + 4 * kq))
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  // ... and written transposed into the k-major tile [BK][LD].
  template <int LD, int V>
  __device__ __forceinline__ static void put_k(float* s, const float4 (&r)[V]) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int idx = threadIdx.x + v * kThreads;
      const int kq = idx % (BK / 4);
      const int i = idx / (BK / 4);
      float* d = s + 4 * kq * LD + i;
      d[0] = r[v].x;
      d[LD] = r[v].y;
      d[2 * LD] = r[v].z;
      d[3 * LD] = r[v].w;
    }
  }

  // The block's operands as the mainloop keeps them: pointers at the block
  // tile's origin, leading dimensions, and the rows (M, N) and K left from
  // that origin, as 32-bit values (fewer live registers than 64-bit
  // bounds).
  struct Operands {
    const float* a;
    const float* b;
    int lda, ldb, mrem, nrem, krem;
  };

  // Stage `slot` <- the k tile at kb (relative to the origin): the cp.async
  // part now, the register part into ra / rb (written by put).
  template <class BRows>
  __device__ __forceinline__ static void load_stage(float* ring, int slot, const Operands& o,
                                                    int kb, float4 (&ra)[AV], float4 (&rb)[BV],
                                                    const BRows& brows) {
    float* sa = ring + slot * STAGE;
    float* sb = sa + A_ELEMS;
    if constexpr (AL == Major::K) {
      fetch_k(ra, o.a, o.lda, kb, o.mrem, o.krem);
    } else {
      copy_mn<BM, LDA>(sa, o.a, o.lda, kb, o.mrem, o.krem);
    }
    if constexpr (BL == Major::K) {
      fetch_k(rb, o.b, o.ldb, kb, o.nrem, o.krem, brows);
    } else {
      copy_mn<BN, LDB>(sb, o.b, o.ldb, kb, o.nrem, o.krem);
    }
  }

  __device__ __forceinline__ static void put(float* ring, int slot, const float4 (&ra)[AV],
                                             const float4 (&rb)[BV]) {
    float* sa = ring + slot * STAGE;
    if constexpr (AL == Major::K) put_k<LDA>(sa, ra);
    if constexpr (BL == Major::K) put_k<LDB>(sa + A_ELEMS, rb);
  }

  // The thread's products over one landed stage.
  __device__ __forceinline__ static void compute(Acc& acc, const float* sa, const float* sb) {
    const float* pa = sa + 4 * thread_ty();
    const float* pb = sb + 4 * thread_tx();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[MI], b[NJ];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float4 v = ld4(pa + k * LDA + 64 * p);
        a[4 * p] = v.x, a[4 * p + 1] = v.y, a[4 * p + 2] = v.z, a[4 * p + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 v = ld4(pb + k * LDB + 64 * q);
        b[4 * q] = v.x, b[4 * q + 1] = v.y, b[4 * q + 2] = v.z, b[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  // acc += A[m0 : m0 + 128, k0 : k1] * B[k0 : k1, n0 : n0 + BN]; rows of A
  // at or past mlim, columns of B at or past nlim and K at or past k1 read
  // as zero (m0 < mlim, n0 < nlim; leading dimensions and the extents left
  // from (m0, n0, k0) below 2^31). A(m, k) = A[m * lda + k] (AL K-major) or A[k * lda + m]; B(k,
  // n) = B[n * ldb + k] (BL K-major) or B[k * ldb + n]. `ring` holds
  // kRingFloats floats of 16-byte aligned shared memory; hook(sa, sb) sees
  // every landed stage before its products; a K-major B's tile row n is B's
  // row n0 + brows(n) (nlim - n0 bounds n, not the mapped row). Called by
  // the whole block; ends with the ring free for reuse.
  template <class Hook, class BRows = SameRows>
  __device__ __forceinline__ static void run(Acc& acc, float* ring, const float* A, long lda,
                                             const float* B, long ldb, long m0, long n0,
                                             long mlim, long nlim, long k0, long k1, Hook& hook,
                                             const BRows& brows = BRows()) {
    static_assert(BL == Major::K || std::is_same<BRows, SameRows>::value,
                  "a row map needs a K-major B");
    const int kt_total = k1 > k0 ? (int)((k1 - k0 + BK - 1) / BK) : 0;
    if (kt_total == 0) return;
    // The block tile's origin lies inside both operands (m0 < mlim, n0 <
    // nlim, k0 < k1): zero-filled chunks read it.
    const Operands o{AL == Major::K ? A + m0 * lda + k0 : A + k0 * lda + m0,
                     BL == Major::K ? B + n0 * ldb + k0 : B + k0 * ldb + n0,
                     (int)lda, (int)ldb, (int)(mlim - m0), (int)(nlim - n0), (int)(k1 - k0)};
    float4 ra[AV], rb[BV];
    load_stage(ring, 0, o, 0, ra, rb, brows);
    mma::cp_async_commit();
    put(ring, 0, ra, rb);
    mma::cp_async_wait<0>();
    __syncthreads();
    for (int kt = 0; kt < kt_total; ++kt) {
      const int cur = kt & 1;
      const bool more = kt + 1 < kt_total;
      if (more) load_stage(ring, cur ^ 1, o, (kt + 1) * BK, ra, rb, brows);
      mma::cp_async_commit();
      const float* sa = ring + cur * STAGE;
      hook(sa, sa + A_ELEMS);
      compute(acc, sa, sa + A_ELEMS);
      if (more) put(ring, cur ^ 1, ra, rb);
      mma::cp_async_wait<0>();
      __syncthreads();  // stage kt + 1 landed for all; stage kt read by all
    }
  }

  __device__ __forceinline__ static void run(Acc& acc, float* ring, const float* A, long lda,
                                             const float* B, long ldb, long m0, long n0,
                                             long mlim, long nlim, long k0, long k1) {
    NoHook none;
    run(acc, ring, A, lda, B, ldb, m0, n0, mlim, nlim, k0, k1, none);
  }

  // Calls epi(row, col, v) for each of the thread's rows and column quads,
  // v = acc's four elements (row, col .. col + 3), coordinates relative to
  // the block tile's origin.
  template <class Epi>
  __device__ __forceinline__ static void epilogue(const Acc& acc, Epi&& epi) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        epi(row(i), col(q),
            make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]));
      }
  }
};

}  // namespace sgemm
}  // namespace espnet
