// A bf16 tensor-core GEMM mainloop for the port's kernels: C += A * B over a
// range of K, for one BM x BN block tile, with fp32 accumulators in
// registers.
//
//   - Tensor cores through inline PTX: `ldmatrix` (`.trans` for an operand
//     whose K is not the contiguous axis) and
//     `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`.
//   - A ring of STAGES shared-memory stages filled by `cp.async.cg` (16
//     bytes a thread), STAGES - 1 tiles in flight while the tensor cores
//     work on the oldest. Every shared row is padded by 16 bytes, so the
//     eight row addresses of one `ldmatrix` fall in eight distinct 4-bank
//     groups (no bank conflicts) for the tile widths used here.
//   - A ragged M, N or K edge is zero-filled by `cp.async` with a source
//     size of 0; the epilogue masks its stores.
//   - Operand layouts are template parameters (`Major`), the epilogue is a
//     functor that receives each thread's accumulator pairs with their
//     (row, column), and a per-stage hook may read each landed stage (a
//     column sum of an operand rides along for free).
//   - A row map for a K-major B (the memory row of each of the tile's
//     rows: K6's pw1 interleaves W1's GLU halves per n8 tile through it),
//     and `run_ra`, the mainloop with A already resident in shared memory
//     and only B streamed through the ring (K6's pw2 multiplies a tile the
//     block formed itself).
//   - `warp_mma_k16`, the mainloop's per-warp step on its own: one warp's
//     products over one k-step from tiles a kernel already holds in shared
//     memory, with runtime leading dimensions (K3's dkv kernel uses it), and
//     `warp_mma_k16_ra`, the same with A already in registers (K3's forward
//     keeps q there, and feeds P from its score accumulators).
//
// No CUTLASS / CuTe: the header is self-contained so that the build inside
// chip_smoke.py's time limit stays a few seconds. wgmma and TMA are a later
// step; this is the Ampere-style mainloop, which Hopper runs unchanged.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace espnet {
namespace mma {

using bf16 = __nv_bfloat16;

// Where the reduction axis K lies in memory for an operand X with rows i (M
// for A, N for B): K-major, X(i, k) = p[i * ld + k]; MN-major, X(i, k) =
// p[k * ld + i].
enum class Major { K, MN };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid == false nothing is read and the 16
// bytes are zero-filled (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared (cache-all), zero-filled when valid == false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
// 8 bytes global -> shared (cache-all), zero-filled when valid == false.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  if constexpr (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_u32(p)));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_u32(p)));
  }
}

// A fragment of one m16 x k16 tile at (m, kk): A(m, k) = sa[m * lda + k]
// (AL K-major) or sa[k * lda + m] (MN-major). Row addresses 16-byte aligned.
template <Major AL>
__device__ __forceinline__ void load_a_k16(uint32_t (&a)[4], const bf16* sa, int lda, int m,
                                           int kk) {
  const int lane = threadIdx.x & 31;
  if constexpr (AL == Major::K) {
    // 8x8 matrices (m +0/+8, k +0/+8) in the order of the A fragment.
    ldsm_x4<false>(a, sa + (m + (lane & 15)) * lda + kk + (lane >> 4) * 8);
  } else {
    ldsm_x4<true>(a, sa + (kk + (lane & 7) + (lane >> 4) * 8) * lda + m + ((lane >> 3) & 1) * 8);
  }
}

// B fragments of NT n8 tiles from column n0 over the k-step at kk: B(k, n) =
// sb[n * ldb + k] (BL K-major) or sb[k * ldb + n] (MN-major). NT may be
// odd: the last n8 tile goes through ldmatrix .x2 (its lanes 0-15 give the
// addresses, as for .x4).
template <int NT, Major BL>
__device__ __forceinline__ void load_b_k16(uint32_t (&b)[NT][2], const bf16* sb, int ldb, int n0,
                                           int kk) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    const int n = n0 + j * 8;
    // (n +0, k +0), (n +0, k +8), (n +8, k +0), (n +8, k +8)
    const bf16* pb = BL == Major::K
                         ? sb + (n + (lane & 7) + (lane >> 4) * 8) * ldb + kk + ((lane >> 3) & 1) * 8
                         : sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + n + (lane >> 4) * 8;
    if (j + 1 < NT) {
      uint32_t r[4];
      ldsm_x4<BL == Major::MN>(r, pb);
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    } else {
      ldsm_x2<BL == Major::MN>(b[j], pb);
    }
  }
}

// One warp's products over one k-step of 16, both operands already in
// shared memory with runtime leading dimensions: for i < MT, j < NT,
//   acc[i][j] += A[m0 + i * MSTRIDE : +16, kk : kk + 16] * B[kk : kk + 16, n0 + 8 j : +8]
// with the layouts of load_a_k16 / load_b_k16. acc[i][j][2h + e] is then
// the element (m0 + i * MSTRIDE + lane / 4 + 8 h, n0 + 8 j + 2 (lane % 4) + e).
template <int MT, int NT, Major AL, Major BL, int MSTRIDE = 16>
__device__ __forceinline__ void warp_mma_k16(float (&acc)[MT][NT][4], const bf16* sa, int lda,
                                             const bf16* sb, int ldb, int m0, int n0, int kk) {
  uint32_t a[MT][4];
  uint32_t b[NT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) load_a_k16<AL>(a[i], sa, lda, m0 + i * MSTRIDE, kk);
  load_b_k16<NT, BL>(b, sb, ldb, n0, kk);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
}

// warp_mma_k16 for one m16 tile whose A fragment the warp already holds in
// registers (from load_a_k16, or accumulators packed to bf16: element (g +
// 8 h, 2 t + e + 8 q) of the 16 x 16 tile in half e of a[2 q + h], with g =
// lane / 4 and t = lane % 4): acc[j] += A * B[kk : kk + 16, n0 + 8 j : +8].
template <int NT, Major BL>
__device__ __forceinline__ void warp_mma_k16_ra(float (&acc)[NT][4], const uint32_t (&a)[4],
                                                const bf16* sb, int ldb, int n0, int kk) {
  uint32_t b[NT][2];
  load_b_k16<NT, BL>(b, sb, ldb, n0, kk);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a, b[j][0], b[j][1]);
}

// A per-stage hook that does nothing.
struct NoHook {
  __device__ __forceinline__ void operator()(const bf16*, const bf16*) {}
};

// The row map that changes nothing: a tile's row r is the operand's row r.
struct SameRows {
  __device__ __forceinline__ long operator()(long r) const { return r; }
};

// One block tile of BM x BN over warps of WM x WN (warp w owns rows
// (w / (BN / WN)) * WM and columns (w % (BN / WN)) * WN of the tile), K
// walked in steps of BK through a ring of STAGES shared-memory stages.
template <int BM, int BN, int BK, int WM, int WN, int STAGES, Major AL, Major BL>
struct Gemm {
  static constexpr int kBK = BK;
  static constexpr int kStages = STAGES;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = (BM / WM) * kWarpsN * 32;
  static constexpr int MT = WM / 16;  // m16 tiles per warp
  static constexpr int NT = WN / 8;   // n8 tiles per warp
  static constexpr int kPad = 8;      // 16 bytes of bf16
  // Shared tiles: rows x cols with cols contiguous, padded.
  static constexpr int A_ROWS = AL == Major::K ? BM : BK;
  static constexpr int A_LD = (AL == Major::K ? BK : BM) + kPad;
  static constexpr int B_ROWS = BL == Major::K ? BN : BK;
  static constexpr int B_LD = (BL == Major::K ? BK : BN) + kPad;
  static constexpr int A_ELEMS = A_ROWS * A_LD;
  static constexpr int STAGE_ELEMS = A_ELEMS + B_ROWS * B_LD;
  static constexpr size_t kSmemBytes = (size_t)STAGES * STAGE_ELEMS * sizeof(bf16);
  static_assert(BM % WM == 0 && BN % WN == 0 && WM % 16 == 0 && WN % 16 == 0, "warp tile");
  static_assert(BK % 16 == 0 && STAGES >= 2, "k step");

  using Acc = float[MT][NT][4];

  __device__ __forceinline__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  }

  // rows x cols (cols contiguous, a multiple of 8) of global p (leading
  // dimension ld) from (r0, c0) into the padded shared tile s; a 16-byte
  // chunk with row >= rlim or column >= clim is zero-filled. Tile row r is
  // p's row rows(r0 + r).
  template <int ROWS, int COLS, int LD, class RowMap = SameRows>
  __device__ __forceinline__ static void load_tile(bf16* s, const bf16* p, long ld, long r0,
                                                   long c0, long rlim, long clim,
                                                   const RowMap& rows = RowMap()) {
    constexpr int CH = COLS / 8;
    constexpr int TOTAL = ROWS * CH;
    static_assert(TOTAL % kThreads == 0 || TOTAL < kThreads, "tile chunks per thread");
#pragma unroll
    for (int i = 0; i < (TOTAL + kThreads - 1) / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      if (TOTAL % kThreads != 0 && idx >= TOTAL) break;  // a tile smaller than the block
      const int r = idx / CH;
      const int c = (idx - r * CH) * 8;
      const long gr = r0 + r, gc = c0 + c;
      const bool ok = gr < rlim && gc < clim;
      cp_async16(s + r * LD + c, ok ? p + rows(gr) * ld + gc : p, ok);
    }
  }

  // B's part of a stage at sb <- the K step starting at kb; brows maps the
  // tile's N rows to B's rows (a K-major B only).
  template <class BRows = SameRows>
  __device__ __forceinline__ static void load_b(bf16* sb, const bf16* B, long ldb, long n0,
                                                long nlim, long kb, long klim,
                                                const BRows& brows = BRows()) {
    static_assert(BL == Major::K || std::is_same<BRows, SameRows>::value,
                  "a row map needs a K-major B");
    if constexpr (BL == Major::K) {
      load_tile<BN, BK, B_LD>(sb, B, ldb, n0, kb, nlim, klim, brows);
    } else {
      load_tile<BK, BN, B_LD>(sb, B, ldb, kb, n0, klim, nlim);
    }
  }

  // Stage `slot` <- the K step starting at kb.
  template <class BRows = SameRows>
  __device__ __forceinline__ static void load_stage(bf16* ring, int slot, const bf16* A, long lda,
                                                    const bf16* B, long ldb, long m0, long n0,
                                                    long mlim, long nlim, long kb, long klim,
                                                    const BRows& brows = BRows()) {
    bf16* sa = ring + slot * STAGE_ELEMS;
    bf16* sb = sa + A_ELEMS;
    if constexpr (AL == Major::K) {
      load_tile<BM, BK, A_LD>(sa, A, lda, m0, kb, mlim, klim);
    } else {
      load_tile<BK, BM, A_LD>(sa, A, lda, kb, m0, klim, mlim);
    }
    load_b(sb, B, ldb, n0, nlim, kb, klim, brows);
  }

  // The warp's products over one landed stage.
  __device__ __forceinline__ static void compute_stage(Acc& acc, const bf16* sa, const bf16* sb) {
    const int warp = threadIdx.x >> 5;
    const int wm = (warp / kWarpsN) * WM, wn = (warp % kWarpsN) * WN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      warp_mma_k16<MT, NT, AL, BL>(acc, sa, A_LD, sb, B_LD, wm, wn, kk);
    }
  }

  // acc += A[m0 : m0 + BM, k0 : k1] * B[k0 : k1, n0 : n0 + BN], rows of A
  // past mlim, columns of B past nlim and K past k1 read as zero. `ring`
  // holds kSmemBytes of dynamic shared memory; hook(sa, sb) sees every
  // landed stage before its products. Called by the whole block; ends with
  // the ring free for reuse.
  __device__ __forceinline__ static void run(Acc& acc, bf16* ring, const bf16* A, long lda,
                                             const bf16* B, long ldb, long m0, long n0, long mlim,
                                             long nlim, long k0, long k1) {
    NoHook none;
    run(acc, ring, A, lda, B, ldb, m0, n0, mlim, nlim, k0, k1, none);
  }

  // (Inlined, so that the accumulators stay in registers.) brows: see
  // load_b.
  template <class Hook, class BRows = SameRows>
  __device__ __forceinline__ static void run(Acc& acc, bf16* ring, const bf16* A, long lda,
                                             const bf16* B, long ldb, long m0, long n0, long mlim,
                                             long nlim, long k0, long k1, Hook& hook,
                                             const BRows& brows = BRows()) {
    const int kt_total = k1 > k0 ? (int)((k1 - k0 + BK - 1) / BK) : 0;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < kt_total) {
        load_stage(ring, s, A, lda, B, ldb, m0, n0, mlim, nlim, k0 + (long)s * BK, k1, brows);
      }
      cp_async_commit();
    }
    for (int kt = 0; kt < kt_total; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage kt landed for all; stage kt - 1 read by all
      const int next = kt + STAGES - 1;
      if (next < kt_total) {
        load_stage(ring, next % STAGES, A, lda, B, ldb, m0, n0, mlim, nlim, k0 + (long)next * BK,
                   k1, brows);
      }
      cp_async_commit();
      const bf16* sa = ring + (kt % STAGES) * STAGE_ELEMS;
      hook(sa, sa + A_ELEMS);
      compute_stage(acc, sa, sa + A_ELEMS);
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // Shared bytes of run_ra's ring (B stages only).
  static constexpr int B_ELEMS = B_ROWS * B_LD;
  static constexpr size_t kSmemBytesB = (size_t)STAGES * B_ELEMS * sizeof(bf16);

  // acc += A_s[0 : BM, 0 : k1 - k0] * B[k0 : k1, n0 : n0 + BN] with A already
  // in shared memory (K-major, leading dimension lda_s in elements, 16-byte
  // rows, every column up to k1 - k0 rounded up to BK written) and only B
  // streamed through `ring` (kSmemBytesB). Called by the whole block; ends
  // with the ring free for reuse.
  __device__ __forceinline__ static void run_ra(Acc& acc, bf16* ring, const bf16* sa, int lda_s,
                                                const bf16* B, long ldb, long n0, long nlim,
                                                long k0, long k1) {
    static_assert(AL == Major::K, "a resident A is K-major");
    const int kt_total = k1 > k0 ? (int)((k1 - k0 + BK - 1) / BK) : 0;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < kt_total) load_b(ring + s * B_ELEMS, B, ldb, n0, nlim, k0 + (long)s * BK, k1);
      cp_async_commit();
    }
    const int warp = threadIdx.x >> 5;
    const int wm = (warp / kWarpsN) * WM, wn = (warp % kWarpsN) * WN;
    for (int kt = 0; kt < kt_total; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int next = kt + STAGES - 1;
      if (next < kt_total) {
        load_b(ring + (next % STAGES) * B_ELEMS, B, ldb, n0, nlim, k0 + (long)next * BK, k1);
      }
      cp_async_commit();
      const bf16* sb = ring + (kt % STAGES) * B_ELEMS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        warp_mma_k16<MT, NT, Major::K, BL>(acc, sa + kt * BK, lda_s, sb, B_LD, wm, wn, kk);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // acc[i][j][2h] and acc[i][j][2h + 1] hold the block tile's elements
  // (frag_row(i, h), frag_col(j)) and (frag_row(i, h), frag_col(j) + 1),
  // relative to the tile's origin.
  __device__ __forceinline__ static int frag_row(int i, int h) {
    return ((threadIdx.x >> 5) / kWarpsN) * WM + i * 16 + ((threadIdx.x & 31) >> 2) + h * 8;
  }
  __device__ __forceinline__ static int frag_col(int j) {
    return ((threadIdx.x >> 5) % kWarpsN) * WN + j * 8 + (threadIdx.x & 3) * 2;
  }

  // Calls epi(row, col, v0, v1) for each accumulator pair of the thread
  // (coordinates as frag_row / frag_col; col is even).
  template <class Epi>
  __device__ __forceinline__ static void epilogue(const Acc& acc, Epi&& epi) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          epi(frag_row(i, h), frag_col(j), acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
  }
};

}  // namespace mma
}  // namespace espnet
