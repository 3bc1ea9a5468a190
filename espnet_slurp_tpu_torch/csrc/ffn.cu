// Fused position-wise feed-forward: out = dropout(swish(x W1 + b1)) W2 + b2,
// forward and backward (each direction's own notes are at its kernels below).
//
// Replaces the TPU kernel espnet_slurp_tpu/ops/pallas/ffn.py:fused_ffn
// (_fwd_kernel, _bwd_kernel), which runs both macaron FFNs of every Conformer
// block.
//
// What bounds it on the H100: at the flagship shape (N = B*T' ~ 3800 rows,
// D = 256, F = 1024, bf16) the two products are ~4 GFLOP against ~5 MB of
// compulsory traffic (x, W1, W2, out), about 800 FLOP per byte, well above
// the card's ~295 FLOP/byte ridge: the bound is the tensor cores. The plain
// composition instead writes and re-reads an [N, F] hidden (4x the size of x)
// and its activation, which is what the TPU kernel was written to avoid.
//
// Two routes by dtype. bf16 (the flagship's training and serving): the
// register-resident forward ffn_fwd::fwd_kernel, which writes no [N, F]
// hidden, and the tensor-core backward ffn_bwd. float32 (the default
// ASRConfig's training and the fp32 card-against-CPU checks): ffn_f32, five
// launches on the register-tiled fp32 GEMM mainloop of sgemm.cuh, the
// hidden through fp32 scratch for the length of a call.
//
// Dropout on the hidden (the reference's _keep_mask) is drawn in every
// launch that forms the hidden, from philox.cuh, at the element's global
// (row, column): the bf16 kernels per lane with keep8, the fp32 ones (DROP)
// into a byte tile of the block's outputs in shared memory with
// fill_keep_tile. Each such kernel has a rate-0 instantiation without the
// draw.
#include <algorithm>

#include "common.cuh"
#include "mma_gemm.cuh"
#include "philox.cuh"
#include "sgemm.cuh"

namespace espnet {

// ---- Forward, bf16: S, hd and O in registers --------------------------------
//
// Replaces espnet_slurp_tpu/ops/pallas/ffn.py:_fwd_kernel (the pallas_call
// of fused_ffn at :186) in bf16, at its rounding points:
//   s = x W1 + b1 (fp32), h = s sigmoid(s), hd = bf16(keep ? h / (1 - rate)
//   : 0), out = bf16(hd W2 + b2).
// Dropout (DROP): the keep bits of (row n, column f) come from philox.cuh,
// two Philox calls a lane a tile of 32 columns (8 elements each), drawn
// before S's products so that their registers are free again when S is
// live; at rate 0 the kernel is instantiated without them.
//
// Bound: the tensor cores. The two products are 4 N D F operations (D2 = D):
// 31.4 GFLOP at the flagship train shape (N = 64 x 468, D 256, F 1024),
// 0.032 ms at 989 TFLOP/s, against ~16 MB of compulsory traffic (0.005 ms).
//
// Design (K3's register-resident forward, with F in place of the keys): one
// block of 4 warps owns BM = 64 rows of x, kept in shared memory for the
// block's life. Warp w owns rows 16 w .. 16 w + 15 and all D2 output
// columns; their fp32 accumulator O (16 x D2, 128 registers at D2 256) stays
// in registers. The block walks its range of F in tiles of BF = 32:
//   - W1[:, tile] and W2[tile, :] stream through a 2-stage cp.async ring;
//   - S = x W1[:, tile] (16 x 32 a warp) comes from mma.sync into register
//     accumulators, x's A fragments read from shared memory each k-step;
//   - bias and swish are applied there, and hd is rounded to bf16 and packed
//     straight into two A fragments, as the attention forward packs P;
//   - O += hd W2[tile, :] by mma::warp_mma_k16_ra, W2 read as an MN-major B.
// The epilogue adds b2, rounds and stores bf16 pairs. 108,544 B of shared
// memory at D 256, D2 256: two blocks an SM (8 warps).
//
// Occupancy: 64-row tiles give 468 blocks at the train shape and 234 at the
// transducer's, but only 59 at the serving shape (N = 8 x 471) for 132 SMs x
// 2 slots. There the F range is split across blocks (fsplit 2 or 4, chosen
// on the host as the count that needs the fewest waves per unit of work):
// each block writes fp32 partials [fsplit, N, D2] that reduce_kernel sums in
// a fixed order (deterministic) before adding b2 and rounding. Smaller row
// tiles were the other way; they would re-read all of W1 and W2 (1 MB) once
// per 32 rows at every shape, and halve the work that each x load feeds.

namespace ffn_fwd {

constexpr int BM = 64, BF = 32, kWarps = BM / 16, kThreadsFwd = kWarps * 32;
constexpr int LDW1 = BF + 8;  // W1 tile rows: 80 bytes, 8 rows on 8 distinct bank groups

// Shared memory: x [BM][d + 8], then 2 stages of (W1 tile [d][BF + 8], W2
// tile [BF][D2 + 8]), all bf16.
template <int D2>
struct Layout {
  static constexpr int LDW2 = D2 + 8;
  __host__ __device__ static size_t x_elems(int d) { return (size_t)BM * (d + 8); }
  __host__ __device__ static size_t w1_elems(int d) { return (size_t)d * LDW1; }
  __host__ __device__ static size_t stage_elems(int d) {
    return w1_elems(d) + (size_t)BF * LDW2;
  }
  __host__ __device__ static size_t bytes(int d) {
    return sizeof(bf16) * (x_elems(d) + 2 * stage_elems(d));
  }
};

// rows x cols (cols a multiple of 8) of p (leading dimension ld) from (r0,
// c0) into s (leading dimension lds); rows at or past rlim are zero-filled.
__device__ __forceinline__ void load_async(bf16* s, int lds, const bf16* p, long ld, long r0,
                                           long c0, int rows, int cols, long rlim) {
  const int ch = cols >> 3;
  for (int idx = threadIdx.x; idx < rows * ch; idx += kThreadsFwd) {
    const int r = idx / ch;
    const int c = (idx - r * ch) * 8;
    const bool ok = r0 + r < rlim;
    mma::cp_async16(s + r * lds + c, ok ? p + (r0 + r) * ld + c0 + c : p, ok);
  }
}

// Block (row tile, split): O over F range split * (f / nsplit) .. + f /
// nsplit; with nsplit 1 it writes out, else fp32 partials part[split].
template <int D2, bool DROP>
__global__ void __launch_bounds__(kThreadsFwd, 2)
    fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, bf16* __restrict__ out, float* __restrict__ part,
               int n, int d, int f, philox::Dropout drop) {
  using L = Layout<D2>;
  constexpr int NC = D2 / 32;  // chunks of 4 n8 tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ring = xs + L::x_elems(d);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long m0 = (long)blockIdx.x * BM;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int frange = f / nsplit;  // a multiple of BF (the host checks)
  const int fbeg = split * frange;
  const int nft = frange / BF;
  const int ldx = d + 8;
  auto w1s = [&](int slot) { return ring + slot * L::stage_elems(d); };
  auto w2s = [&](int slot) { return ring + slot * L::stage_elems(d) + L::w1_elems(d); };
  auto load_stage = [&](int ft) {
    const long f0 = fbeg + (long)ft * BF;
    load_async(w1s(ft & 1), LDW1, w1, f, 0, f0, d, BF, d);
    load_async(w2s(ft & 1), L::LDW2, w2, D2, f0, 0, BF, D2, f);
  };
  load_async(xs, ldx, x, d, m0, 0, BM, d, n);
  load_stage(0);
  mma::cp_async_commit();
  const uint32_t seed = DROP ? (uint32_t)__ldg(drop.seed) : 0u;
  const uint32_t krow = (uint32_t)(m0 + warp * 16 + g);  // the lane's first row

  float o[NC][4][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][j][e] = 0.0f;

  for (int ft = 0; ft < nft; ++ft) {
    mma::cp_async_wait<0>();
    __syncthreads();  // stage ft (and x) landed; stage ft - 1's readers are done
    if (ft + 1 < nft) load_stage(ft + 1);
    mma::cp_async_commit();
    const bf16* w1t = w1s(ft & 1);
    const bf16* w2t = w2s(ft & 1);
    const int f0 = fbeg + ft * BF;
    // Keep bits of the lane's 16 hidden elements of this tile: n8 tiles
    // (0, 1) in bits 0-7, (2, 3) in bits 8-15.
    uint32_t kb = 0;
    if constexpr (DROP) {
      kb = philox::keep8(seed, 0u, krow, (uint32_t)(f0 + 2 * tq), drop.thr) |
           philox::keep8(seed, 0u, krow, (uint32_t)(f0 + 16 + 2 * tq), drop.thr) << 8;
    }

    float s[1][4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[0][j][e] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < d; kk += 16) {
      mma::warp_mma_k16<1, 4, mma::Major::K, mma::Major::MN>(s, xs, ldx, w1t, LDW1, warp * 16, 0,
                                                             kk);
    }

    // hd = bf16(dropout(swish(s + b1))), element (g + 8 hf, 8 j + 2 tq + e)
    // of the warp's 16 x 32 tile, packed as the A fragments of k-steps j / 2.
    uint32_t a[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(b1 + f0 + 8 * j + 2 * tq);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float s0 = s[0][j][2 * hf] + bb.x, s1 = s[0][j][2 * hf + 1] + bb.y;
        float h0 = s0 / (1.0f + __expf(-s0)), h1 = s1 / (1.0f + __expf(-s1));
        if constexpr (DROP) {
          const uint32_t k8 = kb >> (8 * (j >> 1));
          h0 = philox::kept(k8, hf, j & 1, 0) ? h0 * drop.inv : 0.0f;
          h1 = philox::kept(k8, hf, j & 1, 1) ? h1 * drop.inv : 0.0f;
        }
        __nv_bfloat162 hk = __floats2bfloat162_rn(h0, h1);
        a[j >> 1][2 * (j & 1) + hf] = *reinterpret_cast<uint32_t*>(&hk);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        mma::warp_mma_k16_ra<4, mma::Major::MN>(o[c], a[kk], w2t, L::LDW2, 32 * c, 16 * kk);
      }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const long row = m0 + warp * 16 + g + 8 * hf;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 32 * c + 8 * j + 2 * tq;
        const float v0 = o[c][j][2 * hf], v1 = o[c][j][2 * hf + 1];
        if (nsplit == 1) {
          const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
          *reinterpret_cast<__nv_bfloat162*>(out + row * D2 + col) =
              __floats2bfloat162_rn(v0 + bb.x, v1 + bb.y);
        } else {
          *reinterpret_cast<float2*>(part + ((long)split * n + row) * D2 + col) =
              make_float2(v0, v1);
        }
      }
  }
}

// out = bf16(sum over splits of part + b2), four elements a thread, the
// splits added in order.
__global__ void __launch_bounds__(256)
    reduce_kernel(const float* __restrict__ part, const float* __restrict__ b2,
                  bf16* __restrict__ out, long total, int d2, int nsplit) {
  const long i = ((long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= total) return;
  float4 acc = *reinterpret_cast<const float4*>(part + i);
  for (int sp = 1; sp < nsplit; ++sp) {
    const float4 p = *reinterpret_cast<const float4*>(part + sp * total + i);
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  const float4 bb = *reinterpret_cast<const float4*>(b2 + i % d2);
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(acc.x + bb.x, acc.y + bb.y);
  *reinterpret_cast<__nv_bfloat162*>(out + i + 2) =
      __floats2bfloat162_rn(acc.z + bb.z, acc.w + bb.w);
}

// Sets fwd_kernel<D2, *>'s shared-memory attributes for width d; returns
// its blocks per SM (0: the shape does not fit). Both variants share the
// shared memory and the register cap, so one occupancy serves both.
template <int D2>
int configure(int d) {
  const size_t bytes = Layout<D2>::bytes(d);
  int dev = 0, max_smem = 0, nb = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > (size_t)max_smem) return 0;
  for (auto kernel : {fwd_kernel<D2, false>, fwd_kernel<D2, true>}) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
  }
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, fwd_kernel<D2, false>, kThreadsFwd, bytes);
  return nb;
}

inline bool shape_ok(int n, int d, int f) { return n > 0 && d > 0 && d % 16 == 0 && f % BF == 0; }

// Blocks of fwd_kernel<d2> that fit one SM at width d (the attributes set);
// 0 for an output width it is not built for or a d that does not fit.
inline int blocks_per_sm(int d, int d2) {
  if (d <= 0 || d % 16) return 0;
  switch (d2) {
    case 32: return configure<32>(d);
    case 64: return configure<64>(d);
    case 128: return configure<128>(d);
    case 256: return configure<256>(d);
    default: return 0;
  }
}

// The F split for n rows: the count in {1, 2, 4} that divides F into whole
// tiles and needs the fewest waves per unit of work (ties to the smaller);
// 0 when the kernel cannot take the shape.
inline int splits(int n, int d, int f, int d2) {
  if (!shape_ok(n, d, f)) return 0;
  const int nb = blocks_per_sm(d, d2);
  if (nb <= 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long slots = (long)nb * sms, tiles = (n + BM - 1) / BM;
  int best = 1;
  double best_cost = (double)((tiles + slots - 1) / slots);
  for (int fs = 2; fs <= 4; fs *= 2) {
    if (f % (fs * BF)) continue;
    const double cost = (double)((tiles * fs + slots - 1) / slots) / fs;
    if (cost < best_cost) {
      best = fs;
      best_cost = cost;
    }
  }
  return best;
}

template <int D2>
int launch_d2(const bf16* x, const bf16* w1, const float* b1, const bf16* w2, const float* b2,
              bf16* out, float* part, int nsplit, int n, int d, int f,
              const philox::Dropout& drop, cudaStream_t stream) {
  const dim3 grid((unsigned)((n + BM - 1) / BM), nsplit);
  const size_t bytes = Layout<D2>::bytes(d);
  if (drop.seed) {
    fwd_kernel<D2, true><<<grid, kThreadsFwd, bytes, stream>>>(x, w1, b1, w2, b2, out, part, n, d,
                                                               f, drop);
  } else {
    fwd_kernel<D2, false><<<grid, kThreadsFwd, bytes, stream>>>(x, w1, b1, w2, b2, out, part, n,
                                                                d, f, drop);
  }
  return counted("ffn_fwd::fwd_kernel", D2, drop.seed != nullptr);
}

inline int launch(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                  const float* b2, bf16* out, float* part, int nsplit, int n, int d, int f,
                  int d2, const philox::Dropout& drop, cudaStream_t stream) {
  if (!shape_ok(n, d, f) || nsplit < 1 || f % (nsplit * BF) || (nsplit > 1 && !part)) {
    return (int)cudaErrorInvalidValue;
  }
  if (blocks_per_sm(d, d2) <= 0) return (int)cudaErrorInvalidValue;
  const auto run = [&](auto launch_w) {
    return launch_w(x, w1, b1, w2, b2, out, part, nsplit, n, d, f, drop, stream);
  };
  int err = (int)cudaErrorInvalidValue;
  switch (d2) {
    case 32: err = run(launch_d2<32>); break;
    case 64: err = run(launch_d2<64>); break;
    case 128: err = run(launch_d2<128>); break;
    case 256: err = run(launch_d2<256>); break;
  }
  if (err || nsplit == 1) return err;
  const long total = (long)n * d2;
  reduce_kernel<<<(unsigned)((total / 4 + 255) / 256), 256, 0, stream>>>(part, b2, out, total,
                                                                         d2, nsplit);
  return counted("ffn_fwd::reduce_kernel");
}

}  // namespace ffn_fwd

// ---- Backward, bf16: three tensor-core GEMM kernels -------------------------
//
// Replaces espnet_slurp_tpu/ops/pallas/ffn.py:_bwd_kernel (the pallas_call of
// fused_ffn's core_bwd) in bf16. It computes, with the reference's rounding
// points and fp32 accumulation,
//   s = x W1 + b1; sig = sigmoid(s); hd = bf16(keep ? s sig / (1 - rate) : 0)
//   dW2 = hd^T g; db2 = sum g; dh = keep ? (g W2^T) / (1 - rate) : 0
//   ds = dh sig (1 + s (1 - sig)); dW1 = x^T bf16(ds); db1 = sum ds (fp32);
//   dx = bf16(ds) W1^T.
// Dropout touches only `rows`: it draws the forward's keep bits again
// (philox.cuh, four Philox calls a lane a block) and writes the dropped hd
// and the masked ds, which dx and dw read as they are.
//
// Bound: the tensor cores. The five products are 10 N D F operations (D2 =
// D): 78.5 GFLOP at the flagship train shape (N = 64 x 468, D 256, F 1024),
// 0.0794 ms at 989 TFLOP/s, against ~19 MB of compulsory traffic (0.006 ms
// at 3.35 TB/s).
//
// Why scratch, not the TPU's single pass: the TPU kernel walks row tiles in
// order on one core and sums dW1 / dW2 in VMEM across its grid. 132 SMs
// running blocks in no order cannot carry a sum from block to block, and a
// block that recomputes s and dh for its own dW tile repeats two of the
// five products. So the hidden is formed once, by
// `rows`, and written as two bf16 [N, F] scratch tensors (hd and ds: 2 x 61
// MB at the flagship shape, ~0.07 ms of extra traffic); `dx` and `dw` then
// read them. Every product is the register-accumulator mainloop of
// mma_gemm.cuh fed by a 4-stage cp.async ring:
//   rows  grid (F / 64, N / 128): S = x W1[:, tile] and DH = g W2[tile, :]^T
//         into two 128 x 64 register tiles; the epilogue writes hd and ds
//         (bf16), zeroes rows >= N, and writes the fp32 column sums of ds
//         as one db1 partial per row tile.
//   dx    grid (D / 128, N / 128): DS W1^T, both operands K-contiguous.
//   dw    grid (dW1 tiles + dW2 tiles, S splits of N): dW1 = x^T DS and
//         dW2 = H^T g as 128 x 128 tiles (both operands N-row-major, read
//         through ldmatrix.trans), each split writing fp32 partials; the
//         blocks of dW2's first row of tiles also sum g's columns (db2)
//         from the stages as they land.
// The wrapper sums the partials (deterministic, no atomics). The scratch
// lives only for the call; the forward still keeps no hidden.

namespace ffn_bwd {

using mma::Gemm;
using mma::Major;
constexpr int kStages = 4;
constexpr int kRowTile = 128;  // rows of N per rows / dx block, and per db1 partial
constexpr int kRowsF = 64;     // F columns per rows block
// rows: both products share the warp layout (4 x 2 warps of 32 x 32), so
// their accumulators line up element for element.
using RowsS = Gemm<kRowTile, kRowsF, 32, 32, 32, kStages, Major::K, Major::MN>;
using RowsDH = Gemm<kRowTile, kRowsF, 32, 32, 32, kStages, Major::K, Major::K>;
using Dx = Gemm<kRowTile, 128, 32, 64, 32, kStages, Major::K, Major::K>;
using Dw = Gemm<128, 128, 32, 64, 32, kStages, Major::MN, Major::MN>;
constexpr size_t kRowsSmem =
    RowsS::kSmemBytes > RowsDH::kSmemBytes ? RowsS::kSmemBytes : RowsDH::kSmemBytes;
static_assert(RowsS::kThreads == kThreads && RowsDH::kThreads == kThreads &&
                  Dx::kThreads == kThreads && Dw::kThreads == kThreads,
              "one block shape");

__host__ __device__ constexpr long cdiv(long a, long b) { return (a + b - 1) / b; }

template <bool DROP>
__global__ void __launch_bounds__(kThreads, 2)
    rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const bf16* __restrict__ g, bf16* __restrict__ hd, bf16* __restrict__ ds,
                float* __restrict__ db1p, int n, int d, int f, int d2, philox::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const long n0 = (long)blockIdx.x * kRowsF;
  const long m0 = (long)blockIdx.y * kRowTile;
  // Keep bits of the lane's 32 elements: m16 tile i and n8 tiles (2 jp,
  // 2 jp + 1) in bits 8 (2 i + jp) .. + 7.
  uint32_t kb = 0;
  if constexpr (DROP) {
    const uint32_t seed = (uint32_t)__ldg(drop.seed);
#pragma unroll
    for (int i = 0; i < RowsS::MT; ++i)
#pragma unroll
      for (int jp = 0; jp < RowsS::NT / 2; ++jp) {
        kb |= philox::keep8(seed, 0u, (uint32_t)(m0 + RowsS::frag_row(i, 0)),
                            (uint32_t)(n0 + RowsS::frag_col(2 * jp)), drop.thr)
              << (8 * (2 * i + jp));
      }
  }
  static_assert(RowsS::MT * RowsS::NT / 2 * 8 <= 32, "keep bits in one word");
  RowsS::Acc s, dh;
  RowsS::zero(s);
  RowsS::zero(dh);
  RowsS::run(s, ring, x, d, w1, f, m0, n0, n, f, 0, d);     // x [N, D] . W1 [D, F]
  RowsDH::run(dh, ring, g, d2, w2, d2, m0, n0, n, f, 0, d2);  // g [N, D2] . W2 [F, D2]^T

  float csum[RowsS::NT][2];
#pragma unroll
  for (int j = 0; j < RowsS::NT; ++j) {
    const long c = n0 + RowsS::frag_col(j);
    const bool col_ok = c < f;  // F is a multiple of the tile: always, kept as a guard
    const float bias0 = col_ok ? b1[c] : 0.0f, bias1 = col_ok ? b1[c + 1] : 0.0f;
    csum[j][0] = csum[j][1] = 0.0f;
#pragma unroll
    for (int i = 0; i < RowsS::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long r = m0 + RowsS::frag_row(i, h);
        float hv[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sv = s[i][j][2 * h + e] + (e ? bias1 : bias0);
          const float sig = 1.0f / (1.0f + __expf(-sv));
          float dhv = dh[i][j][2 * h + e];
          hv[e] = sv * sig;
          if constexpr (DROP) {
            const bool keep = philox::kept(kb >> (8 * (2 * i + (j >> 1))), h, j & 1, e);
            hv[e] = keep ? hv[e] * drop.inv : 0.0f;
            dhv = keep ? dhv * drop.inv : 0.0f;
          }
          dv[e] = dhv * sig * (1.0f + sv * (1.0f - sig));
        }
        if (r < n) {
          if (col_ok) {
            *reinterpret_cast<__nv_bfloat162*>(hd + r * f + c) =
                __floats2bfloat162_rn(hv[0], hv[1]);
            *reinterpret_cast<__nv_bfloat162*>(ds + r * f + c) =
                __floats2bfloat162_rn(dv[0], dv[1]);
          }
          csum[j][0] += dv[0];  // rows >= N add nothing
          csum[j][1] += dv[1];
        }
      }
  }
  // Column sums: over the 8 lanes that share a column pair, then over the
  // 4 warps along M through shared memory (the ring is free after run).
  float* red = reinterpret_cast<float*>(smem);  // [4][kRowsF]
  const int warp_m = (threadIdx.x >> 5) / RowsS::kWarpsN;
#pragma unroll
  for (int j = 0; j < RowsS::NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = csum[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if ((threadIdx.x & 31) < 4) red[warp_m * kRowsF + RowsS::frag_col(j) + e] = v;
    }
  __syncthreads();
  if (threadIdx.x < kRowsF && n0 + threadIdx.x < f) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kRowTile / 32; ++w) v += red[w * kRowsF + threadIdx.x];
    db1p[(long)blockIdx.y * f + n0 + threadIdx.x] = v;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    dx_kernel(const bf16* __restrict__ ds, const bf16* __restrict__ w1, bf16* __restrict__ dx,
              int n, int d, int f) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long n0 = (long)blockIdx.x * 128;
  const long m0 = (long)blockIdx.y * kRowTile;
  Dx::Acc acc;
  Dx::zero(acc);
  // DS [N, F] . W1 [D, F]^T
  Dx::run(acc, reinterpret_cast<bf16*>(smem), ds, f, w1, f, m0, n0, n, d, 0, f);
  Dx::epilogue(acc, [&](int r, int c, float v0, float v1) {
    const long row = m0 + r, col = n0 + c;
    if (row < n && col < d) {
      *reinterpret_cast<__nv_bfloat162*>(dx + row * d + col) = __floats2bfloat162_rn(v0, v1);
    }
  });
}

// Column sums of dw's B stage (g rows [BK, 128], MN-major): thread t sums
// column t % 128 over half t / 128 of the stage's rows.
struct ColumnSum {
  bool on;
  float sum;
  __device__ __forceinline__ void operator()(const bf16*, const bf16* sb) {
    if (!on) return;
    const bf16* p = sb + (threadIdx.x >> 7) * 16 * Dw::B_LD + (threadIdx.x & 127);
#pragma unroll
    for (int r = 0; r < 16; ++r) sum += __bfloat162float(p[r * Dw::B_LD]);
  }
};

__global__ void __launch_bounds__(kThreads, 2)
    dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ds, const bf16* __restrict__ hd,
              const bf16* __restrict__ g, float* __restrict__ dw1p, float* __restrict__ dw2p,
              float* __restrict__ db2p, int n, int d, int f, int d2, long kchunk) {
  static_assert(kThreads == 2 * 128 && Dw::B_LD == 128 + 8, "ColumnSum's thread map");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const long split = blockIdx.y;
  const long k0 = split * kchunk, k1 = k0 + kchunk < n ? k0 + kchunk : n;
  const int tiles1 = (int)(cdiv(d, 128) * cdiv(f, 128));
  int t = blockIdx.x;
  Dw::Acc acc;
  Dw::zero(acc);
  long m0, n0, rows, cols;
  float* out;
  ColumnSum db2{false, 0.0f};
  if (t < tiles1) {  // dW1 [D, F] = x^T [D, N] . DS [N, F]
    const int tn = (int)cdiv(f, 128);
    m0 = (long)(t / tn) * 128;
    n0 = (long)(t % tn) * 128;
    rows = d;
    cols = f;
    out = dw1p + split * d * f;
    Dw::run(acc, ring, x, d, ds, f, m0, n0, d, f, k0, k1);
  } else {  // dW2 [F, D2] = H^T [F, N] . g [N, D2]
    t -= tiles1;
    const int tn = (int)cdiv(d2, 128);
    m0 = (long)(t / tn) * 128;
    n0 = (long)(t % tn) * 128;
    rows = f;
    cols = d2;
    out = dw2p + split * f * d2;
    db2.on = m0 == 0;
    Dw::run(acc, ring, hd, f, g, d2, m0, n0, f, d2, k0, k1, db2);
  }
  Dw::epilogue(acc, [&](int r, int c, float v0, float v1) {
    const long row = m0 + r, col = n0 + c;
    if (row < rows && col < cols) {
      *reinterpret_cast<float2*>(out + row * cols + col) = make_float2(v0, v1);
    }
  });
  if (db2.on) {  // block-uniform
    float* red = reinterpret_cast<float*>(smem);  // [2][128]; the ring is free after run
    red[threadIdx.x] = db2.sum;
    __syncthreads();
    if (threadIdx.x < 128 && n0 + threadIdx.x < d2) {
      db2p[split * d2 + n0 + threadIdx.x] = red[threadIdx.x] + red[128 + threadIdx.x];
    }
  }
}

// Launches rows, dx and dw on `stream`; returns the first non-zero
// cudaError_t. db1p holds cdiv(n, kRowTile) partials, dw1p / dw2p / db2p
// nsplit each; hd and ds are [n, f] scratch.
inline int launch(const bf16* x, const bf16* w1, const float* b1, const bf16* w2, const bf16* g,
                  bf16* dx, bf16* hd, bf16* ds, float* dw1p, float* db1p, float* dw2p,
                  float* db2p, int nsplit, int n, int d, int f, int d2,
                  const philox::Dropout& drop, cudaStream_t stream) {
  const long row_tiles = cdiv(n, kRowTile);
  if (n <= 0 || d % 16 || d2 % 16 || f % kRowsF || nsplit <= 0 || nsplit > 65535 ||
      row_tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long kchunk = cdiv(cdiv(n, nsplit), 32) * 32;
  const auto rows = drop.seed ? rows_kernel<true> : rows_kernel<false>;
  cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kRowsSmem);
  cudaFuncSetAttribute(dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)Dx::kSmemBytes);
  cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)Dw::kSmemBytes);
  rows<<<dim3((unsigned)cdiv(f, kRowsF), (unsigned)row_tiles), kThreads, kRowsSmem, stream>>>(
      x, w1, b1, w2, g, hd, ds, db1p, n, d, f, d2, drop);
  if (int err = counted("ffn_bwd::rows_kernel", drop.seed != nullptr)) return err;
  dx_kernel<<<dim3((unsigned)cdiv(d, 128), (unsigned)row_tiles), kThreads, Dx::kSmemBytes,
              stream>>>(ds, w1, dx, n, d, f);
  if (int err = counted("ffn_bwd::dx_kernel")) return err;
  const long tiles = cdiv(d, 128) * cdiv(f, 128) + cdiv(f, 128) * cdiv(d2, 128);
  dw_kernel<<<dim3((unsigned)tiles, (unsigned)nsplit), kThreads, Dw::kSmemBytes, stream>>>(
      x, ds, hd, g, dw1p, dw2p, db2p, n, d, f, d2, kchunk);
  return counted("ffn_bwd::dw_kernel");
}

}  // namespace ffn_bwd

// ---- float32: five launches on a register-tiled fp32 GEMM mainloop ---------
//
// Replaces espnet_slurp_tpu/ops/pallas/ffn.py:_fwd_kernel and _bwd_kernel
// (the pallas_calls of fused_ffn at :186 and :206) in float32: the route of
// the default ASRConfig's training and of the fp32 card-against-CPU checks.
// Exact fp32 (FMAs, no TF32), with keep the forward's mask:
//   forward   hd = keep ? swish(x W1 + b1) / (1 - rate) : 0; out = hd W2 + b2
//   backward  s = x W1 + b1, sig = sigmoid(s), hd as above, dh = keep ?
//             (g W2^T) / (1 - rate) : 0, ds = dh sig (1 + s (1 - sig));
//             dx = ds W1^T, dW1 = x^T ds, db1 = sum ds, dW2 = hd^T g,
//             db2 = sum g.
//
// Bound: the fp32 units. Each product is 2 N D F operations (D2 = D): 31.4
// GFLOP at the default ASRConfig's train shape (N = 64 x 468, D 256, F
// 2048), 0.469 ms at 67 TFLOP/s. The forward is 2 products (0.94 ms), the
// backward 5 (2.34 ms), against ~16 and ~33 MB of compulsory traffic (0.005
// and 0.01 ms at 3.35 TB/s).
//
// Design: every product is sgemm.cuh's mainloop (128-row block tiles, 8 x 8
// register micro-tiles of FMAs, a 2-stage ring, one barrier per 16 of K),
// and the [N, F] hidden goes through fp32 scratch that the wrapper holds for
// the call, as the bf16 backward's does (245 MB in the forward and 2 x 245
// in the backward at that shape: ~0.15 and ~0.4 ms of traffic against at
// least 0.94 and 2.34 ms of products). Five launches, five products where
// a kernel that recomputed s and dh for each of dx and dW would form seven:
//   hidden  1-D grid of (N / 128) x (F / 128) tiles: S = x W1; the epilogue
//           adds b1, applies swish and the mask, and writes hd.
//   out     (N / 128) x (D2 / 128) tiles: hd W2 + b2.
//   rows    (N / 128) x (F / 64) tiles: S = x W1 and DH = g W2^T into two
//           8 x 4 micro-tiles a thread; the epilogue writes hd and ds and the
//           tile's column sums of ds as one db1 partial per row tile.
//   dx      (N / 128) x (D / 128) tiles: DS W1^T.
//   dw      grid (dW1 tiles + dW2 tiles, S splits of N): x^T DS and hd^T g,
//           both operands N-row-major (cp.async), fp32 partials per split;
//           dW2's blocks of its first row of tiles also sum g's columns (db2)
//           from the stages as they land.
// The wrapper sums the partials in a fixed order (deterministic, no
// atomics); the autograd forward keeps no hidden, and the backward forms it
// again, as the TPU kernel does. The keep bits come from fill_keep_tile into
// a byte tile of the block's outputs in the freed ring (one Philox call per
// 8 elements). No shared memory grows with D or F: every width whose
// contiguous axes are multiples of 16 (D, D2) and 32 (F) is taken, d_model
// 512 / d_ff 2048 too.

namespace ffn_f32 {

using ffn_bwd::cdiv;
using mma::Major;
constexpr int BM = sgemm::BM;  // rows of N a block; rows of a db1 partial
constexpr int BN = 128;        // columns of every block tile but rows'
constexpr int kRowsF = 64;     // F columns of a rows block
using Wide = sgemm::Gemm<BN, Major::K, Major::MN>;       // x W1, hd W2
using RowsS = sgemm::Gemm<kRowsF, Major::K, Major::MN>;  // x W1
using RowsDH = sgemm::Gemm<kRowsF, Major::K, Major::K>;  // g W2^T
using Dx = sgemm::Gemm<BN, Major::K, Major::K>;          // DS W1^T
using Dw = sgemm::Gemm<BN, Major::MN, Major::MN>;        // x^T DS, hd^T g
static_assert(RowsS::kRingFloats == RowsDH::kRingFloats, "one ring for both products");
static_assert(BM == ffn_bwd::kRowTile, "one db1 partial per 128 rows in both dtypes");

template <bool DROP>
__global__ void __launch_bounds__(sgemm::kThreads, 2)
    hidden_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, float* __restrict__ hd, int n, int d, int f,
                  philox::Dropout drop) {
  __shared__ __align__(16) float ring[Wide::kRingFloats];
  const long tn = cdiv(f, BN);
  const long m0 = (long)(blockIdx.x / tn) * BM, n0 = (long)(blockIdx.x % tn) * BN;
  Wide::Acc acc;
  Wide::zero(acc);
  Wide::run(acc, ring, x, d, w1, f, m0, n0, n, f, 0, d);  // x [N, D] . W1 [D, F]
  unsigned char* keep = reinterpret_cast<unsigned char*>(ring);  // [BM][BN], DROP only
  if constexpr (DROP) {
    philox::fill_keep_tile<BM, BN>(keep, BN, (uint32_t)__ldg(drop.seed), 0u, (uint32_t)m0,
                                   (uint32_t)n0, drop.thr);
    __syncthreads();
  }
  Wide::epilogue(acc, [&](int r, int c, float4 v) {
    const long row = m0 + r, col = n0 + c;
    if (row >= n || col >= f) return;
    const float4 bb = sgemm::ld4(b1 + col);
    float h[4] = {v.x + bb.x, v.y + bb.y, v.z + bb.z, v.w + bb.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[e] = h[e] / (1.0f + expf(-h[e]));
      if constexpr (DROP) h[e] = keep[r * BN + c + e] ? h[e] * drop.inv : 0.0f;
    }
    *reinterpret_cast<float4*>(hd + row * f + col) = make_float4(h[0], h[1], h[2], h[3]);
  });
}

__global__ void __launch_bounds__(sgemm::kThreads, 2)
    out_kernel(const float* __restrict__ hd, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ out, int n, int f, int d2) {
  __shared__ __align__(16) float ring[Wide::kRingFloats];
  const long tn = cdiv(d2, BN);
  const long m0 = (long)(blockIdx.x / tn) * BM, n0 = (long)(blockIdx.x % tn) * BN;
  Wide::Acc acc;
  Wide::zero(acc);
  Wide::run(acc, ring, hd, f, w2, d2, m0, n0, n, d2, 0, f);  // hd [N, F] . W2 [F, D2]
  Wide::epilogue(acc, [&](int r, int c, float4 v) {
    const long row = m0 + r, col = n0 + c;
    if (row >= n || col >= d2) return;
    const float4 bb = sgemm::ld4(b2 + col);
    *reinterpret_cast<float4*>(out + row * d2 + col) =
        make_float4(v.x + bb.x, v.y + bb.y, v.z + bb.z, v.w + bb.w);
  });
}

template <bool DROP>
__global__ void __launch_bounds__(sgemm::kThreads, 2)
    rows_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ g, float* __restrict__ hd, float* __restrict__ ds,
                float* __restrict__ db1p, int n, int d, int f, int d2, philox::Dropout drop) {
  __shared__ __align__(16) float ring[RowsS::kRingFloats];
  __shared__ float red[4][kRowsF];
  const long tn = cdiv(f, kRowsF);
  const long tile = blockIdx.x / tn;
  const long m0 = tile * BM, n0 = (long)(blockIdx.x % tn) * kRowsF;
  RowsS::Acc s, dh;
  RowsS::zero(s);
  RowsS::zero(dh);
  RowsS::run(s, ring, x, d, w1, f, m0, n0, n, f, 0, d);      // x [N, D] . W1 [D, F]
  RowsDH::run(dh, ring, g, d2, w2, d2, m0, n0, n, f, 0, d2);  // g [N, D2] . W2 [F, D2]^T
  unsigned char* keep = reinterpret_cast<unsigned char*>(ring);  // [BM][kRowsF], DROP only
  if constexpr (DROP) {
    philox::fill_keep_tile<BM, kRowsF>(keep, kRowsF, (uint32_t)__ldg(drop.seed), 0u,
                                       (uint32_t)m0, (uint32_t)n0, drop.thr);
    __syncthreads();
  }
  const int c = RowsS::col(0);
  const long col = n0 + c;
  float csum[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // the thread's rows < N
  if (col < f) {
    const float4 bb = sgemm::ld4(b1 + col);
    const float bias[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
    for (int i = 0; i < RowsS::MI; ++i) {
      const int r = RowsS::row(i);
      const long row = m0 + r;
      if (row >= n) continue;
      float hv[4], dv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = s[i][e] + bias[e];
        const float sig = 1.0f / (1.0f + expf(-sv));
        float dhv = dh[i][e];
        hv[e] = sv * sig;
        if constexpr (DROP) {
          const bool kept = keep[r * kRowsF + c + e];
          hv[e] = kept ? hv[e] * drop.inv : 0.0f;
          dhv = kept ? dhv * drop.inv : 0.0f;
        }
        dv[e] = dhv * (sig * (1.0f + sv * (1.0f - sig)));
        csum[e] += dv[e];
      }
      *reinterpret_cast<float4*>(hd + row * f + col) = make_float4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<float4*>(ds + row * f + col) = make_float4(dv[0], dv[1], dv[2], dv[3]);
    }
  }
  // Column sums: over the 4 lanes of a warp that share tx, then over the 4
  // warp rows (ty groups) through shared memory, in a fixed order.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v = csum[e];
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (lane < 8) red[warp >> 1][c + e] = v;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < kRowsF && n0 + t < f) {
    db1p[tile * f + n0 + t] = red[0][t] + red[1][t] + red[2][t] + red[3][t];
  }
}

__global__ void __launch_bounds__(sgemm::kThreads, 2)
    dx_kernel(const float* __restrict__ ds, const float* __restrict__ w1, float* __restrict__ dx,
              int n, int d, int f) {
  __shared__ __align__(16) float ring[Dx::kRingFloats];
  const long tn = cdiv(d, BN);
  const long m0 = (long)(blockIdx.x / tn) * BM, n0 = (long)(blockIdx.x % tn) * BN;
  Dx::Acc acc;
  Dx::zero(acc);
  Dx::run(acc, ring, ds, f, w1, f, m0, n0, n, d, 0, f);  // DS [N, F] . W1 [D, F]^T
  Dx::epilogue(acc, [&](int r, int c, float4 v) {
    const long row = m0 + r, col = n0 + c;
    if (row < n && col < d) *reinterpret_cast<float4*>(dx + row * d + col) = v;
  });
}

// Column sums of dw's B stage (g rows [BK][128]): thread t sums column t %
// 128 over half t / 128 of the stage's rows.
struct ColumnSum {
  bool on;
  float sum;
  __device__ __forceinline__ void operator()(const float*, const float* sb) {
    if (!on) return;
    constexpr int kHalf = sgemm::BK / 2;
    const float* p = sb + (threadIdx.x >> 7) * kHalf * Dw::LDB + (threadIdx.x & 127);
#pragma unroll
    for (int r = 0; r < kHalf; ++r) sum += p[r * Dw::LDB];
  }
};

__global__ void __launch_bounds__(sgemm::kThreads, 2)
    dw_kernel(const float* __restrict__ x, const float* __restrict__ ds,
              const float* __restrict__ hd, const float* __restrict__ g,
              float* __restrict__ dw1p, float* __restrict__ dw2p, float* __restrict__ db2p,
              int n, int d, int f, int d2, long kchunk) {
  static_assert(sgemm::kThreads == 2 * BN, "ColumnSum's thread map");
  __shared__ __align__(16) float ring[Dw::kRingFloats];
  const long split = blockIdx.y;
  const long k0 = split * kchunk, k1 = k0 + kchunk < n ? k0 + kchunk : n;
  const long tiles1 = cdiv(d, BN) * cdiv(f, BN);
  const bool w1_tile = blockIdx.x < tiles1;  // else a dW2 tile
  const long t = w1_tile ? blockIdx.x : blockIdx.x - tiles1;
  const long tn = cdiv(w1_tile ? f : d2, BN);
  const long m0 = (t / tn) * BN, n0 = (t % tn) * BN;
  Dw::Acc acc;
  Dw::zero(acc);
  ColumnSum db2{!w1_tile && m0 == 0, 0.0f};
  if (w1_tile) {  // dW1 [D, F] = x^T [D, N] . DS [N, F]
    Dw::run(acc, ring, x, d, ds, f, m0, n0, d, f, k0, k1);
  } else {  // dW2 [F, D2] = hd^T [F, N] . g [N, D2]
    Dw::run(acc, ring, hd, f, g, d2, m0, n0, f, d2, k0, k1, db2);
  }
  const long rows = w1_tile ? d : f, cols = w1_tile ? f : d2;
  float* out = w1_tile ? dw1p + split * d * f : dw2p + split * f * d2;
  Dw::epilogue(acc, [&](int r, int c, float4 v) {
    const long row = m0 + r, col = n0 + c;
    if (row < rows && col < cols) *reinterpret_cast<float4*>(out + row * cols + col) = v;
  });
  if (db2.on) {  // block-uniform
    float* red = ring;  // [2][128]; the ring is free after run
    red[threadIdx.x] = db2.sum;
    __syncthreads();
    if (threadIdx.x < BN && n0 + threadIdx.x < d2) {
      db2p[split * d2 + n0 + threadIdx.x] = red[threadIdx.x] + red[BN + threadIdx.x];
    }
  }
}

// Every width these launches take (the route test of FeedForward): D and
// D2 multiples of 16, F of 32, and the largest 1-D grid within bounds.
inline bool takes(int n, int d, int f, int d2) {
  return n > 0 && d > 0 && d2 > 0 && f > 0 && d % 16 == 0 && d2 % 16 == 0 && f % 32 == 0 &&
         cdiv(n, BM) * cdiv(f, kRowsF) <= 0x7fffffffL;
}

// The kernels, in the order of espnet_fused_ffn_f32_info's `which`.
inline const void* kernel(int which) {
  const void* all[] = {
      reinterpret_cast<const void*>(hidden_kernel<false>),
      reinterpret_cast<const void*>(hidden_kernel<true>),
      reinterpret_cast<const void*>(out_kernel),
      reinterpret_cast<const void*>(rows_kernel<false>),
      reinterpret_cast<const void*>(rows_kernel<true>),
      reinterpret_cast<const void*>(dx_kernel),
      reinterpret_cast<const void*>(dw_kernel)};
  return which >= 0 && which < 7 ? all[which] : nullptr;
}

// Prefers the largest shared-memory carveout for every kernel, once.
inline void configure() {
  static const bool done = [] {
    for (int i = 0; i < 7; ++i) {
      cudaFuncSetAttribute(kernel(i), cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
    }
    return true;
  }();
  (void)done;
}

// hidden then out; hid is fp32 [n, f] scratch.
inline int launch_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                      const float* b2, float* out, float* hid, int n, int d, int f, int d2,
                      const philox::Dropout& drop, cudaStream_t stream) {
  if (!takes(n, d, f, d2) || !hid) return (int)cudaErrorInvalidValue;
  configure();
  const unsigned gh = (unsigned)(cdiv(n, BM) * cdiv(f, BN));
  if (drop.seed) {
    hidden_kernel<true><<<gh, sgemm::kThreads, 0, stream>>>(x, w1, b1, hid, n, d, f, drop);
  } else {
    hidden_kernel<false><<<gh, sgemm::kThreads, 0, stream>>>(x, w1, b1, hid, n, d, f, drop);
  }
  if (int err = counted("ffn_f32::hidden_kernel", drop.seed != nullptr)) return err;
  out_kernel<<<(unsigned)(cdiv(n, BM) * cdiv(d2, BN)), sgemm::kThreads, 0, stream>>>(
      hid, w2, b2, out, n, f, d2);
  return counted("ffn_f32::out_kernel");
}

// rows, dx, dw; hd and ds are fp32 [n, f] scratch, db1p [cdiv(n, BM), f],
// dw1p / dw2p / db2p nsplit partials each.
inline int launch_bwd(const float* x, const float* w1, const float* b1, const float* w2,
                      const float* g, float* dx, float* hd, float* ds, float* dw1p, float* db1p,
                      float* dw2p, float* db2p, int nsplit, int n, int d, int f, int d2,
                      const philox::Dropout& drop, cudaStream_t stream) {
  if (!takes(n, d, f, d2) || !hd || !ds || nsplit <= 0 || nsplit > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  configure();
  const unsigned gr = (unsigned)(cdiv(n, BM) * cdiv(f, kRowsF));
  if (drop.seed) {
    rows_kernel<true><<<gr, sgemm::kThreads, 0, stream>>>(x, w1, b1, w2, g, hd, ds, db1p, n, d,
                                                          f, d2, drop);
  } else {
    rows_kernel<false><<<gr, sgemm::kThreads, 0, stream>>>(x, w1, b1, w2, g, hd, ds, db1p, n,
                                                           d, f, d2, drop);
  }
  if (int err = counted("ffn_f32::rows_kernel", drop.seed != nullptr)) return err;
  dx_kernel<<<(unsigned)(cdiv(n, BM) * cdiv(d, BN)), sgemm::kThreads, 0, stream>>>(ds, w1, dx, n,
                                                                                   d, f);
  if (int err = counted("ffn_f32::dx_kernel")) return err;
  const long kchunk = cdiv(cdiv(n, nsplit), sgemm::BK) * sgemm::BK;
  const long tiles = cdiv(d, BN) * cdiv(f, BN) + cdiv(f, BN) * cdiv(d2, BN);
  dw_kernel<<<dim3((unsigned)tiles, (unsigned)nsplit), sgemm::kThreads, 0, stream>>>(
      x, ds, hd, g, dw1p, dw2p, db2p, n, d, f, d2, kchunk);
  return counted("ffn_f32::dw_kernel");
}

// Splits of N for dw_kernel on a card of `sms` SMs: as many as fill its
// block slots (sms x dw_kernel's blocks an SM) with (dW1 tiles + dW2 tiles)
// x splits blocks, each split at least kDwMinRows rows; at least 1. A
// negative value is a cudaError_t code, negated.
constexpr int kDwMinRows = 1024;
inline int dw_splits(int n, int d, int f, int d2, int sms) {
  if (n <= 0 || d <= 0 || f <= 0 || d2 <= 0 || sms <= 0) return -(int)cudaErrorInvalidValue;
  configure();
  int per_sm = 0;
  if (int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dw_kernel,
                                                                  sgemm::kThreads, 0)) {
    return -err;
  }
  const long tiles = cdiv(d, BN) * cdiv(f, BN) + cdiv(f, BN) * cdiv(d2, BN);
  const long s = std::min({(long)n / kDwMinRows, (long)sms * per_sm / tiles, 65535L});
  return (int)std::max(1L, s);
}

// Registers, static shared bytes, local (spill) bytes and blocks per SM of
// kernel `which`.
inline int info(int which, int* out) {
  const void* k = kernel(which);
  if (!k) return (int)cudaErrorInvalidValue;
  configure();
  cudaFuncAttributes attr{};
  if (int err = (int)cudaFuncGetAttributes(&attr, k)) return err;
  int nb = 0;
  if (int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, k, sgemm::kThreads, 0)) {
    return err;
  }
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = (int)attr.localSizeBytes;
  out[3] = nb;
  return 0;
}

}  // namespace ffn_f32

}  // namespace espnet

// dtype: 0 = float32, 1 = bfloat16. part: fp32 scratch, in bf16 [nsplit,
// N, D2] when nsplit > 1 (espnet_fused_ffn_fwd_splits gives nsplit), in
// fp32 the [N, F] hidden (nsplit 1). seed: int32 [1] on the device, or
// null for no dropout; thr = floor(rate * 2^16), inv = 1 / (1 - rate).
// Returns a cudaError_t code (0 = launched).
extern "C" int espnet_fused_ffn_fwd(int dtype, const void* x, const void* w1, const float* b1,
                                    const void* w2, const float* b2, void* out, float* part,
                                    int nsplit, int n, int d, int f, int d2, const int* seed,
                                    unsigned thr, float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  using espnet::bf16;
  if (dtype == 1) {
    return espnet::ffn_fwd::launch(static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
                                   static_cast<const bf16*>(w2), b2, static_cast<bf16*>(out), part,
                                   nsplit, n, d, f, d2, {seed, thr, inv}, s);
  }
  if (dtype == 0 && nsplit == 1) {
    return espnet::ffn_f32::launch_fwd(static_cast<const float*>(x), static_cast<const float*>(w1),
                                       b1, static_cast<const float*>(w2), b2,
                                       static_cast<float*>(out), part, n, d, f, d2,
                                       {seed, thr, inv}, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The bf16 forward's F split for N rows (1, 2 or 4); 0 when it cannot take
// the shape (D2 other than 32, 64, 128, 256; D not a multiple of 16; F not
// a multiple of 32; too much shared memory).
extern "C" int espnet_fused_ffn_fwd_splits(int n, int d, int f, int d2) {
  return espnet::ffn_fwd::splits(n, d, f, d2);
}

// 1 when both directions' launches of this dtype take the widths (and, in
// bf16, the forward's shared memory fits a block), else 0: the route test of
// models/conformer.py:FeedForward, decided before any launch.
extern "C" int espnet_fused_ffn_takes(int dtype, int n, int d, int f, int d2) {
  if (n <= 0 || d <= 0 || d % 16 || d2 <= 0 || d2 % 16) return 0;
  if (dtype == 1) {
    return f % espnet::ffn_bwd::kRowsF == 0 && espnet::ffn_fwd::splits(n, d, f, d2) > 0;
  }
  return dtype == 0 && espnet::ffn_f32::takes(n, d, f, d2);
}

// Blocks of the bf16 forward kernel that fit one SM at widths D, D2.
extern "C" int espnet_fused_ffn_fwd_blocks_per_sm(int d, int d2) {
  return espnet::ffn_fwd::blocks_per_sm(d, d2);
}

// Splits of N for the fp32 backward's dW launch (its nsplit) on a card of
// `sms` SMs; a negative value is a cudaError_t code, negated.
extern "C" int espnet_fused_ffn_f32_dw_splits(int n, int d, int f, int d2, int sms) {
  return espnet::ffn_f32::dw_splits(n, d, f, d2, sms);
}

// info[0..3] <- registers a thread, static shared bytes, local (spill)
// bytes and blocks per SM of fp32 kernel `which`: 0 / 1 hidden_kernel at
// rate 0 / with dropout, 2 out_kernel, 3 / 4 rows_kernel, 5 dx_kernel, 6
// dw_kernel. Returns a cudaError_t code.
extern "C" int espnet_fused_ffn_f32_info(int which, int* info) {
  return espnet::ffn_f32::info(which, info);
}

extern "C" const char* espnet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Rows of N per db1 partial of the backward (both dtypes).
extern "C" int espnet_fused_ffn_bwd_row_tile() { return espnet::ffn_bwd::kRowTile; }

// Backward. g: [N, D2] (x's type); dx: [N, D]; fp32 partials, summed by the
// caller: dw1p [nsplit, D, F], dw2p [nsplit, F, D2], db2p [nsplit, D2], and
// db1p [cdiv(N, espnet_fused_ffn_bwd_row_tile()), F]. hd and ds: [N, F]
// scratch in x's type. seed, thr, inv: the forward's dropout (seed null for
// none). Returns a cudaError_t code.
extern "C" int espnet_fused_ffn_bwd(int dtype, const void* x, const void* w1, const float* b1,
                                    const void* w2, const void* g, void* dx, void* hd, void* ds,
                                    float* dw1p, float* db1p, float* dw2p, float* db2p,
                                    int nsplit, int n, int d, int f, int d2, const int* seed,
                                    unsigned thr, float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  using espnet::bf16;
  if (dtype == 1) {
    return espnet::ffn_bwd::launch(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
        static_cast<const bf16*>(w2), static_cast<const bf16*>(g), static_cast<bf16*>(dx),
        static_cast<bf16*>(hd), static_cast<bf16*>(ds), dw1p, db1p, dw2p, db2p, nsplit, n, d, f,
        d2, {seed, thr, inv}, s);
  }
  if (dtype == 0) {
    auto in = [](const void* p) { return static_cast<const float*>(p); };
    return espnet::ffn_f32::launch_bwd(in(x), in(w1), b1, in(w2), in(g), static_cast<float*>(dx),
                                       static_cast<float*>(hd), static_cast<float*>(ds), dw1p,
                                       db1p, dw2p, db2p, nsplit, n, d, f, d2, {seed, thr, inv}, s);
  }
  return (int)cudaErrorInvalidValue;
}
