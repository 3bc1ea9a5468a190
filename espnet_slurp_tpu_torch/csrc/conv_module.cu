// Fused Conformer convolution module, forward and backward:
//   out = pw2(swish(LayerNorm(depthwise_k(mask(GLU(pw1(x)))))))
// with every intermediate in fp32 (pw1 and pw2 take x's type with fp32
// accumulation; the swish output is rounded to x's type before pw2).
//
// Replaces the TPU kernel espnet_slurp_tpu/ops/pallas/conv_module.py:
// fused_conv_module (_fwd_kernel via :214, _bwd_kernel via :236), the opt-in
// fused conv module of every Conformer block.
//
// Weights come in PyTorch's layouts, as the port's modules hold them: w1
// [2D, D] and w2 [D, D] (nn.Linear's [out, in]), the depthwise taps [D, k]
// (Conv1d's [D, 1, k]); biases, taps and LayerNorm parameters fp32.
//
// The TPU kernel kept one utterance in VMEM and recomputed pw1 for it; a
// block here has 227 KB of shared memory, and no product is formed twice:
// pw1 is one GEMM over the N = B T rows with the GLU in its epilogue, and
// what follows it runs per row tile of BT frames, reading the depthwise
// taps' k - 1 frames of halo from fp32 scratch (g, dc) that lives for the
// call. The TPU kernel accumulated weight gradients across its sequential
// grid; blocks here run in no order, so each writes fp32 partials that one
// last launch sums in a fixed order (deterministic, no atomics). Two routes,
// by x's type, each with its own notes below:
//   - bfloat16 (every conf/*.yaml that runs fused_conv): conv_bf16, the
//     products on the mma.sync mainloop of mma_gemm.cuh; two launches
//     forward, six backward.
//   - float32 (ASRConfig(fused_conv=True) and the fp32 card-against-CPU
//     checks): conv_f32, the products on the fp32 FMA mainloop of
//     sgemm.cuh; three launches forward, seven backward.
// Both share the row-tile helpers of conv_rows.
#include <algorithm>

#include "common.cuh"
#include "mma_gemm.cuh"
#include "sgemm.cuh"

namespace espnet {

// ---- Row-tile helpers of both routes ------------------------------------------
//
// The depthwise conv, its transposed conv and the tap gradient walk row tiles
// of BT frames with a halo of g (or dc) in fp32 shared memory; the partial
// sums of the backward are summed by one last launch in a fixed order.

namespace conv_rows {

constexpr int BT = 32;  // frames of a row tile
constexpr int R = 8;    // output frames one thread's tap walk holds
constexpr int KC = 32;  // taps one walk holds in registers

__host__ __device__ constexpr long cdiv(long a, long b) { return (a + b - 1) / b; }

// Rows of a halo tile: BT frames and the taps' reach, rounded up to whole
// chunks of KC taps (a walk reads KC - 1 rows past its last frame).
__host__ __device__ inline int halo_rows(int k) { return BT + (int)cdiv(k, KC) * KC; }
__host__ __device__ inline size_t halo_bytes(int d, int k) {
  return (size_t)halo_rows(k) * d * sizeof(float);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ int valid_len(const int* lengths, int b, int t_len) {
  return min(max(__ldg(lengths + b), 0), t_len);
}

// Rows h < rows of a halo tile at hs (d floats a row) <- frames f0 + h of
// one utterance's [T, D] fp32 src, by the block's `threads` threads; frames
// outside [0, T) and rows h >= hmax read as zero. Commits one cp.async
// group.
__device__ __forceinline__ void load_halo(float* hs, const float* src, long f0, int hmax,
                                          int rows, int t_len, int d, int threads = kThreads) {
  const int vpr = d / 4;
  for (int idx = threadIdx.x; idx < rows * vpr; idx += threads) {
    const int h = idx / vpr, c = (idx - h * vpr) * 4;
    const long f = f0 + h;
    const bool ok = h < hmax && f >= 0 && f < t_len;
    mma::cp_async16(hs + (long)h * d + c, ok ? src + f * d + c : src, ok);
  }
  mma::cp_async_commit();
}

// Chunk c of channel ch's taps (tap j = wdw[ch, c KC + j], 0 past k), or
// with FLIP the transposed conv's (wdw[ch, k - 1 - (c KC + j)]).
template <bool FLIP>
__device__ __forceinline__ void load_taps(float (&tap)[KC], const float* wch, int c, int k) {
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int i = c * KC + j;
    tap[j] = i < k ? __ldg(wch + (FLIP ? k - 1 - i : i)) : 0.0f;
  }
}

// acc[q] += sum_j tap[j] col[(q + j) ld] for q < R: one chunk of taps over R
// output frames, each input read once, the taps added in order.
__device__ __forceinline__ void walk(float (&acc)[R], const float (&tap)[KC], const float* col,
                                     int ld) {
#pragma unroll
  for (int i = 0; i < R + KC - 1; ++i) {
    const float v = col[i * ld];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int j = i - q;
      if (j >= 0 && j < KC) acc[q] = fmaf(tap[j], v, acc[q]);
    }
  }
}

// The depthwise conv of channel ch over a halo tile hs (ld floats a row):
// put(r, acc) with acc[q] = init + sum_j tap(j) hs[r + q + j][ch], q < R,
// for r = 0, R, .. < BT in order, each after the walk has read every row it
// needs from hs (so put may overwrite hs's rows r .. r + R - 1).
template <bool FLIP, class Put>
__device__ __forceinline__ void conv_channel(const float* hs, int ld, int ch, const float* wch,
                                             int k, float init, Put&& put) {
  const int nc = (int)cdiv(k, KC);
  float tap[KC];
  load_taps<FLIP>(tap, wch, 0, k);
  for (int r = 0; r < BT; r += R) {
    float acc[R];
#pragma unroll
    for (int q = 0; q < R; ++q) acc[q] = init;
    for (int c = 0; c < nc; ++c) {
      if (nc > 1) load_taps<FLIP>(tap, wch, c, k);
      walk(acc, tap, hs + (long)(r + c * KC) * ld + ch, ld);
    }
    put(r, acc);
  }
}

// The tap gradient of channel ch over one tile, KC / 2 taps a pass (half a
// chunk: fewer registers): wout[j d] = sum_r w[r] hs[r + j][ch] for j < k,
// or with FLIP wout[(k - 1 - j) d]. With w = dc and hs the halo of g from
// frame r0 - pl, that is dwdw[ch, j] = sum_t dc[t] g[t + j - pl] over the
// tile's frames t; with w = g and hs the halo of dc from frame r0 - pr
// (FLIP), the same sum over the tile's frames t + j - pl.
template <bool FLIP = false>
__device__ __forceinline__ void tap_grad(const float (&w)[BT], const float* hs, int d, int ch,
                                         int k, float* wout) {
  const int nc = (int)cdiv(k, KC);
  constexpr int KH = KC / 2;
  for (int c = 0; c < 2 * nc; ++c) {
    float acc[KH];
#pragma unroll
    for (int j = 0; j < KH; ++j) acc[j] = 0.0f;
    const float* col = hs + (long)c * KH * d + ch;
#pragma unroll
    for (int h = 0; h < BT + KH - 1; ++h) {
      const float v = col[h * d];
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const int j = h - r;
        if (j >= 0 && j < KH) acc[j] = fmaf(w[r], v, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      const int tap = c * KH + j;
      if (tap < k) wout[(long)(FLIP ? k - 1 - tap : tap) * d] = acc[j];
    }
  }
}

// Grid (ceil(T / BT), B), kThreads threads: dg = the transposed conv of dc
// (zero outside [0, T)), masked to frames < len, then da = dg sig, dgate =
// dg a sig (1 - sig) (a sig = g where the mask keeps the frame); du = (da,
// dgate) in T, db1p[tile] <- the tile's unrounded column sums; with TAPS
// also dwdwp[tile] <- the tap gradient [k, D] of the tile's frames of g
// against dc's halo (tap_grad<true>).
template <typename T, bool TAPS = false>
__device__ __forceinline__ void du_tile(const float* __restrict__ dc, const float* __restrict__ g,
                                        const float* __restrict__ sig,
                                        const int* __restrict__ lengths,
                                        const float* __restrict__ wdw, T* __restrict__ du,
                                        float* __restrict__ db1p, float* __restrict__ dwdwp,
                                        int t_len, int d, int k, int pl) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem);
  const int b = blockIdx.y;
  const long r0 = (long)blockIdx.x * BT;
  const long base = (long)b * t_len * d;
  const int len = valid_len(lengths, b, t_len);
  const long tile = (long)b * gridDim.x + blockIdx.x;
  // hs row h <- dc at frame r0 - pr + h (pr = k - 1 - pl): frame s takes
  // rows s - r0 .. s - r0 + k - 1 against the taps reversed.
  load_halo(hs, dc + base, r0 - (k - 1 - pl), BT + k - 1, halo_rows(k), t_len, d);
  mma::cp_async_wait<0>();
  __syncthreads();
  for (int ch = threadIdx.x; ch < d; ch += kThreads) {
    float sda = 0.0f, sdg = 0.0f;
    conv_channel<true>(hs, d, ch, wdw + (long)ch * k, k, 0.0f, [&](int r,
                                                                   const float(&acc)[R]) {
      // The R frames' g and sig first, all loads in flight together.
      float gv[R], sv[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const long f = r0 + r + q;
        gv[q] = f < t_len ? __ldg(g + base + f * d + ch) : 0.0f;
        sv[q] = f < t_len ? __ldg(sig + base + f * d + ch) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const long f = r0 + r + q;
        if (f >= t_len) break;
        const float dgv = f < len ? acc[q] : 0.0f;
        const float da = dgv * sv[q], dgt = dgv * gv[q] * (1.0f - sv[q]);
        T* drow = du + (base + f * d) * 2;
        drow[ch] = from_f32<T>(da);
        drow[d + ch] = from_f32<T>(dgt);
        sda += da;
        sdg += dgt;
      }
    });
    db1p[tile * 2 * d + ch] = sda;
    db1p[tile * 2 * d + d + ch] = sdg;
    if constexpr (TAPS) {
      float gr[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) gr[r] = r0 + r < t_len ? __ldg(g + base + (r0 + r) * d + ch) : 0.0f;
      tap_grad<true>(gr, hs, d, ch, k, dwdwp + tile * k * d + ch);
    }
  }
}

// The backward's partial sums, each over its parts in a fixed order: job j
// sums src [parts, len] into dst (fp32) or dst16 (bf16); with rows > 0 the
// sum of src column i goes to dst[(i % rows) * (len / rows) + i / rows] (a
// transpose of [len / rows, rows]).
struct SumJob {
  const float* src;
  float* dst;
  bf16* dst16;
  int len, parts, rows, blocks;  // blocks = ceil(len / 32)
};
template <int J>
struct SumJobs {
  SumJob job[J];
};

// kThreads threads; grid (sum of the jobs' blocks): a block sums 32 columns
// of one job, its 8 warps a stride of the parts each, then the 8 partial
// sums in order.
template <int J>
__device__ __forceinline__ void sum_jobs(const SumJobs<J>& jobs) {
  __shared__ float red[kThreads / 32][33];
  int blk = blockIdx.x, j = 0;
  while (j < J - 1 && blk >= jobs.job[j].blocks) blk -= jobs.job[j++].blocks;
  const SumJob job = jobs.job[j];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int col = blk * 32 + lane;
  float s = 0.0f;
  if (col < job.len) {
#pragma unroll 4
    for (int p = grp; p < job.parts; p += kThreads / 32) s += job.src[(long)p * job.len + col];
  }
  red[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && col < job.len) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t += red[w][lane];
    const int at = job.rows > 0 ? (col % job.rows) * (job.len / job.rows) + col / job.rows : col;
    if (job.dst) job.dst[at] = t;
    if (job.dst16) job.dst16[at] = __float2bfloat16(t);
  }
}

// Blocks of the sum launch for the jobs (setting each job's blocks).
template <int J>
inline long sum_blocks(SumJobs<J>& jobs) {
  long blocks = 0;
  for (SumJob& j : jobs.job) blocks += j.blocks = (int)cdiv(j.len, 32);
  return blocks;
}

// A route's launch: its kernel, threads and dynamic shared bytes at (d, k).
struct Launch {
  const void* kernel;
  int threads;
  size_t smem;
};

inline int max_smem() {
  int dev = 0, most = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return most;
}

// Lets each of the n launches' kernels that has dynamic shared memory take
// the card's whole opt-in shared memory, and every one prefer the largest
// carveout. (Any error of these calls is cleared, so that the launches'
// checks see only their own.)
inline void allow_smem(const Launch* all, int n) {
  const int most = max_smem();
  for (int i = 0; i < n; ++i) {
    cudaFuncSetAttribute(all[i].kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    if (all[i].smem > 0) {
      cudaFuncSetAttribute(all[i].kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    }
  }
  cudaGetLastError();
}

inline int occupancy(const Launch& l, int* nb) {
  if (!l.kernel) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(nb, l.kernel, l.threads, l.smem);
}

// out[0..3] <- registers a thread, shared bytes (static and dynamic), local
// (spill) bytes and blocks per SM of launch l.
inline int launch_info(const Launch& l, int* out) {
  if (!l.kernel) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr{};
  if (int err = (int)cudaFuncGetAttributes(&attr, l.kernel)) return err;
  int nb = 0;
  if (int err = occupancy(l, &nb)) return err;
  out[0] = attr.numRegs;
  out[1] = (int)(attr.sharedSizeBytes + l.smem);
  out[2] = (int)attr.localSizeBytes;
  out[3] = nb;
  return 0;
}

}  // namespace conv_rows

// ---- bfloat16: each product once, on the mma.sync mainloop ------------------
//
// Replaces espnet_slurp_tpu/ops/pallas/conv_module.py:_fwd_kernel and
// _bwd_kernel (the pallas_calls at :214 and :236) in bfloat16, with the
// reference's rounding points: the swish output sw is rounded to bf16 before
// pw2 and before dW2, the cotangent go is bf16, du is rounded before dx and
// dW1 (db1 sums it unrounded), and every other value is fp32.
//
// Bound: the tensor cores, barely. At the transducer step (N = 32 x 468
// rows, D 256, k 31) the forward's two products are 5.9 GFLOP (0.006 ms at
// 989 TFLOP/s) and its taps 0.24 GFLOP of fp32 FMAs (0.0036 ms at 67); the
// backward forms five products (pw1 again, dsw, dx, dW1, dW2: 13.7 GFLOP)
// and two tap passes. The compulsory traffic (x, go, out or dx, weights) is
// ~15-23 MB, 0.005-0.007 ms at 3.35 TB/s.
//
// Design (the file's head): the halos come from g, sig and dc in fp32
// scratch (15.3 MB each at the transducer shape, read back mostly from L2):
//   forward
//     glu_kernel      g = mask(a sigmoid(gate)) from x W1^T on 128 x 128
//                     tiles; W1's rows enter the B tile interleaved per n8
//                     tile (8 a channels, then their 8 gate channels), so a
//                     thread holds a and gate of one channel in acc[i][2q]
//                     and acc[i][2q + 1] and the GLU runs in the epilogue.
//     out_kernel      per row tile: g's halo by cp.async, the depthwise taps
//                     in registers walking R frames at a time in place,
//                     LayerNorm and swish (a warp a row) into a bf16 A tile
//                     in shared memory, then pw2 with only W2 streamed
//                     through the ring (Gemm::run_ra), + b2.
//   backward
//     glu_sig_kernel  glu_kernel that also keeps sigmoid(gate).
//     rows_kernel     per row tile: dsw = go W2 on the mainloop, kept in
//                     its accumulators; g's halo in the ring's place, the
//                     conv and LayerNorm again, then in the accumulators'
//                     layout sw (bf16 to device memory, for dW2), dn = dsw
//                     swish'(n) and the LayerNorm backward dc (fp32 to
//                     device memory); the tile's sums of go, dn chat, dn, dc
//                     and the tap gradient dwdw[c, j] = sum_t dc[t, c]
//                     g[t + j - pl, c] (a thread a channel, 32 taps in
//                     registers, g from shared memory).
//     du_kernel       per row tile: the transposed conv of dc's halo, the
//                     mask and the GLU backward; du (bf16 [N, 2D]) and the
//                     tile's unrounded column sums (db1).
//     dx_kernel       dx = du W1 on 128 x 128 tiles.
//     dw_kernel       dW1 = du^T x and dW2 = go^T sw as 128 x 128 tiles over
//                     splits of N (fp32 partials per split).
//     sum_kernel      every partial sum over its tiles or splits, in a fixed
//                     order (deterministic, no float atomics); dW1 and dW2
//                     rounded to bf16.
// Every launch counts itself on the host (common.cuh:counted).

namespace conv_bf16 {

using mma::Gemm;
using mma::Major;
using namespace conv_rows;
constexpr int kThreads = 256;
constexpr int kTile = 128;
// x [N, D] . W1 [2D, D]^T, the 2D columns interleaved (GluRows).
using Glu = Gemm<kTile, kTile, 32, 64, 32, 4, Major::K, Major::K>;
// sw [BT, D] (resident) . W2 [D, D]^T, 256 output columns a pass.
using Pw2 = Gemm<BT, 256, 32, 32, 32, 3, Major::K, Major::K>;
// go [BT, D] . W2 [D, D], 256 columns a pass.
using Dsw = Gemm<BT, 256, 32, 32, 32, 3, Major::K, Major::MN>;
// du [N, 2D] . W1 [2D, D].
using Dx = Gemm<kTile, kTile, 32, 64, 32, 4, Major::K, Major::MN>;
// du^T [2D, N] . x [N, D] and go^T [D, N] . sw [N, D].
using Dw = Gemm<kTile, kTile, 32, 64, 32, 4, Major::MN, Major::MN>;
static_assert(Glu::kThreads == kThreads && Pw2::kThreads == kThreads &&
                  Dsw::kThreads == kThreads && Dx::kThreads == kThreads &&
                  Dw::kThreads == kThreads,
              "one block shape");
static_assert(BT % R == 0 && Glu::NT % 2 == 0, "tile shapes");

// Tiles read or written in the mainloop's fragment layout are padded by 8
// elements a row (the 8 rows of a fragment store fall in distinct banks).
__host__ __device__ inline int ld_tile(int d) { return d + 8; }

// Dynamic shared memory of out_kernel: the halo, reused as the ring, then
// the bf16 sw tile.
struct OutSmem {
  size_t sw, total;
  __host__ __device__ OutSmem(int d, int k) {
    const size_t halo = halo_bytes(d, k);
    sw = align128(halo > Pw2::kSmemBytesB ? halo : Pw2::kSmemBytesB);
    total = sw + align128((size_t)BT * ld_tile(d) * sizeof(bf16));
  }
};

// rows_kernel: the ring, then the halo in its place; c then chat then dc;
// the warps' row sums; rstd.
struct RowsSmem {
  size_t c, red, rstd, total;
  __host__ __device__ RowsSmem(int d, int k) {
    const size_t halo = halo_bytes(d, k);
    c = align128(halo > Dsw::kSmemBytes ? halo : Dsw::kSmemBytes);
    red = c + align128((size_t)BT * ld_tile(d) * sizeof(float));
    rstd = red + align128((size_t)(kThreads / 32) * BT * 2 * sizeof(float));
    total = rstd + align128(BT * sizeof(float));
  }
};

__host__ __device__ inline size_t du_smem(int d, int k) { return halo_bytes(d, k); }

// Tile row n of the interleaved B operand -> W1's row: n = 16 p + 8 h + x
// is channel 8 p + x of the a half (h = 0) or of the gate half (h = 1).
struct GluRows {
  long d;
  __device__ __forceinline__ long operator()(long n) const {
    return (n >> 4) * 8 + (n & 7) + ((n >> 3) & 1) * d;
  }
};

// g (and with SIG, sigmoid(gate)) for a 128-row x 64-channel tile.
template <bool SIG>
__device__ __forceinline__ void glu_tile(const bf16* __restrict__ x,
                                         const int* __restrict__ lengths,
                                         const bf16* __restrict__ w1, const float* __restrict__ b1,
                                         float* __restrict__ g, float* __restrict__ sig, long n,
                                         int t_len, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long n0 = (long)blockIdx.x * kTile;  // interleaved column
  const long m0 = (long)blockIdx.y * kTile;
  Glu::Acc acc;
  Glu::zero(acc);
  mma::NoHook none;
  Glu::run(acc, reinterpret_cast<bf16*>(smem), x, d, w1, d, m0, n0, n, 2L * d, 0, d, none,
           GluRows{d});
  const int t2 = (threadIdx.x & 3) * 2;
  int ch[Glu::NT / 2];
  float ba[Glu::NT / 2][2], bg[Glu::NT / 2][2];
#pragma unroll
  for (int q = 0; q < Glu::NT / 2; ++q) {
    ch[q] = (int)(((n0 + Glu::frag_col(2 * q)) >> 4) * 8) + t2;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ba[q][e] = __ldg(b1 + ch[q] + e);
      bg[q][e] = __ldg(b1 + d + ch[q] + e);
    }
  }
#pragma unroll
  for (int i = 0; i < Glu::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long row = m0 + Glu::frag_row(i, h);
      if (row >= n) continue;
      const int b = (int)(row / t_len);
      const bool keep = row - (long)b * t_len < valid_len(lengths, b, t_len);
#pragma unroll
      for (int q = 0; q < Glu::NT / 2; ++q) {
        float gv[2], sv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = acc[i][2 * q][2 * h + e] + ba[q][e];
          sv[e] = sigmoid(acc[i][2 * q + 1][2 * h + e] + bg[q][e]);
          gv[e] = keep ? a * sv[e] : 0.0f;
        }
        *reinterpret_cast<float2*>(g + row * d + ch[q]) = make_float2(gv[0], gv[1]);
        if constexpr (SIG) {
          *reinterpret_cast<float2*>(sig + row * d + ch[q]) = make_float2(sv[0], sv[1]);
        }
      }
    }
}

// Grid (2D / 128, N / 128).
__global__ void __launch_bounds__(kThreads, 2)
    glu_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
               const bf16* __restrict__ w1, const float* __restrict__ b1, float* __restrict__ g,
               long n, int t_len, int d) {
  glu_tile<false>(x, lengths, w1, b1, g, nullptr, n, t_len, d);
}

__global__ void __launch_bounds__(kThreads, 2)
    glu_sig_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
                   const bf16* __restrict__ w1, const float* __restrict__ b1,
                   float* __restrict__ g, float* __restrict__ sig, long n, int t_len, int d) {
  glu_tile<true>(x, lengths, w1, b1, g, sig, n, t_len, d);
}

// Grid (ceil(T / BT), B): the rest of the forward for one row tile.
__global__ void __launch_bounds__(kThreads, 2)
    out_kernel(const float* __restrict__ g, const float* __restrict__ wdw,
               const float* __restrict__ bdw, const float* __restrict__ gamma,
               const float* __restrict__ beta, const bf16* __restrict__ w2,
               const float* __restrict__ b2, bf16* __restrict__ out, int t_len, int d, int k,
               int pl, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const OutSmem L(d, k);
  float* hs = reinterpret_cast<float*>(smem);
  bf16* sws = reinterpret_cast<bf16*>(smem + L.sw);
  const int lds = ld_tile(d);
  const int b = blockIdx.y;
  const long r0 = (long)blockIdx.x * BT;
  const long base = (long)b * t_len * d;
  // hs row h <- g at frame r0 - pl + h.
  load_halo(hs, g + base, r0 - pl, BT + k - 1, halo_rows(k), t_len, d);
  mma::cp_async_wait<0>();
  __syncthreads();
  // c = bdw + taps, in place (one thread owns a channel).
  for (int ch = threadIdx.x; ch < d; ch += kThreads) {
    conv_channel<false>(hs, d, ch, wdw + (long)ch * k, k, __ldg(bdw + ch),
                        [&](int r, const float(&acc)[R]) {
#pragma unroll
                          for (int q = 0; q < R; ++q) hs[(r + q) * d + ch] = acc[q];
                        });
  }
  __syncthreads();
  // LayerNorm (two passes) and swish, a warp a row, into the bf16 A tile.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BT; r += kThreads / 32) {
    const float* row = hs + r * d;
    float s = 0.0f;
    for (int c = lane; c < d; c += 32) s += row[c];
    const float mean = warp_sum(s) / d;
    float v = 0.0f;
    for (int c = lane; c < d; c += 32) v += (row[c] - mean) * (row[c] - mean);
    const float rs = rsqrtf(warp_sum(v) / d + eps);
    for (int c = lane; c < d; c += 32) {
      const float nv = (row[c] - mean) * rs * __ldg(gamma + c) + __ldg(beta + c);
      sws[r * lds + c] = __float2bfloat16(nv * sigmoid(nv));
    }
  }
  __syncthreads();  // the halo is dead: the ring takes its place
  bf16* ring = reinterpret_cast<bf16*>(smem);
  for (int nb = 0; nb < d; nb += 256) {
    Pw2::Acc acc;
    Pw2::zero(acc);
    Pw2::run_ra(acc, ring, sws, lds, w2, d, nb, d, 0, d);
    Pw2::epilogue(acc, [&](int r, int c, float v0, float v1) {
      const long f = r0 + r;
      const int col = nb + c;
      if (f < t_len && col < d) {
        *reinterpret_cast<__nv_bfloat162*>(out + base + f * d + col) =
            __floats2bfloat162_rn(v0 + __ldg(b2 + col), v1 + __ldg(b2 + col + 1));
      }
    });
  }
}

// Grid (ceil(T / BT), B). vecp[tile] <- column sums over the tile's frames
// of go, dn chat, dn, dc (db2, dgamma, dbeta, dbdw); dwdwp[tile] <- the
// tile's tap gradient [k, D]; tile = b ceil(T / BT) + blockIdx.x. dsw stays
// in the mainloop's accumulators (CB column blocks of 256) from its product
// to dc, so the ring and then g's halo share one region and two blocks fit
// an SM at D <= 256.
template <int CB>
__global__ void __launch_bounds__(kThreads, CB == 1 ? 2 : 1)
    rows_kernel(const float* __restrict__ g, const float* __restrict__ wdw,
                const float* __restrict__ bdw, const float* __restrict__ gamma,
                const float* __restrict__ beta, const bf16* __restrict__ w2,
                const bf16* __restrict__ go, float* __restrict__ dc_out, bf16* __restrict__ sw_out,
                float* __restrict__ vecp, float* __restrict__ dwdwp, int t_len, int d, int k,
                int pl, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsSmem L(d, k);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* hs = reinterpret_cast<float*>(smem);         // after the ring
  float* cs = reinterpret_cast<float*>(smem + L.c);   // c, chat, then dc
  float* red = reinterpret_cast<float*>(smem + L.red);  // [warps][BT][2]
  float* rstd = reinterpret_cast<float*>(smem + L.rstd);
  const int ldt = ld_tile(d);
  const int b = blockIdx.y;
  const long r0 = (long)blockIdx.x * BT;
  const long base = (long)b * t_len * d;
  const int valid = (int)min((long)BT, t_len - r0);
  const long tile = (long)b * gridDim.x + blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* vp = vecp + tile * 4 * d;
  Dsw::Acc dn[CB];  // dsw, then dn
#pragma unroll
  for (int cb = 0; cb < CB; ++cb) {
    Dsw::zero(dn[cb]);
    if (cb * 256 < d) {
      Dsw::run(dn[cb], ring, go, d, w2, d, (long)b * t_len + r0, cb * 256,
               (long)b * t_len + t_len, d, 0, d);
    }
  }
  // hs row h <- g at frame r0 - pl + h.
  load_halo(hs, g + base, r0 - pl, BT + k - 1, halo_rows(k), t_len, d);
  mma::cp_async_wait<0>();
  __syncthreads();
  for (int ch = threadIdx.x; ch < d; ch += kThreads) {
    conv_channel<false>(hs, d, ch, wdw + (long)ch * k, k, __ldg(bdw + ch),
                        [&](int r, const float(&acc)[R]) {
#pragma unroll
                          for (int q = 0; q < R; ++q) cs[(r + q) * ldt + ch] = acc[q];
                        });
  }
  __syncthreads();
  for (int r = warp; r < BT; r += kThreads / 32) {
    float* row = cs + r * ldt;
    float s = 0.0f;
    for (int c = lane; c < d; c += 32) s += row[c];
    const float mean = warp_sum(s) / d;
    float v = 0.0f;
    for (int c = lane; c < d; c += 32) v += (row[c] - mean) * (row[c] - mean);
    const float rs = rsqrtf(warp_sum(v) / d + eps);
    for (int c = lane; c < d; c += 32) row[c] = (row[c] - mean) * rs;  // chat
    if (lane == 0) rstd[r] = rs;
  }
  __syncthreads();
  // In the accumulators' layout (a warp owns all BT rows of its 32
  // columns): sw to device memory, dn = dsw swish'(n), the column sums of dn
  // chat and dn, and each row's sums of dchat and dchat chat (dchat = dn
  // gamma) over the warp's columns.
  float s1[Dsw::MT][2] = {}, s2[Dsw::MT][2] = {};
#pragma unroll
  for (int cb = 0; cb < CB; ++cb)
#pragma unroll
    for (int j = 0; j < Dsw::NT; ++j) {
      const int c = cb * 256 + Dsw::frag_col(j);
      if (c >= d) continue;
      float gm[2], bt[2], sdg[2] = {}, sdb[2] = {};
#pragma unroll
      for (int e = 0; e < 2; ++e) gm[e] = __ldg(gamma + c + e), bt[e] = __ldg(beta + c + e);
#pragma unroll
      for (int i = 0; i < Dsw::MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = Dsw::frag_row(i, h);
          const float2 ch2 = *reinterpret_cast<const float2*>(cs + r * ldt + c);
          const float chat[2] = {ch2.x, ch2.y};
          float sw[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float nv = chat[e] * gm[e] + bt[e];
            const float sg = sigmoid(nv);
            sw[e] = nv * sg;
            float& v = dn[cb][i][j][2 * h + e];
            v *= sg * (1.0f + nv * (1.0f - sg));
            const float dch = v * gm[e];
            s1[i][h] += dch;
            s2[i][h] += dch * chat[e];
            if (r < valid) sdg[e] += v * chat[e], sdb[e] += v;
          }
          if (r < valid) {
            *reinterpret_cast<__nv_bfloat162*>(sw_out + base + (r0 + r) * d + c) =
                __floats2bfloat162_rn(sw[0], sw[1]);
          }
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          sdg[e] += __shfl_xor_sync(0xffffffffu, sdg[e], o);
          sdb[e] += __shfl_xor_sync(0xffffffffu, sdb[e], o);
        }
        if (lane < 4) {
          vp[d + c + e] = sdg[e];
          vp[2 * d + c + e] = sdb[e];
        }
      }
    }
#pragma unroll
  for (int i = 0; i < Dsw::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s1[i][h] += __shfl_xor_sync(0xffffffffu, s1[i][h], o);
        s2[i][h] += __shfl_xor_sync(0xffffffffu, s2[i][h], o);
      }
      if ((lane & 3) == 0) {
        float* rr = red + (warp * BT + Dsw::frag_row(i, h)) * 2;
        rr[0] = s1[i][h];
        rr[1] = s2[i][h];
      }
    }
  __syncthreads();
  // The LayerNorm backward, dc = rstd (dchat - mean(dchat) - chat
  // mean(dchat chat)), into cs in place of chat, and its column sums (dbdw).
  float m1[Dsw::MT][2], m2[Dsw::MT][2], rs[Dsw::MT][2];
#pragma unroll
  for (int i = 0; i < Dsw::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = Dsw::frag_row(i, h);
      float a = 0.0f, c2 = 0.0f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        a += red[(w * BT + r) * 2];
        c2 += red[(w * BT + r) * 2 + 1];
      }
      m1[i][h] = a / d;
      m2[i][h] = c2 / d;
      rs[i][h] = rstd[r];
    }
#pragma unroll
  for (int cb = 0; cb < CB; ++cb)
#pragma unroll
    for (int j = 0; j < Dsw::NT; ++j) {
      const int c = cb * 256 + Dsw::frag_col(j);
      if (c >= d) continue;
      float gm[2], sdc[2] = {};
#pragma unroll
      for (int e = 0; e < 2; ++e) gm[e] = __ldg(gamma + c + e);
#pragma unroll
      for (int i = 0; i < Dsw::MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = Dsw::frag_row(i, h);
          float2* p = reinterpret_cast<float2*>(cs + r * ldt + c);
          const float2 ch2 = *p;
          const float chat[2] = {ch2.x, ch2.y};
          float dc[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            dc[e] = rs[i][h] * (dn[cb][i][j][2 * h + e] * gm[e] - m1[i][h] - chat[e] * m2[i][h]);
            if (r < valid) sdc[e] += dc[e];
          }
          *p = make_float2(dc[0], dc[1]);
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) sdc[e] += __shfl_xor_sync(0xffffffffu, sdc[e], o);
        if (lane < 4) vp[3 * d + c + e] = sdc[e];
      }
    }
  __syncthreads();
  // db2, dc to device memory and the tap gradient (tap_grad): a thread a
  // channel, the tile's dc of the channel in registers.
  for (int ch = threadIdx.x; ch < d; ch += kThreads) {
    float sgo = 0.0f;
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      if (r < valid) sgo += __bfloat162float(go[base + (r0 + r) * d + ch]);
    }
    vp[ch] = sgo;
    float dcr[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      dcr[r] = r < valid ? cs[r * ldt + ch] : 0.0f;
      if (r < valid) dc_out[base + (r0 + r) * d + ch] = dcr[r];
    }
    tap_grad(dcr, hs, d, ch, k, dwdwp + tile * k * d + ch);
  }
}

// Grid (ceil(T / BT), B): du_tile in bf16.
__global__ void __launch_bounds__(kThreads)
    du_kernel(const float* __restrict__ dc, const float* __restrict__ g,
              const float* __restrict__ sig, const int* __restrict__ lengths,
              const float* __restrict__ wdw, bf16* __restrict__ du, float* __restrict__ db1p,
              int t_len, int d, int k, int pl) {
  du_tile(dc, g, sig, lengths, wdw, du, db1p, nullptr, t_len, d, k, pl);
}

// Grid (D / 128, N / 128): dx = du W1.
__global__ void __launch_bounds__(kThreads, 2)
    dx_kernel(const bf16* __restrict__ du, const bf16* __restrict__ w1, bf16* __restrict__ dx,
              long n, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long n0 = (long)blockIdx.x * kTile;
  const long m0 = (long)blockIdx.y * kTile;
  Dx::Acc acc;
  Dx::zero(acc);
  Dx::run(acc, reinterpret_cast<bf16*>(smem), du, 2L * d, w1, d, m0, n0, n, d, 0, 2L * d);
  Dx::epilogue(acc, [&](int r, int c, float v0, float v1) {
    const long row = m0 + r, col = n0 + c;
    if (row < n && col < d) {
      *reinterpret_cast<__nv_bfloat162*>(dx + row * d + col) = __floats2bfloat162_rn(v0, v1);
    }
  });
}

// Grid (dW1 tiles + dW2 tiles, splits of N): each split's fp32 partials of
// dW1 = du^T x [2D, D] and dW2 = go^T sw [D, D].
__global__ void __launch_bounds__(kThreads, 2)
    dw_kernel(const bf16* __restrict__ du, const bf16* __restrict__ x, const bf16* __restrict__ go,
              const bf16* __restrict__ sw, float* __restrict__ dw1p, float* __restrict__ dw2p,
              long n, int d, long kchunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const long split = blockIdx.y;
  const long k0 = split * kchunk, k1 = k0 + kchunk < n ? k0 + kchunk : n;
  const int tn = (int)cdiv(d, kTile);
  const int tiles1 = (int)cdiv(2L * d, kTile) * tn;
  int t = blockIdx.x;
  Dw::Acc acc;
  Dw::zero(acc);
  long m0, n0, rows;
  float* out;
  if (t < tiles1) {
    m0 = (long)(t / tn) * kTile;
    n0 = (long)(t % tn) * kTile;
    rows = 2L * d;
    out = dw1p + split * 2 * d * d;
    Dw::run(acc, ring, du, 2L * d, x, d, m0, n0, rows, d, k0, k1);
  } else {
    t -= tiles1;
    m0 = (long)(t / tn) * kTile;
    n0 = (long)(t % tn) * kTile;
    rows = d;
    out = dw2p + split * d * d;
    Dw::run(acc, ring, go, d, sw, d, m0, n0, rows, d, k0, k1);
  }
  Dw::epilogue(acc, [&](int r, int c, float v0, float v1) {
    const long row = m0 + r, col = n0 + c;
    if (row < rows && col < d) {
      *reinterpret_cast<float2*>(out + row * d + col) = make_float2(v0, v1);
    }
  });
}

constexpr int kSumJobs = 5;  // vecp, dwdwp, db1p, dW1, dW2

// Grid (the jobs' blocks): sum_jobs.
__global__ void __launch_bounds__(kThreads) sum_kernel(const SumJobs<kSumJobs> jobs) {
  sum_jobs(jobs);
}

constexpr int kKernels = 8;  // glu, out, glu_sig, rows, du, dx, dw, sum

inline Launch launch_of(int which, int d, int k) {
  auto f = [](auto p) { return reinterpret_cast<const void*>(p); };
  switch (which) {
    case 0: return {f(glu_kernel), kThreads, Glu::kSmemBytes};
    case 1: return {f(out_kernel), kThreads, OutSmem(d, k).total};
    case 2: return {f(glu_sig_kernel), kThreads, Glu::kSmemBytes};
    case 3: return {d <= 256 ? f(rows_kernel<1>) : f(rows_kernel<2>), kThreads,
                    RowsSmem(d, k).total};
    case 4: return {f(du_kernel), kThreads, du_smem(d, k)};
    case 5: return {f(dx_kernel), kThreads, Dx::kSmemBytes};
    case 6: return {f(dw_kernel), kThreads, Dw::kSmemBytes};
    case 7: return {f(sum_kernel), kThreads, 0};
    default: return {nullptr, 0, 0};
  }
}

// allow_smem for every launch (rows_kernel at both widths), once.
inline void configure() {
  static const bool done = [] {
    Launch all[kKernels + 1];
    for (int i = 0; i < kKernels; ++i) all[i] = launch_of(i, 64, 1);
    all[kKernels] = launch_of(3, 512, 1);
    allow_smem(all, kKernels + 1);
    return true;
  }();
  (void)done;
}

inline int blocks_per_sm(int which, int d, int k, int* nb) {
  configure();
  return occupancy(launch_of(which, d, k), nb);
}

// Splits of N for dw_kernel: as many as fill the card's block slots with
// (dW1 + dW2 tiles) x splits blocks, each split at least 512 rows; at
// least 1. A negative value is minus a cudaError_t.
inline int dw_splits(long n, int d, int sms) {
  int per_sm = 0;
  if (int err = blocks_per_sm(6, d, 1, &per_sm)) return -err;
  const long tiles = cdiv(2L * d, kTile) * cdiv(d, kTile) + cdiv(d, kTile) * cdiv(d, kTile);
  const long s = std::min({n / 512, (long)sms * std::max(per_sm, 1) / tiles, 65535L});
  return (int)std::max(1L, s);
}

inline int info(int which, int d, int k, int* out) {
  configure();
  return launch_info(launch_of(which, d, k), out);
}

// Shapes the route takes (D up to 512: rows_kernel holds dsw for at most two
// column blocks of 256; shared memory bounds it there too).
inline bool shape_ok(int nb, int t, int d, int k, int pl) {
  return nb > 0 && nb <= 65535 && t > 0 && d > 0 && d % 64 == 0 && d <= 512 && k > 0 &&
         pl >= 0 && pl <= k - 1 && (long)nb * t <= 0x7fffffffL;
}

inline int launch_fwd(const bf16* x, const int* lengths, const bf16* w1, const float* b1,
                      const float* wdw, const float* bdw, const float* gamma, const float* beta,
                      const bf16* w2, const float* b2, float* g, bf16* out, int nb, int t, int d,
                      int k, int pl, float eps, cudaStream_t stream) {
  configure();
  const long n = (long)nb * t;
  glu_kernel<<<dim3((unsigned)cdiv(2L * d, kTile), (unsigned)cdiv(n, kTile)), kThreads,
               Glu::kSmemBytes, stream>>>(x, lengths, w1, b1, g, n, t, d);
  if (int err = counted("conv_bf16::glu_kernel")) return err;
  out_kernel<<<dim3((unsigned)cdiv(t, BT), (unsigned)nb), kThreads, OutSmem(d, k).total,
               stream>>>(g, wdw, bdw, gamma, beta, w2, b2, out, t, d, k, pl, eps);
  return counted("conv_bf16::out_kernel");
}

inline int launch_bwd(const bf16* x, const int* lengths, const bf16* w1, const float* b1,
                      const float* wdw, const float* bdw, const float* gamma, const float* beta,
                      const bf16* w2, const bf16* go, float* g, float* sig, float* dc, bf16* sw,
                      bf16* du, bf16* dx, float* vecp, float* dwdwp, float* db1p, float* dw1p,
                      float* dw2p, int nsplit, float* vec, float* dwdw, float* db1, bf16* dw1,
                      bf16* dw2, int nb, int t, int d, int k, int pl, float eps,
                      cudaStream_t stream) {
  configure();
  const long n = (long)nb * t;
  const dim3 row_tiles((unsigned)cdiv(t, BT), (unsigned)nb);
  glu_sig_kernel<<<dim3((unsigned)cdiv(2L * d, kTile), (unsigned)cdiv(n, kTile)), kThreads,
                   Glu::kSmemBytes, stream>>>(x, lengths, w1, b1, g, sig, n, t, d);
  if (int err = counted("conv_bf16::glu_sig_kernel")) return err;
  (d <= 256 ? rows_kernel<1> : rows_kernel<2>)<<<row_tiles, kThreads, RowsSmem(d, k).total,
                                                  stream>>>(g, wdw, bdw, gamma, beta, w2, go,
                                                            dc, sw, vecp, dwdwp, t, d, k, pl,
                                                            eps);
  if (int err = counted("conv_bf16::rows_kernel")) return err;
  du_kernel<<<row_tiles, kThreads, du_smem(d, k), stream>>>(dc, g, sig, lengths, wdw, du, db1p,
                                                             t, d, k, pl);
  if (int err = counted("conv_bf16::du_kernel")) return err;
  dx_kernel<<<dim3((unsigned)cdiv(d, kTile), (unsigned)cdiv(n, kTile)), kThreads, Dx::kSmemBytes,
              stream>>>(du, w1, dx, n, d);
  if (int err = counted("conv_bf16::dx_kernel")) return err;
  const long kchunk = cdiv(cdiv(n, nsplit), 32) * 32;
  const long tiles = cdiv(2L * d, kTile) * cdiv(d, kTile) + cdiv(d, kTile) * cdiv(d, kTile);
  dw_kernel<<<dim3((unsigned)tiles, (unsigned)nsplit), kThreads, Dw::kSmemBytes, stream>>>(
      du, x, go, sw, dw1p, dw2p, n, d, kchunk);
  if (int err = counted("conv_bf16::dw_kernel")) return err;
  const int ntiles = row_tiles.x * row_tiles.y;
  SumJobs<kSumJobs> jobs{{{vecp, vec, nullptr, 4 * d, ntiles, 0, 0},
                {dwdwp, dwdw, nullptr, d * k, ntiles, d, 0},  // [tile][k][D] -> [D, k]
                {db1p, db1, nullptr, 2 * d, ntiles, 0, 0},
                {dw1p, nullptr, dw1, 2 * d * d, nsplit, 0, 0},
                {dw2p, nullptr, dw2, d * d, nsplit, 0, 0}}};
  sum_kernel<<<(unsigned)sum_blocks(jobs), kThreads, 0, stream>>>(jobs);
  return counted("conv_bf16::sum_kernel");
}

}  // namespace conv_bf16

// ---- float32: each product once, on the fp32 GEMM mainloop -------------------
//
// Replaces espnet_slurp_tpu/ops/pallas/conv_module.py:_fwd_kernel and
// _bwd_kernel (the pallas_calls at :214 and :236) in float32, the route of
// ASRConfig(fused_conv=True) (fp32 compute) and of the fp32 card-against-CPU
// checks. Every value is fp32 and every product exact fp32 FMAs (no TF32).
//
// Bound: the fp32 units. At the transducer shape (N = 32 x 468 rows, D 256,
// k 31) the forward's two products are 6 N D^2 = 5.9 GFLOP (0.088 ms at 67
// TFLOP/s) and the backward's five 16 N D^2 = 15.7 GFLOP (0.234 ms); the taps
// add 0.24 GFLOP a pass. The compulsory traffic (x, go, out or dx, weights)
// is ~31-46 MB, 0.009-0.014 ms at 3.35 TB/s.
//
// Design. As conv_bf16: no product formed twice, pw1 one GEMM over the N = B
// T rows with the GLU in its epilogue, the conv, LayerNorm and swish (and
// their backward) as row-tile passes reading their k - 1 frames of halo
// from fp32 scratch that lives for the call. Every product runs on
// sgemm.cuh's mainloop (128-row block tiles, 8 x 8 register micro-tiles of
// FMAs, a 2-stage ring, K-major operands loaded along K), whose tile is
// 128 rows: too tall for a row tile's halo in shared memory beside the ring
// (160 rows of g at D 256 is 160 KB), so pw2 and dsw = go W2 are GEMM
// launches of their own through scratch (sw, dsw: 15 MB each at that
// shape, ~0.01 ms of traffic against products of 0.03-0.06 ms).
//   forward
//     glu_kernel      g = mask(a sigmoid(gate)) from x W1^T on 128 x 128
//                     tiles. A tile's 128 B rows are W1's a rows j0 .. j0 +
//                     63 and then their gate rows D + j0 .., by a row map in
//                     the B loader (GluHalves): a thread holds columns 4 tx
//                     + j of quad 0 and 64 + 4 tx + j of quad 1, so the a
//                     and gate of its 4 channels, and the GLU and pad mask
//                     run in the epilogue (float4 stores of g). (A row map
//                     costs one select a loaded row; a permuted copy of W1
//                     would cost a launch and a buffer a call.)
//     norm_kernel     per row tile: g's halo by cp.async, the taps in
//                     registers in place, LayerNorm and swish (a warp a
//                     row) into sw (fp32 scratch).
//     out_kernel      sw W2^T + b2 on 128 x 128 tiles.
//   backward
//     glu_sig_kernel  glu_kernel that also keeps sigmoid(gate).
//     dsw_kernel      dsw = go W2 on 128 x 128 tiles, into the dc buffer.
//     rows_kernel     per row tile, a thread a channel (D threads): the
//                     conv and LayerNorm again in place in g's halo, sw (for
//                     dW2), dn = dsw swish'(n) with the tile's dsw in
//                     registers, the LayerNorm backward dc (over dsw, in
//                     place), the tile's sums of dn chat, dn and dc; each
//                     row's sums over the channels by a transposed
//                     butterfly (31 shuffles for 32 rows) and the warps'
//                     partials.
//     du_kernel       du_tile in fp32: du [N, 2D], db1's tile partials, and
//                     the tap gradient from dc's halo against the tile's g
//                     (rows_kernel holds no register for it).
//     dx_kernel       dx = du W1 on 128 x 128 tiles.
//     dw_kernel       dW1 = du^T x and dW2 = go^T sw over splits of N (fp32
//                     partials a split); dW2's first column of tiles also
//                     sums go's columns (db2) from the stages as they land.
//     sum_kernel      every partial over its tiles or splits in a fixed
//                     order (no float atomics).
// Every launch counts itself on the host (common.cuh:counted).

namespace conv_f32 {

using namespace conv_rows;
using mma::Major;
constexpr int kThreads = sgemm::kThreads;  // every launch but rows_kernel (D threads)
constexpr int BM = sgemm::BM;              // rows of a GEMM block tile
constexpr int BN = 128;                    // its columns
constexpr int kGluC = BN / 2;              // channels of a GLU tile
constexpr int kMaxD = 512;                 // rows_kernel's threads (a channel each)
// x . W1^T (a / gate rows paired by GluHalves); sw . W2^T.
using Glu = sgemm::Gemm<BN, Major::K, Major::K>;
// go . W2; du . W1.
using Dsw = sgemm::Gemm<BN, Major::K, Major::MN>;
// du^T . x; go^T . sw.
using Dw = sgemm::Gemm<BN, Major::MN, Major::MN>;
static_assert(kThreads == espnet::kThreads && BT == 32, "one block shape; a row a lane");

// Tile row n of the GLU product's B operand, the tile's origin at W1's row
// j0: n < 64 is channel j0 + n's a row, n >= 64 the gate row D + j0 + n - 64.
struct GluHalves {
  int d;
  __device__ __forceinline__ int operator()(int n) const { return n < kGluC ? n : n + d - kGluC; }
};

// g (and with SIG, sigmoid(gate)) for a 128-row x 64-channel tile of the
// 1-D grid ((N / 128) x (D / 64)).
template <bool SIG>
__device__ __forceinline__ void glu_tile(float* ring, const float* __restrict__ x,
                                         const int* __restrict__ lengths,
                                         const float* __restrict__ w1, const float* __restrict__ b1,
                                         float* __restrict__ g, float* __restrict__ sig, int n,
                                         int t_len, int d) {
  const int tn = d / kGluC;
  const long m0 = (long)(blockIdx.x / tn) * BM;
  const int j0 = (int)(blockIdx.x % tn) * kGluC;
  Glu::Acc acc;
  Glu::zero(acc);
  sgemm::NoHook none;
  Glu::run(acc, ring, x, d, w1, d, m0, j0, n, 2L * d, 0, d, none, GluHalves{d});
  // acc[i][e]: a of channel ch + e; acc[i][4 + e]: its gate.
  const int ch = j0 + Glu::col(0);
  const float4 ba = sgemm::ld4(b1 + ch), bg = sgemm::ld4(b1 + d + ch);
  const float bav[4] = {ba.x, ba.y, ba.z, ba.w}, bgv[4] = {bg.x, bg.y, bg.z, bg.w};
#pragma unroll
  for (int i = 0; i < Glu::MI; ++i) {
    const long row = m0 + Glu::row(i);
    if (row >= n) continue;
    const int b = (int)(row / t_len);
    const bool keep = row - (long)b * t_len < valid_len(lengths, b, t_len);
    float gv[4], sv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sv[e] = sigmoid(acc[i][4 + e] + bgv[e]);
      gv[e] = keep ? (acc[i][e] + bav[e]) * sv[e] : 0.0f;
    }
    *reinterpret_cast<float4*>(g + row * d + ch) = make_float4(gv[0], gv[1], gv[2], gv[3]);
    if constexpr (SIG) {
      *reinterpret_cast<float4*>(sig + row * d + ch) = make_float4(sv[0], sv[1], sv[2], sv[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    glu_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
               const float* __restrict__ w1, const float* __restrict__ b1, float* __restrict__ g,
               int n, int t_len, int d) {
  __shared__ __align__(16) float ring[Glu::kRingFloats];
  glu_tile<false>(ring, x, lengths, w1, b1, g, nullptr, n, t_len, d);
}

__global__ void __launch_bounds__(kThreads, 2)
    glu_sig_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   float* __restrict__ g, float* __restrict__ sig, int n, int t_len, int d) {
  __shared__ __align__(16) float ring[Glu::kRingFloats];
  glu_tile<true>(ring, x, lengths, w1, b1, g, sig, n, t_len, d);
}

// Grid (ceil(T / BT), B): c = conv(g) + bdw in place in g's halo, then
// LayerNorm (two passes) and swish, a warp a row, into sw.
__global__ void __launch_bounds__(kThreads, 3)
    norm_kernel(const float* __restrict__ g, const float* __restrict__ wdw,
                const float* __restrict__ bdw, const float* __restrict__ gamma,
                const float* __restrict__ beta, float* __restrict__ sw, int t_len, int d, int k,
                int pl, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem);
  const int b = blockIdx.y;
  const long r0 = (long)blockIdx.x * BT;
  const long base = (long)b * t_len * d;
  // hs row h <- g at frame r0 - pl + h.
  load_halo(hs, g + base, r0 - pl, BT + k - 1, halo_rows(k), t_len, d);
  mma::cp_async_wait<0>();
  __syncthreads();
  for (int ch = threadIdx.x; ch < d; ch += kThreads) {
    conv_channel<false>(hs, d, ch, wdw + (long)ch * k, k, __ldg(bdw + ch),
                        [&](int r, const float(&acc)[R]) {
#pragma unroll
                          for (int q = 0; q < R; ++q) hs[(r + q) * d + ch] = acc[q];
                        });
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BT && r0 + r < t_len; r += kThreads / 32) {
    const float* row = hs + r * d;
    float s = 0.0f;
    for (int c = lane; c < d; c += 32) s += row[c];
    const float mean = warp_sum(s) / d;
    float v = 0.0f;
    for (int c = lane; c < d; c += 32) v += (row[c] - mean) * (row[c] - mean);
    const float rs = rsqrtf(warp_sum(v) / d + eps);
    float* out = sw + base + (r0 + r) * d;
    for (int c = lane; c < d; c += 32) {
      const float nv = (row[c] - mean) * rs * __ldg(gamma + c) + __ldg(beta + c);
      out[c] = nv * sigmoid(nv);
    }
  }
}

// Grid ((N / 128) x ceil(D / 128)): out = sw W2^T + b2.
__global__ void __launch_bounds__(kThreads, 2)
    out_kernel(const float* __restrict__ sw, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ out, int n, int d) {
  __shared__ __align__(16) float ring[Glu::kRingFloats];
  const long tn = cdiv(d, BN);
  const long m0 = (long)(blockIdx.x / tn) * BM, n0 = (long)(blockIdx.x % tn) * BN;
  Glu::Acc acc;
  Glu::zero(acc);
  Glu::run(acc, ring, sw, d, w2, d, m0, n0, n, d, 0, d);  // sw [N, D] . W2 [D, D]^T
  Glu::epilogue(acc, [&](int r, int c, float4 v) {
    const long row = m0 + r, col = n0 + c;
    if (row >= n || col >= d) return;
    const float4 bb = sgemm::ld4(b2 + col);
    *reinterpret_cast<float4*>(out + row * d + col) =
        make_float4(v.x + bb.x, v.y + bb.y, v.z + bb.z, v.w + bb.w);
  });
}

// Grid ((N / 128) x ceil(D / 128)): dsw = go W2.
__global__ void __launch_bounds__(kThreads, 2)
    dsw_kernel(const float* __restrict__ go, const float* __restrict__ w2, float* __restrict__ dsw,
               int n, int d) {
  __shared__ __align__(16) float ring[Dsw::kRingFloats];
  const long tn = cdiv(d, BN);
  const long m0 = (long)(blockIdx.x / tn) * BM, n0 = (long)(blockIdx.x % tn) * BN;
  Dsw::Acc acc;
  Dsw::zero(acc);
  Dsw::run(acc, ring, go, d, w2, d, m0, n0, n, d, 0, d);
  Dsw::epilogue(acc, [&](int r, int c, float4 v) {
    const long row = m0 + r, col = n0 + c;
    if (row < n && col < d) *reinterpret_cast<float4*>(dsw + row * d + col) = v;
  });
}

// Grid ((N / 128) x ceil(D / 128)): dx = du W1.
__global__ void __launch_bounds__(kThreads, 2)
    dx_kernel(const float* __restrict__ du, const float* __restrict__ w1, float* __restrict__ dx,
              int n, int d) {
  __shared__ __align__(16) float ring[Dsw::kRingFloats];
  const long tn = cdiv(d, BN);
  const long m0 = (long)(blockIdx.x / tn) * BM, n0 = (long)(blockIdx.x % tn) * BN;
  Dsw::Acc acc;
  Dsw::zero(acc);
  Dsw::run(acc, ring, du, 2L * d, w1, d, m0, n0, n, d, 0, 2L * d);
  Dsw::epilogue(acc, [&](int r, int c, float4 v) {
    const long row = m0 + r, col = n0 + c;
    if (row < n && col < d) *reinterpret_cast<float4*>(dx + row * d + col) = v;
  });
}

// One level of the transposed butterfly and the levels below it: lanes
// that differ in bit O swap halves of v[0 .. 2 O) and add, so that v[0 ..
// O) holds sums of the half of the rows that bit O of the lane selects.
template <int O>
__device__ __forceinline__ void fold(float (&v)[BT / 2], int lane) {
  if constexpr (O > 0) {
    const bool up = lane & O;
#pragma unroll
    for (int i = 0; i < O; ++i) {
      const float send = up ? v[i] : v[i + O];
      const float keep = up ? v[i + O] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    fold<O / 2>(v, lane);
  }
}

// Per-row sums over a block of a thread a channel: f(r) is the thread's
// value of row r; returns with tot[r] the block's sum of row r for r < BT.
// A transposed butterfly leaves lane l with the warp's sum of row l (31
// shuffles; its first level reads f, so it holds only BT / 2 partial sums
// in registers), the warps' sums meet in red [warps][BT].
template <class F>
__device__ __forceinline__ void row_sums(F&& f, float* red, float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int H = BT / 2;
  float v[H];
  const bool top = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = f(i), hi = f(i + H);
    v[i] = (top ? hi : lo) + __shfl_xor_sync(0xffffffffu, top ? lo : hi, H);
  }
  fold<H / 2>(v, lane);
  red[warp * BT + lane] = v[0];
  __syncthreads();
  if (warp == 0) {
    float s = 0.0f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w * BT + lane];
    tot[lane] = s;
  }
  __syncthreads();
}

// rows_kernel's dynamic shared memory: g's halo, the warps' row sums and
// four per-row statistics (sum c, sum (c - mean)^2, sum dchat, sum dchat
// chat).
__host__ __device__ inline size_t rows_smem(int d, int k) {
  return halo_bytes(d, k) + ((size_t)(d / 32) * BT + 4 * BT) * sizeof(float);
}

// Grid (ceil(T / BT), B), D threads (thread = channel). dsw_dc holds dsw on
// entry and dc on return (each element read and then written by its own
// thread). vecp[tile] <- the tile's column sums of dn chat, dn and dc
// (dgamma, dbeta, dbdw); tile = b ceil(T / BT) + blockIdx.x. c, then chat,
// stays in g's halo in place (a thread's own column), dsw then dn then dc
// in registers; the tap gradient is du_kernel's.
__global__ void __launch_bounds__(kMaxD)
    rows_kernel(const float* __restrict__ g, const float* __restrict__ wdw,
                const float* __restrict__ bdw, const float* __restrict__ gamma,
                const float* __restrict__ beta, float* __restrict__ dsw_dc,
                float* __restrict__ sw, float* __restrict__ vecp, int t_len, int d, int k, int pl,
                float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem);
  float* red = hs + (size_t)halo_rows(k) * d;
  float* stat = red + (d / 32) * BT;  // [4][BT]
  const int ch = threadIdx.x;
  const int b = blockIdx.y;
  const long r0 = (long)blockIdx.x * BT;
  const long base = (long)b * t_len * d;
  const int valid = (int)min((long)BT, t_len - r0);
  const long tile = (long)b * gridDim.x + blockIdx.x;
  const float inv_d = 1.0f / d;
  // hs row h <- g at frame r0 - pl + h; then rows r < BT of column ch <- c.
  load_halo(hs, g + base, r0 - pl, BT + k - 1, halo_rows(k), t_len, d, d);
  mma::cp_async_wait<0>();
  __syncthreads();
  conv_channel<false>(hs, d, ch, wdw + (long)ch * k, k, __ldg(bdw + ch),
                      [&](int r, const float(&acc)[R]) {
#pragma unroll
                        for (int q = 0; q < R; ++q) hs[(r + q) * d + ch] = acc[q];
                      });
  float* col = hs + ch;  // c, c - mean, chat
  row_sums([&](int r) { return col[r * d]; }, red, stat);
#pragma unroll
  for (int r = 0; r < BT; ++r) col[r * d] -= stat[r] * inv_d;
  row_sums([&](int r) { return col[r * d] * col[r * d]; }, red, stat + BT);
  float dn[BT];  // dsw, then dn, then dc
  const float* dsw_col = dsw_dc + base + r0 * d + ch;
#pragma unroll
  for (int r = 0; r < BT; ++r) dn[r] = r < valid ? dsw_col[(long)r * d] : 0.0f;
  const float gm = __ldg(gamma + ch), bt = __ldg(beta + ch);
  float sdg = 0.0f, sdb = 0.0f;
  float* sw_col = sw + base + r0 * d + ch;
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    const float chat = col[r * d] * rsqrtf(stat[BT + r] * inv_d + eps);
    col[r * d] = chat;
    const float nv = chat * gm + bt;
    const float sg = sigmoid(nv);
    if (r < valid) sw_col[(long)r * d] = nv * sg;
    dn[r] *= sg * (1.0f + nv * (1.0f - sg));
    sdg += dn[r] * chat;
    sdb += dn[r];
  }
  row_sums([&](int r) { return dn[r] * gm; }, red, stat + 2 * BT);
  row_sums([&](int r) { return dn[r] * gm * col[r * d]; }, red, stat + 3 * BT);
  // dc = rstd (dchat - mean(dchat) - chat mean(dchat chat)), dchat = dn gamma.
  float sdc = 0.0f;
  float* dc_col = dsw_dc + base + r0 * d + ch;
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    if (r >= valid) break;
    const float rs = rsqrtf(stat[BT + r] * inv_d + eps);
    const float dc =
        rs * (dn[r] * gm - stat[2 * BT + r] * inv_d - col[r * d] * stat[3 * BT + r] * inv_d);
    dc_col[(long)r * d] = dc;
    sdc += dc;
  }
  float* vp = vecp + tile * 3 * d + ch;
  vp[0] = sdg;
  vp[d] = sdb;
  vp[2 * d] = sdc;
}

// Grid (ceil(T / BT), B): du_tile in fp32, with the tap gradient.
__global__ void __launch_bounds__(kThreads)
    du_kernel(const float* __restrict__ dc, const float* __restrict__ g,
              const float* __restrict__ sig, const int* __restrict__ lengths,
              const float* __restrict__ wdw, float* __restrict__ du, float* __restrict__ db1p,
              float* __restrict__ dwdwp, int t_len, int d, int k, int pl) {
  du_tile<float, true>(dc, g, sig, lengths, wdw, du, db1p, dwdwp, t_len, d, k, pl);
}

// Column sums of the A stage (go's rows [BK][128 + 4] of a dW2 tile):
// thread t sums column t % 128 over half t / 128 of the stage's rows.
struct ColumnSumA {
  bool on;
  float sum;
  __device__ __forceinline__ void operator()(const float* sa, const float*) {
    if (!on) return;
    constexpr int kHalf = sgemm::BK / 2;
    const float* p = sa + (threadIdx.x >> 7) * kHalf * Dw::LDA + (threadIdx.x & 127);
#pragma unroll
    for (int r = 0; r < kHalf; ++r) sum += p[r * Dw::LDA];
  }
};

// Grid (dW1 tiles + dW2 tiles, splits of N): each split's fp32 partials of
// dW1 = du^T x [2D, D] and dW2 = go^T sw [D, D]; the dW2 tiles at column 0
// also write the split's column sums of go (db2p [split][D]).
__global__ void __launch_bounds__(kThreads, 2)
    dw_kernel(const float* __restrict__ du, const float* __restrict__ x,
              const float* __restrict__ go, const float* __restrict__ sw,
              float* __restrict__ dw1p, float* __restrict__ dw2p, float* __restrict__ db2p,
              int n, int d, long kchunk) {
  static_assert(kThreads == 2 * BM, "ColumnSumA's thread map");
  __shared__ __align__(16) float ring[Dw::kRingFloats];
  const long split = blockIdx.y;
  const long k0 = split * kchunk, k1 = k0 + kchunk < n ? k0 + kchunk : n;
  const long tn = cdiv(d, BN);
  const long tiles1 = cdiv(2L * d, BM) * tn;
  const bool w1_tile = blockIdx.x < tiles1;  // else a dW2 tile
  const long t = w1_tile ? blockIdx.x : blockIdx.x - tiles1;
  const long m0 = (t / tn) * BM, n0 = (t % tn) * BN;
  const long rows = w1_tile ? 2L * d : d;
  Dw::Acc acc;
  Dw::zero(acc);
  ColumnSumA db2{!w1_tile && n0 == 0, 0.0f};
  if (w1_tile) {  // du^T [2D, N] . x [N, D]
    Dw::run(acc, ring, du, 2L * d, x, d, m0, n0, rows, d, k0, k1);
  } else {  // go^T [D, N] . sw [N, D]
    Dw::run(acc, ring, go, d, sw, d, m0, n0, rows, d, k0, k1, db2);
  }
  float* out = w1_tile ? dw1p + split * 2 * d * d : dw2p + split * d * d;
  Dw::epilogue(acc, [&](int r, int c, float4 v) {
    const long row = m0 + r, col = n0 + c;
    if (row < rows && col < d) *reinterpret_cast<float4*>(out + row * d + col) = v;
  });
  if (db2.on) {  // block-uniform
    float* red = ring;  // [2][128]; the ring is free after run
    red[threadIdx.x] = db2.sum;
    __syncthreads();
    if (threadIdx.x < BM && m0 + threadIdx.x < d) {
      db2p[split * d + m0 + threadIdx.x] = red[threadIdx.x] + red[BM + threadIdx.x];
    }
  }
}

constexpr int kSumJobs = 6;  // vecp, dwdwp, db1p, dW1, dW2, db2p

// Grid (the jobs' blocks): sum_jobs.
__global__ void __launch_bounds__(kThreads) sum_kernel(const SumJobs<kSumJobs> jobs) {
  sum_jobs(jobs);
}

constexpr int kKernels = 10;  // glu, norm, out, glu_sig, dsw, rows, du, dx, dw, sum

inline Launch launch_of(int which, int d, int k) {
  auto f = [](auto p) { return reinterpret_cast<const void*>(p); };
  switch (which) {
    case 0: return {f(glu_kernel), kThreads, 0};
    case 1: return {f(norm_kernel), kThreads, halo_bytes(d, k)};
    case 2: return {f(out_kernel), kThreads, 0};
    case 3: return {f(glu_sig_kernel), kThreads, 0};
    case 4: return {f(dsw_kernel), kThreads, 0};
    case 5: return {f(rows_kernel), d, rows_smem(d, k)};
    case 6: return {f(du_kernel), kThreads, halo_bytes(d, k)};
    case 7: return {f(dx_kernel), kThreads, 0};
    case 8: return {f(dw_kernel), kThreads, 0};
    case 9: return {f(sum_kernel), kThreads, 0};
    default: return {nullptr, 0, 0};
  }
}

// allow_smem for every launch, once.
inline void configure() {
  static const bool done = [] {
    Launch all[kKernels];
    for (int i = 0; i < kKernels; ++i) all[i] = launch_of(i, 64, 1);
    allow_smem(all, kKernels);
    return true;
  }();
  (void)done;
}

inline int blocks_per_sm(int which, int d, int k, int* nb) {
  configure();
  return occupancy(launch_of(which, d, k), nb);
}

// Splits of N for dw_kernel: as many as fill the card's block slots with
// (dW1 + dW2 tiles) x splits blocks, each split at least 512 rows; at
// least 1. A negative value is minus a cudaError_t.
inline int dw_splits(long n, int d, int sms) {
  int per_sm = 0;
  if (int err = blocks_per_sm(8, d, 1, &per_sm)) return -err;
  const long tiles = cdiv(2L * d, BM) * cdiv(d, BN) + cdiv(d, BM) * cdiv(d, BN);
  const long s = std::min({n / 512, (long)sms * std::max(per_sm, 1) / tiles, 65535L});
  return (int)std::max(1L, s);
}

inline int info(int which, int d, int k, int* out) {
  configure();
  return launch_info(launch_of(which, d, k), out);
}

// Shapes the route takes: D a multiple of 64 up to kMaxD (rows_kernel's
// thread a channel), the halo within the card's shared memory (at D 512, k
// up to 64), N B T rows with N 2D below 2^31.
inline bool shape_ok(int nb, int t, int d, int k, int pl) {
  return nb > 0 && nb <= 65535 && t > 0 && d > 0 && d % 64 == 0 && d <= kMaxD && k > 0 &&
         pl >= 0 && pl <= k - 1 && (long)nb * t * 2 * d <= 0x7fffffffL &&
         rows_smem(d, k) <= (size_t)max_smem();
}

inline int launch_fwd(const float* x, const int* lengths, const float* w1, const float* b1,
                      const float* wdw, const float* bdw, const float* gamma, const float* beta,
                      const float* w2, const float* b2, float* g, float* sw, float* out, int nb,
                      int t, int d, int k, int pl, float eps, cudaStream_t stream) {
  configure();
  const int n = nb * t;
  const unsigned mt = (unsigned)cdiv(n, BM);
  glu_kernel<<<mt * (unsigned)(d / kGluC), kThreads, 0, stream>>>(x, lengths, w1, b1, g, n, t, d);
  if (int err = counted("conv_f32::glu_kernel")) return err;
  norm_kernel<<<dim3((unsigned)cdiv(t, BT), (unsigned)nb), kThreads, halo_bytes(d, k), stream>>>(
      g, wdw, bdw, gamma, beta, sw, t, d, k, pl, eps);
  if (int err = counted("conv_f32::norm_kernel")) return err;
  out_kernel<<<mt * (unsigned)cdiv(d, BN), kThreads, 0, stream>>>(sw, w2, b2, out, n, d);
  return counted("conv_f32::out_kernel");
}

inline int launch_bwd(const float* x, const int* lengths, const float* w1, const float* b1,
                      const float* wdw, const float* bdw, const float* gamma, const float* beta,
                      const float* w2, const float* go, float* g, float* sig, float* dc, float* sw,
                      float* du, float* dx, float* vecp, float* dwdwp, float* db1p, float* dw1p,
                      float* dw2p, float* db2p, int nsplit, float* vec, float* dwdw, float* db1,
                      float* dw1, float* dw2, float* db2, int nb, int t, int d, int k, int pl,
                      float eps, cudaStream_t stream) {
  configure();
  const int n = nb * t;
  const unsigned mt = (unsigned)cdiv(n, BM);
  const dim3 row_tiles((unsigned)cdiv(t, BT), (unsigned)nb);
  glu_sig_kernel<<<mt * (unsigned)(d / kGluC), kThreads, 0, stream>>>(x, lengths, w1, b1, g, sig,
                                                                       n, t, d);
  if (int err = counted("conv_f32::glu_sig_kernel")) return err;
  dsw_kernel<<<mt * (unsigned)cdiv(d, BN), kThreads, 0, stream>>>(go, w2, dc, n, d);
  if (int err = counted("conv_f32::dsw_kernel")) return err;
  rows_kernel<<<row_tiles, d, rows_smem(d, k), stream>>>(g, wdw, bdw, gamma, beta, dc, sw, vecp,
                                                         t, d, k, pl, eps);
  if (int err = counted("conv_f32::rows_kernel")) return err;
  du_kernel<<<row_tiles, kThreads, halo_bytes(d, k), stream>>>(dc, g, sig, lengths, wdw, du, db1p,
                                                               dwdwp, t, d, k, pl);
  if (int err = counted("conv_f32::du_kernel")) return err;
  dx_kernel<<<mt * (unsigned)cdiv(d, BN), kThreads, 0, stream>>>(du, w1, dx, n, d);
  if (int err = counted("conv_f32::dx_kernel")) return err;
  const long kchunk = cdiv(cdiv(n, nsplit), sgemm::BK) * sgemm::BK;
  const long tiles = cdiv(2L * d, BM) * cdiv(d, BN) + cdiv(d, BM) * cdiv(d, BN);
  dw_kernel<<<dim3((unsigned)tiles, (unsigned)nsplit), kThreads, 0, stream>>>(
      du, x, go, sw, dw1p, dw2p, db2p, n, d, kchunk);
  if (int err = counted("conv_f32::dw_kernel")) return err;
  const int ntiles = row_tiles.x * row_tiles.y;
  SumJobs<kSumJobs> jobs{{{vecp, vec, nullptr, 3 * d, ntiles, 0, 0},
                          {dwdwp, dwdw, nullptr, d * k, ntiles, d, 0},  // [tile][k][D] -> [D, k]
                          {db1p, db1, nullptr, 2 * d, ntiles, 0, 0},
                          {dw1p, dw1, nullptr, 2 * d * d, nsplit, 0, 0},
                          {dw2p, dw2, nullptr, d * d, nsplit, 0, 0},
                          {db2p, db2, nullptr, d, nsplit, 0, 0}}};
  sum_kernel<<<(unsigned)sum_blocks(jobs), kThreads, 0, stream>>>(jobs);
  return counted("conv_f32::sum_kernel");
}

}  // namespace conv_f32

}  // namespace espnet

// Row tile of the backward's row-tile launches (both dtypes): vecp, dwdwp
// and db1p hold B * ceil(T / tile) partials.
extern "C" int espnet_conv_rows_tile() { return espnet::conv_rows::BT; }

// The float32 route. x: [B, T, D]; lengths: int32 [B]; w1 [2D, D]; b1 [2D];
// wdw [D, k]; bdw, gamma, beta, b2 [D]; w2 [D, D]; scratch g, sw: [B, T,
// D]; out [B, T, D]; all f32. pl: left padding of the depthwise conv ((k -
// 1) / 2 SAME, k - 1 causal). Returns a cudaError_t code (0 = launched).
extern "C" int espnet_conv_f32_fwd(const float* x, const int* lengths, const float* w1,
                                   const float* b1, const float* wdw, const float* bdw,
                                   const float* gamma, const float* beta, const float* w2,
                                   const float* b2, float* g, float* sw, float* out, int b, int t,
                                   int d, int k, int pl, float eps, void* stream) {
  using namespace espnet;
  if (!conv_f32::shape_ok(b, t, d, k, pl) || !g || !sw) return (int)cudaErrorInvalidValue;
  return conv_f32::launch_fwd(x, lengths, w1, b1, wdw, bdw, gamma, beta, w2, b2, g, sw, out, b, t,
                              d, k, pl, eps, static_cast<cudaStream_t>(stream));
}

// Backward of the float32 route. go, dx: [B, T, D]; scratch g, sig, dc, sw:
// [B, T, D], du: [B, T, 2D]; fp32 partials with tiles = B ceil(T /
// espnet_conv_rows_tile()): vecp [tiles, 3, D], dwdwp [tiles, k, D], db1p
// [tiles, 2D], dw1p [nsplit, 2D, D], dw2p [nsplit, D, D], db2p [nsplit, D],
// nsplit from espnet_conv_f32_dw_splits. The sums: vec [3, D] (dgamma,
// dbeta, dbdw), dwdw [D, k], db1 [2D], dw1 [2D, D], dw2 [D, D], db2 [D].
// All f32. Returns a cudaError_t code.
extern "C" int espnet_conv_f32_bwd(const float* x, const int* lengths, const float* w1,
                                   const float* b1, const float* wdw, const float* bdw,
                                   const float* gamma, const float* beta, const float* w2,
                                   const float* go, float* g, float* sig, float* dc, float* sw,
                                   float* du, float* dx, float* vecp, float* dwdwp, float* db1p,
                                   float* dw1p, float* dw2p, float* db2p, int nsplit, float* vec,
                                   float* dwdw, float* db1, float* dw1, float* dw2, float* db2,
                                   int b, int t, int d, int k, int pl, float eps, void* stream) {
  using namespace espnet;
  if (!conv_f32::shape_ok(b, t, d, k, pl) || nsplit <= 0 || nsplit > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return conv_f32::launch_bwd(x, lengths, w1, b1, wdw, bdw, gamma, beta, w2, go, g, sig, dc, sw,
                              du, dx, vecp, dwdwp, db1p, dw1p, dw2p, db2p, nsplit, vec, dwdw, db1,
                              dw1, dw2, db2, b, t, d, k, pl, eps,
                              static_cast<cudaStream_t>(stream));
}

// Splits of N = B T for the float32 backward's dw_kernel on a card of `sms`
// SMs at width D; a negative value is minus a cudaError_t code.
extern "C" int espnet_conv_f32_dw_splits(int n, int d, int sms) {
  if (n <= 0 || d <= 0 || d % 64 || sms <= 0) return -(int)cudaErrorInvalidValue;
  return espnet::conv_f32::dw_splits(n, d, sms);
}

// info[0..3] <- registers a thread, shared bytes (static and dynamic at
// width D and k taps), local (spill) bytes and blocks per SM of the float32
// route's kernel `which`: 0 glu, 1 norm, 2 out, 3 glu_sig, 4 dsw, 5 rows, 6
// du, 7 dx, 8 dw, 9 sum. Returns a cudaError_t code.
extern "C" int espnet_conv_f32_info(int which, int d, int k, int* info) {
  if (d <= 0 || d % 64 || d > espnet::conv_f32::kMaxD || k <= 0) return (int)cudaErrorInvalidValue;
  return espnet::conv_f32::info(which, d, k, info);
}

// The bfloat16 route. x: [B, T, D]; lengths: int32 [B]; w1 [2D, D], w2 [D, D]
// bf16; b1 [2D], wdw [D, k], bdw, gamma, beta, b2 [D] f32; g: f32 [B, T, D]
// scratch; out [B, T, D] bf16. D a multiple of 64. Returns a cudaError_t code.
extern "C" int espnet_conv_bf16_fwd(const void* x, const int* lengths, const void* w1,
                                    const float* b1, const float* wdw, const float* bdw,
                                    const float* gamma, const float* beta, const void* w2,
                                    const float* b2, float* g, void* out, int b, int t, int d,
                                    int k, int pl, float eps, void* stream) {
  using namespace espnet;
  if (!conv_bf16::shape_ok(b, t, d, k, pl) || !g) return (int)cudaErrorInvalidValue;
  return conv_bf16::launch_fwd(static_cast<const bf16*>(x), lengths, static_cast<const bf16*>(w1),
                               b1, wdw, bdw, gamma, beta, static_cast<const bf16*>(w2), b2, g,
                               static_cast<bf16*>(out), b, t, d, k, pl, eps,
                               static_cast<cudaStream_t>(stream));
}

// Backward of the bfloat16 route. go, dx: [B, T, D] bf16; scratch g, sig,
// dc: f32 [B, T, D], sw: bf16 [B, T, D], du: bf16 [B, T, 2D], and fp32
// partials with tiles = B ceil(T / espnet_conv_rows_tile()):
// vecp [tiles, 4, D], dwdwp [tiles, k, D], db1p [tiles, 2D], dw1p [nsplit,
// 2D, D], dw2p [nsplit, D, D], nsplit from espnet_conv_bf16_dw_splits. The
// sums: vec f32 [4, D] (db2, dgamma, dbeta, dbdw), dwdw f32 [D, k], db1 f32
// [2D], dw1 bf16 [2D, D], dw2 bf16 [D, D]. Returns a cudaError_t code.
extern "C" int espnet_conv_bf16_bwd(const void* x, const int* lengths, const void* w1,
                                    const float* b1, const float* wdw, const float* bdw,
                                    const float* gamma, const float* beta, const void* w2,
                                    const void* go, float* g, float* sig, float* dc, void* sw,
                                    void* du, void* dx, float* vecp, float* dwdwp, float* db1p,
                                    float* dw1p, float* dw2p, int nsplit, float* vec,
                                    float* dwdw, float* db1, void* dw1, void* dw2, int b, int t,
                                    int d, int k, int pl, float eps, void* stream) {
  using namespace espnet;
  if (!conv_bf16::shape_ok(b, t, d, k, pl) || nsplit <= 0 || nsplit > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  auto out = [](void* p) { return static_cast<bf16*>(p); };
  return conv_bf16::launch_bwd(in(x), lengths, in(w1), b1, wdw, bdw, gamma, beta, in(w2), in(go),
                               g, sig, dc, out(sw), out(du), out(dx), vecp, dwdwp, db1p, dw1p,
                               dw2p, nsplit, vec, dwdw, db1, out(dw1), out(dw2), b, t, d, k, pl,
                               eps, static_cast<cudaStream_t>(stream));
}

// Splits of N = B T for the bfloat16 backward's dw_kernel on a card of `sms`
// SMs at width D; a negative value is minus a cudaError_t code.
extern "C" int espnet_conv_bf16_dw_splits(int n, int d, int sms) {
  if (n <= 0 || d <= 0 || d % 64 || sms <= 0) return -(int)cudaErrorInvalidValue;
  return espnet::conv_bf16::dw_splits(n, d, sms);
}

// info[0..3] <- registers a thread, shared bytes (static and dynamic at
// width D and k taps), local (spill) bytes and blocks per SM of the bfloat16
// route's kernel `which`: 0 glu, 1 out, 2 glu_sig, 3 rows, 4 du, 5 dx, 6 dw,
// 7 sum.
// Returns a cudaError_t code.
extern "C" int espnet_conv_bf16_info(int which, int d, int k, int* info) {
  if (d <= 0 || d % 64 || k <= 0) return (int)cudaErrorInvalidValue;
  return espnet::conv_bf16::info(which, d, k, info);
}
