// Fused CTC head: projection + logsumexp + label gather, forward and backward,
// with no [B, T, V] logits in device memory.
//
//   logits[b, t, v] = hs[b, t] . W[v] + bias[v]          (W: [V, D], bf16/fp32)
//   z[b, t]         = logsumexp_v logits[b, t, v]
//   emit[b, t, s]   = logits[b, t, ext[b, s]] - z[b, t]
// Backward, from demit g [B, T, S]:
//   dlogits = scatter_s(g) - softmax(logits) * sum_s g     (duplicates add)
//   dhs = dlogits . W,  dW = dlogits^T . hs,  dbias = sum over rows of dlogits
//
// Replaces the TPU kernel espnet_slurp_tpu/ops/pallas/ctc_head.py:
// fused_ctc_head_emit (_fwd_kernel, _bwd_kernel), the CTC branch of the
// flagship train step (models/asr_model.py:_ctc_loss_mean).
//
// What bounds it on the H100: at the flagship train step (N = 64 x 471 rows,
// D = 256, V = 5000, bf16) each pass over the vocabulary is a 2*N*D*V = 77
// GFLOP product against ~16 MB of hs and ~15 MB of emissions: ~2,500 FLOP per
// byte, far above the ridge, so the tensor cores bound it. The plain
// composition writes and re-reads fp32 [N, V] logits, softmax and their
// gradient (~0.6 GB each), which is what the TPU kernel was written to avoid.
//
// Two routes by dtype, each two launches forward and three backward, with
// the same plan (espnet_ctc_head_plan) and the same gather launch:
//   bf16 (the flagship's training): lse on the bf16 mma.sync mainloop of
//     mma_gemm.cuh (ctc_head_bf16), gather (ctc_head_fwd, fp32 dot products
//     of the widened rows), and the tensor-core backward ctc_head_bwd;
//   float32 (the default ASRConfig's training and the fp32 card-against-CPU
//     checks): ctc_head_f32, lse and the three backward launches on the
//     register-tiled fp32 GEMM mainloop of sgemm.cuh, and the same gather.
// Both save z for the backward, so no backward runs a logsumexp pass.
//
// Rounding: the reference rounds the gathered logit (forward) and g before
// its one-hot scatter (backward) to bf16, artifacts of doing the gather as a
// matrix product on the TPU; the port gathers and scatters in fp32 (ROADMAP
// queue 3). dlogits is rounded to the element type before the two products
// and dbias summed from the unrounded values, as the reference does.
#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "mma_gemm.cuh"
#include "sgemm.cuh"

namespace espnet {

// ---- Backward, bf16: three tensor-core GEMM kernels ------------------------
//
// Replaces espnet_slurp_tpu/ops/pallas/ctc_head.py:_bwd_kernel (the
// pallas_call of fused_ctc_head_emit's core_bwd, :179) in bf16. Over the N =
// B T rows of hs, with z saved by the forward and dsum = sum_s g (the
// wrapper's row sum):
//   dlg  = scatter_s(g) - exp(hs W^T + bias - z) dsum   (fp32; duplicates add)
//   dhs  = bf16(dlg) W,  dW = bf16(dlg)^T hs,  dbias = sum over rows of dlg.
//
// Bound: the tensor cores. The logits, dhs and dW are three products of
// 2 N D V operations: 230 GFLOP at the flagship train shape (N = 64 x 468,
// D 256, V 5000), 0.233 ms at 989 TFLOP/s, against ~70 MB of compulsory
// traffic (hs, W, g in; dhs, dW, dbias out; 0.02 ms).
//
// Why scratch, not the TPU's single pass (the same reason as K2's backward):
// the TPU kernel walks row tiles in order and sums dW in VMEM across its
// grid; 132 SMs running blocks in no order cannot, and a kernel that
// recomputes the logits for dhs and again for dW (the fp32 path above) does
// four products for three. So `rows` forms dlg once, rounds it and writes a
// bf16 [N, VP] scratch (VP = V rounded up to 8, pad columns zero; ~300 MB at
// the flagship shape, for the length of the call); `dx` and `dw` read it.
// Each product is the register-accumulator mainloop of mma_gemm.cuh on a
// 4-stage cp.async ring, 8 warps of 64 x 32 a 128 x 128 tile:
//   rows grid (V / 128, N / 128): the logits tile hs W^T (both K-major) into
//        registers; the epilogue forms -exp(lg - z) dsum into an fp32 tile in
//        the ring's shared memory (zero past N and past V), adds g there by
//        shared atomics for the labels that fall in the tile (listed once per
//        utterance the tile's rows span, so a tile may span utterances), then writes
//        the tile rounded to bf16 with 16-byte stores and one fp32 dbias
//        partial per row tile from the unrounded values.
//   dx   grid (D / 128, N / 128): dlg W, K = V, W read MN-major.
//   dw   grid (V / 128 x D / 128, splits of N): dlg^T hs, both operands
//        MN-major (ldmatrix.trans), fp32 partials per split that the wrapper
//        sums with dbias's (deterministic; the scatter's atomics order only
//        the duplicates of one label in one row).

namespace ctc_head_bwd {

using mma::Gemm;
using mma::Major;
constexpr int kStages = 4;
constexpr int BT = 128;       // rows and V columns of a rows block; rows of a dbias partial
constexpr int LDT = BT + 4;   // fp32 dlg tile rows in shared memory
constexpr int kList = 1024;   // labels of one utterance listed at a time by the scatter
using Rows = Gemm<BT, BT, 32, 64, 32, kStages, Major::K, Major::K>;
using Dx = Gemm<BT, 128, 32, 64, 32, kStages, Major::K, Major::MN>;
using Dw = Gemm<128, 128, 32, 64, 32, kStages, Major::MN, Major::MN>;
static_assert(Rows::kThreads == 2 * BT && Dx::kThreads == Rows::kThreads &&
                  Dw::kThreads == Rows::kThreads, "one block shape, two threads a column");
static_assert((size_t)(BT * LDT + 2 * BT + 4) * sizeof(float) + kList * sizeof(int2) <=
                  Rows::kSmemBytes,
              "the dlg tile, the dbias halves and the label list fit in the ring");

__host__ __device__ constexpr long cdiv(long a, long b) { return (a + b - 1) / b; }

__global__ void __launch_bounds__(2 * BT, 2)
    rows_kernel(const bf16* __restrict__ hs, const bf16* __restrict__ w,
                const float* __restrict__ bias, const int* __restrict__ ext,
                const float* __restrict__ z, const float* __restrict__ dsum,
                const float* __restrict__ g, bf16* __restrict__ dlg, float* __restrict__ dbp,
                int n, int t, int d, int v, int vp, int s_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long n0 = (long)blockIdx.x * BT;  // vocabulary columns
  const long m0 = (long)blockIdx.y * BT;  // rows of hs
  Rows::Acc acc;
  Rows::zero(acc);
  Rows::run(acc, reinterpret_cast<bf16*>(smem), hs, d, w, d, m0, n0, n, v, 0, d);

  // -exp(lg - z) dsum into the fp32 tile (the ring is free after run).
  float* tile = reinterpret_cast<float*>(smem);
  Rows::epilogue(acc, [&](int r, int c, float v0, float v1) {
    const long row = m0 + r, col = n0 + c;
    float o0 = 0.0f, o1 = 0.0f;
    if (row < n) {
      const float zr = z[row], ds = dsum[row];
      if (col < v) o0 = -__expf(v0 + bias[col] - zr) * ds;
      if (col + 1 < v) o1 = -__expf(v1 + bias[col + 1] - zr) * ds;
    }
    *reinterpret_cast<float2*>(tile + r * LDT + c) = make_float2(o0, o1);
  });
  __syncthreads();

  // scatter_s(g). For each utterance whose rows the tile holds, the labels
  // that fall in this V tile are listed once, (column, s), kList at a time;
  // then each of its rows adds g at those columns, neighbouring lanes on
  // neighbouring rows (distinct addresses, also for the blank's many
  // states). Checking every (row, label) pair in every V tile instead cost
  // the kernel ~1.3 ms at the flagship shape.
  const int rows = n - m0 < BT ? (int)(n - m0) : BT;
  int* nlist = reinterpret_cast<int*>(tile + BT * LDT + 2 * BT);
  int2* list = reinterpret_cast<int2*>(nlist + 4);
  for (long bb = m0 / t; bb <= (m0 + rows - 1) / t; ++bb) {
    const int r_lo = bb * t > m0 ? (int)(bb * t - m0) : 0;
    const int nr = ((bb + 1) * t - m0 < rows ? (int)((bb + 1) * t - m0) : rows) - r_lo;
    for (int s0 = 0; s0 < s_len; s0 += kList) {
      if (threadIdx.x == 0) *nlist = 0;
      __syncthreads();
      for (int sl = s0 + threadIdx.x; sl < min(s_len, s0 + kList); sl += blockDim.x) {
        const int lab = min(max(ext[bb * s_len + sl], 0), v - 1);
        const long c = lab - n0;
        if (c >= 0 && c < BT) list[atomicAdd(nlist, 1)] = make_int2((int)c, sl);
      }
      __syncthreads();
      const int cnt = *nlist;
      for (int idx = threadIdx.x; idx < nr * cnt; idx += blockDim.x) {
        const int j = idx / nr;
        const int r = r_lo + idx - j * nr;
        atomicAdd(tile + r * LDT + list[j].x, g[(m0 + r) * s_len + list[j].y]);
      }
      __syncthreads();  // the list is rebuilt next; the tile is complete
    }
  }

  // bf16(dlg) into the scratch, 8 columns (16 bytes) a store; pad columns
  // [V, VP) hold the epilogue's zeros.
  constexpr int CH = BT / 8;
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
    const int r = idx / CH;
    const int c = (idx - r * CH) * 8;
    if (n0 + c >= vp) continue;
    const float* src = tile + r * LDT + c;
    uint4 pk;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&pk);
#pragma unroll
    for (int q = 0; q < 4; ++q) h2[q] = __floats2bfloat162_rn(src[2 * q], src[2 * q + 1]);
    *reinterpret_cast<uint4*>(dlg + (m0 + r) * vp + n0 + c) = pk;
  }

  // dbias partial of this row tile from the unrounded dlg (rows past N are
  // zero): thread t sums column t % BT over half t / BT of the rows.
  float* red = tile + BT * LDT;
  {
    const int c = threadIdx.x & (BT - 1), half = threadIdx.x / BT;
    float sum = 0.0f;
    for (int r = half * (BT / 2); r < (half + 1) * (BT / 2); ++r) sum += tile[r * LDT + c];
    red[half * BT + c] = sum;
  }
  __syncthreads();
  if (threadIdx.x < BT && n0 + threadIdx.x < v) {
    dbp[(long)blockIdx.y * v + n0 + threadIdx.x] = red[threadIdx.x] + red[BT + threadIdx.x];
  }
}

__global__ void __launch_bounds__(2 * BT, 2)
    dx_kernel(const bf16* __restrict__ dlg, const bf16* __restrict__ w, bf16* __restrict__ dhs,
              int n, int d, int v, int vp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long n0 = (long)blockIdx.x * 128;
  const long m0 = (long)blockIdx.y * BT;
  Dx::Acc acc;
  Dx::zero(acc);
  // dlg [N, VP] . W [V, D]: K = V; W's rows past V and dlg's pad read as zero.
  Dx::run(acc, reinterpret_cast<bf16*>(smem), dlg, vp, w, d, m0, n0, n, d, 0, v);
  Dx::epilogue(acc, [&](int r, int c, float v0, float v1) {
    const long row = m0 + r, col = n0 + c;
    if (row < n && col < d) {
      *reinterpret_cast<__nv_bfloat162*>(dhs + row * d + col) = __floats2bfloat162_rn(v0, v1);
    }
  });
}

__global__ void __launch_bounds__(2 * BT, 2)
    dw_kernel(const bf16* __restrict__ dlg, const bf16* __restrict__ hs, float* __restrict__ dwp,
              int n, int d, int v, int vp, long kchunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long split = blockIdx.y;
  const long k0 = split * kchunk, k1 = k0 + kchunk < n ? k0 + kchunk : n;
  const int dtiles = (int)cdiv(d, 128);
  const long m0 = (long)(blockIdx.x / dtiles) * 128;  // vocabulary rows of dW
  const long n0 = (long)(blockIdx.x % dtiles) * 128;  // columns of D
  Dw::Acc acc;
  Dw::zero(acc);
  // dlg^T [VP, N] . hs [N, D] over rows k0 .. k1 of this split.
  Dw::run(acc, reinterpret_cast<bf16*>(smem), dlg, vp, hs, d, m0, n0, v, d, k0, k1);
  float* out = dwp + split * v * d;
  Dw::epilogue(acc, [&](int r, int c, float v0, float v1) {
    const long row = m0 + r, col = n0 + c;
    if (row < v && col < d) {
      *reinterpret_cast<float2*>(out + row * d + col) = make_float2(v0, v1);
    }
  });
}

// Launches rows, dx and dw on `stream`; returns the first non-zero
// cudaError_t. dlg: bf16 [n, vp] scratch; dbp: cdiv(n, BT) dbias partials
// [., v]; dwp: nsplit dW partials [., v, d].
inline int launch(const bf16* hs, const bf16* w, const float* bias, const int* ext,
                  const float* z, const float* dsum, const float* g, bf16* dlg, bf16* dhs,
                  float* dwp, float* dbp, int nsplit, int n, int t, int d, int v, int vp,
                  int s_len, cudaStream_t stream) {
  const long row_tiles = cdiv(n, BT);
  if (n <= 0 || t <= 0 || d <= 0 || d % 16 || v <= 0 || vp < v || vp % 8 || s_len <= 0 ||
      nsplit <= 0 || nsplit > 65535 || row_tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaFuncSetAttribute(rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)Rows::kSmemBytes);
  cudaFuncSetAttribute(dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)Dx::kSmemBytes);
  cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)Dw::kSmemBytes);
  rows_kernel<<<dim3((unsigned)cdiv(v, BT), (unsigned)row_tiles), 2 * BT, Rows::kSmemBytes,
                stream>>>(hs, w, bias, ext, z, dsum, g, dlg, dbp, n, t, d, v, vp, s_len);
  if (int err = counted("ctc_head_bwd::rows_kernel")) return err;
  dx_kernel<<<dim3((unsigned)cdiv(d, 128), (unsigned)row_tiles), 2 * BT, Dx::kSmemBytes,
              stream>>>(dlg, w, dhs, n, d, v, vp);
  if (int err = counted("ctc_head_bwd::dx_kernel")) return err;
  const long kchunk = cdiv(cdiv(n, nsplit), 32) * 32;
  dw_kernel<<<dim3((unsigned)(cdiv(v, 128) * cdiv(d, 128)), (unsigned)nsplit), 2 * BT,
              Dw::kSmemBytes, stream>>>(dlg, hs, dwp, n, d, v, vp, kchunk);
  return counted("ctc_head_bwd::dw_kernel");
}

}  // namespace ctc_head_bwd

// ---- Forward, both dtypes: lse (by dtype), then one gather -----------------
//
// Replaces espnet_slurp_tpu/ops/pallas/ctc_head.py:_fwd_kernel (the
// pallas_call of fused_ctc_head_emit at :160):
//   z = logsumexp_v(hs W^T + bias); emit = hs . W[ext] + bias[ext] - z.
//   lse     grid (N / 128 row tiles, V splits): a block walks its split of V
//           in 128-column tiles of hs W^T and folds each tile into an online
//           (max, sum) per row; one (max, sum) per row and split goes to
//           fp32 scratch part [splits, N]. bf16: ctc_head_bf16::lse_kernel
//           below; fp32: ctc_head_f32::lse_kernel.
//   gather  grid (utterance x 64-frame tiles, 32-label tiles), gather_kernel
//           <T>: z from the splits' (max, sum) in a fixed order, then emit as
//           fp32 dot products of the frames with the gathered rows W[ext[b,
//           s]], both widened to fp32, 4 x 2 outputs a thread over 32-wide
//           steps of D in shared memory (the TPU's one-hot product is not
//           needed). No [N, V] logits in device memory.
// The split (espnet_ctc_head_plan) evens out lse's last wave: at the flagship
// train shape 234 row tiles alone fill 234 of 264 block slots for all 40 V
// tiles; 10 splits of 4 V tiles run 2,340 blocks in 9 waves (36 tile-times
// against 40).

namespace ctc_head_fwd {

using ctc_head_bwd::cdiv;
constexpr int kThreads = 256;
constexpr int GR = 64;  // gather: frames a block
constexpr int GS = 32;  // gather: labels a block
constexpr int GK = 32;  // gather: D a step
static_assert(GR * GS == 8 * kThreads, "the gather's thread map: 4 x 2 outputs a thread");

// (m, l) <- the pair of (m, l) and (m2, l2), each a max and a sum of exp(x -
// max); (-inf, 0) is the empty pair.
__device__ __forceinline__ void lse_merge(float& m, float& l, float m2, float l2) {
  const float mm = fmaxf(m, m2);
  if (mm == -CUDART_INF_F) return;
  l = l * expf(m - mm) + l2 * expf(m2 - mm);
  m = mm;
}

// Four consecutive elements (16 / 8 bytes, aligned) widened to fp32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const T* __restrict__ hs, const T* __restrict__ w,
                  const float* __restrict__ bias, const int* __restrict__ ext,
                  const float2* __restrict__ part, int nsplit, float* __restrict__ emit,
                  float* __restrict__ z, int n, int t, int d, int v, int s_len) {
  __shared__ __align__(16) float xs[GR][GK + 4];
  __shared__ __align__(16) float ws[GS][GK + 4];
  __shared__ float zr[GR];
  __shared__ int lab[GS];
  const int tid = threadIdx.x;
  const int tiles = (t + GR - 1) / GR;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * GR;
  const int s0 = blockIdx.y * GS;
  const int rows = min(GR, t - t0);
  const long row0 = (long)b * t + t0;
  if (tid < GS) {
    lab[tid] = s0 + tid < s_len ? min(max(ext[(long)b * s_len + s0 + tid], 0), v - 1) : 0;
  } else if (tid < GS + GR) {  // z of a frame from the V splits, in order
    const int r = tid - GS;
    float m = -CUDART_INF_F, l = 0.0f;
    for (int p = 0; r < rows && p < nsplit; ++p) {
      const float2 q = part[(long)p * n + row0 + r];
      lse_merge(m, l, q.x, q.y);
    }
    zr[r] = m + logf(l);
    if (r < rows && blockIdx.y == 0) z[row0 + r] = zr[r];
  }
  // Thread (rg, lg) owns frames rg + 16 i (i < 4) and labels lg + 16 j (j <
  // 2). Frame rows are 36 floats apart, so a warp's float4 loads of 16
  // labels take two wavefronts and those of its 2 frames one.
  const int lg = tid & 15, rg = tid >> 4;
  float acc[4][2] = {};
  for (int k0 = 0; k0 < d; k0 += GK) {
    __syncthreads();  // lab and zr written; the previous step's tiles read
    for (int idx = tid; idx < GR * GK / 4; idx += blockDim.x) {
      const int r = idx / (GK / 4), c = (idx % (GK / 4)) * 4;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < rows && k0 + c < d) x = load4(hs + (row0 + r) * d + k0 + c);
      *reinterpret_cast<float4*>(&xs[r][c]) = x;
    }
    for (int idx = tid; idx < GS * GK / 4; idx += blockDim.x) {
      const int j = idx / (GK / 4), c = (idx % (GK / 4)) * 4;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (k0 + c < d) x = load4(w + (long)lab[j] * d + k0 + c);
      *reinterpret_cast<float4*>(&ws[j][c]) = x;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GK; k += 4) {
      float4 a[4], c[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&xs[rg + 16 * i][k]);
#pragma unroll
      for (int j = 0; j < 2; ++j) c[j] = *reinterpret_cast<const float4*>(&ws[lg + 16 * j][k]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float s = acc[i][j];
          s = fmaf(a[i].x, c[j].x, s);
          s = fmaf(a[i].y, c[j].y, s);
          s = fmaf(a[i].z, c[j].z, s);
          acc[i][j] = fmaf(a[i].w, c[j].w, s);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int sl = lg + 16 * j;
      if (s0 + sl < s_len) {
        emit[(row0 + r) * s_len + s0 + sl] = acc[i][j] + bias[lab[sl]] - zr[r];
      }
    }
  }
}

}  // namespace ctc_head_fwd

// ---- lse, bf16: the logits tile on the mma.sync mainloop, folded in registers
//
// Bound: the tensor cores. hs W^T is 2 N D V operations: 76.7 GFLOP at the
// flagship train shape (N = 64 x 468, D 256, V 5000), 0.0775 ms at 989
// TFLOP/s, against ~31 MB of compulsory traffic (hs, W, bias in; emit, z
// out: 0.009 ms). The first version (WMMA through shared memory, the logits
// tile written to shared memory and read back row by row, a barrier after
// every 64 columns, 512 blocks of 64 frames) took 1.82 ms.
//
// Design: ctc_head_bwd's Rows tile (128 x 128, 8 warps of 64 x 32, both
// operands K-major, a 4-stage cp.async ring) forms each 128-column tile of
// hs W^T into registers. The K steps of all the split's V tiles run as one
// pipeline through the ring, so a tile's first stages are in flight while
// the previous tile is folded. After a tile's last K step each thread folds
// its accumulators in place: mma.sync's layout gives it rows lane / 4 and
// lane / 4 + 8 of each of its 4 m16 tiles (8 rows) and 8 columns of each,
// and it adds the columns' bias (-inf past V) and folds them into an online
// (max, sum) per row kept beside the ring (the logits never leave the
// registers). At the end the 4 lanes of a row merge theirs by shuffles and
// the 4 warps that share those rows through shared memory, in a fixed order.

namespace ctc_head_bf16 {

using ctc_head_bwd::cdiv;
using Rows = ctc_head_bwd::Rows;
constexpr int BM = ctc_head_bwd::BT;  // rows of a block tile
constexpr int BN = ctc_head_bwd::BT;  // V columns of a tile
constexpr int kThreads = Rows::kThreads;
constexpr int kOwned = 2 * Rows::MT;  // rows a thread owns
static_assert(kThreads == ctc_head_fwd::kThreads, "one block shape");
// Dynamic shared memory: the ring, then each thread's (max, sum) pairs.
constexpr size_t kLseSmem = Rows::kSmemBytes + (size_t)kOwned * kThreads * sizeof(float2);

__global__ void __launch_bounds__(kThreads, 2)
    lse_kernel(const bf16* __restrict__ hs, const bf16* __restrict__ w,
               const float* __restrict__ bias, float2* __restrict__ part, int n, int d, int v,
               int vchunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float2* ml = reinterpret_cast<float2*>(smem + Rows::kSmemBytes);  // [kOwned][kThreads]
  const int tid = threadIdx.x;
  const long m0 = (long)blockIdx.x * BM;
  const long v0 = (long)blockIdx.y * vchunk;
  const long v1 = v0 + vchunk < v ? v0 + vchunk : v;
#pragma unroll
  for (int r = 0; r < kOwned; ++r) ml[r * kThreads + tid] = make_float2(-CUDART_INF_F, 0.0f);

  // Step q of the pipeline: K step q % ksteps of V tile q / ksteps.
  const int ksteps = (int)cdiv(d, Rows::kBK);
  const int total = (int)cdiv(v1 - v0, BN) * ksteps;
  auto load = [&](int q) {
    const int tile = q / ksteps;
    Rows::load_stage(ring, q % Rows::kStages, hs, d, w, d, m0, v0 + (long)tile * BN, n, v,
                     (long)(q - tile * ksteps) * Rows::kBK, d);
  };
  // The thread's accumulators of V tile n0, bias added, into its (max, sum)
  // per row.
  auto fold = [&](const Rows::Acc& acc, long n0) {
    float bb[Rows::NT][2];
#pragma unroll
    for (int j = 0; j < Rows::NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long col = n0 + Rows::frag_col(j) + e;
        bb[j][e] = col < v ? bias[col] : -CUDART_INF_F;
      }
#pragma unroll
    for (int i = 0; i < Rows::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mt = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < Rows::NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) mt = fmaxf(mt, acc[i][j][2 * h + e] + bb[j][e]);
        float2* p = ml + (2 * i + h) * kThreads + tid;
        const float2 old = *p;
        const float mm = fmaxf(old.x, mt);
        if (mm == -CUDART_INF_F) continue;  // nothing of this tile is in V
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < Rows::NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) s += __expf(acc[i][j][2 * h + e] + bb[j][e] - mm);
        *p = make_float2(mm, old.y * __expf(old.x - mm) + s);
      }
  };

  Rows::Acc acc;
  Rows::zero(acc);
#pragma unroll
  for (int q = 0; q < Rows::kStages - 1; ++q) {
    if (q < total) load(q);
    mma::cp_async_commit();
  }
  for (int q = 0; q < total; ++q) {
    mma::cp_async_wait<Rows::kStages - 2>();
    __syncthreads();  // step q landed for all; step q - 1 read by all
    if (q + Rows::kStages - 1 < total) load(q + Rows::kStages - 1);
    mma::cp_async_commit();
    const bf16* sa = ring + (q % Rows::kStages) * Rows::STAGE_ELEMS;
    Rows::compute_stage(acc, sa, sa + Rows::A_ELEMS);
    if ((q + 1) % ksteps == 0) {
      fold(acc, v0 + (long)(q / ksteps) * BN);
      Rows::zero(acc);
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // The 16 threads of a row: the 4 lanes of a warp that hold its columns,
  // then the 4 warps that do, through shared memory (the ring is free).
  float2* red = reinterpret_cast<float2*>(smem);  // [BM][kWarpsN]
  const int lane = tid & 31, wn = (tid >> 5) % Rows::kWarpsN;
#pragma unroll
  for (int i = 0; i < Rows::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 p = ml[(2 * i + h) * kThreads + tid];
      float m = p.x, l = p.y;
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
        const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
        ctc_head_fwd::lse_merge(m, l, m2, l2);
      }
      if ((lane & 3) == 0) red[Rows::frag_row(i, h) * Rows::kWarpsN + wn] = make_float2(m, l);
    }
  __syncthreads();
  if (tid < BM && m0 + tid < n) {
    float2 a = red[tid * Rows::kWarpsN];
#pragma unroll
    for (int k = 1; k < Rows::kWarpsN; ++k) {
      const float2 c = red[tid * Rows::kWarpsN + k];
      ctc_head_fwd::lse_merge(a.x, a.y, c.x, c.y);
    }
    part[(long)blockIdx.y * n + m0 + tid] = a;
  }
}

static_assert((size_t)BM * Rows::kWarpsN * sizeof(float2) <= Rows::kSmemBytes,
              "the merge's rows fit in the ring");

}  // namespace ctc_head_bf16

// ---- float32: five launches on the register-tiled fp32 GEMM mainloop -------
//
// Replaces espnet_slurp_tpu/ops/pallas/ctc_head.py:_fwd_kernel and
// _bwd_kernel (the pallas_calls of fused_ctc_head_emit at :160 and :179) in
// float32: the route of the default ASRConfig's training and of the fp32
// card-against-CPU checks. Exact fp32 (FMAs, no TF32), the gather and the
// scatter in fp32, dlg unrounded:
//   forward   z = logsumexp_v(hs W^T + bias); emit = hs . W[ext] + bias[ext] - z
//   backward  dlg = scatter_s(g) - exp(hs W^T + bias - z) dsum, dsum = sum_s g;
//             dhs = dlg W, dW = dlg^T hs, dbias = sum over rows of dlg.
//
// Bound: the fp32 units. hs W^T is 2 N D V operations: 76.7 GFLOP at the
// default ASRConfig's train shape (N = 64 x 468, D 256, V 5000), 1.144 ms at
// 67 TFLOP/s; the label gather adds 2 N D S (2.0 GFLOP at S 129). The
// forward is one such product, the backward three (3.43 ms), against ~51 and
// ~87 MB of compulsory traffic (0.015 and 0.026 ms at 3.35 TB/s).
//
// Design: every product is sgemm.cuh's mainloop (128-row block tiles, 8 x 8
// register micro-tiles of FMAs, a 2-stage ring, one barrier per 16 of K).
//   lse     grid (N / 128 row tiles, V splits): a block walks its split of V
//           in 128-column tiles of hs W^T (both operands K-major); after each
//           tile the thread folds its 8 x 8 logits, bias added, into an
//           online (max, sum) per row that it keeps beside the ring in
//           (dynamic) shared memory; at the end the 16 threads of a row
//           merge theirs (shuffles within a warp, then the two warps
//           through shared memory) into one (max, sum) per row and split.
//   gather  ctc_head_fwd::gather_kernel<float>.
//   rows    grid (V / 128, N / 128): the logits tile again on the same
//           mainloop; the epilogue forms -exp(lg + bias - z) dsum from the
//           registers into an fp32 tile in shared memory (zero past N and
//           V), adds g there by shared atomics for the labels that fall in
//           the tile (listed once per utterance the tile's rows span, as
//           ctc_head_bwd::rows_kernel does), then writes the tile to the fp32
//           scratch dlg [N, VP] with float4 stores (VP = V rounded up to 4,
//           pad columns zero) and its column sums as one dbias partial per
//           128-row tile.
//   dx      (N / 128) x (D / 128) tiles: dlg W, K = V (dlg K-major by
//           register-staged transposes, W MN-major by cp.async).
//   dw      grid (V / 128 x D / 128 tiles, splits of N): dlg^T hs, both
//           operands MN-major (cp.async), fp32 partials per split.
// Three products for the three the function needs (the first version formed
// the logits once more for dx and once for dW). The scratch lives for the
// call (599 MB at the default train shape; the backward runs after the
// train step's peak of memory and does not raise it: PERF.md, PR 15). The
// wrapper sums the partials in a fixed order (deterministic: no atomics
// across blocks; the scatter's shared atomics order only the duplicates of
// one label in one row).

namespace ctc_head_f32 {

using ctc_head_bwd::cdiv;
using mma::Major;
constexpr int BM = sgemm::BM;      // rows of N a block tile; rows of a dbias partial
constexpr int BN = 128;            // columns of every block tile
constexpr int LDT = BN + 4;        // rows of the fp32 dlg tile in shared memory
constexpr int kList = 1024;        // labels of one utterance listed at a time
using Proj = sgemm::Gemm<BN, Major::K, Major::K>;  // hs [N, D] . W [V, D]^T
using Dx = sgemm::Gemm<BN, Major::K, Major::MN>;   // dlg [N, VP] . W [V, D]
using Dw = sgemm::Gemm<BN, Major::MN, Major::MN>;  // dlg^T [VP, N] . hs [N, D]
static_assert(BM == ctc_head_bwd::BT, "one dbias partial per 128 rows in both dtypes");
static_assert(sgemm::kThreads == 2 * BN && sgemm::kThreads == ctc_head_fwd::kThreads,
              "the thread map of the dbias sums; one block shape");
// lse's dynamic shared memory: the ring and each thread's (max, sum) pairs.
constexpr size_t kLseSmem = (Proj::kRingFloats + 2 * Proj::MI * sgemm::kThreads) * sizeof(float);
// rows' dynamic shared memory: the ring, then (after the products) the dlg
// tile, the dbias halves, the label count and the label list.
constexpr size_t kRowsSmem =
    std::max(Proj::kRingFloats * sizeof(float),
             (BM * LDT + 2 * BN + 4) * sizeof(float) + kList * sizeof(int2));

using ctc_head_fwd::lse_merge;

__global__ void __launch_bounds__(sgemm::kThreads, 2)
    lse_kernel(const float* __restrict__ hs, const float* __restrict__ w,
               const float* __restrict__ bias, float2* __restrict__ part, int n, int d, int v,
               int vchunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  // each thread's (max, sum) of its rows
  auto ml = reinterpret_cast<float2(*)[sgemm::kThreads]>(ring + Proj::kRingFloats);
  const int tid = threadIdx.x;
  const long m0 = (long)blockIdx.x * BM;
  const long v0 = (long)blockIdx.y * vchunk;
  const long v1 = v0 + vchunk < v ? v0 + vchunk : v;
#pragma unroll
  for (int i = 0; i < Proj::MI; ++i) ml[i][tid] = make_float2(-CUDART_INF_F, 0.0f);
  for (long n0 = v0; n0 < v1; n0 += BN) {
    Proj::Acc acc;
    Proj::zero(acc);
    Proj::run(acc, ring, hs, d, w, d, m0, n0, n, v, 0, d);  // hs [N, D] . W [V, D]^T
    float bb[Proj::NJ];  // the columns' bias, -inf past V
    bool any = false;
#pragma unroll
    for (int j = 0; j < Proj::NJ; ++j) {
      const long col = n0 + Proj::col(j >> 2) + (j & 3);
      bb[j] = col < v ? bias[col] : -CUDART_INF_F;
      any |= col < v;
    }
    if (!any) continue;
#pragma unroll
    for (int i = 0; i < Proj::MI; ++i) {
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < Proj::NJ; ++j) mt = fmaxf(mt, acc[i][j] + bb[j]);
      const float2 p = ml[i][tid];
      const float mm = fmaxf(p.x, mt);
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < Proj::NJ; ++j) s += expf(acc[i][j] + bb[j] - mm);
      ml[i][tid] = make_float2(mm, p.y * expf(p.x - mm) + s);
    }
  }
  // The 16 threads of a row: the 8 lanes of a warp that share its rows, then
  // the two warps that do, through shared memory (the ring is free).
  float2* red = reinterpret_cast<float2*>(ring);  // [BM][2]
  const int lane = tid & 31, half = (tid >> 5) & 1;
#pragma unroll
  for (int i = 0; i < Proj::MI; ++i) {
    float m = ml[i][tid].x, l = ml[i][tid].y;
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
      lse_merge(m, l, m2, l2);
    }
    if ((lane & 7) == 0) red[2 * Proj::row(i) + half] = make_float2(m, l);
  }
  __syncthreads();
  if (tid < BM && m0 + tid < n) {
    float2 a = red[2 * tid];
    const float2 c = red[2 * tid + 1];
    lse_merge(a.x, a.y, c.x, c.y);
    part[(long)blockIdx.y * n + m0 + tid] = a;
  }
}

__global__ void __launch_bounds__(sgemm::kThreads, 2)
    rows_kernel(const float* __restrict__ hs, const float* __restrict__ w,
                const float* __restrict__ bias, const int* __restrict__ ext,
                const float* __restrict__ z, const float* __restrict__ dsum,
                const float* __restrict__ g, float* __restrict__ dlg, float* __restrict__ dbp,
                int n, int t, int d, int v, int vp, int s_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);  // the ring, then the dlg tile
  const long n0 = (long)blockIdx.x * BN;         // vocabulary columns
  const long m0 = (long)blockIdx.y * BM;         // rows of hs
  Proj::Acc acc;
  Proj::zero(acc);
  Proj::run(acc, tile, hs, d, w, d, m0, n0, n, v, 0, d);  // hs [N, D] . W [V, D]^T

  // -exp(lg + bias - z) dsum into the fp32 tile (the ring is free after run).
  Proj::epilogue(acc, [&](int r, int c, float4 x) {
    const long row = m0 + r, col = n0 + c;
    float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (row < n) {
      const float zr = z[row], ds = dsum[row];
      const float lg[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col + e < v) o[e] = -expf(lg[e] + bias[col + e] - zr) * ds;
      }
    }
    *reinterpret_cast<float4*>(tile + r * LDT + c) = make_float4(o[0], o[1], o[2], o[3]);
  });
  __syncthreads();

  // scatter_s(g): for each utterance whose rows the tile holds, the labels
  // that fall in this V tile are listed once, (column, s), kList at a time;
  // then each of its rows adds g at those columns, neighbouring lanes on
  // neighbouring rows (distinct addresses, also for the blank's many states).
  const int rows = n - m0 < BM ? (int)(n - m0) : BM;
  int* nlist = reinterpret_cast<int*>(tile + BM * LDT + 2 * BN);
  int2* list = reinterpret_cast<int2*>(nlist + 4);
  for (long bb = m0 / t; bb <= (m0 + rows - 1) / t; ++bb) {
    const int r_lo = bb * t > m0 ? (int)(bb * t - m0) : 0;
    const int nr = ((bb + 1) * t - m0 < rows ? (int)((bb + 1) * t - m0) : rows) - r_lo;
    for (int s0 = 0; s0 < s_len; s0 += kList) {
      if (threadIdx.x == 0) *nlist = 0;
      __syncthreads();
      for (int sl = s0 + threadIdx.x; sl < min(s_len, s0 + kList); sl += blockDim.x) {
        const int lab = min(max(ext[bb * s_len + sl], 0), v - 1);
        const long c = lab - n0;
        if (c >= 0 && c < BN) list[atomicAdd(nlist, 1)] = make_int2((int)c, sl);
      }
      __syncthreads();
      const int cnt = *nlist;
      for (int idx = threadIdx.x; idx < nr * cnt; idx += blockDim.x) {
        const int j = idx / nr;
        const int r = r_lo + idx - j * nr;
        atomicAdd(tile + r * LDT + list[j].x, g[(m0 + r) * s_len + list[j].y]);
      }
      __syncthreads();  // the list is rebuilt next; the tile is complete
    }
  }

  // dlg into the scratch, 4 columns (16 bytes) a store; pad columns [V, VP)
  // hold the epilogue's zeros.
  constexpr int CH = BN / 4;
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
    const int r = idx / CH;
    const int c = (idx - r * CH) * 4;
    if (n0 + c >= vp) continue;
    *reinterpret_cast<float4*>(dlg + (m0 + r) * vp + n0 + c) =
        *reinterpret_cast<const float4*>(tile + r * LDT + c);
  }

  // dbias partial of this row tile (rows past N are zero): thread t sums
  // column t % BN over half t / BN of the rows.
  float* red = tile + BM * LDT;
  {
    const int c = threadIdx.x & (BN - 1), half = threadIdx.x / BN;
    float sum = 0.0f;
    for (int r = half * (BM / 2); r < (half + 1) * (BM / 2); ++r) sum += tile[r * LDT + c];
    red[half * BN + c] = sum;
  }
  __syncthreads();
  if (threadIdx.x < BN && n0 + threadIdx.x < v) {
    dbp[(m0 / BM) * v + n0 + threadIdx.x] = red[threadIdx.x] + red[BN + threadIdx.x];
  }
}

__global__ void __launch_bounds__(sgemm::kThreads, 2)
    dx_kernel(const float* __restrict__ dlg, const float* __restrict__ w, float* __restrict__ dhs,
              int n, int d, int v, int vp) {
  __shared__ __align__(16) float ring[Dx::kRingFloats];
  const long tn = cdiv(d, BN);
  const long m0 = (long)(blockIdx.x / tn) * BM, n0 = (long)(blockIdx.x % tn) * BN;
  Dx::Acc acc;
  Dx::zero(acc);
  // dlg [N, VP] . W [V, D]: K = V; W's rows past V read as zero.
  Dx::run(acc, ring, dlg, vp, w, d, m0, n0, n, d, 0, v);
  Dx::epilogue(acc, [&](int r, int c, float4 x) {
    const long row = m0 + r, col = n0 + c;
    if (row < n && col < d) *reinterpret_cast<float4*>(dhs + row * d + col) = x;
  });
}

__global__ void __launch_bounds__(sgemm::kThreads, 2)
    dw_kernel(const float* __restrict__ dlg, const float* __restrict__ hs, float* __restrict__ dwp,
              int n, int d, int v, int vp, int kchunk) {
  __shared__ __align__(16) float ring[Dw::kRingFloats];
  const long split = blockIdx.y;
  const long k0 = split * kchunk, k1 = k0 + kchunk < n ? k0 + kchunk : n;
  const long tn = cdiv(d, BN);
  const long m0 = (long)(blockIdx.x / tn) * BN;  // vocabulary rows of dW
  const long n0 = (long)(blockIdx.x % tn) * BN;  // columns of D
  Dw::Acc acc;
  Dw::zero(acc);
  // dlg^T [VP, N] . hs [N, D] over rows k0 .. k1 of this split.
  Dw::run(acc, ring, dlg, vp, hs, d, m0, n0, v, d, k0, k1);
  float* out = dwp + split * v * d;
  Dw::epilogue(acc, [&](int r, int c, float4 x) {
    const long row = m0 + r, col = n0 + c;
    if (row < v && col < d) *reinterpret_cast<float4*>(out + row * d + col) = x;
  });
}

// rows, dx and dw; dlg: fp32 [N, vp] scratch; dbp: cdiv(N, BM) dbias
// partials [., V]; dwp: nsplit dW partials [., V, D].
inline int launch_bwd(const float* hs, const float* w, const float* bias, const int* ext,
                      const float* z, const float* dsum, const float* g, float* dlg, int vp,
                      float* dhs, float* dwp, float* dbp, int nsplit, int b, int t, int d, int v,
                      int s_len, cudaStream_t stream) {
  const long n = (long)b * t;
  if (n > 0x7fffffffL || !dlg || !dsum || vp < v || vp % 4 || cdiv(n, BM) > 65535 ||
      nsplit <= 0 || nsplit > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long vt = cdiv(v, BN), dt = cdiv(d, BN);
  rows_kernel<<<dim3((unsigned)vt, (unsigned)cdiv(n, BM)), sgemm::kThreads, kRowsSmem,
                stream>>>(hs, w, bias, ext, z, dsum, g, dlg, dbp, (int)n, t, d, v, vp, s_len);
  if (int err = counted("ctc_head_f32::rows_kernel")) return err;
  dx_kernel<<<(unsigned)(cdiv(n, BM) * dt), sgemm::kThreads, 0, stream>>>(dlg, w, dhs, (int)n,
                                                                         d, v, vp);
  if (int err = counted("ctc_head_f32::dx_kernel")) return err;
  const long kchunk = cdiv(cdiv(n, nsplit), sgemm::BK) * sgemm::BK;
  dw_kernel<<<dim3((unsigned)(vt * dt), (unsigned)nsplit), sgemm::kThreads, 0, stream>>>(
      dlg, hs, dwp, (int)n, d, v, vp, (int)kchunk);
  return counted("ctc_head_f32::dw_kernel");
}

}  // namespace ctc_head_f32

// ---- Both dtypes: the launches' table, plan, forward entry and info --------

namespace ctc_head {

using ctc_head_bwd::cdiv;
constexpr int kKernels = 5;  // lse, gather, rows, dx, dw
constexpr int BM = 128;      // rows of an lse block tile (both dtypes)
constexpr int BN = 128;      // V columns of an lse tile and of a dW tile
static_assert(BM == ctc_head_bf16::BM && BM == ctc_head_f32::BM && BN == ctc_head_bf16::BN &&
                  BN == ctc_head_f32::BN, "one plan for both dtypes");

struct Launch {
  const void* kernel;
  int threads;
  size_t smem;  // dynamic shared bytes
};

// Kernel `which` (0 lse, 1 gather, 2 rows, 3 dx, 4 dw) of dtype (0 float32,
// 1 bfloat16).
inline Launch launch_of(int dtype, int which) {
  auto k = [](auto f) { return reinterpret_cast<const void*>(f); };
  if (dtype == 1) {
    using namespace ctc_head_bwd;
    const Launch all[kKernels] = {
        {k(ctc_head_bf16::lse_kernel), ctc_head_bf16::kThreads, ctc_head_bf16::kLseSmem},
        {k(ctc_head_fwd::gather_kernel<bf16>), ctc_head_fwd::kThreads, 0},
        {k(rows_kernel), 2 * BT, Rows::kSmemBytes},
        {k(dx_kernel), 2 * BT, Dx::kSmemBytes},
        {k(dw_kernel), 2 * BT, Dw::kSmemBytes}};
    return which >= 0 && which < kKernels ? all[which] : Launch{nullptr, 0, 0};
  }
  if (dtype == 0) {
    using namespace ctc_head_f32;
    const Launch all[kKernels] = {{k(lse_kernel), sgemm::kThreads, kLseSmem},
                                  {k(ctc_head_fwd::gather_kernel<float>), sgemm::kThreads, 0},
                                  {k(rows_kernel), sgemm::kThreads, kRowsSmem},
                                  {k(dx_kernel), sgemm::kThreads, 0},
                                  {k(dw_kernel), sgemm::kThreads, 0}};
    return which >= 0 && which < kKernels ? all[which] : Launch{nullptr, 0, 0};
  }
  return Launch{nullptr, 0, 0};
}

// Prefers the largest shared-memory carveout for every kernel and lets each
// take its dynamic shared memory, once.
inline void configure() {
  static const bool done = [] {
    for (int dtype = 0; dtype < 2; ++dtype) {
      for (int i = 0; i < kKernels; ++i) {
        const Launch l = launch_of(dtype, i);
        cudaFuncSetAttribute(l.kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
        if (l.smem > 0) {
          cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)l.smem);
        }
      }
    }
    return true;
  }();
  (void)done;
}

inline int blocks_per_sm(int dtype, int which, int* nb) {
  const Launch l = launch_of(dtype, which);
  if (!l.kernel) return (int)cudaErrorInvalidValue;
  configure();
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(nb, l.kernel, l.threads, l.smem);
}

// The launches' plan for dtype on a card of `sms` SMs, for N rows and widths
// D, V:
//   out[0] the V splits of lse: the count whose blocks (row tiles x splits,
//          each split whole 128-column tiles) take the fewest tile-times when
//          run in waves of sms x lse's blocks an SM, the smallest on a tie;
//   out[1] the splits of N for dw: as many as fill the card's block slots
//          with (V / 128 x D / 128 tiles) x splits blocks, each at least
//          1024 rows (fp32) or 512 (bf16); at least 1.
inline int plan(int dtype, int n, int d, int v, int sms, int* out) {
  if (n <= 0 || d <= 0 || v <= 0 || sms <= 0 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  int lse_sm = 0, dw_sm = 0;
  if (int err = blocks_per_sm(dtype, 0, &lse_sm)) return err;
  if (int err = blocks_per_sm(dtype, 4, &dw_sm)) return err;
  const long slots = (long)sms * std::max(lse_sm, 1);
  const long rt = cdiv(n, BM), vt = cdiv(v, BN);
  long best = 1, best_cost = -1;
  for (long sp = 1; sp <= std::min(vt, 65535L); ++sp) {
    const long per = cdiv(vt, sp);
    if (cdiv(vt, per) != sp) continue;  // the same tiles a split as fewer splits
    const long cost = cdiv(rt * sp, slots) * per;
    if (best_cost < 0 || cost < best_cost) best = sp, best_cost = cost;
  }
  const long tiles = cdiv(v, BN) * cdiv(d, BN);
  const long min_rows = dtype == 1 ? 512 : 1024;
  const long dw = std::min({(long)n / min_rows, (long)sms * dw_sm / tiles, 65535L});
  out[0] = (int)best;
  out[1] = (int)std::max(1L, dw);
  return 0;
}

// lse then gather; part: fp32 (max, sum) pairs [nsplit, N], nsplit the
// plan's out[0].
template <typename T>
int launch_fwd(const T* hs, const T* w, const float* bias, const int* ext, float2* part,
               int nsplit, float* emit, float* z, int b, int t, int d, int v, int s_len,
               cudaStream_t stream) {
  using ctc_head_fwd::GR;
  using ctc_head_fwd::GS;
  const long n = (long)b * t, vt = cdiv(v, BN);
  if (n > 0x7fffffffL || !part || nsplit <= 0 || nsplit > std::min(vt, 65535L) ||
      cdiv(t, GR) * b > 0x7fffffffL || cdiv(s_len, GS) > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long vchunk = cdiv(vt, nsplit) * BN;
  if (cdiv(v, vchunk) != nsplit) return (int)cudaErrorInvalidValue;
  configure();
  const dim3 grid((unsigned)cdiv(n, BM), (unsigned)nsplit);
  constexpr bool f32 = std::is_same<T, float>::value;
  if constexpr (f32) {
    ctc_head_f32::lse_kernel<<<grid, sgemm::kThreads, ctc_head_f32::kLseSmem, stream>>>(
        hs, w, bias, part, (int)n, d, v, (int)vchunk);
  } else {
    ctc_head_bf16::lse_kernel<<<grid, ctc_head_bf16::kThreads, ctc_head_bf16::kLseSmem,
                                stream>>>(hs, w, bias, part, (int)n, d, v, (int)vchunk);
  }
  if (int err = counted(f32 ? "ctc_head_f32::lse_kernel" : "ctc_head_bf16::lse_kernel")) return err;
  ctc_head_fwd::gather_kernel<T>
      <<<dim3((unsigned)(cdiv(t, GR) * b), (unsigned)cdiv(s_len, GS)), ctc_head_fwd::kThreads, 0,
         stream>>>(hs, w, bias, ext, part, nsplit, emit, z, (int)n, t, d, v, s_len);
  return counted("ctc_head_fwd::gather_kernel", type_name<T>());
}

// Registers, shared bytes (static and dynamic), local (spill) bytes and
// blocks per SM of kernel `which` of dtype.
inline int info(int dtype, int which, int* out) {
  const Launch l = launch_of(dtype, which);
  if (!l.kernel) return (int)cudaErrorInvalidValue;
  configure();
  cudaFuncAttributes attr{};
  if (int err = (int)cudaFuncGetAttributes(&attr, l.kernel)) return err;
  int nb = 0;
  if (int err = blocks_per_sm(dtype, which, &nb)) return err;
  out[0] = attr.numRegs;
  out[1] = (int)(attr.sharedSizeBytes + l.smem);
  out[2] = (int)attr.localSizeBytes;
  out[3] = nb;
  return 0;
}

}  // namespace ctc_head

inline bool head_args_ok(int b, int t, int d, int v, int s) {
  return b > 0 && t > 0 && v > 0 && s > 0 && d > 0 && d % 16 == 0 && b <= 65535;
}

}  // namespace espnet

// dtype: 0 = float32, 1 = bfloat16. hs: [B, T, D]; w: [V, D]; bias: f32 [V];
// ext: int32 [B, S]; emit: f32 [B, T, S]; z: f32 [B, T]; part: fp32
// [nsplit, B T, 2] scratch for lse's (max, sum) pairs, with nsplit the plan's
// V splits (espnet_ctc_head_plan's out[0]).
extern "C" int espnet_ctc_head_fwd(int dtype, const void* hs, const void* w, const float* bias,
                                   const int* ext, float* emit, float* z, float* part, int nsplit,
                                   int b, int t, int d, int v, int s, void* stream) {
  using namespace espnet;
  if (!head_args_ok(b, t, d, v, s)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto pt = reinterpret_cast<float2*>(part);
  if (dtype == 1) {
    return ctc_head::launch_fwd(static_cast<const bf16*>(hs), static_cast<const bf16*>(w), bias,
                                ext, pt, nsplit, emit, z, b, t, d, v, s, st);
  }
  if (dtype == 0) {
    return ctc_head::launch_fwd(static_cast<const float*>(hs), static_cast<const float*>(w), bias,
                                ext, pt, nsplit, emit, z, b, t, d, v, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

// g: f32 [B, T, S] cotangent of emit; dsum = sum_s g (f32 [B, T]); dx: [B, T,
// D] (hs's type); dw_part: f32 [nsplit, V, D] and db_part: f32
// [cdiv(B T, espnet_ctc_head_bwd_row_tile()), V], summed by the caller. dlg:
// [B T, vp] scratch in hs's type, vp = V rounded up to a multiple of 8
// (bf16) or 4 (fp32).
extern "C" int espnet_ctc_head_bwd(int dtype, const void* hs, const void* w, const float* bias,
                                   const int* ext, const float* z, const float* g,
                                   const float* dsum, void* dlg, int vp, void* dx,
                                   float* dw_part, float* db_part, int nsplit, int b, int t,
                                   int d, int v, int s, void* stream) {
  if (!espnet::head_args_ok(b, t, d, v, s) || nsplit <= 0 || nsplit > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  using espnet::bf16;
  espnet::ctc_head::configure();
  if (dtype == 1) {
    const long n = (long)b * t;
    if (n > 0x7fffffffL || !dsum || !dlg) return (int)cudaErrorInvalidValue;
    return espnet::ctc_head_bwd::launch(
        static_cast<const bf16*>(hs), static_cast<const bf16*>(w), bias, ext, z, dsum, g,
        static_cast<bf16*>(dlg), static_cast<bf16*>(dx), dw_part, db_part, nsplit, (int)n, t, d,
        v, vp, s, st);
  }
  if (dtype == 0) {
    auto in = [](const void* p) { return static_cast<const float*>(p); };
    return espnet::ctc_head_f32::launch_bwd(in(hs), in(w), bias, ext, z, dsum, g,
                                            static_cast<float*>(dlg), vp, static_cast<float*>(dx),
                                            dw_part, db_part, nsplit, b, t, d, v, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Rows of B T per dbias partial of the backward (both dtypes).
extern "C" int espnet_ctc_head_bwd_row_tile() { return espnet::ctc_head_bwd::BT; }

// The plan of dtype (0 float32, 1 bfloat16) for N = B T rows and widths D, V
// on a card of `sms` SMs: out[0] <- lse's V splits, out[1] <- dw's splits of
// N. Returns a cudaError_t code.
extern "C" int espnet_ctc_head_plan(int dtype, int n, int d, int v, int sms, int* out) {
  return espnet::ctc_head::plan(dtype, n, d, v, sms, out);
}

// info[0..3] <- registers a thread, shared bytes (static and dynamic),
// local (spill) bytes and blocks per SM of kernel `which` of dtype (0
// float32, 1 bfloat16): 0 lse, 1 gather, 2 rows, 3 dx, 4 dw. Returns a
// cudaError_t code.
extern "C" int espnet_ctc_head_info(int dtype, int which, int* info) {
  return espnet::ctc_head::info(dtype, which, info);
}
