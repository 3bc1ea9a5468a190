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
// Design of the forward and of the float32 backward (the simple first
// version: WMMA tiles staged through shared memory, no pipelining):
// - forward: one block per (batch row, tile of BM frames). Pass 1 walks V in
//   chunks of BV rows of W: logits tile in shared memory, online max / sum per
//   frame. Pass 2 multiplies the frames by the gathered rows W[ext[s]] (a
//   lane gather is cheap here; the TPU's one-hot product is not needed) and
//   writes emit. z is saved for the backward, so the backward needs no
//   logsumexp pass.
// - backward in float32 (it serves the fp32 card-against-CPU checks), two
//   kernels that each recompute the logits tile by tile:
//   dx: one block per (batch row, frame tile), accumulating dhs over the
//   vocabulary chunks; dw: one block per (vocabulary chunk, row split),
//   keeping that chunk of W resident and accumulating dW^T / dbias over its
//   share of the frame tiles into per-split partials that the wrapper sums
//   (deterministic: no atomics across blocks). Repeated labels add through
//   shared-memory atomics in the scatter.
// The bf16 backward is three tensor-core GEMM kernels (ctc_head_bwd below).
//
// Rounding: the reference rounds the gathered logit (forward) and g before
// its one-hot scatter (backward) to bf16, artifacts of doing the gather as a
// matrix product on the TPU; the port gathers and scatters in fp32 (ROADMAP
// queue 3). dlogits is rounded to the element type before the two products
// and dbias summed from the unrounded values, as the reference does.
#include "common.cuh"
#include "mma_gemm.cuh"

namespace espnet {

struct HeadLayout {
  size_t xs, ws, lt, dl, acc, zr, dsum, db, ext, total;
  __host__ __device__ HeadLayout(int d, int s, int bm, int bv, int esize, bool backward,
                                 bool dw) {
    const int p = 16 / esize;
    const size_t row = (size_t)(d + p) * esize;
    xs = 0;
    ws = align128(xs + bm * row);
    lt = align128(ws + bv * row);
    dl = align128(lt + (size_t)bm * (bv + 4) * 4);
    // dx: dl is [BM, BV] and acc [BM, D]; dw: dl is [BV, BM] and acc [BV, D].
    const size_t dl_bytes =
        backward ? (dw ? (size_t)bv * (bm + p) * esize : (size_t)bm * (bv + p) * esize) : 0;
    acc = align128(dl + dl_bytes);
    const size_t acc_bytes = backward ? (size_t)(dw ? bv : bm) * (d + 4) * 4 : 0;
    zr = align128(acc + acc_bytes);
    dsum = align128(zr + (size_t)bm * 4);
    db = align128(dsum + (size_t)bm * 4);
    ext = align128(db + (size_t)bv * 4);
    total = align128(ext + (size_t)s * 4);
  }
};

// Rows ext[s0 + r] of W into shared memory (zeros past S).
template <typename T>
__device__ void load_gathered(T* s_dst, int lds, const T* w, int d, const int* ext, int s0,
                              int rows, int s_len) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = d / V;
  for (int idx = threadIdx.x; idx < rows * vpr; idx += blockDim.x) {
    const int r = idx / vpr;
    const int c = (idx - r * vpr) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s0 + r < s_len) {
      val = *reinterpret_cast<const uint4*>(w + (size_t)ext[s0 + r] * d + c);
    }
    *reinterpret_cast<uint4*>(s_dst + r * lds + c) = val;
  }
}

// Loads what every backward tile needs for batch row b, frames t0..t0+BM:
// the frames, their z, sum_s g, and the row's ext (clamped to [0, V)).
template <typename T, int BM>
__device__ void load_bwd_tile(T* xs, int ldx, float* zr, float* dsum, int* exts, const T* hs,
                              const float* z, const int* ext, const float* g, int b, int t0,
                              int t, int d, int v, int s_len) {
  load_rows(xs, ldx, hs + (size_t)b * t * d, d, t0, BM, d, 0, t);
  for (int i = threadIdx.x; i < s_len; i += blockDim.x) {
    exts[i] = min(max(ext[(size_t)b * s_len + i], 0), v - 1);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int r = warp; r < BM; r += nwarps) {
    const int tt = t0 + r;
    float sum = 0.0f;
    if (tt < t) {
      const float* gr = g + ((size_t)b * t + tt) * s_len;
      for (int s = lane; s < s_len; s += 32) sum += gr[s];
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      dsum[r] = sum;
      zr[r] = tt < t ? z[(size_t)b * t + tt] : 0.0f;
    }
  }
  __syncthreads();
}

// lt <- dlogits of the tile (frames t0.., vocabulary rows v0.. held in ws):
// scatter(g) - softmax * dsum, zero on frames past T and columns past V.
template <typename T, int BM, int BV>
__device__ void head_dlogits(const T* xs, int ldx, const T* ws, int ldw, float* lt, int ldl,
                             const float* zr, const float* dsum, const int* exts,
                             const float* bias, const float* g, int b, int t0, int v0, int t,
                             int d, int v, int s_len) {
  smem_gemm<true>(xs, ldx, ws, ldw, lt, ldl, BM, BV, d, false);
  for (int idx = threadIdx.x; idx < BM * BV; idx += blockDim.x) {
    const int r = idx / BV;
    const int c = idx - r * BV;
    float val = 0.0f;
    if (t0 + r < t && v0 + c < v) {
      val = -expf(lt[r * ldl + c] + bias[v0 + c] - zr[r]) * dsum[r];
    }
    lt[r * ldl + c] = val;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int r = warp; r < BM; r += nwarps) {
    const int tt = t0 + r;
    if (tt >= t) continue;
    const float* gr = g + ((size_t)b * t + tt) * s_len;
    for (int s = lane; s < s_len; s += 32) {
      const int c = exts[s] - v0;
      if (c >= 0 && c < BV) atomicAdd(&lt[r * ldl + c], gr[s]);
    }
  }
  __syncthreads();
}

template <typename T, int BM, int BV>
__global__ void __launch_bounds__(kThreads)
    ctc_head_fwd_kernel(const T* __restrict__ hs, const T* __restrict__ w,
                        const float* __restrict__ bias, const int* __restrict__ ext,
                        float* __restrict__ emit, float* __restrict__ z, int t, int d, int v,
                        int s_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  const HeadLayout L(d, s_len, BM, BV, sizeof(T), false, false);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* ws = reinterpret_cast<T*>(smem + L.ws);
  float* lt = reinterpret_cast<float*>(smem + L.lt);
  float* m = reinterpret_cast<float*>(smem + L.zr);
  float* l = reinterpret_cast<float*>(smem + L.dsum);
  int* exts = reinterpret_cast<int*>(smem + L.ext);
  const int ld = d + P, ldl = BV + 4;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;

  load_rows(xs, ld, hs + (size_t)b * t * d, d, t0, BM, d, 0, t);
  for (int i = threadIdx.x; i < s_len; i += blockDim.x) {
    exts[i] = min(max(ext[(size_t)b * s_len + i], 0), v - 1);
  }
  for (int r = threadIdx.x; r < BM; r += blockDim.x) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.0f;
  }
  // Pass 1: online logsumexp over the vocabulary.
  for (int v0 = 0; v0 < v; v0 += BV) {
    load_rows(ws, ld, w, d, v0, BV, d, 0, v);
    __syncthreads();
    smem_gemm<true>(xs, ld, ws, ld, lt, ldl, BM, BV, d, false);
    for (int r = warp; r < BM; r += nwarps) {
      float mt = -CUDART_INF_F;
      for (int c = lane; c < BV && v0 + c < v; c += 32) {
        mt = fmaxf(mt, lt[r * ldl + c] + bias[v0 + c]);
      }
      mt = warp_max(mt);
      const float m_new = fmaxf(m[r], mt);
      float sum = 0.0f;
      for (int c = lane; c < BV && v0 + c < v; c += 32) {
        sum += expf(lt[r * ldl + c] + bias[v0 + c] - m_new);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        l[r] = l[r] * expf(m[r] - m_new) + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();
  }
  for (int r = threadIdx.x; r < BM; r += blockDim.x) {
    const float zz = m[r] + logf(l[r]);
    m[r] = zz;  // m now holds z
    if (t0 + r < t) z[(size_t)b * t + t0 + r] = zz;
  }
  // Pass 2: the gathered logits, BV labels at a time.
  for (int s0 = 0; s0 < s_len; s0 += BV) {
    load_gathered(ws, ld, w, d, exts, s0, BV, s_len);
    __syncthreads();
    smem_gemm<true>(xs, ld, ws, ld, lt, ldl, BM, BV, d, false);
    for (int idx = threadIdx.x; idx < BM * BV; idx += blockDim.x) {
      const int r = idx / BV;
      const int c = idx - r * BV;
      const int s = s0 + c;
      if (t0 + r < t && s < s_len) {
        emit[((size_t)b * t + t0 + r) * s_len + s] = lt[r * ldl + c] + bias[exts[s]] - m[r];
      }
    }
    __syncthreads();
  }
}

template <typename T, int BM, int BV>
__global__ void __launch_bounds__(kThreads)
    ctc_head_dx_kernel(const T* __restrict__ hs, const T* __restrict__ w,
                       const float* __restrict__ bias, const int* __restrict__ ext,
                       const float* __restrict__ z, const float* __restrict__ g,
                       T* __restrict__ dx, int t, int d, int v, int s_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  const HeadLayout L(d, s_len, BM, BV, sizeof(T), true, false);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* ws = reinterpret_cast<T*>(smem + L.ws);
  float* lt = reinterpret_cast<float*>(smem + L.lt);
  T* dl = reinterpret_cast<T*>(smem + L.dl);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* zr = reinterpret_cast<float*>(smem + L.zr);
  float* dsum = reinterpret_cast<float*>(smem + L.dsum);
  int* exts = reinterpret_cast<int*>(smem + L.ext);
  const int ld = d + P, ldl = BV + 4, ldd = BV + P, ldacc = d + 4;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * BM;

  load_bwd_tile<T, BM>(xs, ld, zr, dsum, exts, hs, z, ext, g, b, t0, t, d, v, s_len);
  for (int v0 = 0; v0 < v; v0 += BV) {
    load_rows(ws, ld, w, d, v0, BV, d, 0, v);
    __syncthreads();
    head_dlogits<T, BM, BV>(xs, ld, ws, ld, lt, ldl, zr, dsum, exts, bias, g, b, t0, v0, t, d,
                            v, s_len);
    for (int idx = threadIdx.x; idx < BM * BV; idx += blockDim.x) {
      const int r = idx / BV;
      const int c = idx - r * BV;
      dl[r * ldd + c] = from_f32<T>(lt[r * ldl + c]);
    }
    __syncthreads();
    smem_gemm<false>(dl, ldd, ws, ld, acc, ldacc, BM, d, BV, v0 > 0);
  }
  const int valid = min(BM, t - t0);
  for (int idx = threadIdx.x; idx < valid * d; idx += blockDim.x) {
    const int r = idx / d;
    const int c = idx - r * d;
    dx[((size_t)b * t + t0 + r) * d + c] = from_f32<T>(acc[r * ldacc + c]);
  }
}

template <typename T, int BM, int BV>
__global__ void __launch_bounds__(kThreads)
    ctc_head_dw_kernel(const T* __restrict__ hs, const T* __restrict__ w,
                       const float* __restrict__ bias, const int* __restrict__ ext,
                       const float* __restrict__ z, const float* __restrict__ g,
                       float* __restrict__ dw_part, float* __restrict__ db_part, int bsz, int t,
                       int d, int v, int s_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  const HeadLayout L(d, s_len, BM, BV, sizeof(T), true, true);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* ws = reinterpret_cast<T*>(smem + L.ws);
  float* lt = reinterpret_cast<float*>(smem + L.lt);
  T* dlt = reinterpret_cast<T*>(smem + L.dl);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* zr = reinterpret_cast<float*>(smem + L.zr);
  float* dsum = reinterpret_cast<float*>(smem + L.dsum);
  float* db = reinterpret_cast<float*>(smem + L.db);
  int* exts = reinterpret_cast<int*>(smem + L.ext);
  const int ld = d + P, ldl = BV + 4, lddt = BM + P, ldacc = d + 4;
  const int v0 = blockIdx.x * BV;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int ntt = (t + BM - 1) / BM;

  for (int idx = threadIdx.x; idx < BV * d; idx += blockDim.x) {
    acc[(idx / d) * ldacc + idx % d] = 0.0f;
  }
  for (int c = threadIdx.x; c < BV; c += blockDim.x) db[c] = 0.0f;
  load_rows(ws, ld, w, d, v0, BV, d, 0, v);
  for (int tile = split; tile < bsz * ntt; tile += nsplit) {
    const int b = tile / ntt;
    const int t0 = (tile - b * ntt) * BM;
    __syncthreads();  // the previous tile's readers of xs / exts are done
    load_bwd_tile<T, BM>(xs, ld, zr, dsum, exts, hs, z, ext, g, b, t0, t, d, v, s_len);
    head_dlogits<T, BM, BV>(xs, ld, ws, ld, lt, ldl, zr, dsum, exts, bias, g, b, t0, v0, t, d,
                            v, s_len);
    for (int idx = threadIdx.x; idx < BM * BV; idx += blockDim.x) {
      const int c = idx / BM;
      const int r = idx - c * BM;
      dlt[c * lddt + r] = from_f32<T>(lt[r * ldl + c]);
    }
    for (int c = threadIdx.x; c < BV; c += blockDim.x) {
      float sum = 0.0f;
      for (int r = 0; r < BM; ++r) sum += lt[r * ldl + c];
      db[c] += sum;
    }
    __syncthreads();
    smem_gemm<false>(dlt, lddt, xs, ld, acc, ldacc, BV, d, BM, true);
  }
  __syncthreads();
  const int valid = min(BV, v - v0);
  float* out = dw_part + ((size_t)split * v + v0) * d;
  for (int idx = threadIdx.x; idx < valid * d; idx += blockDim.x) {
    const int c = idx / d;
    out[idx] = acc[c * ldacc + idx - c * d];
  }
  for (int c = threadIdx.x; c < valid; c += blockDim.x) {
    db_part[(size_t)split * v + v0 + c] = db[c];
  }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T, int BM, int BV>
int launch_head_fwd(const void* hs, const void* w, const float* bias, const int* ext,
                    float* emit, float* z, int b, int t, int d, int v, int s,
                    cudaStream_t stream) {
  const HeadLayout L(d, s, BM, BV, sizeof(T), false, false);
  auto kernel = ctc_head_fwd_kernel<T, BM, BV>;
  if (int err = prepare(kernel, L.total)) return err;
  const dim3 grid((t + BM - 1) / BM, b);
  kernel<<<grid, kThreads, L.total, stream>>>(static_cast<const T*>(hs),
                                              static_cast<const T*>(w), bias, ext, emit, z, t,
                                              d, v, s);
  return (int)cudaGetLastError();
}

template <typename T, int BM, int BV>
int launch_head_bwd(const void* hs, const void* w, const float* bias, const int* ext,
                    const float* z, const float* g, void* dx, float* dw_part, float* db_part,
                    int nsplit, int b, int t, int d, int v, int s, cudaStream_t stream) {
  const HeadLayout Lx(d, s, BM, BV, sizeof(T), true, false);
  auto kx = ctc_head_dx_kernel<T, BM, BV>;
  if (int err = prepare(kx, Lx.total)) return err;
  kx<<<dim3((t + BM - 1) / BM, b), kThreads, Lx.total, stream>>>(
      static_cast<const T*>(hs), static_cast<const T*>(w), bias, ext, z, g, static_cast<T*>(dx),
      t, d, v, s);
  if (int err = (int)cudaGetLastError()) return err;
  const HeadLayout Lw(d, s, BM, BV, sizeof(T), true, true);
  auto kw = ctc_head_dw_kernel<T, BM, BV>;
  if (int err = prepare(kw, Lw.total)) return err;
  kw<<<dim3((v + BV - 1) / BV, nsplit), kThreads, Lw.total, stream>>>(
      static_cast<const T*>(hs), static_cast<const T*>(w), bias, ext, z, g, dw_part, db_part, b,
      t, d, v, s);
  return (int)cudaGetLastError();
}

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
  if (int err = (int)cudaGetLastError()) return err;
  dx_kernel<<<dim3((unsigned)cdiv(d, 128), (unsigned)row_tiles), 2 * BT, Dx::kSmemBytes,
              stream>>>(dlg, w, dhs, n, d, v, vp);
  if (int err = (int)cudaGetLastError()) return err;
  const long kchunk = cdiv(cdiv(n, nsplit), 32) * 32;
  dw_kernel<<<dim3((unsigned)(cdiv(v, 128) * cdiv(d, 128)), (unsigned)nsplit), 2 * BT,
              Dw::kSmemBytes, stream>>>(dlg, hs, dwp, n, d, v, vp, kchunk);
  return (int)cudaGetLastError();
}

}  // namespace ctc_head_bwd

inline bool head_args_ok(int b, int t, int d, int v, int s) {
  return b > 0 && t > 0 && v > 0 && s > 0 && d > 0 && d % 16 == 0 && b <= 65535;
}

}  // namespace espnet

// dtype: 0 = float32, 1 = bfloat16. hs: [B, T, D]; w: [V, D]; bias: f32 [V];
// ext: int32 [B, S]; emit: f32 [B, T, S]; z: f32 [B, T].
extern "C" int espnet_ctc_head_fwd(int dtype, const void* hs, const void* w, const float* bias,
                                   const int* ext, float* emit, float* z, int b, int t, int d,
                                   int v, int s, void* stream) {
  if (!espnet::head_args_ok(b, t, d, v, s)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return espnet::launch_head_fwd<espnet::bf16, 64, 64>(hs, w, bias, ext, emit, z, b, t, d, v, s,
                                                         st);
  }
  if (dtype == 0) {
    return espnet::launch_head_fwd<float, 32, 32>(hs, w, bias, ext, emit, z, b, t, d, v, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

// g: f32 [B, T, S] cotangent of emit; dx: [B, T, D] (hs's type);
// dw_part: f32 [nsplit, V, D], summed by the caller. db_part: f32 [parts,
// V], summed by the caller: parts = nsplit in fp32 and cdiv(B T,
// espnet_ctc_head_bwd_row_tile()) in bf16. The bf16 path also takes dsum =
// sum_s g (f32 [B, T]) and dlg, a bf16 [B T, vp] scratch (vp = V rounded up
// to a multiple of 8); fp32 takes neither.
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
  if (dtype == 1) {
    const long n = (long)b * t;
    if (n > 0x7fffffffL || !dsum || !dlg) return (int)cudaErrorInvalidValue;
    return espnet::ctc_head_bwd::launch(
        static_cast<const bf16*>(hs), static_cast<const bf16*>(w), bias, ext, z, dsum, g,
        static_cast<bf16*>(dlg), static_cast<bf16*>(dx), dw_part, db_part, nsplit, (int)n, t, d,
        v, vp, s, st);
  }
  if (dtype == 0) {
    return espnet::launch_head_bwd<float, 32, 32>(hs, w, bias, ext, z, g, dx, dw_part, db_part,
                                                  nsplit, b, t, d, v, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Rows of B T per dbias partial of the bf16 backward.
extern "C" int espnet_ctc_head_bwd_row_tile() { return espnet::ctc_head_bwd::BT; }
