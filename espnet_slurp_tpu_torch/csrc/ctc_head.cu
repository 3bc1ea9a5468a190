// Fused CTC head: projection + logsumexp + label gather, forward and backward,
// with no [B, T, V] logits in device memory.
//
//   logits[b, t, v] = hs[b, t] . W[v] + bias[v]          (W: [V, D], bf16/fp32)
//   z[b, t]         = logsumexp_v logits[b, t, v]
//   emit[b, t, s]   = logits[b, t, ext[b, s]] - z[b, t]
// Backward, from demit g [B, T, S]:
//   dlogits = scatter_s(g) - softmax(logits) * sum_s g     (duplicates add)
//   dhs = dlogits . W,  dW = dlogits^T . hs,  dbias = sum over rows of dlogits
// with dlogits rounded to the element type before the two products, as the
// reference does.
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
// Design (the simple first version: WMMA tiles staged through shared memory,
// no pipelining):
// - forward: one block per (batch row, tile of BM frames). Pass 1 walks V in
//   chunks of BV rows of W: logits tile in shared memory, online max / sum per
//   frame. Pass 2 multiplies the frames by the gathered rows W[ext[s]] (a
//   lane gather is cheap here; the TPU's one-hot product is not needed) and
//   writes emit. z is saved for the backward, so the backward needs no
//   logsumexp pass.
// - backward, two kernels that each recompute the logits tile by tile:
//   dx: one block per (batch row, frame tile), accumulating dhs over the
//   vocabulary chunks; dw: one block per (vocabulary chunk, row split),
//   keeping that chunk of W resident and accumulating dW^T / dbias over its
//   share of the frame tiles into per-split partials that the wrapper sums
//   (deterministic: no atomics across blocks). Repeated labels add through
//   shared-memory atomics in the scatter.
#include "common.cuh"

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
// dw_part: f32 [nsplit, V, D] and db_part: f32 [nsplit, V], summed by the caller.
extern "C" int espnet_ctc_head_bwd(int dtype, const void* hs, const void* w, const float* bias,
                                   const int* ext, const float* z, const float* g, void* dx,
                                   float* dw_part, float* db_part, int nsplit, int b, int t,
                                   int d, int v, int s, void* stream) {
  if (!espnet::head_args_ok(b, t, d, v, s) || nsplit <= 0 || nsplit > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return espnet::launch_head_bwd<espnet::bf16, 64, 64>(hs, w, bias, ext, z, g, dx, dw_part,
                                                         db_part, nsplit, b, t, d, v, s, st);
  }
  if (dtype == 0) {
    return espnet::launch_head_bwd<float, 32, 32>(hs, w, bias, ext, z, g, dx, dw_part, db_part,
                                                  nsplit, b, t, d, v, s, st);
  }
  return (int)cudaErrorInvalidValue;
}
