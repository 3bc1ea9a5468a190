// Fused position-wise feed-forward: out = swish(x W1 + b1) W2 + b2, forward
// and backward (the backward's own notes are at its kernels below).
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
// Design: one block owns BM rows of x, kept in shared memory for the whole
// block. It walks F in chunks of BF: the [BM, BF] hidden chunk is computed
// (x * W1[:, chunk]), biased and passed through swish in shared memory, cast to
// the element type, and immediately multiplied into the [BM, D2] fp32
// accumulator with W2[chunk, :]. The [N, F] hidden never reaches global
// memory. Ragged row tiles are zero-filled on load and masked on store. This is
// the simple first version (WMMA bf16 tiles staged through shared memory, no
// pipelining, one block per SM at the flagship shape); wgmma/TMA come later.
#include "common.cuh"

namespace espnet {

struct FfnLayout {
  size_t xs, w1s, hf, hs, w2s, acc, total;
  __host__ __device__ FfnLayout(int d, int d2, int bm, int bf, int esize) {
    const int p = 16 / esize;
    xs = 0;
    w1s = align128(xs + (size_t)bm * (d + p) * esize);
    hf = align128(w1s + (size_t)d * (bf + p) * esize);
    hs = align128(hf + (size_t)bm * (bf + 4) * 4);
    w2s = align128(hs + (size_t)bm * (bf + p) * esize);
    acc = align128(w2s + (size_t)bf * (d2 + p) * esize);
    total = align128(acc + (size_t)bm * (d2 + 4) * 4);
  }
};

template <typename T, int BM, int BF>
__global__ void __launch_bounds__(kThreads)
    ffn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
                   const T* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ out,
                   int n, int d, int f, int d2) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  const FfnLayout L(d, d2, BM, BF, sizeof(T));
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* w1s = reinterpret_cast<T*>(smem + L.w1s);
  float* hf = reinterpret_cast<float*>(smem + L.hf);
  T* hs = reinterpret_cast<T*>(smem + L.hs);
  T* w2s = reinterpret_cast<T*>(smem + L.w2s);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  const int ldx = d + P, ldw1 = BF + P, ldhf = BF + 4, ldh = BF + P, ldw2 = d2 + P,
            ldacc = d2 + 4;

  const long row0 = (long)blockIdx.x * BM;
  load_rows(xs, ldx, x, d, row0, BM, d, 0, n);
  for (int f0 = 0; f0 < f; f0 += BF) {
    load_rows(w1s, ldw1, w1 + f0, f, 0, d, BF, 0, d);
    load_rows(w2s, ldw2, w2, d2, f0, BF, d2, 0, f);
    __syncthreads();
    smem_gemm<false>(xs, ldx, w1s, ldw1, hf, ldhf, BM, BF, d, false);
    for (int idx = threadIdx.x; idx < BM * BF; idx += blockDim.x) {
      const int r = idx / BF;
      const int c = idx - r * BF;
      const float s = hf[r * ldhf + c] + b1[f0 + c];
      hs[r * ldh + c] = from_f32<T>(s / (1.0f + expf(-s)));
    }
    __syncthreads();
    smem_gemm<false>(hs, ldh, w2s, ldw2, acc, ldacc, BM, d2, BF, f0 > 0);
  }
  const int valid = min(BM, n - (int)row0);
  for (int idx = threadIdx.x; idx < valid * d2; idx += blockDim.x) {
    const int r = idx / d2;
    const int c = idx - r * d2;
    out[(row0 + r) * d2 + c] = from_f32<T>(acc[r * ldacc + c] + b2[c]);
  }
}

template <typename T, int BM, int BF>
int launch_ffn(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
               void* out, int n, int d, int f, int d2, cudaStream_t stream) {
  if (n <= 0 || d % 16 || d2 % 16 || f % BF) return (int)cudaErrorInvalidValue;
  const FfnLayout L(d, d2, BM, BF, sizeof(T));
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (L.total > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
  auto kernel = ffn_fwd_kernel<T, BM, BF>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  const dim3 grid((n + BM - 1) / BM);
  kernel<<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
      static_cast<T*>(out), n, d, f, d2);
  return (int)cudaGetLastError();
}


// ---- Backward -------------------------------------------------------------
//
// Replaces espnet_slurp_tpu/ops/pallas/ffn.py:_bwd_kernel. From the output
// cotangent g it recomputes s = x W1 + b1 chunk by chunk over F (no [N, F]
// hidden in device memory) and forms
//   dW2 = hd^T g, db2 = sum g, dh = g W2^T, ds = dh * swish'(s),
//   dW1 = x^T ds, db1 = sum ds, dx = ds W1^T,
// with swish'(s) = sig(s) (1 + s (1 - sig(s))), hd and ds rounded to the
// element type before the products (fp32 accumulation), as the reference does.
// Two kernels, each recomputing s and dh: dx (one block per BM rows, F walked
// in BF chunks, the [BM, D] fp32 dx accumulator in shared memory) and dw (one
// block per (F chunk, row split), that chunk of W1 and W2 resident, dW1^T /
// dW2 / db1 / db2 accumulated over the split's row tiles in shared memory and
// written as per-split fp32 partials that the wrapper sums: deterministic, no
// atomics). The bound is the tensor cores, as in the forward (~6x the
// forward's FLOPs with the recompute).

struct FfnBwdLayout {
  size_t xs, gs, w1s, w2s, sf, dhf, t1, t2, acc1, acc2, db1, db2, total;
  __host__ __device__ FfnBwdLayout(int d, int d2, int bm, int bf, int esize, bool dw) {
    const int p = 16 / esize;
    xs = 0;
    gs = align128(xs + (size_t)bm * (d + p) * esize);
    w1s = align128(gs + (size_t)bm * (d2 + p) * esize);
    w2s = align128(w1s + (size_t)d * (bf + p) * esize);
    sf = align128(w2s + (size_t)bf * (d2 + p) * esize);
    dhf = align128(sf + (size_t)bm * (bf + 4) * 4);
    t1 = align128(dhf + (size_t)bm * (bf + 4) * 4);
    // dx: t1 = ds [BM, BF], acc1 = dx [BM, D]. dw: t1 = hd^T, t2 = ds^T
    // [BF, BM]; acc1 = dW1^T [BF, D], acc2 = dW2 [BF, D2].
    const size_t tb = dw ? (size_t)bf * (bm + p) * esize : (size_t)bm * (bf + p) * esize;
    t2 = align128(t1 + tb);
    acc1 = align128(t2 + (dw ? tb : 0));
    acc2 = align128(acc1 + (size_t)(dw ? bf : bm) * (d + 4) * 4);
    db1 = align128(acc2 + (dw ? (size_t)bf * (d2 + 4) * 4 : 0));
    db2 = align128(db1 + (size_t)bf * 4);
    total = align128(db2 + (dw ? (size_t)d2 * 4 : 0));
  }
};

template <typename T, int BM, int BF>
__global__ void __launch_bounds__(kThreads)
    ffn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ w2,
                      const T* __restrict__ g, T* __restrict__ dx, int n, int d, int f, int d2) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  const FfnBwdLayout L(d, d2, BM, BF, sizeof(T), false);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* gs = reinterpret_cast<T*>(smem + L.gs);
  T* w1s = reinterpret_cast<T*>(smem + L.w1s);
  T* w2s = reinterpret_cast<T*>(smem + L.w2s);
  float* sf = reinterpret_cast<float*>(smem + L.sf);
  float* dhf = reinterpret_cast<float*>(smem + L.dhf);
  T* dss = reinterpret_cast<T*>(smem + L.t1);
  float* acc = reinterpret_cast<float*>(smem + L.acc1);
  const int ldx = d + P, ldg = d2 + P, ldw1 = BF + P, ldw2 = d2 + P, ldf = BF + 4, ldds = BF + P,
            ldacc = d + 4;

  const long row0 = (long)blockIdx.x * BM;
  load_rows(xs, ldx, x, d, row0, BM, d, 0, n);
  load_rows(gs, ldg, g, d2, row0, BM, d2, 0, n);
  for (int f0 = 0; f0 < f; f0 += BF) {
    load_rows(w1s, ldw1, w1 + f0, f, 0, d, BF, 0, d);
    load_rows(w2s, ldw2, w2, d2, f0, BF, d2, 0, f);
    __syncthreads();
    smem_gemm<false>(xs, ldx, w1s, ldw1, sf, ldf, BM, BF, d, false);
    smem_gemm<true>(gs, ldg, w2s, ldw2, dhf, ldf, BM, BF, d2, false);
    for (int idx = threadIdx.x; idx < BM * BF; idx += blockDim.x) {
      const int r = idx / BF;
      const int c = idx - r * BF;
      const float s = sf[r * ldf + c] + b1[f0 + c];
      const float sig = 1.0f / (1.0f + expf(-s));
      dss[r * ldds + c] = from_f32<T>(dhf[r * ldf + c] * sig * (1.0f + s * (1.0f - sig)));
    }
    __syncthreads();
    smem_gemm<true>(dss, ldds, w1s, ldw1, acc, ldacc, BM, d, BF, f0 > 0);
  }
  const int valid = min(BM, n - (int)row0);
  for (int idx = threadIdx.x; idx < valid * d; idx += blockDim.x) {
    const int r = idx / d;
    const int c = idx - r * d;
    dx[(row0 + r) * d + c] = from_f32<T>(acc[r * ldacc + c]);
  }
}

template <typename T, int BM, int BF>
__global__ void __launch_bounds__(kThreads)
    ffn_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ w2,
                      const T* __restrict__ g, float* __restrict__ dw1p, float* __restrict__ db1p,
                      float* __restrict__ dw2p, float* __restrict__ db2p, int n, int d, int f,
                      int d2) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  const FfnBwdLayout L(d, d2, BM, BF, sizeof(T), true);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* gs = reinterpret_cast<T*>(smem + L.gs);
  T* w1s = reinterpret_cast<T*>(smem + L.w1s);
  T* w2s = reinterpret_cast<T*>(smem + L.w2s);
  float* sf = reinterpret_cast<float*>(smem + L.sf);
  float* dhf = reinterpret_cast<float*>(smem + L.dhf);
  T* hdt = reinterpret_cast<T*>(smem + L.t1);
  T* dst = reinterpret_cast<T*>(smem + L.t2);
  float* acc1 = reinterpret_cast<float*>(smem + L.acc1);
  float* acc2 = reinterpret_cast<float*>(smem + L.acc2);
  float* db1 = reinterpret_cast<float*>(smem + L.db1);
  float* db2 = reinterpret_cast<float*>(smem + L.db2);
  const int ldx = d + P, ldg = d2 + P, ldw1 = BF + P, ldw2 = d2 + P, ldf = BF + 4, ldt = BM + P,
            lda1 = d + 4, lda2 = d2 + 4;
  const int f0 = blockIdx.x * BF;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const bool first_chunk = blockIdx.x == 0;
  const int ntiles = (n + BM - 1) / BM;

  for (int idx = threadIdx.x; idx < BF * d; idx += blockDim.x) {
    acc1[(idx / d) * lda1 + idx % d] = 0.0f;
  }
  for (int idx = threadIdx.x; idx < BF * d2; idx += blockDim.x) {
    acc2[(idx / d2) * lda2 + idx % d2] = 0.0f;
  }
  for (int c = threadIdx.x; c < BF; c += blockDim.x) db1[c] = 0.0f;
  for (int c = threadIdx.x; c < d2; c += blockDim.x) db2[c] = 0.0f;
  load_rows(w1s, ldw1, w1 + f0, f, 0, d, BF, 0, d);
  load_rows(w2s, ldw2, w2, d2, f0, BF, d2, 0, f);
  for (int tile = split; tile < ntiles; tile += nsplit) {
    const long row0 = (long)tile * BM;
    __syncthreads();  // the previous tile's readers of xs / gs are done
    load_rows(xs, ldx, x, d, row0, BM, d, 0, n);
    load_rows(gs, ldg, g, d2, row0, BM, d2, 0, n);
    __syncthreads();
    smem_gemm<false>(xs, ldx, w1s, ldw1, sf, ldf, BM, BF, d, false);
    smem_gemm<true>(gs, ldg, w2s, ldw2, dhf, ldf, BM, BF, d2, false);
    const int valid = min(BM, n - (int)row0);
    for (int idx = threadIdx.x; idx < BM * BF; idx += blockDim.x) {
      const int r = idx / BF;
      const int c = idx - r * BF;
      float h = 0.0f, ds = 0.0f;
      if (r < valid) {
        const float s = sf[r * ldf + c] + b1[f0 + c];
        const float sig = 1.0f / (1.0f + expf(-s));
        h = s * sig;
        ds = dhf[r * ldf + c] * sig * (1.0f + s * (1.0f - sig));
      }
      hdt[c * ldt + r] = from_f32<T>(h);
      dst[c * ldt + r] = from_f32<T>(ds);
      sf[r * ldf + c] = ds;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < BF; c += blockDim.x) {
      float sum = 0.0f;
      for (int r = 0; r < valid; ++r) sum += sf[r * ldf + c];
      db1[c] += sum;
    }
    if (first_chunk) {
      for (int c = threadIdx.x; c < d2; c += blockDim.x) {
        float sum = 0.0f;
        for (int r = 0; r < valid; ++r) sum += to_f32(gs[r * ldg + c]);
        db2[c] += sum;
      }
    }
    smem_gemm<false>(hdt, ldt, gs, ldg, acc2, lda2, BF, d2, BM, true);
    smem_gemm<false>(dst, ldt, xs, ldx, acc1, lda1, BF, d, BM, true);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BF * d; idx += blockDim.x) {
    const int k = idx / BF;  // consecutive threads: consecutive F columns
    const int c = idx - k * BF;
    dw1p[((size_t)split * d + k) * f + f0 + c] = acc1[c * lda1 + k];
  }
  for (int idx = threadIdx.x; idx < BF * d2; idx += blockDim.x) {
    const int c = idx / d2;
    const int k = idx - c * d2;
    dw2p[((size_t)split * f + f0 + c) * d2 + k] = acc2[c * lda2 + k];
  }
  for (int c = threadIdx.x; c < BF; c += blockDim.x) db1p[(size_t)split * f + f0 + c] = db1[c];
  if (first_chunk) {
    for (int c = threadIdx.x; c < d2; c += blockDim.x) db2p[(size_t)split * d2 + c] = db2[c];
  }
}

template <typename T, int BM, int BF>
int launch_ffn_bwd(const void* x, const void* w1, const float* b1, const void* w2, const void* g,
                   void* dx, float* dw1p, float* db1p, float* dw2p, float* db2p, int nsplit,
                   int n, int d, int f, int d2, cudaStream_t stream) {
  if (n <= 0 || d % 16 || d2 % 16 || f % BF || nsplit <= 0 || nsplit > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const FfnBwdLayout Lx(d, d2, BM, BF, sizeof(T), false);
  const FfnBwdLayout Lw(d, d2, BM, BF, sizeof(T), true);
  if (Lx.total > (size_t)max_smem || Lw.total > (size_t)max_smem) {
    return (int)cudaErrorInvalidConfiguration;
  }
  auto kx = ffn_bwd_dx_kernel<T, BM, BF>;
  auto kw = ffn_bwd_dw_kernel<T, BM, BF>;
  cudaFuncSetAttribute(kx, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lx.total);
  cudaFuncSetAttribute(kw, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lw.total);
  const T* xt = static_cast<const T*>(x);
  const T* w1t = static_cast<const T*>(w1);
  const T* w2t = static_cast<const T*>(w2);
  const T* gt = static_cast<const T*>(g);
  kx<<<(n + BM - 1) / BM, kThreads, Lx.total, stream>>>(xt, w1t, b1, w2t, gt, static_cast<T*>(dx),
                                                        n, d, f, d2);
  if (int err = (int)cudaGetLastError()) return err;
  kw<<<dim3(f / BF, nsplit), kThreads, Lw.total, stream>>>(xt, w1t, b1, w2t, gt, dw1p, db1p, dw2p,
                                                          db2p, n, d, f, d2);
  return (int)cudaGetLastError();
}

}  // namespace espnet

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code (0 = launched).
extern "C" int espnet_fused_ffn_fwd(int dtype, const void* x, const void* w1, const float* b1,
                                    const void* w2, const float* b2, void* out, int n, int d,
                                    int f, int d2, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return espnet::launch_ffn<espnet::bf16, 32, 64>(x, w1, b1, w2, b2, out, n, d, f, d2, s);
  if (dtype == 0) return espnet::launch_ffn<float, 32, 32>(x, w1, b1, w2, b2, out, n, d, f, d2, s);
  return (int)cudaErrorInvalidValue;
}

// Row-chunk width over F that the kernel requires F to be a multiple of.
extern "C" int espnet_fused_ffn_f_multiple(int dtype) { return dtype == 1 ? 64 : 32; }

extern "C" const char* espnet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Backward. g: [N, D2] (x's type); dx: [N, D]; per-split fp32 partials
// dw1p [nsplit, D, F], db1p [nsplit, F], dw2p [nsplit, F, D2], db2p
// [nsplit, D2], summed by the caller. Returns a cudaError_t code.
extern "C" int espnet_fused_ffn_bwd(int dtype, const void* x, const void* w1, const float* b1,
                                    const void* w2, const void* g, void* dx, float* dw1p,
                                    float* db1p, float* dw2p, float* db2p, int nsplit, int n,
                                    int d, int f, int d2, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return espnet::launch_ffn_bwd<espnet::bf16, 64, 32>(x, w1, b1, w2, g, dx, dw1p, db1p, dw2p,
                                                        db2p, nsplit, n, d, f, d2, s);
  }
  if (dtype == 0) {
    return espnet::launch_ffn_bwd<float, 16, 32>(x, w1, b1, w2, g, dx, dw1p, db1p, dw2p, db2p,
                                                 nsplit, n, d, f, d2, s);
  }
  return (int)cudaErrorInvalidValue;
}
