// Fused position-wise feed-forward, forward only: out = swish(x W1 + b1) W2 + b2.
//
// Replaces the TPU kernel espnet_slurp_tpu/ops/pallas/ffn.py:fused_ffn
// (_fwd_kernel), which runs both macaron FFNs of every Conformer block.
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
