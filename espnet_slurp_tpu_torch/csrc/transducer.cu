// RNN-T (transducer) lattice, forward and backward, over gathered blank and
// emit log-prob tables [B, T, U1] (U1 = U + 1).
//
// Forward (alpha recursion, alpha[0, 0] = 0):
//   alpha[t, u] = max(lse(alpha[t-1, u] + blank[t-1, u],
//                         alpha[t, u-1] + emit[t, u-1]), NEG)
//   loss = -(alpha[tl-1, ul] + blank[tl-1, ul]),
//   tl = min(tlen, T), ul = clamp(ulen, 0, U1-1); a row with tl < 1 gives 0.
// Backward: the beta recursion from the virtual row t = tl (0 at u = ul only,
//   NEG elsewhere), beta[t, u] = lse(blank[t, u] + beta[t+1, u],
//   emit[t, u] + beta[t, u+1]), and the posteriors
//   dblank[t, u] = -exp(min(alpha + blank + beta[t+1, u] - ll, 0)) * g,
//   demit[t, u]  = -exp(min(alpha + emit + beta[t, u+1] - ll, 0)) * g,
//   exact zeros for t >= tl and for every entry of a row whose g is 0.
//
// Replaces the TPU kernel espnet_slurp_tpu/ops/pallas/transducer.py
// (_fwd_kernel via _pallas_alpha, _bwd_kernel via _rnnt_bwd), the lattice
// under the transducer loss (espnet_slurp_tpu/ops/transducer.py:57-70).
//
// What bounds it on the H100: at the transducer train step (B 32, T' 468,
// U1 65) the tables are 3.9 MB each and the work a few million log-space
// adds: the bytes would take ~2 us. What really sets its pace is the
// dependency chain: alpha[t, u] needs its left and upper neighbours, so the
// lattice is walked along its T + U1 - 1 = 532 anti-diagonals, each a
// dependent step. The TPU kernel solved the within-row dependency with a
// 128-lane Hillis-Steele scan; here one block per utterance walks the
// anti-diagonals with one thread per u (the cells of a diagonal are
// independent), the previous diagonal in shared memory (double-buffered, one
// barrier per diagonal), and stops at the row's own tl. U1 need not be padded.
//
// Precision: as in the CTC lattice (csrc/ctc.cu), the recursions run in fp64:
// at T' ~ 470 the log-likelihoods are ~ -4000, where fp32's spacing (~5e-4)
// would show in alpha + beta - ll. Tables, loss and gradients stay fp32.
#include "common.cuh"

namespace espnet {

namespace {

using acc_t = double;
constexpr acc_t kNegR = -1e30;

__device__ __forceinline__ acc_t lse2r(acc_t a, acc_t b) {
  const acc_t m = fmax(fmax(a, b), kNegR);
  return m + log(exp(a - m) + exp(b - m));
}

// One block per batch row; dynamic shared memory: 2 * U1 acc_t.
__global__ void rnnt_fwd_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
                                const int* __restrict__ tlen, const int* __restrict__ ulen,
                                float* __restrict__ loss, acc_t* __restrict__ alpha, int t_max,
                                int u1) {
  extern __shared__ acc_t diag[];  // [2][U1]: alpha along two anti-diagonals
  const int b = blockIdx.x;
  const int tl = min(tlen[b], t_max);
  if (tl < 1) {
    if (threadIdx.x == 0) loss[b] = 0.0f;
    return;
  }
  const int ul = min(max(ulen[b], 0), u1 - 1);
  const size_t base = (size_t)b * t_max * u1;
  const float* bl = blank + base;
  const float* em = emit + base;
  acc_t* al = alpha + base;

  for (int d = 0; d < tl + u1 - 1; ++d) {
    const acc_t* prev = diag + ((d + 1) & 1) * u1;  // diagonal d - 1
    acc_t* cur = diag + (d & 1) * u1;
    for (int u = threadIdx.x; u < u1; u += blockDim.x) {
      const int t = d - u;
      acc_t v = kNegR;
      if (t >= 0 && t < tl) {
        if (d == 0) {
          v = 0.0;
        } else {
          const acc_t from_blank =
              t >= 1 ? prev[u] + (acc_t)bl[(size_t)(t - 1) * u1 + u] : kNegR;
          const acc_t from_emit =
              u >= 1 ? prev[u - 1] + (acc_t)em[(size_t)t * u1 + u - 1] : kNegR;
          v = fmax(lse2r(from_blank, from_emit), kNegR);
        }
        al[(size_t)t * u1 + u] = v;
      }
      cur[u] = v;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const size_t fin = (size_t)(tl - 1) * u1 + ul;
    loss[b] = (float)(-(al[fin] + (acc_t)bl[fin]));
  }
}

// One block per batch row; dynamic shared memory: 2 * U1 acc_t.
__global__ void rnnt_bwd_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
                                const int* __restrict__ tlen, const int* __restrict__ ulen,
                                const acc_t* __restrict__ alpha, const float* __restrict__ grad,
                                float* __restrict__ dblank, float* __restrict__ demit, int t_max,
                                int u1) {
  extern __shared__ acc_t diag[];  // [2][U1]: beta along two anti-diagonals
  const int b = blockIdx.x;
  const size_t base = (size_t)b * t_max * u1;
  const float* bl = blank + base;
  const float* em = emit + base;
  const acc_t* al = alpha + base;
  float* db = dblank + base;
  float* de = demit + base;
  const int tl = min(tlen[b], t_max);
  const float g = grad[b];

  // Frames the row does not have, and every frame of a row whose cotangent
  // is 0 (or that has no frame), get exact zeros.
  const int active = (g == 0.0f || tl < 1) ? 0 : tl;
  for (size_t i = (size_t)active * u1 + threadIdx.x; i < (size_t)t_max * u1; i += blockDim.x) {
    db[i] = 0.0f;
    de[i] = 0.0f;
  }
  if (active == 0) return;
  const int ul = min(max(ulen[b], 0), u1 - 1);
  // ll from the stored alphas, in fp64 (not from the fp32 loss).
  const size_t fin = (size_t)(tl - 1) * u1 + ul;
  const acc_t ll = al[fin] + (acc_t)bl[fin];

  for (int d = tl + u1 - 2; d >= 0; --d) {
    const acc_t* nxt = diag + ((d + 1) & 1) * u1;  // diagonal d + 1
    acc_t* cur = diag + (d & 1) * u1;
    for (int u = threadIdx.x; u < u1; u += blockDim.x) {
      const int t = d - u;
      acc_t v = kNegR;
      if (t >= 0 && t < tl) {
        const size_t i = (size_t)t * u1 + u;
        // beta[t+1, u] (the virtual row at t + 1 == tl) and beta[t, u+1].
        const acc_t b_down = t + 1 == tl ? (u == ul ? 0.0 : kNegR) : nxt[u];
        const acc_t b_right = u + 1 < u1 ? nxt[u + 1] : kNegR;
        const acc_t lb = (acc_t)bl[i], le = (acc_t)em[i], a = al[i];
        v = fmax(lse2r(lb + b_down, le + b_right), kNegR);
        db[i] = (float)(-exp(fmin(a + lb + b_down - ll, 0.0))) * g;
        de[i] = (float)(-exp(fmin(a + le + b_right - ll, 0.0))) * g;
      }
      cur[u] = v;
    }
    __syncthreads();
  }
}

inline int rnnt_threads(int u1) { return min(1024, ((u1 + 31) / 32) * 32); }

}  // namespace

}  // namespace espnet

// blank, emit: f32 [B, T, U1]; tlen, ulen: int32 [B]; loss: f32 [B];
// alpha: f64 [B, T, U1] (entries at t >= tlen left unwritten).
extern "C" int espnet_rnnt_fwd(const float* blank, const float* emit, const int* tlen,
                               const int* ulen, float* loss, double* alpha, int b, int t, int u1,
                               void* stream) {
  if (b <= 0 || t <= 0 || u1 <= 0 || u1 > 3072) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)u1 * sizeof(double);
  espnet::rnnt_fwd_kernel<<<b, espnet::rnnt_threads(u1), smem,
                            static_cast<cudaStream_t>(stream)>>>(blank, emit, tlen, ulen, loss,
                                                                 alpha, t, u1);
  return (int)cudaGetLastError();
}

// alpha: the forward's; grad: f32 [B] cotangent of the loss; dblank, demit:
// f32 [B, T, U1] (every entry written).
extern "C" int espnet_rnnt_bwd(const float* blank, const float* emit, const int* tlen,
                               const int* ulen, const double* alpha, const float* grad,
                               float* dblank, float* demit, int b, int t, int u1, void* stream) {
  if (b <= 0 || t <= 0 || u1 <= 0 || u1 > 3072) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)u1 * sizeof(double);
  espnet::rnnt_bwd_kernel<<<b, espnet::rnnt_threads(u1), smem,
                            static_cast<cudaStream_t>(stream)>>>(blank, emit, tlen, ulen, alpha,
                                                                 grad, dblank, demit, t, u1);
  return (int)cudaGetLastError();
}
