// CTC lattice, forward and backward, over a gathered emission matrix.
//
// Forward (alpha recursion over the blank-interleaved label sequence):
//   alpha[0, s] = emit[0, s] for s < 2, NEG otherwise;
//   alpha[t, s] = max(lse(alpha[t-1, s], alpha[t-1, s-1],
//                         skip[s] ? alpha[t-1, s-2] : NEG) + emit[t, s], NEG)
//   for t < tlen (frames past tlen are frozen), and
//   loss = -lse(alpha[n-1, last], last > 0 ? alpha[n-1, last-1] : NEG),
//   n = clamp(tlen, 1, T).
// Backward: the beta recursion (beta excludes the emission at (t, s)) and
//   demit[t, s] = -exp(min(alpha + beta - ll, 0)) * g   for t < tlen, else 0,
// exact zeros where g == 0 (infeasible or padded rows).
//
// Replaces the TPU kernel espnet_slurp_tpu/ops/pallas/ctc.py (_fwd_kernel via
// _pallas_fwd, _bwd_kernel via _ctc_bwd), the lattice under both CTC losses.
//
// What bounds it on the H100: at the flagship train step (B = 64, T' = 471,
// S = 129) the work is ~60k states x T' of log-space adds (a few MFLOP) on
// ~16 MB of emissions and ~31 MB of alphas: nothing here is compute, and the
// bytes take ~15 us at 3.35 TB/s. What really bounds it is the recursion's
// latency: T' dependent steps, each a block-wide barrier. So the design keeps
// each step short: one block per batch row, one thread per state, the
// previous alpha row in shared memory (double-buffered, one barrier per
// step), and stops at the row's own tlen instead of walking frozen frames.
// The TPU kernel's padding of B to 8 rows and S to 128 lanes is not needed.
//
// Precision: the recursions run in fp64. At the flagship shape the
// log-likelihoods are ~ -4200, where an fp32 ulp is ~5e-4, and the posterior
// exp(alpha + beta - ll) cancels three such numbers: in fp32 its error was
// 5e-3 of max |ref| on the card (posteriors of a frame summing to 1.001). In
// fp64 the cancellation is exact to ~1e-12; emissions, loss and demit stay
// fp32. FP64 costs nothing that matters here (a few million exp/log).
#include "common.cuh"

namespace espnet {

using acc_t = double;  // the recursions' type (see "Precision" above)
constexpr acc_t kNegD = -1e30;

__device__ __forceinline__ acc_t lse3(acc_t a, acc_t b, acc_t c) {
  const acc_t m = fmax(fmax(fmax(a, b), c), kNegD);
  return m + log(exp(a - m) + exp(b - m) + exp(c - m));
}

__device__ __forceinline__ acc_t lse2(acc_t a, acc_t b) {
  const acc_t m = fmax(fmax(a, b), kNegD);
  return m + log(exp(a - m) + exp(b - m));
}

// log-likelihood from the final alpha row (last and, when last > 0, last-1).
__device__ __forceinline__ acc_t final_ll(const acc_t* fin, int l) {
  return lse2(fin[l], l > 0 ? fin[l - 1] : kNegD);
}

// One block per batch row; dynamic shared memory: 2 * S acc_t.
__global__ void ctc_fwd_kernel(const float* __restrict__ emit, const float* __restrict__ skip,
                               const int* __restrict__ tlen, const int* __restrict__ last,
                               float* __restrict__ loss, acc_t* __restrict__ alpha, int t_max,
                               int s_len) {
  extern __shared__ acc_t buf[];  // [2][S]
  const int b = blockIdx.x;
  const float* e = emit + (size_t)b * t_max * s_len;
  const float* sk = skip + (size_t)b * s_len;
  acc_t* al = alpha + (size_t)b * t_max * s_len;
  const int n = min(max(tlen[b], 1), t_max);

  for (int s = threadIdx.x; s < s_len; s += blockDim.x) {
    const acc_t a0 = s < 2 ? (acc_t)e[s] : kNegD;
    buf[s] = a0;
    al[s] = a0;
  }
  __syncthreads();
  for (int t = 1; t < n; ++t) {
    const acc_t* prev = buf + ((t - 1) & 1) * s_len;
    acc_t* cur = buf + (t & 1) * s_len;
    const float* et = e + (size_t)t * s_len;
    for (int s = threadIdx.x; s < s_len; s += blockDim.x) {
      const acc_t a0 = prev[s];
      const acc_t a1 = s >= 1 ? prev[s - 1] : kNegD;
      const acc_t a2 = (s >= 2 && sk[s] > 0.0f) ? prev[s - 2] : kNegD;
      const acc_t v = fmax(lse3(a0, a1, a2) + (acc_t)et[s], kNegD);
      cur[s] = v;
      al[(size_t)t * s_len + s] = v;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int l = min(max(last[b], 0), s_len - 1);
    loss[b] = (float)(-final_ll(buf + ((n - 1) & 1) * s_len, l));
  }
}

// One block per batch row; dynamic shared memory: 2 * S acc_t.
__global__ void ctc_bwd_kernel(const float* __restrict__ emit, const float* __restrict__ skip,
                               const int* __restrict__ tlen, const int* __restrict__ last,
                               const acc_t* __restrict__ alpha, const float* __restrict__ grad,
                               float* __restrict__ demit, int t_max, int s_len) {
  extern __shared__ acc_t buf[];  // [2][S]
  const int b = blockIdx.x;
  const float* e = emit + (size_t)b * t_max * s_len;
  const float* sk = skip + (size_t)b * s_len;
  const acc_t* al = alpha + (size_t)b * t_max * s_len;
  float* de = demit + (size_t)b * t_max * s_len;
  const int tl = tlen[b];
  const int n = min(max(tl, 1), t_max);
  const float g = grad[b];
  const int l = min(max(last[b], 0), s_len - 1);
  // ll from the stored final alpha row, in fp64 (not from the fp32 loss).
  const acc_t ll = final_ll(al + (size_t)(n - 1) * s_len, l);

  // Frames the row does not have (t >= tlen), and every frame of a row whose
  // cotangent is 0, get exact zeros.
  const int active = g == 0.0f ? 0 : min(max(tl, 0), t_max);
  for (size_t i = (size_t)active * s_len + threadIdx.x; i < (size_t)t_max * s_len;
       i += blockDim.x) {
    de[i] = 0.0f;
  }
  if (active == 0) return;

  // Terminal beta at frame n - 1 (the frozen alpha past tlen is alpha[n-1]).
  for (int s = threadIdx.x; s < s_len; s += blockDim.x) {
    const acc_t bt = (s == l || s == max(l - 1, 0)) ? 0.0 : kNegD;
    buf[((n - 1) & 1) * s_len + s] = bt;
    if (n - 1 < active) {
      const acc_t post = al[(size_t)(n - 1) * s_len + s] + bt - ll;
      de[(size_t)(n - 1) * s_len + s] = (float)(-exp(fmin(post, 0.0))) * g;
    }
  }
  __syncthreads();
  for (int t = n - 2; t >= 0; --t) {
    const acc_t* nxt = buf + ((t + 1) & 1) * s_len;
    acc_t* cur = buf + (t & 1) * s_len;
    const float* en = e + (size_t)(t + 1) * s_len;
    for (int s = threadIdx.x; s < s_len; s += blockDim.x) {
      const acc_t b0 = nxt[s] + en[s];
      const acc_t b1 = s + 1 < s_len ? nxt[s + 1] + en[s + 1] : kNegD;
      const acc_t b2 = (s + 2 < s_len && sk[s + 2] > 0.0f) ? nxt[s + 2] + en[s + 2] : kNegD;
      const acc_t v = fmax(lse3(b0, b1, b2), kNegD);
      cur[s] = v;
      const acc_t post = al[(size_t)t * s_len + s] + v - ll;
      de[(size_t)t * s_len + s] = (float)(-exp(fmin(post, 0.0))) * g;
    }
    __syncthreads();
  }
}

inline int ctc_threads(int s_len) { return min(1024, ((s_len + 31) / 32) * 32); }

}  // namespace espnet

// emit: f32 [B, T, S]; skip: f32 [B, S]; tlen, last: int32 [B];
// loss: f32 [B]; alpha: f64 [B, T, S] (rows past tlen left unwritten).
extern "C" int espnet_ctc_fwd(const float* emit, const float* skip, const int* tlen,
                              const int* last, float* loss, double* alpha, int b, int t, int s,
                              void* stream) {
  if (b <= 0 || t <= 0 || s <= 0 || s > 3072) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)s * sizeof(espnet::acc_t);
  espnet::ctc_fwd_kernel<<<b, espnet::ctc_threads(s), smem, static_cast<cudaStream_t>(stream)>>>(
      emit, skip, tlen, last, loss, alpha, t, s);
  return (int)cudaGetLastError();
}

// alpha: the forward's; grad: f32 [B] cotangent of loss; demit: f32
// [B, T, S] (every entry written).
extern "C" int espnet_ctc_bwd(const float* emit, const float* skip, const int* tlen,
                              const int* last, const double* alpha, const float* grad,
                              float* demit, int b, int t, int s, void* stream) {
  if (b <= 0 || t <= 0 || s <= 0 || s > 3072) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)s * sizeof(espnet::acc_t);
  espnet::ctc_bwd_kernel<<<b, espnet::ctc_threads(s), smem, static_cast<cudaStream_t>(stream)>>>(
      emit, skip, tlen, last, alpha, grad, demit, t, s);
  return (int)cudaGetLastError();
}
