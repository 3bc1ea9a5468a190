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
// lattice is walked along its tl + U1 - 1 anti-diagonals (532 at full
// length), each a dependent step. The TPU kernel solved the within-row
// dependency with a 128-lane Hillis-Steele scan; here the cells of a
// diagonal are independent and a diagonal is one step.
//
// Two routes, by U1 (both stop at each row's own tl):
//   rnnt_warp, U1 <= kWarpStates (256): one warp per utterance, one warp a
//     block (B 32 utterances on 132 SMs: each has an SM's units and L1 to
//     itself). Lane `lane` holds the states u = lane + 32 j (j < J =
//     ceil(U1 / 32)) in registers; a diagonal's step is J independent
//     lse2's on them. alpha[t, u-1] (backward beta[t, u+1]) comes from the
//     previous diagonal by one fp64 shuffle a slot, the slot wrapping at lane
//     0 (31); alpha[t-1, u] (beta[t+1, u]) is the lane's own register: no
//     barrier and no shared-memory trip on the chain. lse2 keeps the running
//     value in fp64 and forms the correction log1p(e^-|a-b|) in fp32 by the
//     MUFU, with no table on the chain (lse2_n).
//     No load on the chain: a diagonal's table entries lie at stride U1 - 1,
//     so a group of 8 lanes loads 8 consecutive entries of one row by
//     cp.async (4 runs, not 32 scattered entries, a copy instruction) into
//     its lanes' own columns of a 16-row ring, 6 steps before the group's
//     first reader, and each lane reads its entry of the next diagonal from
//     its own column a step before its use. No lane reads another's ring
//     elements, so the rings need no warp barrier. The alpha residual is the
//     port's own tensor, so it is stored diagonal-major, [B, T + U1 - 1, U1]
//     fp64: row d holds diagonal d, the forward's stores and the backward's
//     ring loads (8 diagonals) are coalesced, at +1.1 MB over [B, T, U1] at
//     the train shape. dblank and demit go to their row-major addresses, off
//     the chain.
//     Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py, B 32, T'
//     468, U1 65): 0.42 us a step forward, 0.58 backward (0.2216 / 0.3095
//     ms over 532 steps; the first version took 0.70 / 0.81); the build
//     reports J 3: 59 / 93 registers, 12,288 / 18,432 B of shared memory,
//     17 / 12 blocks an SM, no spills; J 8: 102 / 196 registers, 32,768 /
//     49,152 B, no spills. The step is still ~100x its bytes' share: one
//     warp issues all of it, and in variants that dropped parts of the
//     forward's loop, the lse2 and the loads and stores beside it each
//     took a large share.
//   rnnt_block, kWarpStates < U1 <= 3072: the first version, kept as the
//     route for label sequences whose states do not fit a warp's registers:
//     one block per utterance, one thread per state, the previous diagonal in
//     shared memory (double-buffered, one barrier per diagonal), the
//     library's fp64 exp and log; the same diagonal-major residual.
//
// Precision: as in the CTC lattice (csrc/ctc.cu), the running values are
// fp64: at T' ~ 470 the log-likelihoods are ~ -4000, where fp32's spacing
// (~5e-4) would show in alpha + beta - ll. Tables, loss and gradients stay
// fp32.
#include <type_traits>

#include "common.cuh"
#include "mma_gemm.cuh"

namespace espnet {

using acc_t = double;  // the recursions' type (see "Precision" above)
constexpr acc_t kNegD = -1e30;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ acc_t dmax(acc_t a, acc_t b) { return a > b ? a : b; }

// A gradient from its fp64 posterior exponent: -exp(post) * g, the exp in
// fp32 (off the recursion's chain).
__device__ __forceinline__ float posterior_grad(acc_t post, float g) {
  return -expf((float)fmin(post, 0.0)) * g;
}

// ---- One warp per utterance (U1 <= kWarpStates) -----------------------------

namespace rnnt_warp {

constexpr int kMaxJ = 8;                 // states a lane
constexpr int kWarpStates = 32 * kMaxJ;  // the route's limit on U1
// A group of kGroup lanes loads kGroup consecutive entries of one table row,
// kAhead steps before the group's first reader needs it, into the lanes'
// own columns of a ring of kRows rows.
constexpr int kGroup = 8;
constexpr int kAhead = 6;
constexpr int kRows = 16;
static_assert(kRows >= kAhead + kGroup + 1, "a ring slot outlives its reads");
static_assert((kRows & (kRows - 1)) == 0, "ring slots by mask");
// Backward: alpha's rows (diagonal-major, coalesced) in a ring of kAlpha
// diagonals, each fetched kAhead steps before its use.
constexpr int kAlpha = 8;
static_assert(kAlpha >= kAhead + 2 && (kAlpha & (kAlpha - 1)) == 0, "alpha ring slots");

// out[i] <- log(e^a[i] + e^b[i]) = top + log1p(e^-|a - b|): top, the larger
// term, is the fp64 running value; the correction (0 to log 2) is formed in
// fp32 by the MUFU's ex2 and lg2, branch-free and with no table on the
// chain: variants of these kernels with an fp64 lse2 on shared-memory
// tables, as csrc/ctc.cu's lse3, or with the library's expf and log1pf
// took longer a step on the H100. The approximations' error, ~2e-7 a
// step, moved the gradients by 2.2e-6 of max |ref| at the train shape
// (chip_smoke.py).
template <int N>
__device__ __forceinline__ void lse2_n(const acc_t (&a)[N], const acc_t (&b)[N],
                                       acc_t (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool ab = a[i] > b[i];
    const acc_t top = ab ? a[i] : b[i];
    const float d = (float)dmax((ab ? b[i] : a[i]) - top, -80.0);
    float e, l;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(d * 1.4426950408889634f));
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(1.0f + e));
    out[i] = top + (acc_t)(l * 0.6931471805599453f);
  }
}

// x1[j] <- x at state u - 1 of u = lane + 32 j (NEG below 0): each slot
// rotated down one lane, lane 0's from slot j - 1's lane 31.
template <int J>
__device__ __forceinline__ void from_below(const acc_t (&x)[J], acc_t (&x1)[J], int lane) {
  acc_t r[J];
#pragma unroll
  for (int j = 0; j < J; ++j) r[j] = __shfl_sync(kFull, x[j], (lane + 31) & 31);
#pragma unroll
  for (int j = 0; j < J; ++j) x1[j] = lane >= 1 ? r[j] : (j > 0 ? r[j > 0 ? j - 1 : 0] : kNegD);
}

// x1[j] <- x at state u + 1 (NEG past the last slot): lane 31's from slot
// j + 1's lane 0.
template <int J>
__device__ __forceinline__ void from_above(const acc_t (&x)[J], acc_t (&x1)[J], int lane) {
  acc_t r[J];
#pragma unroll
  for (int j = 0; j < J; ++j) r[j] = __shfl_sync(kFull, x[j], (lane + 1) & 31);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    x1[j] = lane <= 30 ? r[j] : (j + 1 < J ? r[j + 1 < J ? j + 1 : j] : kNegD);
  }
}

// Each lane's entry (r, u) of both tables (the utterance's,
// row-major [T, U1]) for its states u = lane + 32 j, r = r0 - 32 j, into
// slot r % kRows of its own column of the ring, in flight until a cp.async
// wait. r0 is the same for the kGroup lanes of a group, so one copy
// instruction reads 32 / kGroup runs of kGroup consecutive entries. Entries
// off the lattice (r outside [0, tl), u >= U1) are zero-filled without a
// read.
template <int J>
__device__ __forceinline__ void fetch_rows(float (&ring)[2][kRows][32 * J], const float* bl,
                                           const float* em, int r0, int tl, int u1, int lane,
                                           const bool (&in)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int r = r0 - 32 * j, u = lane + 32 * j;
    const bool ok = in[j] && (unsigned)r < (unsigned)tl;
    const size_t at = ok ? (size_t)r * u1 + u : 0;
    mma::cp_async4(&ring[0][r & (kRows - 1)][u], bl + at, ok);
    mma::cp_async4(&ring[1][r & (kRows - 1)][u], em + at, ok);
  }
}

// This lane's entries (d - u, u) of diagonal d, from the ring.
template <int J>
__device__ __forceinline__ void read_diag(const float (&ring)[2][kRows][32 * J], int d, int lane,
                                          float (&xb)[J], float (&xe)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int u = lane + 32 * j;
    xb[j] = ring[0][(d - u) & (kRows - 1)][u];
    xe[j] = ring[1][(d - u) & (kRows - 1)][u];
  }
}

// One warp (block) per batch row; alpha: [B, T + U1 - 1, U1], row d of an
// utterance diagonal d (rows d >= tl + U1 - 1 left unwritten; entries off
// the lattice hold NEG or the state's last value).
template <int J>
__global__ void __launch_bounds__(32)
    fwd_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
               const int* __restrict__ tlen, const int* __restrict__ ulen,
               float* __restrict__ loss, acc_t* __restrict__ alpha, int t_max, int u1) {
  __shared__ float ring[2][kRows][32 * J];  // blank, emit: row t in slot t % kRows
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int tl = min(tlen[b], t_max);
  if (tl < 1) {
    if (lane == 0) loss[b] = 0.0f;
    return;
  }
  const int ul = min(max(ulen[b], 0), u1 - 1);
  const int nd = tl + u1 - 1;  // the row's diagonals
  const size_t base = (size_t)b * t_max * u1;
  const float* bl = blank + base;
  const float* em = emit + base;
  acc_t* row = alpha + (size_t)b * (t_max + u1 - 1) * u1 + lane;  // diagonal 0

  // a[j]: alpha at (d - u, u) after step d, frozen once d - u reaches tl
  // (so that alpha[tl - 1, u] is left at the end) and NEG before d - u
  // reaches 0.
  bool in[J];
  acc_t a[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    in[j] = lane + 32 * j < u1;
    a[j] = lane + 32 * j == 0 ? 0.0 : kNegD;
    if (in[j]) row[32 * j] = a[j];
  }
  // Step d reads diagonal d - 1's entries, into registers one iteration
  // before (at iteration d - 1). Iteration i fetches row i + kAhead - g of
  // the tables (g = the group's first state), which a lane of the group first
  // reads at iteration i + kAhead; the prologue's iterations 1 - kAhead -
  // kGroup .. 0 fetch every row a read touches before then.
  const int g0 = lane & ~(kGroup - 1);
#pragma unroll 1
  for (int i = 1 - kAhead - kGroup; i <= 0; ++i) {
    fetch_rows<J>(ring, bl, em, i + kAhead - g0, tl, u1, lane, in);
    mma::cp_async_commit();
  }
  float cb[J], ce[J];  // diagonal d - 1's entries at step d
  mma::cp_async_wait<kAhead>();
  read_diag<J>(ring, 0, lane, cb, ce);
  for (int d = 1; d < nd; ++d) {
    row += u1;
    acc_t pb[J], pe[J], pe1[J], v[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      pb[j] = a[j] + (acc_t)cb[j];  // to (t, u) from (t - 1, u)
      pe[j] = a[j] + (acc_t)ce[j];  // to (t, u + 1) from (t, u)
    }
    from_below<J>(pe, pe1, lane);
    // Diagonal d's entries for the next step (every fetch from iteration
    // d - kAhead on landed), and this iteration's fetch.
    mma::cp_async_wait<kAhead - 1>();
    read_diag<J>(ring, d, lane, cb, ce);
    fetch_rows<J>(ring, bl, em, d + kAhead - g0, tl, u1, lane, in);
    mma::cp_async_commit();
    lse2_n<J>(pb, pe1, v);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int t = d - lane - 32 * j;
      if (in[j] && (unsigned)t < (unsigned)tl) a[j] = dmax(v[j], kNegD);
      if (in[j]) row[32 * j] = a[j];
    }
  }
  mma::cp_async_wait<0>();
  // alpha[tl - 1, ul] from the lane that holds state ul (a max over the
  // lane's states, not a select by slot, which the compiler turns into an
  // indexed load from local memory).
  acc_t fin = -CUDART_INF;
#pragma unroll
  for (int j = 0; j < J; ++j) fin = fmax(fin, lane + 32 * j == ul ? a[j] : -CUDART_INF);
  fin = __shfl_sync(kFull, fin, ul & 31);
  if (lane == 0) loss[b] = (float)(-(fin + (acc_t)bl[(size_t)(tl - 1) * u1 + ul]));
}

template <int J>
__global__ void __launch_bounds__(32)
    bwd_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
               const int* __restrict__ tlen, const int* __restrict__ ulen,
               const acc_t* __restrict__ alpha, const float* __restrict__ grad,
               float* __restrict__ dblank, float* __restrict__ demit, int t_max, int u1) {
  __shared__ float ring[2][kRows][32 * J];  // blank, emit: row t in slot t % kRows
  __shared__ acc_t aring[kAlpha][32 * J];    // alpha's diagonal d in slot d % kAlpha
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * t_max * u1;
  const float* bl = blank + base;
  const float* em = emit + base;
  float* db = dblank + base;
  float* de = demit + base;
  const int tl = min(tlen[b], t_max);
  const float g = grad[b];
  // Frames the row does not have, and every frame of a row whose cotangent
  // is 0 (or that has no frame), get exact zeros.
  const int active = (g == 0.0f || tl < 1) ? 0 : tl;
  for (size_t i = (size_t)active * u1 + lane; i < (size_t)t_max * u1; i += 32) {
    db[i] = 0.0f;
    de[i] = 0.0f;
  }
  if (active == 0) return;
  const int ul = min(max(ulen[b], 0), u1 - 1);
  const int nd = tl + u1 - 1;
  const acc_t* ar = alpha + (size_t)b * (t_max + u1 - 1) * u1;
  // ll from the stored alphas, in fp64 (not from the fp32 loss).
  const acc_t ll = ar[(size_t)(tl - 1 + ul) * u1 + ul] + (acc_t)bl[(size_t)(tl - 1) * u1 + ul];
  // beta[j]: beta at (d + 1 - u, u) before step d: the virtual row's value
  // where d + 1 - u == tl, NEG past it.
  bool in[J];
  acc_t beta[J], virt[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int u = lane + 32 * j;
    in[j] = u < u1;
    virt[j] = u == ul ? 0.0 : kNegD;
    beta[j] = u == u1 - 1 ? virt[j] : kNegD;
  }
  // Steps run d = nd - 1 down to 0; step d reads diagonal d's entries,
  // into registers at iteration d + 1, and alpha's diagonal d from its slot.
  // Iteration i fetches row i - g - kGroup - kAhead of the tables (a lane of
  // the group first reads it at iteration i - kAhead or later) and alpha's
  // diagonal i - 1 - kAhead; the prologue's iterations nd + kAhead + kGroup
  // - 1 .. nd fetch what a read touches before then.
  const int g0 = lane & ~(kGroup - 1);
  auto fetch = [&](int i) {
    fetch_rows<J>(ring, bl, em, i - g0 - kGroup - kAhead, tl, u1, lane, in);
    const int d = i - 1 - kAhead;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const bool ok = in[j] && d >= 0 && d < nd;
      mma::cp_async8(&aring[d & (kAlpha - 1)][lane + 32 * j],
                     ok ? ar + (size_t)d * u1 + lane + 32 * j : ar, ok);
    }
    mma::cp_async_commit();
  };
#pragma unroll 1
  for (int i = nd + kAhead + kGroup - 1; i >= nd; --i) fetch(i);
  float cb[J], ce[J];  // diagonal d's entries at step d
  mma::cp_async_wait<kAhead>();
  read_diag<J>(ring, nd - 1, lane, cb, ce);
  for (int d = nd - 1; d >= 0; --d) {
    // Diagonal d - 1's entries for the next step (every fetch from
    // iteration d + kAhead on landed), and this iteration's fetch.
    mma::cp_async_wait<kAhead - 1>();
    float nb[J], ne[J];
    read_diag<J>(ring, d - 1, lane, nb, ne);
    fetch(d);
    acc_t right[J], xb[J], xe[J], v[J];
    from_above<J>(beta, right, lane);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      xb[j] = (acc_t)cb[j] + beta[j];   // blank[t, u] + beta[t + 1, u]
      xe[j] = (acc_t)ce[j] + right[j];  // emit[t, u] + beta[t, u + 1]
    }
    lse2_n<J>(xb, xe, v);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int u = lane + 32 * j, t = d - u;
      const bool live = in[j] && (unsigned)t < (unsigned)tl;
      if (live) {  // the posteriors, at their row-major addresses
        const acc_t ca = aring[d & (kAlpha - 1)][u];
        const size_t i = (size_t)t * u1 + u;
        db[i] = posterior_grad(ca + xb[j] - ll, g);
        de[i] = posterior_grad(ca + xe[j] - ll, g);
      }
      beta[j] = live ? dmax(v[j], kNegD) : (t == tl ? virt[j] : kNegD);
      cb[j] = nb[j];
      ce[j] = ne[j];
    }
  }
  mma::cp_async_wait<0>();
}

}  // namespace rnnt_warp

// ---- One block per utterance (kWarpStates < U1 <= 3072) ---------------------

namespace rnnt_block {

constexpr int kMaxStates = 3072;

// The library's fp64 exp and log.
__device__ __forceinline__ acc_t lse2r(acc_t a, acc_t b) {
  const acc_t m = fmax(fmax(a, b), kNegD);
  return m + log(exp(a - m) + exp(b - m));
}

// One block per batch row; dynamic shared memory: 2 * U1 acc_t. alpha as
// the warp route's (diagonal-major).
__global__ void fwd_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
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
  acc_t* al = alpha + (size_t)b * (t_max + u1 - 1) * u1;

  for (int d = 0; d < tl + u1 - 1; ++d) {
    const acc_t* prev = diag + ((d + 1) & 1) * u1;  // diagonal d - 1
    acc_t* cur = diag + (d & 1) * u1;
    for (int u = threadIdx.x; u < u1; u += blockDim.x) {
      const int t = d - u;
      acc_t v = kNegD;
      if (t >= 0 && t < tl) {
        if (d == 0) {
          v = 0.0;
        } else {
          const acc_t from_blank =
              t >= 1 ? prev[u] + (acc_t)bl[(size_t)(t - 1) * u1 + u] : kNegD;
          const acc_t from_emit =
              u >= 1 ? prev[u - 1] + (acc_t)em[(size_t)t * u1 + u - 1] : kNegD;
          v = fmax(lse2r(from_blank, from_emit), kNegD);
        }
        al[(size_t)d * u1 + u] = v;
      }
      cur[u] = v;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    loss[b] = (float)(-(al[(size_t)(tl - 1 + ul) * u1 + ul] +
                        (acc_t)bl[(size_t)(tl - 1) * u1 + ul]));
  }
}

// One block per batch row; dynamic shared memory: 2 * U1 acc_t.
__global__ void bwd_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
                           const int* __restrict__ tlen, const int* __restrict__ ulen,
                           const acc_t* __restrict__ alpha, const float* __restrict__ grad,
                           float* __restrict__ dblank, float* __restrict__ demit, int t_max,
                           int u1) {
  extern __shared__ acc_t diag[];  // [2][U1]: beta along two anti-diagonals
  const int b = blockIdx.x;
  const size_t base = (size_t)b * t_max * u1;
  const float* bl = blank + base;
  const float* em = emit + base;
  const acc_t* al = alpha + (size_t)b * (t_max + u1 - 1) * u1;
  float* db = dblank + base;
  float* de = demit + base;
  const int tl = min(tlen[b], t_max);
  const float g = grad[b];

  const int active = (g == 0.0f || tl < 1) ? 0 : tl;
  for (size_t i = (size_t)active * u1 + threadIdx.x; i < (size_t)t_max * u1; i += blockDim.x) {
    db[i] = 0.0f;
    de[i] = 0.0f;
  }
  if (active == 0) return;
  const int ul = min(max(ulen[b], 0), u1 - 1);
  const acc_t ll = al[(size_t)(tl - 1 + ul) * u1 + ul] + (acc_t)bl[(size_t)(tl - 1) * u1 + ul];

  for (int d = tl + u1 - 2; d >= 0; --d) {
    const acc_t* nxt = diag + ((d + 1) & 1) * u1;  // diagonal d + 1
    acc_t* cur = diag + (d & 1) * u1;
    for (int u = threadIdx.x; u < u1; u += blockDim.x) {
      const int t = d - u;
      acc_t v = kNegD;
      if (t >= 0 && t < tl) {
        const size_t i = (size_t)t * u1 + u;
        // beta[t+1, u] (the virtual row at t + 1 == tl) and beta[t, u+1].
        const acc_t b_down = t + 1 == tl ? (u == ul ? 0.0 : kNegD) : nxt[u];
        const acc_t b_right = u + 1 < u1 ? nxt[u + 1] : kNegD;
        const acc_t lb = (acc_t)bl[i], le = (acc_t)em[i], a = al[(size_t)d * u1 + u];
        v = fmax(lse2r(lb + b_down, le + b_right), kNegD);
        db[i] = (float)(-exp(fmin(a + lb + b_down - ll, 0.0))) * g;
        de[i] = (float)(-exp(fmin(a + le + b_right - ll, 0.0))) * g;
      }
      cur[u] = v;
    }
    __syncthreads();
  }
}

inline int threads(int u1) { return min(1024, ((u1 + 31) / 32) * 32); }
inline size_t smem(int u1) { return 2 * (size_t)u1 * sizeof(acc_t); }

}  // namespace rnnt_block

// f(std::integral_constant<int, J>) for the warp route's J = ceil(U1 / 32).
template <class F>
int rnnt_by_lanes(int u1, F&& f) {
  switch ((u1 + 31) / 32) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return (int)cudaErrorInvalidValue;
  }
}
static_assert(rnnt_warp::kMaxJ == 8, "rnnt_by_lanes covers every J");

inline bool rnnt_args_ok(int b, int t, int u1) {
  return b > 0 && t > 0 && u1 > 0 && u1 <= rnnt_block::kMaxStates;
}

// The kernel that launches for U1 states, forward (which 0) or backward (1),
// and its threads and dynamic shared bytes.
struct RnntLaunch {
  const void* kernel;
  int threads;
  size_t smem;
};
inline RnntLaunch rnnt_launch(int which, int u1) {
  if (u1 > rnnt_warp::kWarpStates) {
    return {which == 0 ? reinterpret_cast<const void*>(rnnt_block::fwd_kernel)
                       : reinterpret_cast<const void*>(rnnt_block::bwd_kernel),
            rnnt_block::threads(u1), rnnt_block::smem(u1)};
  }
  RnntLaunch l{nullptr, 32, 0};
  rnnt_by_lanes(u1, [&](auto j) {
    constexpr int J = decltype(j)::value;
    l.kernel = which == 0 ? reinterpret_cast<const void*>(rnnt_warp::fwd_kernel<J>)
                          : reinterpret_cast<const void*>(rnnt_warp::bwd_kernel<J>);
    return 0;
  });
  return l;
}

}  // namespace espnet

// blank, emit: f32 [B, T, U1]; tlen, ulen: int32 [B]; loss: f32 [B];
// alpha: f64 [B, T + U1 - 1, U1], diagonal-major (row d of an utterance
// holds its diagonal d; rows past tlen + U1 - 2 left unwritten).
extern "C" int espnet_rnnt_fwd(const float* blank, const float* emit, const int* tlen,
                               const int* ulen, float* loss, double* alpha, int b, int t, int u1,
                               void* stream) {
  using namespace espnet;
  if (!rnnt_args_ok(b, t, u1)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (u1 <= rnnt_warp::kWarpStates) {
    return rnnt_by_lanes(u1, [&](auto j) {
      constexpr int J = decltype(j)::value;
      rnnt_warp::fwd_kernel<J><<<b, 32, 0, st>>>(blank, emit, tlen, ulen, loss, alpha, t, u1);
      return counted("rnnt_warp::fwd_kernel");
    });
  }
  rnnt_block::fwd_kernel<<<b, rnnt_block::threads(u1), rnnt_block::smem(u1), st>>>(
      blank, emit, tlen, ulen, loss, alpha, t, u1);
  return counted("rnnt_block::fwd_kernel");
}

// alpha: the forward's; grad: f32 [B] cotangent of the loss; dblank, demit:
// f32 [B, T, U1] (every entry written).
extern "C" int espnet_rnnt_bwd(const float* blank, const float* emit, const int* tlen,
                               const int* ulen, const double* alpha, const float* grad,
                               float* dblank, float* demit, int b, int t, int u1, void* stream) {
  using namespace espnet;
  if (!rnnt_args_ok(b, t, u1)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (u1 <= rnnt_warp::kWarpStates) {
    return rnnt_by_lanes(u1, [&](auto j) {
      constexpr int J = decltype(j)::value;
      rnnt_warp::bwd_kernel<J><<<b, 32, 0, st>>>(blank, emit, tlen, ulen, alpha, grad, dblank,
                                                 demit, t, u1);
      return counted("rnnt_warp::bwd_kernel");
    });
  }
  rnnt_block::bwd_kernel<<<b, rnnt_block::threads(u1), rnnt_block::smem(u1), st>>>(
      blank, emit, tlen, ulen, alpha, grad, dblank, demit, t, u1);
  return counted("rnnt_block::bwd_kernel");
}

// The warp route's limit on U1 (larger U1 take the block route).
extern "C" int espnet_rnnt_warp_states() { return espnet::rnnt_warp::kWarpStates; }

// info[0..3] <- registers a thread, shared bytes (static and dynamic),
// local (spill) bytes and blocks per SM of the forward (which 0) or backward
// (1) kernel that launches for U1 states. Returns a cudaError_t code.
extern "C" int espnet_rnnt_info(int which, int u1, int* info) {
  using namespace espnet;
  if ((which != 0 && which != 1) || !rnnt_args_ok(1, 1, u1)) return (int)cudaErrorInvalidValue;
  const RnntLaunch l = rnnt_launch(which, u1);
  cudaFuncAttributes attr{};
  if (int err = (int)cudaFuncGetAttributes(&attr, l.kernel)) return err;
  int nb = 0;
  if (int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, l.kernel, l.threads,
                                                                   l.smem)) {
    return err;
  }
  info[0] = attr.numRegs;
  info[1] = (int)(attr.sharedSizeBytes + l.smem);
  info[2] = (int)attr.localSizeBytes;
  info[3] = nb;
  return 0;
}
