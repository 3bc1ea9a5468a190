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
// What bounds it on the H100: at the flagship train step (B = 64, T' = 468,
// S = 129) the work is ~60k states x T' of log-space adds (a few MFLOP) on
// ~16 MB of emissions and ~31 MB of alphas: nothing here is compute, and the
// bytes take ~15 us at 3.35 TB/s. What really bounds it is the recursion's
// latency: T' dependent steps of a row, each as long as one warp takes to
// issue a frame's fp64 work (J lse3's; ~0.7 us a frame at J = 5 on an
// H100). The TPU kernel's padding of B to 8 rows and S to 128 lanes is not
// needed.
//
// Two routes, by S (both stop at each row's own tlen):
//   ctc_warp, S <= kWarpStates (256): one warp per utterance. Lane `lane`
//     holds the states s = lane + 32 j (j < J = ceil(S / 32)) in registers,
//     and a frame's step is J lse3's on them, with alpha[t-1, s-1] and
//     [s-2] (backward: beta at s+1, s+2) handed across lanes by shuffles of
//     the fp64 values: no barrier and no shared-memory round trip on the
//     recursion's chain. States interleaved across lanes, not J contiguous
//     states a lane, because then every global load and store of a row is
//     coalesced (lane + 32 j) and the ring's shared reads are conflict-free
//     with no staging; the price is 2 J shuffles a frame instead of 2, small
//     beside the J lse3's in fp64. The emissions (and, backward, the alpha
//     rows) of the next kRing - 1 frames are in flight in a per-warp
//     cp.async ring in shared memory, so a frame's loads have landed before
//     its step needs them; the alpha rows and demit are stored coalesced,
//     off the chain. One warp a block: at B = 64 every utterance has an SM
//     to itself (its load pipes, its L1 and one scheduler's fp64 units,
//     which a frame's step waits on), and more utterances a block would only
//     share those.
//   ctc_block, kWarpStates < S <= 3072: the first version, kept as the route
//     for long label sequences, whose states do not fit a warp's registers:
//     one block per utterance, one thread per state, the previous row in
//     shared memory (double-buffered, one barrier per frame).
//
// Precision: the recursions run in fp64. At the flagship shape the
// log-likelihoods are ~ -4200, where an fp32 ulp is ~5e-4, and the posterior
// exp(alpha + beta - ll) cancels three such numbers: in fp32 its error was
// 5e-3 of max |ref| on the card (posteriors of a frame summing to 1.001). In
// fp64 the cancellation is exact to ~1e-12; emissions, loss and demit stay
// fp32, and so does the posterior's exp of the (fp64) cancelled sum, which
// is off the recursion's chain. lse3 takes 2 exp and 1 log, the largest
// term's own exp being 1 (ops/kernels/ctc.py:_lse3 is the same form), as
// straight-line fp64 code on small tables, accurate to the result's
// rounding (lse3_n).
#include <type_traits>

#include "common.cuh"
#include "mma_gemm.cuh"

namespace espnet {

using acc_t = double;  // the recursions' type (see "Precision" above)
constexpr acc_t kNegD = -1e30;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ acc_t dmax(acc_t a, acc_t b) { return a > b ? a : b; }

// ---- lse3 in fp64, as straight-line code ------------------------------------
//
// log(e^a + e^b + e^c) = top + log(1 + e^(x - top) + e^(y - top)): top is the
// largest term, whose own exp is 1, and x, y are the other two (a min / max
// network). The library's exp and log1p branch on their range checks, and
// those branches serialised a lane's J states (a first warp version on them
// was slower than the block kernel's 5 warps), so both are written out here
// without branches, on tables in shared memory (the fp64 units and one
// warp's issue slots are what a frame's step waits on, and the tables
// shorten the polynomials), each step over all N values before the next so
// that one warp has N independent operations in flight:
//   exp(d), d <= 0: d floored at -708 (below it exp(d) < 4e-308, which
//     vanishes next to the 1 it is added to); k = rint(32 d / ln 2) by the
//     1.5 * 2^52 shift; r = d - k ln 2 / 32 in two parts (|r| <= 0.011);
//     e^d = 2^(k >> 5) * 2^((k & 31) / 32) * e^r, the middle factor from the
//     table, e^r by its Taylor polynomial of degree 5 (relative error <
//     3e-15), 2^(k >> 5) added to the table entry's exponent bits.
//   log(v), 1 <= v <= 3: v = 2^E m with m in [1, 2) (E = 0 or 1); c the
//     centre of m's 32nd of [1, 2); the exponent's low bit and m's top five
//     mantissa bits index the table, which holds 1 / c and E ln 2 - log(1 /
//     c); r = m * (1 / c) - 1 in one fma (|r| <= 0.016); log v = that
//     entry + log1p(r), log1p(r) by its series to r^7 (error < 5e-16).
// Accurate to the rounding of the result (ops/kernels/ctc.py:_lse3 is the
// same form on torch's exp and log1p). Where x or y is -inf (a skip that is
// not allowed) its term is exp(-708), which 1 + u absorbs.

struct LseTables {
  acc_t pow2[32];  // 2^(i / 32)
  acc_t inv[64];   // 1 / c, c = 1 + ((i & 31) + 0.5) / 32
  acc_t nlog[64];  // E ln 2 - log(inv[i]) (of the rounded reciprocal), E = i < 32
};

// Fills the tables with the calling threads (i = threadIdx.x, step
// blockDim.x); the caller then synchronises them. Index bit 5 is the low bit
// of v's exponent field: 0 for v in [2, 4) (E = 1), 1 for [1, 2).
__device__ __forceinline__ void fill_tables(LseTables& tb) {
  for (int i = threadIdx.x; i < 64; i += blockDim.x) {
    if (i < 32) tb.pow2[i] = exp2(i / 32.0);
    const acc_t inv = 1.0 / (1.0 + ((i & 31) + 0.5) / 32.0);
    tb.inv[i] = inv;
    tb.nlog[i] = (i < 32 ? 0.69314718055994531 : 0.0) - log(inv);
  }
}

template <int N>
__device__ __forceinline__ void lse3_n(const LseTables& tb, const acc_t (&a)[N],
                                       const acc_t (&b)[N], const acc_t (&c)[N],
                                       acc_t (&out)[N]) {
  constexpr acc_t kShift = 6755399441055744.0;  // 1.5 * 2^52
  acc_t top[N], d[2 * N], r[2 * N], p[2 * N];
  int k[2 * N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool ab = a[i] > b[i];
    const acc_t hi = ab ? a[i] : b[i], lo = ab ? b[i] : a[i];
    const bool hc = hi > c[i];
    top[i] = hc ? hi : c[i];
    d[i] = dmax(lo - top[i], -708.0);
    d[N + i] = dmax((hc ? c[i] : hi) - top[i], -708.0);
  }
  // exp of the 2 N differences.
#pragma unroll
  for (int i = 0; i < 2 * N; ++i) {
    const acc_t kd = fma(d[i], 46.166241308446828, kShift);  // 32 / ln 2
    k[i] = __double2loint(kd);  // the low word holds rint(32 d / ln 2)
    const acc_t kf = kd - kShift;
    r[i] = fma(kf, -2.1660849386535119e-02, d[i]);  // ln 2 / 32, high part
    r[i] = fma(kf, -5.9631716539705866e-12, r[i]);  // and low part
  }
#pragma unroll
  for (int i = 0; i < 2 * N; ++i) p[i] = fma(1.0 / 120.0, r[i], 1.0 / 24.0);
#pragma unroll
  for (int i = 0; i < 2 * N; ++i) p[i] = fma(p[i], r[i], 1.0 / 6.0);
#pragma unroll
  for (int i = 0; i < 2 * N; ++i) p[i] = fma(p[i], r[i], 0.5);
#pragma unroll
  for (int i = 0; i < 2 * N; ++i) p[i] = fma(p[i], r[i], 1.0);
#pragma unroll
  for (int i = 0; i < 2 * N; ++i) p[i] = fma(p[i], r[i], 1.0);
#pragma unroll
  for (int i = 0; i < 2 * N; ++i) {
    const acc_t t = tb.pow2[k[i] & 31];
    p[i] *= __hiloint2double(__double2hiint(t) + ((k[i] >> 5) << 20), __double2loint(t));
  }
  // log(1 + the two exps' sum).
  acc_t q[N], lc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const acc_t v = 1.0 + (p[i] + p[N + i]);
    const int hi = __double2hiint(v);
    const int idx = (hi >> 15) & 63;
    const acc_t m = __hiloint2double((hi & 0x000fffff) | 0x3ff00000, __double2loint(v));
    q[i] = fma(m, tb.inv[idx], -1.0);
    lc[i] = tb.nlog[idx];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = fma(1.0 / 7.0, q[i], -1.0 / 6.0);
  constexpr acc_t kLog[] = {1.0 / 5.0, -1.0 / 4.0, 1.0 / 3.0, -0.5, 1.0};
#pragma unroll
  for (int s = 0; s < 5; ++s)
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = fma(r[i], q[i], kLog[s]);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = top[i] + fma(r[i], q[i], lc[i]);
}

__device__ __forceinline__ acc_t lse3(const LseTables& tb, acc_t a, acc_t b, acc_t c) {
  const acc_t x[1] = {a}, y[1] = {b}, z[1] = {c};
  acc_t out[1];
  lse3_n<1>(tb, x, y, z, out);
  return out[0];
}

__device__ __forceinline__ acc_t lse2(acc_t a, acc_t b) {
  const acc_t m = fmax(fmax(a, b), kNegD);
  return m + log(exp(a - m) + exp(b - m));
}

// log-likelihood from the final alpha row (last and, when last > 0, last-1).
__device__ __forceinline__ acc_t final_ll(const acc_t* fin, int l) {
  return lse2(fin[l], l > 0 ? fin[l - 1] : kNegD);
}

// demit from the fp64 posterior exponent alpha + beta - ll.
__device__ __forceinline__ float posterior_grad(acc_t post, float g) {
  return -expf((float)fmin(post, 0.0)) * g;
}

// ---- One warp per utterance (S <= kWarpStates) ------------------------------

namespace ctc_warp {

constexpr int kMaxJ = 8;                 // states a lane
constexpr int kWarpStates = 32 * kMaxJ;  // the route's limit on S
constexpr int kRing = 8;                 // frames a ring holds (kRing - 1 in flight)
static_assert((kRing & (kRing - 1)) == 0, "ring slots by mask");

// x1[j], x2[j] <- x at states s - 1, s - 2 of s = lane + 32 j (NEG below 0):
// each slot's values rotated down one and two lanes, lane 0's s - 1 and
// lanes 0-1's s - 2 from the rotation of slot j - 1 (lanes 31 and 30).
template <int J>
__device__ __forceinline__ void from_below(const acc_t (&x)[J], acc_t (&x1)[J], acc_t (&x2)[J],
                                           int lane) {
  acc_t r1[J], r2[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    r1[j] = __shfl_sync(kFull, x[j], (lane + 31) & 31);
    r2[j] = __shfl_sync(kFull, x[j], (lane + 30) & 31);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int jp = j > 0 ? j - 1 : 0;
    x1[j] = lane >= 1 ? r1[j] : (j > 0 ? r1[jp] : kNegD);
    x2[j] = lane >= 2 ? r2[j] : (j > 0 ? r2[jp] : kNegD);
  }
}

// x1[j], x2[j] <- x at states s + 1, s + 2 of s = lane + 32 j (NEG past the
// last slot). Lane 31's s + 1 and lanes 30-31's s + 2 are lanes 0 and 1 of
// slot j + 1.
template <int J>
__device__ __forceinline__ void from_above(const acc_t (&x)[J], acc_t (&x1)[J], acc_t (&x2)[J],
                                           int lane) {
  acc_t r1[J], r2[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    r1[j] = __shfl_sync(kFull, x[j], (lane + 1) & 31);
    r2[j] = __shfl_sync(kFull, x[j], (lane + 2) & 31);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int jn = j + 1 < J ? j + 1 : j;
    x1[j] = lane <= 30 ? r1[j] : (j + 1 < J ? r1[jn] : kNegD);
    x2[j] = lane <= 29 ? r2[j] : (j + 1 < J ? r2[jn] : kNegD);
  }
}

// The warp's copy of one row (from src, this lane's element first: lane +
// 32 j for j < J) into a ring slot, in flight until a cp.async wait; the
// states past S, and every state when `any` is false, are zero-filled
// without a read of src (`safe`, a mapped address, stands in for it). No
// branch: a lane's J copies are one predicated run.
template <int J, typename T>
__device__ __forceinline__ void fetch_row(T* dst, const T* src, const T* safe,
                                          const bool (&in)[J], bool any) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const bool ok = any && in[j];
    if constexpr (sizeof(T) == 4) {
      mma::cp_async4(dst + 32 * j, ok ? src + 32 * j : safe, ok);
    } else {
      mma::cp_async8(dst + 32 * j, ok ? src + 32 * j : safe, ok);
    }
  }
}

// One warp (block) per batch row; states past S are NEG throughout.
template <int J>
__global__ void __launch_bounds__(32)
    fwd_kernel(const float* __restrict__ emit, const float* __restrict__ skip,
               const int* __restrict__ tlen, const int* __restrict__ last,
               float* __restrict__ loss, acc_t* __restrict__ alpha, int t_max, int s_len) {
  __shared__ float ring[kRing][32 * J];  // emissions of frames t .. t + kRing - 2
  __shared__ LseTables tb;
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  // This lane's element of frame 0 (emit) and of alpha's row 0.
  const float* e = emit + (size_t)b * t_max * s_len + lane;
  acc_t* al = alpha + (size_t)b * t_max * s_len + lane;
  const int n = min(max(tlen[b], 1), t_max);
  fill_tables(tb);

  // State in S (only the last slot has lanes past it); the s-2 -> s skip as
  // an addend: 0 where allowed, -inf where not.
  bool in[J];
  acc_t skip2[J], a[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = lane + 32 * j;
    in[j] = j + 1 < J || s < s_len;
    skip2[j] = in[j] && s >= 2 && skip[(size_t)b * s_len + s] > 0.0f ? 0.0 : -CUDART_INF;
    a[j] = in[j] && s < 2 ? (acc_t)e[32 * j] : kNegD;
    if (in[j]) al[32 * j] = a[j];
  }
  // Frame t's emissions go to slot t % kRing.
#pragma unroll
  for (int i = 1; i < kRing; ++i) {
    fetch_row<J>(ring[i] + lane, e + (size_t)i * s_len, emit, in, i < n);
    mma::cp_async_commit();
  }
  const float* next = e + (size_t)kRing * s_len;  // frame t + kRing - 1
  acc_t* row = al + s_len;                        // alpha's row t
  __syncwarp();                                   // the tables
  for (int t = 1; t < n; ++t, next += s_len, row += s_len) {
    mma::cp_async_wait<kRing - 2>();
    __syncwarp();  // frame t landed for every lane; slot (t - 1) % kRing read
    float et[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float x = ring[t & (kRing - 1)][lane + 32 * j];
      et[j] = in[j] ? x : kNeg;
    }
    fetch_row<J>(ring[(t + kRing - 1) & (kRing - 1)] + lane, next, emit, in,
                 t + kRing - 1 < n);
    mma::cp_async_commit();
    acc_t a1[J], a2[J], v[J];
    from_below(a, a1, a2, lane);
#pragma unroll
    for (int j = 0; j < J; ++j) a2[j] += skip2[j];
    lse3_n<J>(tb, a, a1, a2, v);
#pragma unroll
    for (int j = 0; j < J; ++j) a[j] = dmax(v[j] + (acc_t)et[j], kNegD);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (in[j]) row[32 * j] = a[j];
    }
  }
  // The final row's states last and last - 1, from the lanes that hold them
  // (a max over the lane's states, not a select by slot, which the compiler
  // turns into an indexed load from local memory).
  const int l = min(max(last[b], 0), s_len - 1);
  acc_t fl = -CUDART_INF, fp = -CUDART_INF;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = lane + 32 * j;
    fl = fmax(fl, s == l ? a[j] : -CUDART_INF);
    fp = fmax(fp, s == l - 1 ? a[j] : -CUDART_INF);
  }
  fl = __shfl_sync(kFull, fl, l & 31);
  fp = __shfl_sync(kFull, fp, (l + 31) & 31);
  if (lane == 0) loss[b] = (float)(-lse2(fl, l > 0 ? fp : kNegD));
}

template <int J>
__global__ void __launch_bounds__(32)
    bwd_kernel(const float* __restrict__ emit, const float* __restrict__ skip,
               const int* __restrict__ tlen, const int* __restrict__ last,
               const acc_t* __restrict__ alpha, const float* __restrict__ grad,
               float* __restrict__ demit, int t_max, int s_len) {
  // Step k (frame t = n - 2 - k) reads emit[t + 1] and alpha[t] from slot
  // k % kRing.
  __shared__ float ering[kRing][32 * J];
  __shared__ acc_t aring[kRing][32 * J];
  __shared__ LseTables tb;
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * t_max * s_len;
  float* de = demit + base;
  const int tl = tlen[b];
  const float g = grad[b];
  // Frames the row does not have (t >= tlen), and every frame of a row whose
  // cotangent is 0, get exact zeros.
  const int active = g == 0.0f ? 0 : min(max(tl, 0), t_max);
  for (size_t i = (size_t)active * s_len + lane; i < (size_t)t_max * s_len; i += 32) de[i] = 0.0f;
  if (active == 0) return;
  const int n = active;  // = clamp(tlen, 1, T) here
  const int l = min(max(last[b], 0), s_len - 1);
  fill_tables(tb);
  // ll from the stored final alpha row, in fp64 (not from the fp32 loss).
  const acc_t* fin = alpha + base + (size_t)(n - 1) * s_len;
  const acc_t ll = final_ll(fin, l);

  // State in S (only the last slot has lanes past it); the s -> s+2 skip
  // (the skip of state s + 2) as an addend: 0 where allowed, -inf where not.
  bool in[J];
  acc_t skip2[J], beta[J];  // beta: terminal at frame n - 1
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = lane + 32 * j;
    in[j] = j + 1 < J || s < s_len;
    skip2[j] = s + 2 < s_len && skip[(size_t)b * s_len + s + 2] > 0.0f ? 0.0 : -CUDART_INF;
    beta[j] = in[j] && (s == l || s == max(l - 1, 0)) ? 0.0 : kNegD;
    if (in[j]) de[(size_t)(n - 1) * s_len + s] = posterior_grad(fin[s] + beta[j] - ll, g);
  }
  // This lane's elements of emit[n - 1] and alpha[n - 2] (step 0's rows),
  // and of demit's row n - 2.
  const float* en = emit + base + (long)(n - 1) * s_len + lane;
  const acc_t* an = alpha + base + (long)(n - 2) * s_len + lane;
  float* row = de + (long)(n - 2) * s_len + lane;
  const int steps = n - 1;
#pragma unroll
  for (int k = 0; k < kRing - 1; ++k) {
    fetch_row<J>(ering[k] + lane, en - (long)k * s_len, emit, in, k < steps);
    fetch_row<J>(aring[k] + lane, an - (long)k * s_len, alpha, in, k < steps);
    mma::cp_async_commit();
  }
  en -= (long)(kRing - 1) * s_len;  // step k + kRing - 1's rows
  an -= (long)(kRing - 1) * s_len;
  __syncwarp();  // the tables
  for (int k = 0; k < steps; ++k, en -= s_len, an -= s_len, row -= s_len) {
    mma::cp_async_wait<kRing - 2>();
    __syncwarp();  // step k landed for every lane; slot (k - 1) % kRing read
    acc_t be[J], at[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float x = ering[k & (kRing - 1)][lane + 32 * j];
      const acc_t y = aring[k & (kRing - 1)][lane + 32 * j];
      be[j] = beta[j] + (acc_t)(in[j] ? x : kNeg);
      at[j] = in[j] ? y : kNegD;
    }
    const bool more = k + kRing - 1 < steps;
    fetch_row<J>(ering[(k + kRing - 1) & (kRing - 1)] + lane, en, emit, in, more);
    fetch_row<J>(aring[(k + kRing - 1) & (kRing - 1)] + lane, an, alpha, in, more);
    mma::cp_async_commit();
    acc_t b1[J], b2[J], v[J];
    from_above(be, b1, b2, lane);
#pragma unroll
    for (int j = 0; j < J; ++j) b2[j] += skip2[j];
    lse3_n<J>(tb, be, b1, b2, v);
#pragma unroll
    for (int j = 0; j < J; ++j) beta[j] = dmax(v[j], kNegD);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (in[j]) row[32 * j] = posterior_grad(at[j] + beta[j] - ll, g);
    }
  }
}

}  // namespace ctc_warp

// ---- One block per utterance (kWarpStates < S <= 3072) ----------------------

namespace ctc_block {

constexpr int kMaxStates = 3072;

// One block per batch row; dynamic shared memory: 2 * S acc_t.
__global__ void fwd_kernel(const float* __restrict__ emit, const float* __restrict__ skip,
                           const int* __restrict__ tlen, const int* __restrict__ last,
                           float* __restrict__ loss, acc_t* __restrict__ alpha, int t_max,
                           int s_len) {
  extern __shared__ acc_t buf[];  // [2][S]
  __shared__ LseTables tb;
  const int b = blockIdx.x;
  const float* e = emit + (size_t)b * t_max * s_len;
  const float* sk = skip + (size_t)b * s_len;
  acc_t* al = alpha + (size_t)b * t_max * s_len;
  const int n = min(max(tlen[b], 1), t_max);
  fill_tables(tb);

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
      const acc_t v = fmax(lse3(tb, a0, a1, a2) + (acc_t)et[s], kNegD);
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
__global__ void bwd_kernel(const float* __restrict__ emit, const float* __restrict__ skip,
                           const int* __restrict__ tlen, const int* __restrict__ last,
                           const acc_t* __restrict__ alpha, const float* __restrict__ grad,
                           float* __restrict__ demit, int t_max, int s_len) {
  extern __shared__ acc_t buf[];  // [2][S]
  __shared__ LseTables tb;
  const int b = blockIdx.x;
  const float* e = emit + (size_t)b * t_max * s_len;
  const float* sk = skip + (size_t)b * s_len;
  const acc_t* al = alpha + (size_t)b * t_max * s_len;
  float* de = demit + (size_t)b * t_max * s_len;
  const int tl = tlen[b];
  const int n = min(max(tl, 1), t_max);
  const float g = grad[b];
  const int l = min(max(last[b], 0), s_len - 1);
  const acc_t ll = final_ll(al + (size_t)(n - 1) * s_len, l);

  const int active = g == 0.0f ? 0 : min(max(tl, 0), t_max);
  for (size_t i = (size_t)active * s_len + threadIdx.x; i < (size_t)t_max * s_len;
       i += blockDim.x) {
    de[i] = 0.0f;
  }
  if (active == 0) return;
  fill_tables(tb);

  // Terminal beta at frame n - 1 (the frozen alpha past tlen is alpha[n-1]).
  for (int s = threadIdx.x; s < s_len; s += blockDim.x) {
    const acc_t bt = (s == l || s == max(l - 1, 0)) ? 0.0 : kNegD;
    buf[((n - 1) & 1) * s_len + s] = bt;
    if (n - 1 < active) {
      de[(size_t)(n - 1) * s_len + s] =
          posterior_grad(al[(size_t)(n - 1) * s_len + s] + bt - ll, g);
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
      const acc_t v = fmax(lse3(tb, b0, b1, b2), kNegD);
      cur[s] = v;
      de[(size_t)t * s_len + s] = posterior_grad(al[(size_t)t * s_len + s] + v - ll, g);
    }
    __syncthreads();
  }
}

inline int threads(int s_len) { return min(1024, ((s_len + 31) / 32) * 32); }
inline size_t smem(int s_len) { return 2 * (size_t)s_len * sizeof(acc_t); }

// Lets both kernels take the dynamic shared memory of kMaxStates states
// (48 KB, which with the static tables passes the default limit), once.
inline void configure() {
  static const bool done = [] {
    const int bytes = (int)smem(kMaxStates);
    cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    cudaFuncSetAttribute(bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    return true;
  }();
  (void)done;
}

}  // namespace ctc_block

// f(std::integral_constant<int, J>) for the warp route's J = ceil(S / 32).
template <class F>
int by_lanes(int s_len, F&& f) {
  switch ((s_len + 31) / 32) {
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
static_assert(ctc_warp::kMaxJ == 8, "by_lanes covers every J");

inline bool ctc_args_ok(int b, int t, int s) {
  return b > 0 && t > 0 && s > 0 && s <= ctc_block::kMaxStates;
}

// The kernel that launches for S states: forward (which 0) or backward (1).
inline const void* ctc_kernel(int which, int s_len) {
  if (s_len > ctc_warp::kWarpStates) {
    return which == 0 ? reinterpret_cast<const void*>(ctc_block::fwd_kernel)
                      : reinterpret_cast<const void*>(ctc_block::bwd_kernel);
  }
  const void* k = nullptr;
  by_lanes(s_len, [&](auto j) {
    constexpr int J = decltype(j)::value;
    k = which == 0 ? reinterpret_cast<const void*>(ctc_warp::fwd_kernel<J>)
                   : reinterpret_cast<const void*>(ctc_warp::bwd_kernel<J>);
    return 0;
  });
  return k;
}

}  // namespace espnet

// emit: f32 [B, T, S]; skip: f32 [B, S]; tlen, last: int32 [B];
// loss: f32 [B]; alpha: f64 [B, T, S] (rows past tlen left unwritten).
extern "C" int espnet_ctc_fwd(const float* emit, const float* skip, const int* tlen,
                              const int* last, float* loss, double* alpha, int b, int t, int s,
                              void* stream) {
  using namespace espnet;
  if (!ctc_args_ok(b, t, s)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (s <= ctc_warp::kWarpStates) {
    return by_lanes(s, [&](auto j) {
      constexpr int J = decltype(j)::value;
      ctc_warp::fwd_kernel<J><<<b, 32, 0, st>>>(emit, skip, tlen, last, loss, alpha, t, s);
      return counted("ctc_warp::fwd_kernel");
    });
  }
  ctc_block::configure();
  ctc_block::fwd_kernel<<<b, ctc_block::threads(s), ctc_block::smem(s), st>>>(
      emit, skip, tlen, last, loss, alpha, t, s);
  return counted("ctc_block::fwd_kernel");
}

// alpha: the forward's; grad: f32 [B] cotangent of loss; demit: f32
// [B, T, S] (every entry written).
extern "C" int espnet_ctc_bwd(const float* emit, const float* skip, const int* tlen,
                              const int* last, const double* alpha, const float* grad,
                              float* demit, int b, int t, int s, void* stream) {
  using namespace espnet;
  if (!ctc_args_ok(b, t, s)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (s <= ctc_warp::kWarpStates) {
    return by_lanes(s, [&](auto j) {
      constexpr int J = decltype(j)::value;
      ctc_warp::bwd_kernel<J><<<b, 32, 0, st>>>(emit, skip, tlen, last, alpha, grad, demit, t, s);
      return counted("ctc_warp::bwd_kernel");
    });
  }
  ctc_block::configure();
  ctc_block::bwd_kernel<<<b, ctc_block::threads(s), ctc_block::smem(s), st>>>(
      emit, skip, tlen, last, alpha, grad, demit, t, s);
  return counted("ctc_block::bwd_kernel");
}

// The warp route's limit on S (larger S take the block route).
extern "C" int espnet_ctc_warp_states() { return espnet::ctc_warp::kWarpStates; }

// info[0..3] <- registers a thread, shared bytes (static and dynamic),
// local (spill) bytes and blocks per SM of the forward (which 0) or backward
// (1) kernel that launches for S states. Returns a cudaError_t code.
extern "C" int espnet_ctc_info(int which, int s, int* info) {
  using namespace espnet;
  if ((which != 0 && which != 1) || !ctc_args_ok(1, 1, s)) return (int)cudaErrorInvalidValue;
  const void* k = ctc_kernel(which, s);
  const bool block = s > ctc_warp::kWarpStates;
  if (block) ctc_block::configure();
  const int threads = block ? ctc_block::threads(s) : 32;
  const size_t dyn = block ? ctc_block::smem(s) : 0;
  cudaFuncAttributes attr{};
  if (int err = (int)cudaFuncGetAttributes(&attr, k)) return err;
  int nb = 0;
  if (int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, k, threads, dyn)) {
    return err;
  }
  info[0] = attr.numRegs;
  info[1] = (int)(attr.sharedSizeBytes + dyn);
  info[2] = (int)attr.localSizeBytes;
  info[3] = nb;
  return 0;
}

// Every host-side launch count (common.cuh:counted) as "name\tcount\n"
// lines into buf (cap bytes, NUL-terminated when it fits), one for each
// kernel instance launched so far. Returns the length the whole list needs,
// without its NUL.
extern "C" int espnet_launch_names(char* buf, int cap) {
  using namespace espnet;
  std::string out;
  {
    std::lock_guard<std::mutex> lock(launch_mutex());
    for (const auto& kv : launch_counts()) {
      out += kv.first + '\t' + std::to_string(kv.second) + '\n';
    }
  }
  if ((long)out.size() < (long)cap) {
    for (size_t i = 0; i <= out.size(); ++i) buf[i] = out.c_str()[i];
  }
  return (int)out.size();
}
