// Relative-position flash attention, forward and backward (the backward's
// notes are at its kernels below). Forward:
//   s[i, j] = ((q_u[i] . k[j]) + (q_v[i] . p[(T-1) - i + j])) * scale, masked
//   out[i]  = softmax_j(s[i, :]) . v,   lse[i] = logsumexp_j s[i, :]
// with the key-length mask and the streaming chunk / left-chunk mask built in
// the kernel.
//
// Replaces the TPU kernel espnet_slurp_tpu/ops/pallas/flash_attention.py:
// rel_flash_attention (_fwd_kernel, _dkv_kernel, _dq_kernel), which runs the
// self-attention of every Conformer block.
//
// What bounds it on the H100: at the flagship train shape (B = 64, H = 4,
// T' = 468, Dh = 64, bf16) the three products (q_u k^T, the skewed q_v p^T,
// P v) over the (query, key) pairs are ~21 GFLOP against ~78 MB of
// compulsory traffic (q_u, q_v, k, v, p, out, lse): ~280 FLOP per byte, at
// the ridge, so a fast kernel is bounded about equally by memory and by the
// tensor cores (0.022-0.023 ms). The plain composition writes [B, H, T, T]
// scores and probabilities and a [B, H, T, 2T-1] position score matrix,
// which is what the TPU kernel was written to avoid.
//
// Three forward kernels. In bf16 at Dh 32 and 64 (both main-path models)
// the forward is rel_fwd::fwd_kernel below: registers for q, S, P and O,
// one fp32 shared trip a warp for the skewed slice, cp.async rings; in
// fp32 at Dh 32, 64 and 128 (the default ASRConfig) it is
// rel_f32::fwd_kernel below, register micro-tiles of fp32 FMAs; their
// notes say what limits them and what their designs do about that. Every
// other case (bf16 or fp32 at another Dh) takes rel_flash_fwd_kernel here,
// the first version:
//
// one block owns BQ query rows of one (batch, head) and streams key
// tiles of BK rows with an online softmax (running max m, sum l, fp32 output
// accumulator in shared memory). The rel-shift never materialises: for a
// (query tile i0, key tile j0) pair, the position rows it needs are the one
// contiguous slab p[c0 : c0 + BQ + BK) with c0 = T - BQ - i0 + j0. The block
// multiplies q_v by that slab into a [BQ, BQ + BK] fp32 tile in shared memory
// and reads bd[i, j] from it at column (BQ - 1) - i + j. Slab rows outside
// [0, 2T) and key/query rows at or past T are zero-filled; key columns at or
// past T are dropped from the softmax, so any T works. No [T, T] or
// [T, 2T - 1] buffer reaches global memory. WMMA tiles staged through shared
// memory, no pipelining.
//
// Dropout on the probabilities (the reference's _dropout_keep) is drawn in
// every launch, from philox.cuh with (b * H + h, query, key) as the
// element's coordinates: the bf16 kernels at Dh 32 / 64 (rel_fwd, rel_dkv,
// rel_dq) per lane with keep8, the fp32 ones (rel_f32) and the WMMA ones
// (DROP) into a BQ x BK byte tile in shared memory per (query tile, key
// tile) pair with fill_keep_tile. Each kernel has a rate-0 instantiation
// without the draw.
#include "common.cuh"
#include "mma_gemm.cuh"
#include "philox.cuh"

namespace espnet {

// drop: a BQ x BK keep tile (bytes) at the end.
struct FlashLayout {
  size_t qus, qvs, ks, vs, slab, raw, sc, ps, o, m, l, alpha, keep, total;
  __host__ __device__ FlashLayout(int dh, int bq, int bk, int esize, bool drop) {
    const int p = 16 / esize;
    const size_t row = (size_t)(dh + p) * esize;
    qus = 0;
    qvs = align128(qus + bq * row);
    ks = align128(qvs + bq * row);
    vs = align128(ks + bk * row);
    slab = align128(vs + bk * row);
    raw = align128(slab + (bq + bk) * row);
    sc = align128(raw + (size_t)bq * (bq + bk + 4) * 4);
    ps = align128(sc + (size_t)bq * (bk + 4) * 4);
    o = align128(ps + (size_t)bq * (bk + p) * esize);
    m = align128(o + (size_t)bq * (dh + 4) * 4);
    l = align128(m + (size_t)bq * 4);
    alpha = align128(l + (size_t)bq * 4);
    keep = align128(alpha + (size_t)bq * 4);
    total = align128(keep + (drop ? (size_t)bq * bk : 0));
  }
};

// DROP: P is dropped (kept entries scaled by 1 / (1 - rate), the others 0)
// before it multiplies v, after its undropped value went into l, so lse
// stays the undropped one, as in rel_fwd::fwd_kernel and the reference.
template <typename T, int BQ, int BK, bool DROP>
__global__ void __launch_bounds__(kThreads)
    rel_flash_fwd_kernel(const T* __restrict__ qu, const T* __restrict__ qv,
                         const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ p, const int* __restrict__ lengths,
                         T* __restrict__ out, float* __restrict__ lse, int h, int t, int dh,
                         float scale, int chunk_size, int left_chunks, philox::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  const FlashLayout L(dh, BQ, BK, sizeof(T), DROP);
  T* qus = reinterpret_cast<T*>(smem + L.qus);
  T* qvs = reinterpret_cast<T*>(smem + L.qvs);
  T* ks = reinterpret_cast<T*>(smem + L.ks);
  T* vs = reinterpret_cast<T*>(smem + L.vs);
  T* slab = reinterpret_cast<T*>(smem + L.slab);
  float* raw = reinterpret_cast<float*>(smem + L.raw);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  T* ps = reinterpret_cast<T*>(smem + L.ps);
  float* o = reinterpret_cast<float*>(smem + L.o);
  float* m = reinterpret_cast<float*>(smem + L.m);
  float* l = reinterpret_cast<float*>(smem + L.l);
  float* alpha = reinterpret_cast<float*>(smem + L.alpha);
  unsigned char* keep = smem + L.keep;  // [BQ][BK], DROP only
  const int ld = dh + P, ldraw = BQ + BK + 4, ldsc = BK + 4, ldps = BK + P, ldo = dh + 4;

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int i0 = blockIdx.x * BQ;
  const int klen = lengths[b];
  const long base = (long)bh * t * dh;
  const T* pb = p + (long)hh * 2 * t * dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  const uint32_t seed = DROP ? (uint32_t)__ldg(drop.seed) : 0u;

  load_rows(qus, ld, qu + base, dh, i0, BQ, dh, 0, t);
  load_rows(qvs, ld, qv + base, dh, i0, BQ, dh, 0, t);
  for (int idx = threadIdx.x; idx < BQ * dh; idx += blockDim.x) {
    o[(idx / dh) * ldo + idx % dh] = 0.0f;
  }
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    m[r] = kNeg;
    l[r] = 0.0f;
  }

  const int nk = (t + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int j0 = kt * BK;
    load_rows(ks, ld, k + base, dh, j0, BK, dh, 0, t);
    load_rows(vs, ld, v + base, dh, j0, BK, dh, 0, t);
    load_rows(slab, ld, pb, dh, (long)t - BQ - i0 + j0, BQ + BK, dh, 0, 2L * t);
    if constexpr (DROP) {
      philox::fill_keep_tile<BQ, BK>(keep, BK, seed, (uint32_t)bh, (uint32_t)i0, (uint32_t)j0,
                                     drop.thr);
    }
    __syncthreads();
    smem_gemm<true>(qus, ld, ks, ld, sc, ldsc, BQ, BK, dh, false);
    smem_gemm<true>(qvs, ld, slab, ld, raw, ldraw, BQ, BQ + BK, dh, false);

    // Scores, masks and the online-softmax update: one warp per query row.
    for (int r = warp; r < BQ; r += nwarps) {
      const int i = i0 + r;
      float mt = -CUDART_INF_F;
      for (int c = lane; c < BK; c += 32) {
        const int j = j0 + c;
        float s = -CUDART_INF_F;  // key column past T: not part of the softmax
        if (j < t) {
          s = (sc[r * ldsc + c] + raw[r * ldraw + (BQ - 1 - r + c)]) * scale;
          bool ok = j < klen;
          if (chunk_size > 0) {
            const int cc = j / chunk_size, rc = i / chunk_size;
            ok = ok && cc <= rc;
            if (left_chunks >= 0) ok = ok && cc >= rc - left_chunks;
          }
          if (!ok) s = kNeg;
        }
        sc[r * ldsc + c] = s;
        mt = fmaxf(mt, s);
      }
      mt = warp_max(mt);
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mt);
      float sum = 0.0f;
      for (int c = lane; c < BK; c += 32) {
        const float e = expf(sc[r * ldsc + c] - m_new);
        float pe = e;
        if constexpr (DROP) pe = keep[r * BK + c] ? e * drop.inv : 0.0f;
        ps[r * ldps + c] = from_f32<T>(pe);
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        l[r] = l[r] * a + sum;
        m[r] = m_new;
        alpha[r] = a;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * dh; idx += blockDim.x) {
      const int r = idx / dh;
      o[r * ldo + idx - r * dh] *= alpha[r];
    }
    __syncthreads();
    smem_gemm<false>(ps, ldps, vs, ld, o, ldo, BQ, dh, BK, true);
  }

  for (int idx = threadIdx.x; idx < BQ * dh; idx += blockDim.x) {
    const int r = idx / dh;
    const int c = idx - r * dh;
    const int i = i0 + r;
    if (i < t) {
      out[base + (long)i * dh + c] = from_f32<T>(o[r * ldo + c] / fmaxf(l[r], 1e-30f));
    }
  }
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    const int i = i0 + r;
    if (i < t) lse[(long)bh * t + i] = m[r] + logf(fmaxf(l[r], 1e-30f));
  }
}

// drop.seed null: the rate-0 instantiation.
template <typename T, int BQ, int BK>
int launch_rel_flash(const void* qu, const void* qv, const void* k, const void* v, const void* p,
                     const int* lengths, void* out, float* lse, int b, int h, int t, int dh,
                     float scale, int chunk_size, int left_chunks, const philox::Dropout& drop,
                     cudaStream_t stream) {
  const bool dropping = drop.seed != nullptr;
  const FlashLayout L(dh, BQ, BK, sizeof(T), dropping);
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (L.total > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
  auto kernel =
      dropping ? rel_flash_fwd_kernel<T, BQ, BK, true> : rel_flash_fwd_kernel<T, BQ, BK, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  const dim3 grid((t + BQ - 1) / BQ, b * h);
  kernel<<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(qv), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(p), lengths, static_cast<T*>(out), lse, h,
      t, dh, scale, chunk_size, left_chunks, drop);
  return counted("rel_flash_fwd_kernel", type_name<T>(), BQ, BK, dropping);
}


// ---- Backward -------------------------------------------------------------
//
// Replaces espnet_slurp_tpu/ops/pallas/flash_attention.py:_dkv_kernel and
// _dq_kernel. With P = exp(s - lse) recomputed per tile from the forward's
// lse, dP = dO v^T and delta = rowsum(dO * out) (computed by the wrapper):
//   ds = P (dP - delta) scale   on visible (query, key) pairs, 0 elsewhere
//   dq_u = ds k,  dq_v[i] = sum_j ds[i, j] p[T-1-i+j],  dk = ds^T q_u,
//   dv = P^T dO,  dp[T-1-i+j] += ds[i, j] q_v[i]  (summed over the batch).
// A fully masked query row (no visible key) has lse at NEG; its forward
// weights are uniform over the T keys, so P = 1/T there and ds = 0: the
// gradient the plain version's autograd gives. With dropout (DROP) the
// forward's keep tile is drawn again per pair: dP is masked and scaled
// before ds (ds = P (keep ? dP / (1 - rate) : 0 - delta) scale, with the
// undropped P) and dv takes the dropped P, fully masked rows included, as
// in rel_dkv::dkv_kernel.
// The skewed diagonal is scattered, like the forward gathers it, through the
// slab of BQ + BK position rows a (query tile, key tile) pair touches:
// rawg[r, BQ-1-r+c] = ds[r, c], then dq_v += rawg slab and
// dp[slab rows] += rawg^T q_v. Two kernels, as in the reference: dq (query
// tile outer) and dkv (key tile outer). dp is summed over the batch and the
// query tiles in fp32 into [H, 2T, Dh] with atomic adds (so its last bits
// depend on the order the blocks run in); slab rows outside [0, 2T) are
// dropped. In bf16 at Dh 32 and 64 the dkv launch is rel_dkv::dkv_kernel
// below (register accumulators, cp.async ring, vector reductions) and the
// dq launch rel_dq::dq_kernel (the forward's query-tile loop, registers for
// q, dO, S, dP and dq); in fp32 at Dh 32, 64 and 128 they are
// rel_f32::dkv_kernel and dq_kernel; the WMMA kernels here serve every
// other Dh.

struct FlashBwdLayout {
  size_t qu, qv, dout, k, v, slab, sc, dpf, raw, t1, t2, t3, acc1, acc2, lse, delta, keep, total;
  __host__ __device__ FlashBwdLayout(int dh, int bq, int bk, int esize, bool dkv, bool drop) {
    const int p = 16 / esize;
    const size_t row = (size_t)(dh + p) * esize;
    const int sw = bq + bk;
    qu = 0;
    qv = align128(qu + bq * row);
    dout = align128(qv + bq * row);
    k = align128(dout + bq * row);
    v = align128(k + bk * row);
    slab = align128(v + bk * row);
    sc = align128(slab + sw * row);
    dpf = align128(sc + (size_t)bq * (bk + 4) * 4);
    raw = align128(dpf + (size_t)bq * (bk + 4) * 4);
    // dkv: raw doubles as the [BQ + BK, Dh] fp32 dp slab once P is formed.
    size_t raw_bytes = (size_t)bq * (sw + 4) * 4;
    if (dkv && (size_t)sw * (dh + 4) * 4 > raw_bytes) raw_bytes = (size_t)sw * (dh + 4) * 4;
    t1 = align128(raw + raw_bytes);
    if (dkv) {  // t1 = P^T, t2 = ds^T [BK, BQ]; t3 = rawg^T [BQ + BK, BQ]
      t2 = align128(t1 + (size_t)bk * (bq + p) * esize);
      t3 = align128(t2 + (size_t)bk * (bq + p) * esize);
      acc1 = align128(t3 + (size_t)sw * (bq + p) * esize);
      acc2 = align128(acc1 + (size_t)bk * (dh + 4) * 4);  // dk, dv
      lse = align128(acc2 + (size_t)bk * (dh + 4) * 4);
    } else {  // t1 = ds [BQ, BK]; t2 = rawg [BQ, BQ + BK]
      t2 = align128(t1 + (size_t)bq * (bk + p) * esize);
      t3 = align128(t2 + (size_t)bq * (sw + p) * esize);
      acc1 = t3;
      acc2 = align128(acc1 + (size_t)bq * (dh + 4) * 4);  // dq_u, dq_v
      lse = align128(acc2 + (size_t)bq * (dh + 4) * 4);
    }
    delta = align128(lse + (size_t)bq * 4);
    keep = align128(delta + (size_t)bq * 4);  // [BQ][BK] bytes, drop only
    total = align128(keep + (drop ? (size_t)bq * bk : 0));
  }
};

// P and ds of one (query tile i0, key tile j0) pair, from sc = q_u k^T,
// raw = q_v slab^T and dpf = dO v^T (all [BQ, *] fp32 in shared memory).
struct PairScores {
  int t, i0, j0, klen, chunk_size, left_chunks;
  float scale;
  // Key j is visible to query i (both < t): the key-length and chunk masks.
  __device__ __forceinline__ bool visible(int i, int j) const {
    bool ok = j < klen;
    if (chunk_size > 0) {
      const int cc = j / chunk_size, rc = i / chunk_size;
      ok = ok && cc <= rc;
      if (left_chunks >= 0) ok = ok && cc >= rc - left_chunks;
    }
    return ok;
  }
  // DROP: `on` is the element's keep bit and inv = 1 / (1 - rate); p_out
  // is then the dropped P (dv's operand), ds the undropped P times the
  // dropped dP's difference.
  template <int BQ, bool DROP>
  __device__ __forceinline__ void at(const float* sc, int ldsc, const float* raw, int ldraw,
                                     const float* dpf, const float* lse, const float* delta,
                                     int r, int c, bool on, float inv, float* p_out,
                                     float* ds_out) const {
    const int i = i0 + r, j = j0 + c;
    float pv = 0.0f, ds = 0.0f;
    if (i < t && j < t) {
      const float l = lse[r];
      if (l < 0.5f * kNeg) {
        pv = 1.0f / (float)t;  // fully masked row: uniform weights, no ds
      } else if (visible(i, j)) {
        const float s = (sc[r * ldsc + c] + raw[r * ldraw + (BQ - 1 - r + c)]) * scale;
        float dpv = dpf[r * ldsc + c];
        if constexpr (DROP) dpv = on ? dpv * inv : 0.0f;
        pv = expf(s - l);
        ds = pv * (dpv - delta[r]) * scale;
      }
      if constexpr (DROP) pv = on ? pv * inv : 0.0f;  // dv takes the dropped P
    }
    *p_out = pv;
    *ds_out = ds;
  }
};

template <typename T, int BQ, int BK, bool DROP>
__global__ void __launch_bounds__(kThreads)
    rel_flash_dq_kernel(const T* __restrict__ qu, const T* __restrict__ qv,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ p, const int* __restrict__ lengths,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dqu,
                        T* __restrict__ dqv, int h, int t, int dh, float scale, int chunk_size,
                        int left_chunks, philox::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  constexpr int SW = BQ + BK;
  const FlashBwdLayout L(dh, BQ, BK, sizeof(T), false, DROP);
  T* qus = reinterpret_cast<T*>(smem + L.qu);
  T* qvs = reinterpret_cast<T*>(smem + L.qv);
  T* dos = reinterpret_cast<T*>(smem + L.dout);
  T* ks = reinterpret_cast<T*>(smem + L.k);
  T* vs = reinterpret_cast<T*>(smem + L.v);
  T* slab = reinterpret_cast<T*>(smem + L.slab);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* dpf = reinterpret_cast<float*>(smem + L.dpf);
  float* raw = reinterpret_cast<float*>(smem + L.raw);
  T* dsb = reinterpret_cast<T*>(smem + L.t1);
  T* rawg = reinterpret_cast<T*>(smem + L.t2);
  float* acc_u = reinterpret_cast<float*>(smem + L.acc1);
  float* acc_v = reinterpret_cast<float*>(smem + L.acc2);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);
  unsigned char* keep = smem + L.keep;  // [BQ][BK], DROP only
  const uint32_t seed = DROP ? (uint32_t)__ldg(drop.seed) : 0u;
  const int ld = dh + P, ldsc = BK + 4, ldraw = SW + 4, ldds = BK + P, ldrg = SW + P,
            ldacc = dh + 4;

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int i0 = blockIdx.x * BQ;
  const long base = (long)bh * t * dh;
  const T* pb = p + (long)hh * 2 * t * dh;
  const PairScores ps{t, i0, 0, lengths[b], chunk_size, left_chunks, scale};

  load_rows(qus, ld, qu + base, dh, i0, BQ, dh, 0, t);
  load_rows(qvs, ld, qv + base, dh, i0, BQ, dh, 0, t);
  load_rows(dos, ld, dout + base, dh, i0, BQ, dh, 0, t);
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    const bool in = i0 + r < t;
    lse_s[r] = in ? lse[(long)bh * t + i0 + r] : 0.0f;
    delta_s[r] = in ? delta[(long)bh * t + i0 + r] : 0.0f;
  }
  const int nk = (t + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int j0 = kt * BK;
    PairScores pair = ps;
    pair.j0 = j0;
    load_rows(ks, ld, k + base, dh, j0, BK, dh, 0, t);
    load_rows(vs, ld, v + base, dh, j0, BK, dh, 0, t);
    load_rows(slab, ld, pb, dh, (long)t - BQ - i0 + j0, SW, dh, 0, 2L * t);
    if constexpr (DROP) {
      philox::fill_keep_tile<BQ, BK>(keep, BK, seed, (uint32_t)bh, (uint32_t)i0, (uint32_t)j0,
                                     drop.thr);
    }
    __syncthreads();
    smem_gemm<true>(qus, ld, ks, ld, sc, ldsc, BQ, BK, dh, false);
    smem_gemm<true>(qvs, ld, slab, ld, raw, ldraw, BQ, SW, dh, false);
    smem_gemm<true>(dos, ld, vs, ld, dpf, ldsc, BQ, BK, dh, false);
    // Every rawg entry once: column col of row r holds ds[r, c] with
    // c = col - (BQ - 1 - r) when 0 <= c < BK, and 0 elsewhere.
    for (int idx = threadIdx.x; idx < BQ * SW; idx += blockDim.x) {
      const int r = idx / SW;
      const int col = idx - r * SW;
      const int c = col - (BQ - 1 - r);
      float ds = 0.0f;
      if (c >= 0 && c < BK) {
        float pv;
        pair.at<BQ, DROP>(sc, ldsc, raw, ldraw, dpf, lse_s, delta_s, r, c,
                          DROP && keep[r * BK + c], drop.inv, &pv, &ds);
        dsb[r * ldds + c] = from_f32<T>(ds);
      }
      rawg[r * ldrg + col] = from_f32<T>(ds);
    }
    __syncthreads();
    smem_gemm<false>(dsb, ldds, ks, ld, acc_u, ldacc, BQ, dh, BK, kt > 0);
    smem_gemm<false>(rawg, ldrg, slab, ld, acc_v, ldacc, BQ, dh, SW, kt > 0);
  }
  for (int idx = threadIdx.x; idx < BQ * dh; idx += blockDim.x) {
    const int r = idx / dh;
    const int c = idx - r * dh;
    if (i0 + r < t) {
      dqu[base + (long)(i0 + r) * dh + c] = from_f32<T>(acc_u[r * ldacc + c]);
      dqv[base + (long)(i0 + r) * dh + c] = from_f32<T>(acc_v[r * ldacc + c]);
    }
  }
}

template <typename T, int BQ, int BK, bool DROP>
__global__ void __launch_bounds__(kThreads)
    rel_flash_dkv_kernel(const T* __restrict__ qu, const T* __restrict__ qv,
                         const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ p, const int* __restrict__ lengths,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, float* __restrict__ dp, int h, int t, int dh,
                         float scale, int chunk_size, int left_chunks, philox::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  constexpr int SW = BQ + BK;
  const FlashBwdLayout L(dh, BQ, BK, sizeof(T), true, DROP);
  T* qus = reinterpret_cast<T*>(smem + L.qu);
  T* qvs = reinterpret_cast<T*>(smem + L.qv);
  T* dos = reinterpret_cast<T*>(smem + L.dout);
  T* ks = reinterpret_cast<T*>(smem + L.k);
  T* vs = reinterpret_cast<T*>(smem + L.v);
  T* slab = reinterpret_cast<T*>(smem + L.slab);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* dpf = reinterpret_cast<float*>(smem + L.dpf);
  float* raw = reinterpret_cast<float*>(smem + L.raw);
  float* dslab = raw;
  T* pt = reinterpret_cast<T*>(smem + L.t1);
  T* dst = reinterpret_cast<T*>(smem + L.t2);
  T* rawgt = reinterpret_cast<T*>(smem + L.t3);
  float* acc_k = reinterpret_cast<float*>(smem + L.acc1);
  float* acc_v = reinterpret_cast<float*>(smem + L.acc2);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);
  unsigned char* keep = smem + L.keep;  // [BQ][BK], DROP only
  const uint32_t seed = DROP ? (uint32_t)__ldg(drop.seed) : 0u;
  const int ld = dh + P, ldsc = BK + 4, ldraw = SW + 4, ldt = BQ + P, ldacc = dh + 4,
            ldslab = dh + 4;

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int j0 = blockIdx.x * BK;
  const long base = (long)bh * t * dh;
  const T* pb = p + (long)hh * 2 * t * dh;
  float* dpb = dp + (long)hh * 2 * t * dh;
  PairScores pair{t, 0, j0, lengths[b], chunk_size, left_chunks, scale};

  load_rows(ks, ld, k + base, dh, j0, BK, dh, 0, t);
  load_rows(vs, ld, v + base, dh, j0, BK, dh, 0, t);
  const int nq = (t + BQ - 1) / BQ;
  for (int qt = 0; qt < nq; ++qt) {
    const int i0 = qt * BQ;
    const long c0 = (long)t - BQ - i0 + j0;
    pair.i0 = i0;
    load_rows(qus, ld, qu + base, dh, i0, BQ, dh, 0, t);
    load_rows(qvs, ld, qv + base, dh, i0, BQ, dh, 0, t);
    load_rows(dos, ld, dout + base, dh, i0, BQ, dh, 0, t);
    load_rows(slab, ld, pb, dh, c0, SW, dh, 0, 2L * t);
    for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
      const bool in = i0 + r < t;
      lse_s[r] = in ? lse[(long)bh * t + i0 + r] : 0.0f;
      delta_s[r] = in ? delta[(long)bh * t + i0 + r] : 0.0f;
    }
    if constexpr (DROP) {
      philox::fill_keep_tile<BQ, BK>(keep, BK, seed, (uint32_t)bh, (uint32_t)i0, (uint32_t)j0,
                                     drop.thr);
    }
    __syncthreads();
    smem_gemm<true>(qus, ld, ks, ld, sc, ldsc, BQ, BK, dh, false);
    smem_gemm<true>(qvs, ld, slab, ld, raw, ldraw, BQ, SW, dh, false);
    smem_gemm<true>(dos, ld, vs, ld, dpf, ldsc, BQ, BK, dh, false);
    // P^T, ds^T and rawg^T, every entry once (c = col - (BQ - 1 - r)).
    for (int idx = threadIdx.x; idx < SW * BQ; idx += blockDim.x) {
      const int col = idx / BQ;
      const int r = idx - col * BQ;
      const int c = col - (BQ - 1 - r);
      float ds = 0.0f;
      if (c >= 0 && c < BK) {
        float pv;
        pair.at<BQ, DROP>(sc, ldsc, raw, ldraw, dpf, lse_s, delta_s, r, c,
                          DROP && keep[r * BK + c], drop.inv, &pv, &ds);
        pt[c * ldt + r] = from_f32<T>(pv);
        dst[c * ldt + r] = from_f32<T>(ds);
      }
      rawgt[col * ldt + r] = from_f32<T>(ds);
    }
    __syncthreads();
    smem_gemm<false>(pt, ldt, dos, ld, acc_v, ldacc, BK, dh, BQ, qt > 0);
    smem_gemm<false>(dst, ldt, qus, ld, acc_k, ldacc, BK, dh, BQ, qt > 0);
    smem_gemm<false>(rawgt, ldt, qvs, ld, dslab, ldslab, SW, dh, BQ, false);
    for (int idx = threadIdx.x; idx < SW * dh; idx += blockDim.x) {
      const int rr = idx / dh;
      const int c = idx - rr * dh;
      const long prow = c0 + rr;
      if (prow >= 0 && prow < 2L * t) {
        const float val = dslab[rr * ldslab + c];
        if (val != 0.0f) atomicAdd(&dpb[prow * dh + c], val);
      }
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < BK * dh; idx += blockDim.x) {
    const int r = idx / dh;
    const int c = idx - r * dh;
    if (j0 + r < t) {
      dk[base + (long)(j0 + r) * dh + c] = from_f32<T>(acc_k[r * ldacc + c]);
      dv[base + (long)(j0 + r) * dh + c] = from_f32<T>(acc_v[r * ldacc + c]);
    }
  }
}

// ---- dkv in bf16 at Dh 32 and 64: register accumulators ----------------
//
// Replaces _dkv_kernel (espnet_slurp_tpu/ops/pallas/flash_attention.py:178)
// in bf16 where Dh is 32 or 64 (both main-path models use 64); every other
// case takes rel_flash_dkv_kernel above. It computes what that kernel
// computes, with the same rounding points (P, ds and rawg rounded to bf16
// before the products that take them, fp32 accumulation).
//
// Bound (flagship train shape, B 64, H 4, T' 468, Dh 64, ragged lengths):
// the compulsory traffic (q_u, q_v, dO, k, v, p, lse, delta in; dk, dv, dp
// out) is ~110 MB, 0.033 ms at 3.35 TB/s; the six products over the
// visible (query, key) pairs are ~34 GFLOP, 0.035 ms at 989 TFLOP/s, so it
// sits at the ridge. The tiles it forms hold ~56 GFLOP (masked pairs and
// the unused part of the skewed product included); its first limits are
// the shared-memory operand traffic of mma.sync and the dp reduction.
//
// Design. One block (8 warps) owns one (b, h) and one key tile of BK = 64
// rows and walks the query tiles of BQ = 32 rows:
//   - k and v are loaded once; dk and dv ([BK, Dh] fp32 each) live in
//     registers (warp tile 16 x Dh/2) for the whole loop and are written
//     once, in bf16.
//   - A 2-stage ring: while tile qt is computed, cp.async fetches q_u, q_v
//     and dO [BQ, Dh], the position slab p[c0 - BQ : c0 + BK) of tile qt + 1
//     (rows outside [0, 2T) zero-filled with a source size of 0) and lse
//     and delta.
//   - S = q_u k^T and dP = dO v^T stay in registers (warp tile 16 x 16).
//     raw = q_v slab^T [BQ, BQ + BK] goes through the tensor cores and once
//     to shared fp32, because the skewed read raw[r, BQ-1-r+c] crosses
//     lanes. P and ds are formed at the S fragments' (row, column) with
//     the masks (PairScores::visible), scale and fully-masked-row rule of
//     PairScores::at, and written
//     to shared memory as bf16 [BQ, BK]; ds also into the skewed bf16 rawg
//     [BQ, BQ + BK], whose off-band zeros are written once per block.
//   - dv += P^T dO and dk += ds^T q_u read both operands through
//     ldmatrix.trans (no transposing pass); dslab = rawg^T q_v [BQ + BK, Dh]
//     accumulates in registers.
//   - dp: slab rows [c0 + BK, c0 + BQ + BK) are final after tile qt, since
//     the next tile's slab is [c0 - BQ, c0 + BK). Each warp owns the m16
//     tiles {w / 4, w / 4 + 2, w / 4 + 4} of dslab, so the BQ = 32-row shift
//     to the next tile moves an accumulator from one slot of the thread to
//     the next: the kernel flushes the final slot and carries the other two
//     (all rows are flushed after the last tile); flushing every row after
//     every tile triples the reductions and timed slower. A flush is one
//     red.global.add.v4.f32 per 4 columns (pairs of lanes trade halves with
//     one shuffle), summed over the batch and the key tiles in fp32; rows
//     outside [0, 2T) are dropped.
// Shared memory: k, v, 2 ring stages, raw fp32 [BQ, 104], P, ds and rawg:
// 103,424 bytes at Dh 64 (70,656 at Dh 32), so two blocks share an SM
// (__launch_bounds__(256, 2): at most 128 registers a thread).
// Dropout (DROP, reference :208-222): one Philox call a lane a query tile
// gives the keep bits of its 8 S-fragment elements; dv takes the dropped
// P (keep ? P / (1 - rate) : 0), and dP is masked and scaled the same way
// before ds = P (dP - delta) scale, P itself undropped.
namespace rel_dkv {

using mma::Major;
using mma::cp_async16;
using mma::cp_async4;
using mma::warp_mma_k16;
constexpr int BQ = 32, BK = 64, SW = BQ + BK;

template <int DH>
struct Layout {
  static constexpr int LDQ = DH + 8;    // q_u, q_v, dO, k, v, slab rows (bf16)
  static constexpr int LDR = SW + 8;    // raw fp32: 104 = 8 mod 32 banks
  static constexpr int LDP = BK + 8;    // P, ds (bf16)
  static constexpr int LDG = SW + 8;    // rawg (bf16)
  static constexpr int QU = 0, QV = BQ * LDQ, DO = 2 * BQ * LDQ, SLAB = 3 * BQ * LDQ;
  static constexpr size_t kStageBytes = (size_t)(3 * BQ + SW) * LDQ * 2 + 2 * BQ * 4;
  static constexpr size_t kK = 0, kV = (size_t)BK * LDQ * 2, kRing = 2 * kV,
                          kRaw = kRing + 2 * kStageBytes, kP = kRaw + (size_t)BQ * LDR * 4,
                          kDs = kP + (size_t)BQ * LDP * 2, kRawg = kDs + (size_t)BQ * LDP * 2,
                          kBytes = kRawg + (size_t)BQ * LDG * 2;
  static_assert(kV % 16 == 0 && kStageBytes % 16 == 0 && kP % 16 == 0 && kRawg % 16 == 0,
                "16-byte aligned regions");
};

// rows x DH of global rows [r0, r0 + rows) of g (row length DH) into shared
// s (leading dimension ld) by a block of NTH threads; rows outside [lo, hi)
// are zero-filled.
template <int DH, int NTH = kThreads>
__device__ __forceinline__ void load_rows_async(bf16* s, int ld, const bf16* g, long r0, int rows,
                                                long lo, long hi) {
  constexpr int CH = DH / 8;
  for (int idx = threadIdx.x; idx < rows * CH; idx += NTH) {
    const int r = idx / CH;
    const int c = (idx - r * CH) * 8;
    const long gr = r0 + r;
    const bool ok = gr >= lo && gr < hi;
    cp_async16(s + r * ld + c, ok ? g + gr * DH + c : g, ok);
  }
}

template <int DH, bool DROP>
__global__ void __launch_bounds__(kThreads, 2)
    dkv_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ qv,
               const bf16* __restrict__ k, const bf16* __restrict__ v,
               const bf16* __restrict__ p, const int* __restrict__ lengths,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
               float* __restrict__ dp, int h, int t, float scale, int chunk_size,
               int left_chunks, philox::Dropout drop) {
  using L = Layout<DH>;
  constexpr int NKV = DH / 16;  // n8 tiles of a dk / dv warp tile (16 x DH/2)
  constexpr int NSL = DH / 32;  // n8 tiles of a dslab warp tile (3 m16 tiles x DH/4)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::kV);
  float* raw = reinterpret_cast<float*>(smem + L::kRaw);
  bf16* ps = reinterpret_cast<bf16*>(smem + L::kP);
  bf16* dss = reinterpret_cast<bf16*>(smem + L::kDs);
  bf16* rawg = reinterpret_cast<bf16*>(smem + L::kRawg);

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int j0 = blockIdx.x * BK;
  const long base = (long)bh * t * DH;
  const bf16* pb = p + (long)hh * 2 * t * DH;
  float* dpb = dp + (long)hh * 2 * t * DH;
  const PairScores pair{t, 0, j0, lengths[b], chunk_size, left_chunks, scale};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  // Stage `slot` <- query tile i0 and its slab rows from c0.
  auto load_stage = [&](int slot, int i0, long c0) {
    unsigned char* st = smem + L::kRing + slot * L::kStageBytes;
    bf16* sq = reinterpret_cast<bf16*>(st);
    load_rows_async<DH>(sq + L::QU, L::LDQ, qu + base, i0, BQ, 0, t);
    load_rows_async<DH>(sq + L::QV, L::LDQ, qv + base, i0, BQ, 0, t);
    load_rows_async<DH>(sq + L::DO, L::LDQ, dout + base, i0, BQ, 0, t);
    load_rows_async<DH>(sq + L::SLAB, L::LDQ, pb, c0, SW, 0, 2L * t);
    float* lf = reinterpret_cast<float*>(sq + (3 * BQ + SW) * L::LDQ);  // lse [BQ], delta [BQ]
    if (threadIdx.x < 2 * BQ) {
      const int r = threadIdx.x % BQ;
      const float* src = threadIdx.x < BQ ? lse : delta;
      const bool ok = i0 + r < t;
      cp_async4(lf + threadIdx.x, ok ? src + (long)bh * t + i0 + r : src, ok);
    }
  };

  // rawg off the band is 0 for every tile: written once.
  for (int idx = threadIdx.x; idx < BQ * L::LDG / 2; idx += kThreads) {
    reinterpret_cast<uint32_t*>(rawg)[idx] = 0u;
  }
  load_rows_async<DH>(ks, L::LDQ, k + base, j0, BK, 0, t);
  load_rows_async<DH>(vs, L::LDQ, v + base, j0, BK, 0, t);
  load_stage(0, 0, (long)t - BQ + j0);
  mma::cp_async_commit();

  float acc_k[1][NKV][4], acc_v[1][NKV][4], sl[3][NSL][4];
#pragma unroll
  for (int j = 0; j < NKV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[0][j][e] = acc_v[0][j][e] = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < NSL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sl[i][j][e] = 0.0f;

  const int sm = (warp >> 2) * 16, sn = (warp & 3) * 16;         // S, dP, raw rows / S cols
  const int rn = (warp & 3) * 24;                                 // raw cols
  const int km = (warp >> 1) * 16, kn = (warp & 1) * (DH / 2);    // dk, dv
  const int lm = warp >> 2, ln = (warp & 3) * (DH / 4);           // dslab m16 tiles lm + 2i
  const int nq = (t + BQ - 1) / BQ;
  const uint32_t seed = DROP ? (uint32_t)__ldg(drop.seed) : 0u;

  // dslab rows of slot i (m16 tile lm + 2i) into dp: one red.v4 per 4
  // columns. Lanes tq and tq ^ 1 trade halves: the even lane takes row g,
  // the odd lane row g + 8, both the 4 columns from (tq & ~1) * 2.
  auto flush = [&](int i, long c0) {
#pragma unroll
    for (int j = 0; j < NSL; ++j) {
      const bool odd = tq & 1;
      const float s0 = odd ? sl[i][j][0] : sl[i][j][2];
      const float s1 = odd ? sl[i][j][1] : sl[i][j][3];
      const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      float4 val = odd ? make_float4(r0, r1, sl[i][j][2], sl[i][j][3])
                       : make_float4(sl[i][j][0], sl[i][j][1], r0, r1);
      const long prow = c0 + (lm + 2 * i) * 16 + g + (odd ? 8 : 0);
      const int col = ln + j * 8 + (tq & 2) * 2;
      if (prow >= 0 && prow < 2L * t &&
          (val.x != 0.0f || val.y != 0.0f || val.z != 0.0f || val.w != 0.0f)) {
        asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(dpb + prow * DH + col),
                     "f"(val.x), "f"(val.y), "f"(val.z), "f"(val.w)
                     : "memory");
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sl[i][j][e] = 0.0f;
    }
  };

  for (int qt = 0; qt < nq; ++qt) {
    const int i0 = qt * BQ;
    const long c0 = (long)t - BQ - i0 + j0;
    mma::cp_async_wait<0>();
    __syncthreads();  // tile qt landed; the previous tile's readers are done
    if (qt + 1 < nq) load_stage((qt + 1) & 1, i0 + BQ, c0 - BQ);
    mma::cp_async_commit();
    const unsigned char* st = smem + L::kRing + (qt & 1) * L::kStageBytes;
    const bf16* sq = reinterpret_cast<const bf16*>(st);
    const bf16 *qus = sq + L::QU, *qvs = sq + L::QV, *dos = sq + L::DO, *slab = sq + L::SLAB;
    const float* lse_s = reinterpret_cast<const float*>(sq + (3 * BQ + SW) * L::LDQ);
    const float* delta_s = lse_s + BQ;
    // Keep bits of the lane's S elements: rows sm + g (+ 8), n8 tiles 0, 1.
    const uint32_t kb = DROP ? philox::keep8(seed, (uint32_t)bh, (uint32_t)(i0 + sm + g),
                                             (uint32_t)(j0 + sn + 2 * tq), drop.thr)
                             : 0u;

    float s[1][2][4], dpr[1][2][4], rw[1][3][4];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        rw[0][j][e] = 0.0f;
        if (j < 2) s[0][j][e] = dpr[0][j][e] = 0.0f;
      }
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      warp_mma_k16<1, 2, Major::K, Major::K>(s, qus, L::LDQ, ks, L::LDQ, sm, sn, kk);
      warp_mma_k16<1, 2, Major::K, Major::K>(dpr, dos, L::LDQ, vs, L::LDQ, sm, sn, kk);
      warp_mma_k16<1, 3, Major::K, Major::K>(rw, qvs, L::LDQ, slab, L::LDQ, sm, rn, kk);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        *reinterpret_cast<float2*>(raw + (sm + g + 8 * hf) * L::LDR + rn + 8 * j + 2 * tq) =
            make_float2(rw[0][j][2 * hf], rw[0][j][2 * hf + 1]);
      }
    __syncthreads();  // raw visible

    // P and ds at the S fragments (PairScores::at with S and dP from
    // registers), to bf16 P, ds and the skewed rawg.
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = sm + g + 8 * hf, c = sn + 8 * j + 2 * tq;
        const int i = i0 + r;
        const float l = lse_s[r], dl = delta_s[r];
        float pv[2], dsv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = j0 + c + e;
          const bool keep = !DROP || philox::kept(kb, hf, j, e);
          pv[e] = 0.0f;
          dsv[e] = 0.0f;
          if (i < t && jj < t) {
            if (l < 0.5f * kNeg) {
              pv[e] = 1.0f / (float)t;  // fully masked row: uniform weights, no ds
            } else if (pair.visible(i, jj)) {
              const float sv = (s[0][j][2 * hf + e] + raw[r * L::LDR + (BQ - 1 - r + c + e)]) * scale;
              float dpv = dpr[0][j][2 * hf + e];
              if (DROP) dpv = keep ? dpv * drop.inv : 0.0f;
              pv[e] = expf(sv - l);
              dsv[e] = pv[e] * (dpv - dl) * scale;
            }
            if (DROP) pv[e] = keep ? pv[e] * drop.inv : 0.0f;  // dv takes the dropped P
          }
          rawg[r * L::LDG + (BQ - 1 - r + c + e)] = __float2bfloat16(dsv[e]);
        }
        *reinterpret_cast<__nv_bfloat162*>(ps + r * L::LDP + c) = __floats2bfloat162_rn(pv[0], pv[1]);
        *reinterpret_cast<__nv_bfloat162*>(dss + r * L::LDP + c) =
            __floats2bfloat162_rn(dsv[0], dsv[1]);
      }
    __syncthreads();  // P, ds, rawg visible

#pragma unroll
    for (int kk = 0; kk < BQ; kk += 16) {
      warp_mma_k16<1, NKV, Major::MN, Major::MN>(acc_v, ps, L::LDP, dos, L::LDQ, km, kn, kk);
      warp_mma_k16<1, NKV, Major::MN, Major::MN>(acc_k, dss, L::LDP, qus, L::LDQ, km, kn, kk);
      warp_mma_k16<3, NSL, Major::MN, Major::MN, 32>(sl, rawg, L::LDG, qvs, L::LDQ, lm * 16, ln,
                                                     kk);
    }
    if (qt + 1 < nq) {
      // slot 2 holds rows [BK, SW): final. Slots 0, 1 move up one (rows
      // + BQ in the next tile's slab).
      flush(2, c0);
#pragma unroll
      for (int j = 0; j < NSL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sl[2][j][e] = sl[1][j][e];
          sl[1][j][e] = sl[0][j][e];
          sl[0][j][e] = 0.0f;
        }
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) flush(i, c0);
    }
  }

#pragma unroll
  for (int j = 0; j < NKV; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = km + g + 8 * hf, c = kn + 8 * j + 2 * tq;
      if (j0 + r < t) {
        const long o = base + (long)(j0 + r) * DH + c;
        *reinterpret_cast<__nv_bfloat162*>(dk + o) =
            __floats2bfloat162_rn(acc_k[0][j][2 * hf], acc_k[0][j][2 * hf + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + o) =
            __floats2bfloat162_rn(acc_v[0][j][2 * hf], acc_v[0][j][2 * hf + 1]);
      }
    }
}

// Sets dkv_kernel<DH, *>'s shared-memory attributes; returns its bytes.
template <int DH>
size_t configure() {
  constexpr size_t bytes = Layout<DH>::kBytes;
  for (auto kernel : {dkv_kernel<DH, false>, dkv_kernel<DH, true>}) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
  }
  return bytes;
}

template <int DH>
int launch(const void* qu, const void* qv, const void* k, const void* v, const void* p,
           const int* lengths, const void* dout, const float* lse, const float* delta, void* dk,
           void* dv, float* dp, int b, int h, int t, float scale, int chunk_size, int left_chunks,
           const philox::Dropout& drop, cudaStream_t stream) {
  const size_t bytes = configure<DH>();
  auto in = [](const void* x) { return static_cast<const bf16*>(x); };
  const auto kernel = drop.seed ? dkv_kernel<DH, true> : dkv_kernel<DH, false>;
  kernel<<<dim3((t + BK - 1) / BK, b * h), kThreads, bytes, stream>>>(
      in(qu), in(qv), in(k), in(v), in(p), lengths, in(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dp, h, t, scale, chunk_size, left_chunks, drop);
  return counted("rel_dkv::dkv_kernel", DH, drop.seed != nullptr);
}

template <int DH>
int blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, dkv_kernel<DH, false>, kThreads,
                                                configure<DH>());
  return n;
}

}  // namespace rel_dkv

// ---- Forward in bf16 at Dh 32 and 64: S, P and O in registers ----------
//
// Replaces _fwd_kernel (espnet_slurp_tpu/ops/pallas/flash_attention.py:134,
// called at :336) in bf16 where Dh is 32 or 64 (both main-path models use
// 64); fp32 and every other Dh take rel_flash_fwd_kernel above. Same
// function and rounding points as that kernel: scores in fp32 from bf16
// products, masked scores kNeg, an online softmax over key tiles whose
// exp(s - m_running) is rounded to bf16 before P v, l and O in fp32.
//
// Bound (flagship train shape, B 64, H 4, T' 468, Dh 64): ~78 MB of
// compulsory traffic (q_u, q_v, k, v, p in; out, lse out), 0.023 ms at
// 3.35 TB/s, and ~21 GFLOP of products over the (query, key) pairs, 0.022
// ms at 989 TFLOP/s: it sits at the ridge. The tiles it forms hold ~28
// GFLOP (the raw slice is 16 x (BK + 16) per warp) and take ~0.25 ms of
// device time there (PERF.md §6): its products run through mma.sync with
// operands fed from shared memory (each warp reads the whole k, v
// and its slab span), beside the softmax's fp32 work; which of the two
// holds it is not measured apart.
//
// Design. One block (4 warps) owns one (b, h) and one query tile of BQ = 64
// rows; warp w owns query rows 16 w .. 16 w + 15 and walks the key tiles of
// BK = 64 rows:
//   - q_u and q_v are loaded once; their A fragments stay in registers for
//     the whole walk (mma::load_a_k16), and so do the O accumulator, the
//     running max m and the per-lane partial sums l (reduced over the quad
//     once, at the end).
//   - S = q_u k^T goes into m16n8k16 accumulators (mma::warp_mma_k16_ra).
//   - The skewed product: the position rows that a warp's 16 query rows
//     need for one key tile are the slab rows [48 - 16 w, 48 - 16 w + 80),
//     so each warp forms only its 16 x 80 slice rawW = q_v slab^T, in five
//     16-row groups of 8 registers each, and stores it in fp32 to a region
//     of shared memory of its own (rows of 88 floats: conflict-free float2
//     stores); after a __syncwarp it reads bd[r, c] = rawW[r, 15 - r + c]
//     at the S fragment's (row, column), the lane-crossing skew.
//   - Masks per lane row: the visible keys of query i are one interval
//     [jlo, jhi) (PairScores::visible: key length, chunk and left chunks),
//     computed once; key columns at or past T are -inf and leave l alone.
//     Scores are kept in log2 units (scale * log2 e folded in, exp2f).
//   - The online softmax runs on the fragments: the row max over the quad
//     that holds a row (two shuffles), O rescaled once a tile, and P packed
//     from the S accumulators straight into bf16 A fragments for P v, whose
//     B operand v is read with ldmatrix.trans.
//   - Loads: a 2-stage cp.async ring of (k, v) tiles, and the slab as a
//     ring of three 64-row chunks (tile kt reads chunks kt and kt + 1, so
//     each p row is fetched once a block); rows outside [0, 2T) and key rows
//     at or past T are zero-filled with a source size of 0.
// Shared memory: 7 tiles of 64 x (Dh + 8) bf16 and 4 x 16 x 88 fp32 raw
// slices (q's staging reuses the raw region): 87,040 B at Dh 64 (58,368 at
// Dh 32), so two blocks (three at Dh 32) share an SM; 176 / 132 registers,
// no spills. At the serving shape
// (B 8, H 4, T' 471) the grid is 8 x 32 = 256 blocks: one wave on 132 SMs.
// rel_dq::dq_kernel below walks the same (b, h, query tile) over the key
// tiles with this loop (ring, raw slice, masks).
// Dropout (DROP, reference :159-165): four Philox calls a lane a key tile,
// before its products, give the keep bits of the lane's 32 S elements; P
// is added into the row sum l first, then dropped (keep ? P / (1 - rate) :
// 0) as it is packed for P v, so the normaliser and lse are the undropped
// ones. A fully masked row's uniform weights are dropped alike.
namespace rel_fwd {

using mma::Major;
using rel_dkv::load_rows_async;
constexpr int BQ = 64, BK = 64, kWarps = BQ / 16, kThreadsFwd = kWarps * 32;
constexpr int SPAN = BK + 16;  // slab rows one warp reads for one key tile (BK + 15, rounded)
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

template <int DH>
struct Layout {
  static constexpr int LDQ = DH + 8;    // q, k, v, slab rows (bf16)
  static constexpr int LDR = SPAN + 8;  // raw fp32: 88 = 24 mod 32 banks
  static constexpr size_t kTile = (size_t)BK * LDQ * 2;
  // k: 2 stages, v: 2 stages, slab: 3 chunks of BK rows, raw: one slice a warp.
  static constexpr size_t kK = 0, kV = 2 * kTile, kSlab = 4 * kTile, kRaw = 7 * kTile,
                          kBytes = kRaw + (size_t)kWarps * 16 * LDR * 4;
  static_assert(BQ == BK, "the slab of a tile is two chunks of BK rows");
  static_assert(kTile % 16 == 0 && 2 * BQ * LDQ * 2 <= kWarps * 16 * LDR * 4,
                "16-byte aligned tiles; q's staging fits the raw region");
};

// Keys visible to query i: [jlo, jhi) (PairScores::visible for keys below
// klen).
__device__ __forceinline__ void visible_keys(int i, int klen, int chunk_size, int left_chunks,
                                             int& jlo, int& jhi) {
  jlo = 0;
  jhi = klen;
  if (chunk_size > 0) {
    const int rc = i / chunk_size;
    jhi = min(klen, (rc + 1) * chunk_size);
    if (left_chunks >= 0) jlo = max(0, (rc - left_chunks) * chunk_size);
  }
}

// Slab rows row .. row + 15 of key tile kt in the 3-chunk ring `slab`
// (chunk m in slot m % 3; tile kt's slab is chunks kt and kt + 1).
template <int LDQ>
__device__ __forceinline__ const bf16* slab_rows(const bf16* slab, int kt, int row) {
  return slab + ((kt + row / BK) % 3) * BK * LDQ + (row % BK) * LDQ;
}

// The warp's rawW = q_v slab[sw0 : sw0 + SPAN]^T of key tile kt into its
// fp32 raw slice (rows of LDR floats), 16 slab rows (one chunk) at a time.
template <int DH, int LDQ, int LDR>
__device__ __forceinline__ void raw_slice(float* raw, const uint32_t (&qa_v)[DH / 16][4],
                                          const bf16* slab, int kt, int sw0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int gi = 0; gi < SPAN / 16; ++gi) {
    float rw[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) rw[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      mma::warp_mma_k16_ra<2, Major::K>(rw, qa_v[kk], slab_rows<LDQ>(slab, kt, sw0 + 16 * gi),
                                        LDQ, 0, kk * 16);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        *reinterpret_cast<float2*>(raw + (g + 8 * hf) * LDR + 16 * gi + 8 * j + 2 * tq) =
            make_float2(rw[j][2 * hf], rw[j][2 * hf + 1]);
      }
  }
}

template <int DH, bool DROP>
__global__ void __launch_bounds__(kThreadsFwd, 2)
    fwd_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ qv,
               const bf16* __restrict__ k, const bf16* __restrict__ v,
               const bf16* __restrict__ p, const int* __restrict__ lengths,
               bf16* __restrict__ out, float* __restrict__ lse, int h, int t, float scale,
               int chunk_size, int left_chunks, philox::Dropout drop) {
  using L = Layout<DH>;
  constexpr int KS = DH / 16;  // k-steps over Dh
  constexpr int NO = DH / 8;   // n8 tiles of a warp's O (16 x DH)
  constexpr int NS = BK / 8;   // n8 tiles of a warp's S (16 x BK)
  extern __shared__ __align__(128) unsigned char smem[];

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int i0 = blockIdx.x * BQ;
  const long base = (long)bh * t * DH;
  const bf16* pb = p + (long)hh * 2 * t * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long cb = (long)t - BQ - i0;  // p row of slab row 0 at key tile 0
  const int nk = (t + BK - 1) / BK;
  float* raw = reinterpret_cast<float*>(smem + L::kRaw) + warp * 16 * L::LDR;
  auto tile = [&](size_t region, int slot) {
    return reinterpret_cast<bf16*>(smem + region + slot * L::kTile);
  };
  // Chunk m: p rows [cb + m BK, cb + (m + 1) BK), in slot m % 3.
  auto load_chunk = [&](int m) {
    load_rows_async<DH, kThreadsFwd>(tile(L::kSlab, m % 3), L::LDQ, pb, cb + (long)m * BK, BK, 0,
                                     2L * t);
  };
  auto load_kv = [&](int kt) {
    load_rows_async<DH, kThreadsFwd>(tile(L::kK, kt & 1), L::LDQ, k + base, kt * BK, BK, 0, t);
    load_rows_async<DH, kThreadsFwd>(tile(L::kV, kt & 1), L::LDQ, v + base, kt * BK, BK, 0, t);
  };

  // q_u and q_v through the raw region into registers, with tile 0.
  bf16* qs = reinterpret_cast<bf16*>(smem + L::kRaw);
  load_rows_async<DH, kThreadsFwd>(qs, L::LDQ, qu + base, i0, BQ, 0, t);
  load_rows_async<DH, kThreadsFwd>(qs + BQ * L::LDQ, L::LDQ, qv + base, i0, BQ, 0, t);
  load_chunk(0);
  load_kv(0);
  load_chunk(1);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  uint32_t qa_u[KS][4], qa_v[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    mma::load_a_k16<Major::K>(qa_u[kk], qs, L::LDQ, warp * 16, kk * 16);
    mma::load_a_k16<Major::K>(qa_v[kk], qs + BQ * L::LDQ, L::LDQ, warp * 16, kk * 16);
  }

  // This lane's rows g and g + 8 of the warp: visible keys [jlo, jhi).
  int jlo[2], jhi[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    visible_keys(i0 + warp * 16 + g + 8 * hf, lengths[b], chunk_size, left_chunks, jlo[hf],
                 jhi[hf]);
  }

  const float sl2 = scale * kLog2e, neg2 = kNeg * kLog2e;
  float o[NO][4], m2[2] = {neg2, neg2}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  const int sw0 = BQ - 16 - 16 * warp;  // the warp's first slab row
  const uint32_t seed = DROP ? (uint32_t)__ldg(drop.seed) : 0u;
  const uint32_t krow = (uint32_t)(i0 + warp * 16 + g);  // the lane's first row

  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile kt landed; tile kt - 1's readers (and q's) are done
    if (kt + 1 < nk) {
      load_kv(kt + 1);
      load_chunk(kt + 2);
    }
    mma::cp_async_commit();
    const bf16* ks = tile(L::kK, kt & 1);
    const bf16* vs = tile(L::kV, kt & 1);
    const int j0 = kt * BK;
    // Keep bits of the lane's S elements: n8 tiles (2 kk, 2 kk + 1) in bits
    // 8 kk .. 8 kk + 7.
    uint32_t kb = 0;
    if constexpr (DROP) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        kb |= philox::keep8(seed, (uint32_t)bh, krow, (uint32_t)(j0 + 16 * kk + 2 * tq), drop.thr)
              << (8 * kk);
      }
    }

    raw_slice<DH, L::LDQ, L::LDR>(raw, qa_v, tile(L::kSlab, 0), kt, sw0);

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) mma::warp_mma_k16_ra<NS, Major::K>(s, qa_u[kk], ks, L::LDQ, 0, kk * 16);
    __syncwarp();  // rawW visible to the warp

    // Scores in log2 units, masked; the tile's row max.
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = g + 8 * hf, c = 8 * j + 2 * tq + e, jj = j0 + c;
          float x = -CUDART_INF_F;  // key column past T: not part of the softmax
          if (jj < t) {
            x = jj >= jlo[hf] && jj < jhi[hf]
                    ? (s[j][2 * hf + e] + raw[r * L::LDR + 15 - r + c]) * sl2
                    : neg2;
          }
          s[j][2 * hf + e] = x;
          mt[hf] = fmaxf(mt[hf], x);
        }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mt[hf] = fmaxf(mt[hf], __shfl_xor_sync(0xffffffffu, mt[hf], 1));
      mt[hf] = fmaxf(mt[hf], __shfl_xor_sync(0xffffffffu, mt[hf], 2));
      const float m_new = fmaxf(m2[hf], mt[hf]);
      alpha[hf] = exp2f(m2[hf] - m_new);
      m2[hf] = m_new;
      l[hf] *= alpha[hf];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

    // P = exp2(x - m) in fp32 for l, in bf16 A fragments for P v.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float p0 = exp2f(s[2 * kk + q][2 * hf] - m2[hf]);
          float p1 = exp2f(s[2 * kk + q][2 * hf + 1] - m2[hf]);
          l[hf] += p0 + p1;
          if constexpr (DROP) {
            const uint32_t k8 = kb >> (8 * kk);
            p0 = philox::kept(k8, hf, q, 0) ? p0 * drop.inv : 0.0f;
            p1 = philox::kept(k8, hf, q, 1) ? p1 * drop.inv : 0.0f;
          }
          __nv_bfloat162 pk = __floats2bfloat162_rn(p0, p1);
          a[2 * q + hf] = *reinterpret_cast<uint32_t*>(&pk);
        }
      mma::warp_mma_k16_ra<NO, Major::MN>(o, a, vs, L::LDQ, 0, kk * 16);
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lt = l[hf] + __shfl_xor_sync(0xffffffffu, l[hf], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, 1e-30f);
    const int i = i0 + warp * 16 + g + 8 * hf;
    if (i < t) {
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(out + base + (long)i * DH + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(o[j][2 * hf] / lt, o[j][2 * hf + 1] / lt);
      }
      if (tq == 0) lse[(long)bh * t + i] = m2[hf] * kLn2 + logf(lt);
    }
  }
}

// Sets fwd_kernel<DH, *>'s shared-memory attributes; returns its bytes.
template <int DH>
size_t configure() {
  constexpr size_t bytes = Layout<DH>::kBytes;
  for (auto kernel : {fwd_kernel<DH, false>, fwd_kernel<DH, true>}) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
  }
  return bytes;
}

template <int DH>
int launch(const void* qu, const void* qv, const void* k, const void* v, const void* p,
           const int* lengths, void* out, float* lse, int b, int h, int t, float scale,
           int chunk_size, int left_chunks, const philox::Dropout& drop, cudaStream_t stream) {
  const size_t bytes = configure<DH>();
  auto in = [](const void* x) { return static_cast<const bf16*>(x); };
  const auto kernel = drop.seed ? fwd_kernel<DH, true> : fwd_kernel<DH, false>;
  kernel<<<dim3((t + BQ - 1) / BQ, b * h), kThreadsFwd, bytes, stream>>>(
      in(qu), in(qv), in(k), in(v), in(p), lengths, static_cast<bf16*>(out), lse, h, t, scale,
      chunk_size, left_chunks, drop);
  return counted("rel_fwd::fwd_kernel", DH, drop.seed != nullptr);
}

template <int DH>
int blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fwd_kernel<DH, false>, kThreadsFwd,
                                                configure<DH>());
  return n;
}

}  // namespace rel_fwd

// ---- dq in bf16 at Dh 32 and 64: the forward's query-tile loop ---------
//
// Replaces _dq_kernel (espnet_slurp_tpu/ops/pallas/flash_attention.py:237,
// called at :421) in bf16 where Dh is 32 or 64 (both main-path models use
// 64); fp32 and every other Dh take rel_flash_dq_kernel above. Same
// function and rounding points as that kernel (PairScores::at): s in fp32
// from bf16 products, P = exp(s - lse) and ds = P (dP - delta) scale on
// visible pairs, ds and the skewed rawg rounded to bf16 before ds k and
// rawg slab, fp32 accumulation; masked pairs, keys at or past T and fully
// masked rows (lse < kNeg / 2) give ds = 0.
//
// Bound (flagship train shape, B 64, H 4, T' 468, Dh 64, ragged lengths):
// ~109 MB of compulsory traffic (q_u, q_v, dO, k, v, p, lse, delta in;
// dq_u, dq_v out), 0.033 ms at 3.35 TB/s; five products over the ~45 M
// visible (query, key) pairs, ~29 GFLOP, 0.029 ms at 989 TFLOP/s: it sits
// at the ridge. The tiles it forms hold ~2.9 MFLOP a (query tile, key
// tile) pair; as in the forward, mma.sync with operands fed from shared
// memory and the fp32 work on the fragments bound it first.
//
// Design: rel_fwd::fwd_kernel's walk. One block (4 warps) owns one (b, h)
// and one query tile of BQ = 64 rows; warp w owns query rows 16 w .. 16 w
// + 15 and walks the key tiles of BK = 64 rows:
//   - q_u, q_v and dO are loaded once; their A fragments stay in registers,
//     and so do the dq_u and dq_v accumulators (16 x Dh fp32 each), lse
//     (in log2 units) and delta of the lane's two rows.
//   - The skewed product: as in the forward, each warp forms its 16 x 80
//     slice rawW = q_v slab[sw0 : sw0 + 80]^T and stores it in fp32 to a
//     shared region of its own; bd[r, c] = rawW[r, 15 - r + c].
//   - S = q_u k^T and dP = dO v^T go into m16n8k16 accumulators, in two
//     halves of 32 key columns (registers: the fragments and accumulators
//     above hold 112 of them). ds is formed at the fragments and packed
//     straight into bf16 A fragments for dq_u += ds k, k read as the
//     MN-major B through ldmatrix.trans.
//   - rawg[r, 15 - r + c] = ds[r, c] crosses lanes: each warp writes its ds
//     skewed (2-byte stores: the pair (c, c + 1) is 4-byte aligned only for
//     odd r) into a bf16 16 x 80 region of its own, whose off-band zeros are
//     written once a block, and reads it back after a __syncwarp as A
//     fragments (mma::load_a_k16) for dq_v += rawg slab[sw0 : sw0 + 80],
//     the slab read through ldmatrix.trans, one ring chunk a 16-row group.
//   - Loads: the forward's 2-stage cp.async (k, v) ring and 3-chunk slab
//     ring (tile kt reads chunks kt and kt + 1), zero-filled outside [0,
//     2T) and past T.
// Shared memory: the forward's 7 tiles of 64 x (Dh + 8) bf16 and 4 x 16 x
// 88 fp32 raw slices, plus 4 x 16 x 88 bf16 rawg regions (q_u, q_v and
// dO's staging reuses raw and rawg): 98,304 B at Dh 64 (69,632 at Dh 32),
// so two blocks share an SM.
// Dropout (DROP, reference :262-265): four Philox calls a lane a key tile,
// before its products, give the keep bits of the lane's 32 elements; dP is
// masked and scaled (keep ? dP / (1 - rate) : 0) before ds.
namespace rel_dq {

using mma::Major;
using rel_dkv::load_rows_async;
using rel_fwd::BK;
using rel_fwd::BQ;
using rel_fwd::kLog2e;
using rel_fwd::kThreadsFwd;
using rel_fwd::kWarps;
using rel_fwd::raw_slice;
using rel_fwd::slab_rows;
using rel_fwd::SPAN;
using rel_fwd::visible_keys;
constexpr int HALF = BK / 2;  // key columns of S and dP formed at once

template <int DH>
struct Layout {
  static constexpr int LDQ = DH + 8;    // q, dO, k, v, slab rows (bf16)
  static constexpr int LDR = SPAN + 8;  // raw fp32: 88 = 24 mod 32 banks
  static constexpr int LDG = SPAN + 8;  // rawg bf16: 176-byte rows, ldmatrix without conflicts
  static constexpr size_t kTile = (size_t)BK * LDQ * 2;
  // k: 2 stages, v: 2 stages, slab: 3 chunks of BK rows, then one raw slice
  // and one rawg region a warp.
  static constexpr size_t kK = 0, kV = 2 * kTile, kSlab = 4 * kTile, kRaw = 7 * kTile,
                          kRawg = kRaw + (size_t)kWarps * 16 * LDR * 4,
                          kBytes = kRawg + (size_t)kWarps * 16 * LDG * 2;
  static_assert(BQ == BK, "the slab of a tile is two chunks of BK rows");
  static_assert(kTile % 16 == 0 && kRawg % 16 == 0 && 3 * BQ * LDQ * 2 <= kBytes - kRaw,
                "16-byte aligned regions; q_u, q_v and dO's staging fits raw and rawg");
};

template <int DH, bool DROP>
__global__ void __launch_bounds__(kThreadsFwd, 2)
    dq_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ qv,
              const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ p, const int* __restrict__ lengths,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, bf16* __restrict__ dqu, bf16* __restrict__ dqv,
              int h, int t, float scale, int chunk_size, int left_chunks, philox::Dropout drop) {
  using L = Layout<DH>;
  constexpr int KS = DH / 16;   // k-steps over Dh
  constexpr int NO = DH / 8;    // n8 tiles of a warp's dq_u / dq_v (16 x DH)
  constexpr int NH = HALF / 8;  // n8 tiles of a warp's S / dP half (16 x HALF)
  extern __shared__ __align__(128) unsigned char smem[];

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int i0 = blockIdx.x * BQ;
  const long base = (long)bh * t * DH;
  const bf16* pb = p + (long)hh * 2 * t * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long cb = (long)t - BQ - i0;  // p row of slab row 0 at key tile 0
  float* raw = reinterpret_cast<float*>(smem + L::kRaw) + warp * 16 * L::LDR;
  bf16* rg = reinterpret_cast<bf16*>(smem + L::kRawg) + warp * 16 * L::LDG;
  auto tile = [&](size_t region, int slot) {
    return reinterpret_cast<bf16*>(smem + region + slot * L::kTile);
  };
  auto load_chunk = [&](int m) {
    load_rows_async<DH, kThreadsFwd>(tile(L::kSlab, m % 3), L::LDQ, pb, cb + (long)m * BK, BK, 0,
                                     2L * t);
  };
  auto load_kv = [&](int kt) {
    load_rows_async<DH, kThreadsFwd>(tile(L::kK, kt & 1), L::LDQ, k + base, kt * BK, BK, 0, t);
    load_rows_async<DH, kThreadsFwd>(tile(L::kV, kt & 1), L::LDQ, v + base, kt * BK, BK, 0, t);
  };

  const int nk = (t + BK - 1) / BK;
  const int klen = min(lengths[b], t);  // keys at or past T are invisible

  // q_u, q_v and dO through the raw and rawg regions into registers, with
  // the first tile.
  bf16* qs = reinterpret_cast<bf16*>(smem + L::kRaw);
  load_rows_async<DH, kThreadsFwd>(qs, L::LDQ, qu + base, i0, BQ, 0, t);
  load_rows_async<DH, kThreadsFwd>(qs + BQ * L::LDQ, L::LDQ, qv + base, i0, BQ, 0, t);
  load_rows_async<DH, kThreadsFwd>(qs + 2 * BQ * L::LDQ, L::LDQ, dout + base, i0, BQ, 0, t);
  load_chunk(0);
  load_kv(0);
  load_chunk(1);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  uint32_t qa_u[KS][4], qa_v[KS][4], qa_do[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    mma::load_a_k16<Major::K>(qa_u[kk], qs, L::LDQ, warp * 16, kk * 16);
    mma::load_a_k16<Major::K>(qa_v[kk], qs + BQ * L::LDQ, L::LDQ, warp * 16, kk * 16);
    mma::load_a_k16<Major::K>(qa_do[kk], qs + 2 * BQ * L::LDQ, L::LDQ, warp * 16, kk * 16);
  }
  __syncthreads();  // every warp has read the staging
  // rawg off the band is 0 for every tile: written once.
  for (int idx = lane; idx < 16 * L::LDG / 2; idx += 32) {
    reinterpret_cast<uint32_t*>(rg)[idx] = 0u;
  }

  // This lane's rows g and g + 8 of the warp: visible keys (none for a row
  // past T or a fully masked one), lse in log2 units, delta.
  int jlo[2], jhi[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = i0 + warp * 16 + g + 8 * hf;
    const float l = i < t ? lse[(long)bh * t + i] : kNeg;
    dl[hf] = i < t ? delta[(long)bh * t + i] : 0.0f;
    lse2[hf] = l * kLog2e;
    visible_keys(i, klen, chunk_size, left_chunks, jlo[hf], jhi[hf]);
    if (i >= t || l < 0.5f * kNeg) jhi[hf] = jlo[hf];
  }

  const float sl2 = scale * kLog2e;
  float acc_u[NO][4], acc_v[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_u[j][e] = acc_v[j][e] = 0.0f;
  const int sw0 = BQ - 16 - 16 * warp;  // the warp's first slab row
  const uint32_t seed = DROP ? (uint32_t)__ldg(drop.seed) : 0u;
  const uint32_t krow = (uint32_t)(i0 + warp * 16 + g);  // the lane's first row

  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile kt landed; tile kt - 1's readers are done
    if (kt + 1 < nk) {
      load_kv(kt + 1);
      load_chunk(kt + 2);
    }
    mma::cp_async_commit();
    const bf16* ks = tile(L::kK, kt & 1);
    const bf16* vs = tile(L::kV, kt & 1);
    const bf16* slab = tile(L::kSlab, 0);
    const int j0 = kt * BK;
    // Keep bits of the lane's elements: n8 tiles (2 m, 2 m + 1) of the tile
    // (m = 2 hv + jp over the halves) in bits 8 m .. 8 m + 7.
    uint32_t kb = 0;
    if constexpr (DROP) {
#pragma unroll
      for (int m = 0; m < BK / 16; ++m) {
        kb |= philox::keep8(seed, (uint32_t)bh, krow, (uint32_t)(j0 + 16 * m + 2 * tq), drop.thr)
              << (8 * m);
      }
    }
    raw_slice<DH, L::LDQ, L::LDR>(raw, qa_v, slab, kt, sw0);
    __syncwarp();  // rawW visible to the warp

#pragma unroll
    for (int hv = 0; hv < BK / HALF; ++hv) {
      const int n0 = hv * HALF;
      float s[NH][4], dpv[NH][4];
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dpv[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        mma::warp_mma_k16_ra<NH, Major::K>(s, qa_u[kk], ks, L::LDQ, n0, kk * 16);
        mma::warp_mma_k16_ra<NH, Major::K>(dpv, qa_do[kk], vs, L::LDQ, n0, kk * 16);
      }
      // ds at the fragments (into s), and skewed into rawg.
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = g + 8 * hf, c = n0 + 8 * j + 2 * tq + e, jj = j0 + c;
            float ds = 0.0f;
            if (jj >= jlo[hf] && jj < jhi[hf]) {
              const float x = (s[j][2 * hf + e] + raw[r * L::LDR + 15 - r + c]) * sl2 - lse2[hf];
              float dpk = dpv[j][2 * hf + e];
              if constexpr (DROP) {
                const uint32_t k8 = kb >> (8 * ((n0 + 8 * j) / 16));
                dpk = philox::kept(k8, hf, j & 1, e) ? dpk * drop.inv : 0.0f;
              }
              ds = exp2f(x) * (dpk - dl[hf]) * scale;
            }
            s[j][2 * hf + e] = ds;
            rg[r * L::LDG + 15 - r + c] = __float2bfloat16(ds);
          }
      // dq_u += ds k over the half's keys.
#pragma unroll
      for (int kk = 0; kk < HALF / 16; ++kk) {
        uint32_t a[4];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            __nv_bfloat162 pk = __floats2bfloat162_rn(s[2 * kk + q][2 * hf],
                                                      s[2 * kk + q][2 * hf + 1]);
            a[2 * q + hf] = *reinterpret_cast<uint32_t*>(&pk);
          }
        mma::warp_mma_k16_ra<NO, Major::MN>(acc_u, a, ks, L::LDQ, 0, n0 + kk * 16);
      }
    }
    __syncwarp();  // rawg visible to the warp

    // dq_v += rawg slab[sw0 : sw0 + SPAN], 16 slab rows (one chunk) at a time.
#pragma unroll
    for (int gi = 0; gi < SPAN / 16; ++gi) {
      uint32_t a[4];
      mma::load_a_k16<Major::K>(a, rg, L::LDG, 0, gi * 16);
      mma::warp_mma_k16_ra<NO, Major::MN>(acc_v, a, slab_rows<L::LDQ>(slab, kt, sw0 + 16 * gi),
                                          L::LDQ, 0, 0);
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = i0 + warp * 16 + g + 8 * hf;
    if (i < t) {
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const long o = base + (long)i * DH + 8 * j + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(dqu + o) =
            __floats2bfloat162_rn(acc_u[j][2 * hf], acc_u[j][2 * hf + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dqv + o) =
            __floats2bfloat162_rn(acc_v[j][2 * hf], acc_v[j][2 * hf + 1]);
      }
    }
  }
}

// Sets dq_kernel<DH, *>'s shared-memory attributes; returns its bytes.
template <int DH>
size_t configure() {
  constexpr size_t bytes = Layout<DH>::kBytes;
  for (auto kernel : {dq_kernel<DH, false>, dq_kernel<DH, true>}) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
  }
  return bytes;
}

template <int DH>
int launch(const void* qu, const void* qv, const void* k, const void* v, const void* p,
           const int* lengths, const void* dout, const float* lse, const float* delta, void* dqu,
           void* dqv, int b, int h, int t, float scale, int chunk_size, int left_chunks,
           const philox::Dropout& drop, cudaStream_t stream) {
  const size_t bytes = configure<DH>();
  auto in = [](const void* x) { return static_cast<const bf16*>(x); };
  const auto kernel = drop.seed ? dq_kernel<DH, true> : dq_kernel<DH, false>;
  kernel<<<dim3((t + BQ - 1) / BQ, b * h), kThreadsFwd, bytes, stream>>>(
      in(qu), in(qv), in(k), in(v), in(p), lengths, in(dout), lse, delta, static_cast<bf16*>(dqu),
      static_cast<bf16*>(dqv), h, t, scale, chunk_size, left_chunks, drop);
  return counted("rel_dq::dq_kernel", DH, drop.seed != nullptr);
}

template <int DH>
int blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, dq_kernel<DH, false>, kThreadsFwd,
                                                configure<DH>());
  return n;
}

}  // namespace rel_dq

// dst[0 : CW] += v in device memory: one red.global.add.v4.f32 (CW 4,
// 16-byte aligned) or two scalar reductions (CW 2).
template <int CW>
__device__ __forceinline__ void red_add_f32(float* dst, const float (&v)[CW]) {
  if constexpr (CW == 4) {
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst), "f"(v[0]),
                 "f"(v[1]), "f"(v[2]), "f"(v[3])
                 : "memory");
  } else {
#pragma unroll
    for (int e = 0; e < CW; ++e) atomicAdd(dst + e, v[e]);
  }
}

// ---- fp32 at Dh 32, 64 and 128: register micro-tiles of FMAs -----------
//
// Replace _fwd_kernel, _dq_kernel and _dkv_kernel
// (espnet_slurp_tpu/ops/pallas/flash_attention.py:134 / :237 / :178,
// called at :336 / :421 / :379) in fp32 where Dh is 32, 64 or 128 (the
// default ASRConfig's Dh is 64, d_model 512 / 4 heads gives 128); fp32 at
// any other Dh takes the WMMA-staged rel_flash_*_kernel<float, 32, 32>
// above. They compute what those kernels compute, in exact fp32 (no TF32):
// the same masks, dropout bits (philox::fill_keep_tile at 16-aligned tile
// origins), rounding points (PairScores::at) and fully-masked-row rule;
// only the fp32 summation order differs.
//
// Bound (default ASRConfig train shape, B 64, H 4, T' 468, Dh 64, ragged
// key lengths): the products over the visible (query, key) pairs, ~17
// GFLOP forward and ~46 GFLOP backward, at the 67 TFLOP/s of the fp32
// units: 0.26 ms forward, 0.51 ms dkv and 0.43 ms dq (their compulsory
// bytes take under 0.05 ms). The WMMA-staged kernels read both operands of
// every FMA from shared memory, one output a thread, and run at 1.6-5.9
// TFLOP/s: they wait on shared memory, not on the FMA units.
//
// Design. A block of 256 threads, a 16 x 16 grid (ty, tx); a warp holds 4
// ty x 8 tx. Every product of the three kernels is a register micro-tile:
//   - Scores (pair_products): thread (ty, tx) accumulates the TM x TN
//     scores of query rows ty + 16 i and key columns tx + 16 j. Per 4 k it
//     loads TM rows of q_u and of q_v, TN rows of k and, for the skewed
//     term, TM + TN - 1 slab rows, each as one float4, and does 2 TM TN x 4
//     FMAs (3 with dP = dO v^T): q_u k and q_v p go into the same
//     accumulator, and the slab rows of element (i, j) are
//     BQ - 1 - ty + tx + 16 (j - i), one band a thread, each row used by
//     every element on its diagonal. No [BQ, BQ + BK] raw tile and no
//     shared trip of the scores. Row strides of Dh + 4 floats put the 8
//     consecutive rows a warp reads at once in 8 distinct 16-byte bank
//     groups; q rows are broadcast over the 8 tx lanes.
//   - The second products (rows_times: P v, ds k, rawg slab, P^T dO, ds^T
//     q_u, rawg^T q_v): rows ty + 16 i of an operand in shared memory
//     (float4 over the reduction axis, broadcast over tx) times a row of
//     the other (each lane 2-4 consecutive columns: one 128-byte wavefront
//     a warp), accumulated in registers.
//   - Forward: the online softmax in registers, in log2 units; a row's
//     16 columns threads sit in two warps, so its max goes through a
//     [BQ][2] shared array once a key tile (three shuffles, then one read);
//     l stays a per-thread partial sum, reduced at the end. P goes to
//     shared memory once, into the k tile's region (k is read by then), and
//     the slab of the next key tile is fetched while P v runs, v while the
//     scores run (cp.async).
//   - dq: P and ds from lse and delta (registers: a thread's rows are the
//     same in every key tile); ds and the skewed rawg [BQ, BQ + BK] (its
//     off-band zeros written once) to shared memory; dq_u += ds k and dq_v
//     += rawg slab. v of the next key tile is fetched during those products.
//   - dkv: one key tile, the query tiles walked; P^T, ds^T and rawg^T to
//     shared memory ([BK or BQ + BK][BQ + 4]: conflict-free transposing
//     stores); dk, dv and the [BQ + BK, Dh] dp slab accumulate in
//     registers. The slab rows [BK, BQ + BK) are final after each query
//     tile (the next tile's slab starts BQ rows lower): those are added to
//     dp with red.global.add.v4.f32 (all rows after the last tile), the
//     rest move up BQ rows in registers. The next tile's slab is fetched
//     while the products run.
//   - Zeros not formed: half of rawg and rawg^T is off the band, and a warp
//     skips the 4-column steps of rawg slab and rawg^T q_v that miss the
//     band of all its rows. Key tiles at or past the key length add exact
//     zeros to every row that sees a key: the forward and dkv skip them
//     unless a row may see none (no key, or a left-chunk window past the
//     keys: those rows weigh all T keys), dq always (ds = 0 there).
//   - Tiles: BQ = BK = 64 (BQ = 32 for dq and dkv at Dh 128, for their
//     shared memory); BQ, BK and every tile origin multiples of 16, so the
//     keep tile is filled at 16-aligned origins. Rows past T, and slab
//     rows outside [0, 2T), are zero-filled by cp.async with a source size
//     of 0.
// Shared memory at Dh 64: forward 109,056 B (two blocks an SM), dq
// 178,176 B, dkv 196,096 B. Each instantiation's attributes are set once.
// On the H100 they reach 29-34% of these bounds (PERF.md §6). Deeper
// unrolling, a second dq stage for k and the slab and fetching dkv's q
// operands as soon as each product is done did not make them faster: load
// latency does not hold them. The backward forms 11 products a (query,
// key) pair (S and dP in both kernels; dp and dq_v from the band), SDPA's
// backward over a precomputed bias 5.
namespace rel_f32 {

using mma::cp_async16;
using mma::cp_async4;
using rel_fwd::kLn2;
using rel_fwd::kLog2e;
using rel_fwd::visible_keys;
constexpr int kThr = 256;  // the 16 x 16 thread grid
constexpr int BK = 64;     // key tile of the three kernels
constexpr int TN = BK / 16;

// Query tile of the dq and dkv kernels.
template <int DH>
constexpr int bq_bwd() {
  return DH == 128 ? 32 : 64;
}

__device__ __forceinline__ void grid_pos(int& ty, int& tx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ty = (warp >> 1) * 4 + (lane >> 3);
  tx = (warp & 1) * 8 + (lane & 7);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float c) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, c))));
}

// The thread's columns of a [*, DH] row: d = 16 CW m + CW tx + e, m < NCH,
// e < CW (CW = 4, or 2 at Dh 32), held as acc[.][CW m + e].
template <int DH>
struct Cols {
  static constexpr int DV = DH / 16, CW = DV < 4 ? DV : 4, NCH = DV / CW;
  static __device__ __forceinline__ int col(int m, int tx) { return 16 * CW * m + CW * tx; }
};

template <int CW>
__device__ __forceinline__ void load_cw(float (&d)[CW], const float* p) {
  if constexpr (CW == 4) {
    const float4 x = ld4(p);
    d[0] = x.x, d[1] = x.y, d[2] = x.z, d[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    d[0] = x.x, d[1] = x.y;
  }
}

template <int CW>
__device__ __forceinline__ void store_cw(float* p, const float* d) {
  if constexpr (CW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
  }
}

// rows x DH floats of global rows [r0, r0 + rows) of g (row length DH) into
// shared s (ld floats a row) by cp.async; rows outside [lo, hi) are
// zero-filled.
template <int DH>
__device__ __forceinline__ void load_rows(float* s, int ld, const float* g, long r0, int rows,
                                          long lo, long hi) {
  constexpr int CH = DH / 4;
  for (int idx = threadIdx.x; idx < rows * CH; idx += kThr) {
    const int r = idx / CH;
    const int c = (idx - r * CH) * 4;
    const long gr = r0 + r;
    const bool ok = gr >= lo && gr < hi;
    cp_async16(s + r * ld + c, ok ? g + gr * DH + c : g, ok);
  }
}

// The thread's TM x TN scores of one (query tile, key tile) pair, rows r_i
// = ty + 16 i, columns c_j = tx + 16 j (BQ = 16 TM, all operands in shared
// memory with rows of DH + 4 floats):
//   s[i][j] += q_u[r_i] . k[c_j] + q_v[r_i] . slab[BQ - 1 - r_i + c_j],
// and with DP dp[i][j] += dO[r_i] . v[c_j].
template <int DH, int TM, bool DP>
__device__ __forceinline__ void pair_products(float (&s)[TM][TN], float (&dp)[TM][TN],
                                              const float* qu, const float* qv, const float* dO,
                                              const float* k, const float* v, const float* slab,
                                              int ty, int tx) {
  constexpr int LD = DH + 4;
  const float* band = slab + (16 * TM - 1 - ty + tx) * LD;  // slab row of (i, j) = band + 16 (j - i)
#pragma unroll 2
  for (int kk = 0; kk < DH; kk += 4) {
    float4 a[TM], bb[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = ld4(qu + (ty + 16 * i) * LD + kk);
#pragma unroll
    for (int j = 0; j < TN; ++j) bb[j] = ld4(k + (tx + 16 * j) * LD + kk);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = dot4(a[i], bb[j], s[i][j]);
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = ld4(qv + (ty + 16 * i) * LD + kk);
#pragma unroll
    for (int u = 1 - TM; u < TN; ++u) {
      const float4 w = ld4(band + 16 * u * LD + kk);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (u + i >= 0 && u + i < TN) s[i][u + i] = dot4(a[i], w, s[i][u + i]);
      }
    }
    if constexpr (DP) {
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ld4(dO + (ty + 16 * i) * LD + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j) bb[j] = ld4(v + (tx + 16 * j) * LD + kk);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) dp[i][j] = dot4(a[i], bb[j], dp[i][j]);
    }
  }
}

// acc[i][.] += sum_{x < n} a[ty + 16 i][x] * b[x][the thread's columns]:
// a with rows of lda floats, b with rows of DH + 4, both in shared memory;
// n a multiple of 4. With BAND, row `row` of a is zero outside columns
// [BQ - 1 - row, BQ - 2 - row + BK] (the skewed rawg and rawg^T), and a
// warp skips the 4-column steps that miss the band of all its rows.
template <int DH, int R, int BQ = 0>
__device__ __forceinline__ void rows_times(float (&acc)[R][DH / 16], const float* a, int lda,
                                           const float* b, int n, int ty, int tx) {
  using C = Cols<DH>;
  constexpr int LD = DH + 4;
  const int ty0 = ty & ~3;  // the warp's rows are ty0 .. ty0 + 3 (+ 16 i)
#pragma unroll 4
  for (int x = 0; x < n; x += 4) {
    bool on[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      on[i] = BQ == 0 || (x + 3 >= BQ - 4 - ty0 - 16 * i && x <= BQ - 2 - ty0 - 16 * i + BK);
    }
    float4 ar[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (on[i]) ar[i] = ld4(a + (ty + 16 * i) * lda + x);
    }
#pragma unroll
    for (int xx = 0; xx < 4; ++xx) {
      float bv[C::NCH][C::CW];
#pragma unroll
      for (int m = 0; m < C::NCH; ++m) load_cw<C::CW>(bv[m], b + (x + xx) * LD + C::col(m, tx));
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (!on[i]) continue;
        const float av = comp(ar[i], xx);
#pragma unroll
        for (int m = 0; m < C::NCH; ++m)
#pragma unroll
          for (int e = 0; e < C::CW; ++e) {
            acc[i][C::CW * m + e] = fmaf(av, bv[m][e], acc[i][C::CW * m + e]);
          }
      }
    }
  }
}

// Rows r_i of acc into global rows row0 + r_i < t of g ([*, DH]).
template <int DH, int R>
__device__ __forceinline__ void store_rows(float* g, const float (&acc)[R][DH / 16], long row0,
                                           int t, int ty, int tx) {
  using C = Cols<DH>;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long row = row0 + ty + 16 * i;
    if (row < t) {
#pragma unroll
      for (int m = 0; m < C::NCH; ++m) store_cw<C::CW>(g + row * DH + C::col(m, tx), &acc[i][C::CW * m]);
    }
  }
}

template <int DH>
struct FwdLayout {
  static constexpr int BQ = 64, SW = BQ + BK, LD = DH + 4, LDP = BK + 4;
  static constexpr size_t kTileQ = (size_t)BQ * LD * 4,
                          kKP = (size_t)(BK * LD > BQ * LDP ? BK * LD : BQ * LDP) * 4;
  // q_u, q_v; k, then P; v; the slab; the row maxima [BQ][2]; the keep tile.
  static constexpr size_t kQu = 0, kQv = kTileQ, kK = 2 * kTileQ, kV = kK + kKP,
                          kSlab = kV + (size_t)BK * LD * 4, kRed = kSlab + (size_t)SW * LD * 4,
                          kKeep = kRed + (size_t)BQ * 2 * 4, kBytes = kKeep + (size_t)BQ * BK;
};

// DROP: P is dropped after its undropped value went into l (lse undropped),
// as in rel_flash_fwd_kernel.
template <int DH, bool DROP>
__global__ void __launch_bounds__(kThr, DH == 128 ? 1 : 2)
    fwd_kernel(const float* __restrict__ qu, const float* __restrict__ qv,
               const float* __restrict__ k, const float* __restrict__ v,
               const float* __restrict__ p, const int* __restrict__ lengths,
               float* __restrict__ out, float* __restrict__ lse, int h, int t, float scale,
               int chunk_size, int left_chunks, philox::Dropout drop) {
  using L = FwdLayout<DH>;
  using C = Cols<DH>;
  constexpr int BQ = L::BQ, SW = L::SW, LD = L::LD, LDP = L::LDP, TM = BQ / 16, DV = C::DV;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qus = reinterpret_cast<float*>(smem + L::kQu);
  float* qvs = reinterpret_cast<float*>(smem + L::kQv);
  float* ks = reinterpret_cast<float*>(smem + L::kK);
  float* ps = ks;  // P [BQ][LDP] once the scores are formed
  float* vs = reinterpret_cast<float*>(smem + L::kV);
  float* slab = reinterpret_cast<float*>(smem + L::kSlab);
  float* red = reinterpret_cast<float*>(smem + L::kRed);
  unsigned char* keep = smem + L::kKeep;  // [BQ][BK], DROP only

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int i0 = blockIdx.x * BQ;
  const long base = (long)bh * t * DH;
  const float* pb = p + (long)hh * 2 * t * DH;
  const long cb = (long)t - BQ - i0;  // p row of slab row 0 at key tile 0
  // Key tiles at or past the key length add exact zeros to every row that
  // sees a key; where a row may see none (no key, or a left-chunk window
  // past the keys), all T keys weigh in.
  const int klen = lengths[b];
  const bool seen = klen >= 1 && (chunk_size <= 0 || left_chunks < 0);
  const int nk = ((seen ? min(klen, t) : t) + BK - 1) / BK;
  int ty, tx;
  grid_pos(ty, tx);
  const int half = (threadIdx.x >> 5) & 1;  // which of a row's two warps

  load_rows<DH>(qus, LD, qu + base, i0, BQ, 0, t);
  load_rows<DH>(qvs, LD, qv + base, i0, BQ, 0, t);
  load_rows<DH>(ks, LD, k + base, 0, BK, 0, t);
  load_rows<DH>(slab, LD, pb, cb, SW, 0, 2L * t);
  mma::cp_async_commit();
  load_rows<DH>(vs, LD, v + base, 0, BK, 0, t);
  mma::cp_async_commit();

  int jlo[TM], jhi[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    visible_keys(i0 + ty + 16 * i, klen, chunk_size, left_chunks, jlo[i], jhi[i]);
  }
  const float sl2 = scale * kLog2e, neg2 = kNeg * kLog2e;
  float o[TM][DV], m2[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m2[i] = neg2;
    l[i] = 0.0f;
#pragma unroll
    for (int d = 0; d < DV; ++d) o[i][d] = 0.0f;
  }
  const uint32_t seed = DROP ? (uint32_t)__ldg(drop.seed) : 0u;

  for (int kt = 0; kt < nk; ++kt) {
    const int j0 = kt * BK;
    if constexpr (DROP) {
      philox::fill_keep_tile<BQ, BK>(keep, BK, seed, (uint32_t)bh, (uint32_t)i0, (uint32_t)j0,
                                     drop.thr);
    }
    mma::cp_async_wait<1>();
    __syncthreads();  // k and the slab of tile kt landed (v may still fly)

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
    pair_products<DH, TM, false>(s, s, qus, qvs, nullptr, ks, nullptr, slab, ty, tx);

    // Scores in log2 units, masked; the row maxima over the row's threads.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int jj = j0 + tx + 16 * j;
        float x = -CUDART_INF_F;  // key column past T: not part of the softmax
        if (jj < t) x = jj >= jlo[i] && jj < jhi[i] ? s[i][j] * sl2 : neg2;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      if ((threadIdx.x & 7) == 0) red[(ty + 16 * i) * 2 + half] = mt;
    }
    __syncthreads();  // k and the slab read; the row maxima visible
    if (kt + 1 < nk) load_rows<DH>(slab, LD, pb, cb + j0 + BK, SW, 0, 2L * t);
    mma::cp_async_commit();

    // P = exp2(x - m) into l undropped, into shared memory dropped.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + 16 * i;
      const float m_new = fmaxf(m2[i], fmaxf(red[2 * r], red[2 * r + 1]));
      const float alpha = exp2f(m2[i] - m_new);
      m2[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int d = 0; d < DV; ++d) o[i][d] *= alpha;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tx + 16 * j;
        float pe = exp2f(s[i][j] - m_new);
        l[i] += pe;
        if constexpr (DROP) pe = keep[r * BK + c] ? pe * drop.inv : 0.0f;
        ps[r * LDP + c] = pe;
      }
    }
    mma::cp_async_wait<1>();
    __syncthreads();  // P and v visible
    rows_times<DH, TM>(o, ps, LDP, vs, BK, ty, tx);
    __syncthreads();  // P (k's region) and v read
    if (kt + 1 < nk) load_rows<DH>(ks, LD, k + base, j0 + BK, BK, 0, t);
    mma::cp_async_commit();
    if (kt + 1 < nk) load_rows<DH>(vs, LD, v + base, j0 + BK, BK, 0, t);
    mma::cp_async_commit();
  }

  // l over the row's 16 threads (the last reads of red were before the
  // last tile's "P and v visible" barrier).
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
    if ((threadIdx.x & 7) == 0) red[(ty + 16 * i) * 2 + half] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + 16 * i;
    const float lt = fmaxf(red[2 * r] + red[2 * r + 1], 1e-30f);
#pragma unroll
    for (int d = 0; d < DV; ++d) o[i][d] /= lt;
    if (tx == 0 && i0 + r < t) lse[(long)bh * t + i0 + r] = m2[i] * kLn2 + logf(lt);
  }
  store_rows<DH, TM>(out + base, o, i0, t, ty, tx);
}

template <int DH>
struct DqLayout {
  static constexpr int BQ = bq_bwd<DH>(), SW = BQ + BK, LD = DH + 4, LDS = BK + 8,
                       LDG = SW + 4;
  // q_u, q_v, dO; k, v; the slab; ds; the skewed rawg; the keep tile.
  static constexpr size_t kTileQ = (size_t)BQ * LD * 4, kTileK = (size_t)BK * LD * 4;
  static constexpr size_t kQu = 0, kQv = kTileQ, kDo = 2 * kTileQ, kK = 3 * kTileQ,
                          kV = kK + kTileK, kSlab = kV + kTileK,
                          kDs = kSlab + (size_t)SW * LD * 4, kRawg = kDs + (size_t)BQ * LDS * 4,
                          kKeep = kRawg + (size_t)BQ * LDG * 4, kBytes = kKeep + (size_t)BQ * BK;
};

template <int DH, bool DROP>
__global__ void __launch_bounds__(kThr, 1)
    dq_kernel(const float* __restrict__ qu, const float* __restrict__ qv,
              const float* __restrict__ k, const float* __restrict__ v,
              const float* __restrict__ p, const int* __restrict__ lengths,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dqu, float* __restrict__ dqv,
              int h, int t, float scale, int chunk_size, int left_chunks, philox::Dropout drop) {
  using L = DqLayout<DH>;
  constexpr int BQ = L::BQ, SW = L::SW, LD = L::LD, TM = BQ / 16, DV = Cols<DH>::DV;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qus = reinterpret_cast<float*>(smem + L::kQu);
  float* qvs = reinterpret_cast<float*>(smem + L::kQv);
  float* dos = reinterpret_cast<float*>(smem + L::kDo);
  float* ks = reinterpret_cast<float*>(smem + L::kK);
  float* vs = reinterpret_cast<float*>(smem + L::kV);
  float* slab = reinterpret_cast<float*>(smem + L::kSlab);
  float* dss = reinterpret_cast<float*>(smem + L::kDs);
  float* rawg = reinterpret_cast<float*>(smem + L::kRawg);
  unsigned char* keep = smem + L::kKeep;  // [BQ][BK], DROP only

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int i0 = blockIdx.x * BQ;
  const long base = (long)bh * t * DH;
  const float* pb = p + (long)hh * 2 * t * DH;
  const long cb = (long)t - BQ - i0;
  const int klen = min(lengths[b], t);  // keys at or past T are invisible
  const int nk = (max(klen, 0) + BK - 1) / BK;  // later key tiles have ds = 0
  int ty, tx;
  grid_pos(ty, tx);

  load_rows<DH>(qus, LD, qu + base, i0, BQ, 0, t);
  load_rows<DH>(qvs, LD, qv + base, i0, BQ, 0, t);
  load_rows<DH>(dos, LD, dout + base, i0, BQ, 0, t);
  load_rows<DH>(ks, LD, k + base, 0, BK, 0, t);
  load_rows<DH>(vs, LD, v + base, 0, BK, 0, t);
  load_rows<DH>(slab, LD, pb, cb, SW, 0, 2L * t);
  mma::cp_async_commit();
  // rawg off the band is 0 for every tile: written once.
  for (int idx = threadIdx.x; idx < BQ * L::LDG; idx += kThr) rawg[idx] = 0.0f;

  // The thread's rows: lse in log2 units, delta, visible keys (none for a
  // row past T or a fully masked one).
  int jlo[TM], jhi[TM];
  float lse2[TM], dl[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int ii = i0 + ty + 16 * i;
    const float lv = ii < t ? lse[(long)bh * t + ii] : kNeg;
    dl[i] = ii < t ? delta[(long)bh * t + ii] : 0.0f;
    lse2[i] = lv * kLog2e;
    visible_keys(ii, klen, chunk_size, left_chunks, jlo[i], jhi[i]);
    if (ii >= t || lv < 0.5f * kNeg) jhi[i] = jlo[i];
  }
  const float sl2 = scale * kLog2e;
  float acc_u[TM][DV], acc_v[TM][DV];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int d = 0; d < DV; ++d) acc_u[i][d] = acc_v[i][d] = 0.0f;
  const uint32_t seed = DROP ? (uint32_t)__ldg(drop.seed) : 0u;

  for (int kt = 0; kt < nk; ++kt) {
    const int j0 = kt * BK;
    if constexpr (DROP) {
      philox::fill_keep_tile<BQ, BK>(keep, BK, seed, (uint32_t)bh, (uint32_t)i0, (uint32_t)j0,
                                     drop.thr);
    }
    mma::cp_async_wait<0>();
    __syncthreads();  // tile kt landed; the previous tile's readers are done

    float s[TM][TN], dpv[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = dpv[i][j] = 0.0f;
    pair_products<DH, TM, true>(s, dpv, qus, qvs, dos, ks, vs, slab, ty, tx);
    // ds (PairScores::at) into ds and, skewed, rawg.
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j, jj = j0 + c;
        float ds = 0.0f;
        if (jj >= jlo[i] && jj < jhi[i]) {
          float dpk = dpv[i][j];
          if constexpr (DROP) dpk = keep[r * BK + c] ? dpk * drop.inv : 0.0f;
          ds = exp2f(s[i][j] * sl2 - lse2[i]) * (dpk - dl[i]) * scale;
        }
        dss[r * L::LDS + c] = ds;
        rawg[r * L::LDG + BQ - 1 - r + c] = ds;
      }
    __syncthreads();  // ds and rawg visible; v read
    if (kt + 1 < nk) load_rows<DH>(vs, LD, v + base, j0 + BK, BK, 0, t);
    mma::cp_async_commit();
    rows_times<DH, TM>(acc_u, dss, L::LDS, ks, BK, ty, tx);
    rows_times<DH, TM, BQ>(acc_v, rawg, L::LDG, slab, SW, ty, tx);
    __syncthreads();  // k, the slab, ds and rawg read
    if (kt + 1 < nk) {
      load_rows<DH>(ks, LD, k + base, j0 + BK, BK, 0, t);
      load_rows<DH>(slab, LD, pb, cb + j0 + BK, SW, 0, 2L * t);
    }
    mma::cp_async_commit();
  }
  mma::cp_async_wait<0>();  // the first tile's loads, when no tile ran
  store_rows<DH, TM>(dqu + base, acc_u, i0, t, ty, tx);
  store_rows<DH, TM>(dqv + base, acc_v, i0, t, ty, tx);
}

template <int DH>
struct DkvLayout {
  static constexpr int BQ = bq_bwd<DH>(), SW = BQ + BK, LD = DH + 4, LDT = BQ + 4;
  // k, v; q_u, q_v, dO; the slab; P^T, ds^T, rawg^T; lse, delta; the keep
  // tile.
  static constexpr size_t kTileQ = (size_t)BQ * LD * 4, kTileK = (size_t)BK * LD * 4;
  static constexpr size_t kK = 0, kV = kTileK, kQu = 2 * kTileK, kQv = kQu + kTileQ,
                          kDo = kQv + kTileQ, kSlab = kDo + kTileQ,
                          kPt = kSlab + (size_t)SW * LD * 4, kDst = kPt + (size_t)BK * LDT * 4,
                          kRawgt = kDst + (size_t)BK * LDT * 4,
                          kLse = kRawgt + (size_t)SW * LDT * 4, kDelta = kLse + (size_t)BQ * 4,
                          kKeep = kDelta + (size_t)BQ * 4, kBytes = kKeep + (size_t)BQ * BK;
};

template <int DH, bool DROP>
__global__ void __launch_bounds__(kThr, 1)
    dkv_kernel(const float* __restrict__ qu, const float* __restrict__ qv,
               const float* __restrict__ k, const float* __restrict__ v,
               const float* __restrict__ p, const int* __restrict__ lengths,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
               float* __restrict__ dp, int h, int t, float scale, int chunk_size, int left_chunks,
               philox::Dropout drop) {
  using L = DkvLayout<DH>;
  using C = Cols<DH>;
  constexpr int BQ = L::BQ, SW = L::SW, LD = L::LD, LDT = L::LDT, TM = BQ / 16, DV = C::DV;
  constexpr int NS = SW / 16, NQ = BQ / 16;  // dp slab rows ty + 16 i, i < NS; a shift of NQ
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem + L::kK);
  float* vs = reinterpret_cast<float*>(smem + L::kV);
  float* qus = reinterpret_cast<float*>(smem + L::kQu);
  float* qvs = reinterpret_cast<float*>(smem + L::kQv);
  float* dos = reinterpret_cast<float*>(smem + L::kDo);
  float* slab = reinterpret_cast<float*>(smem + L::kSlab);
  float* pt = reinterpret_cast<float*>(smem + L::kPt);
  float* dst = reinterpret_cast<float*>(smem + L::kDst);
  float* rawgt = reinterpret_cast<float*>(smem + L::kRawgt);
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);
  float* delta_s = reinterpret_cast<float*>(smem + L::kDelta);
  unsigned char* keep = smem + L::kKeep;  // [BQ][BK], DROP only

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int j0 = blockIdx.x * BK;
  const long base = (long)bh * t * DH;
  const float* pb = p + (long)hh * 2 * t * DH;
  float* dpb = dp + (long)hh * 2 * t * DH;
  const PairScores pair{t, 0, j0, lengths[b], chunk_size, left_chunks, scale};
  const int nq = (t + BQ - 1) / BQ;
  int ty, tx;
  grid_pos(ty, tx);
  if (j0 >= pair.klen && pair.klen >= 1 && (chunk_size <= 0 || left_chunks < 0)) {
    // Every row sees a key, none of these: P = ds = 0, so dk = dv = 0 and
    // no dp.
    const float zero[TN][DV] = {};
    store_rows<DH, TN>(dk + base, zero, j0, t, ty, tx);
    store_rows<DH, TN>(dv + base, zero, j0, t, ty, tx);
    return;
  }

  // q_u, q_v, dO, lse and delta of the query tile from row i0.
  auto load_q = [&](int i0) {
    load_rows<DH>(qus, LD, qu + base, i0, BQ, 0, t);
    load_rows<DH>(qvs, LD, qv + base, i0, BQ, 0, t);
    load_rows<DH>(dos, LD, dout + base, i0, BQ, 0, t);
    if (threadIdx.x < 2 * BQ) {
      const int r = threadIdx.x % BQ;
      const float* src = threadIdx.x < BQ ? lse : delta;
      const bool ok = i0 + r < t;
      cp_async4((threadIdx.x < BQ ? lse_s : delta_s) + r, ok ? src + (long)bh * t + i0 + r : src,
                ok);
    }
  };
  load_rows<DH>(ks, LD, k + base, j0, BK, 0, t);
  load_rows<DH>(vs, LD, v + base, j0, BK, 0, t);
  load_q(0);
  load_rows<DH>(slab, LD, pb, (long)t - BQ + j0, SW, 0, 2L * t);
  mma::cp_async_commit();
  // rawg^T off the band is 0 for every tile: written once.
  for (int idx = threadIdx.x; idx < SW * LDT; idx += kThr) rawgt[idx] = 0.0f;

  float acc_k[TN][DV], acc_v[TN][DV], sl[NS][DV];
#pragma unroll
  for (int d = 0; d < DV; ++d) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc_k[j][d] = acc_v[j][d] = 0.0f;
#pragma unroll
    for (int i = 0; i < NS; ++i) sl[i][d] = 0.0f;
  }
  const float sl2 = scale * kLog2e;
  const uint32_t seed = DROP ? (uint32_t)__ldg(drop.seed) : 0u;

  // dp slab row ty + 16 i (p row c0 + ty + 16 i) into dp, then zeroed.
  auto flush = [&](int i, long c0) {
    const long prow = c0 + ty + 16 * i;
#pragma unroll
    for (int m = 0; m < C::NCH; ++m) {
      float val[C::CW];
      bool any = false;
#pragma unroll
      for (int e = 0; e < C::CW; ++e) {
        val[e] = sl[i][C::CW * m + e];
        any = any || val[e] != 0.0f;
        sl[i][C::CW * m + e] = 0.0f;
      }
      if (any && prow >= 0 && prow < 2L * t) red_add_f32<C::CW>(dpb + prow * DH + C::col(m, tx), val);
    }
  };

  for (int qt = 0; qt < nq; ++qt) {
    const int i0 = qt * BQ;
    const long c0 = (long)t - BQ - i0 + j0;
    if constexpr (DROP) {
      philox::fill_keep_tile<BQ, BK>(keep, BK, seed, (uint32_t)bh, (uint32_t)i0, (uint32_t)j0,
                                     drop.thr);
    }
    mma::cp_async_wait<0>();
    __syncthreads();  // tile qt landed; the previous tile's readers are done

    float s[TM][TN], dpv[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = dpv[i][j] = 0.0f;
    pair_products<DH, TM, true>(s, dpv, qus, qvs, dos, ks, vs, slab, ty, tx);
    // P and ds (PairScores::at) into P^T, ds^T and rawg^T.
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int ii = i0 + r, jj = j0 + c;
        float pv = 0.0f, ds = 0.0f;
        if (ii < t && jj < t) {
          const float lv = lse_s[r];
          const bool on = !DROP || keep[r * BK + c];
          if (lv < 0.5f * kNeg) {
            pv = 1.0f / (float)t;  // fully masked row: uniform weights, no ds
          } else if (pair.visible(ii, jj)) {
            float dpk = dpv[i][j];
            if constexpr (DROP) dpk = on ? dpk * drop.inv : 0.0f;
            pv = exp2f(s[i][j] * sl2 - lv * kLog2e);
            ds = pv * (dpk - delta_s[r]) * scale;
          }
          if constexpr (DROP) pv = on ? pv * drop.inv : 0.0f;  // dv takes the dropped P
        }
        pt[c * LDT + r] = pv;
        dst[c * LDT + r] = ds;
        rawgt[(BQ - 1 - r + c) * LDT + r] = ds;
      }
    __syncthreads();  // P^T, ds^T and rawg^T visible; the slab read
    if (qt + 1 < nq) load_rows<DH>(slab, LD, pb, c0 - BQ, SW, 0, 2L * t);
    mma::cp_async_commit();
    rows_times<DH, TN>(acc_v, pt, LDT, dos, BQ, ty, tx);
    rows_times<DH, TN>(acc_k, dst, LDT, qus, BQ, ty, tx);
    rows_times<DH, NS, BQ>(sl, rawgt, LDT, qvs, BQ, ty, tx);
    if (qt + 1 < nq) {
      // Rows [BK, SW) are final; the rest move up BQ rows (NQ slots).
#pragma unroll
      for (int i = BK / 16; i < NS; ++i) flush(i, c0);
#pragma unroll
      for (int i = NS - 1; i >= 0; --i)
#pragma unroll
        for (int d = 0; d < DV; ++d) sl[i][d] = i >= NQ ? sl[i >= NQ ? i - NQ : 0][d] : 0.0f;
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) flush(i, c0);
    }
    __syncthreads();  // q_u, q_v, dO, P^T, ds^T and rawg^T read
    if (qt + 1 < nq) load_q(i0 + BQ);
    mma::cp_async_commit();
  }
  store_rows<DH, TN>(dk + base, acc_k, j0, t, ty, tx);
  store_rows<DH, TN>(dv + base, acc_v, j0, t, ty, tx);
}

// Launches.

// Sets the kernels' shared-memory attributes, once per instantiation;
// returns the bytes.
template <class Kernel>
size_t configure(Kernel no_drop, Kernel drop, size_t bytes) {
  for (auto kernel : {no_drop, drop}) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
  }
  return bytes;
}

template <int DH>
size_t fwd_bytes() {
  static const size_t bytes =
      configure(fwd_kernel<DH, false>, fwd_kernel<DH, true>, FwdLayout<DH>::kBytes);
  return bytes;
}

template <int DH>
size_t dq_bytes() {
  static const size_t bytes =
      configure(dq_kernel<DH, false>, dq_kernel<DH, true>, DqLayout<DH>::kBytes);
  return bytes;
}

template <int DH>
size_t dkv_bytes() {
  static const size_t bytes =
      configure(dkv_kernel<DH, false>, dkv_kernel<DH, true>, DkvLayout<DH>::kBytes);
  return bytes;
}

template <int DH>
int launch_fwd(const void* qu, const void* qv, const void* k, const void* v, const void* p,
               const int* lengths, void* out, float* lse, int b, int h, int t, float scale,
               int chunk_size, int left_chunks, const philox::Dropout& drop, cudaStream_t stream) {
  const size_t bytes = fwd_bytes<DH>();
  auto in = [](const void* x) { return static_cast<const float*>(x); };
  const auto kernel = drop.seed ? fwd_kernel<DH, true> : fwd_kernel<DH, false>;
  kernel<<<dim3((t + FwdLayout<DH>::BQ - 1) / FwdLayout<DH>::BQ, b * h), kThr, bytes, stream>>>(
      in(qu), in(qv), in(k), in(v), in(p), lengths, static_cast<float*>(out), lse, h, t, scale,
      chunk_size, left_chunks, drop);
  return counted("rel_f32::fwd_kernel", DH, drop.seed != nullptr);
}

// dkv, then dq.
template <int DH>
int launch_bwd(const void* qu, const void* qv, const void* k, const void* v, const void* p,
               const int* lengths, const void* dout, const float* lse, const float* delta,
               void* dqu, void* dqv, void* dk, void* dv, float* dp, int b, int h, int t,
               float scale, int chunk_size, int left_chunks, const philox::Dropout& drop,
               cudaStream_t stream) {
  constexpr int BQ = bq_bwd<DH>();
  auto in = [](const void* x) { return static_cast<const float*>(x); };
  auto o = [](void* x) { return static_cast<float*>(x); };
  const size_t kv_bytes = dkv_bytes<DH>();
  const auto kv = drop.seed ? dkv_kernel<DH, true> : dkv_kernel<DH, false>;
  kv<<<dim3((t + BK - 1) / BK, b * h), kThr, kv_bytes, stream>>>(
      in(qu), in(qv), in(k), in(v), in(p), lengths, in(dout), lse, delta, o(dk), o(dv), dp, h, t,
      scale, chunk_size, left_chunks, drop);
  if (int err = counted("rel_f32::dkv_kernel", DH, drop.seed != nullptr)) return err;
  const size_t q_bytes = dq_bytes<DH>();
  const auto kq = drop.seed ? dq_kernel<DH, true> : dq_kernel<DH, false>;
  kq<<<dim3((t + BQ - 1) / BQ, b * h), kThr, q_bytes, stream>>>(
      in(qu), in(qv), in(k), in(v), in(p), lengths, in(dout), lse, delta, o(dqu), o(dqv), h, t,
      scale, chunk_size, left_chunks, drop);
  return counted("rel_f32::dq_kernel", DH, drop.seed != nullptr);
}

// Blocks of the fp32 forward (0), dkv (1) or dq (2) kernel one SM holds.
template <int DH>
int blocks_per_sm(int which) {
  int n = 0;
  if (which == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fwd_kernel<DH, false>, kThr, fwd_bytes<DH>());
  } else if (which == 1) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, dkv_kernel<DH, false>, kThr, dkv_bytes<DH>());
  } else {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, dq_kernel<DH, false>, kThr, dq_bytes<DH>());
  }
  return n;
}

}  // namespace rel_f32

template <typename T, int BQ, int BK, bool DKV>
int launch_rel_flash_bwd_kernel(const void* qu, const void* qv, const void* k, const void* v,
                                const void* p, const int* lengths, const void* dout,
                                const float* lse, const float* delta, void* dq_or_dk,
                                void* dqv_or_dv, float* dp, int b, int h, int t, int dh,
                                float scale, int chunk_size, int left_chunks,
                                const philox::Dropout& drop, cudaStream_t stream) {
  const bool dropping = drop.seed != nullptr;
  const FlashBwdLayout L(dh, BQ, BK, sizeof(T), DKV, dropping);
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (L.total > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
  const T *qut = static_cast<const T*>(qu), *qvt = static_cast<const T*>(qv),
          *kt = static_cast<const T*>(k), *vt = static_cast<const T*>(v),
          *pt = static_cast<const T*>(p), *dot = static_cast<const T*>(dout);
  if constexpr (DKV) {
    auto kk = dropping ? rel_flash_dkv_kernel<T, BQ, BK, true>
                       : rel_flash_dkv_kernel<T, BQ, BK, false>;
    cudaFuncSetAttribute(kk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    kk<<<dim3((t + BK - 1) / BK, b * h), kThreads, L.total, stream>>>(
        qut, qvt, kt, vt, pt, lengths, dot, lse, delta, static_cast<T*>(dq_or_dk),
        static_cast<T*>(dqv_or_dv), dp, h, t, dh, scale, chunk_size, left_chunks, drop);
    return counted("rel_flash_dkv_kernel", type_name<T>(), BQ, BK, dropping);
  } else {
    auto kq = dropping ? rel_flash_dq_kernel<T, BQ, BK, true>
                       : rel_flash_dq_kernel<T, BQ, BK, false>;
    cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    kq<<<dim3((t + BQ - 1) / BQ, b * h), kThreads, L.total, stream>>>(
        qut, qvt, kt, vt, pt, lengths, dot, lse, delta, static_cast<T*>(dq_or_dk),
        static_cast<T*>(dqv_or_dv), h, t, dh, scale, chunk_size, left_chunks, drop);
    return counted("rel_flash_dq_kernel", type_name<T>(), BQ, BK, dropping);
  }
}

// dkv, then dq, with the tiles of rel_flash_dkv_kernel / rel_flash_dq_kernel;
// drop.seed null: the rate-0 instantiations.
template <typename T, int BQ, int BK>
int launch_rel_flash_bwd(const void* qu, const void* qv, const void* k, const void* v,
                         const void* p, const int* lengths, const void* dout, const float* lse,
                         const float* delta, void* dqu, void* dqv, void* dk, void* dv, float* dp,
                         int b, int h, int t, int dh, float scale, int chunk_size,
                         int left_chunks, const philox::Dropout& drop, cudaStream_t stream) {
  if (int err = launch_rel_flash_bwd_kernel<T, BQ, BK, true>(
          qu, qv, k, v, p, lengths, dout, lse, delta, dk, dv, dp, b, h, t, dh, scale,
          chunk_size, left_chunks, drop, stream)) {
    return err;
  }
  return launch_rel_flash_bwd_kernel<T, BQ, BK, false>(qu, qv, k, v, p, lengths, dout, lse,
                                                       delta, dqu, dqv, nullptr, b, h, t, dh,
                                                       scale, chunk_size, left_chunks, drop,
                                                       stream);
}

}  // namespace espnet

// dtype: 0 = float32, 1 = bfloat16. q_u, q_v, k, v, out: [B, H, T, Dh];
// p: [H, 2T, Dh]; lengths: int32 [B]; lse: fp32 [B, H, T]. seed: int32 [1]
// on the device, or null for no dropout; thr = floor(rate * 2^16), inv = 1 /
// (1 - rate). Returns a cudaError_t code (0 = launched).
extern "C" int espnet_rel_flash_fwd(int dtype, const void* qu, const void* qv, const void* k,
                                    const void* v, const void* p, const int* lengths, void* out,
                                    float* lse, int b, int h, int t, int dh, float scale,
                                    int chunk_size, int left_chunks, const int* seed,
                                    unsigned thr, float inv, void* stream) {
  if (b <= 0 || h <= 0 || t <= 0 || dh % 16 || (long)b * h > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  const espnet::philox::Dropout drop{seed, thr, inv};
  if (dtype == 1 && (dh == 64 || dh == 32)) {
    const auto fwd = dh == 64 ? espnet::rel_fwd::launch<64> : espnet::rel_fwd::launch<32>;
    return fwd(qu, qv, k, v, p, lengths, out, lse, b, h, t, scale, chunk_size, left_chunks, drop,
               s);
  }
  if (dtype == 1) {
    return espnet::launch_rel_flash<espnet::bf16, 64, 64>(qu, qv, k, v, p, lengths, out, lse, b, h,
                                                          t, dh, scale, chunk_size, left_chunks,
                                                          drop, s);
  }
  if (dtype == 0 && (dh == 32 || dh == 64 || dh == 128)) {
    const auto fwd = dh == 32   ? espnet::rel_f32::launch_fwd<32>
                     : dh == 64 ? espnet::rel_f32::launch_fwd<64>
                                : espnet::rel_f32::launch_fwd<128>;
    return fwd(qu, qv, k, v, p, lengths, out, lse, b, h, t, scale, chunk_size, left_chunks, drop,
               s);
  }
  if (dtype == 0) {
    return espnet::launch_rel_flash<float, 32, 32>(qu, qv, k, v, p, lengths, out, lse, b, h, t, dh,
                                                   scale, chunk_size, left_chunks, drop, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Backward. dout: [B, H, T, Dh]; lse, delta: fp32 [B, H, T]; dq_u, dq_v, dk,
// dv: [B, H, T, Dh] (the inputs' type); dp: fp32 [H, 2T, Dh], zeroed by the
// caller and accumulated into. seed, thr, inv: the forward's dropout.
// Returns a cudaError_t code (0 = launched).
extern "C" int espnet_rel_flash_bwd(int dtype, const void* qu, const void* qv, const void* k,
                                    const void* v, const void* p, const int* lengths,
                                    const void* dout, const float* lse, const float* delta,
                                    void* dqu, void* dqv, void* dk, void* dv, float* dp, int b,
                                    int h, int t, int dh, float scale, int chunk_size,
                                    int left_chunks, const int* seed, unsigned thr, float inv,
                                    void* stream) {
  if (b <= 0 || h <= 0 || t <= 0 || dh % 16 || (long)b * h > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  const espnet::philox::Dropout drop{seed, thr, inv};
  if (dtype == 1 && (dh == 64 || dh == 32)) {
    const auto dkv = dh == 64 ? espnet::rel_dkv::launch<64> : espnet::rel_dkv::launch<32>;
    const auto dq = dh == 64 ? espnet::rel_dq::launch<64> : espnet::rel_dq::launch<32>;
    if (int err = dkv(qu, qv, k, v, p, lengths, dout, lse, delta, dk, dv, dp, b, h, t, scale,
                      chunk_size, left_chunks, drop, s)) {
      return err;
    }
    return dq(qu, qv, k, v, p, lengths, dout, lse, delta, dqu, dqv, b, h, t, scale, chunk_size,
              left_chunks, drop, s);
  }
  if (dtype == 1) {
    return espnet::launch_rel_flash_bwd<espnet::bf16, 32, 32>(
        qu, qv, k, v, p, lengths, dout, lse, delta, dqu, dqv, dk, dv, dp, b, h, t, dh, scale,
        chunk_size, left_chunks, drop, s);
  }
  if (dtype == 0 && (dh == 32 || dh == 64 || dh == 128)) {
    const auto bwd = dh == 32   ? espnet::rel_f32::launch_bwd<32>
                     : dh == 64 ? espnet::rel_f32::launch_bwd<64>
                                : espnet::rel_f32::launch_bwd<128>;
    return bwd(qu, qv, k, v, p, lengths, dout, lse, delta, dqu, dqv, dk, dv, dp, b, h, t, scale,
               chunk_size, left_chunks, drop, s);
  }
  if (dtype == 0) {
    return espnet::launch_rel_flash_bwd<float, 32, 32>(qu, qv, k, v, p, lengths, dout, lse, delta,
                                                       dqu, dqv, dk, dv, dp, b, h, t, dh, scale,
                                                       chunk_size, left_chunks, drop, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Blocks of the bf16 dkv kernel that one SM holds at once at this Dh (0 where
// that kernel does not take the Dh).
extern "C" int espnet_rel_flash_dkv_blocks_per_sm(int dh) {
  return dh == 64 ? espnet::rel_dkv::blocks_per_sm<64>()
                  : dh == 32 ? espnet::rel_dkv::blocks_per_sm<32>() : 0;
}

// Blocks of the bf16 forward kernel that one SM holds at once at this Dh (0
// where that kernel does not take the Dh).
extern "C" int espnet_rel_flash_fwd_blocks_per_sm(int dh) {
  return dh == 64 ? espnet::rel_fwd::blocks_per_sm<64>()
                  : dh == 32 ? espnet::rel_fwd::blocks_per_sm<32>() : 0;
}

// Blocks of the bf16 dq kernel that one SM holds at once at this Dh (0
// where that kernel does not take the Dh).
extern "C" int espnet_rel_flash_dq_blocks_per_sm(int dh) {
  return dh == 64 ? espnet::rel_dq::blocks_per_sm<64>()
                  : dh == 32 ? espnet::rel_dq::blocks_per_sm<32>() : 0;
}

// Blocks of the fp32 forward (kernel 0), dkv (1) or dq (2) kernel that one
// SM holds at once at this Dh (0 where those kernels do not take the Dh).
extern "C" int espnet_rel_flash_f32_blocks_per_sm(int kernel, int dh) {
  return dh == 32   ? espnet::rel_f32::blocks_per_sm<32>(kernel)
         : dh == 64 ? espnet::rel_f32::blocks_per_sm<64>(kernel)
         : dh == 128 ? espnet::rel_f32::blocks_per_sm<128>(kernel)
                     : 0;
}
