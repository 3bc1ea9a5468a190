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
// What bounds it on the H100: at the flagship shape (B = 8, H = 4, T ~ 470,
// Dh = 64, bf16) the three products (q_u k^T, the skewed q_v p^T, P v) are
// ~2.7 GFLOP against ~10 MB of compulsory traffic (q_u, q_v, k, v, p, out,
// lse): ~270 FLOP per byte, close to the ridge, so a fast kernel is bounded
// about equally by memory and by the tensor cores. The plain composition
// writes [B, H, T, T] scores and probabilities and a [B, H, T, 2T-1] position
// score matrix, which is what the TPU kernel was written to avoid.
//
// Design: one block owns BQ query rows of one (batch, head) and streams key
// tiles of BK rows with an online softmax (running max m, sum l, fp32 output
// accumulator in shared memory). The rel-shift never materialises: for a
// (query tile i0, key tile j0) pair, the position rows it needs are the one
// contiguous slab p[c0 : c0 + BQ + BK) with c0 = T - BQ - i0 + j0. The block
// multiplies q_v by that slab into a [BQ, BQ + BK] fp32 tile in shared memory
// and reads bd[i, j] from it at column (BQ - 1) - i + j. Slab rows outside
// [0, 2T) and key/query rows at or past T are zero-filled; key columns at or
// past T are dropped from the softmax, so any T works. No [T, T] or
// [T, 2T - 1] buffer reaches global memory. The simple first version: WMMA bf16
// tiles staged through shared memory, no pipelining; wgmma/TMA come later.
#include "common.cuh"

namespace espnet {

struct FlashLayout {
  size_t qus, qvs, ks, vs, slab, raw, sc, ps, o, m, l, alpha, total;
  __host__ __device__ FlashLayout(int dh, int bq, int bk, int esize) {
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
    total = align128(alpha + (size_t)bq * 4);
  }
};

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    rel_flash_fwd_kernel(const T* __restrict__ qu, const T* __restrict__ qv,
                         const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ p, const int* __restrict__ lengths,
                         T* __restrict__ out, float* __restrict__ lse, int h, int t, int dh,
                         float scale, int chunk_size, int left_chunks) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  const FlashLayout L(dh, BQ, BK, sizeof(T));
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
  const int ld = dh + P, ldraw = BQ + BK + 4, ldsc = BK + 4, ldps = BK + P, ldo = dh + 4;

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int i0 = blockIdx.x * BQ;
  const int klen = lengths[b];
  const long base = (long)bh * t * dh;
  const T* pb = p + (long)hh * 2 * t * dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;

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
        ps[r * ldps + c] = from_f32<T>(e);
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

template <typename T, int BQ, int BK>
int launch_rel_flash(const void* qu, const void* qv, const void* k, const void* v, const void* p,
                     const int* lengths, void* out, float* lse, int b, int h, int t, int dh,
                     float scale, int chunk_size, int left_chunks, cudaStream_t stream) {
  if (b <= 0 || h <= 0 || t <= 0 || dh % 16 || (long)b * h > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const FlashLayout L(dh, BQ, BK, sizeof(T));
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (L.total > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
  auto kernel = rel_flash_fwd_kernel<T, BQ, BK>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  const dim3 grid((t + BQ - 1) / BQ, b * h);
  kernel<<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(qv), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(p), lengths, static_cast<T*>(out), lse, h,
      t, dh, scale, chunk_size, left_chunks);
  return (int)cudaGetLastError();
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
// gradient the plain version's autograd gives.
// The skewed diagonal is scattered, like the forward gathers it, through the
// slab of BQ + BK position rows a (query tile, key tile) pair touches:
// rawg[r, BQ-1-r+c] = ds[r, c], then dq_v += rawg slab and
// dp[slab rows] += rawg^T q_v. Two kernels, as in the reference: dq (query
// tile outer) and dkv (key tile outer). dp is summed over the batch and the
// query tiles with fp32 atomicAdd into [H, 2T, Dh] (so its last bits depend
// on the order the blocks run in); slab rows outside [0, 2T) are dropped.

struct FlashBwdLayout {
  size_t qu, qv, dout, k, v, slab, sc, dpf, raw, t1, t2, t3, acc1, acc2, lse, delta, total;
  __host__ __device__ FlashBwdLayout(int dh, int bq, int bk, int esize, bool dkv) {
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
    total = align128(delta + (size_t)bq * 4);
  }
};

// P and ds of one (query tile i0, key tile j0) pair, from sc = q_u k^T,
// raw = q_v slab^T and dpf = dO v^T (all [BQ, *] fp32 in shared memory).
struct PairScores {
  int t, i0, j0, klen, chunk_size, left_chunks;
  float scale;
  template <int BQ>
  __device__ __forceinline__ void at(const float* sc, int ldsc, const float* raw, int ldraw,
                                     const float* dpf, const float* lse, const float* delta,
                                     int r, int c, float* p_out, float* ds_out) const {
    const int i = i0 + r, j = j0 + c;
    float pv = 0.0f, ds = 0.0f;
    if (i < t && j < t) {
      bool ok = j < klen;
      if (chunk_size > 0) {
        const int cc = j / chunk_size, rc = i / chunk_size;
        ok = ok && cc <= rc;
        if (left_chunks >= 0) ok = ok && cc >= rc - left_chunks;
      }
      const float l = lse[r];
      if (l < 0.5f * kNeg) {
        pv = 1.0f / (float)t;  // fully masked row: uniform weights, no ds
      } else if (ok) {
        const float s = (sc[r * ldsc + c] + raw[r * ldraw + (BQ - 1 - r + c)]) * scale;
        pv = expf(s - l);
        ds = pv * (dpf[r * ldsc + c] - delta[r]) * scale;
      }
    }
    *p_out = pv;
    *ds_out = ds;
  }
};

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    rel_flash_dq_kernel(const T* __restrict__ qu, const T* __restrict__ qv,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ p, const int* __restrict__ lengths,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dqu,
                        T* __restrict__ dqv, int h, int t, int dh, float scale, int chunk_size,
                        int left_chunks) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  constexpr int SW = BQ + BK;
  const FlashBwdLayout L(dh, BQ, BK, sizeof(T), false);
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
        pair.at<BQ>(sc, ldsc, raw, ldraw, dpf, lse_s, delta_s, r, c, &pv, &ds);
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

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    rel_flash_dkv_kernel(const T* __restrict__ qu, const T* __restrict__ qv,
                         const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ p, const int* __restrict__ lengths,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, float* __restrict__ dp, int h, int t, int dh,
                         float scale, int chunk_size, int left_chunks) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  constexpr int SW = BQ + BK;
  const FlashBwdLayout L(dh, BQ, BK, sizeof(T), true);
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
        pair.at<BQ>(sc, ldsc, raw, ldraw, dpf, lse_s, delta_s, r, c, &pv, &ds);
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

template <typename T, int BQ, int BK>
int launch_rel_flash_bwd(const void* qu, const void* qv, const void* k, const void* v,
                         const void* p, const int* lengths, const void* dout, const float* lse,
                         const float* delta, void* dqu, void* dqv, void* dk, void* dv, float* dp,
                         int b, int h, int t, int dh, float scale, int chunk_size,
                         int left_chunks, cudaStream_t stream) {
  const FlashBwdLayout Lq(dh, BQ, BK, sizeof(T), false);
  const FlashBwdLayout Lk(dh, BQ, BK, sizeof(T), true);
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (Lq.total > (size_t)max_smem || Lk.total > (size_t)max_smem) {
    return (int)cudaErrorInvalidConfiguration;
  }
  auto kq = rel_flash_dq_kernel<T, BQ, BK>;
  auto kk = rel_flash_dkv_kernel<T, BQ, BK>;
  cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lq.total);
  cudaFuncSetAttribute(kk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lk.total);
  const T *qut = static_cast<const T*>(qu), *qvt = static_cast<const T*>(qv),
          *kt = static_cast<const T*>(k), *vt = static_cast<const T*>(v),
          *pt = static_cast<const T*>(p), *dot = static_cast<const T*>(dout);
  kk<<<dim3((t + BK - 1) / BK, b * h), kThreads, Lk.total, stream>>>(
      qut, qvt, kt, vt, pt, lengths, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      dp, h, t, dh, scale, chunk_size, left_chunks);
  if (int err = (int)cudaGetLastError()) return err;
  kq<<<dim3((t + BQ - 1) / BQ, b * h), kThreads, Lq.total, stream>>>(
      qut, qvt, kt, vt, pt, lengths, dot, lse, delta, static_cast<T*>(dqu),
      static_cast<T*>(dqv), h, t, dh, scale, chunk_size, left_chunks);
  return (int)cudaGetLastError();
}

inline bool fits(int dh, int bq, int bk, int esize) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return FlashBwdLayout(dh, bq, bk, esize, true).total <= (size_t)max_smem &&
         FlashBwdLayout(dh, bq, bk, esize, false).total <= (size_t)max_smem;
}

}  // namespace espnet

// dtype: 0 = float32, 1 = bfloat16. q_u, q_v, k, v, out: [B, H, T, Dh];
// p: [H, 2T, Dh]; lengths: int32 [B]; lse: fp32 [B, H, T].
// Returns a cudaError_t code (0 = launched).
extern "C" int espnet_rel_flash_fwd(int dtype, const void* qu, const void* qv, const void* k,
                                    const void* v, const void* p, const int* lengths, void* out,
                                    float* lse, int b, int h, int t, int dh, float scale,
                                    int chunk_size, int left_chunks, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return espnet::launch_rel_flash<espnet::bf16, 64, 64>(qu, qv, k, v, p, lengths, out, lse, b, h,
                                                          t, dh, scale, chunk_size, left_chunks, s);
  }
  if (dtype == 0) {
    return espnet::launch_rel_flash<float, 32, 32>(qu, qv, k, v, p, lengths, out, lse, b, h, t, dh,
                                                   scale, chunk_size, left_chunks, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Backward. dout: [B, H, T, Dh]; lse, delta: fp32 [B, H, T]; dq_u, dq_v, dk,
// dv: [B, H, T, Dh] (the inputs' type); dp: fp32 [H, 2T, Dh], zeroed by the
// caller and accumulated into. Returns a cudaError_t code (0 = launched).
extern "C" int espnet_rel_flash_bwd(int dtype, const void* qu, const void* qv, const void* k,
                                    const void* v, const void* p, const int* lengths,
                                    const void* dout, const float* lse, const float* delta,
                                    void* dqu, void* dqv, void* dk, void* dv, float* dp, int b,
                                    int h, int t, int dh, float scale, int chunk_size,
                                    int left_chunks, void* stream) {
  if (b <= 0 || h <= 0 || t <= 0 || dh % 16 || (long)b * h > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (espnet::fits(dh, 64, 64, 2)) {
      return espnet::launch_rel_flash_bwd<espnet::bf16, 64, 64>(
          qu, qv, k, v, p, lengths, dout, lse, delta, dqu, dqv, dk, dv, dp, b, h, t, dh, scale,
          chunk_size, left_chunks, s);
    }
    return espnet::launch_rel_flash_bwd<espnet::bf16, 32, 32>(
        qu, qv, k, v, p, lengths, dout, lse, delta, dqu, dqv, dk, dv, dp, b, h, t, dh, scale,
        chunk_size, left_chunks, s);
  }
  if (dtype == 0) {
    return espnet::launch_rel_flash_bwd<float, 32, 32>(qu, qv, k, v, p, lengths, dout, lse, delta,
                                                       dqu, dqv, dk, dv, dp, b, h, t, dh, scale,
                                                       chunk_size, left_chunks, s);
  }
  return (int)cudaErrorInvalidValue;
}
