// Relative-position flash attention, forward only:
//   s[i, j] = ((q_u[i] . k[j]) + (q_v[i] . p[(T-1) - i + j])) * scale, masked
//   out[i]  = softmax_j(s[i, :]) . v,   lse[i] = logsumexp_j s[i, :]
// with the key-length mask and the streaming chunk / left-chunk mask built in
// the kernel.
//
// Replaces the TPU kernel espnet_slurp_tpu/ops/pallas/flash_attention.py:
// rel_flash_attention (_fwd_kernel), which runs the self-attention of every
// Conformer block.
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
