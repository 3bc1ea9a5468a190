// Fused Conformer convolution module, forward and backward:
//   out = pw2(swish(LayerNorm(depthwise_k(mask(GLU(pw1(x)))))))
// with every intermediate in fp32 (pw1 and pw2 take x's type with fp32
// accumulation; the swish output is rounded to x's type before pw2).
//
// Replaces the TPU kernel espnet_slurp_tpu/ops/pallas/conv_module.py:
// fused_conv_module (_fwd_kernel via :214, _bwd_kernel via :236), the opt-in
// fused conv module of every Conformer block.
//
// Weights come in PyTorch's layouts, as the port's modules hold them: w1
// [2D, D] and w2 [D, D] (nn.Linear's [out, in]), the depthwise taps [D, k]
// (Conv1d's [D, 1, k]); biases, taps and LayerNorm parameters fp32.
//
// Two routes, by x's type:
//   - bfloat16 (every configuration that runs fused_conv): namespace
//     conv_bf16 below, each product formed once on the mma.sync mainloop of
//     mma_gemm.cuh, the conv and LayerNorm as row-tile passes.
//   - float32 (the fp32 card-against-CPU checks): the first version, next.
//
// ---- float32: the first version ---------------------------------------------
//
// A whole utterance ([468, 256] fp32 = 479 KB) does not fit in a block's 227
// KB of shared memory, so blocks own row tiles of BT frames and recompute
// pw1 + GLU over a halo of k - 1 frames (the depthwise taps' reach), walking
// the 2D pw1 outputs in chunks of BC GLU channels (a and gate rows of w1
// together), each chunk folded into the depthwise sum at once. No [B, T, 2D]
// hidden reaches device memory, in either direction. The backward is four
// kernels, each recomputing what it needs:
//   rows: the forward over the tile, then dsw = g w2, the swish and LayerNorm
//         backward -> dc (fp32 [B, T, D]) and the swish output sw ([B, T, D],
//         x's type) to device memory, and per-tile partial sums of db2,
//         dgamma, dbeta, dbdw;
//   dw2:  dW2 = g^T sw over (output chunk, row split) blocks;
//   dw1:  per (GLU channel chunk, row split): pw1 over the tile's halo,
//         dg = the transposed depthwise conv of dc (read over the halo), du,
//         and dW1 = du^T x, db1 and the tap gradients accumulated in shared
//         memory;
//   dx:   per row tile, walking the channel chunks: du again, dx += du w1.
// The TPU kernel accumulated weight gradients across its sequential grid;
// blocks here run in no order, so each writes fp32 partials that the wrapper
// sums (deterministic, no atomics). The products are plain fp32 FMAs staged
// through shared memory (common.cuh:smem_gemm), with no pipelining.
#include <algorithm>

#include "common.cuh"
#include "mma_gemm.cuh"

namespace espnet {

namespace {

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// Row geometry of a tile of BT frames: the depthwise conv pads pl frames on
// the left and pr = k - 1 - pl on the right. A halo tile starts pl16 rows
// before the tile (pl rounded up to 16, so that the tile's own rows start
// on a WMMA-aligned row) and holds bh rows.
struct ConvGeo {
  int d, k, pl, pr, pl16, bt, bc, bh;
  __host__ __device__ ConvGeo(int d_, int k_, int pl_, int bt_, int bc_)
      : d(d_), k(k_), pl(pl_), pr(k_ - 1 - pl_), pl16(((pl_ + 15) / 16) * 16), bt(bt_), bc(bc_) {
    bh = ((pl16 + bt + pr + 15) / 16) * 16;
  }
};

// Sequential carving of the dynamic shared memory, 128-byte aligned.
struct Carve {
  size_t off = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t o = off;
    off = align128(off + bytes);
    return o;
  }
};

// Shared buffers of the forward recompute (the forward and "rows" kernels).
struct TileLayout {
  size_t xs, ws, us, cs, rstd, gos, dsw, total;
  __host__ __device__ TileLayout(const ConvGeo& g, int esize, bool rows) {
    const int p = 16 / esize;
    Carve c;
    xs = c.take((size_t)g.bh * (g.d + p) * esize);
    const size_t w1c = (size_t)2 * g.bc * (g.d + p) * esize;  // w1 / w2 row chunk
    const size_t w2c = (size_t)g.d * (2 * g.bc + p) * esize;  // w2 column chunk
    ws = c.take(rows && w2c > w1c ? w2c : w1c);
    us = c.take((size_t)g.bh * (2 * g.bc + 4) * 4);
    cs = c.take((size_t)g.bt * (g.d + 4) * 4);
    rstd = c.take((size_t)g.bt * 4);
    gos = rows ? c.take((size_t)g.bt * (g.d + p) * esize) : c.off;
    dsw = rows ? c.take((size_t)g.bt * (g.d + 4) * 4) : c.off;
    total = c.off;
  }
};

// The forward of one tile up to the LayerNorm: x's halo rows into xs, then
// per chunk of BC GLU channels u = x w1_chunk^T (+ b1), g = a * sigmoid(gate)
// masked to rows in [0, len), and the depthwise taps summed into cs. Ends
// with cs holding chat = (c - mean) * rstd and rstd[r] per row.
template <typename T>
__device__ void forward_tile(const ConvGeo& G, const TileLayout& L, unsigned char* smem,
                             const T* xb, const T* w1, const float* b1, const float* wdw,
                             const float* bdw, long r0, int len, int t_len, float eps) {
  constexpr int P = pad_of<T>();
  const int d = G.d, bc = G.bc, k = G.k;
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* ws = reinterpret_cast<T*>(smem + L.ws);
  float* us = reinterpret_cast<float*>(smem + L.us);
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  float* rstd = reinterpret_cast<float*>(smem + L.rstd);
  const int ldx = d + P, ldw = d + P, ldu = 2 * bc + 4, ldc = d + 4;
  const long h0 = r0 - G.pl16;  // frame of xs row 0

  load_rows(xs, ldx, xb, d, h0, G.bh, d, 0, t_len);
  for (int idx = threadIdx.x; idx < G.bt * d; idx += blockDim.x) {
    const int r = idx / d, c = idx - r * d;
    cs[r * ldc + c] = bdw[c];
  }
  for (int j0 = 0; j0 < d; j0 += bc) {
    load_rows(ws, ldw, w1, d, j0, bc, d, 0, 2 * d);
    load_rows(ws + bc * ldw, ldw, w1, d, d + j0, bc, d, 0, 2 * d);
    __syncthreads();
    smem_gemm<true>(xs, ldx, ws, ldw, us, ldu, G.bh, 2 * bc, d, false);
    for (int idx = threadIdx.x; idx < G.bh * bc; idx += blockDim.x) {
      const int r = idx / bc, c = idx - r * bc;
      const long row = h0 + r;
      float gv = 0.0f;
      if (row >= 0 && row < len) {
        gv = (us[r * ldu + c] + b1[j0 + c]) * sigmoidf(us[r * ldu + bc + c] + b1[d + j0 + c]);
      }
      us[r * ldu + c] = gv;
    }
    __syncthreads();
    // c[r] = bdw + sum_j wdw[j] g[r + j - pl]; g row (r0 + r + j - pl) is us
    // row r + j - pl + pl16.
    for (int idx = threadIdx.x; idx < G.bt * bc; idx += blockDim.x) {
      const int r = idx / bc, c = idx - r * bc;
      const float* tap = wdw + (size_t)(j0 + c) * k;
      const float* gcol = us + (r + G.pl16 - G.pl) * ldu + c;
      float s = cs[r * ldc + j0 + c];
      for (int j = 0; j < k; ++j) s += tap[j] * gcol[j * ldu];
      cs[r * ldc + j0 + c] = s;
    }
    __syncthreads();
  }
  // LayerNorm statistics, one warp per row (two passes, fp32).
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int r = warp; r < G.bt; r += nwarps) {
    float* row = cs + r * ldc;
    float s = 0.0f;
    for (int c = lane; c < d; c += 32) s += row[c];
    const float mean = warp_sum(s) / d;
    float v = 0.0f;
    for (int c = lane; c < d; c += 32) v += (row[c] - mean) * (row[c] - mean);
    const float rs = rsqrtf(warp_sum(v) / d + eps);
    for (int c = lane; c < d; c += 32) row[c] = (row[c] - mean) * rs;
    if (lane == 0) rstd[r] = rs;
  }
  __syncthreads();
}

template <typename T, int BT, int BC>
__global__ void __launch_bounds__(kThreads)
    conv_fwd_kernel(const T* __restrict__ x, const int* __restrict__ lengths,
                    const T* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ wdw, const float* __restrict__ bdw,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const T* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ out,
                    int t_len, int d, int k, int pl, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  const ConvGeo G(d, k, pl, BT, BC);
  const TileLayout L(G, sizeof(T), false);
  const int b = blockIdx.y;
  const long r0 = (long)blockIdx.x * BT;
  const int len = min(max(lengths[b], 0), t_len);
  const size_t base = (size_t)b * t_len * d;
  forward_tile<T>(G, L, smem, x + base, w1, b1, wdw, bdw, r0, len, t_len, eps);

  T* sws = reinterpret_cast<T*>(smem + L.xs);  // x's halo is no longer needed
  T* ws = reinterpret_cast<T*>(smem + L.ws);
  float* acc = reinterpret_cast<float*>(smem + L.us);
  const float* cs = reinterpret_cast<const float*>(smem + L.cs);
  const int lds = d + P, ldw = d + P, lda = 2 * BC + 4, ldc = d + 4;
  for (int idx = threadIdx.x; idx < BT * d; idx += blockDim.x) {
    const int r = idx / d, c = idx - r * d;
    const float n = cs[r * ldc + c] * gamma[c] + beta[c];
    sws[r * lds + c] = from_f32<T>(n * sigmoidf(n));
  }
  const int valid = min(BT, t_len - (int)r0);
  for (int o0 = 0; o0 < d; o0 += 2 * BC) {
    load_rows(ws, ldw, w2, d, o0, 2 * BC, d, 0, d);
    __syncthreads();
    smem_gemm<true>(sws, lds, ws, ldw, acc, lda, BT, 2 * BC, d, false);
    for (int idx = threadIdx.x; idx < valid * 2 * BC; idx += blockDim.x) {
      const int r = idx / (2 * BC), c = idx - r * (2 * BC);
      out[base + (size_t)(r0 + r) * d + o0 + c] = from_f32<T>(acc[r * lda + c] + b2[o0 + c]);
    }
  }
}

// ---- Backward ---------------------------------------------------------------

// Per row tile: the forward again, then dsw = go w2, dn = dsw * swish'(n),
// the LayerNorm backward dc = rstd (dchat - mean(dchat) - chat mean(dchat
// chat)) with dchat = dn gamma. Writes dc (fp32) and sw (x's type) for the
// tile's frames, and the tile's sums over its frames of go, dn chat, dn and
// dc into vecp[tile][0..3][:] (db2, dgamma, dbeta, dbdw partials).
template <typename T, int BT, int BC>
__global__ void __launch_bounds__(kThreads)
    conv_bwd_rows_kernel(const T* __restrict__ x, const int* __restrict__ lengths,
                         const T* __restrict__ w1, const float* __restrict__ b1,
                         const float* __restrict__ wdw, const float* __restrict__ bdw,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         const T* __restrict__ w2, const T* __restrict__ go,
                         float* __restrict__ dc_out, T* __restrict__ sw_out,
                         float* __restrict__ vecp, int t_len, int d, int k, int pl, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  const ConvGeo G(d, k, pl, BT, BC);
  const TileLayout L(G, sizeof(T), true);
  const int b = blockIdx.y;
  const long r0 = (long)blockIdx.x * BT;
  const int len = min(max(lengths[b], 0), t_len);
  const size_t base = (size_t)b * t_len * d;
  const int valid = min(BT, t_len - (int)r0);
  forward_tile<T>(G, L, smem, x + base, w1, b1, wdw, bdw, r0, len, t_len, eps);

  T* ws = reinterpret_cast<T*>(smem + L.ws);
  float* cs = reinterpret_cast<float*>(smem + L.cs);  // chat
  const float* rstd = reinterpret_cast<const float*>(smem + L.rstd);
  T* gos = reinterpret_cast<T*>(smem + L.gos);
  float* dsw = reinterpret_cast<float*>(smem + L.dsw);
  const int ldc = d + 4, ldg = d + P, ldw = 2 * BC + P;
  load_rows(gos, ldg, go + base, d, r0, BT, d, 0, t_len);
  for (int idx = threadIdx.x; idx < valid * d; idx += blockDim.x) {
    const int r = idx / d, c = idx - r * d;
    const float n = cs[r * ldc + c] * gamma[c] + beta[c];
    sw_out[base + (size_t)(r0 + r) * d + c] = from_f32<T>(n * sigmoidf(n));
  }
  for (int i0 = 0; i0 < d; i0 += 2 * BC) {
    __syncthreads();  // the previous chunk's product is done with ws
    load_rows(ws, ldw, w2 + i0, d, 0, d, 2 * BC, 0, d);
    __syncthreads();
    smem_gemm<false>(gos, ldg, ws, ldw, dsw + i0, ldc, BT, 2 * BC, d, false);
  }
  // dn = dsw * swish'(n), swish'(n) = s (1 + n (1 - s)), in place.
  for (int idx = threadIdx.x; idx < BT * d; idx += blockDim.x) {
    const int r = idx / d, c = idx - r * d;
    const float n = cs[r * ldc + c] * gamma[c] + beta[c];
    const float s = sigmoidf(n);
    dsw[r * ldc + c] *= s * (1.0f + n * (1.0f - s));
  }
  __syncthreads();
  float* vp = vecp + (size_t)(b * gridDim.x + blockIdx.x) * 4 * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float sg = 0.0f, sdg = 0.0f, sdb = 0.0f;
    for (int r = 0; r < valid; ++r) {
      sg += to_f32(gos[r * ldg + c]);
      sdg += dsw[r * ldc + c] * cs[r * ldc + c];
      sdb += dsw[r * ldc + c];
    }
    vp[c] = sg;
    vp[d + c] = sdg;
    vp[2 * d + c] = sdb;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int r = warp; r < BT; r += nwarps) {
    float* dn = dsw + r * ldc;
    const float* ch = cs + r * ldc;
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float dch = dn[c] * gamma[c];
      s1 += dch;
      s2 += dch * ch[c];
    }
    const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
    for (int c = lane; c < d; c += 32) {
      dn[c] = rstd[r] * (dn[c] * gamma[c] - m1 - ch[c] * m2);  // dc
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.0f;
    for (int r = 0; r < valid; ++r) s += dsw[r * ldc + c];
    vp[3 * d + c] = s;
  }
  for (int idx = threadIdx.x; idx < valid * d; idx += blockDim.x) {
    const int r = idx / d, c = idx - r * d;
    dc_out[base + (size_t)(r0 + r) * d + c] = dsw[r * ldc + c];
  }
}

// dW2[o, i] = sum_rows go[row, o] sw[row, i]: block (chunk of OC outputs,
// row split) over the N = B*T rows in tiles of BM; fp32 partials per split.
struct Dw2Layout {
  size_t got, sws, acc, total;
  __host__ __device__ Dw2Layout(int d, int bm, int oc, int esize) {
    const int p = 16 / esize;
    Carve c;
    got = c.take((size_t)oc * (bm + p) * esize);
    sws = c.take((size_t)bm * (d + p) * esize);
    acc = c.take((size_t)oc * (d + 4) * 4);
    total = c.off;
  }
};

template <typename T, int BM, int OC>
__global__ void __launch_bounds__(kThreads)
    conv_bwd_dw2_kernel(const T* __restrict__ go, const T* __restrict__ sw,
                        float* __restrict__ dw2p, long n, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  const Dw2Layout L(d, BM, OC, sizeof(T));
  T* got = reinterpret_cast<T*>(smem + L.got);
  T* sws = reinterpret_cast<T*>(smem + L.sws);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  const int ldt = BM + P, lds = d + P, lda = d + 4;
  const int o0 = blockIdx.x * OC;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const long ntiles = (n + BM - 1) / BM;
  for (int idx = threadIdx.x; idx < OC * d; idx += blockDim.x) {
    acc[(idx / d) * lda + idx % d] = 0.0f;
  }
  for (long tile = split; tile < ntiles; tile += nsplit) {
    const long row0 = tile * BM;
    __syncthreads();  // the previous tile's product is done
    load_rows(sws, lds, sw, d, row0, BM, d, 0, n);
    for (int idx = threadIdx.x; idx < BM * OC; idx += blockDim.x) {
      const int r = idx / OC, c = idx - r * OC;
      got[c * ldt + r] = row0 + r < n ? go[(row0 + r) * d + o0 + c] : from_f32<T>(0.0f);
    }
    __syncthreads();
    smem_gemm<false>(got, ldt, sws, lds, acc, lda, OC, d, BM, true);
  }
  for (int idx = threadIdx.x; idx < OC * d; idx += blockDim.x) {
    const int c = idx / d, i = idx - c * d;
    dw2p[((size_t)split * d + o0 + c) * d + i] = acc[c * lda + i];
  }
}

// dg[s] = sum_j wdw[j] dc[s - j + pl] (the transposed depthwise conv; dc
// outside [0, T) is 0), masked to s < len, then du = (dg sigmoid(gate),
// dg a sigmoid(gate) (1 - sigmoid(gate))). dch holds dc rows from r0 - pr.
__device__ __forceinline__ void glu_backward(float dg, float a, float s, float* da,
                                             float* dgate) {
  *da = dg * s;
  *dgate = dg * a * s * (1.0f - s);
}

struct Dw1Layout {
  size_t ws, xs, us, gb, dch, dub, dut, acc, db1, dwdw, total;
  __host__ __device__ Dw1Layout(const ConvGeo& g, int esize) {
    const int p = 16 / esize;
    Carve c;
    ws = c.take((size_t)2 * g.bc * (g.d + p) * esize);
    xs = c.take((size_t)g.bh * (g.d + p) * esize);
    us = c.take((size_t)g.bh * (2 * g.bc + 4) * 4);
    gb = c.take((size_t)g.bh * (g.bc + 4) * 4);
    dch = c.take((size_t)(g.bt + g.k - 1) * (g.bc + 4) * 4);
    dub = c.take((size_t)g.bt * (2 * g.bc + 4) * 4);
    dut = c.take((size_t)2 * g.bc * (g.bt + p) * esize);
    acc = c.take((size_t)2 * g.bc * (g.d + 4) * 4);
    db1 = c.take((size_t)2 * g.bc * 4);
    dwdw = c.take((size_t)g.bc * g.k * 4);
    total = c.off;
  }
};

// Block (GLU channel chunk j0.., row split): over its row tiles of every
// utterance, pw1 over the tile's halo, du at the tile's frames, and
//   dW1[j0.., :] += du^T x (the a rows and the gate rows), db1 += sum du,
//   dwdw[c, j] += sum_t dc[t, c] g[t + j - pl, c],
// written as fp32 partials of this split.
template <typename T, int BT, int BC>
__global__ void __launch_bounds__(kThreads)
    conv_bwd_dw1_kernel(const T* __restrict__ x, const int* __restrict__ lengths,
                        const T* __restrict__ w1, const float* __restrict__ b1,
                        const float* __restrict__ wdw, const float* __restrict__ dc,
                        float* __restrict__ dw1p, float* __restrict__ db1p,
                        float* __restrict__ dwdwp, int nb, int t_len, int d, int k, int pl) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  const ConvGeo G(d, k, pl, BT, BC);
  const Dw1Layout L(G, sizeof(T));
  T* ws = reinterpret_cast<T*>(smem + L.ws);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  float* us = reinterpret_cast<float*>(smem + L.us);
  float* gb = reinterpret_cast<float*>(smem + L.gb);
  float* dch = reinterpret_cast<float*>(smem + L.dch);
  float* dub = reinterpret_cast<float*>(smem + L.dub);
  T* dut = reinterpret_cast<T*>(smem + L.dut);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* db1 = reinterpret_cast<float*>(smem + L.db1);
  float* dwdw = reinterpret_cast<float*>(smem + L.dwdw);
  const int ldw = d + P, ldx = d + P, ldu = 2 * BC + 4, ldg = BC + 4, ldt = BT + P, lda = d + 4;
  const int j0 = blockIdx.x * BC;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int tiles_per_row = (t_len + BT - 1) / BT;
  const int ntiles = nb * tiles_per_row;

  for (int idx = threadIdx.x; idx < 2 * BC * d; idx += blockDim.x) {
    acc[(idx / d) * lda + idx % d] = 0.0f;
  }
  for (int i = threadIdx.x; i < 2 * BC; i += blockDim.x) db1[i] = 0.0f;
  for (int i = threadIdx.x; i < BC * k; i += blockDim.x) dwdw[i] = 0.0f;
  load_rows(ws, ldw, w1, d, j0, BC, d, 0, 2 * d);
  load_rows(ws + BC * ldw, ldw, w1, d, d + j0, BC, d, 0, 2 * d);
  for (int tile = split; tile < ntiles; tile += nsplit) {
    const int b = tile / tiles_per_row;
    const long r0 = (long)(tile - b * tiles_per_row) * BT;
    const int len = min(max(lengths[b], 0), t_len);
    const size_t base = (size_t)b * t_len * d;
    const long h0 = r0 - G.pl16;
    const int valid = min(BT, t_len - (int)r0);
    __syncthreads();  // the previous tile's readers are done
    load_rows(xs, ldx, x + base, d, h0, G.bh, d, 0, t_len);
    load_rows(dch, ldg, dc + base + j0, d, r0 - G.pr, BT + k - 1, BC, 0, t_len);
    __syncthreads();
    smem_gemm<true>(xs, ldx, ws, ldw, us, ldu, G.bh, 2 * BC, d, false);
    // us <- (a, sigmoid(gate)); gb <- g masked to [0, len).
    for (int idx = threadIdx.x; idx < G.bh * BC; idx += blockDim.x) {
      const int r = idx / BC, c = idx - r * BC;
      const long row = h0 + r;
      const float a = us[r * ldu + c] + b1[j0 + c];
      const float s = sigmoidf(us[r * ldu + BC + c] + b1[d + j0 + c]);
      us[r * ldu + c] = a;
      us[r * ldu + BC + c] = s;
      gb[r * ldg + c] = (row >= 0 && row < len) ? a * s : 0.0f;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BT * BC; idx += blockDim.x) {
      const int r = idx / BC, c = idx - r * BC;
      const float* tap = wdw + (size_t)(j0 + c) * k;
      float dg = 0.0f;
      if (r0 + r < len) {
        for (int j = 0; j < k; ++j) dg += tap[j] * dch[(r - j + k - 1) * ldg + c];
      }
      const int ur = r + G.pl16;
      float da, dgt;
      glu_backward(dg, us[ur * ldu + c], us[ur * ldu + BC + c], &da, &dgt);
      dub[r * ldu + c] = da;
      dub[r * ldu + BC + c] = dgt;
      dut[c * ldt + r] = from_f32<T>(da);
      dut[(BC + c) * ldt + r] = from_f32<T>(dgt);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < 2 * BC; c += blockDim.x) {
      float s = 0.0f;
      for (int r = 0; r < valid; ++r) s += dub[r * ldu + c];
      db1[c] += s;
    }
    for (int idx = threadIdx.x; idx < BC * k; idx += blockDim.x) {
      const int c = idx / k, j = idx - c * k;
      float s = 0.0f;
      for (int r = 0; r < valid; ++r) {
        s += dch[(r + G.pr) * ldg + c] * gb[(r + G.pl16 - G.pl + j) * ldg + c];
      }
      dwdw[idx] += s;
    }
    smem_gemm<false>(dut, ldt, xs + G.pl16 * ldx, ldx, acc, lda, 2 * BC, d, BT, true);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 2 * BC * d; idx += blockDim.x) {
    const int c = idx / d, i = idx - c * d;
    const int row = c < BC ? j0 + c : d + j0 + (c - BC);
    dw1p[((size_t)split * 2 * d + row) * d + i] = acc[c * lda + i];
  }
  for (int c = threadIdx.x; c < 2 * BC; c += blockDim.x) {
    db1p[(size_t)split * 2 * d + (c < BC ? j0 + c : d + j0 + c - BC)] = db1[c];
  }
  for (int idx = threadIdx.x; idx < BC * k; idx += blockDim.x) {
    dwdwp[((size_t)split * d + j0) * k + idx] = dwdw[idx];
  }
}

struct DxLayout {
  size_t xs, ws, us, dch, dus, acc, total;
  __host__ __device__ DxLayout(const ConvGeo& g, int esize) {
    const int p = 16 / esize;
    Carve c;
    xs = c.take((size_t)g.bt * (g.d + p) * esize);
    ws = c.take((size_t)2 * g.bc * (g.d + p) * esize);
    us = c.take((size_t)g.bt * (2 * g.bc + 4) * 4);
    dch = c.take((size_t)(g.bt + g.k - 1) * (g.bc + 4) * 4);
    dus = c.take((size_t)g.bt * (2 * g.bc + p) * esize);
    acc = c.take((size_t)g.bt * (g.d + 4) * 4);
    total = c.off;
  }
};

// Per row tile, walking the GLU channel chunks: u at the tile's frames, du
// as in the dw1 kernel, dx += du w1_chunk.
template <typename T, int BT, int BC>
__global__ void __launch_bounds__(kThreads)
    conv_bwd_dx_kernel(const T* __restrict__ x, const int* __restrict__ lengths,
                       const T* __restrict__ w1, const float* __restrict__ b1,
                       const float* __restrict__ wdw, const float* __restrict__ dc,
                       T* __restrict__ dx, int t_len, int d, int k, int pl) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  const ConvGeo G(d, k, pl, BT, BC);
  const DxLayout L(G, sizeof(T));
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* ws = reinterpret_cast<T*>(smem + L.ws);
  float* us = reinterpret_cast<float*>(smem + L.us);
  float* dch = reinterpret_cast<float*>(smem + L.dch);
  T* dus = reinterpret_cast<T*>(smem + L.dus);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  const int ldx = d + P, ldw = d + P, ldu = 2 * BC + 4, ldg = BC + 4, ldd = 2 * BC + P,
            lda = d + 4;
  const int b = blockIdx.y;
  const long r0 = (long)blockIdx.x * BT;
  const int len = min(max(lengths[b], 0), t_len);
  const size_t base = (size_t)b * t_len * d;
  load_rows(xs, ldx, x + base, d, r0, BT, d, 0, t_len);
  for (int j0 = 0; j0 < d; j0 += BC) {
    load_rows(ws, ldw, w1, d, j0, BC, d, 0, 2 * d);
    load_rows(ws + BC * ldw, ldw, w1, d, d + j0, BC, d, 0, 2 * d);
    load_rows(dch, ldg, dc + base + j0, d, r0 - G.pr, BT + k - 1, BC, 0, t_len);
    __syncthreads();
    smem_gemm<true>(xs, ldx, ws, ldw, us, ldu, BT, 2 * BC, d, false);
    for (int idx = threadIdx.x; idx < BT * BC; idx += blockDim.x) {
      const int r = idx / BC, c = idx - r * BC;
      const float* tap = wdw + (size_t)(j0 + c) * k;
      float dg = 0.0f;
      if (r0 + r < len) {
        for (int j = 0; j < k; ++j) dg += tap[j] * dch[(r - j + k - 1) * ldg + c];
      }
      float da, dgt;
      glu_backward(dg, us[r * ldu + c] + b1[j0 + c],
                   sigmoidf(us[r * ldu + BC + c] + b1[d + j0 + c]), &da, &dgt);
      dus[r * ldd + c] = from_f32<T>(da);
      dus[r * ldd + BC + c] = from_f32<T>(dgt);
    }
    __syncthreads();
    smem_gemm<false>(dus, ldd, ws, ldw, acc, lda, BT, d, 2 * BC, j0 > 0);
  }
  const int valid = min(BT, t_len - (int)r0);
  for (int idx = threadIdx.x; idx < valid * d; idx += blockDim.x) {
    const int r = idx / d, c = idx - r * d;
    dx[base + (size_t)(r0 + r) * d + c] = from_f32<T>(acc[r * lda + c]);
  }
}

int max_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > (size_t)max_smem()) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// Tile sizes of the float32 route: <forward BT, rows BT, dx BT, BC, dw2 BM>.
template <typename T>
struct Tiles;
template <>
struct Tiles<float> {
  static constexpr int kFwd = 32, kRows = 16, kDx = 32, kBc = 16, kBm = 16;
};

template <typename T>
int launch_fwd(const void* x, const int* lengths, const void* w1, const float* b1,
               const float* wdw, const float* bdw, const float* gamma, const float* beta,
               const void* w2, const float* b2, void* out, int nb, int t, int d, int k, int pl,
               float eps, cudaStream_t stream) {
  using S = Tiles<T>;
  const ConvGeo G(d, k, pl, S::kFwd, S::kBc);
  const TileLayout L(G, sizeof(T), false);
  auto kern = conv_fwd_kernel<T, S::kFwd, S::kBc>;
  if (int err = prepare(kern, L.total)) return err;
  kern<<<dim3((t + S::kFwd - 1) / S::kFwd, nb), kThreads, L.total, stream>>>(
      static_cast<const T*>(x), lengths, static_cast<const T*>(w1), b1, wdw, bdw, gamma, beta,
      static_cast<const T*>(w2), b2, static_cast<T*>(out), t, d, k, pl, eps);
  return counted(Counted::kConvFwdF32);
}

template <typename T>
int launch_bwd(const void* x, const int* lengths, const void* w1, const float* b1,
               const float* wdw, const float* bdw, const float* gamma, const float* beta,
               const void* w2, const void* go, void* dx, float* dc, void* sw, float* vecp,
               float* dw1p, float* db1p, float* dwdwp, float* dw2p, int nsplit, int nb, int t,
               int d, int k, int pl, float eps, cudaStream_t stream) {
  using S = Tiles<T>;
  const T* xt = static_cast<const T*>(x);
  const T* w1t = static_cast<const T*>(w1);
  {
    const ConvGeo G(d, k, pl, S::kRows, S::kBc);
    const TileLayout L(G, sizeof(T), true);
    auto kern = conv_bwd_rows_kernel<T, S::kRows, S::kBc>;
    if (int err = prepare(kern, L.total)) return err;
    kern<<<dim3((t + S::kRows - 1) / S::kRows, nb), kThreads, L.total, stream>>>(
        xt, lengths, w1t, b1, wdw, bdw, gamma, beta, static_cast<const T*>(w2),
        static_cast<const T*>(go), dc, static_cast<T*>(sw), vecp, t, d, k, pl, eps);
    if (int err = counted(Counted::kConvRowsF32)) return err;
  }
  {
    const Dw2Layout L(d, S::kBm, 2 * S::kBc, sizeof(T));
    auto kern = conv_bwd_dw2_kernel<T, S::kBm, 2 * S::kBc>;
    if (int err = prepare(kern, L.total)) return err;
    kern<<<dim3(d / (2 * S::kBc), nsplit), kThreads, L.total, stream>>>(
        static_cast<const T*>(go), static_cast<const T*>(sw), dw2p, (long)nb * t, d);
    if (int err = counted(Counted::kConvDw2F32)) return err;
  }
  {
    const ConvGeo G(d, k, pl, S::kRows, S::kBc);
    const Dw1Layout L(G, sizeof(T));
    auto kern = conv_bwd_dw1_kernel<T, S::kRows, S::kBc>;
    if (int err = prepare(kern, L.total)) return err;
    kern<<<dim3(d / S::kBc, nsplit), kThreads, L.total, stream>>>(
        xt, lengths, w1t, b1, wdw, dc, dw1p, db1p, dwdwp, nb, t, d, k, pl);
    if (int err = counted(Counted::kConvDw1F32)) return err;
  }
  {
    const ConvGeo G(d, k, pl, S::kDx, S::kBc);
    const DxLayout L(G, sizeof(T));
    auto kern = conv_bwd_dx_kernel<T, S::kDx, S::kBc>;
    if (int err = prepare(kern, L.total)) return err;
    kern<<<dim3((t + S::kDx - 1) / S::kDx, nb), kThreads, L.total, stream>>>(
        xt, lengths, w1t, b1, wdw, dc, static_cast<T*>(dx), t, d, k, pl);
  }
  return counted(Counted::kConvDxF32);
}

bool bad_shape(int nb, int t, int d, int k, int pl) {
  return nb <= 0 || t <= 0 || d <= 0 || d % 64 || k <= 0 || pl < 0 || pl > k - 1;
}

}  // namespace

// ---- bfloat16: each product once, on the mma.sync mainloop ------------------
//
// Replaces espnet_slurp_tpu/ops/pallas/conv_module.py:_fwd_kernel and
// _bwd_kernel (the pallas_calls at :214 and :236) in bfloat16, with the
// reference's rounding points: the swish output sw is rounded to bf16 before
// pw2 and before dW2, the cotangent go is bf16, du is rounded before dx and
// dW1 (db1 sums it unrounded), and every other value is fp32.
//
// Bound: the tensor cores, barely. At the transducer step (N = 32 x 468
// rows, D 256, k 31) the forward's two products are 5.9 GFLOP (0.006 ms at
// 989 TFLOP/s) and its taps 0.24 GFLOP of fp32 FMAs (0.0036 ms at 67); the
// backward forms five products (pw1 again, dsw, dx, dW1, dW2: 13.7 GFLOP)
// and two tap passes. The compulsory traffic (x, go, out or dx, weights) is
// ~15-23 MB, 0.005-0.007 ms at 3.35 TB/s.
//
// Design. The TPU kernel kept one utterance in VMEM and recomputed pw1 for
// it; here no product is formed twice. pw1 is one GEMM over the N = B T rows
// with no halo, and what follows it runs per row tile of BT frames, reading
// its k - 1 frames of halo from fp32 scratch that lives for the call (g, sig
// and dc: 15.3 MB each at the transducer shape, read back mostly from L2):
//   forward
//     glu_kernel      g = mask(a sigmoid(gate)) from x W1^T on 128 x 128
//                     tiles; W1's rows enter the B tile interleaved per n8
//                     tile (8 a channels, then their 8 gate channels), so a
//                     thread holds a and gate of one channel in acc[i][2q]
//                     and acc[i][2q + 1] and the GLU runs in the epilogue.
//     out_kernel      per row tile: g's halo by cp.async, the depthwise taps
//                     in registers walking R frames at a time in place,
//                     LayerNorm and swish (a warp a row) into a bf16 A tile
//                     in shared memory, then pw2 with only W2 streamed
//                     through the ring (Gemm::run_ra), + b2.
//   backward
//     glu_sig_kernel  glu_kernel that also keeps sigmoid(gate).
//     rows_kernel     per row tile: dsw = go W2 on the mainloop, kept in
//                     its accumulators; g's halo in the ring's place, the
//                     conv and LayerNorm again, then in the accumulators'
//                     layout sw (bf16 to device memory, for dW2), dn = dsw
//                     swish'(n) and the LayerNorm backward dc (fp32 to
//                     device memory); the tile's sums of go, dn chat, dn, dc
//                     and the tap gradient dwdw[c, j] = sum_t dc[t, c]
//                     g[t + j - pl, c] (a thread a channel, 32 taps in
//                     registers, g from shared memory).
//     du_kernel       per row tile: the transposed conv of dc's halo, the
//                     mask and the GLU backward; du (bf16 [N, 2D]) and the
//                     tile's unrounded column sums (db1).
//     dx_kernel       dx = du W1 on 128 x 128 tiles.
//     dw_kernel       dW1 = du^T x and dW2 = go^T sw as 128 x 128 tiles over
//                     splits of N (fp32 partials per split).
//     sum_kernel      every partial sum over its tiles or splits, in a fixed
//                     order (deterministic, no float atomics); dW1 and dW2
//                     rounded to bf16.
// Every launch counts itself on the host (common.cuh:Counted).

namespace conv_bf16 {

using mma::Gemm;
using mma::Major;
constexpr int kThreads = 256;
constexpr int BT = 32;  // frames of an out / rows / du row tile
constexpr int R = 8;    // output frames one thread's tap walk holds
constexpr int KC = 32;  // taps one walk holds in registers
constexpr int kTile = 128;
// x [N, D] . W1 [2D, D]^T, the 2D columns interleaved (GluRows).
using Glu = Gemm<kTile, kTile, 32, 64, 32, 4, Major::K, Major::K>;
// sw [BT, D] (resident) . W2 [D, D]^T, 256 output columns a pass.
using Pw2 = Gemm<BT, 256, 32, 32, 32, 3, Major::K, Major::K>;
// go [BT, D] . W2 [D, D], 256 columns a pass.
using Dsw = Gemm<BT, 256, 32, 32, 32, 3, Major::K, Major::MN>;
// du [N, 2D] . W1 [2D, D].
using Dx = Gemm<kTile, kTile, 32, 64, 32, 4, Major::K, Major::MN>;
// du^T [2D, N] . x [N, D] and go^T [D, N] . sw [N, D].
using Dw = Gemm<kTile, kTile, 32, 64, 32, 4, Major::MN, Major::MN>;
static_assert(Glu::kThreads == kThreads && Pw2::kThreads == kThreads &&
                  Dsw::kThreads == kThreads && Dx::kThreads == kThreads &&
                  Dw::kThreads == kThreads,
              "one block shape");
static_assert(BT % R == 0 && Glu::NT % 2 == 0, "tile shapes");

__host__ __device__ constexpr long cdiv(long a, long b) { return (a + b - 1) / b; }

// Rows of a halo tile: BT frames and the taps' reach, rounded up to whole
// chunks of KC taps (a walk reads KC - 1 rows past its last frame).
__host__ __device__ inline int halo_rows(int k) { return BT + (int)cdiv(k, KC) * KC; }
__host__ __device__ inline size_t halo_bytes(int d, int k) {
  return (size_t)halo_rows(k) * d * sizeof(float);
}
// Tiles read or written in the mainloop's fragment layout are padded by 8
// elements a row (the 8 rows of a fragment store fall in distinct banks).
__host__ __device__ inline int ld_tile(int d) { return d + 8; }

// Dynamic shared memory of out_kernel: the halo, reused as the ring, then
// the bf16 sw tile.
struct OutSmem {
  size_t sw, total;
  __host__ __device__ OutSmem(int d, int k) {
    const size_t halo = halo_bytes(d, k);
    sw = align128(halo > Pw2::kSmemBytesB ? halo : Pw2::kSmemBytesB);
    total = sw + align128((size_t)BT * ld_tile(d) * sizeof(bf16));
  }
};

// rows_kernel: the ring, then the halo in its place; c then chat then dc;
// the warps' row sums; rstd.
struct RowsSmem {
  size_t c, red, rstd, total;
  __host__ __device__ RowsSmem(int d, int k) {
    const size_t halo = halo_bytes(d, k);
    c = align128(halo > Dsw::kSmemBytes ? halo : Dsw::kSmemBytes);
    red = c + align128((size_t)BT * ld_tile(d) * sizeof(float));
    rstd = red + align128((size_t)(kThreads / 32) * BT * 2 * sizeof(float));
    total = rstd + align128(BT * sizeof(float));
  }
};

__host__ __device__ inline size_t du_smem(int d, int k) { return halo_bytes(d, k); }

// Tile row n of the interleaved B operand -> W1's row: n = 16 p + 8 h + x
// is channel 8 p + x of the a half (h = 0) or of the gate half (h = 1).
struct GluRows {
  long d;
  __device__ __forceinline__ long operator()(long n) const {
    return (n >> 4) * 8 + (n & 7) + ((n >> 3) & 1) * d;
  }
};

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ int valid_len(const int* lengths, int b, int t_len) {
  return min(max(__ldg(lengths + b), 0), t_len);
}

// Rows h < rows of a halo tile at hs (d floats a row) <- frames f0 + h of
// one utterance's [T, D] fp32 src; frames outside [0, T) and rows h >= hmax
// read as zero. Commits one cp.async group.
__device__ __forceinline__ void load_halo(float* hs, const float* src, long f0, int hmax,
                                          int rows, int t_len, int d) {
  const int vpr = d / 4;
  for (int idx = threadIdx.x; idx < rows * vpr; idx += kThreads) {
    const int h = idx / vpr, c = (idx - h * vpr) * 4;
    const long f = f0 + h;
    const bool ok = h < hmax && f >= 0 && f < t_len;
    mma::cp_async16(hs + (long)h * d + c, ok ? src + f * d + c : src, ok);
  }
  mma::cp_async_commit();
}

// Chunk c of channel ch's taps (tap j = wdw[ch, c KC + j], 0 past k), or
// with FLIP the transposed conv's (wdw[ch, k - 1 - (c KC + j)]).
template <bool FLIP>
__device__ __forceinline__ void load_taps(float (&tap)[KC], const float* wch, int c, int k) {
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int i = c * KC + j;
    tap[j] = i < k ? __ldg(wch + (FLIP ? k - 1 - i : i)) : 0.0f;
  }
}

// acc[q] += sum_j tap[j] col[(q + j) ld] for q < R: one chunk of taps over R
// output frames, each input read once, the taps added in order.
__device__ __forceinline__ void walk(float (&acc)[R], const float (&tap)[KC], const float* col,
                                     int ld) {
#pragma unroll
  for (int i = 0; i < R + KC - 1; ++i) {
    const float v = col[i * ld];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int j = i - q;
      if (j >= 0 && j < KC) acc[q] = fmaf(tap[j], v, acc[q]);
    }
  }
}

// The depthwise conv of channel ch over a halo tile hs (ld floats a row):
// put(r, acc) with acc[q] = init + sum_j tap(j) hs[r + q + j][ch], q < R,
// for r = 0, R, .. < BT in order, each after the walk has read every row it
// needs from hs (so put may overwrite hs's rows r .. r + R - 1).
template <bool FLIP, class Put>
__device__ __forceinline__ void conv_channel(const float* hs, int ld, int ch, const float* wch,
                                             int k, float init, Put&& put) {
  const int nc = (int)cdiv(k, KC);
  float tap[KC];
  load_taps<FLIP>(tap, wch, 0, k);
  for (int r = 0; r < BT; r += R) {
    float acc[R];
#pragma unroll
    for (int q = 0; q < R; ++q) acc[q] = init;
    for (int c = 0; c < nc; ++c) {
      if (nc > 1) load_taps<FLIP>(tap, wch, c, k);
      walk(acc, tap, hs + (long)(r + c * KC) * ld + ch, ld);
    }
    put(r, acc);
  }
}

// g (and with SIG, sigmoid(gate)) for a 128-row x 64-channel tile.
template <bool SIG>
__device__ __forceinline__ void glu_tile(const bf16* __restrict__ x,
                                         const int* __restrict__ lengths,
                                         const bf16* __restrict__ w1, const float* __restrict__ b1,
                                         float* __restrict__ g, float* __restrict__ sig, long n,
                                         int t_len, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long n0 = (long)blockIdx.x * kTile;  // interleaved column
  const long m0 = (long)blockIdx.y * kTile;
  Glu::Acc acc;
  Glu::zero(acc);
  mma::NoHook none;
  Glu::run(acc, reinterpret_cast<bf16*>(smem), x, d, w1, d, m0, n0, n, 2L * d, 0, d, none,
           GluRows{d});
  const int t2 = (threadIdx.x & 3) * 2;
  int ch[Glu::NT / 2];
  float ba[Glu::NT / 2][2], bg[Glu::NT / 2][2];
#pragma unroll
  for (int q = 0; q < Glu::NT / 2; ++q) {
    ch[q] = (int)(((n0 + Glu::frag_col(2 * q)) >> 4) * 8) + t2;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ba[q][e] = __ldg(b1 + ch[q] + e);
      bg[q][e] = __ldg(b1 + d + ch[q] + e);
    }
  }
#pragma unroll
  for (int i = 0; i < Glu::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long row = m0 + Glu::frag_row(i, h);
      if (row >= n) continue;
      const int b = (int)(row / t_len);
      const bool keep = row - (long)b * t_len < valid_len(lengths, b, t_len);
#pragma unroll
      for (int q = 0; q < Glu::NT / 2; ++q) {
        float gv[2], sv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = acc[i][2 * q][2 * h + e] + ba[q][e];
          sv[e] = sigmoid(acc[i][2 * q + 1][2 * h + e] + bg[q][e]);
          gv[e] = keep ? a * sv[e] : 0.0f;
        }
        *reinterpret_cast<float2*>(g + row * d + ch[q]) = make_float2(gv[0], gv[1]);
        if constexpr (SIG) {
          *reinterpret_cast<float2*>(sig + row * d + ch[q]) = make_float2(sv[0], sv[1]);
        }
      }
    }
}

// Grid (2D / 128, N / 128).
__global__ void __launch_bounds__(kThreads, 2)
    glu_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
               const bf16* __restrict__ w1, const float* __restrict__ b1, float* __restrict__ g,
               long n, int t_len, int d) {
  glu_tile<false>(x, lengths, w1, b1, g, nullptr, n, t_len, d);
}

__global__ void __launch_bounds__(kThreads, 2)
    glu_sig_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
                   const bf16* __restrict__ w1, const float* __restrict__ b1,
                   float* __restrict__ g, float* __restrict__ sig, long n, int t_len, int d) {
  glu_tile<true>(x, lengths, w1, b1, g, sig, n, t_len, d);
}

// Grid (ceil(T / BT), B): the rest of the forward for one row tile.
__global__ void __launch_bounds__(kThreads, 2)
    out_kernel(const float* __restrict__ g, const float* __restrict__ wdw,
               const float* __restrict__ bdw, const float* __restrict__ gamma,
               const float* __restrict__ beta, const bf16* __restrict__ w2,
               const float* __restrict__ b2, bf16* __restrict__ out, int t_len, int d, int k,
               int pl, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const OutSmem L(d, k);
  float* hs = reinterpret_cast<float*>(smem);
  bf16* sws = reinterpret_cast<bf16*>(smem + L.sw);
  const int lds = ld_tile(d);
  const int b = blockIdx.y;
  const long r0 = (long)blockIdx.x * BT;
  const long base = (long)b * t_len * d;
  // hs row h <- g at frame r0 - pl + h.
  load_halo(hs, g + base, r0 - pl, BT + k - 1, halo_rows(k), t_len, d);
  mma::cp_async_wait<0>();
  __syncthreads();
  // c = bdw + taps, in place (one thread owns a channel).
  for (int ch = threadIdx.x; ch < d; ch += kThreads) {
    conv_channel<false>(hs, d, ch, wdw + (long)ch * k, k, __ldg(bdw + ch),
                        [&](int r, const float(&acc)[R]) {
#pragma unroll
                          for (int q = 0; q < R; ++q) hs[(r + q) * d + ch] = acc[q];
                        });
  }
  __syncthreads();
  // LayerNorm (two passes) and swish, a warp a row, into the bf16 A tile.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BT; r += kThreads / 32) {
    const float* row = hs + r * d;
    float s = 0.0f;
    for (int c = lane; c < d; c += 32) s += row[c];
    const float mean = warp_sum(s) / d;
    float v = 0.0f;
    for (int c = lane; c < d; c += 32) v += (row[c] - mean) * (row[c] - mean);
    const float rs = rsqrtf(warp_sum(v) / d + eps);
    for (int c = lane; c < d; c += 32) {
      const float nv = (row[c] - mean) * rs * __ldg(gamma + c) + __ldg(beta + c);
      sws[r * lds + c] = __float2bfloat16(nv * sigmoid(nv));
    }
  }
  __syncthreads();  // the halo is dead: the ring takes its place
  bf16* ring = reinterpret_cast<bf16*>(smem);
  for (int nb = 0; nb < d; nb += 256) {
    Pw2::Acc acc;
    Pw2::zero(acc);
    Pw2::run_ra(acc, ring, sws, lds, w2, d, nb, d, 0, d);
    Pw2::epilogue(acc, [&](int r, int c, float v0, float v1) {
      const long f = r0 + r;
      const int col = nb + c;
      if (f < t_len && col < d) {
        *reinterpret_cast<__nv_bfloat162*>(out + base + f * d + col) =
            __floats2bfloat162_rn(v0 + __ldg(b2 + col), v1 + __ldg(b2 + col + 1));
      }
    });
  }
}

// Grid (ceil(T / BT), B). vecp[tile] <- column sums over the tile's frames
// of go, dn chat, dn, dc (db2, dgamma, dbeta, dbdw); dwdwp[tile] <- the
// tile's tap gradient [k, D]; tile = b ceil(T / BT) + blockIdx.x. dsw stays
// in the mainloop's accumulators (CB column blocks of 256) from its product
// to dc, so the ring and then g's halo share one region and two blocks fit
// an SM at D <= 256.
template <int CB>
__global__ void __launch_bounds__(kThreads, CB == 1 ? 2 : 1)
    rows_kernel(const float* __restrict__ g, const float* __restrict__ wdw,
                const float* __restrict__ bdw, const float* __restrict__ gamma,
                const float* __restrict__ beta, const bf16* __restrict__ w2,
                const bf16* __restrict__ go, float* __restrict__ dc_out, bf16* __restrict__ sw_out,
                float* __restrict__ vecp, float* __restrict__ dwdwp, int t_len, int d, int k,
                int pl, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsSmem L(d, k);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* hs = reinterpret_cast<float*>(smem);         // after the ring
  float* cs = reinterpret_cast<float*>(smem + L.c);   // c, chat, then dc
  float* red = reinterpret_cast<float*>(smem + L.red);  // [warps][BT][2]
  float* rstd = reinterpret_cast<float*>(smem + L.rstd);
  const int ldt = ld_tile(d);
  const int b = blockIdx.y;
  const long r0 = (long)blockIdx.x * BT;
  const long base = (long)b * t_len * d;
  const int valid = (int)min((long)BT, t_len - r0);
  const long tile = (long)b * gridDim.x + blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* vp = vecp + tile * 4 * d;
  Dsw::Acc dn[CB];  // dsw, then dn
#pragma unroll
  for (int cb = 0; cb < CB; ++cb) {
    Dsw::zero(dn[cb]);
    if (cb * 256 < d) {
      Dsw::run(dn[cb], ring, go, d, w2, d, (long)b * t_len + r0, cb * 256,
               (long)b * t_len + t_len, d, 0, d);
    }
  }
  // hs row h <- g at frame r0 - pl + h.
  load_halo(hs, g + base, r0 - pl, BT + k - 1, halo_rows(k), t_len, d);
  mma::cp_async_wait<0>();
  __syncthreads();
  for (int ch = threadIdx.x; ch < d; ch += kThreads) {
    conv_channel<false>(hs, d, ch, wdw + (long)ch * k, k, __ldg(bdw + ch),
                        [&](int r, const float(&acc)[R]) {
#pragma unroll
                          for (int q = 0; q < R; ++q) cs[(r + q) * ldt + ch] = acc[q];
                        });
  }
  __syncthreads();
  for (int r = warp; r < BT; r += kThreads / 32) {
    float* row = cs + r * ldt;
    float s = 0.0f;
    for (int c = lane; c < d; c += 32) s += row[c];
    const float mean = warp_sum(s) / d;
    float v = 0.0f;
    for (int c = lane; c < d; c += 32) v += (row[c] - mean) * (row[c] - mean);
    const float rs = rsqrtf(warp_sum(v) / d + eps);
    for (int c = lane; c < d; c += 32) row[c] = (row[c] - mean) * rs;  // chat
    if (lane == 0) rstd[r] = rs;
  }
  __syncthreads();
  // In the accumulators' layout (a warp owns all BT rows of its 32
  // columns): sw to device memory, dn = dsw swish'(n), the column sums of dn
  // chat and dn, and each row's sums of dchat and dchat chat (dchat = dn
  // gamma) over the warp's columns.
  float s1[Dsw::MT][2] = {}, s2[Dsw::MT][2] = {};
#pragma unroll
  for (int cb = 0; cb < CB; ++cb)
#pragma unroll
    for (int j = 0; j < Dsw::NT; ++j) {
      const int c = cb * 256 + Dsw::frag_col(j);
      if (c >= d) continue;
      float gm[2], bt[2], sdg[2] = {}, sdb[2] = {};
#pragma unroll
      for (int e = 0; e < 2; ++e) gm[e] = __ldg(gamma + c + e), bt[e] = __ldg(beta + c + e);
#pragma unroll
      for (int i = 0; i < Dsw::MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = Dsw::frag_row(i, h);
          const float2 ch2 = *reinterpret_cast<const float2*>(cs + r * ldt + c);
          const float chat[2] = {ch2.x, ch2.y};
          float sw[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float nv = chat[e] * gm[e] + bt[e];
            const float sg = sigmoid(nv);
            sw[e] = nv * sg;
            float& v = dn[cb][i][j][2 * h + e];
            v *= sg * (1.0f + nv * (1.0f - sg));
            const float dch = v * gm[e];
            s1[i][h] += dch;
            s2[i][h] += dch * chat[e];
            if (r < valid) sdg[e] += v * chat[e], sdb[e] += v;
          }
          if (r < valid) {
            *reinterpret_cast<__nv_bfloat162*>(sw_out + base + (r0 + r) * d + c) =
                __floats2bfloat162_rn(sw[0], sw[1]);
          }
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          sdg[e] += __shfl_xor_sync(0xffffffffu, sdg[e], o);
          sdb[e] += __shfl_xor_sync(0xffffffffu, sdb[e], o);
        }
        if (lane < 4) {
          vp[d + c + e] = sdg[e];
          vp[2 * d + c + e] = sdb[e];
        }
      }
    }
#pragma unroll
  for (int i = 0; i < Dsw::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s1[i][h] += __shfl_xor_sync(0xffffffffu, s1[i][h], o);
        s2[i][h] += __shfl_xor_sync(0xffffffffu, s2[i][h], o);
      }
      if ((lane & 3) == 0) {
        float* rr = red + (warp * BT + Dsw::frag_row(i, h)) * 2;
        rr[0] = s1[i][h];
        rr[1] = s2[i][h];
      }
    }
  __syncthreads();
  // The LayerNorm backward, dc = rstd (dchat - mean(dchat) - chat
  // mean(dchat chat)), into cs in place of chat, and its column sums (dbdw).
  float m1[Dsw::MT][2], m2[Dsw::MT][2], rs[Dsw::MT][2];
#pragma unroll
  for (int i = 0; i < Dsw::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = Dsw::frag_row(i, h);
      float a = 0.0f, c2 = 0.0f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        a += red[(w * BT + r) * 2];
        c2 += red[(w * BT + r) * 2 + 1];
      }
      m1[i][h] = a / d;
      m2[i][h] = c2 / d;
      rs[i][h] = rstd[r];
    }
#pragma unroll
  for (int cb = 0; cb < CB; ++cb)
#pragma unroll
    for (int j = 0; j < Dsw::NT; ++j) {
      const int c = cb * 256 + Dsw::frag_col(j);
      if (c >= d) continue;
      float gm[2], sdc[2] = {};
#pragma unroll
      for (int e = 0; e < 2; ++e) gm[e] = __ldg(gamma + c + e);
#pragma unroll
      for (int i = 0; i < Dsw::MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = Dsw::frag_row(i, h);
          float2* p = reinterpret_cast<float2*>(cs + r * ldt + c);
          const float2 ch2 = *p;
          const float chat[2] = {ch2.x, ch2.y};
          float dc[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            dc[e] = rs[i][h] * (dn[cb][i][j][2 * h + e] * gm[e] - m1[i][h] - chat[e] * m2[i][h]);
            if (r < valid) sdc[e] += dc[e];
          }
          *p = make_float2(dc[0], dc[1]);
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) sdc[e] += __shfl_xor_sync(0xffffffffu, sdc[e], o);
        if (lane < 4) vp[3 * d + c + e] = sdc[e];
      }
    }
  __syncthreads();
  // db2, dc to device memory and dwdw[ch, j] = sum_r dc[r] hs[r + j]: a
  // thread a channel, the tile's dc of the channel in registers, KC / 2 taps
  // a pass.
  const int nc = (int)cdiv(k, KC);
  for (int ch = threadIdx.x; ch < d; ch += kThreads) {
    float sgo = 0.0f;
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      if (r < valid) sgo += __bfloat162float(go[base + (r0 + r) * d + ch]);
    }
    vp[ch] = sgo;
    float dcr[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      dcr[r] = r < valid ? cs[r * ldt + ch] : 0.0f;
      if (r < valid) dc_out[base + (r0 + r) * d + ch] = dcr[r];
    }
    float* wout = dwdwp + tile * k * d + ch;  // [tile][j][ch]: stores a row a warp
    constexpr int KH = KC / 2;  // taps a pass holds (half a chunk: fewer registers)
    for (int c = 0; c < 2 * nc; ++c) {
      float acc[KH];
#pragma unroll
      for (int j = 0; j < KH; ++j) acc[j] = 0.0f;
      const float* col = hs + (long)c * KH * d + ch;
#pragma unroll
      for (int h = 0; h < BT + KH - 1; ++h) {
        const float v = col[h * d];
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const int j = h - r;
          if (j >= 0 && j < KH) acc[j] = fmaf(dcr[r], v, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < KH; ++j) {
        if (c * KH + j < k) wout[(long)(c * KH + j) * d] = acc[j];
      }
    }
  }
}

// Grid (ceil(T / BT), B): dg = the transposed conv of dc (zero outside [0,
// T)), masked to frames < len, then da = dg sig, dgate = dg a sig (1 - sig)
// (a sig = g where the mask keeps the frame); du = (da, dgate) in bf16,
// db1p[tile] <- the tile's unrounded column sums.
__global__ void __launch_bounds__(kThreads)
    du_kernel(const float* __restrict__ dc, const float* __restrict__ g,
              const float* __restrict__ sig, const int* __restrict__ lengths,
              const float* __restrict__ wdw, bf16* __restrict__ du, float* __restrict__ db1p,
              int t_len, int d, int k, int pl) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem);
  const int b = blockIdx.y;
  const long r0 = (long)blockIdx.x * BT;
  const long base = (long)b * t_len * d;
  const int len = valid_len(lengths, b, t_len);
  const long tile = (long)b * gridDim.x + blockIdx.x;
  // hs row h <- dc at frame r0 - pr + h (pr = k - 1 - pl): frame s takes
  // rows s - r0 .. s - r0 + k - 1 against the taps reversed.
  load_halo(hs, dc + base, r0 - (k - 1 - pl), BT + k - 1, halo_rows(k), t_len, d);
  mma::cp_async_wait<0>();
  __syncthreads();
  for (int ch = threadIdx.x; ch < d; ch += kThreads) {
    float sda = 0.0f, sdg = 0.0f;
    conv_channel<true>(hs, d, ch, wdw + (long)ch * k, k, 0.0f, [&](int r,
                                                                   const float(&acc)[R]) {
      // The R frames' g and sig first, all loads in flight together.
      float gv[R], sv[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const long f = r0 + r + q;
        gv[q] = f < t_len ? __ldg(g + base + f * d + ch) : 0.0f;
        sv[q] = f < t_len ? __ldg(sig + base + f * d + ch) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const long f = r0 + r + q;
        if (f >= t_len) break;
        const float dgv = f < len ? acc[q] : 0.0f;
        const float da = dgv * sv[q], dgt = dgv * gv[q] * (1.0f - sv[q]);
        bf16* drow = du + (base + f * d) * 2;
        drow[ch] = __float2bfloat16(da);
        drow[d + ch] = __float2bfloat16(dgt);
        sda += da;
        sdg += dgt;
      }
    });
    db1p[tile * 2 * d + ch] = sda;
    db1p[tile * 2 * d + d + ch] = sdg;
  }
}

// Grid (D / 128, N / 128): dx = du W1.
__global__ void __launch_bounds__(kThreads, 2)
    dx_kernel(const bf16* __restrict__ du, const bf16* __restrict__ w1, bf16* __restrict__ dx,
              long n, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long n0 = (long)blockIdx.x * kTile;
  const long m0 = (long)blockIdx.y * kTile;
  Dx::Acc acc;
  Dx::zero(acc);
  Dx::run(acc, reinterpret_cast<bf16*>(smem), du, 2L * d, w1, d, m0, n0, n, d, 0, 2L * d);
  Dx::epilogue(acc, [&](int r, int c, float v0, float v1) {
    const long row = m0 + r, col = n0 + c;
    if (row < n && col < d) {
      *reinterpret_cast<__nv_bfloat162*>(dx + row * d + col) = __floats2bfloat162_rn(v0, v1);
    }
  });
}

// Grid (dW1 tiles + dW2 tiles, splits of N): each split's fp32 partials of
// dW1 = du^T x [2D, D] and dW2 = go^T sw [D, D].
__global__ void __launch_bounds__(kThreads, 2)
    dw_kernel(const bf16* __restrict__ du, const bf16* __restrict__ x, const bf16* __restrict__ go,
              const bf16* __restrict__ sw, float* __restrict__ dw1p, float* __restrict__ dw2p,
              long n, int d, long kchunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const long split = blockIdx.y;
  const long k0 = split * kchunk, k1 = k0 + kchunk < n ? k0 + kchunk : n;
  const int tn = (int)cdiv(d, kTile);
  const int tiles1 = (int)cdiv(2L * d, kTile) * tn;
  int t = blockIdx.x;
  Dw::Acc acc;
  Dw::zero(acc);
  long m0, n0, rows;
  float* out;
  if (t < tiles1) {
    m0 = (long)(t / tn) * kTile;
    n0 = (long)(t % tn) * kTile;
    rows = 2L * d;
    out = dw1p + split * 2 * d * d;
    Dw::run(acc, ring, du, 2L * d, x, d, m0, n0, rows, d, k0, k1);
  } else {
    t -= tiles1;
    m0 = (long)(t / tn) * kTile;
    n0 = (long)(t % tn) * kTile;
    rows = d;
    out = dw2p + split * d * d;
    Dw::run(acc, ring, go, d, sw, d, m0, n0, rows, d, k0, k1);
  }
  Dw::epilogue(acc, [&](int r, int c, float v0, float v1) {
    const long row = m0 + r, col = n0 + c;
    if (row < rows && col < d) {
      *reinterpret_cast<float2*>(out + row * d + col) = make_float2(v0, v1);
    }
  });
}

// The backward's partial sums, each over its parts in a fixed order: job j
// sums src [parts, len] into dst (fp32) or dst16 (bf16); with rows > 0 the
// sum of src column i goes to dst[(i % rows) * (len / rows) + i / rows] (a
// transpose of [len / rows, rows]).
struct SumJob {
  const float* src;
  float* dst;
  bf16* dst16;
  int len, parts, rows, blocks;  // blocks = ceil(len / 32)
};
constexpr int kSumJobs = 5;  // vecp, dwdwp, db1p, dW1, dW2
struct SumJobs {
  SumJob job[kSumJobs];
};

// Grid (sum of the jobs' blocks): a block sums 32 columns of one job, its 8
// warps a stride of the parts each, then the 8 partial sums in order.
__global__ void __launch_bounds__(kThreads) sum_kernel(const SumJobs jobs) {
  __shared__ float red[kThreads / 32][33];
  int blk = blockIdx.x, j = 0;
  while (j < kSumJobs - 1 && blk >= jobs.job[j].blocks) blk -= jobs.job[j++].blocks;
  const SumJob job = jobs.job[j];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int col = blk * 32 + lane;
  float s = 0.0f;
  if (col < job.len) {
#pragma unroll 4
    for (int p = grp; p < job.parts; p += kThreads / 32) s += job.src[(long)p * job.len + col];
  }
  red[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && col < job.len) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t += red[w][lane];
    const int at = job.rows > 0 ? (col % job.rows) * (job.len / job.rows) + col / job.rows : col;
    if (job.dst) job.dst[at] = t;
    if (job.dst16) job.dst16[at] = __float2bfloat16(t);
  }
}

constexpr int kKernels = 8;  // glu, out, glu_sig, rows, du, dx, dw, sum

struct Launch {
  const void* kernel;
  size_t smem;  // dynamic shared bytes at (d, k)
};

inline Launch launch_of(int which, int d, int k) {
  auto f = [](auto p) { return reinterpret_cast<const void*>(p); };
  switch (which) {
    case 0: return {f(glu_kernel), Glu::kSmemBytes};
    case 1: return {f(out_kernel), OutSmem(d, k).total};
    case 2: return {f(glu_sig_kernel), Glu::kSmemBytes};
    case 3: return {d <= 256 ? f(rows_kernel<1>) : f(rows_kernel<2>), RowsSmem(d, k).total};
    case 4: return {f(du_kernel), du_smem(d, k)};
    case 5: return {f(dx_kernel), Dx::kSmemBytes};
    case 6: return {f(dw_kernel), Dw::kSmemBytes};
    case 7: return {f(sum_kernel), 0};
    default: return {nullptr, 0};
  }
}

// Every kernel with dynamic shared memory may take the card's whole opt-in
// shared memory, and every kernel prefers the largest carveout; once. (Any
// error of these calls is cleared, so that the launches' checks see only
// their own.)
inline void configure() {
  static const bool done = [] {
    int dev = 0, most = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    for (int i = 0; i <= kKernels; ++i) {  // rows at both widths: i == kKernels
      const Launch l = i < kKernels ? launch_of(i, 64, 1) : launch_of(3, 512, 1);
      cudaFuncSetAttribute(l.kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
      if (l.smem > 0) {
        cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      }
    }
    cudaGetLastError();
    return true;
  }();
  (void)done;
}

inline int blocks_per_sm(int which, int d, int k, int* nb) {
  const Launch l = launch_of(which, d, k);
  if (!l.kernel) return (int)cudaErrorInvalidValue;
  configure();
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(nb, l.kernel, kThreads, l.smem);
}

// Splits of N for dw_kernel: as many as fill the card's block slots with
// (dW1 + dW2 tiles) x splits blocks, each split at least 512 rows; at
// least 1. A negative value is minus a cudaError_t.
inline int dw_splits(long n, int d, int sms) {
  int per_sm = 0;
  if (int err = blocks_per_sm(6, d, 1, &per_sm)) return -err;
  const long tiles = cdiv(2L * d, kTile) * cdiv(d, kTile) + cdiv(d, kTile) * cdiv(d, kTile);
  const long s = std::min({n / 512, (long)sms * std::max(per_sm, 1) / tiles, 65535L});
  return (int)std::max(1L, s);
}

inline int info(int which, int d, int k, int* out) {
  const Launch l = launch_of(which, d, k);
  if (!l.kernel) return (int)cudaErrorInvalidValue;
  configure();
  cudaFuncAttributes attr{};
  if (int err = (int)cudaFuncGetAttributes(&attr, l.kernel)) return err;
  int nb = 0;
  if (int err = blocks_per_sm(which, d, k, &nb)) return err;
  out[0] = attr.numRegs;
  out[1] = (int)(attr.sharedSizeBytes + l.smem);
  out[2] = (int)attr.localSizeBytes;
  out[3] = nb;
  return 0;
}

// Shapes the route takes (D up to 512: rows_kernel holds dsw for at most two
// column blocks of 256; shared memory bounds it there too).
inline bool shape_ok(int nb, int t, int d, int k, int pl) {
  return nb > 0 && nb <= 65535 && t > 0 && d > 0 && d % 64 == 0 && d <= 512 && k > 0 &&
         pl >= 0 && pl <= k - 1 && (long)nb * t <= 0x7fffffffL;
}

inline int launch_fwd(const bf16* x, const int* lengths, const bf16* w1, const float* b1,
                      const float* wdw, const float* bdw, const float* gamma, const float* beta,
                      const bf16* w2, const float* b2, float* g, bf16* out, int nb, int t, int d,
                      int k, int pl, float eps, cudaStream_t stream) {
  configure();
  const long n = (long)nb * t;
  glu_kernel<<<dim3((unsigned)cdiv(2L * d, kTile), (unsigned)cdiv(n, kTile)), kThreads,
               Glu::kSmemBytes, stream>>>(x, lengths, w1, b1, g, n, t, d);
  if (int err = counted(Counted::kConvGluBf16)) return err;
  out_kernel<<<dim3((unsigned)cdiv(t, BT), (unsigned)nb), kThreads, OutSmem(d, k).total,
               stream>>>(g, wdw, bdw, gamma, beta, w2, b2, out, t, d, k, pl, eps);
  return counted(Counted::kConvOutBf16);
}

inline int launch_bwd(const bf16* x, const int* lengths, const bf16* w1, const float* b1,
                      const float* wdw, const float* bdw, const float* gamma, const float* beta,
                      const bf16* w2, const bf16* go, float* g, float* sig, float* dc, bf16* sw,
                      bf16* du, bf16* dx, float* vecp, float* dwdwp, float* db1p, float* dw1p,
                      float* dw2p, int nsplit, float* vec, float* dwdw, float* db1, bf16* dw1,
                      bf16* dw2, int nb, int t, int d, int k, int pl, float eps,
                      cudaStream_t stream) {
  configure();
  const long n = (long)nb * t;
  const dim3 row_tiles((unsigned)cdiv(t, BT), (unsigned)nb);
  glu_sig_kernel<<<dim3((unsigned)cdiv(2L * d, kTile), (unsigned)cdiv(n, kTile)), kThreads,
                   Glu::kSmemBytes, stream>>>(x, lengths, w1, b1, g, sig, n, t, d);
  if (int err = counted(Counted::kConvGluSigBf16)) return err;
  (d <= 256 ? rows_kernel<1> : rows_kernel<2>)<<<row_tiles, kThreads, RowsSmem(d, k).total,
                                                  stream>>>(g, wdw, bdw, gamma, beta, w2, go,
                                                            dc, sw, vecp, dwdwp, t, d, k, pl,
                                                            eps);
  if (int err = counted(Counted::kConvRowsBf16)) return err;
  du_kernel<<<row_tiles, kThreads, du_smem(d, k), stream>>>(dc, g, sig, lengths, wdw, du, db1p,
                                                             t, d, k, pl);
  if (int err = counted(Counted::kConvDuBf16)) return err;
  dx_kernel<<<dim3((unsigned)cdiv(d, kTile), (unsigned)cdiv(n, kTile)), kThreads, Dx::kSmemBytes,
              stream>>>(du, w1, dx, n, d);
  if (int err = counted(Counted::kConvDxBf16)) return err;
  const long kchunk = cdiv(cdiv(n, nsplit), 32) * 32;
  const long tiles = cdiv(2L * d, kTile) * cdiv(d, kTile) + cdiv(d, kTile) * cdiv(d, kTile);
  dw_kernel<<<dim3((unsigned)tiles, (unsigned)nsplit), kThreads, Dw::kSmemBytes, stream>>>(
      du, x, go, sw, dw1p, dw2p, n, d, kchunk);
  if (int err = counted(Counted::kConvDwBf16)) return err;
  const int ntiles = row_tiles.x * row_tiles.y;
  SumJobs jobs{{{vecp, vec, nullptr, 4 * d, ntiles, 0, 0},
                {dwdwp, dwdw, nullptr, d * k, ntiles, d, 0},  // [tile][k][D] -> [D, k]
                {db1p, db1, nullptr, 2 * d, ntiles, 0, 0},
                {dw1p, nullptr, dw1, 2 * d * d, nsplit, 0, 0},
                {dw2p, nullptr, dw2, d * d, nsplit, 0, 0}}};
  long blocks = 0;
  for (SumJob& j : jobs.job) blocks += j.blocks = (int)cdiv(j.len, 32);
  sum_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(jobs);
  return counted(Counted::kConvSumBf16);
}

}  // namespace conv_bf16

}  // namespace espnet

// The float32 route (x, w1, w2, out float32). x: [B, T, D]; lengths: int32
// [B]; w1 [2D, D]; b1 [2D]; wdw [D, k]; bdw, gamma, beta, b2 [D]; w2 [D, D];
// pl: left padding of the depthwise conv ((k-1)/2 SAME, k-1 causal). D must
// be a multiple of 64. Returns a cudaError_t code (0 = launched).
extern "C" int espnet_conv_f32_fwd(const void* x, const int* lengths, const void* w1,
                                   const float* b1, const float* wdw, const float* bdw,
                                   const float* gamma, const float* beta, const void* w2,
                                   const float* b2, void* out, int b, int t, int d, int k, int pl,
                                   float eps, void* stream) {
  if (espnet::bad_shape(b, t, d, k, pl)) return (int)cudaErrorInvalidValue;
  return espnet::launch_fwd<float>(x, lengths, w1, b1, wdw, bdw, gamma, beta, w2, b2, out, b, t,
                                   d, k, pl, eps, static_cast<cudaStream_t>(stream));
}

// Row tile of the backward's "rows" kernel of dtype (0 float32, 1
// bfloat16): vecp holds B * ceil(T / tile) partials of 4 x D floats.
extern "C" int espnet_conv_module_rows_tile(int dtype) {
  return dtype == 1 ? espnet::conv_bf16::BT : espnet::Tiles<float>::kRows;
}

// Backward of the float32 route. go, dx: [B, T, D]; scratch dc, sw: f32 [B,
// T, D]; fp32 partials, summed by the caller: vecp [B * ceil(T / rows_tile),
// 4, D] (db2, dgamma, dbeta, dbdw), dw1p [nsplit, 2D, D], db1p [nsplit, 2D],
// dwdwp [nsplit, D, k], dw2p [nsplit, D, D]. Returns a cudaError_t code.
extern "C" int espnet_conv_f32_bwd(const void* x, const int* lengths, const void* w1,
                                   const float* b1, const float* wdw, const float* bdw,
                                   const float* gamma, const float* beta, const void* w2,
                                   const void* go, void* dx, float* dc, void* sw, float* vecp,
                                   float* dw1p, float* db1p, float* dwdwp, float* dw2p,
                                   int nsplit, int b, int t, int d, int k, int pl, float eps,
                                   void* stream) {
  if (espnet::bad_shape(b, t, d, k, pl) || nsplit <= 0 || nsplit > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return espnet::launch_bwd<float>(x, lengths, w1, b1, wdw, bdw, gamma, beta, w2, go, dx, dc, sw,
                                   vecp, dw1p, db1p, dwdwp, dw2p, nsplit, b, t, d, k, pl, eps,
                                   static_cast<cudaStream_t>(stream));
}

// The bfloat16 route. x: [B, T, D]; lengths: int32 [B]; w1 [2D, D], w2 [D, D]
// bf16; b1 [2D], wdw [D, k], bdw, gamma, beta, b2 [D] f32; g: f32 [B, T, D]
// scratch; out [B, T, D] bf16. D a multiple of 64. Returns a cudaError_t code.
extern "C" int espnet_conv_bf16_fwd(const void* x, const int* lengths, const void* w1,
                                    const float* b1, const float* wdw, const float* bdw,
                                    const float* gamma, const float* beta, const void* w2,
                                    const float* b2, float* g, void* out, int b, int t, int d,
                                    int k, int pl, float eps, void* stream) {
  using namespace espnet;
  if (!conv_bf16::shape_ok(b, t, d, k, pl) || !g) return (int)cudaErrorInvalidValue;
  return conv_bf16::launch_fwd(static_cast<const bf16*>(x), lengths, static_cast<const bf16*>(w1),
                               b1, wdw, bdw, gamma, beta, static_cast<const bf16*>(w2), b2, g,
                               static_cast<bf16*>(out), b, t, d, k, pl, eps,
                               static_cast<cudaStream_t>(stream));
}

// Backward of the bfloat16 route. go, dx: [B, T, D] bf16; scratch g, sig,
// dc: f32 [B, T, D], sw: bf16 [B, T, D], du: bf16 [B, T, 2D], and fp32
// partials with tiles = B ceil(T / espnet_conv_module_rows_tile(1)):
// vecp [tiles, 4, D], dwdwp [tiles, k, D], db1p [tiles, 2D], dw1p [nsplit,
// 2D, D], dw2p [nsplit, D, D], nsplit from espnet_conv_bf16_dw_splits. The
// sums: vec f32 [4, D] (db2, dgamma, dbeta, dbdw), dwdw f32 [D, k], db1 f32
// [2D], dw1 bf16 [2D, D], dw2 bf16 [D, D]. Returns a cudaError_t code.
extern "C" int espnet_conv_bf16_bwd(const void* x, const int* lengths, const void* w1,
                                    const float* b1, const float* wdw, const float* bdw,
                                    const float* gamma, const float* beta, const void* w2,
                                    const void* go, float* g, float* sig, float* dc, void* sw,
                                    void* du, void* dx, float* vecp, float* dwdwp, float* db1p,
                                    float* dw1p, float* dw2p, int nsplit, float* vec,
                                    float* dwdw, float* db1, void* dw1, void* dw2, int b, int t,
                                    int d, int k, int pl, float eps, void* stream) {
  using namespace espnet;
  if (!conv_bf16::shape_ok(b, t, d, k, pl) || nsplit <= 0 || nsplit > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  auto out = [](void* p) { return static_cast<bf16*>(p); };
  return conv_bf16::launch_bwd(in(x), lengths, in(w1), b1, wdw, bdw, gamma, beta, in(w2), in(go),
                               g, sig, dc, out(sw), out(du), out(dx), vecp, dwdwp, db1p, dw1p,
                               dw2p, nsplit, vec, dwdw, db1, out(dw1), out(dw2), b, t, d, k, pl,
                               eps, static_cast<cudaStream_t>(stream));
}

// Splits of N = B T for the bfloat16 backward's dw_kernel on a card of `sms`
// SMs at width D; a negative value is minus a cudaError_t code.
extern "C" int espnet_conv_bf16_dw_splits(int n, int d, int sms) {
  if (n <= 0 || d <= 0 || d % 64 || sms <= 0) return -(int)cudaErrorInvalidValue;
  return espnet::conv_bf16::dw_splits(n, d, sms);
}

// info[0..3] <- registers a thread, shared bytes (static and dynamic at
// width D and k taps), local (spill) bytes and blocks per SM of the bfloat16
// route's kernel `which`: 0 glu, 1 out, 2 glu_sig, 3 rows, 4 du, 5 dx, 6 dw,
// 7 sum.
// Returns a cudaError_t code.
extern "C" int espnet_conv_bf16_info(int which, int d, int k, int* info) {
  if (d <= 0 || d % 64 || k <= 0) return (int)cudaErrorInvalidValue;
  return espnet::conv_bf16::info(which, d, k, info);
}
