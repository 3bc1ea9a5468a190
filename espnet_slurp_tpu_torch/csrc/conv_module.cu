// Fused Conformer convolution module, forward and backward:
//   out = pw2(swish(LayerNorm(depthwise_k(mask(GLU(pw1(x)))))))
// per utterance row, all intermediates in fp32 (pw1 and pw2 take x's type with
// fp32 accumulation; the swish output is rounded to x's type before pw2).
//
// Replaces the TPU kernel espnet_slurp_tpu/ops/pallas/conv_module.py:
// fused_conv_module (_fwd_kernel via :214, _bwd_kernel via :236), the opt-in
// fused conv module of every Conformer block.
//
// Weights come in PyTorch's layouts, as the port's modules hold them: w1
// [2D, D] and w2 [D, D] (nn.Linear's [out, in]), the depthwise taps [D, k]
// (Conv1d's [D, 1, k]); biases, taps and LayerNorm parameters fp32.
//
// What bounds it on the H100: at the transducer step (B 32, T' 468, D 256,
// k 31, bf16) the two pointwise products are ~3 GFLOP against ~15 MB of
// compulsory traffic: the tensor cores bound it. The plain composition writes
// and re-reads the [B, T, 2D] GLU input and four [B, T, D] intermediates; the
// TPU kernel kept a whole utterance in VMEM to avoid that.
//
// Design. A whole utterance ([468, 256] fp32 = 479 KB) does not fit in a
// block's 227 KB of shared memory, so blocks own row tiles of BT frames and
// recompute pw1 + GLU over a halo of k - 1 frames (the depthwise taps' reach),
// walking the 2D pw1 outputs in chunks of BC GLU channels (a and gate rows of
// w1 together), each chunk folded into the depthwise sum at once. No
// [B, T, 2D] hidden reaches device memory, in either direction.
// The backward is four kernels, each recomputing what it needs:
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
// sums (deterministic, no atomics). dc and sw are [B, T, D]; writing and
// reading them costs ~46 MB a step at the flagship shape, the price of not
// recomputing the forward over two halos. This is the simple first version
// (WMMA tiles staged through shared memory, no pipelining).
#include "common.cuh"

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

// Tile sizes per element type: <forward BT, rows BT, dx BT, BC, dw2 BM>.
template <typename T>
struct Tiles;
template <>
struct Tiles<bf16> {
  static constexpr int kFwd = 64, kRows = 32, kDx = 64, kBc = 32, kBm = 32;
};
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
  return (int)cudaGetLastError();
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
    if (int err = (int)cudaGetLastError()) return err;
  }
  {
    const Dw2Layout L(d, S::kBm, 2 * S::kBc, sizeof(T));
    auto kern = conv_bwd_dw2_kernel<T, S::kBm, 2 * S::kBc>;
    if (int err = prepare(kern, L.total)) return err;
    kern<<<dim3(d / (2 * S::kBc), nsplit), kThreads, L.total, stream>>>(
        static_cast<const T*>(go), static_cast<const T*>(sw), dw2p, (long)nb * t, d);
    if (int err = (int)cudaGetLastError()) return err;
  }
  {
    const ConvGeo G(d, k, pl, S::kRows, S::kBc);
    const Dw1Layout L(G, sizeof(T));
    auto kern = conv_bwd_dw1_kernel<T, S::kRows, S::kBc>;
    if (int err = prepare(kern, L.total)) return err;
    kern<<<dim3(d / S::kBc, nsplit), kThreads, L.total, stream>>>(
        xt, lengths, w1t, b1, wdw, dc, dw1p, db1p, dwdwp, nb, t, d, k, pl);
    if (int err = (int)cudaGetLastError()) return err;
  }
  {
    const ConvGeo G(d, k, pl, S::kDx, S::kBc);
    const DxLayout L(G, sizeof(T));
    auto kern = conv_bwd_dx_kernel<T, S::kDx, S::kBc>;
    if (int err = prepare(kern, L.total)) return err;
    kern<<<dim3((t + S::kDx - 1) / S::kDx, nb), kThreads, L.total, stream>>>(
        xt, lengths, w1t, b1, wdw, dc, static_cast<T*>(dx), t, d, k, pl);
  }
  return (int)cudaGetLastError();
}

bool bad_shape(int nb, int t, int d, int k, int pl) {
  return nb <= 0 || t <= 0 || d <= 0 || d % 64 || k <= 0 || pl < 0 || pl > k - 1;
}

}  // namespace

}  // namespace espnet

// dtype: 0 = float32, 1 = bfloat16 (x, w1, w2, out). x: [B, T, D]; lengths:
// int32 [B]; w1 [2D, D]; b1 [2D]; wdw [D, k]; bdw, gamma, beta, b2 [D]; w2
// [D, D]; pl: left padding of the depthwise conv ((k-1)/2 SAME, k-1 causal).
// D must be a multiple of 64. Returns a cudaError_t code (0 = launched).
extern "C" int espnet_conv_module_fwd(int dtype, const void* x, const int* lengths,
                                      const void* w1, const float* b1, const float* wdw,
                                      const float* bdw, const float* gamma, const float* beta,
                                      const void* w2, const float* b2, void* out, int b, int t,
                                      int d, int k, int pl, float eps, void* stream) {
  if (espnet::bad_shape(b, t, d, k, pl)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return espnet::launch_fwd<espnet::bf16>(x, lengths, w1, b1, wdw, bdw, gamma, beta, w2, b2,
                                            out, b, t, d, k, pl, eps, s);
  }
  if (dtype == 0) {
    return espnet::launch_fwd<float>(x, lengths, w1, b1, wdw, bdw, gamma, beta, w2, b2, out, b,
                                     t, d, k, pl, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Row tile of the backward's "rows" kernel: vecp holds B * ceil(T / tile)
// partials of 4 x D floats.
extern "C" int espnet_conv_module_rows_tile(int dtype) {
  return dtype == 1 ? espnet::Tiles<espnet::bf16>::kRows : espnet::Tiles<float>::kRows;
}

// Backward. go: [B, T, D] (x's type); dx: [B, T, D]; scratch dc: f32
// [B, T, D] and sw: [B, T, D] (x's type); fp32 partials, summed by the
// caller: vecp [B * ceil(T / rows_tile), 4, D] (db2, dgamma, dbeta, dbdw),
// dw1p [nsplit, 2D, D], db1p [nsplit, 2D], dwdwp [nsplit, D, k], dw2p
// [nsplit, D, D]. Returns a cudaError_t code.
extern "C" int espnet_conv_module_bwd(int dtype, const void* x, const int* lengths,
                                      const void* w1, const float* b1, const float* wdw,
                                      const float* bdw, const float* gamma, const float* beta,
                                      const void* w2, const void* go, void* dx, float* dc,
                                      void* sw, float* vecp, float* dw1p, float* db1p,
                                      float* dwdwp, float* dw2p, int nsplit, int b, int t, int d,
                                      int k, int pl, float eps, void* stream) {
  if (espnet::bad_shape(b, t, d, k, pl) || nsplit <= 0 || nsplit > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return espnet::launch_bwd<espnet::bf16>(x, lengths, w1, b1, wdw, bdw, gamma, beta, w2, go,
                                            dx, dc, sw, vecp, dw1p, db1p, dwdwp, dw2p, nsplit, b,
                                            t, d, k, pl, eps, s);
  }
  if (dtype == 0) {
    return espnet::launch_bwd<float>(x, lengths, w1, b1, wdw, bdw, gamma, beta, w2, go, dx, dc,
                                     sw, vecp, dw1p, db1p, dwdwp, dw2p, nsplit, b, t, d, k, pl,
                                     eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
