// Fused position-wise feed-forward: out = dropout(swish(x W1 + b1)) W2 + b2,
// forward and backward (each direction's own notes are at its kernels below).
//
// Replaces the TPU kernel espnet_slurp_tpu/ops/pallas/ffn.py:fused_ffn
// (_fwd_kernel, _bwd_kernel), which runs both macaron FFNs of every Conformer
// block.
//
// What bounds it on the H100: at the flagship shape (N = B*T' ~ 3800 rows,
// D = 256, F = 1024, bf16) the two products are ~4 GFLOP against ~5 MB of
// compulsory traffic (x, W1, W2, out), about 800 FLOP per byte, well above
// the card's ~295 FLOP/byte ridge: the bound is the tensor cores. The plain
// composition instead writes and re-reads an [N, F] hidden (4x the size of x)
// and its activation, which is what the TPU kernel was written to avoid.
//
// The float32 forward (ffn_fwd_kernel<float>) is the route of fp32 training
// (the default ASRConfig) and of the fp32 card-against-CPU checks: one block
// owns BM rows of x in shared memory and walks F in chunks of BF, the hidden
// chunk formed and passed through swish in shared memory and multiplied at
// once into a [BM, D2] accumulator there (plain FMAs, no pipelining). The
// bf16 forward is the register-resident ffn_fwd::fwd_kernel further below.
// Neither writes an [N, F] hidden to global memory.
//
// Dropout on the hidden (the reference's _keep_mask) is drawn in every
// launch, from philox.cuh, at the element's global (row, column): the bf16
// kernels per lane with keep8, the fp32 ones (DROP) into a BM x BF byte
// tile in shared memory per hidden chunk with fill_keep_tile. Each kernel
// has a rate-0 instantiation without the draw.
#include "common.cuh"
#include "mma_gemm.cuh"
#include "philox.cuh"

namespace espnet {

// drop: a BM x BF keep tile (bytes) after the accumulator.
struct FfnLayout {
  size_t xs, w1s, hf, hs, w2s, acc, keep, total;
  __host__ __device__ FfnLayout(int d, int d2, int bm, int bf, int esize, bool drop) {
    const int p = 16 / esize;
    xs = 0;
    w1s = align128(xs + (size_t)bm * (d + p) * esize);
    hf = align128(w1s + (size_t)d * (bf + p) * esize);
    hs = align128(hf + (size_t)bm * (bf + 4) * 4);
    w2s = align128(hs + (size_t)bm * (bf + p) * esize);
    acc = align128(w2s + (size_t)bf * (d2 + p) * esize);
    keep = align128(acc + (size_t)bm * (d2 + 4) * 4);
    total = align128(keep + (drop ? (size_t)bm * bf : 0));
  }
};

template <typename T, int BM, int BF, bool DROP>
__global__ void __launch_bounds__(kThreads)
    ffn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
                   const T* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ out,
                   int n, int d, int f, int d2, philox::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  const FfnLayout L(d, d2, BM, BF, sizeof(T), DROP);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* w1s = reinterpret_cast<T*>(smem + L.w1s);
  float* hf = reinterpret_cast<float*>(smem + L.hf);
  T* hs = reinterpret_cast<T*>(smem + L.hs);
  T* w2s = reinterpret_cast<T*>(smem + L.w2s);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  unsigned char* keep = smem + L.keep;  // [BM][BF], DROP only
  const int ldx = d + P, ldw1 = BF + P, ldhf = BF + 4, ldh = BF + P, ldw2 = d2 + P,
            ldacc = d2 + 4;

  const long row0 = (long)blockIdx.x * BM;
  const uint32_t seed = DROP ? (uint32_t)__ldg(drop.seed) : 0u;
  load_rows(xs, ldx, x, d, row0, BM, d, 0, n);
  for (int f0 = 0; f0 < f; f0 += BF) {
    load_rows(w1s, ldw1, w1 + f0, f, 0, d, BF, 0, d);
    load_rows(w2s, ldw2, w2, d2, f0, BF, d2, 0, f);
    if constexpr (DROP) {
      philox::fill_keep_tile<BM, BF>(keep, BF, seed, 0u, (uint32_t)row0, (uint32_t)f0, drop.thr);
    }
    __syncthreads();
    smem_gemm<false>(xs, ldx, w1s, ldw1, hf, ldhf, BM, BF, d, false);
    for (int idx = threadIdx.x; idx < BM * BF; idx += blockDim.x) {
      const int r = idx / BF;
      const int c = idx - r * BF;
      const float s = hf[r * ldhf + c] + b1[f0 + c];
      float h = s / (1.0f + expf(-s));
      if constexpr (DROP) h = keep[r * BF + c] ? h * drop.inv : 0.0f;
      hs[r * ldh + c] = from_f32<T>(h);
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

// drop.seed null: the rate-0 instantiation.
template <typename T, int BM, int BF>
int launch_ffn(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
               void* out, int n, int d, int f, int d2, const philox::Dropout& drop,
               cudaStream_t stream) {
  if (n <= 0 || d % 16 || d2 % 16 || f % BF) return (int)cudaErrorInvalidValue;
  const bool dropping = drop.seed != nullptr;
  const FfnLayout L(d, d2, BM, BF, sizeof(T), dropping);
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (L.total > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
  auto kernel = dropping ? ffn_fwd_kernel<T, BM, BF, true> : ffn_fwd_kernel<T, BM, BF, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  const dim3 grid((n + BM - 1) / BM);
  kernel<<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
      static_cast<T*>(out), n, d, f, d2, drop);
  return (int)cudaGetLastError();
}


// ---- Forward, bf16: S, hd and O in registers --------------------------------
//
// Replaces espnet_slurp_tpu/ops/pallas/ffn.py:_fwd_kernel (the pallas_call
// of fused_ffn at :186) in bf16, at its rounding points:
//   s = x W1 + b1 (fp32), h = s sigmoid(s), hd = bf16(keep ? h / (1 - rate)
//   : 0), out = bf16(hd W2 + b2).
// Dropout (DROP): the keep bits of (row n, column f) come from philox.cuh,
// two Philox calls a lane a tile of 32 columns (8 elements each), drawn
// before S's products so that their registers are free again when S is
// live; at rate 0 the kernel is instantiated without them.
//
// Bound: the tensor cores. The two products are 4 N D F operations (D2 = D):
// 31.4 GFLOP at the flagship train shape (N = 64 x 468, D 256, F 1024),
// 0.032 ms at 989 TFLOP/s, against ~16 MB of compulsory traffic (0.005 ms).
//
// Design (K3's register-resident forward, with F in place of the keys): one
// block of 4 warps owns BM = 64 rows of x, kept in shared memory for the
// block's life. Warp w owns rows 16 w .. 16 w + 15 and all D2 output
// columns; their fp32 accumulator O (16 x D2, 128 registers at D2 256) stays
// in registers. The block walks its range of F in tiles of BF = 32:
//   - W1[:, tile] and W2[tile, :] stream through a 2-stage cp.async ring;
//   - S = x W1[:, tile] (16 x 32 a warp) comes from mma.sync into register
//     accumulators, x's A fragments read from shared memory each k-step;
//   - bias and swish are applied there, and hd is rounded to bf16 and packed
//     straight into two A fragments, as the attention forward packs P;
//   - O += hd W2[tile, :] by mma::warp_mma_k16_ra, W2 read as an MN-major B.
// The epilogue adds b2, rounds and stores bf16 pairs. 108,544 B of shared
// memory at D 256, D2 256: two blocks an SM (8 warps).
//
// Occupancy: 64-row tiles give 468 blocks at the train shape and 234 at the
// transducer's, but only 59 at the serving shape (N = 8 x 471) for 132 SMs x
// 2 slots. There the F range is split across blocks (fsplit 2 or 4, chosen
// on the host as the count that needs the fewest waves per unit of work):
// each block writes fp32 partials [fsplit, N, D2] that reduce_kernel sums in
// a fixed order (deterministic) before adding b2 and rounding. Smaller row
// tiles were the other way; they would re-read all of W1 and W2 (1 MB) once
// per 32 rows at every shape, and halve the work that each x load feeds.

namespace ffn_fwd {

constexpr int BM = 64, BF = 32, kWarps = BM / 16, kThreadsFwd = kWarps * 32;
constexpr int LDW1 = BF + 8;  // W1 tile rows: 80 bytes, 8 rows on 8 distinct bank groups

// Shared memory: x [BM][d + 8], then 2 stages of (W1 tile [d][BF + 8], W2
// tile [BF][D2 + 8]), all bf16.
template <int D2>
struct Layout {
  static constexpr int LDW2 = D2 + 8;
  __host__ __device__ static size_t x_elems(int d) { return (size_t)BM * (d + 8); }
  __host__ __device__ static size_t w1_elems(int d) { return (size_t)d * LDW1; }
  __host__ __device__ static size_t stage_elems(int d) {
    return w1_elems(d) + (size_t)BF * LDW2;
  }
  __host__ __device__ static size_t bytes(int d) {
    return sizeof(bf16) * (x_elems(d) + 2 * stage_elems(d));
  }
};

// rows x cols (cols a multiple of 8) of p (leading dimension ld) from (r0,
// c0) into s (leading dimension lds); rows at or past rlim are zero-filled.
__device__ __forceinline__ void load_async(bf16* s, int lds, const bf16* p, long ld, long r0,
                                           long c0, int rows, int cols, long rlim) {
  const int ch = cols >> 3;
  for (int idx = threadIdx.x; idx < rows * ch; idx += kThreadsFwd) {
    const int r = idx / ch;
    const int c = (idx - r * ch) * 8;
    const bool ok = r0 + r < rlim;
    mma::cp_async16(s + r * lds + c, ok ? p + (r0 + r) * ld + c0 + c : p, ok);
  }
}

// Block (row tile, split): O over F range split * (f / nsplit) .. + f /
// nsplit; with nsplit 1 it writes out, else fp32 partials part[split].
template <int D2, bool DROP>
__global__ void __launch_bounds__(kThreadsFwd, 2)
    fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, bf16* __restrict__ out, float* __restrict__ part,
               int n, int d, int f, philox::Dropout drop) {
  using L = Layout<D2>;
  constexpr int NC = D2 / 32;  // chunks of 4 n8 tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ring = xs + L::x_elems(d);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long m0 = (long)blockIdx.x * BM;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int frange = f / nsplit;  // a multiple of BF (the host checks)
  const int fbeg = split * frange;
  const int nft = frange / BF;
  const int ldx = d + 8;
  auto w1s = [&](int slot) { return ring + slot * L::stage_elems(d); };
  auto w2s = [&](int slot) { return ring + slot * L::stage_elems(d) + L::w1_elems(d); };
  auto load_stage = [&](int ft) {
    const long f0 = fbeg + (long)ft * BF;
    load_async(w1s(ft & 1), LDW1, w1, f, 0, f0, d, BF, d);
    load_async(w2s(ft & 1), L::LDW2, w2, D2, f0, 0, BF, D2, f);
  };
  load_async(xs, ldx, x, d, m0, 0, BM, d, n);
  load_stage(0);
  mma::cp_async_commit();
  const uint32_t seed = DROP ? (uint32_t)__ldg(drop.seed) : 0u;
  const uint32_t krow = (uint32_t)(m0 + warp * 16 + g);  // the lane's first row

  float o[NC][4][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][j][e] = 0.0f;

  for (int ft = 0; ft < nft; ++ft) {
    mma::cp_async_wait<0>();
    __syncthreads();  // stage ft (and x) landed; stage ft - 1's readers are done
    if (ft + 1 < nft) load_stage(ft + 1);
    mma::cp_async_commit();
    const bf16* w1t = w1s(ft & 1);
    const bf16* w2t = w2s(ft & 1);
    const int f0 = fbeg + ft * BF;
    // Keep bits of the lane's 16 hidden elements of this tile: n8 tiles
    // (0, 1) in bits 0-7, (2, 3) in bits 8-15.
    uint32_t kb = 0;
    if constexpr (DROP) {
      kb = philox::keep8(seed, 0u, krow, (uint32_t)(f0 + 2 * tq), drop.thr) |
           philox::keep8(seed, 0u, krow, (uint32_t)(f0 + 16 + 2 * tq), drop.thr) << 8;
    }

    float s[1][4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[0][j][e] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < d; kk += 16) {
      mma::warp_mma_k16<1, 4, mma::Major::K, mma::Major::MN>(s, xs, ldx, w1t, LDW1, warp * 16, 0,
                                                             kk);
    }

    // hd = bf16(dropout(swish(s + b1))), element (g + 8 hf, 8 j + 2 tq + e)
    // of the warp's 16 x 32 tile, packed as the A fragments of k-steps j / 2.
    uint32_t a[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(b1 + f0 + 8 * j + 2 * tq);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float s0 = s[0][j][2 * hf] + bb.x, s1 = s[0][j][2 * hf + 1] + bb.y;
        float h0 = s0 / (1.0f + __expf(-s0)), h1 = s1 / (1.0f + __expf(-s1));
        if constexpr (DROP) {
          const uint32_t k8 = kb >> (8 * (j >> 1));
          h0 = philox::kept(k8, hf, j & 1, 0) ? h0 * drop.inv : 0.0f;
          h1 = philox::kept(k8, hf, j & 1, 1) ? h1 * drop.inv : 0.0f;
        }
        __nv_bfloat162 hk = __floats2bfloat162_rn(h0, h1);
        a[j >> 1][2 * (j & 1) + hf] = *reinterpret_cast<uint32_t*>(&hk);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        mma::warp_mma_k16_ra<4, mma::Major::MN>(o[c], a[kk], w2t, L::LDW2, 32 * c, 16 * kk);
      }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const long row = m0 + warp * 16 + g + 8 * hf;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 32 * c + 8 * j + 2 * tq;
        const float v0 = o[c][j][2 * hf], v1 = o[c][j][2 * hf + 1];
        if (nsplit == 1) {
          const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
          *reinterpret_cast<__nv_bfloat162*>(out + row * D2 + col) =
              __floats2bfloat162_rn(v0 + bb.x, v1 + bb.y);
        } else {
          *reinterpret_cast<float2*>(part + ((long)split * n + row) * D2 + col) =
              make_float2(v0, v1);
        }
      }
  }
}

// out = bf16(sum over splits of part + b2), four elements a thread, the
// splits added in order.
__global__ void __launch_bounds__(256)
    reduce_kernel(const float* __restrict__ part, const float* __restrict__ b2,
                  bf16* __restrict__ out, long total, int d2, int nsplit) {
  const long i = ((long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= total) return;
  float4 acc = *reinterpret_cast<const float4*>(part + i);
  for (int sp = 1; sp < nsplit; ++sp) {
    const float4 p = *reinterpret_cast<const float4*>(part + sp * total + i);
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  const float4 bb = *reinterpret_cast<const float4*>(b2 + i % d2);
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(acc.x + bb.x, acc.y + bb.y);
  *reinterpret_cast<__nv_bfloat162*>(out + i + 2) =
      __floats2bfloat162_rn(acc.z + bb.z, acc.w + bb.w);
}

// Sets fwd_kernel<D2, *>'s shared-memory attributes for width d; returns
// its blocks per SM (0: the shape does not fit). Both variants share the
// shared memory and the register cap, so one occupancy serves both.
template <int D2>
int configure(int d) {
  const size_t bytes = Layout<D2>::bytes(d);
  int dev = 0, max_smem = 0, nb = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > (size_t)max_smem) return 0;
  for (auto kernel : {fwd_kernel<D2, false>, fwd_kernel<D2, true>}) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
  }
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, fwd_kernel<D2, false>, kThreadsFwd, bytes);
  return nb;
}

inline bool shape_ok(int n, int d, int f) { return n > 0 && d > 0 && d % 16 == 0 && f % BF == 0; }

// Blocks of fwd_kernel<d2> that fit one SM at width d (the attributes set);
// 0 for an output width it is not built for or a d that does not fit.
inline int blocks_per_sm(int d, int d2) {
  if (d <= 0 || d % 16) return 0;
  switch (d2) {
    case 32: return configure<32>(d);
    case 64: return configure<64>(d);
    case 128: return configure<128>(d);
    case 256: return configure<256>(d);
    default: return 0;
  }
}

// The F split for n rows: the count in {1, 2, 4} that divides F into whole
// tiles and needs the fewest waves per unit of work (ties to the smaller);
// 0 when the kernel cannot take the shape.
inline int splits(int n, int d, int f, int d2) {
  if (!shape_ok(n, d, f)) return 0;
  const int nb = blocks_per_sm(d, d2);
  if (nb <= 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long slots = (long)nb * sms, tiles = (n + BM - 1) / BM;
  int best = 1;
  double best_cost = (double)((tiles + slots - 1) / slots);
  for (int fs = 2; fs <= 4; fs *= 2) {
    if (f % (fs * BF)) continue;
    const double cost = (double)((tiles * fs + slots - 1) / slots) / fs;
    if (cost < best_cost) {
      best = fs;
      best_cost = cost;
    }
  }
  return best;
}

template <int D2>
int launch_d2(const bf16* x, const bf16* w1, const float* b1, const bf16* w2, const float* b2,
              bf16* out, float* part, int nsplit, int n, int d, int f,
              const philox::Dropout& drop, cudaStream_t stream) {
  const dim3 grid((unsigned)((n + BM - 1) / BM), nsplit);
  const size_t bytes = Layout<D2>::bytes(d);
  if (drop.seed) {
    fwd_kernel<D2, true><<<grid, kThreadsFwd, bytes, stream>>>(x, w1, b1, w2, b2, out, part, n, d,
                                                               f, drop);
  } else {
    fwd_kernel<D2, false><<<grid, kThreadsFwd, bytes, stream>>>(x, w1, b1, w2, b2, out, part, n,
                                                                d, f, drop);
  }
  return (int)cudaGetLastError();
}

inline int launch(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                  const float* b2, bf16* out, float* part, int nsplit, int n, int d, int f,
                  int d2, const philox::Dropout& drop, cudaStream_t stream) {
  if (!shape_ok(n, d, f) || nsplit < 1 || f % (nsplit * BF) || (nsplit > 1 && !part)) {
    return (int)cudaErrorInvalidValue;
  }
  if (blocks_per_sm(d, d2) <= 0) return (int)cudaErrorInvalidValue;
  const auto run = [&](auto launch_w) {
    return launch_w(x, w1, b1, w2, b2, out, part, nsplit, n, d, f, drop, stream);
  };
  int err = (int)cudaErrorInvalidValue;
  switch (d2) {
    case 32: err = run(launch_d2<32>); break;
    case 64: err = run(launch_d2<64>); break;
    case 128: err = run(launch_d2<128>); break;
    case 256: err = run(launch_d2<256>); break;
  }
  if (err || nsplit == 1) return err;
  const long total = (long)n * d2;
  reduce_kernel<<<(unsigned)((total / 4 + 255) / 256), 256, 0, stream>>>(part, b2, out, total,
                                                                         d2, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace ffn_fwd

// ---- Backward, float32 ----------------------------------------------------
//
// The fp32 instantiation of espnet_slurp_tpu/ops/pallas/ffn.py:_bwd_kernel,
// the route of fp32 training and of the fp32 card-against-CPU checks (the
// bf16 backward is the tensor-core version further below). From the output
// cotangent g it recomputes s = x W1 + b1 chunk by chunk over F and forms
//   hd = keep ? s sig(s) / (1 - rate) : 0, dW2 = hd^T g, db2 = sum g,
//   dh = keep ? (g W2^T) / (1 - rate) : 0, ds = dh * swish'(s),
//   dW1 = x^T ds, db1 = sum ds, dx = ds W1^T,
// with swish'(s) = sig(s) (1 + s (1 - sig(s))) and keep the forward's mask
// (DROP: drawn again into a BM x BF byte tile per row tile and hidden
// chunk, as the forward draws it). Two kernels, each
// recomputing s and dh: dx (one block per BM rows, F walked in BF chunks, the
// [BM, D] accumulator in shared memory) and dw (one block per (F chunk, row
// split), dW1^T / dW2 / db1 / db2 accumulated over the split's row tiles in
// shared memory and written as per-split partials that the wrapper sums:
// deterministic, no atomics).

struct FfnBwdLayout {
  size_t xs, gs, w1s, w2s, sf, dhf, t1, t2, acc1, acc2, db1, db2, keep, total;
  __host__ __device__ FfnBwdLayout(int d, int d2, int bm, int bf, int esize, bool dw,
                                   bool drop) {
    const int p = 16 / esize;
    xs = 0;
    gs = align128(xs + (size_t)bm * (d + p) * esize);
    w1s = align128(gs + (size_t)bm * (d2 + p) * esize);
    w2s = align128(w1s + (size_t)d * (bf + p) * esize);
    sf = align128(w2s + (size_t)bf * (d2 + p) * esize);
    dhf = align128(sf + (size_t)bm * (bf + 4) * 4);
    t1 = align128(dhf + (size_t)bm * (bf + 4) * 4);
    // dx: t1 = ds [BM, BF], acc1 = dx [BM, D]. dw: t1 = hd^T, t2 = ds^T
    // [BF, BM]; acc1 = dW1^T [BF, D], acc2 = dW2 [BF, D2].
    const size_t tb = dw ? (size_t)bf * (bm + p) * esize : (size_t)bm * (bf + p) * esize;
    t2 = align128(t1 + tb);
    acc1 = align128(t2 + (dw ? tb : 0));
    acc2 = align128(acc1 + (size_t)(dw ? bf : bm) * (d + 4) * 4);
    db1 = align128(acc2 + (dw ? (size_t)bf * (d2 + 4) * 4 : 0));
    db2 = align128(db1 + (size_t)bf * 4);
    keep = align128(db2 + (dw ? (size_t)d2 * 4 : 0));  // [BM][BF] bytes, drop only
    total = align128(keep + (drop ? (size_t)bm * bf : 0));
  }
};

template <typename T, int BM, int BF, bool DROP>
__global__ void __launch_bounds__(kThreads)
    ffn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ w2,
                      const T* __restrict__ g, T* __restrict__ dx, int n, int d, int f, int d2,
                      philox::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  const FfnBwdLayout L(d, d2, BM, BF, sizeof(T), false, DROP);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* gs = reinterpret_cast<T*>(smem + L.gs);
  T* w1s = reinterpret_cast<T*>(smem + L.w1s);
  T* w2s = reinterpret_cast<T*>(smem + L.w2s);
  float* sf = reinterpret_cast<float*>(smem + L.sf);
  float* dhf = reinterpret_cast<float*>(smem + L.dhf);
  T* dss = reinterpret_cast<T*>(smem + L.t1);
  float* acc = reinterpret_cast<float*>(smem + L.acc1);
  unsigned char* keep = smem + L.keep;  // [BM][BF], DROP only
  const int ldx = d + P, ldg = d2 + P, ldw1 = BF + P, ldw2 = d2 + P, ldf = BF + 4, ldds = BF + P,
            ldacc = d + 4;

  const long row0 = (long)blockIdx.x * BM;
  const uint32_t seed = DROP ? (uint32_t)__ldg(drop.seed) : 0u;
  load_rows(xs, ldx, x, d, row0, BM, d, 0, n);
  load_rows(gs, ldg, g, d2, row0, BM, d2, 0, n);
  for (int f0 = 0; f0 < f; f0 += BF) {
    load_rows(w1s, ldw1, w1 + f0, f, 0, d, BF, 0, d);
    load_rows(w2s, ldw2, w2, d2, f0, BF, d2, 0, f);
    if constexpr (DROP) {
      philox::fill_keep_tile<BM, BF>(keep, BF, seed, 0u, (uint32_t)row0, (uint32_t)f0, drop.thr);
    }
    __syncthreads();
    smem_gemm<false>(xs, ldx, w1s, ldw1, sf, ldf, BM, BF, d, false);
    smem_gemm<true>(gs, ldg, w2s, ldw2, dhf, ldf, BM, BF, d2, false);
    for (int idx = threadIdx.x; idx < BM * BF; idx += blockDim.x) {
      const int r = idx / BF;
      const int c = idx - r * BF;
      const float s = sf[r * ldf + c] + b1[f0 + c];
      const float sig = 1.0f / (1.0f + expf(-s));
      float dh = dhf[r * ldf + c];
      if constexpr (DROP) dh = keep[r * BF + c] ? dh * drop.inv : 0.0f;
      dss[r * ldds + c] = from_f32<T>(dh * sig * (1.0f + s * (1.0f - sig)));
    }
    __syncthreads();
    smem_gemm<true>(dss, ldds, w1s, ldw1, acc, ldacc, BM, d, BF, f0 > 0);
  }
  const int valid = min(BM, n - (int)row0);
  for (int idx = threadIdx.x; idx < valid * d; idx += blockDim.x) {
    const int r = idx / d;
    const int c = idx - r * d;
    dx[(row0 + r) * d + c] = from_f32<T>(acc[r * ldacc + c]);
  }
}

template <typename T, int BM, int BF, bool DROP>
__global__ void __launch_bounds__(kThreads)
    ffn_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ w2,
                      const T* __restrict__ g, float* __restrict__ dw1p, float* __restrict__ db1p,
                      float* __restrict__ dw2p, float* __restrict__ db2p, int n, int d, int f,
                      int d2, philox::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = pad_of<T>();
  const FfnBwdLayout L(d, d2, BM, BF, sizeof(T), true, DROP);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* gs = reinterpret_cast<T*>(smem + L.gs);
  T* w1s = reinterpret_cast<T*>(smem + L.w1s);
  T* w2s = reinterpret_cast<T*>(smem + L.w2s);
  float* sf = reinterpret_cast<float*>(smem + L.sf);
  float* dhf = reinterpret_cast<float*>(smem + L.dhf);
  T* hdt = reinterpret_cast<T*>(smem + L.t1);
  T* dst = reinterpret_cast<T*>(smem + L.t2);
  float* acc1 = reinterpret_cast<float*>(smem + L.acc1);
  float* acc2 = reinterpret_cast<float*>(smem + L.acc2);
  float* db1 = reinterpret_cast<float*>(smem + L.db1);
  float* db2 = reinterpret_cast<float*>(smem + L.db2);
  unsigned char* keep = smem + L.keep;  // [BM][BF], DROP only
  const uint32_t seed = DROP ? (uint32_t)__ldg(drop.seed) : 0u;
  const int ldx = d + P, ldg = d2 + P, ldw1 = BF + P, ldw2 = d2 + P, ldf = BF + 4, ldt = BM + P,
            lda1 = d + 4, lda2 = d2 + 4;
  const int f0 = blockIdx.x * BF;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const bool first_chunk = blockIdx.x == 0;
  const int ntiles = (n + BM - 1) / BM;

  for (int idx = threadIdx.x; idx < BF * d; idx += blockDim.x) {
    acc1[(idx / d) * lda1 + idx % d] = 0.0f;
  }
  for (int idx = threadIdx.x; idx < BF * d2; idx += blockDim.x) {
    acc2[(idx / d2) * lda2 + idx % d2] = 0.0f;
  }
  for (int c = threadIdx.x; c < BF; c += blockDim.x) db1[c] = 0.0f;
  for (int c = threadIdx.x; c < d2; c += blockDim.x) db2[c] = 0.0f;
  load_rows(w1s, ldw1, w1 + f0, f, 0, d, BF, 0, d);
  load_rows(w2s, ldw2, w2, d2, f0, BF, d2, 0, f);
  for (int tile = split; tile < ntiles; tile += nsplit) {
    const long row0 = (long)tile * BM;
    __syncthreads();  // the previous tile's readers of xs / gs are done
    load_rows(xs, ldx, x, d, row0, BM, d, 0, n);
    load_rows(gs, ldg, g, d2, row0, BM, d2, 0, n);
    if constexpr (DROP) {
      philox::fill_keep_tile<BM, BF>(keep, BF, seed, 0u, (uint32_t)row0, (uint32_t)f0, drop.thr);
    }
    __syncthreads();
    smem_gemm<false>(xs, ldx, w1s, ldw1, sf, ldf, BM, BF, d, false);
    smem_gemm<true>(gs, ldg, w2s, ldw2, dhf, ldf, BM, BF, d2, false);
    const int valid = min(BM, n - (int)row0);
    for (int idx = threadIdx.x; idx < BM * BF; idx += blockDim.x) {
      const int r = idx / BF;
      const int c = idx - r * BF;
      float h = 0.0f, ds = 0.0f;
      if (r < valid) {
        const float s = sf[r * ldf + c] + b1[f0 + c];
        const float sig = 1.0f / (1.0f + expf(-s));
        float dh = dhf[r * ldf + c];
        h = s * sig;
        if constexpr (DROP) {
          const bool on = keep[r * BF + c];
          h = on ? h * drop.inv : 0.0f;
          dh = on ? dh * drop.inv : 0.0f;
        }
        ds = dh * sig * (1.0f + s * (1.0f - sig));
      }
      hdt[c * ldt + r] = from_f32<T>(h);
      dst[c * ldt + r] = from_f32<T>(ds);
      sf[r * ldf + c] = ds;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < BF; c += blockDim.x) {
      float sum = 0.0f;
      for (int r = 0; r < valid; ++r) sum += sf[r * ldf + c];
      db1[c] += sum;
    }
    if (first_chunk) {
      for (int c = threadIdx.x; c < d2; c += blockDim.x) {
        float sum = 0.0f;
        for (int r = 0; r < valid; ++r) sum += to_f32(gs[r * ldg + c]);
        db2[c] += sum;
      }
    }
    smem_gemm<false>(hdt, ldt, gs, ldg, acc2, lda2, BF, d2, BM, true);
    smem_gemm<false>(dst, ldt, xs, ldx, acc1, lda1, BF, d, BM, true);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BF * d; idx += blockDim.x) {
    const int k = idx / BF;  // consecutive threads: consecutive F columns
    const int c = idx - k * BF;
    dw1p[((size_t)split * d + k) * f + f0 + c] = acc1[c * lda1 + k];
  }
  for (int idx = threadIdx.x; idx < BF * d2; idx += blockDim.x) {
    const int c = idx / d2;
    const int k = idx - c * d2;
    dw2p[((size_t)split * f + f0 + c) * d2 + k] = acc2[c * lda2 + k];
  }
  for (int c = threadIdx.x; c < BF; c += blockDim.x) db1p[(size_t)split * f + f0 + c] = db1[c];
  if (first_chunk) {
    for (int c = threadIdx.x; c < d2; c += blockDim.x) db2p[(size_t)split * d2 + c] = db2[c];
  }
}

// drop.seed null: the rate-0 instantiations.
template <typename T, int BM, int BF>
int launch_ffn_bwd(const void* x, const void* w1, const float* b1, const void* w2, const void* g,
                   void* dx, float* dw1p, float* db1p, float* dw2p, float* db2p, int nsplit,
                   int n, int d, int f, int d2, const philox::Dropout& drop,
                   cudaStream_t stream) {
  if (n <= 0 || d % 16 || d2 % 16 || f % BF || nsplit <= 0 || nsplit > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const bool dropping = drop.seed != nullptr;
  const FfnBwdLayout Lx(d, d2, BM, BF, sizeof(T), false, dropping);
  const FfnBwdLayout Lw(d, d2, BM, BF, sizeof(T), true, dropping);
  if (Lx.total > (size_t)max_smem || Lw.total > (size_t)max_smem) {
    return (int)cudaErrorInvalidConfiguration;
  }
  auto kx = dropping ? ffn_bwd_dx_kernel<T, BM, BF, true> : ffn_bwd_dx_kernel<T, BM, BF, false>;
  auto kw = dropping ? ffn_bwd_dw_kernel<T, BM, BF, true> : ffn_bwd_dw_kernel<T, BM, BF, false>;
  cudaFuncSetAttribute(kx, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lx.total);
  cudaFuncSetAttribute(kw, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lw.total);
  const T* xt = static_cast<const T*>(x);
  const T* w1t = static_cast<const T*>(w1);
  const T* w2t = static_cast<const T*>(w2);
  const T* gt = static_cast<const T*>(g);
  kx<<<(n + BM - 1) / BM, kThreads, Lx.total, stream>>>(xt, w1t, b1, w2t, gt, static_cast<T*>(dx),
                                                        n, d, f, d2, drop);
  if (int err = (int)cudaGetLastError()) return err;
  kw<<<dim3(f / BF, nsplit), kThreads, Lw.total, stream>>>(xt, w1t, b1, w2t, gt, dw1p, db1p, dw2p,
                                                          db2p, n, d, f, d2, drop);
  return (int)cudaGetLastError();
}


// ---- Backward, bf16: three tensor-core GEMM kernels -------------------------
//
// Replaces espnet_slurp_tpu/ops/pallas/ffn.py:_bwd_kernel (the pallas_call of
// fused_ffn's core_bwd) in bf16. It computes, with the reference's rounding
// points and fp32 accumulation,
//   s = x W1 + b1; sig = sigmoid(s); hd = bf16(keep ? s sig / (1 - rate) : 0)
//   dW2 = hd^T g; db2 = sum g; dh = keep ? (g W2^T) / (1 - rate) : 0
//   ds = dh sig (1 + s (1 - sig)); dW1 = x^T bf16(ds); db1 = sum ds (fp32);
//   dx = bf16(ds) W1^T.
// Dropout touches only `rows`: it draws the forward's keep bits again
// (philox.cuh, four Philox calls a lane a block) and writes the dropped hd
// and the masked ds, which dx and dw read as they are.
//
// Bound: the tensor cores. The five products are 10 N D F operations (D2 =
// D): 78.5 GFLOP at the flagship train shape (N = 64 x 468, D 256, F 1024),
// 0.0794 ms at 989 TFLOP/s, against ~19 MB of compulsory traffic (0.006 ms
// at 3.35 TB/s).
//
// Why scratch, not the TPU's single pass: the TPU kernel walks row tiles in
// order on one core and sums dW1 / dW2 in VMEM across its grid. 132 SMs
// running blocks in no order cannot carry a sum from block to block, and a
// block that recomputes s and dh for its own dW tile (the fp32 path above)
// repeats two of the five products. So the hidden is formed once, by
// `rows`, and written as two bf16 [N, F] scratch tensors (hd and ds: 2 x 61
// MB at the flagship shape, ~0.07 ms of extra traffic); `dx` and `dw` then
// read them. Every product is the register-accumulator mainloop of
// mma_gemm.cuh fed by a 4-stage cp.async ring:
//   rows  grid (F / 64, N / 128): S = x W1[:, tile] and DH = g W2[tile, :]^T
//         into two 128 x 64 register tiles; the epilogue writes hd and ds
//         (bf16), zeroes rows >= N, and writes the fp32 column sums of ds
//         as one db1 partial per row tile.
//   dx    grid (D / 128, N / 128): DS W1^T, both operands K-contiguous.
//   dw    grid (dW1 tiles + dW2 tiles, S splits of N): dW1 = x^T DS and
//         dW2 = H^T g as 128 x 128 tiles (both operands N-row-major, read
//         through ldmatrix.trans), each split writing fp32 partials; the
//         blocks of dW2's first row of tiles also sum g's columns (db2)
//         from the stages as they land.
// The wrapper sums the partials (deterministic, no atomics). The scratch
// lives only for the call; the forward still keeps no hidden.

namespace ffn_bwd {

using mma::Gemm;
using mma::Major;
constexpr int kStages = 4;
constexpr int kRowTile = 128;  // rows of N per rows / dx block, and per db1 partial
constexpr int kRowsF = 64;     // F columns per rows block
// rows: both products share the warp layout (4 x 2 warps of 32 x 32), so
// their accumulators line up element for element.
using RowsS = Gemm<kRowTile, kRowsF, 32, 32, 32, kStages, Major::K, Major::MN>;
using RowsDH = Gemm<kRowTile, kRowsF, 32, 32, 32, kStages, Major::K, Major::K>;
using Dx = Gemm<kRowTile, 128, 32, 64, 32, kStages, Major::K, Major::K>;
using Dw = Gemm<128, 128, 32, 64, 32, kStages, Major::MN, Major::MN>;
constexpr size_t kRowsSmem =
    RowsS::kSmemBytes > RowsDH::kSmemBytes ? RowsS::kSmemBytes : RowsDH::kSmemBytes;
static_assert(RowsS::kThreads == kThreads && RowsDH::kThreads == kThreads &&
                  Dx::kThreads == kThreads && Dw::kThreads == kThreads,
              "one block shape");

__host__ __device__ constexpr long cdiv(long a, long b) { return (a + b - 1) / b; }

template <bool DROP>
__global__ void __launch_bounds__(kThreads, 2)
    rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const bf16* __restrict__ g, bf16* __restrict__ hd, bf16* __restrict__ ds,
                float* __restrict__ db1p, int n, int d, int f, int d2, philox::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const long n0 = (long)blockIdx.x * kRowsF;
  const long m0 = (long)blockIdx.y * kRowTile;
  // Keep bits of the lane's 32 elements: m16 tile i and n8 tiles (2 jp,
  // 2 jp + 1) in bits 8 (2 i + jp) .. + 7.
  uint32_t kb = 0;
  if constexpr (DROP) {
    const uint32_t seed = (uint32_t)__ldg(drop.seed);
#pragma unroll
    for (int i = 0; i < RowsS::MT; ++i)
#pragma unroll
      for (int jp = 0; jp < RowsS::NT / 2; ++jp) {
        kb |= philox::keep8(seed, 0u, (uint32_t)(m0 + RowsS::frag_row(i, 0)),
                            (uint32_t)(n0 + RowsS::frag_col(2 * jp)), drop.thr)
              << (8 * (2 * i + jp));
      }
  }
  static_assert(RowsS::MT * RowsS::NT / 2 * 8 <= 32, "keep bits in one word");
  RowsS::Acc s, dh;
  RowsS::zero(s);
  RowsS::zero(dh);
  RowsS::run(s, ring, x, d, w1, f, m0, n0, n, f, 0, d);     // x [N, D] . W1 [D, F]
  RowsDH::run(dh, ring, g, d2, w2, d2, m0, n0, n, f, 0, d2);  // g [N, D2] . W2 [F, D2]^T

  float csum[RowsS::NT][2];
#pragma unroll
  for (int j = 0; j < RowsS::NT; ++j) {
    const long c = n0 + RowsS::frag_col(j);
    const bool col_ok = c < f;  // F is a multiple of the tile: always, kept as a guard
    const float bias0 = col_ok ? b1[c] : 0.0f, bias1 = col_ok ? b1[c + 1] : 0.0f;
    csum[j][0] = csum[j][1] = 0.0f;
#pragma unroll
    for (int i = 0; i < RowsS::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long r = m0 + RowsS::frag_row(i, h);
        float hv[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sv = s[i][j][2 * h + e] + (e ? bias1 : bias0);
          const float sig = 1.0f / (1.0f + __expf(-sv));
          float dhv = dh[i][j][2 * h + e];
          hv[e] = sv * sig;
          if constexpr (DROP) {
            const bool keep = philox::kept(kb >> (8 * (2 * i + (j >> 1))), h, j & 1, e);
            hv[e] = keep ? hv[e] * drop.inv : 0.0f;
            dhv = keep ? dhv * drop.inv : 0.0f;
          }
          dv[e] = dhv * sig * (1.0f + sv * (1.0f - sig));
        }
        if (r < n) {
          if (col_ok) {
            *reinterpret_cast<__nv_bfloat162*>(hd + r * f + c) =
                __floats2bfloat162_rn(hv[0], hv[1]);
            *reinterpret_cast<__nv_bfloat162*>(ds + r * f + c) =
                __floats2bfloat162_rn(dv[0], dv[1]);
          }
          csum[j][0] += dv[0];  // rows >= N add nothing
          csum[j][1] += dv[1];
        }
      }
  }
  // Column sums: over the 8 lanes that share a column pair, then over the
  // 4 warps along M through shared memory (the ring is free after run).
  float* red = reinterpret_cast<float*>(smem);  // [4][kRowsF]
  const int warp_m = (threadIdx.x >> 5) / RowsS::kWarpsN;
#pragma unroll
  for (int j = 0; j < RowsS::NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = csum[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if ((threadIdx.x & 31) < 4) red[warp_m * kRowsF + RowsS::frag_col(j) + e] = v;
    }
  __syncthreads();
  if (threadIdx.x < kRowsF && n0 + threadIdx.x < f) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kRowTile / 32; ++w) v += red[w * kRowsF + threadIdx.x];
    db1p[(long)blockIdx.y * f + n0 + threadIdx.x] = v;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    dx_kernel(const bf16* __restrict__ ds, const bf16* __restrict__ w1, bf16* __restrict__ dx,
              int n, int d, int f) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long n0 = (long)blockIdx.x * 128;
  const long m0 = (long)blockIdx.y * kRowTile;
  Dx::Acc acc;
  Dx::zero(acc);
  // DS [N, F] . W1 [D, F]^T
  Dx::run(acc, reinterpret_cast<bf16*>(smem), ds, f, w1, f, m0, n0, n, d, 0, f);
  Dx::epilogue(acc, [&](int r, int c, float v0, float v1) {
    const long row = m0 + r, col = n0 + c;
    if (row < n && col < d) {
      *reinterpret_cast<__nv_bfloat162*>(dx + row * d + col) = __floats2bfloat162_rn(v0, v1);
    }
  });
}

// Column sums of dw's B stage (g rows [BK, 128], MN-major): thread t sums
// column t % 128 over half t / 128 of the stage's rows.
struct ColumnSum {
  bool on;
  float sum;
  __device__ __forceinline__ void operator()(const bf16*, const bf16* sb) {
    if (!on) return;
    const bf16* p = sb + (threadIdx.x >> 7) * 16 * Dw::B_LD + (threadIdx.x & 127);
#pragma unroll
    for (int r = 0; r < 16; ++r) sum += __bfloat162float(p[r * Dw::B_LD]);
  }
};

__global__ void __launch_bounds__(kThreads, 2)
    dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ds, const bf16* __restrict__ hd,
              const bf16* __restrict__ g, float* __restrict__ dw1p, float* __restrict__ dw2p,
              float* __restrict__ db2p, int n, int d, int f, int d2, long kchunk) {
  static_assert(kThreads == 2 * 128 && Dw::B_LD == 128 + 8, "ColumnSum's thread map");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const long split = blockIdx.y;
  const long k0 = split * kchunk, k1 = k0 + kchunk < n ? k0 + kchunk : n;
  const int tiles1 = (int)(cdiv(d, 128) * cdiv(f, 128));
  int t = blockIdx.x;
  Dw::Acc acc;
  Dw::zero(acc);
  long m0, n0, rows, cols;
  float* out;
  ColumnSum db2{false, 0.0f};
  if (t < tiles1) {  // dW1 [D, F] = x^T [D, N] . DS [N, F]
    const int tn = (int)cdiv(f, 128);
    m0 = (long)(t / tn) * 128;
    n0 = (long)(t % tn) * 128;
    rows = d;
    cols = f;
    out = dw1p + split * d * f;
    Dw::run(acc, ring, x, d, ds, f, m0, n0, d, f, k0, k1);
  } else {  // dW2 [F, D2] = H^T [F, N] . g [N, D2]
    t -= tiles1;
    const int tn = (int)cdiv(d2, 128);
    m0 = (long)(t / tn) * 128;
    n0 = (long)(t % tn) * 128;
    rows = f;
    cols = d2;
    out = dw2p + split * f * d2;
    db2.on = m0 == 0;
    Dw::run(acc, ring, hd, f, g, d2, m0, n0, f, d2, k0, k1, db2);
  }
  Dw::epilogue(acc, [&](int r, int c, float v0, float v1) {
    const long row = m0 + r, col = n0 + c;
    if (row < rows && col < cols) {
      *reinterpret_cast<float2*>(out + row * cols + col) = make_float2(v0, v1);
    }
  });
  if (db2.on) {  // block-uniform
    float* red = reinterpret_cast<float*>(smem);  // [2][128]; the ring is free after run
    red[threadIdx.x] = db2.sum;
    __syncthreads();
    if (threadIdx.x < 128 && n0 + threadIdx.x < d2) {
      db2p[split * d2 + n0 + threadIdx.x] = red[threadIdx.x] + red[128 + threadIdx.x];
    }
  }
}

// Launches rows, dx and dw on `stream`; returns the first non-zero
// cudaError_t. db1p holds cdiv(n, kRowTile) partials, dw1p / dw2p / db2p
// nsplit each; hd and ds are [n, f] scratch.
inline int launch(const bf16* x, const bf16* w1, const float* b1, const bf16* w2, const bf16* g,
                  bf16* dx, bf16* hd, bf16* ds, float* dw1p, float* db1p, float* dw2p,
                  float* db2p, int nsplit, int n, int d, int f, int d2,
                  const philox::Dropout& drop, cudaStream_t stream) {
  const long row_tiles = cdiv(n, kRowTile);
  if (n <= 0 || d % 16 || d2 % 16 || f % kRowsF || nsplit <= 0 || nsplit > 65535 ||
      row_tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long kchunk = cdiv(cdiv(n, nsplit), 32) * 32;
  const auto rows = drop.seed ? rows_kernel<true> : rows_kernel<false>;
  cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kRowsSmem);
  cudaFuncSetAttribute(dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)Dx::kSmemBytes);
  cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)Dw::kSmemBytes);
  rows<<<dim3((unsigned)cdiv(f, kRowsF), (unsigned)row_tiles), kThreads, kRowsSmem, stream>>>(
      x, w1, b1, w2, g, hd, ds, db1p, n, d, f, d2, drop);
  if (int err = (int)cudaGetLastError()) return err;
  dx_kernel<<<dim3((unsigned)cdiv(d, 128), (unsigned)row_tiles), kThreads, Dx::kSmemBytes,
              stream>>>(ds, w1, dx, n, d, f);
  if (int err = (int)cudaGetLastError()) return err;
  const long tiles = cdiv(d, 128) * cdiv(f, 128) + cdiv(f, 128) * cdiv(d2, 128);
  dw_kernel<<<dim3((unsigned)tiles, (unsigned)nsplit), kThreads, Dw::kSmemBytes, stream>>>(
      x, ds, hd, g, dw1p, dw2p, db2p, n, d, f, d2, kchunk);
  return (int)cudaGetLastError();
}

}  // namespace ffn_bwd

}  // namespace espnet

// dtype: 0 = float32, 1 = bfloat16. part: fp32 [nsplit, N, D2] scratch of
// the bf16 path when nsplit > 1 (espnet_fused_ffn_fwd_splits gives nsplit;
// fp32 takes nsplit 1 and no scratch). seed: int32 [1] on the device, or
// null for no dropout; thr = floor(rate * 2^16), inv = 1 / (1 - rate).
// Returns a cudaError_t code (0 = launched).
extern "C" int espnet_fused_ffn_fwd(int dtype, const void* x, const void* w1, const float* b1,
                                    const void* w2, const float* b2, void* out, float* part,
                                    int nsplit, int n, int d, int f, int d2, const int* seed,
                                    unsigned thr, float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  using espnet::bf16;
  if (dtype == 1) {
    return espnet::ffn_fwd::launch(static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
                                   static_cast<const bf16*>(w2), b2, static_cast<bf16*>(out), part,
                                   nsplit, n, d, f, d2, {seed, thr, inv}, s);
  }
  if (dtype == 0 && nsplit == 1) {
    return espnet::launch_ffn<float, 32, 32>(x, w1, b1, w2, b2, out, n, d, f, d2,
                                             {seed, thr, inv}, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The bf16 forward's F split for N rows (1, 2 or 4); 0 when it cannot take
// the shape (D2 other than 32, 64, 128, 256; D not a multiple of 16; F not
// a multiple of 32; too much shared memory).
extern "C" int espnet_fused_ffn_fwd_splits(int n, int d, int f, int d2) {
  return espnet::ffn_fwd::splits(n, d, f, d2);
}

// 1 when both directions' launches of this dtype take the widths (and the
// shared memory they need fits a block), else 0: the route test of
// models/conformer.py:FeedForward, decided before any launch.
extern "C" int espnet_fused_ffn_takes(int dtype, int n, int d, int f, int d2) {
  if (n <= 0 || d <= 0 || d % 16 || d2 <= 0 || d2 % 16) return 0;
  if (dtype == 1) {
    return f % espnet::ffn_bwd::kRowsF == 0 && espnet::ffn_fwd::splits(n, d, f, d2) > 0;
  }
  if (dtype != 0 || f % 32) return 0;
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // With the keep tiles of a rate above 0 (the larger layouts).
  const size_t need[] = {espnet::FfnLayout(d, d2, 32, 32, 4, true).total,
                         espnet::FfnBwdLayout(d, d2, 16, 32, 4, false, true).total,
                         espnet::FfnBwdLayout(d, d2, 16, 32, 4, true, true).total};
  for (size_t b : need) {
    if (b > (size_t)max_smem) return 0;
  }
  return 1;
}

// Blocks of the bf16 forward kernel that fit one SM at widths D, D2.
extern "C" int espnet_fused_ffn_fwd_blocks_per_sm(int d, int d2) {
  return espnet::ffn_fwd::blocks_per_sm(d, d2);
}

extern "C" const char* espnet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Rows of N per db1 partial of the bf16 backward.
extern "C" int espnet_fused_ffn_bwd_row_tile() { return espnet::ffn_bwd::kRowTile; }

// Backward. g: [N, D2] (x's type); dx: [N, D]; fp32 partials, summed by the
// caller: dw1p [nsplit, D, F], dw2p [nsplit, F, D2], db2p [nsplit, D2], and
// db1p [parts, F] with parts = cdiv(N, espnet_fused_ffn_bwd_row_tile()) in
// bf16 and nsplit in fp32. hd and ds: bf16 [N, F] scratch of the bf16 path
// (unused in fp32). seed, thr, inv: the forward's dropout (seed null for
// none). Returns a cudaError_t code.
extern "C" int espnet_fused_ffn_bwd(int dtype, const void* x, const void* w1, const float* b1,
                                    const void* w2, const void* g, void* dx, void* hd, void* ds,
                                    float* dw1p, float* db1p, float* dw2p, float* db2p,
                                    int nsplit, int n, int d, int f, int d2, const int* seed,
                                    unsigned thr, float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  using espnet::bf16;
  if (dtype == 1) {
    return espnet::ffn_bwd::launch(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
        static_cast<const bf16*>(w2), static_cast<const bf16*>(g), static_cast<bf16*>(dx),
        static_cast<bf16*>(hd), static_cast<bf16*>(ds), dw1p, db1p, dw2p, db2p, nsplit, n, d, f,
        d2, {seed, thr, inv}, s);
  }
  if (dtype == 0) {
    return espnet::launch_ffn_bwd<float, 16, 32>(x, w1, b1, w2, g, dx, dw1p, db1p, dw2p, db2p,
                                                 nsplit, n, d, f, d2, {seed, thr, inv}, s);
  }
  return (int)cudaErrorInvalidValue;
}
