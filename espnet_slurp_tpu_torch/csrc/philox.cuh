// Counter-based dropout masks for K2 (fused FFN) and K3 (rel-pos flash
// attention): Philox4x32-10 (Salmon et al., "Parallel random numbers: as
// easy as 1, 2, 3", SC 2011; the generator of Random123 and of cuRAND's
// Philox), written out so that every kernel draws its own bits.
//
// Replaces the TPU's in-kernel PRNG of espnet_slurp_tpu/ops/pallas/ffn.py:
// _keep_mask and ops/pallas/flash_attention.py:_dropout_keep, which seed
// per (seed + tile id) so that the backward regenerates the forward's mask.
// Here the mask of an element is a pure function of (seed, plane, row,
// column) in global coordinates:
//   K2: plane 0, (row n, column f) of the [N, F] hidden;
//   K3: plane b * H + h, (query i, key j) of the [B * H, T, T] probabilities.
// It never depends on a tile, a block or the launch geometry, so K3's
// forward, dkv and dq launches (whose tiles differ), K2's forward and its
// backward launches, in every dtype, and the plain version in
// ops/kernels/philox.py all draw the same bits. The mma.sync launches
// (bf16) call keep8 for their lanes' own elements; the WMMA launches, which
// stage every tile in shared memory, fill a keep tile there with
// fill_keep_tile.
//
// Counter layout. An mma.sync m16n8 accumulator gives lane (g = lane / 4,
// q = lane % 4) rows g and g + 8 of a 16-row tile and columns 2q, 2q + 1 of
// each n8 tile; two neighbouring n8 tiles of a 16-aligned column block give
// it 8 elements: rows {r, r + 8} x columns {c, c + 1, c + 8, c + 9}, with
// r = 16 a + g and c = 16 b + 2 q. One Philox call serves those 8:
//   counter = (16-row group * 8 + (r & 7), 16-column block * 4 + (c / 2 & 3),
//              plane, 0),  key = (seed, 0);
//   word w = 2 * ((r >> 3) & 1) + ((c >> 3) & 1), its low 16 bits for even
//   c and its high 16 bits for odd c.
// The draw is 16 bits wide: an element is kept when bits >= floor(rate *
// 2^16), so the keep probability is 1 - floor(rate * 2^16) / 2^16, within
// 2^-16 (1.5e-5) of 1 - rate (0.9000092 at rate 0.1). Kept elements are
// scaled by 1 / (1 - rate), as the reference's.
#pragma once

#include <stdint.h>

namespace espnet {
namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // round multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // Weyl key increments

// Philox4x32-10 of counter c under key k.
__host__ __device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += kW0;
      k.y += kW1;
    }
#ifdef __CUDA_ARCH__
    const uint32_t hi0 = __umulhi(kM0, c.x), hi1 = __umulhi(kM1, c.z);
#else
    const uint32_t hi0 = (uint32_t)(((uint64_t)kM0 * c.x) >> 32);
    const uint32_t hi1 = (uint32_t)(((uint64_t)kM1 * c.z) >> 32);
#endif
    const uint32_t lo0 = kM0 * c.x, lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// Keep bits of the 8 elements (row + 8 hf, col + 8 jj + e), hf, jj, e in
// {0, 1}, that share (row, col)'s Philox call: bit 4 hf + 2 jj + e. row and
// col are the coordinates of one of them with (row >> 3) & 1 == 0 and
// (col >> 3) & 1 == 0 (for a lane: r = 16 a + g, c = 16 b + 2 q); thr is
// floor(rate * 2^16).
__host__ __device__ __forceinline__ uint32_t keep8(uint32_t seed, uint32_t plane, uint32_t row,
                                          uint32_t col, uint32_t thr) {
  const uint4 o = philox4x32_10(
      make_uint4(((row >> 4) << 3) | (row & 7u), ((col >> 4) << 2) | ((col >> 1) & 3u), plane, 0u),
      make_uint2(seed, 0u));
  const uint32_t w[4] = {o.x, o.y, o.z, o.w};
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bits |= (uint32_t)((w[i] & 0xffffu) >= thr) << (2 * i);
    bits |= (uint32_t)((w[i] >> 16) >= thr) << (2 * i + 1);
  }
  return bits;
}

// Bit of element (hf, jj, e) in keep8's result.
__host__ __device__ __forceinline__ bool kept(uint32_t bits, int hf, int jj, int e) {
  return (bits >> (4 * hf + 2 * jj + e)) & 1u;
}

// Fills keep[r * ldk + c] (1: kept, 0: dropped) for the R x C elements (r0 +
// r, c0 + c) of `plane`, r0 and c0 multiples of 16: one keep8 call per 8
// elements (rows {r, r + 8} x columns {c, c + 1, c + 8, c + 9} of a 16 x 16
// block), the R * C / 8 calls spread over the block's threads. Elements past
// the tensor's rows or columns are drawn like the others; the caller ignores
// them. Called by the whole block; the caller synchronises before reading.
template <int R, int C>
__device__ __forceinline__ void fill_keep_tile(unsigned char* keep, int ldk, uint32_t seed,
                                               uint32_t plane, uint32_t r0, uint32_t c0,
                                               uint32_t thr) {
  static_assert(R % 16 == 0 && C % 16 == 0, "keep tiles are whole 16 x 16 blocks");
  constexpr int kGroups = R * C / 8, kBlocksC = C / 16;
  for (int gi = threadIdx.x; gi < kGroups; gi += blockDim.x) {
    // group gi: 16 x 16 block gi / 32 (row-major), its row g and pair q.
    const int q = gi & 3, g = (gi >> 2) & 7, blk = gi >> 5;
    const int r = 16 * (blk / kBlocksC) + g, c = 16 * (blk % kBlocksC) + 2 * q;
    const uint32_t bits = keep8(seed, plane, r0 + r, c0 + c, thr);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          keep[(r + 8 * hf) * ldk + c + 8 * jj + e] = (unsigned char)kept(bits, hf, jj, e);
        }
  }
}

// The dropout of a launch: the seed (a device int32, read by the kernel),
// floor(rate * 2^16) and 1 / (1 - rate).
struct Dropout {
  const int* seed;
  uint32_t thr;
  float inv;
};

}  // namespace philox
}  // namespace espnet
