// Test entries of philox.cuh: the generator on given counters and keys
// (for the Random123 answer vectors) and the keep mask that the dropout
// launches of K2 and K3 draw, written out for a [planes, rows, cols] block
// (to hold against ops/kernels/philox.py bit for bit), once as the mma.sync
// launches draw it (keep8 a group of 8 elements) and once as the WMMA
// launches do (fill_keep_tile into shared memory). None is on a model's
// path: the kernels draw their masks themselves.
#include <cuda_runtime.h>

#include "philox.cuh"

namespace espnet {
namespace philox {

__global__ void answer_kernel(const uint32_t* __restrict__ ck, uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* a = ck + 6 * i;
  const uint4 o = philox4x32_10(make_uint4(a[0], a[1], a[2], a[3]), make_uint2(a[4], a[5]));
  out[4 * i] = o.x;
  out[4 * i + 1] = o.y;
  out[4 * i + 2] = o.z;
  out[4 * i + 3] = o.w;
}

// One thread per Philox call: 8 elements (rows r, r + 8; columns c, c + 1,
// c + 8, c + 9) of plane blockIdx.y.
__global__ void mask_kernel(const int* __restrict__ seed, uint32_t thr, int rows, int cols,
                            uint8_t* __restrict__ out) {
  const long gid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int cg = (cols + 15) / 16 * 4;  // column groups (16-column block, pair)
  const int rg = (rows + 15) / 16 * 8;  // row groups (16-row group, r & 7)
  if (gid >= (long)rg * cg) return;
  const int a = (int)(gid / cg), b = (int)(gid - (long)a * cg);
  const uint32_t r = (uint32_t)(a >> 3) * 16 + (a & 7), c = (uint32_t)(b >> 2) * 16 + 2 * (b & 3);
  const uint32_t plane = blockIdx.y;
  const uint32_t bits = keep8((uint32_t)seed[0], plane, r, c, thr);
  uint8_t* o = out + (long)plane * rows * cols;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t rr = r + 8 * hf, cc = c + 8 * jj + e;
        if (rr < (uint32_t)rows && cc < (uint32_t)cols) {
          o[(long)rr * cols + cc] = kept(bits, hf, jj, e);
        }
      }
}

// The same mask through fill_keep_tile: block (x, y) fills the 64 x 64 tile
// at (64 y, 64 x) of plane blockIdx.z in shared memory, then writes out the
// elements inside [rows, cols).
constexpr int kTile = 64;
__global__ void __launch_bounds__(256)
    tile_mask_kernel(const int* __restrict__ seed, uint32_t thr, int rows, int cols,
                     uint8_t* __restrict__ out) {
  __shared__ unsigned char keep[kTile * kTile];
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  fill_keep_tile<kTile, kTile>(keep, kTile, (uint32_t)seed[0], blockIdx.z, r0, c0, thr);
  __syncthreads();
  uint8_t* o = out + (long)blockIdx.z * rows * cols;
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += blockDim.x) {
    const int r = r0 + idx / kTile, c = c0 + idx % kTile;
    if (r < rows && c < cols) o[(long)r * cols + c] = keep[idx];
  }
}

}  // namespace philox
}  // namespace espnet

// ck: n x (counter[4], key[2]) uint32 on the device; out: n x 4 uint32.
extern "C" int espnet_philox4x32_10(const void* ck, void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  espnet::philox::answer_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ck), static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

// out: uint8 [planes, rows, cols], 1 where the dropout launches keep the
// element; seed: int32 [1] on the device; thr = floor(rate * 2^16).
extern "C" int espnet_philox_keep_mask(const int* seed, unsigned thr, int planes, int rows,
                                       int cols, void* out, void* stream) {
  if (planes <= 0 || planes > 65535 || rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const long groups = (long)(rows + 15) / 16 * 8 * ((cols + 15) / 16 * 4);
  espnet::philox::mask_kernel<<<dim3((unsigned)((groups + 255) / 256), planes), 256, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      seed, thr, rows, cols, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

// The same mask as espnet_philox_keep_mask, drawn by fill_keep_tile (the
// WMMA launches' draw).
extern "C" int espnet_philox_keep_tiles(const int* seed, unsigned thr, int planes, int rows,
                                        int cols, void* out, void* stream) {
  using espnet::philox::kTile;
  if (planes <= 0 || planes > 65535 || rows <= 0 || cols <= 0 || rows > 65535 * kTile) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((cols + kTile - 1) / kTile), (unsigned)((rows + kTile - 1) / kTile),
                  (unsigned)planes);
  espnet::philox::tile_mask_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, thr, rows, cols, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
