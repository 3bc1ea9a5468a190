// Shared device helpers for the port's hand-written Hopper kernels.
//
// K3's WMMA kernels (csrc/flash_attention.cu: rel_flash_*_kernel) stage their
// operands in shared memory and multiply tiles with `smem_gemm`: WMMA
// (mma.sync) 16x16x16 bf16 tiles with fp32 accumulation for the bf16
// instantiation, and plain fp32 FMAs for the float instantiation. Every
// shared tile row is padded by 16 bytes: rows stay 16-byte aligned for
// vector loads and WMMA's 32-byte pointer rule, and the row stride is
// staggered across banks. Also here: the host-side launch counts, and warp
// reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <string>
#include <type_traits>

namespace espnet {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps per block for both kernels
constexpr float kNeg = -1e30f;  // the reference's masked-score value

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Row padding, in elements, of a shared tile holding T (16 bytes).
template <typename T>
__host__ __device__ constexpr int pad_of() { return 16 / static_cast<int>(sizeof(T)); }

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Copies `rows` x `cols` of a row-major global matrix into shared memory.
// Shared row r takes global row (row0 + r) when row_lo <= row0 + r < row_hi,
// and zeros otherwise. `cols`, `ldg` and `lds` must keep every row 16-byte
// aligned (the wrappers check that the global base pointer is).
template <typename T>
__device__ void load_rows(T* s, int lds, const T* g, long ldg, long row0, int rows,
                          int cols, long row_lo, long row_hi) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = cols / V;
  for (int idx = threadIdx.x; idx < rows * vpr; idx += blockDim.x) {
    const int r = idx / vpr;
    const int c = (idx - r * vpr) * V;
    const long gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr >= row_lo && gr < row_hi) {
      val = *reinterpret_cast<const uint4*>(g + gr * ldg + c);
    }
    *reinterpret_cast<uint4*>(s + r * lds + c) = val;
  }
}

// C[M, N] = (accumulate ? C : 0) + A[M, K] * B, all in shared memory, C fp32.
// B is [K, N] row-major, or with B_T it is [N, K] row-major (that is, the
// product is A * B^T). M, N and K are multiples of 16. Called by the whole
// block; ends with __syncthreads().
template <bool B_T>
__device__ void smem_gemm(const bf16* A, int lda, const bf16* B, int ldb, float* C, int ldc,
                          int M, int N, int K, bool accumulate) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  const int tn = N / 16;
  const int tiles = (M / 16) * tn;
  for (int t = warp; t < tiles; t += nwarps) {
    const int r0 = (t / tn) * 16;
    const int c0 = (t % tn) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (accumulate) {
      wmma::load_matrix_sync(acc, C + r0 * ldc + c0, ldc, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(acc, 0.0f);
    }
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + r0 * lda + k0, lda);
      if constexpr (B_T) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, B + c0 * ldb + k0, ldb);
        wmma::mma_sync(acc, a, b, acc);
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, B + k0 * ldb + c0, ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
    }
    wmma::store_matrix_sync(C + r0 * ldc + c0, acc, ldc, wmma::mem_row_major);
  }
  __syncthreads();
}

template <bool B_T>
__device__ void smem_gemm(const float* A, int lda, const float* B, int ldb, float* C, int ldc,
                          int M, int N, int K, bool accumulate) {
  for (int idx = threadIdx.x; idx < M * N; idx += blockDim.x) {
    const int r = idx / N;
    const int c = idx - r * N;
    float s = accumulate ? C[r * ldc + c] : 0.0f;
    const float* a = A + r * lda;
    for (int k = 0; k < K; ++k) {
      s = fmaf(a[k], B_T ? B[c * ldb + k] : B[k * ldb + c], s);
    }
    C[r * ldc + c] = s;
  }
  __syncthreads();
}

// Host-side launch counts: every kernel entry of the library adds one to a
// kernel's count each time it launches it, under the kernel's name with its
// template arguments as the profiler writes it (e.g. "ctc_warp::fwd_kernel",
// "ffn_fwd::fwd_kernel<256, true>", "rel_flash_fwd_kernel<__nv_bfloat16, 64,
// 64, false>"), so that a check of which kernels a call ran tells the route,
// dropout, dtype and head-width instances apart without a torch.profiler
// window (which has been seen to drop launches on the card).
// espnet_launch_names (csrc/ctc.cu) lists them with their counts.
inline std::mutex& launch_mutex() {
  static std::mutex m;
  return m;
}

// One map for the whole library (an inline function's static is shared by
// every translation unit that includes this header).
inline std::map<std::string, long long>& launch_counts() {
  static std::map<std::string, long long> n;
  return n;
}

inline std::string template_arg(bool b) { return b ? "true" : "false"; }
inline std::string template_arg(int v) { return std::to_string(v); }
inline std::string template_arg(const char* s) { return s; }

template <typename T>
inline const char* type_name() {
  return std::is_same<T, float>::value ? "float" : "__nv_bfloat16";
}

// The launch just made of `kernel<args...>`, if it was accepted: counts it
// and returns 0, or returns the launch's cudaError_t.
template <typename... A>
inline int counted(const char* kernel, A... args) {
  const int err = (int)cudaGetLastError();
  if (err == 0) {
    std::string name = kernel;
    const char* sep = "<";
    ((name += sep, name += template_arg(args), sep = ", "), ...);
    if (sizeof...(A) > 0) name += ">";
    std::lock_guard<std::mutex> lock(launch_mutex());
    ++launch_counts()[name];
  }
  return err;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace espnet
