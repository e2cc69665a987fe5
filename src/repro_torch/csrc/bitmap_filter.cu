// Phase 1 of the online stage (the paper's Alg. 5 line 3) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bitmap_filter.py::bitmap_filter_pallas
// (body _filter_kernel, layout _pack).
//
// Computes: images is (B, k, G, m, W) int32, row-major. Tuple (b, g) survives
// iff for every image j < m the AND over the k sets of image j has a non-zero
// word. out is (B, G) uint8: 1 for a survivor, 0 otherwise. The result is
// bit-identical to kernels/ref.py::bitmap_filter_ref.
//
// What bounds it on this card: bytes. A tuple reads k*m*W*4 bytes and does
// about one AND or OR per word read (~0.25 operations per byte), far below
// the card's int32-operations-per-byte ridge, so HBM bandwidth is the limit.
//
// What the design does about it: one thread per (b, g) tuple with the
// row-major layout kept as the engine builds it. The TPU kernel transposed
// groups onto its 128 vector lanes; here neighbouring threads own
// neighbouring tuples, so a warp's loads of one set cover one contiguous
// span of memory and every byte of each fetched sector is used. At W = 8 an
// image is 32 bytes and is read as two 16-byte loads; other widths take a
// scalar path. A thread's loads are independent of each other and there is
// no early exit, so all of them are in flight together and the bytes read
// are exactly the bytes the bound counts.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int4 and4(int4 a, int4 b) {
  return make_int4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

// W == 8: each image is two int4; a (set, tuple) row is 2*m int4.
__global__ void __launch_bounds__(kThreads)
bitmap_filter_w8(const int4* __restrict__ images, uint8_t* __restrict__ out,
                 long long n_tuples, long long G, int k, int m) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (tid >= n_tuples) return;
  const long long b = tid / G;
  const long long g = tid - b * G;
  const long long row = 2LL * m;
  const long long set_stride = G * row;
  const int4* p = images + (b * k * G + g) * row;
  bool pass = true;
  for (int j = 0; j < m; ++j) {
    int4 lo = __ldg(p + 2 * j);
    int4 hi = __ldg(p + 2 * j + 1);
    for (int i = 1; i < k; ++i) {
      const int4* q = p + i * set_stride + 2 * j;
      lo = and4(lo, __ldg(q));
      hi = and4(hi, __ldg(q + 1));
    }
    const int any = lo.x | lo.y | lo.z | lo.w | hi.x | hi.y | hi.z | hi.w;
    pass = pass && (any != 0);
  }
  out[tid] = pass ? 1 : 0;
}

// Any W (and images not 16-byte aligned): one int32 load per word.
__global__ void __launch_bounds__(kThreads)
bitmap_filter_words(const int* __restrict__ images, uint8_t* __restrict__ out,
                    long long n_tuples, long long G, int k, int m, int W) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (tid >= n_tuples) return;
  const long long b = tid / G;
  const long long g = tid - b * G;
  const long long row = (long long)m * W;
  const long long set_stride = G * row;
  const int* p = images + (b * k * G + g) * row;
  bool pass = true;
  for (int j = 0; j < m; ++j) {
    int any = 0;
    for (int w = 0; w < W; ++w) {
      int h = __ldg(p + j * W + w);
      for (int i = 1; i < k; ++i) h &= __ldg(p + i * set_stride + j * W + w);
      any |= h;
    }
    pass = pass && (any != 0);
  }
  out[tid] = pass ? 1 : 0;
}

}  // namespace

// Launches on `stream`, does not synchronize, allocates nothing. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_bitmap_filter(const void* images, void* out, long long B,
                                   int k, long long G, int m, int W,
                                   void* stream) {
  const long long n = B * G;
  if (n <= 0 || k <= 0 || m <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (W == 8 && reinterpret_cast<uintptr_t>(images) % 16 == 0) {
    bitmap_filter_w8<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const int4*>(images), o, n, G, k, m);
  } else {
    bitmap_filter_words<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const int*>(images), o, n, G, k, m, W);
  }
  return (int)cudaGetLastError();
}
