// Phase 2 of the online stage for Hopper (sm_90a): exact matching of the
// raw groups of the survivor tuples.
//
// Replaces the TPU kernel
// src/repro/kernels/group_intersect.py::group_match_pallas (body _match_kernel).
//
// Computes: a is (S, ga) int32 and b is (S, gb) int32, both padded with -1.
// out[s, i] = 1 iff a[s, i] != -1 and a[s, i] occurs in b[s, :]. Rows are in
// g-order, not value order (core/partition.py), so this is an equality tile,
// not a merge. The result is bit-identical to kernels/ref.py::group_match_ref.
// The TPU wrapper padded B rows with -2 only to fill 128 lanes; this kernel
// loops to exactly gb, and the a != -1 test is what keeps A's padding from
// meeting B's own -1 padding.
//
// What bounds it on this card: per row it reads (ga + gb) * 4 bytes, writes
// ga bytes and does ga * gb int32 compares. At the main path's gmax tiers
// (16-64) that is a few compares per byte, near the card's int32 ridge; at
// ga = gb = 128 (14 compares per byte) the compares bound it.
//
// What the design does about it: one block per tile of up to 32 rows. The
// tile's B rows are staged once in shared memory with coalesced loads (rows
// are contiguous), so global memory sees each input byte once. One thread
// per A element scans its row's gb values in shared memory; the threads of a
// row read the same address (a broadcast), and rows are stored at an odd
// stride so threads of different rows in one warp hit different banks. The
// scan has no early exit: it is branch-free and its work is what the bound
// counts.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 32;
// stay under the 48 KB of shared memory a block gets without opting in
constexpr int kSmemInts = 48 * 1024 / 4;

__global__ void __launch_bounds__(kThreads)
group_match_kernel(const int* __restrict__ a, const int* __restrict__ b,
                   uint8_t* __restrict__ out, long long S, int ga, int gb,
                   int stride, int rows) {
  extern __shared__ int sb[];
  const long long row0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, S - row0);
  const int* bt = b + row0 * gb;
  for (int i = threadIdx.x; i < nrows * gb; i += kThreads) {
    const int r = i / gb;
    sb[r * stride + (i - r * gb)] = __ldg(bt + i);
  }
  __syncthreads();
  const int* at = a + row0 * ga;
  uint8_t* ot = out + row0 * ga;
  for (int e = threadIdx.x; e < nrows * ga; e += kThreads) {
    const int v = __ldg(at + e);
    const int* br = sb + (e / ga) * stride;
    int hit = 0;
    for (int j = 0; j < gb; ++j) hit |= (br[j] == v);
    ot[e] = (hit && v != -1) ? 1 : 0;
  }
}

}  // namespace

// Launches on `stream`, does not synchronize, allocates nothing. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_group_match(const void* a, const void* b, void* out,
                                 long long S, int ga, int gb, void* stream) {
  if (S <= 0 || ga <= 0 || gb <= 0) return (int)cudaErrorInvalidValue;
  const int stride = gb | 1;  // odd: rows of one warp land in distinct banks
  if (stride > kSmemInts) return (int)cudaErrorInvalidValue;
  int rows = kSmemInts / stride;
  if (rows > kMaxRows) rows = kMaxRows;
  const long long blocks = (S + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rows * stride * sizeof(int);
  group_match_kernel<<<(unsigned)blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b),
      static_cast<uint8_t*>(out), S, ga, gb, stride, rows);
  return (int)cudaGetLastError();
}
