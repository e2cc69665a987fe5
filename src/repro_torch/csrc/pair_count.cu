// Per-pair intersection counts of the suggestion path for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/count.py::pair_count_pallas
// (body _count_kernel), fused with what src/repro/core/engine.py::_count_block
// does around it (the prefix-alignment gather, the broadcast of the probe and
// the sum over the G tuples), so a bucket goes from its mirrors to its (B, C)
// count matrix in one launch.
//
// Computes: a bucket of B rows, each one probe and C candidate slots. The
// mirrors are read in place through a table of device pointers, (B, 1 + C)
// int64: ptrs[b][0] is probe b's (2^tp, gp) int32 mirror, ptrs[b][1 + c] is
// candidate c's (2^tc, gc) mirror, or 0 for a padding slot, whose count stays
// 0. Nothing is stacked and nothing is broadcast in device memory. With
// G = 2^max(tp, tc) and d = |tp - tc|, the deeper set supplies the iterated
// rows a (its row z), the shallower set the rows b it is held against (its row
// z >> d): tp >= tc iterates the probe, tp < tc the candidate, as _count_block
// does. out[b][c] is the number of pairs (z, i) with a[z][i] != -1 present in
// b's row. Every common element lives in exactly one tuple (src/repro/kernels/
// count.py:5-10), so this is |probe ∩ candidate|. The result is bit-identical
// to kernels/ref.py::count_block_ref. The TPU wrapper padded B rows with -2
// only to fill 128 lanes; this kernel loops to exactly gb, and the a != -1
// test is what keeps A's padding from meeting B's own -1 padding.
//
// What bounds it on this card: the function needs, per pair, one int32
// compare of each real element of a row z against each real element of the
// aligned row, and reads each mirror once, (2^tp * gp + 2^tc * gc) * 4 bytes.
// At the suggestion path's tiers (G 2^8-2^12, g 16-128) that is tens to
// hundreds of compares per byte, so the compares bound it, far above the
// mirror bytes. This kernel scans the padded tiers, G * ga * gb compares per
// pair, -1 slots included: with mean group sizes of 8-16 in tiers of 32 that
// is several times the compares the function needs.
//
// What the design does about it: one block per chunk of T consecutive tuples
// of one (b, c) pair (T * ga near kElems a elements). The chunk's rows of the
// shallower side (T >> d of them, or one when 2^d >= T) are staged once in
// shared memory with coalesced loads, at an odd stride so that threads of
// different rows in one warp hit different banks. One thread per A element
// (consecutive threads on consecutive addresses) scans its b row in shared
// memory, where the threads of a row read the same address (a broadcast). The
// scan has no early exit and does not stop at a row's -1 tail: it is
// branch-free, and skipping the padding is left to a faster version. The block sums its hits with warp shuffles and adds them to the
// zeroed output with one integer atomicAdd: integer addition is exact in any
// order, so the result does not depend on the order the blocks run in. The
// grid is one-dimensional (blocks ordered by pair, then chunk), so no
// dimension meets the 65535 limit of gridDim.y and gridDim.z.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kElems = 2048;  // a elements a block aims to cover
// stay under the 48 KB of shared memory a block gets without opting in
constexpr int kSmemInts = 48 * 1024 / 4;

__global__ void __launch_bounds__(kThreads)
pair_count_kernel(const long long* __restrict__ ptrs, int* __restrict__ out,
                  int C, int tp, int tc, int gp, int gc, int tuples,
                  int chunk_shift, int stride) {
  extern __shared__ int sb[];
  __shared__ int warp_sums[kWarps];
  const long long item = blockIdx.x;
  const long long pair = item >> chunk_shift;
  const int chunk = (int)(item - (pair << chunk_shift));
  const long long b = pair / C;
  const int c = (int)(pair - b * C);
  const long long* row = ptrs + b * (C + 1);
  const long long cand_ptr = row[1 + c];
  if (cand_ptr == 0) return;  // padding slot: the whole block leaves at once
  const int* probe = reinterpret_cast<const int*>(row[0]);
  const int* cand = reinterpret_cast<const int*>(cand_ptr);
  const bool probe_iterates = tp >= tc;
  const int* av = probe_iterates ? probe : cand;
  const int* bv = probe_iterates ? cand : probe;
  const int ga = probe_iterates ? gp : gc;
  const int gb = probe_iterates ? gc : gp;
  const int d = probe_iterates ? tp - tc : tc - tp;

  // T and 2^d are powers of two and the chunk starts at a multiple of T, so
  // its tuples meet max(1, T >> d) consecutive rows of the shallower side
  const int z0 = chunk * tuples;
  const int r0 = z0 >> d;
  const int nrows = ((z0 + tuples - 1) >> d) - r0 + 1;
  const int* bt = bv + (long long)r0 * gb;
  for (int i = threadIdx.x; i < nrows * gb; i += kThreads) {
    const int r = i / gb;
    sb[r * stride + (i - r * gb)] = __ldg(bt + i);
  }
  __syncthreads();

  const int* at = av + (long long)z0 * ga;
  int count = 0;
  for (int e = threadIdx.x; e < tuples * ga; e += kThreads) {
    const int v = __ldg(at + e);
    const int* br = sb + (((z0 + e / ga) >> d) - r0) * stride;
    int hit = 0;
#pragma unroll 4
    for (int j = 0; j < gb; ++j) hit |= (br[j] == v);
    count += (hit && v != -1) ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x < 32) {
    count = threadIdx.x < kWarps ? warp_sums[threadIdx.x] : 0;
    for (int off = 16; off > 0; off >>= 1)
      count += __shfl_down_sync(0xffffffffu, count, off);
    if (threadIdx.x == 0 && count != 0) atomicAdd(out + pair, count);
  }
}

}  // namespace

// ptrs: (B, 1 + C) int64 device pointers as above; out: (B, C) int32, zeroed
// by the caller. Launches on `stream`, does not synchronize, allocates
// nothing. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_pair_count(const void* ptrs, void* out, long long B, int C,
                                int tp, int tc, int gp, int gc, void* stream) {
  if (B <= 0 || C <= 0 || gp <= 0 || gc <= 0 || tp < 0 || tc < 0 || tp > 30 ||
      tc > 30)
    return (int)cudaErrorInvalidValue;
  const int t = tp > tc ? tp : tc;
  const int d = tp > tc ? tp - tc : tc - tp;
  const int ga = tp >= tc ? gp : gc;
  const int gb = tp >= tc ? gc : gp;
  const int stride = gb | 1;  // odd: rows of one warp land in distinct banks
  if (stride > kSmemInts) return (int)cudaErrorInvalidValue;
  // T: a power of two, at most G, near kElems / ga a elements, and whose
  // staged rows fit in shared memory
  int shift = 0;  // log2 T
  while (shift < t && (2 << shift) * ga <= kElems) ++shift;
  auto rows = [&](int s) { return s > d ? 1 << (s - d) : 1; };
  while (shift > 0 && rows(shift) * stride > kSmemInts) --shift;
  const int chunk_shift = t - shift;  // log2 of the chunks per pair
  const long long blocks = (B * (long long)C) << chunk_shift;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rows(shift) * stride * sizeof(int);
  pair_count_kernel<<<(unsigned)blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(ptrs), static_cast<int*>(out), C, tp, tc,
      gp, gc, 1 << shift, chunk_shift, stride);
  return (int)cudaGetLastError();
}
