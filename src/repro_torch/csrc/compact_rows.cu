// Compaction of a pass's answers for Hopper (sm_90a): the kept values of
// every taken row of a (B, L) int32 buffer, in order, into one flat buffer
// with (B + 1) row offsets.
//
// Replaces no TPU kernel. The JAX package copies a pass's whole survivor
// buffer to the host and drops its -1 padding there; on the card that host
// filter and the pageable copy of mostly -1 were 98.2% (paper10m-batch) and
// 66.7% (skewed-batch) of the benchmark's window on an H100, so the
// single-device pass compacts its answers here and the collect copies 4
// bytes an answer.
//
// Computes: packed is (B, L) int32, -1 where a value was dropped (a stored
// value is never -1: core/engine.py::DeviceSet.from_host refuses
// 0xFFFFFFFF); take is (B,) uint8. For each row b with take[b] != 0, its
// values != -1, in position order, are written to out[offsets[b],
// offsets[b + 1]); a row with take[b] == 0 (an overflow row that is re-run)
// gets an empty slice and is not read. offsets is the exclusive scan of the
// rows' kept counts, offsets[B] their total. The result is bit-identical to
// kernels/ref.py::compact_rows_ref; out past offsets[B] is left as it was.
//
// What bounds it on this card: bytes. Per taken row it reads L * 4 bytes
// twice (two passes, below) and writes 4 bytes an answer, with answers a
// small share of L on the path (0.5 MB of a 33.5 MB row at the paper's
// sizes), so about 8 * L bytes a row at 3.35 TB/s.
//
// What the design does about it:
// - A row is cut into tiles of kTile values, one block each, read with
//   16-byte loads: a thread's kVecs int4 loads are all issued before any
//   other work, neighbouring threads on neighbouring addresses. Rows whose
//   width is not a multiple of 4, or a buffer off 16 bytes, take scalar
//   loads with the same logic.
// - Counts come from warp ballots: each of a thread's four values is one
//   ballot, and __popc of the ballots gives a warp's count of a strip and
//   each lane's count of the lanes below it, so a value's position inside
//   its tile is its strip's and warp's base plus popcounts.
// - Two passes over the buffer, and a scan between them: the first counts
//   each tile, one block scans the tile counts into tile bases (and the row
//   offsets, the bases of each row's first tile), and the second re-reads
//   each tile and writes its kept values at its base. The second read costs
//   one more L * 4 bytes a row, about 0.3 ms a 1 GB pass; a single pass
//   with decoupled look-back would save it but needs flags in device
//   memory, a spin on the preceding tile's, and forward progress of the
//   blocks that it waits on. The scan is one block of kScanThreads over
//   B * L / kTile counts (32,768 for 32 rows of 8.4M values).
// - Nothing is allocated: the wrapper hands in the output at its worst
//   case, B * L values, and the scratch of B * ceil(L / kTile) int64 tile
//   bases, so the launch never waits to learn the total.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 8;                    // int4 loads a thread per tile
constexpr int kStrip = kThreads * 4;        // values one load of a block covers
constexpr int kTile = kVecs * kStrip;       // 8192 values, 32 KB
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;               // tile counts a scan thread takes
constexpr unsigned kFull = 0xffffffffu;

// pos..pos+3 of a row `width` wide; -1 past its end. `vec`: the row starts
// on 16 bytes and width % 4 == 0, so the four values are one aligned int4.
__device__ __forceinline__ int4 load4(const int* row, long long pos,
                                      long long width, bool vec) {
  if (vec)
    return pos < width ? __ldg(reinterpret_cast<const int4*>(row + pos))
                       : make_int4(-1, -1, -1, -1);
  int4 v;
  v.x = pos < width ? __ldg(row + pos) : -1;
  v.y = pos + 1 < width ? __ldg(row + pos + 1) : -1;
  v.z = pos + 2 < width ? __ldg(row + pos + 2) : -1;
  v.w = pos + 3 < width ? __ldg(row + pos + 3) : -1;
  return v;
}

struct Ballots {
  unsigned x, y, z, w;
};

__device__ __forceinline__ Ballots ballots(int4 v) {
  return {__ballot_sync(kFull, v.x != -1), __ballot_sync(kFull, v.y != -1),
          __ballot_sync(kFull, v.z != -1), __ballot_sync(kFull, v.w != -1)};
}

__device__ __forceinline__ int popc4(Ballots m, unsigned mask) {
  return __popc(m.x & mask) + __popc(m.y & mask) + __popc(m.z & mask) +
         __popc(m.w & mask);
}

// The tile's kVecs strips of one thread: strip j holds positions
// start + j * kStrip + 4 * threadIdx.x .. + 3 of the row.
__device__ __forceinline__ void load_tile(int4 (&v)[kVecs], const int* row,
                                          long long start, long long width,
                                          bool vec) {
#pragma unroll
  for (int j = 0; j < kVecs; ++j)
    v[j] = load4(row, start + (long long)j * kStrip + 4 * threadIdx.x, width,
                 vec);
}

// Pass 1: bases[tile] = the kept values of the tile (0 in a row not taken).
__global__ void __launch_bounds__(kThreads)
compact_rows_count(const int* __restrict__ packed,
                   const uint8_t* __restrict__ take,
                   long long* __restrict__ bases, long long L, long long tiles,
                   bool vec) {
  const long long tile = blockIdx.x;
  const long long row = tile / tiles;
  if (!take[row]) {
    if (threadIdx.x == 0) bases[tile] = 0;
    return;
  }
  int4 v[kVecs];
  load_tile(v, packed + row * L, (tile % tiles) * kTile, L, vec);
  int n = 0;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) n += popc4(ballots(v[j]), kFull);
  __shared__ int warp_n[kWarps];
  if ((threadIdx.x & 31) == 0) warp_n[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_n[w];
    bases[tile] = total;
  }
}

// Inclusive scan of x across the warp. Every lane calls it.
template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Exclusive scan of x across a block of kScanThreads; returns this thread's
// prefix and sets *total to the block's sum. Every thread calls it.
__device__ __forceinline__ long long block_exclusive_scan(long long x,
                                                          long long* total) {
  static_assert(kScanThreads == 32 * 32, "warp 0 scans one sum a warp");
  __shared__ long long warp_base[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long inc = warp_inclusive_scan(x);
  if (lane == 31) warp_base[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const long long s = warp_base[lane];
    const long long si = warp_inclusive_scan(s);
    warp_base[lane] = si - s;
    if (lane == 31) *total = si;
  }
  __syncthreads();
  return warp_base[warp] + inc - x;
}

// The scan: bases[0, n) tile counts -> their exclusive scan, in place;
// offsets[b] = bases[b * tiles] and offsets[B] = the total.
__global__ void __launch_bounds__(kScanThreads)
compact_rows_scan(long long* __restrict__ bases,
                  long long* __restrict__ offsets, long long n,
                  long long tiles, long long B) {
  __shared__ long long carry, chunk_total;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long c0 = 0; c0 < n; c0 += (long long)kScanThreads * kScanItems) {
    const long long i0 = c0 + (long long)threadIdx.x * kScanItems;
    long long x[kScanItems], sum = 0;
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      x[q] = i0 + q < n ? bases[i0 + q] : 0;
      sum += x[q];
    }
    long long at = carry + block_exclusive_scan(sum, &chunk_total);
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      const long long i = i0 + q;
      if (i < n) {
        bases[i] = at;
        if (i % tiles == 0) offsets[i / tiles] = at;
      }
      at += x[q];
    }
    __syncthreads();  // every thread has read carry and chunk_total
    if (threadIdx.x == 0) carry += chunk_total;
    __syncthreads();
  }
  if (threadIdx.x == 0) offsets[B] = carry;
}

// Pass 2: the tile's kept values at out[bases[tile] + their rank].
__global__ void __launch_bounds__(kThreads)
compact_rows_write(const int* __restrict__ packed,
                   const uint8_t* __restrict__ take,
                   const long long* __restrict__ bases, int* __restrict__ out,
                   long long L, long long tiles, bool vec) {
  const long long tile = blockIdx.x;
  const long long row = tile / tiles;
  if (!take[row]) return;
  int4 v[kVecs];
  load_tile(v, packed + row * L, (tile % tiles) * kTile, L, vec);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // strip j's count of warp w at [j * kWarps + w]: position order
  __shared__ int strip_base[kVecs * kWarps];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int n = popc4(ballots(v[j]), kFull);
    if (lane == 0) strip_base[j * kWarps + warp] = n;
  }
  __syncthreads();
  static_assert(kVecs * kWarps == 64, "one warp scans two counts a lane");
  if (warp == 0) {
    const int a = strip_base[2 * lane], b = strip_base[2 * lane + 1];
    const int ex = warp_inclusive_scan(a + b) - a - b;
    strip_base[2 * lane] = ex;
    strip_base[2 * lane + 1] = ex + a;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  int* dst = out + bases[tile];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const Ballots m = ballots(v[j]);
    int at = strip_base[j * kWarps + warp] + popc4(m, below);
    if (v[j].x != -1) dst[at++] = v[j].x;
    if (v[j].y != -1) dst[at++] = v[j].y;
    if (v[j].z != -1) dst[at++] = v[j].z;
    if (v[j].w != -1) dst[at] = v[j].w;
  }
}

long long tiles_per_row(long long L) { return (L + kTile - 1) / kTile; }

}  // namespace

// Scratch the wrapper allocates for (B, L): B * ceil(L / kTile) int64.
extern "C" long long repro_compact_rows_scratch(long long B, long long L) {
  return B * tiles_per_row(L);
}

// Launches on `stream`, does not synchronize, allocates nothing. `out` holds
// B * L int32, `offsets` B + 1 int64, `scratch` repro_compact_rows_scratch(B,
// L) int64. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int repro_compact_rows(const void* packed, const void* take,
                                  void* out, void* offsets, void* scratch,
                                  long long B, long long L, void* stream) {
  if (B <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = tiles_per_row(L);
  const long long n = B * tiles;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(packed);
  const uint8_t* t = static_cast<const uint8_t*>(take);
  long long* bases = static_cast<long long*>(scratch);
  long long* off = static_cast<long long*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = L % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  compact_rows_count<<<(unsigned)n, kThreads, 0, s>>>(p, t, bases, L, tiles,
                                                      vec);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  compact_rows_scan<<<1, kScanThreads, 0, s>>>(bases, off, n, tiles, B);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  compact_rows_write<<<(unsigned)n, kThreads, 0, s>>>(
      p, t, bases, static_cast<int*>(out), L, tiles, vec);
  return (int)cudaGetLastError();
}
