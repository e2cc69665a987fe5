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
// The TPU wrapper padded B rows with -2 only to fill 128 lanes; here no row is
// padded in memory, and the a != -1 test keeps A's padding out of the result.
//
// What bounds it on this card: bytes. Per row the function reads
// (ga + gb) * 4 bytes and writes ga, and on the path's rows (groups of 8-16
// real elements in tiers of 16-64, the rest -1) it needs only the compares of
// real elements against real elements, about a tenth of ga * gb: well under
// one compare per byte, far below the card's int32 ridge.
//
// What the design does about it: a segment of L lanes (8, 16 or 32, the
// least that covers max(ga, gb) / 4) owns one row, so a warp owns 32 / L
// rows. The lanes read their A row and their B row four values each, with
// 16-byte loads where the row allows it, and both loads are issued before
// any other work: every byte is read once and a warp's loads cover
// contiguous rows. Ballots over the B values find the real ones (by value,
// wherever the -1s lie), which the segment packs into its slot of shared
// memory (their order does not matter to a membership test), followed by -1
// up to the row's width rounded to 4. Each lane then reads the packed row
// with 16-byte shared loads, one load feeding 16 compares (4 of its A values
// against 4 B values), as far as the longest packed row of the warp: the
// loop's length is the rows' real B count over 4 whatever the tier, so -1
// in B costs no compare, and -1 in A never sets the loop length (its lane is
// masked when the result is written). The loop is unrolled to the tier and
// its bound is the same for the whole warp, so the running ORs stay in
// predicates rather than being moved to registers every step. B's -1
// padding cannot match: only real A values, never -1, reach the output. The
// segment writes its 4 result bytes per lane as one 32-bit store where the
// row allows it. Widths that are not a multiple of 4, or rows that are not
// 16-byte aligned, take scalar loads and byte stores with the same logic;
// rows wider than 4 * L are taken 4 * L values at a time, and B rows wider
// than 128 take a plain loop.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRowsPerSeg = 2;  // rows a segment handles, one after another
constexpr unsigned kFull = 0xffffffffu;
// stay under the 48 KB of shared memory a block gets without opting in
constexpr int kSmemInts = 48 * 1024 / 4;

// pos..pos+3 of a row `width` wide; -1 past its end. `vec`: the row starts on
// 16 bytes and width % 4 == 0, so the four values are one aligned int4.
__device__ __forceinline__ int4 load4(const int* row, int pos, int width,
                                      bool vec) {
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

// Bit k set where the k-th of a's four values occurs in buf[0, n4): n4 is a
// multiple of 4 and buf 16-byte aligned. With kIters > 0 the loop is
// unrolled kIters times (n4 <= 4 * kIters) and leaves at n4, which must be
// the same for the whole warp: the running ORs then stay in predicates.
template <int kIters>
__device__ __forceinline__ unsigned scan4(int4 a, const int* buf, int n4) {
  bool h0 = false, h1 = false, h2 = false, h3 = false;
  auto step = [&](int p) {
    const int4 v = *reinterpret_cast<const int4*>(buf + p);
    h0 = h0 || a.x == v.x || a.x == v.y || a.x == v.z || a.x == v.w;
    h1 = h1 || a.y == v.x || a.y == v.y || a.y == v.z || a.y == v.w;
    h2 = h2 || a.z == v.x || a.z == v.y || a.z == v.z || a.z == v.w;
    h3 = h3 || a.w == v.x || a.w == v.y || a.w == v.z || a.w == v.w;
  };
  if constexpr (kIters > 0) {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      if (4 * it >= n4) break;
      step(4 * it);
    }
  } else {
#pragma unroll 1
    for (int p = 0; p < n4; p += 4) step(p);
  }
  return (unsigned)h0 | (unsigned)h1 << 1 | (unsigned)h2 << 2 |
         (unsigned)h3 << 3;
}

// Appends the segment's real values of v (four a lane) to buf[n, ...) and
// returns the new length. Every lane of the warp calls it.
__device__ __forceinline__ int pack1(int v, int* buf, int n, unsigned seg_mask,
                                     unsigned below) {
  const unsigned m = __ballot_sync(kFull, v != -1) & seg_mask;
  if (v != -1) buf[n + __popc(m & below)] = v;
  return n + __popc(m);
}

__device__ __forceinline__ int pack4(int4 v, int* buf, int n,
                                     unsigned seg_mask, unsigned below) {
  n = pack1(v.x, buf, n, seg_mask, below);
  n = pack1(v.y, buf, n, seg_mask, below);
  n = pack1(v.z, buf, n, seg_mask, below);
  return pack1(v.w, buf, n, seg_mask, below);
}

__device__ __forceinline__ unsigned real4(int4 a) {
  return (unsigned)(a.x != -1) | (unsigned)(a.y != -1) << 1 |
         (unsigned)(a.z != -1) << 2 | (unsigned)(a.w != -1) << 3;
}

template <int L, int kIters>
__global__ void __launch_bounds__(kMaxThreads)
group_match_kernel(const int* __restrict__ a, const int* __restrict__ b,
                   uint8_t* __restrict__ out, long long S, int ga, int gb,
                   int cap, bool vec_a, bool vec_b, bool vec_out) {
  extern __shared__ int4 smem4[];
  const int segs = blockDim.x / L;
  const int seg = threadIdx.x / L;
  const int sl = threadIdx.x % L;
  const int lane = threadIdx.x & 31;
  const unsigned seg_mask =
      L == 32 ? kFull : ((1u << L) - 1u) << (lane - sl);
  const unsigned below = (1u << lane) - 1u;  // lanes under this one
  int* buf = reinterpret_cast<int*>(smem4) + seg * cap;
  const long long row0 = (long long)blockIdx.x * segs * kRowsPerSeg;

  // every lane of a warp runs this loop alike: the ballots need them all
  for (int k = 0; k < kRowsPerSeg; ++k) {
    const long long row = row0 + (long long)k * segs + seg;
    const bool valid = row < S;
    const int* ar = a + row * ga;
    const int* br = b + row * gb;
    // A's and B's first four values a lane, loaded together
    int4 av = valid ? load4(ar, 4 * sl, ga, vec_a) : make_int4(-1, -1, -1, -1);
    int4 bv = valid ? load4(br, 4 * sl, gb, vec_b) : make_int4(-1, -1, -1, -1);
    int n = 0;
    for (int j = 0;;) {
      n = pack4(bv, buf, n, seg_mask, below);
      j += 4 * L;
      if (j >= gb) break;
      bv = valid ? load4(br, j + 4 * sl, gb, vec_b) : make_int4(-1, -1, -1, -1);
    }
    // -1 up to the row's width rounded to 4: a scan may run past n
    for (int q = n + sl; q < cap; q += L) buf[q] = -1;
    __syncwarp();
    // the lanes scan as far as the longest row of the warp
    const int n4 = __reduce_max_sync(kFull, (n + 3) & ~3);
    for (int i = 0;;) {
      const unsigned hit = scan4<kIters>(av, buf, n4) & real4(av);
      const int pos = i + 4 * sl;
      if (valid && pos < ga) {
        uint8_t* o = out + row * ga + pos;
        if (vec_out) {
          *reinterpret_cast<unsigned*>(o) =
              (hit & 1u) | (hit >> 1 & 1u) << 8 | (hit >> 2 & 1u) << 16 |
              (hit >> 3 & 1u) << 24;
        } else {
          for (int q = 0; q < 4 && pos + q < ga; ++q) o[q] = hit >> q & 1u;
        }
      }
      i += 4 * L;
      if (i >= ga) break;
      av = valid ? load4(ar, i + 4 * sl, ga, vec_a) : make_int4(-1, -1, -1, -1);
    }
    __syncwarp();  // the slot is refilled for the next row
  }
}

template <int L>
int launch(const int* a, const int* b, uint8_t* out, long long S, int ga,
           int gb, cudaStream_t stream) {
  const int cap = (gb + 3) & ~3;  // a packed B row, padded to 4
  const int segs_per_warp = 32 / L;
  int warps = kMaxThreads / 32;
  while (warps > 1 && warps * segs_per_warp * cap > kSmemInts) warps >>= 1;
  if (warps * segs_per_warp * cap > kSmemInts)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)warps * segs_per_warp * kRowsPerSeg;
  const long long blocks = (S + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec_a = ga % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vec_b = gb % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const bool vec_out =
      ga % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const size_t smem = (size_t)warps * segs_per_warp * cap * sizeof(int);
  // the scan unrolled for rows up to 32 or up to 128 wide, looped past that
  auto kernel = cap <= 32    ? group_match_kernel<L, 8>
                : cap <= 128 ? group_match_kernel<L, 32>
                             : group_match_kernel<L, 0>;
  kernel<<<(unsigned)blocks, warps * 32, smem, stream>>>(
      a, b, out, S, ga, gb, cap, vec_a, vec_b, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`, does not synchronize, allocates nothing. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_group_match(const void* a, const void* b, void* out,
                                 long long S, int ga, int gb, void* stream) {
  if (S <= 0 || ga <= 0 || gb <= 0) return (int)cudaErrorInvalidValue;
  const int* av = static_cast<const int*>(a);
  const int* bv = static_cast<const int*>(b);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int widest = ga > gb ? ga : gb;
  if (widest <= 32) return launch<8>(av, bv, o, S, ga, gb, s);
  if (widest <= 64) return launch<16>(av, bv, o, S, ga, gb, s);
  return launch<32>(av, bv, o, S, ga, gb, s);
}
