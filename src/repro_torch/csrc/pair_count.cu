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
// b's row: an a value counts once however often it occurs in that row. Every
// common element lives in exactly one tuple (src/repro/kernels/count.py:5-10),
// so this is |probe ∩ candidate|. The result is bit-identical to
// kernels/ref.py::count_block_ref, in any block order.
//
// What bounds it on this card: the function needs, per pair, one int32
// compare of each real element (not -1) of a row z against each real element
// of the aligned row, and reads each mirror once. Mirror rows hold groups of
// 8-16 real elements in tiers of 32, the rest -1, so that is about a tenth of
// the padded tile G * ga * gb, and at the path's tiers it is still tens of
// compares per mirror byte: the compares bound it.
//
// What the design does about it:
// - Skip -1 on both sides by value, wherever it lies. The shallower side's
//   rows: a segment of lanes loads a row four values a lane, and ballots
//   find the real ones, which it packs into the row's slot of shared memory
//   (their order does not matter to a membership test), followed by -1 up
//   to the row's width rounded to 4, with the real count rounded to 4
//   beside it. The deeper side: the 2^d rows r << d .. (r + 1) << d that
//   meet shallower row r are one contiguous span of n_a = ga << d values,
//   cut into groups of 4 (16-byte loads where the mirror allows it). Only a
//   group that holds a real value becomes a task: ballots and one
//   block-wide prefix pack the tasks, each 4 values and its row, into shared
//   memory. Mirror rows hold their real elements at the left of a tier of
//   32, so about a third of the groups become tasks.
// - Fewer instructions per compare: a lane takes a task and scans its
//   packed row with 16-byte shared loads, each feeding 16 compares (4 task
//   values against 4 row values) folded into running ORs; one population
//   count adds a task's 4 results, masked to its real values, so the row's
//   -1 padding never counts. The lanes of a warp scan as far as the longest
//   of their rows (consecutive tasks share a few rows), the loop unrolled to
//   the row tier, so the running ORs stay in predicates. Rows sit at a
//   stride of 4 values more than a multiple of 4, so lanes on different
//   rows read different banks.
// - One side is stationary, so a piece of a mirror is loaded and packed once
//   for many pairs. A block takes a piece of the pairs' rows and a group of
//   up to kGroup candidate slots. Where the candidate iterates it takes a
//   batch of up to 32 probes too: it packs their rows once, then for each
//   slot builds each distinct candidate's tasks once and scans them against
//   every probe that holds that candidate there. Where the probe iterates it
//   takes one probe: it builds the probe's tasks once, then packs the
//   group's candidates a few at a time. The scans are (mirror, 32 tasks)
//   items, a contiguous run of them to each warp, with no barrier between
//   them; L2 serves the re-reads of a piece by the blocks of other probe
//   batches, which run next to each other (the batch varies fastest).
// - Each warp adds its count for a pair to the zeroed output with one
//   integer atomicAdd, exact in any order. The grid is one-dimensional, so no
//   dimension meets the 65535 limit of gridDim.y and gridDim.z.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlotsPerThread = 2;
// groups of 4 deeper values a block takes at most, so its tasks fit in
// shared memory and each thread loads at most kSlotsPerThread of them
constexpr int kTaskCap = kThreads * kSlotsPerThread;
constexpr int kGroup = 16;    // candidate slots a block walks, at most
// fewer slots a block where the bucket would give the card fewer blocks
constexpr int kMinBlocks = 2048;
// mirrors a block packs at once, where the piece's rows allow it
constexpr int kMinBatch = 8;
constexpr int kUnroll = 4;    // row loads a lane has in flight when packing
// the packed rows' share of shared memory: with the tasks, under the 48 KB
// a block gets without opting in
constexpr int kRowInts = 9472;
constexpr int kMaxSmem = 232448;  // what a block may opt in to on sm_90
constexpr unsigned kFull = 0xffffffffu;

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

// Appends the segment's real values of v to buf[n, ...) and returns the new
// length. Every lane of the warp calls it.
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

__device__ __forceinline__ unsigned real4(int4 a) {
  return (unsigned)(a.x != -1) | (unsigned)(a.y != -1) << 1 |
         (unsigned)(a.z != -1) << 2 | (unsigned)(a.w != -1) << 3;
}

// What a block works on: shared memory and the shape of its piece.
struct Piece {
  int4* task;      // [kTaskCap] groups of 4 deeper values that hold a real one
  int* task_row;   // [kTaskCap] each task's row, relative to r_lo
  int* n4;         // [mirrors * nrows] each packed row's padded count
  int* rows;       // [mirrors * nrows * stride] the packed shallower rows
  int* warp_total; // [kWarps]
  int s0, s1;      // the block's groups of the pair's q * 2^shallow
  int r_lo;        // the first shallower row they meet
  int nrows, q, q_shift, n_a, ga, gb, d, stride;

  // the shallower row that group s meets: a shift when q is a power of two
  __device__ __forceinline__ int row_of(int s) const {
    return q_shift >= 0 ? s >> q_shift : s / q;
  }
};

// Packs shallower rows r_lo .. r_lo + nrows - 1 of mirrors mirror(0) ..
// mirror(n - 1) into p.rows / p.n4, mirror k's rows after mirror k - 1's; a
// null mirror packs as empty rows. A segment of L lanes takes a row, four
// values a lane, so a warp loads 32 / L rows at once, kUnroll times over.
template <int L, class Mirror>
__device__ __forceinline__ void pack_rows(const Piece& p, Mirror mirror,
                                          int n) {
  constexpr int kSegs = 32 / L;  // rows a warp takes at once
  constexpr int kStep = kUnroll * kWarps * kSegs;
  const int lane = threadIdx.x & 31, sl = lane % L;
  const unsigned seg_mask = L == 32 ? kFull : ((1u << L) - 1u) << (lane - sl);
  const unsigned below = (1u << lane) - 1u;
  const int4 none = make_int4(-1, -1, -1, -1);
  const int total = n * p.nrows;
  const int first = (threadIdx.x >> 5) * kSegs;
  for (int i0 = first; i0 < total; i0 += kStep) {
    int4 v[kUnroll];
    const int* src[kUnroll];
    bool vec[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // the loads go out together
      const int i = i0 + u * kWarps * kSegs + lane / L;
      const int k = i / p.nrows;
      const int* m = i < total ? mirror(k) : nullptr;
      src[u] = m == nullptr ? nullptr
                            : m + (long long)(p.r_lo + i - k * p.nrows) * p.gb;
      vec[u] = p.gb % 4 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0;
      v[u] = src[u] ? load4(src[u], 4 * sl, p.gb, vec[u]) : none;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * kWarps * kSegs >= total) break;  // the same for the warp
      const int i = i0 + u * kWarps * kSegs + lane / L;
      int* dst = p.rows + i * p.stride;
      int n_real = 0;
      for (int j = 0;;) {
        n_real = pack4(v[u], dst, n_real, seg_mask, below);
        j += 4 * L;
        if (j >= p.gb) break;
        v[u] = src[u] ? load4(src[u], j + 4 * sl, p.gb, vec[u]) : none;
      }
      if (i < total) {
        // -1 up to the row's width rounded to 4: a scan may run past n4
        for (int q = n_real + sl; q < ((p.gb + 3) & ~3); q += L) dst[q] = -1;
        if (sl == 0) p.n4[i] = (n_real + 3) & ~3;
      }
    }
  }
}

template <class Mirror>
__device__ __forceinline__ void pack_rows(const Piece& p, Mirror mirror,
                                          int n) {
  if (p.gb <= 32)
    pack_rows<8>(p, mirror, n);
  else if (p.gb <= 64)
    pack_rows<16>(p, mirror, n);
  else
    pack_rows<32>(p, mirror, n);
}

// The deeper mirror `av`'s groups of this thread: slot s0 + k * kThreads +
// threadIdx.x of the piece, all -1 past its end.
__device__ __forceinline__ void load_groups(const Piece& p, const int* av,
                                            int4 (&v)[kSlotsPerThread]) {
  const bool vec =
      p.ga % 4 == 0 && reinterpret_cast<uintptr_t>(av) % 16 == 0;
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    const int s = p.s0 + k * kThreads + threadIdx.x;
    const int r = p.row_of(s);
    v[k] = s < p.s1 ? load4(av + ((long long)r << p.d) * p.ga,
                            (s - r * p.q) * 4, p.n_a, vec)
                    : make_int4(-1, -1, -1, -1);
  }
}

// Packs the loaded groups that hold a real value into the task list and
// returns its length. Every thread of the block calls it; it holds one
// __syncthreads.
__device__ __forceinline__ int build_tasks(const Piece& p,
                                           const int4 (&v)[kSlotsPerThread]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned m[kSlotsPerThread];
  int total = 0;
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    m[k] = __ballot_sync(kFull, real4(v[k]) != 0);
    total += __popc(m[k]);
  }
  if (lane == 0) p.warp_total[warp] = total;
  __syncthreads();
  int base = 0, n = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int t = p.warp_total[w];
    base += w < warp ? t : 0;
    n += t;
  }
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    if (m[k] >> lane & 1u) {
      const int at = base + __popc(m[k] & below);
      p.task[at] = v[k];
      p.task_row[at] = p.row_of(p.s0 + k * kThreads + threadIdx.x) - p.r_lo;
    }
    base += __popc(m[k]);
  }
  return n;
}

// Adds a warp's count to *at with one atomicAdd.
__device__ __forceinline__ void add_count(int count, int* at) {
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(kFull, count, off);
  if ((threadIdx.x & 31) == 0 && count != 0) atomicAdd(at, count);
}

// The items of one task list against n packed mirrors: item i is mirror
// i / rounds against tasks 32 * (i % rounds) .. + 31, one task a lane. Each
// warp takes a contiguous run of items. Mirror k's rows are packed mirror
// slot(k), and its count goes to *at(k), once a warp.
template <int kIters, class Slot, class At>
__device__ __forceinline__ void scan_items(const Piece& p, int n_tasks, int n,
                                           Slot slot, At at) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rounds = (n_tasks + 31) >> 5;
  const int n_items = n * rounds;
  const int per = (n_items + kWarps - 1) / kWarps;
  const int i1 = min(n_items, (warp + 1) * per);
  int i = warp * per;
  if (i >= i1) return;
  int k = i / rounds, round = i - k * rounds, count = 0;
  const int* rows = p.rows + slot(k) * p.nrows * p.stride;
  const int* n4 = p.n4 + slot(k) * p.nrows;
  for (; i < i1; ++i) {
    const int t = round * 32 + lane;
    const bool live = t < n_tasks;
    const int4 a = live ? p.task[t] : make_int4(-1, -1, -1, -1);
    const int rr = live ? p.task_row[t] : 0;
    // the lanes scan as far as the longest of their rows
    const int n = __reduce_max_sync(kFull, live ? n4[rr] : 0);
    count += __popc(scan4<kIters>(a, rows + rr * p.stride, n) & real4(a));
    if (++round == rounds || i + 1 == i1) {  // mirror k's items end here
      add_count(count, at(k));
      count = 0;
      round = 0;
      if (i + 1 < i1) {
        ++k;
        rows = p.rows + slot(k) * p.nrows * p.stride;
        n4 = p.n4 + slot(k) * p.nrows;
      }
    }
  }
}

template <bool kProbeIterates, int kIters>
__global__ void __launch_bounds__(kThreads)
pair_count_kernel(const long long* __restrict__ ptrs, int* __restrict__ out,
                  long long B, int C, int tp, int tc, int gp, int gc,
                  int pieces, int slots_per_block, int group, int batch,
                  int max_rows, int stride) {
  extern __shared__ int4 smem4[];
  __shared__ int warp_total[kWarps];
  constexpr bool probe_iterates = kProbeIterates;
  // bucket rows fastest (a batch of them where the candidate iterates), then
  // piece, then candidate group
  const long long nbatch = probe_iterates ? B : (B + batch - 1) / batch;
  const long long item = blockIdx.x;
  const long long rest = item / nbatch;
  const long long b0 = (item - rest * nbatch) * (probe_iterates ? 1 : batch);
  const int nb = probe_iterates ? 1 : (int)min((long long)batch, B - b0);
  const int piece = (int)(rest % pieces);
  const int c0 = (int)(rest / pieces) * group;
  const int c1 = min(C, c0 + group);
  auto row = [&](int k) { return ptrs + (b0 + k) * (C + 1); };
  auto cand = [&](int k, int c) {
    return reinterpret_cast<const int*>(row(k)[1 + c]);
  };
  bool any = false;
  for (int k = 0; k < nb; ++k)
    for (int c = c0; c < c1; ++c) any |= cand(k, c) != nullptr;
  if (!any) return;  // only padding slots: the whole block leaves at once

  Piece p;
  p.ga = probe_iterates ? gp : gc;
  p.gb = probe_iterates ? gc : gp;
  p.d = probe_iterates ? tp - tc : tc - tp;
  p.n_a = p.ga << p.d;
  p.q = (p.n_a + 3) >> 2;
  p.q_shift = (p.q & (p.q - 1)) == 0 ? __ffs(p.q) - 1 : -1;
  p.stride = stride;
  const int total = p.q << (probe_iterates ? tc : tp);
  p.s0 = piece * slots_per_block;
  p.s1 = p.s0 + min(slots_per_block, total - p.s0);
  p.r_lo = p.row_of(p.s0);
  p.nrows = p.row_of(p.s1 - 1) - p.r_lo + 1;
  p.task = smem4;
  p.task_row = reinterpret_cast<int*>(smem4 + kTaskCap);
  p.n4 = p.task_row + kTaskCap;
  p.rows = p.n4 + ((batch * max_rows + 3) & ~3);
  p.warp_total = warp_total;
  int4 v[kSlotsPerThread];

  if constexpr (probe_iterates) {
    // the probe's tasks, once; then `batch` candidates' rows at a time
    load_groups(p, reinterpret_cast<const int*>(row(0)[0]), v);
    const int n_tasks = build_tasks(p, v);
    for (int cb = c0; cb < c1; cb += batch) {
      const int n = min(batch, c1 - cb);
      if (cb != c0) __syncthreads();  // the scans are done with the rows
      pack_rows(p, [&](int k) { return cand(0, cb + k); }, n);
      __syncthreads();
      scan_items<kIters>(p, n_tasks, n, [](int k) { return k; },
                 [&](int k) { return out + b0 * C + cb + k; });
    }
    return;
  }
  // the batch's probes' rows, once; then for each candidate slot, each
  // distinct candidate's tasks against the probes that hold it there
  pack_rows(p, [&](int k) { return reinterpret_cast<const int*>(row(k)[0]); },
            nb);
  const int lane = threadIdx.x & 31;
  for (int c = c0; c < c1; ++c) {
    // lane k of every warp holds probe k's candidate in this slot
    const long long mine = lane < nb ? row(lane)[1 + c] : 0;
    unsigned pending = __ballot_sync(kFull, mine != 0);
    while (pending) {  // the same in every thread
      const long long cv = __shfl_sync(kFull, mine, __ffs(pending) - 1);
      const unsigned same = __ballot_sync(kFull, mine == cv) & pending;
      pending &= ~same;
      __syncthreads();  // the scans are done with the last tasks
      load_groups(p, reinterpret_cast<const int*>(cv), v);
      const int n_tasks = build_tasks(p, v);
      __syncthreads();
      // the probes that hold cv: the set bits of `same`, in order
      auto probe_of = [&](int j) {
        unsigned left = same;
        for (; j > 0; --j) left &= left - 1;
        return __ffs(left) - 1;
      };
      scan_items<kIters>(p, n_tasks, __popc(same), probe_of,
                 [&](int j) { return out + (b0 + probe_of(j)) * C + c; });
    }
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
  const int d = tp > tc ? tp - tc : tc - tp;
  const int ga = tp >= tc ? gp : gc;
  const int gb = tp >= tc ? gc : gp;
  const int shallow = tp < tc ? tp : tc;  // log2 of the shallower rows
  if (((long long)ga << d) > 0x7ffffff0LL || gb > 0x7ffffff0 - 4)
    return (int)cudaErrorInvalidValue;
  const long long q = (((long long)ga << d) + 3) >> 2;  // groups of 4 a row
  if ((q << shallow) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int stride = ((gb + 3) & ~3) + 4;  // rows land 4 banks apart
  // a piece: whole rows, as many as fit in kTaskCap groups (a power of two,
  // at most the pair's), or part of one row that alone holds more than
  // kTaskCap groups
  long long rows = 2;
  if (q <= kTaskCap) {
    rows = 1;
    while (rows < (1LL << shallow) && 2 * rows * q <= kTaskCap) rows *= 2;
  }
  // mirrors a block packs at once: probes where the candidate iterates,
  // candidates where the probe does; fewer rows a piece rather than fewer
  // than kMinBatch of them
  const bool probe_iterates = tp >= tc;
  const long long many = probe_iterates ? kGroup : B;
  const long long want = many < kMinBatch ? many : kMinBatch;
  while (q <= kTaskCap && rows > 1 && want * rows * (stride + 1) > kRowInts)
    rows /= 2;
  long long batch = kRowInts / (rows * (stride + 1));
  batch = batch < 1 ? 1 : (batch > many ? many : batch);
  if (batch > 32) batch = 32;  // a lane for each probe of the batch
  const long long slots = q <= kTaskCap ? rows * q : kTaskCap;
  const long long pieces = ((q << shallow) + slots - 1) / slots;
  const long long nbatch = probe_iterates ? B : (B + batch - 1) / batch;
  // candidates a block walks: up to kGroup, fewer where the bucket is too
  // small to give the card kMinBlocks blocks
  int group = kGroup;
  while (group > 1 && nbatch * pieces * ((C + group - 1) / group) < kMinBlocks)
    group >>= 1;
  if (probe_iterates && batch > group) batch = group;
  const long long groups = (C + group - 1) / group;
  if (nbatch * groups > 0x7fffffffLL / pieces)
    return (int)cudaErrorInvalidValue;
  const long long blocks = nbatch * pieces * groups;
  const long long packed = batch * rows;
  const size_t smem = (size_t)kTaskCap * (sizeof(int4) + sizeof(int)) +
                      (size_t)(((packed + 3) & ~3) + packed * stride) *
                          sizeof(int);
  if (smem > (size_t)kMaxSmem - kWarps * sizeof(int))
    return (int)cudaErrorInvalidValue;
  // the scan unrolled for rows up to 32 or up to 128 wide, looped past that
  const int width = stride - 4;
  const int which =
      (probe_iterates ? 3 : 0) + (width <= 32 ? 0 : width <= 128 ? 1 : 2);
  void (*const kernels[6])(const long long*, int*, long long, int, int, int,
                           int, int, int, int, int, int, int, int) = {
      pair_count_kernel<false, 8>, pair_count_kernel<false, 32>,
      pair_count_kernel<false, 0>, pair_count_kernel<true, 8>,
      pair_count_kernel<true, 32>, pair_count_kernel<true, 0>};
  const auto kernel = kernels[which];
  if (smem > 48 * 1024) {  // a row wider than kRowInts: opt in, once each
    static bool opted[6] = {};
    if (!opted[which]) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSmem - kWarps * (int)sizeof(int));
      if (e != cudaSuccess) return (int)e;
      opted[which] = true;
    }
  }
  kernel<<<(unsigned)blocks, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(ptrs), static_cast<int*>(out), B, C, tp,
      tc, gp, gc, (int)pieces, (int)slots, group, (int)batch, (int)rows,
      stride);
  return (int)cudaGetLastError();
}
