// Replay of cell segments on Hopper (sm_90a): the routine that carries
// both `slow_round` (engine_round.cu) and `cas_apply_rounds` (table_ops.cu).
//
// Both kernels take lanes sorted by slot.  A segment is a run of lanes with
// one slot; its lanes are replayed in lane order against that row.  Each
// lane that takes part sees the row and version before its turn (its
// witness), may write its desired row (version + 2, wrapping), and the
// segment's row and version are written back once, if any lane wrote.
// Segments touch distinct rows, so they run in parallel.  The kernels
// differ only in their Op: which in-table lanes take part (`live`) and
// what a lane's kind may write and when it succeeds (`flags`).
//
// Design, `replay_warp` (row widths K = 1-8 and 16): a warp per 32-lane
// window of the sorted lanes, p threads in all.
//   * The warp loads its window's operands coalesced, in one pass, each
//     lane its own (16-byte vectors where K % 4 == 0).  The segment that
//     runs into the window from the lane before belongs to an earlier warp:
//     its lanes (a prefix) are left to that warp.
//   * What does not depend on the running state is found in parallel:
//     segment starts (ballot of slot changes); each segment's row and
//     version (every lane of it loads them, one transaction per segment),
//     whether a CAS lane's expected row equals it, and a SC lane's link
//     version less it.
//   * The dependent chain is which lanes write: a lane's state is the last
//     writer before it in its segment (-1 = the starting row) and the
//     count of writes before it.  The write mask is found as a fixed
//     point: from the STORE lanes, every lane applies its rule to the
//     state the current mask gives it (a CAS lane compares its expected
//     row with the last writer's desired row, shuffled from that lane; a
//     SC lane its link version with the count), and a ballot gives the next
//     mask.  A lane's rule reads only lanes below it, so each pass settles
//     at least the lowest lane still wrong, and the sequential order's
//     writes are the only fixed point: at most 33 passes, few unless many
//     outcomes chain.  Then each lane takes its witness from the last
//     writer's lane and writes its outputs.  A window where no lane has an
//     earlier live lane in its segment (the uniform and fast-tier batches)
//     skips the passes and moves what a thread per lane would.
//   * A segment that runs past the window stays with its warp, which walks
//     it in further 32-lane chunks with the row, version and dirty flag
//     carried in registers, loading the next chunk while it resolves the
//     current one.  The worst case, every lane on one cell, is one warp
//     walking p / 32 chunks.
//   * The row and version are written back once per dirty segment, by the
//     segment's last lane.
// `replay_thread` (any other row width): a thread per segment walks its
// lanes one by one, updating the row in place in memory.
//
// What bounds it on an H100: with short segments, memory latency (one row
// read per segment, a few lane words) and the launch; with a long segment,
// the chunks, one after another, each a few dependent shuffles and ballots
// per pass.
//
// An Op provides:
//   static constexpr bool kLink       lanes compare a link version (`aux`)
//   bool taken()                      does the launch run at all (a flag
//                                     the host left on the device)
//   uint32_t* data                    the rows, k words each
//   const int* slot, * kind           per sorted lane
//   const uint32_t* expected, * desired   [p, k]
//   uint32_t* out                     the witness rows [p, k]
//   bool in_table(int s)              is row s in the table
//   uint32_t aux(int g)               lane g's link version or round
//   bool live(uint32_t aux)           does an in-table lane take part
//   uint32_t flags(int kind)          kWrite* | kSucc* below
//   uint32_t ver(int s); void set_ver(int s, uint32_t v)
//   void out_meta(int g, uint32_t v, bool ok)   the lane's version, success
// A lane outside the table, or in it but not live, gets zero outputs.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace replay {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// What a lane's kind may write and when it succeeds.
constexpr uint32_t kWriteAlways = 1u << 0;   // STORE
constexpr uint32_t kWriteIfMatch = 1u << 1;  // CAS: row == expected
constexpr uint32_t kWriteIfLink = 1u << 2;   // SC: link version == version
constexpr uint32_t kSuccAlways = 1u << 3;
constexpr uint32_t kSuccIfLink = 1u << 4;
constexpr uint32_t kSuccIfWrote = 1u << 5;

__device__ __forceinline__ bool wrote(uint32_t f, bool match, bool link_ok) {
  return (f & kWriteAlways) || ((f & kWriteIfMatch) && match) ||
         ((f & kWriteIfLink) && link_ok);
}

__device__ __forceinline__ bool succeeded(uint32_t f, bool link_ok,
                                          bool okw) {
  return (f & kSuccAlways) || ((f & kSuccIfLink) && link_ok) ||
         ((f & kSuccIfWrote) && okw);
}

// Load / store K words; VEC = 16-byte vectors (K % 4 == 0, aligned rows).
template <int K, bool VEC>
__device__ __forceinline__ void ld(uint32_t (&r)[K], const uint32_t* src) {
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[q];
      r[4 * q] = v.x;
      r[4 * q + 1] = v.y;
      r[4 * q + 2] = v.z;
      r[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) r[j] = src[j];
  }
}

template <int K, bool VEC>
__device__ __forceinline__ void st(uint32_t* dst, const uint32_t (&r)[K]) {
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q)
      reinterpret_cast<uint4*>(dst)[q] =
          make_uint4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) dst[j] = r[j];
  }
}

template <int K, bool VEC, class Op>
__device__ __forceinline__ void dead_lane(const Op& op, int g) {
  uint32_t zero[K];
#pragma unroll
  for (int w = 0; w < K; ++w) zero[w] = 0u;
  st<K, VEC>(op.out + (size_t)g * K, zero);
  op.out_meta(g, 0u, false);
}

// One lane's operands in a 32-lane chunk.
template <int K>
struct Chunk {
  uint32_t expected[K], desired[K];
  uint32_t aux;
  int slot, kind;
  int slot_after;     // lane 31: the slot of the lane after the chunk
  bool valid;         // the lane is < p
  bool after_valid;   // lane 31: the lane after the chunk is < p
};

template <int K, bool VEC, class Op>
__device__ __forceinline__ void load_chunk(const Op& op, int g, int p,
                                           Chunk<K>& c) {
  c.valid = g < p;
  c.slot = c.valid ? op.slot[g] : 0;
  c.kind = c.valid ? op.kind[g] : 0;
  c.aux = c.valid ? op.aux(g) : 0u;
  if (c.valid) {
    ld<K, VEC>(c.expected, op.expected + (size_t)g * K);
    ld<K, VEC>(c.desired, op.desired + (size_t)g * K);
  } else {
#pragma unroll
    for (int w = 0; w < K; ++w) c.expected[w] = c.desired[w] = 0u;
  }
  c.after_valid = (threadIdx.x & 31) == 31 && g + 1 < p;
  c.slot_after = c.after_valid ? op.slot[g + 1] : 0;
}

template <int K, bool VEC, class Op>
__device__ __forceinline__ void replay_warp(const Op& op, int p) {
  const int lane = threadIdx.x & 31;
  const int w0 = blockIdx.x * blockDim.x + threadIdx.x - lane;
  if (w0 >= p) return;                                   // warp-uniform
  const bool has_before = w0 > 0;
  const int before = has_before ? op.slot[w0 - 1] : 0;
  Chunk<K> cur, nxt;
  load_chunk<K, VEC>(op, w0 + lane, p, cur);
  uint32_t carry_row[K];
#pragma unroll
  for (int w = 0; w < K; ++w) carry_row[w] = 0u;
  uint32_t carry_v = 0u;
  int carry_slot = 0;
  bool carry_dirty = false;
  const unsigned upto = (2u << lane) - 1u;               // lanes <= this one
  const unsigned below = upto >> 1;                      // lanes < this one

  for (int c0 = w0;; c0 += 32) {
    const bool first = c0 == w0;
    const int g = c0 + lane;
    const int s = cur.slot;
    const bool in_table = cur.valid && op.in_table(s);
    // This warp's lanes: in the window, all but the prefix that continues
    // an earlier warp's segment; in a later chunk, the prefix that
    // continues this warp's segment.
    const bool owned = in_table && (first ? !(has_before && s == before)
                                          : s == carry_slot);
    // Each lane's segment base: the carried row for the segment that runs
    // in from the chunk before, else the table's row.
    const bool cont = owned && !first;
    uint32_t base[K];
    uint32_t vb = 0u;
    if (cont) {
#pragma unroll
      for (int w = 0; w < K; ++w) base[w] = carry_row[w];
      vb = carry_v;
    } else if (owned) {
      ld<K, VEC>(base, op.data + (size_t)s * K);
      vb = op.ver(s);
    } else {
#pragma unroll
      for (int w = 0; w < K; ++w) base[w] = 0u;
    }
    if (first && cur.valid && !in_table) dead_lane<K, VEC>(op, g);
    const int s_up = __shfl_up_sync(kFull, s, 1);
    int s_dn = __shfl_down_sync(kFull, s, 1);
    int dn_valid = __shfl_down_sync(kFull, (int)cur.valid, 1);
    if (lane == 31) {
      s_dn = cur.slot_after;
      dn_valid = cur.after_valid;
    }
    const bool start = owned && (lane == 0 ? first : s_up != s);
    const bool seg_end = owned && !(dn_valid && s_dn == s);
    const bool more = __shfl_sync(kFull, (int)(owned && !seg_end), 31) != 0;
    if (more) load_chunk<K, VEC>(op, g + 32, p, nxt);   // prefetch

    const bool active = owned && op.live(cur.aux);
    if (owned && !active) dead_lane<K, VEC>(op, g);
    const uint32_t f = active ? op.flags(cur.kind) : 0u;
    bool eq_start = true;
#pragma unroll
    for (int w = 0; w < K; ++w) eq_start &= base[w] == cur.expected[w];
    const uint32_t dl = cur.aux - vb;      // link version - base version

    // Lanes whose state depends on an earlier live lane of their segment.
    const unsigned act = __ballot_sync(kFull, active);
    const unsigned sm = __ballot_sync(kFull, start) & upto;
    const unsigned seg_below =      // the earlier lanes of this segment
        (sm ? ~((1u << (31 - __clz(sm))) - 1u) : kFull) & below;
    const bool dep = owned && (act & seg_below) != 0u;
    const unsigned deps = __ballot_sync(kFull, dep);

    // The lanes that write: the fixed point of "a lane writes iff its rule
    // holds after the writes before it in its segment".  A lane's rule
    // reads only lanes below it, so each pass settles at least the lowest
    // lane still wrong, and the sequential order's writes are the only
    // fixed point; it takes few passes unless many outcomes chain.
    int last = -1;            // last writer before this lane (-1 = base)
    uint32_t cnt = 0u;        // writes before this lane in this chunk
    bool okw = wrote(f, eq_start, dl == 0u);
    if (deps) {
      const bool cas_dep =
          __ballot_sync(kFull, dep && (f & kWriteIfMatch)) != 0u;
      unsigned wr = __ballot_sync(kFull, (f & kWriteAlways) != 0u);
      for (;;) {
        const unsigned mine = wr & seg_below;
        last = mine ? 31 - __clz(mine) : -1;
        cnt = __popc(mine);
        bool match = eq_start;
        if (cas_dep) {        // the last writer's desired row == expected
          const int src = last < 0 ? lane : last;
          bool eq = true;
#pragma unroll
          for (int w = 0; w < K; ++w)
            eq &= __shfl_sync(kFull, cur.desired[w], src) == cur.expected[w];
          if (last >= 0) match = eq;
        }
        okw = wrote(f, match, dl == 2u * cnt);
        const unsigned next = __ballot_sync(kFull, okw);
        if (next == wr) break;
        wr = next;
      }
    }
    const bool link_ok = dl == 2u * cnt;
    uint32_t row[K];                       // the row before this lane
    if (deps) {
      const int src = last < 0 ? lane : last;
#pragma unroll
      for (int w = 0; w < K; ++w) {
        const uint32_t d = __shfl_sync(kFull, cur.desired[w], src);
        row[w] = last < 0 ? base[w] : d;
      }
    } else {
#pragma unroll
      for (int w = 0; w < K; ++w) row[w] = base[w];
    }
    const uint32_t v = vb + 2u * cnt;
    if (active) {
      st<K, VEC>(op.out + (size_t)g * K, row);
      op.out_meta(g, v, succeeded(f, link_ok, okw));
    }
    if (okw) {
#pragma unroll
      for (int w = 0; w < K; ++w) row[w] = cur.desired[w];   // row after
    }
    const uint32_t v_after = v + (okw ? 2u : 0u);
    const bool dirty = (cont && carry_dirty) || cnt > 0u || okw;
    if (seg_end && dirty) {
      st<K, VEC>(op.data + (size_t)s * K, row);
      op.set_ver(s, v_after);
    }
    if (!more) break;
#pragma unroll
    for (int w = 0; w < K; ++w)
      carry_row[w] = __shfl_sync(kFull, row[w], 31);
    carry_v = __shfl_sync(kFull, v_after, 31);
    carry_dirty = __shfl_sync(kFull, (int)dirty, 31) != 0;
    carry_slot = __shfl_sync(kFull, s, 31);
    cur = nxt;
  }
}

// Any row width: a thread per segment, the row updated in place.
template <class Op>
__device__ __forceinline__ void replay_thread(const Op& op, int p, int k) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= p) return;
  const int s = op.slot[g];
  if (!op.in_table(s) || !op.live(op.aux(g))) {
    for (int w = 0; w < k; ++w) op.out[(size_t)g * k + w] = 0u;
    op.out_meta(g, 0u, false);
  }
  if (!op.in_table(s)) return;
  if (g > 0 && op.slot[g - 1] == s) return;            // not a segment start
  uint32_t* row = op.data + (size_t)s * k;
  uint32_t v = op.ver(s);
  bool dirty = false;
  for (int j = g; j < p && op.slot[j] == s; ++j) {
    const uint32_t aux = op.aux(j);
    if (!op.live(aux)) continue;
    const size_t lo = (size_t)j * k;
    bool match = true;
    for (int w = 0; w < k; ++w) {
      op.out[lo + w] = row[w];
      match &= row[w] == op.expected[lo + w];
    }
    const uint32_t f = op.flags(op.kind[j]);
    const bool link_ok = aux == v;
    const bool okw = wrote(f, match, link_ok);
    op.out_meta(j, v, succeeded(f, link_ok, okw));
    if (okw) {
      for (int w = 0; w < k; ++w) row[w] = op.desired[lo + w];
      v += 2u;
      dirty = true;
    }
  }
  if (dirty) op.set_ver(s, v);
}

template <int K, bool VEC, class Op>
__global__ void __launch_bounds__(kThreads) replay_warp_kernel(Op op,
                                                               int p) {
  if (op.taken()) replay_warp<K, VEC>(op, p);
}

template <class Op>
__global__ void __launch_bounds__(kThreads) replay_thread_kernel(Op op,
                                                                 int p,
                                                                 int k) {
  if (op.taken()) replay_thread(op, p, k);
}

template <int K, class Op>
void launch_k(const Op& op, int p, bool vec, dim3 grid, cudaStream_t st) {
  if constexpr (K % 4 == 0) {
    if (vec) {
      replay_warp_kernel<K, true, Op><<<grid, kThreads, 0, st>>>(op, p);
      return;
    }
  }
  replay_warp_kernel<K, false, Op><<<grid, kThreads, 0, st>>>(op, p);
}

// Launch the replay over p sorted lanes of width k on `st`: the warp
// kernel for k = 1-8 and 16 (`vec`: rows and lane rows 16-byte aligned),
// else the thread kernel.  The caller checks cudaGetLastError().
template <class Op>
void launch(const Op& op, int p, int k, bool vec, cudaStream_t st) {
  if (p <= 0) return;
  const dim3 grid((p + kThreads - 1) / kThreads);
  switch (k) {
    case 1: launch_k<1>(op, p, vec, grid, st); break;
    case 2: launch_k<2>(op, p, vec, grid, st); break;
    case 3: launch_k<3>(op, p, vec, grid, st); break;
    case 4: launch_k<4>(op, p, vec, grid, st); break;
    case 5: launch_k<5>(op, p, vec, grid, st); break;
    case 6: launch_k<6>(op, p, vec, grid, st); break;
    case 7: launch_k<7>(op, p, vec, grid, st); break;
    case 8: launch_k<8>(op, p, vec, grid, st); break;
    case 16: launch_k<16>(op, p, vec, grid, st); break;
    default: replay_thread_kernel<Op><<<grid, kThreads, 0, st>>>(op, p, k);
  }
}

}  // namespace replay
