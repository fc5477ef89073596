// The span walk shared by the sorted scatter-max forward (K1,
// scatter_sorted_fwd.cu) and its backward (K5, scatter_sorted_bwd.cu).
//
// Points arrive sorted by cell: keys[b, :] is non-decreasing, and each cell
// c of image b owns one contiguous span of points [lower_bound(c),
// lower_bound(c + 1)). Both kernels walk the flattened (image, cell) space
// the same way; only what they copy and what they do with a step differs.
//
// - Persistent blocks. The grid is the blocks an SM holds times the SMs,
//   by channel slices; block k takes the contiguous cell
//   range [k Q / G, (k + 1) Q / G) of the Q = B x ncell flattened cells. It
//   runs one block-wide search for its first span start (block_lower_bound:
//   256 probes a round, two rounds at N = 5,000) and from there carries the
//   span end of one group into the next; an image change restarts at point
//   0 with no search.
// - Groups. The block reads the keys [p, p + cap] (one a thread, coalesced,
//   loaded a group ahead), and the group is the longest run of whole cells
//   whose points fit `cap` rows: with X = min(key[p + cap], the range's
//   limit), its E rows are the keys below X, one __syncthreads_count. At
//   most `max_cells` cells, never past the block's range. The span starts
//   lo[0..ncells] go to shared memory from the window: each position writes
//   the starts of the cells between its key and the one before.
// - A ring of two shared-memory stages. A step's rows (at most cap, a
//   contiguous byte range of one image's features; K5 also its cells' out
//   and g rows) are copied into a stage with cp.async, 16 bytes a thread a
//   copy (narrower where a row is not a multiple of 16 bytes), while the
//   step before is reduced from the other stage: the next group's copies
//   are in flight whenever a block works, without registers.
// - Walkers. A walker is `lanes` threads (a power of two up to 32) over one
//   row's vectors (several a lane where a slice has more than 32); the
//   walkers take the group's cells in turn and reduce each cell's rows from
//   shared memory. Every output element has one writer: no atomics, no
//   dependency between blocks, nothing to join between walkers.
// - A cell longer than cap rows (the window holds a single key) is a long
//   span: its end comes from a second block-wide search, and it passes
//   through the ring in chunks of long_rows rows (a stage's buffers end to
//   end) that all walkers share, each keeping a running result in
//   registers; the walkers' results meet in shared memory after the last
//   chunk.
// - Channel slices. A row wider than a kernel's slice (K1: 128 vectors,
//   K5: 32) is cut into slices, one walk each (blockIdx.y).
//
// Keys past N read as ncell, which no group reaches. K1 walks ncell = HW
// cells an image; K5 walks HW + 1, the last being the invalid points
// (key HW), whose rows of d it zeroes in the walk.
//
// The flat forward K4 (scatter_sorted_fwd_flat.cu), split by points, walks
// windows of its own but takes its vectors (Vec, whose max_with keeps NaN),
// copies and geometry from here.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ssw {

constexpr int kThreads = 256;  // threads a block; the key window is one key a thread
constexpr int kStages = 2;     // shared-memory stages of the ring

// What a call decides from C, the element size and the wrapper's constants,
// host and device alike (ops/scatter_sorted.py::walk_geometry mirrors it).
struct Geometry {
  int vec = 0;        // bytes a vector: 16, 8, 4 or 2 (the largest dividing a row)
  int epv = 0;        // elements a vector
  int cw = 0;         // channels a slice
  int slices = 0;     // slices a row
  int rowvec = 0;     // vectors a full slice
  int lanes = 0;      // threads a walker
  int walkers = 0;    // walkers a block
  int rbs = 0;        // bytes a slice row in a stage
  int cap = 0;        // rows a step; a longer cell is a long span
  int long_rows = 0;  // rows a chunk of a long span: a stage's buffers, end to end
  int max_cells = 0;  // cells a group at most
  int nbuf = 0;       // row buffers a stage: K1 1 (features), K5 3 (features, out, g)
};

// slice_vecs: the vectors of a row a walk takes at most (a multiple of 32).
inline bool make_geometry(int C, int es, int slot_bytes, int max_cells, int nbuf,
                          int slice_vecs, Geometry* g) {
  if (C <= 0 || (es != 2 && es != 4) || slot_bytes < 16 || max_cells < 1) return false;
  const long long rb = (long long)C * es;
  int vec = 16;
  while (rb % vec) vec /= 2;
  const long long all = rb / vec;
  g->vec = vec;
  g->epv = vec / es;
  g->rowvec = (int)(all < slice_vecs ? all : slice_vecs);
  g->slices = (int)((all + g->rowvec - 1) / g->rowvec);
  g->cw = g->rowvec * g->epv;
  int lanes = 1;
  while (lanes < 32 && lanes < g->rowvec) lanes *= 2;
  g->lanes = lanes;
  g->walkers = kThreads / lanes;
  g->rbs = g->cw * es;
  const int rows = slot_bytes / g->rbs;
  g->cap = rows < 1 ? 1 : rows < kThreads - 1 ? rows : kThreads - 1;
  g->long_rows = nbuf * ((g->cap * g->rbs + 15) / 16 * 16) / g->rbs;
  g->max_cells = max_cells;
  g->nbuf = nbuf;
  return true;
}

// Shared memory of a block, in bytes, each part 16-byte aligned: per stage
// the window, the span starts and nbuf row buffers; then the slots where the
// walkers' long-span results meet (8 words a thread).
struct Layout {
  int lo, buf, bufbytes, stage, slots, bytes;
};

inline Layout layout_of(const Geometry& g) {
  auto up16 = [](int n) { return (n + 15) / 16 * 16; };
  Layout L;
  L.lo = up16(kThreads * 4);
  L.buf = L.lo + up16((g.max_cells + 1) * 4);
  L.bufbytes = up16(g.cap * g.rbs);
  L.stage = L.buf + g.nbuf * L.bufbytes;
  L.slots = kStages * L.stage;
  L.bytes = L.slots + kThreads * 8 * 4;
  return L;
}

// One stage's parts.
struct Stage {
  int* win;      // [kThreads] keys [p, p + cap]
  int* lo;       // [max_cells + 1] the group's span starts, relative to p
  uint8_t* buf;  // nbuf row buffers of cap rows of rbs bytes, bufbytes apart
};

__device__ __forceinline__ Stage stage_of(uint8_t* smem, const Layout& L, int s) {
  uint8_t* base = smem + s * L.stage;
  return Stage{reinterpret_cast<int*>(base), reinterpret_cast<int*>(base + L.lo),
               base + L.buf};
}

// Copies V bytes global -> shared without a register (cp.async; V = 2 has
// no cp.async and goes through one).
template <int V>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
  } else if constexpr (V == 8 || V == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src), "n"(V));
  } else {
    *static_cast<unsigned short*>(dst) = __ldg(static_cast<const unsigned short*>(src));
  }
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Waits for all but the newest committed group of this thread's copies.
__device__ __forceinline__ void copy_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// NaN-propagating maxima (PTX max.NaN, sm_80 and up): NaN (the canonical
// one) where either operand is NaN, else what max.f32 gives, signed zeros
// included. fmaxf and __hmax2 return the other operand, dropping a NaN.
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
// Two bf16 a word.
__device__ __forceinline__ uint32_t bmax2_nan(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// V bytes of T: elements as f32 (bf16 widened exactly).
template <typename T, int V>
struct Vec {
  static constexpr int E = V / (int)sizeof(T);
  static constexpr int W = V >= 4 ? V / 4 : 1;
  uint32_t w[W];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (V == 16) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else if constexpr (V == 8) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = q.x; w[1] = q.y;
    } else if constexpr (V == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }
  __device__ __forceinline__ void load_shared(const void* p) {
    if constexpr (V == 16) {
      const uint4 q = *static_cast<const uint4*>(p);
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else if constexpr (V == 8) {
      const uint2 q = *static_cast<const uint2*>(p);
      w[0] = q.x; w[1] = q.y;
    } else if constexpr (V == 4) {
      w[0] = *static_cast<const unsigned int*>(p);
    } else {
      w[0] = *static_cast<const unsigned short*>(p);
    }
  }
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (V == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (V == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else if constexpr (V == 4) {
      *reinterpret_cast<unsigned int*>(p) = w[0];
    } else {
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)w[0];
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ void neg_inf() {
#pragma unroll
    for (int i = 0; i < W; ++i)
      w[i] = sizeof(T) == 4 ? 0xff800000u : V >= 4 ? 0xff80ff80u : 0xff80u;
  }
  __device__ __forceinline__ float get(int e) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[e]);
    } else {
      return __uint_as_float(((w[e >> 1] >> (16 * (e & 1))) & 0xffffu) << 16);
    }
  }
  // Elements must be set in order from a zeroed vector (bf16 packs halves).
  __device__ __forceinline__ void set(int e, float v) {
    if constexpr (sizeof(T) == 4) {
      w[e] = __float_as_uint(v);
    } else {
      const uint32_t h = __bfloat16_as_ushort(__float2bfloat16(v));
      w[e >> 1] |= h << (16 * (e & 1));
    }
  }
  // this = the elementwise max of this and o (exact: a max moves values;
  // NaN where either is NaN, as the reference's max keeps it).
  __device__ __forceinline__ void max_with(const Vec& o) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < W; ++i)
        w[i] = __float_as_uint(fmax_nan(__uint_as_float(w[i]), __uint_as_float(o.w[i])));
    } else if constexpr (V >= 4) {
#pragma unroll
      for (int i = 0; i < W; ++i) w[i] = bmax2_nan(w[i], o.w[i]);
    } else {
      w[0] = __bfloat16_as_ushort(__float2bfloat16(fmax_nan(get(0), o.get(0))));
    }
  }
};

// The first index i in [lo, hi] with kb[i] >= value (hi if none), found by
// the whole block: each round probes kThreads evenly spaced keys and keeps
// the interval between the last probe below `value` and the next. Every
// thread must call it; all get the result.
__device__ __forceinline__ int block_lower_bound(const int* __restrict__ kb, int value, int lo,
                                                 int hi) {
  const int tid = threadIdx.x;
  while (hi - lo > kThreads) {
    const int step = (hi - lo + kThreads - 1) / kThreads;
    const int i = lo + tid * step;
    const int below = __syncthreads_count(i < hi && __ldg(kb + i) < value);
    if (below == 0) return lo;
    const int nhi = lo + below * step;
    lo = lo + (below - 1) * step + 1;
    hi = nhi < hi ? nhi : hi;
  }
  return lo + __syncthreads_count(lo + tid < hi && __ldg(kb + lo + tid) < value);
}

// One step of the walk. A group is cells [c, c + ncells) of image b and
// their L points from p; a normal group is one step of E = L rows. A long
// span (the group's last cell holds all L > cap points; the cells before it
// are empty) is nt steps of nch chunks of `rows` rows: chunk t covers rows
// [r0, r0 + E) from p, r0 = (t mod nch) rows (K5 passes its chunks twice:
// count, then write).
struct Step {
  int b, c, p, ncells, L;
  bool longc;
  int t, nt, nch, rows, r0, E;
};

__device__ __forceinline__ void set_chunk(Step& st) {
  st.r0 = (st.t % st.nch) * st.rows;
  st.E = st.L - st.r0 < st.rows ? st.L - st.r0 : st.rows;
}

// Walks the block's cells [q0, q1) of the B x ncell flattened cells:
//   op.chunks(step)        a long span's chunks: sets step.rows and step.nch
//                          (long_rows and its chunks, unless the op reads
//                          nothing) and returns its steps;
//   op.copy(step, stage)   issues the step's copies into a stage;
//   op.process(step, stage) reduces it once its copies have arrived.
// Every thread calls it; each op call is made by all threads together.
template <class Op>
__device__ __forceinline__ void span_walk(Op& op, const int* __restrict__ keys, int N, int ncell,
                                          const Geometry& g, uint8_t* smem, const Layout& Lay,
                                          long long q0, long long q1) {
  const int tid = threadIdx.x;
  if (q0 >= q1) return;
  int b = (int)(q0 / ncell);
  int c = (int)(q0 - (long long)b * ncell);
  const int* kb = keys + (size_t)b * N;
  int p = c == 0 ? 0 : block_lower_bound(kb, c, 0, N);
  long long q = q0;
  // The next window's keys: key[p + tid] and key[p + cap].
  int kw = 0, kcap = 0;
  auto load_window = [&]() {
    kw = (tid <= g.cap && p + tid < N) ? __ldg(kb + p + tid) : ncell;
    kcap = p + g.cap < N ? __ldg(kb + p + g.cap) : ncell;
  };
  load_window();

  // Plans the group at (b, c, p) into stage s and moves the walk past it.
  auto plan = [&](int s, Step& st) {
    const Stage sg = stage_of(smem, Lay, s);
    const long long left = q1 - q;
    const int c_end = left < (long long)(ncell - c) ? c + (int)left : ncell;
    const int limit = c_end < c + g.max_cells ? c_end : c + g.max_cells;
    sg.win[tid] = kw;
    const int X = kcap < limit ? kcap : limit;
    const int E = __syncthreads_count(kw < X);
    st.b = b;
    st.c = c;
    st.p = p;
    st.t = 0;
    int c_next;
    if (kcap >= limit || E > 0) {  // whole cells of at most cap points
      c_next = X;
      st.longc = false;
      st.L = st.rows = E;
      st.nt = st.nch = 1;
    } else {                       // the cell kcap fills the window: a long span
      c_next = kcap + 1;
      st.longc = true;
      st.L = block_lower_bound(kb, c_next, p + g.cap + 1, N) - p;
    }
    st.ncells = c_next - c;
    if (st.longc) st.nt = op.chunks(st);
    set_chunk(st);
    if (!st.longc) {
      if (tid <= E) {  // cells (key before, key here] start at this position
        const int prev = tid == 0 ? c - 1 : sg.win[tid - 1];
        const int cur = tid == E ? c_next : sg.win[tid];
        const int x1 = cur < c_next ? cur : c_next;
        for (int x = (prev + 1 > c ? prev + 1 : c); x <= x1; ++x) sg.lo[x - c] = tid;
      }
    } else {
      for (int j = tid; j <= st.ncells; j += kThreads) sg.lo[j] = j < st.ncells ? 0 : st.L;
    }
    p += st.L;
    c = c_next;
    q += st.ncells;
    if (c == ncell) {
      ++b;
      c = 0;
      p = 0;
      kb = keys + (size_t)b * N;
    }
    if (q < q1) load_window();
  };

  Step cur, nxt;
  plan(0, cur);
  op.copy(cur, 0);
  copy_commit();
  for (int s = 0;; s ^= 1) {
    bool more = true;
    if (cur.longc && cur.t + 1 < cur.nt) {
      nxt = cur;
      ++nxt.t;
      set_chunk(nxt);
    } else if (q < q1) {
      plan(s ^ 1, nxt);
    } else {
      more = false;
    }
    if (more) op.copy(nxt, s ^ 1);
    copy_commit();
    copy_wait_older();
    __syncthreads();
    op.process(cur, s);
    __syncthreads();
    if (!more) break;
    cur = nxt;
  }
}

// Persistent launch shape of a kernel with `smem` bytes: blocks an SM
// holds, and the blocks of a slice over Q flattened cells.
template <typename K>
cudaError_t launch_shape(K kernel, size_t smem, long long Q, int* per_sm, long long* grid) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (*per_sm <= 0) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long full = (long long)*per_sm * sms;
  *grid = Q < full ? Q : full;
  return cudaSuccess;
}

}  // namespace ssw
