// BEV scatter-max over CELL-SORTED points, split by points (K4), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/scatter_sorted_pallas.py::
// _fwd_kernel_flat (launched from _forward when _FWD_FLAT is set). It
// computes what scatter_sorted_fwd.cu (K1) computes, the sorted segment max
// out[b, cell] = max of feats[b, span(cell)] (exactly 0 for an empty span;
// NaN where the span holds a NaN), but splits the work by points where K1
// splits it by cells. The TPU kernel walks a static table of 128-cell tiles
// and windows of points, with an output pass setting -inf and a pass
// turning -inf into 0; the tiles and the 8/16-row alignment of its windows
// are VMEM and sublane rules that the card does not have, and the table is
// not read here (the plain version keeps that route).
//
// Bound on the H100: bytes, as K1's: each valid point's row read once, each
// output row written once; at B=128, N=5,000, C=128, f32, 301 MB + 268 MB
// over 3.35 TB/s = 0.155 ms. What splitting by points buys: a cell that
// takes thousands of points (zero-padded frames put them in the centre
// cell) is spread over many blocks, where K1 gives it to one.
//
// The design:
// - Windows. Each image's sorted points are cut into windows of W points;
//   the flattened (image, window) list is cut into one contiguous range a
//   block of a persistent grid (the blocks an SM holds times the SMs, by
//   channel slices). A window's rows, W rows of the slice (one stage of
//   FLAT_SLOT_BYTES, or FLAT_SLOT_BYTES_SMALL for a call too small to give
//   each block several windows: ops/scatter_sorted.py), are copied into a
//   two-stage shared-memory ring with cp.async, 16 bytes a thread a copy
//   (narrower where a row is not a multiple of 16 bytes), a window ahead;
//   the keys two windows ahead are in registers, one a thread, so that the
//   rows of invalid points (sorted last) are never copied.
// - Chunks. A walker (lanes threads over one row's vectors, as in K1) takes
//   a chunk of R = W / walkers consecutive points of the window and walks
//   it once: it writes each run of equal keys that lies wholly inside its
//   chunk (one writer, a plain store) and, before each run, the empty
//   cells between the key before the run and the run's key as zeros. The
//   image's last window also writes the cells after its last point. Every
//   cell is written exactly once; a run whose points cross a chunk's edge
//   leaves its partial maxima in shared memory instead (the chunk's first
//   run, hp, and its last, tp).
// - The merge, after the walk, joins the partials: the walker of the chunk
//   where such a run ends takes the partials of the chunks before it
//   (whole chunks of that run, then the one where it starts). A run that
//   crosses the window's end is carried to the block's next window in
//   shared memory. A run crossing the block's first or last point leaves
//   its partial in the workspace with its cell: one [2, C] row pair and two
//   keys a block.
// - The join, a second small launch (a programmatic dependent of the walk,
//   so that its launch overlaps the walk), a walker for each block of the walk:
//   the walker of the block where such a run starts joins the partials of
//   the blocks the run crosses and writes the cell. A block starts at most
//   one such run, so the join reads at most two rows a block of the walk
//   (and one more for each block a long run covers whole).
// A max takes no rounding, so every order of joining gives the same bits:
// the result is exact and deterministic. The maxima keep NaN (max.NaN, the
// repaired Vec::max_with of scatter_sorted_common.cuh).
//
// Input contract: keys[b, :] = where(valid, flat_idx, H*W) is
// non-decreasing. Unsorted keys give wrong results (silently, as on the TPU).

#include "scatter_sorted_common.cuh"

namespace {

using ssw::kThreads;
constexpr int kSliceVecs = 128;  // vectors of a row a slice takes at most (K1's)

// What a call decides from C and the element size (host and device;
// ops/scatter_sorted.py::flat_geometry mirrors it).
struct FlatGeometry {
  int vec, epv, cw, slices, lanes, walkers, rbs;
  int R;  // points a chunk (a walker's share of a window)
  int W;  // points a window: R x walkers, at most kThreads
};

inline bool flat_geometry(int C, int es, int slot_bytes, FlatGeometry* f) {
  ssw::Geometry g;
  if (!ssw::make_geometry(C, es, slot_bytes, 1, 1, kSliceVecs, &g)) return false;
  f->vec = g.vec;
  f->epv = g.epv;
  f->cw = g.cw;
  f->slices = g.slices;
  f->lanes = g.lanes;
  f->walkers = g.walkers;
  f->rbs = g.rbs;
  int rows = slot_bytes / g.rbs;
  rows = rows < kThreads ? rows : kThreads;
  f->R = rows / g.walkers > 1 ? rows / g.walkers : 1;
  f->W = f->R * g.walkers;
  return true;
}

// Shared memory of a block, in bytes, each part 16-byte aligned: per stage
// the keys (the key before the window, its W keys, the key after it) and
// W rows; the walkers' partials hp and tp; two carry rows.
struct FlatLayout {
  int rows, stage, hp, tp, carry, bytes;
};

inline FlatLayout flat_layout(const FlatGeometry& g) {
  auto up16 = [](int n) { return (n + 15) / 16 * 16; };
  FlatLayout L;
  L.rows = up16((g.W + 2) * 4);
  L.stage = L.rows + up16(g.W * g.rbs);
  L.hp = ssw::kStages * L.stage;
  L.tp = L.hp + up16(g.walkers * g.rbs);
  L.carry = L.tp + up16(g.walkers * g.rbs);
  L.bytes = L.carry + up16(2 * g.rbs);
  return L;
}

// The workspace: two keys a block (b x HW + cell of the run crossing its
// first point, then its last, or -1), then two partial rows a block.
inline size_t part_offset(long long grid) { return (size_t)(grid * 2 * 4 + 15) / 16 * 16; }

struct Params {
  const void* feats;
  const int* keys;
  void* out;
  int* rec;    // [grid, 2]
  void* part;  // [grid, 2, C]
  int N, C, HW, S;
  long long T;  // windows: B x S
  FlatGeometry g;
  FlatLayout L;
};

template <typename T, int V>
struct Walk {
  using VT = ssw::Vec<T, V>;
  static constexpr int EV = VT::E;
  const Params P;
  const T* __restrict__ feats;  // at this slice's first channel
  T* __restrict__ out;
  T* __restrict__ part;
  uint8_t* smem;
  int tid, w, lane, rowvec;

  __device__ __forceinline__ Walk(const Params& p, uint8_t* s) : P(p), smem(s) {
    const int ch0 = blockIdx.y * P.g.cw;
    feats = static_cast<const T*>(P.feats) + ch0;
    out = static_cast<T*>(P.out) + ch0;
    part = static_cast<T*>(P.part) + ch0;
    tid = threadIdx.x;
    w = tid / P.g.lanes;
    lane = tid % P.g.lanes;
    rowvec = ((P.C - ch0 < P.g.cw ? P.C - ch0 : P.g.cw) + P.g.epv - 1) / P.g.epv;
  }

  __device__ __forceinline__ int* keys_of(int s) const {
    return reinterpret_cast<int*>(smem + s * P.L.stage);
  }
  __device__ __forceinline__ uint8_t* rows_of(int s) const {
    return smem + s * P.L.stage + P.L.rows;
  }
  __device__ __forceinline__ uint8_t* hp(int j) const { return smem + P.L.hp + j * P.g.rbs; }
  __device__ __forceinline__ uint8_t* tp(int j) const { return smem + P.L.tp + j * P.g.rbs; }
  __device__ __forceinline__ uint8_t* carry(int s) const {
    return smem + P.L.carry + s * P.g.rbs;
  }

  // Window gi's keys into registers: this thread's point, and the key
  // before the window (thread 0: -1 at an image's start) or after it
  // (thread 1: HW past an image's end).
  __device__ __forceinline__ void load_keys(long long gi, int& kw, int& ex) const {
    const int b = (int)(gi / P.S);
    const int p = (int)(gi - (long long)b * P.S) * P.g.W;
    const int* kb = P.keys + (size_t)b * P.N;
    kw = (tid < P.g.W && p + tid < P.N) ? __ldg(kb + p + tid) : P.HW;
    ex = 0;
    if (tid == 0) ex = p > 0 ? __ldg(kb + p - 1) : -1;
    if (tid == 1) ex = p + P.g.W < P.N ? __ldg(kb + p + P.g.W) : P.HW;
  }

  // Window gi into stage s: its keys, and its valid rows by cp.async. The
  // count is a barrier: every thread is past the last reads of stage s.
  __device__ __forceinline__ void issue(long long gi, int s, int kw, int ex) const {
    const int E = __syncthreads_count(tid < P.g.W && kw < P.HW);
    int* ks = keys_of(s);
    if (tid < P.g.W) ks[1 + tid] = kw;
    if (tid == 0) ks[0] = ex;
    if (tid == 1) ks[P.g.W + 1] = ex;
    const int b = (int)(gi / P.S);
    const int p = (int)(gi - (long long)b * P.S) * P.g.W;
    const T* src = feats + ((size_t)b * P.N + p) * P.C;
    uint8_t* rows = rows_of(s);
    for (int r = w; r < E; r += P.g.walkers)
      for (int v = lane; v < rowvec; v += P.g.lanes)
        ssw::copy_async<V>(rows + r * P.g.rbs + v * V, src + (size_t)r * P.C + v * EV);
  }

  // Cells (lo, hi) of image row ob, clipped to [0, HW): zeros, vector v.
  __device__ __forceinline__ void zero_gap(T* ob, int lo, int hi, int v) const {
    VT z;
    z.zero();
    const int end = hi < P.HW ? hi : P.HW;
    for (int c = lo + 1 > 0 ? lo + 1 : 0; c < end; ++c) z.store(ob + (size_t)c * P.C + v * EV);
  }

  // The walk of window gi from stage s: this walker's chunk.
  __device__ __forceinline__ void walk(long long gi, int s) const {
    const int* K = keys_of(s) + 1;  // K[-1]: the key before the window, K[W]: after it
    const uint8_t* rows = rows_of(s);
    const int b = (int)(gi / P.S);
    const int p = (int)(gi - (long long)b * P.S) * P.g.W;
    T* ob = out + (size_t)b * P.HW * P.C;
    const int r0 = w * P.g.R, r1 = r0 + P.g.R;
    const bool image_end = r1 == P.g.W && p + P.g.W >= P.N;
    for (int v = lane; v < rowvec; v += P.g.lanes) {
      zero_gap(ob, K[r0 - 1], K[r0], v);
      for (int r = r0; r < r1;) {
        const int c = K[r];
        if (c >= P.HW) break;  // invalid points to the chunk's end
        VT m;
        m.neg_inf();
        int e = r;
        for (; e < r1 && K[e] == c; ++e) {
          VT x;
          x.load_shared(rows + e * P.g.rbs + v * V);
          m.max_with(x);
        }
        const bool starts = r > r0 || K[r0 - 1] != c;
        const bool ends = e < r1 || K[r1] != c;
        if (starts && ends) {
          m.store(ob + (size_t)c * P.C + v * EV);
        } else {
          m.store(reinterpret_cast<T*>((starts ? tp(w) : hp(w)) + v * V));
        }
        if (e < r1) zero_gap(ob, c, K[e], v);
        r = e;
      }
      if (image_end) zero_gap(ob, K[P.g.W - 1], P.HW, v);
    }
  }

  // m joined with the partials of chunks j, j - 1, ... whose first point
  // continues the run c (whole chunks of it, in hp), then of the chunk where
  // it starts (tp); false if the run reaches the window's first point.
  __device__ __forceinline__ bool back(VT& m, const int* K, int c, int j, int v) const {
    for (; j >= 0 && K[j * P.g.R - 1] == c; --j) {
      VT x;
      x.load_shared(hp(j) + v * V);
      m.max_with(x);
    }
    if (j < 0) return false;
    VT x;
    x.load_shared(tp(j) + v * V);
    m.max_with(x);
    return true;
  }

  // The merge of window gi (stage s) after its walk. first / last: the
  // block's first / last window; open: the run carried in crossed the
  // block's first point. Returns open for the next window.
  __device__ __forceinline__ bool merge(long long gi, int s, bool first, bool last,
                                        bool open) const {
    const int* K = keys_of(s) + 1;
    const int b = (int)(gi / P.S);
    const int W = P.g.W, R = P.g.R;
    const int a = K[-1], z = K[W];
    T* ob = out + (size_t)b * P.HW * P.C;
    T* head = part + (size_t)blockIdx.x * 2 * P.C;
    T* tail = head + P.C;
    const bool crosses = K[W - 1] == z && z < P.HW;
    if (blockIdx.y == 0 && tid == 0) {
      if (first) P.rec[2 * blockIdx.x] = (a == K[0] && a < P.HW) ? b * P.HW + a : -1;
      if (last) P.rec[2 * blockIdx.x + 1] = crosses ? b * P.HW + z : -1;
    }
    // The run that ends in this walker's chunk and began before it.
    const int r0 = w * R, c = K[r0];
    if (K[r0 - 1] == c && c < P.HW && K[r0 + R] != c) {
      for (int v = lane; v < rowvec; v += P.g.lanes) {
        VT m;
        m.load_shared(hp(w) + v * V);
        T* dst = ob + (size_t)c * P.C;
        if (!back(m, K, c, w - 1, v)) {  // it began before the window
          if (first) {
            dst = head;
          } else {
            VT x;
            x.load_shared(carry(s ^ 1) + v * V);
            m.max_with(x);
            if (open) dst = head;
          }
        }
        m.store(dst + v * EV);
      }
    }
    // The run that crosses the window's end: carried, or the block's tail.
    const bool whole = crosses && a == z;  // it began before the window
    if (crosses && w == P.g.walkers - 1) {
      const int L = P.g.walkers - 1;
      for (int v = lane; v < rowvec; v += P.g.lanes) {
        VT m;
        if (K[L * R - 1] == z) {
          m.load_shared(hp(L) + v * V);
          back(m, K, z, L - 1, v);
        } else {
          m.load_shared(tp(L) + v * V);
        }
        if (whole && !first) {
          VT x;
          x.load_shared(carry(s ^ 1) + v * V);
          m.max_with(x);
        }
        if (last) {
          m.store(tail + v * EV);
          if (whole && (first || open)) m.store(head + v * EV);
        } else {
          m.store(reinterpret_cast<T*>(carry(s) + v * V));
        }
      }
    }
    return whole && (first || open);
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) flat_walk_kernel(const Params P) {
  extern __shared__ uint4 smem4[];
  // The join may be scheduled now: it waits for this grid's end and its
  // writes (griddepcontrol.wait) before it reads them.
  asm volatile("griddepcontrol.launch_dependents;");
  Walk<T, V> op(P, reinterpret_cast<uint8_t*>(smem4));
  const long long g0 = P.T * blockIdx.x / gridDim.x;
  const long long g1 = P.T * (blockIdx.x + 1) / gridDim.x;
  int kw, ex;
  op.load_keys(g0, kw, ex);
  op.issue(g0, 0, kw, ex);
  ssw::copy_commit();
  if (g0 + 1 < g1) op.load_keys(g0 + 1, kw, ex);
  bool open = false;
  int s = 0;
  for (long long gi = g0; gi < g1; ++gi, s ^= 1) {
    if (gi + 1 < g1) op.issue(gi + 1, s ^ 1, kw, ex);
    ssw::copy_commit();
    if (gi + 2 < g1) op.load_keys(gi + 2, kw, ex);
    ssw::copy_wait_older();
    __syncthreads();
    op.walk(gi, s);
    __syncthreads();
    open = op.merge(gi, s, gi == g0, gi + 1 == g1, open);
  }
}

// The join: walker w of block x takes block k = x * walkers + w of the walk.
// If the run crossing k's last point began in k, it joins the partials of
// the blocks the run crosses and writes the cell.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) flat_join_kernel(const Params P, int grid) {
  using VT = ssw::Vec<T, V>;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the walk has ended, its writes seen
  const int w = threadIdx.x / P.g.lanes, lane = threadIdx.x % P.g.lanes;
  const int k = blockIdx.x * P.g.walkers + w;
  if (k >= grid) return;
  const int rt = P.rec[2 * k + 1];
  if (rt < 0 || P.rec[2 * k] == rt) return;
  const int ch0 = blockIdx.y * P.g.cw;
  const int rowvec = ((P.C - ch0 < P.g.cw ? P.C - ch0 : P.g.cw) + P.g.epv - 1) / P.g.epv;
  const T* part = static_cast<const T*>(P.part) + ch0;
  T* dst = static_cast<T*>(P.out) + (size_t)rt * P.C + ch0;
  for (int v = lane; v < rowvec; v += P.g.lanes) {
    VT m;
    m.load(part + (size_t)(2 * k + 1) * P.C + v * VT::E);
    for (int j = k + 1;; ++j) {
      VT x;
      x.load(part + (size_t)(2 * j) * P.C + v * VT::E);
      m.max_with(x);
      if (P.rec[2 * j + 1] != rt) break;
    }
    m.store(dst + v * VT::E);
  }
}

// Without `launch`, the persistent grid into *grid (blocks an SM into
// *per_sm); with it, the walk on *grid blocks a slice, then the join.
template <typename T, int V>
cudaError_t run(const Params& p, long long* grid, bool launch, int* per_sm, cudaStream_t s) {
  const auto walk = flat_walk_kernel<T, V>;
  if (!launch) return ssw::launch_shape(walk, p.L.bytes, p.T, per_sm, grid);
  cudaError_t e = cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       p.L.bytes);
  if (e != cudaSuccess) return e;
  walk<<<dim3((unsigned)*grid, p.g.slices), kThreads, p.L.bytes, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // A programmatic dependent of the walk, so that its launch overlaps the
  // walk's tail.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((*grid + p.g.walkers - 1) / p.g.walkers), p.g.slices);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, flat_join_kernel<T, V>, p, (int)*grid);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, long long* grid, bool launch, int* per_sm,
                     cudaStream_t s) {
  switch (p.g.vec) {
    case 16: return run<T, 16>(p, grid, launch, per_sm, s);
    case 8: return run<T, 8>(p, grid, launch, per_sm, s);
    case 4: return run<T, 4>(p, grid, launch, per_sm, s);
    default:
      if constexpr (sizeof(T) == 2) return run<T, 2>(p, grid, launch, per_sm, s);
      return cudaErrorInvalidValue;
  }
}

cudaError_t setup(int B, int N, int C, int HW, int dtype, int slot_bytes, Params* p) {
  if (B <= 0 || N <= 0 || C <= 0 || HW <= 0 || (dtype != 0 && dtype != 1) ||
      (long long)B * HW >= 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (!flat_geometry(C, dtype == 0 ? 4 : 2, slot_bytes, &p->g)) return cudaErrorInvalidValue;
  p->N = N;
  p->C = C;
  p->HW = HW;
  p->S = (N + p->g.W - 1) / p->g.W;
  p->T = (long long)B * p->S;
  p->L = flat_layout(p->g);
  return cudaSuccess;
}

}  // namespace

// The plan of a call, into out[11]: vector bytes, threads a walker,
// walkers, points a window, points a chunk, shared memory a block (bytes),
// resident blocks per SM, blocks of the persistent grid (a slice), channel
// slices, windows an image, workspace bytes. Returns the CUDA error.
extern "C" int scatter_sorted_fwd_flat_plan(int B, int N, int C, int HW, int dtype,
                                            int slot_bytes, void* out) {
  Params p;
  cudaError_t e = setup(B, N, C, HW, dtype, slot_bytes, &p);
  int per_sm = 0;
  long long grid = 0;
  if (e == cudaSuccess)
    e = dtype == 0 ? dispatch<float>(p, &grid, false, &per_sm, nullptr)
                   : dispatch<__nv_bfloat16>(p, &grid, false, &per_sm, nullptr);
  if (e != cudaSuccess) return (int)e;
  int* o = static_cast<int*>(out);
  o[0] = p.g.vec; o[1] = p.g.lanes; o[2] = p.g.walkers; o[3] = p.g.W; o[4] = p.g.R;
  o[5] = p.L.bytes; o[6] = per_sm; o[7] = (int)grid; o[8] = p.g.slices; o[9] = p.S;
  o[10] = (int)(part_offset(grid) + (size_t)grid * 2 * C * (dtype == 0 ? 4 : 2));
  return 0;
}

// feats [B, N, C] (dtype 0 = f32, 1 = bf16), keys [B, N] int32 sorted per
// row (sentinel HW for invalid points), out [B, HW, C] of the feature
// dtype, work: the plan's workspace bytes for this grid (16-byte aligned;
// nothing needs to be set in it). slot_bytes and grid: the plan's stage
// bytes and blocks (any grid from 1 to B x windows an image gives the same
// result). Launches the walk, then the join.
extern "C" int scatter_sorted_fwd_flat(const void* feats, const void* keys, void* out,
                                       void* work, int B, int N, int C, int HW, int dtype,
                                       int slot_bytes, int grid, void* stream) {
  Params p;
  cudaError_t e = setup(B, N, C, HW, dtype, slot_bytes, &p);
  if (e != cudaSuccess) return (int)e;
  if (grid <= 0 || grid > p.T) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(feats) % p.g.vec ||
      reinterpret_cast<uintptr_t>(out) % p.g.vec || reinterpret_cast<uintptr_t>(work) % 16)
    return (int)cudaErrorMisalignedAddress;
  p.feats = feats;
  p.keys = static_cast<const int*>(keys);
  p.out = out;
  p.rec = static_cast<int*>(work);
  p.part = static_cast<uint8_t*>(work) + part_offset(grid);
  int per_sm = 0;
  long long g = grid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? dispatch<float>(p, &g, true, &per_sm, s)
                          : dispatch<__nv_bfloat16>(p, &g, true, &per_sm, s));
}
