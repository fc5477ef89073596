// BEV scatter-max over CELL-SORTED points, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/scatter_sorted_pallas.py::_fwd_kernel
// (launched from _forward). The TPU design scans each chunk with circular
// roll-max passes and places segment maxima with one-hot matrix products,
// because the TPU has no cheap dynamic addressing. A GPU addresses memory
// freely, so this is a segmented max over each cell's span of sorted
// points: out[b, cell] = max of feats[b, span(cell)], and exactly 0 for an
// empty span (include_self=False semantics: the zero never enters a max, so
// all-negative points still land).
//
// Bound on the H100: bytes. Each valid point's row is read once and each
// output row written once, one compare an element: at B=128, N=5,000,
// C=128, f32, 301 MB + 268 MB over 3.35 TB/s = 0.155 ms.
//
// What held the first design back (0.2450 / 0.2329 ms f32 / bf16 at B=128
// C=128 on an NVIDIA H100 80GB HBM3, 700.00 W; bf16 at 33% of its bound,
// PERF.md): a block of 16 cells ran 17 dependent
// binary searches before its first load, read one 4- or 2-byte element a
// thread a row (at most 8 KB in flight per SM), walked its cells one after
// another, and walked a long span row by row.
//
// This design is the span walk of scatter_sorted_common.cuh: persistent
// blocks with one block-wide search each; groups of whole cells of at most
// cap rows, whose feature rows (one contiguous byte range) are copied into
// a two-stage shared-memory ring with cp.async a group ahead; each walker
// takes a cell, its max over the cell's rows in shared memory as 16-byte
// vectors (max.NaN, bf16 in pairs: a NaN wins), and writes the cell's row, an empty cell
// as zeros. A long span's chunks are shared by all walkers, each keeping a
// running max; walker 0 joins them. Every output element has one writer:
// no atomics, and the result is exact (a max only moves values).
//
// Input contract: keys[b, :] = where(valid, flat_idx, H*W) is
// non-decreasing. Unsorted keys give wrong spans (silently, as on the TPU).

#include "scatter_sorted_common.cuh"

namespace {

using ssw::kThreads;
constexpr int kSliceVecs = 128;            // vectors of a row a walk takes at most
constexpr int kMaxSlabs = kSliceVecs / 32;  // vectors a lane of a walker

struct Params {
  const void* feats;
  const int* keys;
  void* out;
  int N, C, HW;
  ssw::Geometry g;
  ssw::Layout L;
  long long Q;
};

template <typename T, int V>
struct FwdOp {
  using VT = ssw::Vec<T, V>;
  static constexpr int EV = VT::E;
  const T* __restrict__ feats;  // at this slice's first channel
  T* __restrict__ out;          // at this slice's first channel
  int N, C, HW, rowvec;         // rowvec: vectors of this slice
  ssw::Geometry g;
  ssw::Layout L;
  uint8_t* smem;
  int tid, w, lane;
  VT acc[kMaxSlabs];            // a long span's running max, by slab

  __device__ __forceinline__ int chunks(ssw::Step& st) const {
    st.rows = g.long_rows;
    st.nch = (st.L + st.rows - 1) / st.rows;
    return st.nch;
  }

  __device__ __forceinline__ void copy(const ssw::Step& st, int s) const {
    uint8_t* rows = ssw::stage_of(smem, L, s).buf;
    const T* src = feats + ((size_t)st.b * N + st.p + st.r0) * C;
    for (int r = w; r < st.E; r += g.walkers)
      for (int v = lane; v < rowvec; v += g.lanes)
        ssw::copy_async<V>(rows + r * g.rbs + v * V, src + (size_t)r * C + v * EV);
  }

  // Cells [0, n) of the step's group: each walker in turn takes a cell, the
  // max over its rows (lo) from the stage, 0 for an empty one.
  __device__ __forceinline__ void cells(const ssw::Step& st, const ssw::Stage& sg, int n) const {
    T* ob = out + ((size_t)st.b * HW + st.c) * C;
    for (int j = w; j < n; j += g.walkers) {
      const int a = sg.lo[j], z = sg.lo[j + 1];
      for (int v = lane; v < rowvec; v += g.lanes) {
        VT m;
        if (a == z) {
          m.zero();
        } else {
          m.load_shared(sg.buf + a * g.rbs + v * V);
          for (int r = a + 1; r < z; ++r) {
            VT x;
            x.load_shared(sg.buf + r * g.rbs + v * V);
            m.max_with(x);
          }
        }
        m.store(ob + (size_t)j * C + v * EV);
      }
    }
  }

  __device__ __forceinline__ void process(const ssw::Step& st, int s) {
    const ssw::Stage sg = ssw::stage_of(smem, L, s);
    if (!st.longc) {
      cells(st, sg, st.ncells);
      return;
    }
    // A long span: the cells before it are empty; the walkers share its rows.
    if (st.t == 0) {
      cells(st, sg, st.ncells - 1);
#pragma unroll
      for (int k = 0; k < kMaxSlabs; ++k) acc[k].neg_inf();
    }
    for (int r = w; r < st.E; r += g.walkers) {
#pragma unroll
      for (int k = 0; k < kMaxSlabs; ++k) {
        const int v = k * g.lanes + lane;
        if (v < rowvec) {
          VT x;
          x.load_shared(sg.buf + r * g.rbs + v * V);
          acc[k].max_with(x);
        }
      }
    }
    if (st.t + 1 < st.nt) return;
    uint32_t* slots = reinterpret_cast<uint32_t*>(smem + L.slots);
    T* orow = out + ((size_t)st.b * HW + st.c + st.ncells - 1) * C;
#pragma unroll
    for (int k = 0; k < kMaxSlabs; ++k) {
      if (k * g.lanes >= rowvec) break;
      const int v = k * g.lanes + lane;
      if (k) __syncthreads();
#pragma unroll
      for (int i = 0; i < VT::W; ++i) slots[tid * VT::W + i] = acc[k].w[i];
      __syncthreads();
      if (w == 0 && v < rowvec) {
        VT m = acc[k];
        for (int w2 = 1; w2 < g.walkers; ++w2) {
          VT x;
#pragma unroll
          for (int i = 0; i < VT::W; ++i) x.w[i] = slots[(w2 * g.lanes + lane) * VT::W + i];
          m.max_with(x);
        }
        m.store(orow + v * EV);
      }
    }
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
scatter_sorted_fwd_kernel(const Params P) {
  extern __shared__ uint4 smem4[];
  const int ch0 = blockIdx.y * P.g.cw;
  FwdOp<T, V> op;
  op.feats = static_cast<const T*>(P.feats) + ch0;
  op.out = static_cast<T*>(P.out) + ch0;
  op.N = P.N;
  op.C = P.C;
  op.HW = P.HW;
  op.rowvec = ((P.C - ch0 < P.g.cw ? P.C - ch0 : P.g.cw) + P.g.epv - 1) / P.g.epv;
  op.g = P.g;
  op.L = P.L;
  op.smem = reinterpret_cast<uint8_t*>(smem4);
  op.tid = threadIdx.x;
  op.w = threadIdx.x / P.g.lanes;
  op.lane = threadIdx.x % P.g.lanes;
  const long long q0 = P.Q * blockIdx.x / gridDim.x;
  const long long q1 = P.Q * (blockIdx.x + 1) / gridDim.x;
  ssw::span_walk(op, P.keys, P.N, P.HW, P.g, op.smem, P.L, q0, q1);
}

struct Plan {
  int per_sm = 0;
  long long grid = 0;
};

template <typename T, int V>
cudaError_t run(const Params& p, Plan* L, bool launch, cudaStream_t s) {
  const auto kernel = scatter_sorted_fwd_kernel<T, V>;
  cudaError_t e = ssw::launch_shape(kernel, p.L.bytes, p.Q, &L->per_sm, &L->grid);
  if (e != cudaSuccess || !launch) return e;
  kernel<<<dim3((unsigned)L->grid, p.g.slices), kThreads, p.L.bytes, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, Plan* L, bool launch, cudaStream_t s) {
  switch (p.g.vec) {
    case 16: return run<T, 16>(p, L, launch, s);
    case 8: return run<T, 8>(p, L, launch, s);
    case 4: return run<T, 4>(p, L, launch, s);
    default:
      if constexpr (sizeof(T) == 2) return run<T, 2>(p, L, launch, s);
      return cudaErrorInvalidValue;
  }
}

cudaError_t call(const void* feats, const void* keys, void* out, int B, int N, int C, int HW,
                 int dtype, int slot_bytes, int max_cells, bool launch, Plan* L,
                 Params* p, cudaStream_t s) {
  if (B <= 0 || N <= 0 || C <= 0 || HW <= 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (!ssw::make_geometry(C, dtype == 0 ? 4 : 2, slot_bytes, max_cells, 1, kSliceVecs, &p->g))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(feats) % p->g.vec ||
      reinterpret_cast<uintptr_t>(out) % p->g.vec)
    return cudaErrorMisalignedAddress;
  p->feats = feats;
  p->keys = static_cast<const int*>(keys);
  p->out = out;
  p->N = N;
  p->C = C;
  p->HW = HW;
  p->L = ssw::layout_of(p->g);
  p->Q = (long long)B * HW;
  return dtype == 0 ? dispatch<float>(*p, L, launch, s)
                    : dispatch<__nv_bfloat16>(*p, L, launch, s);
}

}  // namespace

// The plan of a call, into out[9]: vector bytes, threads a walker,
// walkers, rows a step (a longer cell is a long span), rows a long span's
// chunk, shared memory a block (bytes), resident blocks per SM, blocks
// launched a slice, channel slices. Returns the CUDA error (0 on success).
extern "C" int scatter_sorted_fwd_plan(int B, int N, int C, int HW, int dtype, int slot_bytes,
                                       int max_cells, void* out) {
  Plan L;
  Params p;
  const cudaError_t e = call(reinterpret_cast<const void*>(16), nullptr,
                             reinterpret_cast<void*>(16), B, N, C, HW, dtype, slot_bytes,
                             max_cells, false, &L, &p, nullptr);
  if (e != cudaSuccess) return (int)e;
  int* o = static_cast<int*>(out);
  o[0] = p.g.vec; o[1] = p.g.lanes; o[2] = p.g.walkers; o[3] = p.g.cap; o[4] = p.g.long_rows;
  o[5] = p.L.bytes; o[6] = L.per_sm; o[7] = (int)L.grid; o[8] = p.g.slices;
  return 0;
}

// feats [B, N, C] (dtype 0 = f32, 1 = bf16), keys [B, N] int32 sorted per
// row (sentinel HW for invalid points), out [B, HW, C] of the feature
// dtype; slot_bytes and max_cells: the walk's constants
// (ops/scatter_sorted.py).
extern "C" int scatter_sorted_fwd(const void* feats, const void* keys, void* out, int B, int N,
                                  int C, int HW, int dtype, int slot_bytes, int max_cells,
                                  void* stream) {
  Plan L;
  Params p;
  return (int)call(feats, keys, out, B, N, C, HW, dtype, slot_bytes, max_cells, true, &L, &p,
                   static_cast<cudaStream_t>(stream));
}
