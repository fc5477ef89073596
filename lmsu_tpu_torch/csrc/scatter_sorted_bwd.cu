// BEV scatter-max over CELL-SORTED points, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/scatter_sorted_pallas.py::_bwd_kernel
// (launched from _backward). It computes the VJP of the segmented max with
// the gradient split evenly over tied winners:
//
//   d[p, c] = [feat[p, c] == out[cell(p), c]] * g[cell(p), c] / max(ties, 1)
//   ties[cell, c] = #{p in cell : feat[p, c] == out[cell, c]}
//
// and d = 0 for invalid points (key == HW). A NaN cell ties no point (NaN
// equals nothing), so its points get 0, as in the plain version. The TPU
// kernel gathers out and g per point and counts ties with one-hot
// placement matmuls, and splits the
// counts into two bf16-exact parts because its matrix unit rounds f32
// operands; here the counts are plain integers, exact at any size.
//
// Bound on the H100: bytes. Valid points' feature rows, the keys, out and g
// of occupied cells are read once and all of d written once; one compare an
// element and a division a winner. At B=128, N=5,000, C=128, f32: 0.262 ms.
//
// What held the first design back (0.417 / 0.426 ms f32 / bf16 at B=128
// C=128, 0.0713 / 0.0495 at B=8, on an NVIDIA H100 80GB HBM3, 700.00 W,
// PERF.md): K1's faults (17 dependent binary searches
// a block, one element a thread a row, cells and long spans walked
// serially), two passes over every span in device memory (count the ties,
// then write d), and tail blocks for the invalid rows, each with its own
// search and scalar stores.
//
// This design is K1's span walk (scatter_sorted_common.cuh) over HW + 1
// cells an image, the last being the invalid points. A step's feature rows
// and, at the first row of each occupied cell, that cell's out and g rows go
// into the stage's three buffers by cp.async, a group ahead. Each walker
// takes a cell: it counts the ties as integers over the cell's rows in
// shared memory, then writes d of those rows, so each feature row is read
// from device memory once. Only a cell longer than cap rows passes through
// the ring twice (count, then write), its rows shared by all walkers, whose
// counts meet in shared memory; the invalid points' rows of d are zeroed as
// their cell's rows, with nothing read. share = g / ties is taken once a
// cell, an IEEE f32 division (no fast math) where ties > 1 and g itself
// where ties = 1 (the same value, without the division's cost), the result
// cast to the feature dtype, so d equals the plain version's exactly; g
// arrives in the output's dtype (the JAX side casts it so at :466-468).

#include "scatter_sorted_common.cuh"

namespace {

using ssw::kThreads;
// A walk takes 32 vectors of a row at most, one a lane: the long-span state
// below then takes few registers (wider rows are more channel slices).
constexpr int kSliceVecs = 32;

struct Params {
  const void* feats;
  const int* keys;
  const void* out;
  const void* g;
  void* d;
  int N, C, HW;
  ssw::Geometry geo;
  ssw::Layout L;
  long long Q;
};

template <typename T, int V>
struct BwdOp {
  using VT = ssw::Vec<T, V>;
  static constexpr int EV = VT::E;
  const T* __restrict__ feats;  // each at this slice's first channel
  const T* __restrict__ out;
  const T* __restrict__ g;
  T* __restrict__ d;
  int N, C, HW, rowvec;         // rowvec: vectors of this slice
  ssw::Geometry geo;
  ssw::Layout L;
  uint8_t* smem;
  int tid, w, lane;
  VT ov, gv;     // a long span's cell: out and g
  int cnt[EV];   // its ties, counted, then summed
  float sh[EV];  // its shares g / ties

  __device__ __forceinline__ bool invalid_cell(const ssw::Step& st) const {
    return st.c + st.ncells - 1 >= HW;
  }
  // The invalid points' cell is zeroed in one step, with nothing read; any
  // other long span is counted, then written, in chunks of long_rows rows
  // (its rows use all three of a stage's buffers).
  __device__ __forceinline__ int chunks(ssw::Step& st) const {
    if (invalid_cell(st)) {
      st.rows = st.L;
      st.nch = 1;
      return 1;
    }
    st.rows = geo.long_rows;
    st.nch = (st.L + st.rows - 1) / st.rows;
    return 2 * st.nch;
  }

  __device__ __forceinline__ void copy(const ssw::Step& st, int s) const {
    const ssw::Stage sg = ssw::stage_of(smem, L, s);
    const T* src = feats + ((size_t)st.b * N + st.p + st.r0) * C;
    if (st.longc) {
      if (invalid_cell(st)) return;
      for (int r = w; r < st.E; r += geo.walkers)
        for (int v = lane; v < rowvec; v += geo.lanes)
          ssw::copy_async<V>(sg.buf + r * geo.rbs + v * V, src + (size_t)r * C + v * EV);
      return;
    }
    uint8_t* obuf = sg.buf + L.bufbytes;
    uint8_t* gbuf = sg.buf + 2 * L.bufbytes;
    for (int r = w; r < st.E; r += geo.walkers) {
      const int key = sg.win[r];
      if (key >= HW) continue;  // an invalid point: its d is 0, nothing to read
      const bool first = r == 0 || sg.win[r - 1] != key;
      const size_t cell = ((size_t)st.b * HW + key) * C;
      for (int v = lane; v < rowvec; v += geo.lanes) {
        ssw::copy_async<V>(sg.buf + r * geo.rbs + v * V, src + (size_t)r * C + v * EV);
        if (first) {
          ssw::copy_async<V>(obuf + r * geo.rbs + v * V, out + cell + v * EV);
          ssw::copy_async<V>(gbuf + r * geo.rbs + v * V, g + cell + v * EV);
        }
      }
    }
  }

  // A cell's share g / ties of each element, once for all its rows: an
  // IEEE f32 division where ties > 1, g itself where it is 1 (the same
  // value); where it is 0, no row takes it.
  __device__ __forceinline__ static void shares(const VT& gg, const int* ties, float* sh) {
#pragma unroll
    for (int k = 0; k < EV; ++k)
      sh[k] = ties[k] > 1 ? gg.get(k) / (float)ties[k] : gg.get(k);
  }
  // d of one row: the share where the row ties the cell's max, else 0.
  __device__ __forceinline__ static void store_d(const VT& f, const VT& o, const float* sh,
                                                 T* dst) {
    VT dv;
    dv.zero();
#pragma unroll
    for (int k = 0; k < EV; ++k) dv.set(k, f.get(k) == o.get(k) ? sh[k] : 0.f);
    dv.store(dst);
  }

  __device__ __forceinline__ void zero_rows(T* db, int a, int z) const {
    VT zv;
    zv.zero();
    for (int r = a; r < z; ++r)
      for (int v = lane; v < rowvec; v += geo.lanes) zv.store(db + (size_t)r * C + v * EV);
  }

  __device__ __forceinline__ void process(const ssw::Step& st, int s) {
    const ssw::Stage sg = ssw::stage_of(smem, L, s);
    T* db = d + ((size_t)st.b * N + st.p) * C;
    if (st.longc) {
      long_span(st, sg, db);
      return;
    }
    const uint8_t* obuf = sg.buf + L.bufbytes;
    const uint8_t* gbuf = sg.buf + 2 * L.bufbytes;
    for (int j = w; j < st.ncells; j += geo.walkers) {
      const int a = sg.lo[j], z = sg.lo[j + 1];
      if (a == z) continue;
      if (st.c + j >= HW) {
        zero_rows(db, a, z);
        continue;
      }
      for (int v = lane; v < rowvec; v += geo.lanes) {
        VT o, gg;
        o.load_shared(obuf + a * geo.rbs + v * V);
        gg.load_shared(gbuf + a * geo.rbs + v * V);
        int ties[EV];
#pragma unroll
        for (int k = 0; k < EV; ++k) ties[k] = 0;
        for (int r = a; r < z; ++r) {
          VT f;
          f.load_shared(sg.buf + r * geo.rbs + v * V);
#pragma unroll
          for (int k = 0; k < EV; ++k) ties[k] += f.get(k) == o.get(k);
        }
        float sh[EV];
        shares(gg, ties, sh);
        for (int r = a; r < z; ++r) {
          VT f;
          f.load_shared(sg.buf + r * geo.rbs + v * V);
          store_d(f, o, sh, db + (size_t)r * C + v * EV);
        }
      }
    }
  }

  // A long span's chunk: the walkers share its rows. The invalid points'
  // cell: zero them. Any other: the first nch chunks count the ties, the
  // counts meet after the last of them, and the next nch chunks write d.
  // A lane has one vector of the slice (kSliceVecs = 32).
  __device__ __forceinline__ void long_span(const ssw::Step& st, const ssw::Stage& sg, T* db) {
    if (invalid_cell(st)) {
      for (int r = w; r < st.E; r += geo.walkers) zero_rows(db, st.r0 + r, st.r0 + r + 1);
      return;
    }
    const bool act = lane < rowvec;
    if (st.t == 0) {
      const size_t cell = ((size_t)st.b * HW + st.c + st.ncells - 1) * C;
      if (act) {
        ov.load(out + cell + lane * EV);
        gv.load(g + cell + lane * EV);
      }
#pragma unroll
      for (int e = 0; e < EV; ++e) cnt[e] = 0;
    }
    const bool counting = st.t < st.nch;
    if (act) {
      for (int r = w; r < st.E; r += geo.walkers) {
        VT f;
        f.load_shared(sg.buf + r * geo.rbs + lane * V);
        if (counting) {
#pragma unroll
          for (int e = 0; e < EV; ++e) cnt[e] += f.get(e) == ov.get(e);
        } else {
          store_d(f, ov, sh, db + (size_t)(st.r0 + r) * C + lane * EV);
        }
      }
    }
    if (st.t + 1 != st.nch) return;
    int* slots = reinterpret_cast<int*>(smem + L.slots);
#pragma unroll
    for (int e = 0; e < EV; ++e) slots[tid * 8 + e] = cnt[e];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < EV; ++e) cnt[e] = 0;
    for (int w2 = 0; w2 < geo.walkers; ++w2)
#pragma unroll
      for (int e = 0; e < EV; ++e) cnt[e] += slots[(w2 * geo.lanes + lane) * 8 + e];
    shares(gv, cnt, sh);
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
scatter_sorted_bwd_kernel(const Params P) {
  extern __shared__ uint4 smem4[];
  const int ch0 = blockIdx.y * P.geo.cw;
  BwdOp<T, V> op;
  op.feats = static_cast<const T*>(P.feats) + ch0;
  op.out = static_cast<const T*>(P.out) + ch0;
  op.g = static_cast<const T*>(P.g) + ch0;
  op.d = static_cast<T*>(P.d) + ch0;
  op.N = P.N;
  op.C = P.C;
  op.HW = P.HW;
  op.rowvec = ((P.C - ch0 < P.geo.cw ? P.C - ch0 : P.geo.cw) + P.geo.epv - 1) / P.geo.epv;
  op.geo = P.geo;
  op.L = P.L;
  op.smem = reinterpret_cast<uint8_t*>(smem4);
  op.tid = threadIdx.x;
  op.w = threadIdx.x / P.geo.lanes;
  op.lane = threadIdx.x % P.geo.lanes;
  const long long q0 = P.Q * blockIdx.x / gridDim.x;
  const long long q1 = P.Q * (blockIdx.x + 1) / gridDim.x;
  ssw::span_walk(op, P.keys, P.N, P.HW + 1, P.geo, op.smem, P.L, q0, q1);
}

struct Plan {
  int per_sm = 0;
  long long grid = 0;
};

template <typename T, int V>
cudaError_t run(const Params& p, Plan* L, bool launch, cudaStream_t s) {
  const auto kernel = scatter_sorted_bwd_kernel<T, V>;
  cudaError_t e = ssw::launch_shape(kernel, p.L.bytes, p.Q, &L->per_sm, &L->grid);
  if (e != cudaSuccess || !launch) return e;
  kernel<<<dim3((unsigned)L->grid, p.geo.slices), kThreads, p.L.bytes, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, Plan* L, bool launch, cudaStream_t s) {
  switch (p.geo.vec) {
    case 16: return run<T, 16>(p, L, launch, s);
    case 8: return run<T, 8>(p, L, launch, s);
    case 4: return run<T, 4>(p, L, launch, s);
    default:
      if constexpr (sizeof(T) == 2) return run<T, 2>(p, L, launch, s);
      return cudaErrorInvalidValue;
  }
}

cudaError_t call(const void* feats, const void* keys, const void* out, const void* g, void* d,
                 int B, int N, int C, int HW, int dtype, int slot_bytes, int max_cells,
                 bool launch, Plan* L, Params* p, cudaStream_t s) {
  if (B <= 0 || N <= 0 || C <= 0 || HW <= 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (!ssw::make_geometry(C, dtype == 0 ? 4 : 2, slot_bytes, max_cells, 3, kSliceVecs, &p->geo))
    return cudaErrorInvalidValue;
  const int vb = p->geo.vec;
  if (reinterpret_cast<uintptr_t>(feats) % vb || reinterpret_cast<uintptr_t>(out) % vb ||
      reinterpret_cast<uintptr_t>(g) % vb || reinterpret_cast<uintptr_t>(d) % vb)
    return cudaErrorMisalignedAddress;
  p->feats = feats;
  p->keys = static_cast<const int*>(keys);
  p->out = out;
  p->g = g;
  p->d = d;
  p->N = N;
  p->C = C;
  p->HW = HW;
  p->L = ssw::layout_of(p->geo);
  p->Q = (long long)B * (HW + 1);
  return dtype == 0 ? dispatch<float>(*p, L, launch, s)
                    : dispatch<__nv_bfloat16>(*p, L, launch, s);
}

}  // namespace

// The plan of a call, into out[9], as scatter_sorted_fwd_plan's.
extern "C" int scatter_sorted_bwd_plan(int B, int N, int C, int HW, int dtype, int slot_bytes,
                                       int max_cells, void* out) {
  Plan L;
  Params p;
  const void* a = reinterpret_cast<const void*>(16);
  const cudaError_t e = call(a, nullptr, a, a, const_cast<void*>(a), B, N, C, HW, dtype,
                             slot_bytes, max_cells, false, &L, &p, nullptr);
  if (e != cudaSuccess) return (int)e;
  int* o = static_cast<int*>(out);
  o[0] = p.geo.vec; o[1] = p.geo.lanes; o[2] = p.geo.walkers; o[3] = p.geo.cap;
  o[4] = p.geo.long_rows; o[5] = p.L.bytes; o[6] = L.per_sm; o[7] = (int)L.grid;
  o[8] = p.geo.slices;
  return 0;
}

// feats [B, N, C] (dtype 0 = f32, 1 = bf16), keys [B, N] int32 sorted per
// row (sentinel HW for invalid points), out and g [B, HW, C] and d [B, N, C]
// of the feature dtype; slot_bytes and max_cells: the walk's constants
// (ops/scatter_sorted.py).
extern "C" int scatter_sorted_bwd(const void* feats, const void* keys, const void* out,
                                  const void* g, void* d, int B, int N, int C, int HW,
                                  int dtype, int slot_bytes, int max_cells, void* stream) {
  Plan L;
  Params p;
  return (int)call(feats, keys, out, g, d, B, N, C, HW, dtype, slot_bytes, max_cells, true, &L,
                   &p, static_cast<cudaStream_t>(stream));
}
