// Row-table scatter-RMW (Indirect Access unit, store/RMW path) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/scatter_rmw/scatter_rmw.py::row_table_rmw
//   (_rmw_kernel):
//   lane by lane in plan order,
//     row = tile_block[t]*block_rows + offsets[t, l]
//     table[row] = op(table[row], vals[t*lanes + l])
// rows outside the table dropped, op in ADD MIN MAX AND OR XOR MUL.
//
// The table is updated in place: the caller passes a copy it owns.
//
// What bounds it on this card: bytes (one op per element). The function
// reads every lane's value row — the plan's full (num_tiles * lanes, D)
// buffer — and reads and writes each touched table row.
//
// Design: on the TPU the grid ran in order; the tile that opened a block
// (tile_first) loaded it into VMEM and the block's later tiles accumulated
// into it. On Hopper CTAs run concurrently, and lanes alias real rows
// (padded lanes sit on offset 0 of their block; clamped out-of-range
// destinations sit on rows 0 and n-1 with identity values), so a thread
// per lane would race. Instead the lanes of one block are applied by one
// CTA, in plan order, with its threads across D: each table element is
// updated by one thread in the reference's sequential order, so duplicates
// are exact, float results are bit for bit those of the sequential
// semantics, no atomics are needed (MUL has none), and no host pass finds
// the run boundaries.
//
// Most lanes change nothing. Padded lanes, the plan's trailing slack tiles
// and the empty segments of a coalesced stream all carry the op identity,
// and they pile up on one row each: one engine tile of a zipf stream puts
// about 16,000 such lanes on the last block. Applying the identity is
// idempotent — op(op(x, e), e) == op(x, e) for every op here, floats
// included — so a lane whose whole value row is the identity, on the same
// row as the lane before it which also was, can be skipped, bit for bit.
// Two kernels, back to back on one stream:
//
//   mark  reads every value row once, at the card's full width (a warp per
//         32 consecutive lanes), and writes one byte per lane: apply it or
//         not (skipped, or its row is outside the table: stores drop).
//   walk  one CTA per tile; only a tile that opens its block goes on. It
//         compacts the block's lanes to apply, window by window, into a
//         list in shared memory (in plan order), then its threads walk the
//         list across D. Each thread takes kGroup lanes at a time: it
//         issues all their value and table loads together, folds them in
//         order in registers (a lane on the same row as an earlier lane of
//         the group continues from that lane's result), and writes back in
//         order, so the last write of a row holds its final value. One
//         round trip to memory serves kGroup lanes.
//
// The mark pass is the byte-bound part; the walk's critical path is the
// longest list of lanes to apply in one block.
//
// Float MIN/MAX propagate NaN (as torch.minimum / jnp.minimum); bf16
// computes in float and rounds to nearest even; u32 compares unsigned;
// integer ADD/MUL wrap.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

enum Op { kAdd = 0, kMin = 1, kMax = 2, kAnd = 3, kOr = 4, kXor = 5,
          kMul = 6 };
enum Dtype { kF32 = 0, kBF16 = 1, kI32 = 2, kU32 = 3 };
constexpr int kThreads = 256;                  // both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kMarkLanes = 32;                 // consecutive lanes per warp
constexpr int kPerThread = 16;                 // walk: lanes compacted
constexpr int kWindow = kThreads * kPerThread; //   per thread, per window
constexpr int kGroup = 16;                     // walk: loads in flight

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  using C = float;
  static constexpr bool kFloat = true;
  __device__ static float load(float x) { return x; }
  __device__ static float store(float x) { return x; }
  __device__ static unsigned bits(float x) { return __float_as_uint(x); }
  __device__ static float lowest() { return -INFINITY; }
  __device__ static float highest() { return INFINITY; }
};

template <>
struct Traits<__nv_bfloat16> {
  using C = float;
  static constexpr bool kFloat = true;
  __device__ static float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ static unsigned bits(__nv_bfloat16 x) {
    return __bfloat16_as_ushort(x);
  }
  __device__ static float lowest() { return -INFINITY; }
  __device__ static float highest() { return INFINITY; }
};

template <>
struct Traits<int> {
  using C = int;
  static constexpr bool kFloat = false;
  __device__ static int load(int x) { return x; }
  __device__ static int store(int x) { return x; }
  __device__ static unsigned bits(int x) { return (unsigned)x; }
  __device__ static int lowest() { return INT_MIN; }
  __device__ static int highest() { return INT_MAX; }
};

template <>
struct Traits<unsigned> {
  using C = unsigned;
  static constexpr bool kFloat = false;
  __device__ static unsigned load(unsigned x) { return x; }
  __device__ static unsigned store(unsigned x) { return x; }
  __device__ static unsigned bits(unsigned x) { return x; }
  __device__ static unsigned lowest() { return 0u; }
  __device__ static unsigned highest() { return UINT_MAX; }
};

template <typename T, int OP>
__device__ T identity() {
  using Tr = Traits<T>;
  using C = typename Tr::C;
  if constexpr (OP == kMul) return Tr::store(C(1));
  else if constexpr (OP == kMin) return Tr::store(Tr::highest());
  else if constexpr (OP == kMax) return Tr::store(Tr::lowest());
  else if constexpr (OP == kAnd) return Tr::store(C(~0u));
  else return Tr::store(C(0));
}

template <typename T, int OP>
__device__ T apply(T a_s, T b_s) {
  using Tr = Traits<T>;
  using C = typename Tr::C;
  const C a = Tr::load(a_s), b = Tr::load(b_s);
  C r;
  if constexpr (Tr::kFloat) {
    if constexpr (OP == kAdd) r = __fadd_rn(a, b);
    else if constexpr (OP == kMul) r = __fmul_rn(a, b);
    else if constexpr (OP == kMin) r = a != a ? a : (b != b ? b : (b < a ? b : a));
    else r = a != a ? a : (b != b ? b : (b > a ? b : a));
  } else {
    if constexpr (OP == kAdd) r = C((unsigned)a + (unsigned)b);
    else if constexpr (OP == kMul) r = C((unsigned)a * (unsigned)b);
    else if constexpr (OP == kMin) r = b < a ? b : a;
    else if constexpr (OP == kMax) r = b > a ? b : a;
    else if constexpr (OP == kAnd) r = a & b;
    else if constexpr (OP == kOr) r = a | b;
    else r = a ^ b;
  }
  return Tr::store(r);
}

template <typename T>
struct Args {
  T* table;
  const int* tile_block;
  const int* tile_first;
  const int* offsets;
  const T* vals;
  unsigned char* apply_lane;  // scratch, one byte per lane
  long long n_rows;
  long long total;            // num_tiles * lanes
  int d, num_tiles, block_rows, lanes;
};

// Lane l opens a walk (a block's run of tiles): no lane before it counts.
template <typename T>
__device__ bool opens_walk(const Args<T>& a, long long l) {
  return l == 0 || (l % a.lanes == 0 && a.tile_first[l / a.lanes] != 0);
}

template <typename T>
__device__ long long row_of(const Args<T>& a, long long l) {
  return (long long)a.tile_block[l / a.lanes] * a.block_rows + a.offsets[l];
}

// True on every thread of the warp iff lane l's whole value row is the
// identity, bit for bit.
template <typename T>
__device__ bool all_identity(const Args<T>& a, long long l, unsigned ident) {
  bool ok = true;
  for (int c = threadIdx.x % 32; c < a.d; c += 32)
    ok &= Traits<T>::bits(a.vals[l * a.d + c]) == ident;
  return __all_sync(0xffffffffu, ok);
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
mark_kernel(Args<T> a) {
  const long long first =
      ((long long)blockIdx.x * kWarps + threadIdx.x / 32) * kMarkLanes;
  if (first >= a.total) return;
  const unsigned ident = Traits<T>::bits(identity<T, OP>());
  bool prev_ident = false;
  long long prev_row = 0;
  if (!opens_walk(a, first)) {
    prev_ident = all_identity<T>(a, first - 1, ident);
    prev_row = row_of(a, first - 1);
  }
  const long long last =
      first + kMarkLanes < a.total ? first + kMarkLanes : a.total;
  for (long long l = first; l < last; ++l) {
    const bool is_ident = all_identity<T>(a, l, ident);
    const long long row = row_of(a, l);
    const bool skip =
        !opens_walk(a, l) && is_ident && prev_ident && row == prev_row;
    if (threadIdx.x % 32 == 0)
      a.apply_lane[l] = !skip && row >= 0 && row < a.n_rows;
    prev_ident = is_ident;
    prev_row = row;
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
walk_kernel(Args<T> a) {
  __shared__ int list[kWindow];
  __shared__ int warp_start[kWarps + 1];
  const int t0 = blockIdx.x;
  if (t0 > 0 && a.tile_first[t0] == 0) return;  // not opening a block
  int t_end = t0 + 1;
  while (t_end < a.num_tiles && a.tile_first[t_end] == 0) ++t_end;
  const long long base = (long long)a.tile_block[t0] * a.block_rows;
  const long long end = (long long)t_end * a.lanes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (long long win = (long long)t0 * a.lanes; win < end; win += kWindow) {
    // compact this window's lanes to apply, in plan order
    const long long mine = win + (long long)threadIdx.x * kPerThread;
    unsigned mask = 0;
#pragma unroll
    for (int u = 0; u < kPerThread; ++u)
      if (mine + u < end && a.apply_lane[mine + u]) mask |= 1u << u;
    const int count = __popc(mask);
    int incl = count;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_start[warp] = incl;
    __syncthreads();
    if (threadIdx.x == 0) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int c = warp_start[w];
        warp_start[w] = s;
        s += c;
      }
      warp_start[kWarps] = s;
    }
    __syncthreads();
    int pos = warp_start[warp] + incl - count;
    for (int u = 0; u < kPerThread; ++u)
      if (mask >> u & 1u) list[pos++] = threadIdx.x * kPerThread + u;
    __syncthreads();
    const int n_apply = warp_start[kWarps];
    // apply them, threads across D
    for (int c = threadIdx.x; c < a.d; c += kThreads) {
      for (int g = 0; g < n_apply; g += kGroup) {
        int off[kGroup];
        long long l[kGroup];
        T v[kGroup], r[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (g + u < n_apply) {
            l[u] = win + list[g + u];
            off[u] = a.offsets[l[u]];
            v[u] = a.vals[l[u] * a.d + c];
          }
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          if (g + u < n_apply) r[u] = a.table[(base + off[u]) * a.d + c];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (g + u >= n_apply) continue;
          T cur = r[u];
#pragma unroll
          for (int j = 0; j < u; ++j)  // the latest earlier lane on the row
            if (off[j] == off[u]) cur = r[j];
          r[u] = apply<T, OP>(cur, v[u]);
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u)  // in order: the last write wins
          if (g + u < n_apply) a.table[(base + off[u]) * a.d + c] = r[u];
      }
    }
    __syncthreads();  // the list is rewritten by the next window
  }
}

template <typename T, int OP>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  const long long mark_blocks =
      (a.total + kWarps * kMarkLanes - 1) / (kWarps * kMarkLanes);
  mark_kernel<T, OP><<<(unsigned)mark_blocks, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  walk_kernel<T, OP><<<a.num_tiles, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_op(int op, const Args<T>& a, cudaStream_t s) {
  switch (op) {
    case kAdd: return launch<T, kAdd>(a, s);
    case kMin: return launch<T, kMin>(a, s);
    case kMax: return launch<T, kMax>(a, s);
    case kMul: return launch<T, kMul>(a, s);
    default: break;
  }
  if constexpr (!Traits<T>::kFloat) {
    switch (op) {
      case kAnd: return launch<T, kAnd>(a, s);
      case kOr: return launch<T, kOr>(a, s);
      case kXor: return launch<T, kXor>(a, s);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(int op, void* table, const void* tile_block,
                     const void* tile_first, const void* offsets,
                     const void* vals, void* scratch, long long n_rows, int d,
                     int num_tiles, int block_rows, int lanes,
                     cudaStream_t s) {
  const Args<T> a{static_cast<T*>(table),
                  static_cast<const int*>(tile_block),
                  static_cast<const int*>(tile_first),
                  static_cast<const int*>(offsets),
                  static_cast<const T*>(vals),
                  static_cast<unsigned char*>(scratch),
                  n_rows,
                  (long long)num_tiles * lanes,
                  d,
                  num_tiles,
                  block_rows,
                  lanes};
  return dispatch_op<T>(op, a, s);
}

}  // namespace

extern "C" {

const char* dx_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// table: (n_rows, d), n_rows % block_rows == 0, updated in place;
// tile_block, tile_first: (num_tiles,) int32; offsets: (num_tiles, lanes)
// int32 in [0, block_rows); vals: (num_tiles * lanes, d), the op identity
// on padded lanes; scratch: num_tiles * lanes bytes the kernels may
// overwrite. dtype: 0 f32, 1 bf16, 2 i32, 3 u32 (int32 container); op: the
// Op enum. Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// dtype/op pair the kernel does not take (bitwise ops on floats).
int dx_row_table_rmw(void* table, const void* tile_block,
                     const void* tile_first, const void* offsets,
                     const void* vals, void* scratch, long long n_rows,
                     int d, int num_tiles, int block_rows, int lanes,
                     int dtype, int op, void* stream) {
  if (num_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = dispatch<float>(op, table, tile_block, tile_first, offsets, vals,
                            scratch, n_rows, d, num_tiles, block_rows, lanes,
                            s);
      break;
    case kBF16:
      err = dispatch<__nv_bfloat16>(op, table, tile_block, tile_first,
                                    offsets, vals, scratch, n_rows, d,
                                    num_tiles, block_rows, lanes, s);
      break;
    case kI32:
      err = dispatch<int>(op, table, tile_block, tile_first, offsets, vals,
                          scratch, n_rows, d, num_tiles, block_rows, lanes,
                          s);
      break;
    case kU32:
      err = dispatch<unsigned>(op, table, tile_block, tile_first, offsets,
                               vals, scratch, n_rows, d, num_tiles,
                               block_rows, lanes, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
