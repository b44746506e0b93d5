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
// buffer, 142.6 MB for one engine tile of the main path's zipf stream —
// and reads and writes each touched table row once.
//
// What the plan guarantees (core/reorder.py::make_row_table_plan over a
// sorted stream, ops.py::plan_updates), and this kernel relies on: each
// block's lanes form one run of tiles (tile_first opens it; the trailing
// slack tiles repeat the last block); within a run the offsets of the
// valid lanes do not decrease, and the invalid lanes come after them at
// offset 0 holding the op identity. So a row is touched by more than one
// lane of the plan only at offset 0 of a block, or by lanes next to each
// other in the run.
//
// Design: on the TPU the grid ran in order; the tile that opened a block
// loaded it into VMEM and the block's later tiles accumulated into it. On
// Hopper CTAs run concurrently and MUL has no atomic. Two kernels, back to
// back on one stream:
//
//   stream  reads every value row once, 16-byte words (elements one by one
//           where a row is not a whole number of them), 4 words per thread
//           in flight. Each warp takes a contiguous range of chunks of 32
//           lanes. A lane is single-writer when its offset is not 0 and its
//           neighbours in the run are on other rows, so no other lane of
//           the plan touches its row: the warp applies it at once, its
//           table words loaded in the same round trip as its values (the
//           decision needs only the offsets). Every other lane gets a mark
//           bit: apply it later, unless its whole value row is the
//           identity, it follows an identity lane on the same row and does
//           not open a run (applying the identity is idempotent,
//           op(op(x, e), e) == op(x, e) for every op here, floats included,
//           so skipping it is exact), or its row is outside the table
//           (stores drop). The identity of the lane before a chunk is
//           carried from the warp's previous chunk, so only a range's first
//           chunk may read that lane's row again.
//   chains  one warp per run (the warp of the tile that opens it) finds
//           the run's end, reads its mark words and applies the marked
//           lanes in plan order with its threads across the row's words,
//           4 lanes' loads in flight, folded in order in registers (a lane
//           on the row of an earlier one continues from its result) and
//           written back in order. Each table word is updated by one thread
//           in plan order: duplicates are exact and float results are bit
//           for bit those of the sequential loop.
//
// What that does about the first version (a mark pass, then one CTA per
// block walking every marked lane: 0.2257 ms on a zipf engine tile against
// a 0.0466 ms byte bound, H100 80GB HBM3 at 700 W): the value rows are
// read once, not twice; the walk's critical path (block 0 held 738 real
// lanes, one dependent round trip per 16) is gone, since those lanes are
// single-writer and applied by the streaming pass across the whole card;
// the mark pass's 4-byte loads and warp vote per row became 16-byte loads
// with 4 words in flight; and what is left for the chains pass is a
// block's offset-0 row and the rows its clamped and empty-segment lanes
// pile onto, a few lanes per block after skipping. Any dependent round
// trip left on a warp's path costs the queueing latency of a saturated
// memory system, which is why the lane metadata takes one round of
// independent loads and the identity of the lane before a chunk is
// carried, not read again. (A ring of TMA bulk copies into shared memory
// was tried in its place and was slower: its copies alone took as long as
// this whole pass.)
//
// Float MIN/MAX propagate NaN (as torch.minimum / jnp.minimum); bf16
// computes in float and rounds to nearest even; u32 compares unsigned;
// integer ADD/MUL wrap.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Op { kAdd = 0, kMin = 1, kMax = 2, kAnd = 3, kOr = 4, kXor = 5,
          kMul = 6 };
enum Dtype { kF32 = 0, kBF16 = 1, kI32 = 2, kU32 = 3 };
constexpr int kThreads = 256;                  // both kernels
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStep = 4;                       // stream: words per thread
constexpr int kScan = 4;                       // chains: mark words per thread
constexpr int kGroup = 4;                      // chains: lanes in flight

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

// A word W of a row: a 16-byte vector (uint4) or one element (T).
template <typename T, typename W>
struct Word {
  static constexpr int kN = sizeof(W) / sizeof(T);
};

template <typename T, int OP, typename W>
__device__ W apply_word(W a, W b) {
  T* x = reinterpret_cast<T*>(&a);
  const T* y = reinterpret_cast<const T*>(&b);
#pragma unroll
  for (int i = 0; i < Word<T, W>::kN; ++i) x[i] = apply<T, OP>(x[i], y[i]);
  return a;
}

// What word_is compares with: the identity's bits, repeated over 32 bits
// for 16-byte words (bf16: two elements).
template <typename T, int OP, typename W>
__device__ unsigned ident_pattern() {
  const unsigned ident = Traits<T>::bits(identity<T, OP>());
  if constexpr (std::is_same<W, uint4>::value && sizeof(T) == 2)
    return ident | ident << 16;
  return ident;
}

// True iff every element of the word has the identity's bits.
template <typename T, typename W>
__device__ bool word_is(W a, unsigned pattern) {
  if constexpr (std::is_same<W, uint4>::value) {
    return a.x == pattern && a.y == pattern && a.z == pattern &&
           a.w == pattern;
  } else {
    return Traits<T>::bits(a) == pattern;
  }
}

// Value rows are read once: stream them past the caches.
template <typename W>
__device__ W load_once(const W* p) {
  if constexpr (std::is_same<W, uint4>::value) return __ldcs(p);
  else return *p;
}

template <typename T>
struct Args {
  T* table;
  const int* tile_block;
  const int* tile_first;
  const int* offsets;
  const T* vals;
  unsigned* marks;            // scratch: bit b of word k marks lane 32k+b
  int n_rows;
  int total;                  // num_tiles * lanes
  int d, num_tiles, block_rows, lanes;
};

// One lane of a 32-lane chunk, as its thread of the warp sees it. Within a
// run every tile is on the run's block (tile_first is a block-change flag),
// so lanes of one run are on the same row iff their offsets are equal.
struct Lane {
  int row = -1;            // in the table, or -1
  bool opens = true;       // opens a run: no lane before it counts
  bool prev_same = false;  // the lane before is on the same row
  bool multi = true;       // another lane of the run may touch its row
};

template <typename T>
__device__ Lane lane_of(const Args<T>& a, int first, int count, int lane) {
  Lane x;
  if (lane < count) {
    // six independent loads (clamped at the ends), one round trip
    const int l = first + lane;
    const int t = l / a.lanes, p = l - t * a.lanes;  // tile, place in it
    const bool last_lane = l + 1 == a.total;
    const int off = a.offsets[l];
    const int off_prev = a.offsets[l > 0 ? l - 1 : l];
    const int off_next = a.offsets[last_lane ? l : l + 1];
    const int first_here = a.tile_first[t];
    const int first_next =
        a.tile_first[!last_lane & p + 1 == a.lanes ? t + 1 : t];
    const long long row =
        (long long)a.tile_block[t] * a.block_rows + off;
    x.opens = l == 0 | (p == 0 & first_here != 0);
    x.prev_same = !x.opens & off_prev == off;
    const bool next_opens = p + 1 == a.lanes & first_next != 0;
    const bool next_same = !last_lane & !next_opens & off_next == off;
    x.multi = off == 0 | x.prev_same | next_same;
    x.row = row >= 0 & row < a.n_rows ? (int)row : -1;
  }
  return x;
}

// Where thread `lane` is in a chunk's words (lane u of the chunk, word c of
// its row), stepping 32 words at a time: no division per word.
struct Walk {
  int u0, c0, du, dc, words;
};

__device__ Walk walk_of(int words, int lane) {
  return {lane / words, lane % words, 32 / words, 32 % words, words};
}

__device__ void advance(const Walk& w, int& u, int& c) {
  u += w.du;
  c += w.dc;
  if (c >= w.words) {
    c -= w.words;
    ++u;
  }
}

// The chunk's value rows, word by word from src (its first word), kStep
// words per thread in flight: single-writer lanes are applied, their table
// words loaded beside their values. Returns bit u set where lane u of the
// chunk has a word that is not the identity (this thread's words only).
template <typename T, int OP, typename W>
__device__ unsigned stream_chunk(const Args<T>& a, const Lane& x, int count,
                                 int lane, const Walk& wk, const W* src,
                                 unsigned pattern) {
  W* table = reinterpret_cast<W*>(a.table);
  const unsigned direct = __ballot_sync(kFull, !x.multi && x.row >= 0);
  const int n_words = count * wk.words;
  unsigned nonident = 0;
  int u = wk.u0, c = wk.c0;  // of word j = base + 32 * k + lane
  for (int base = 0; base < n_words; base += 32 * kStep) {
    W v[kStep], t[kStep];
    long long at[kStep];  // table word of a single-writer lane, or -1
    int uk[kStep];
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      const int j = base + 32 * k + lane;
      uk[k] = u;
      at[k] = -1;
      if (direct) {  // the same on every thread of the warp
        const int row = __shfl_sync(kFull, x.row, u < 31 ? u : 31);
        if (j < n_words && (direct >> u & 1u))
          at[k] = (long long)row * wk.words + c;
      }
      if (j < n_words) v[k] = load_once(src + j);
      if (at[k] >= 0) t[k] = table[at[k]];
      advance(wk, u, c);
    }
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      if (base + 32 * k + lane >= n_words) continue;
      if (!word_is<T, W>(v[k], pattern)) nonident |= 1u << uk[k];
      if (at[k] >= 0) table[at[k]] = apply_word<T, OP, W>(t[k], v[k]);
    }
  }
  return nonident;
}

// Mark the chunk's lanes that the chains pass applies: another lane of the
// run may touch their row, their row is in the table, and they are not an
// identity lane after an identity lane on the same row. `carry` holds
// whether the lane before the chunk is the identity, where the warp knows
// it (it took that chunk just before); it is updated for the next chunk.
template <typename T, typename W>
__device__ void mark_chunk(const Args<T>& a, const Lane& x, int chunk,
                           int count, int lane, int words, unsigned nonident,
                           unsigned pattern, int& carry) {
  nonident = __reduce_or_sync(kFull, nonident);
  bool before_ident = carry > 0;
  // else lane 0's skip test needs the lane before the chunk: read its row
  // again, only when that lane is on the same row of the same run
  if (carry < 0 &&
      __shfl_sync(kFull, (int)(x.prev_same && !(nonident & 1u)), 0)) {
    const W* prev = reinterpret_cast<const W*>(a.vals) +
                    ((long long)chunk * 32 - 1) * words;
    bool ok = true;
    for (int w = lane; w < words; w += 32)
      ok &= word_is<T, W>(prev[w], pattern);
    before_ident = __all_sync(kFull, ok);
  }
  const bool is_ident = !(nonident >> lane & 1u);
  const bool prev_ident =
      lane == 0 ? before_ident : !(nonident >> (lane - 1) & 1u);
  const bool skip = x.prev_same && is_ident && prev_ident;
  const unsigned marked =
      __ballot_sync(kFull, lane < count && x.multi && x.row >= 0 && !skip);
  if (lane == 0) a.marks[chunk] = marked;
  carry = !(nonident >> (count - 1) & 1u);
}

// The chunks [begin, end) of warp g of n: contiguous, so that each chunk
// but the first finds the identity of the lane before it in `carry`.
__device__ void chunks_of(int n_chunks, int g, int n, int& begin,
                          int& end) {
  const int per = (n_chunks + n - 1) / n;
  begin = g * per < n_chunks ? g * per : n_chunks;
  end = begin + per < n_chunks ? begin + per : n_chunks;
}

// Streaming pass: each warp takes its range of chunks, 32 lanes at a time.
template <typename T, int OP, typename W>
__global__ void __launch_bounds__(kThreads)
rmw_stream_kernel(Args<T> a) {
  const W* vals = reinterpret_cast<const W*>(a.vals);
  const int words = a.d / Word<T, W>::kN;
  const unsigned pattern = ident_pattern<T, OP, W>();
  const int lane = threadIdx.x % 32;
  const Walk wk = walk_of(words, lane);
  int begin, end, carry = -1;
  chunks_of((a.total + 31) / 32, blockIdx.x * kWarps + threadIdx.x / 32,
            gridDim.x * kWarps, begin, end);
  for (int chunk = begin; chunk < end; ++chunk) {
    const int first = chunk * 32;
    const int count = a.total - first < 32 ? a.total - first : 32;
    const Lane x = lane_of(a, first, count, lane);
    const unsigned nonident = stream_chunk<T, OP, W>(
        a, x, count, lane, wk, vals + (long long)first * words, pattern);
    mark_chunk<T, W>(a, x, chunk, count, lane, words, nonident, pattern,
                     carry);
  }
}

// --- chains pass -----------------------------------------------------------

// Apply lanes l[0..n) (marked, in plan order, one block) with the warp
// across the row's words: loads issued together, folded in order in
// registers (a lane on the row of an earlier one continues from its
// result), written back in order.
template <typename T, int OP, typename W>
__device__ void apply_lanes(const Args<T>& a, long long base, int words,
                            const long long (&l)[kGroup], int n, int lane) {
  const W* vals = reinterpret_cast<const W*>(a.vals);
  W* table = reinterpret_cast<W*>(a.table);
  int off[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u)
    if (u < n) off[u] = a.offsets[l[u]];
  for (int c = lane; c < words; c += 32) {
    W v[kGroup], r[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (u < n) {
        v[u] = load_once(vals + l[u] * words + c);
        r[u] = table[(base + off[u]) * words + c];
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (u >= n) continue;
      W cur = r[u];
#pragma unroll
      for (int j = 0; j < u; ++j)
        if (off[j] == off[u]) cur = r[j];
      r[u] = apply_word<T, OP, W>(cur, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u)  // in order: the last write wins
      if (u < n) table[(base + off[u]) * words + c] = r[u];
  }
}

// One warp per run (the warp of the tile that opens it): finds the run's
// end, reads its mark words kScan per thread at a time and applies the
// marked lanes in plan order, kGroup at a time.
template <typename T, int OP, typename W>
__global__ void __launch_bounds__(kThreads)
rmw_chains_kernel(Args<T> a) {
  const int lane = threadIdx.x % 32;
  const int t0 = blockIdx.x * kWarps + threadIdx.x / 32;
  if (t0 >= a.num_tiles || (t0 > 0 && a.tile_first[t0] == 0)) return;
  int t_end = a.num_tiles;
  for (int t = t0 + 1; t < a.num_tiles; t += 32 * kScan) {
    bool f[kScan];
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      const int tt = t + 32 * q + lane;
      f[q] = tt < a.num_tiles && a.tile_first[tt] != 0;
    }
    int found = -1;
#pragma unroll
    for (int q = kScan - 1; q >= 0; --q) {
      const unsigned m = __ballot_sync(kFull, f[q]);
      if (m) found = t + 32 * q + __ffs(m) - 1;
    }
    if (found >= 0) {
      t_end = found;
      break;
    }
  }
  const int words = a.d / Word<T, W>::kN;
  const long long base = (long long)a.tile_block[t0] * a.block_rows;
  const long long lo = (long long)t0 * a.lanes;
  const long long hi = (long long)t_end * a.lanes;
  const long long k_last = (hi - 1) / 32;
  for (long long kb = lo / 32; kb <= k_last; kb += 32 * kScan) {
    unsigned w[kScan];
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      const long long k = kb + lane * kScan + q;
      unsigned m = 0;
      if (k <= k_last) {
        m = a.marks[k];
        const long long l0 = k * 32;  // keep the run's lanes [lo, hi) only
        if (l0 < lo) m &= ~0u << (int)(lo - l0);
        if (l0 + 32 > hi) m &= (1u << (int)(hi - l0)) - 1u;
      }
      w[q] = m;
    }
    unsigned mine = 0;
#pragma unroll
    for (int q = 0; q < kScan; ++q) mine |= w[q];
    unsigned any = __ballot_sync(kFull, mine != 0);
    while (any) {
      const int src = __ffs(any) - 1;
      any &= any - 1;
#pragma unroll
      for (int q = 0; q < kScan; ++q) {
        unsigned m = __shfl_sync(kFull, w[q], src);
        const long long l0 = (kb + src * kScan + q) * 32;
        while (m) {
          long long l[kGroup];
          int n = 0;
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            if (m) {
              l[u] = l0 + __ffs(m) - 1;
              m &= m - 1;
              n = u + 1;
            }
          }
          apply_lanes<T, OP, W>(a, base, words, l, n, lane);
        }
      }
    }
  }
}

// --- launch ----------------------------------------------------------------

template <typename T, int OP, typename W>
cudaError_t launch_passes(const Args<T>& a, int sms, cudaStream_t stream) {
  static int per_sm = 0;  // resident streaming CTAs per SM, asked once
  cudaError_t err = cudaSuccess;
  if (per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rmw_stream_kernel<T, OP, W>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int needed = ((a.total + 31) / 32 + kWarps - 1) / kWarps;
  rmw_stream_kernel<T, OP, W>
      <<<needed < resident ? needed : resident, kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmw_chains_kernel<T, OP, W>
      <<<(a.num_tiles + kWarps - 1) / kWarps, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int OP>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long row_bytes = (long long)a.d * sizeof(T);
  // 16-byte words where a row is a whole number of them and both buffers
  // are 16-byte aligned; elements one by one otherwise
  const bool vec = row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.vals) % 16 == 0;
  return vec ? launch_passes<T, OP, uint4>(a, sms, stream)
             : launch_passes<T, OP, T>(a, sms, stream);
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
  // lane and row numbers are 32-bit on the card
  const long long total = (long long)num_tiles * lanes;
  if (total > INT_MAX - 64 || n_rows > INT_MAX) return cudaErrorInvalidValue;
  const Args<T> a{static_cast<T*>(table),
                  static_cast<const int*>(tile_block),
                  static_cast<const int*>(tile_first),
                  static_cast<const int*>(offsets),
                  static_cast<const T*>(vals),
                  static_cast<unsigned*>(scratch),
                  (int)n_rows,
                  (int)total,
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
// int32 in [0, block_rows), laid out as make_row_table_plan lays them out
// (see the note at the top); vals: (num_tiles * lanes, d), the op identity
// on padded lanes; scratch: ceil(num_tiles * lanes / 32) 32-bit words the
// kernels may overwrite. dtype: 0 f32, 1 bf16, 2 i32, 3 u32 (int32
// container); op: the Op enum. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a dtype/op pair the kernel does not take
// (bitwise ops on floats) or more than 2^31 - 64 lanes or table rows.
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
