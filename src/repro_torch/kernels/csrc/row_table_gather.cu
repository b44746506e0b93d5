// Row-table gather (Indirect Access unit, paper §3.2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gather/gather.py::row_table_gather (_gather_kernel):
//   out[t*lanes + l] = table[tile_block[t]*block_rows + offsets[t, l]]
// for every plan tile t and lane l, padded lanes included (they read
// offset 0 of their tile's block), rows clamped into the table.
//
// What bounds it on this card: bytes. There is no arithmetic; every output
// row is one row read and one row written. The output is the plan's full
// (num_tiles * lanes, D) buffer, valid lanes or not, so the bytes written
// are set by the plan's static tile budget, not by the stream.
//
// Design: on the TPU each grid step DMAed one table block into VMEM and
// consecutive steps reused it (a "row-buffer hit"). Here CTAs run
// concurrently in no order, so nothing is staged: one CTA per plan tile
// loads its own tile_block / offsets (there is no scalar prefetch) and
// its threads cover lanes x row-vectors, neighbouring threads on
// neighbouring 16-byte words of one row. The plan's sort keeps a tile's
// rows inside one block, so a CTA reads a narrow address range. The copy
// moves bits, so one kernel serves every element type: the host picks the
// widest vector (16, 8, 4 or 2 bytes) that divides the row and both
// pointers' alignment.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void row_table_gather_kernel(const V* __restrict__ table,
                                        const int* __restrict__ tile_block,
                                        const int* __restrict__ offsets,
                                        V* __restrict__ out,
                                        long long n_rows, int block_rows,
                                        int lanes, int vec_per_row) {
  const long long t = blockIdx.x;
  const long long base = (long long)tile_block[t] * block_rows;
  const int* offs = offsets + t * lanes;
  V* dst = out + t * lanes * (long long)vec_per_row;
  const int total = lanes * vec_per_row;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int l = i / vec_per_row;
    const int v = i - l * vec_per_row;
    long long row = base + offs[l];
    row = row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
    dst[i] = table[row * vec_per_row + v];
  }
}


template <typename V>
cudaError_t launch(const void* table, const void* tile_block,
                   const void* offsets, void* out, long long n_rows,
                   long long row_bytes, int num_tiles, int block_rows,
                   int lanes, cudaStream_t stream) {
  const int vec_per_row = (int)(row_bytes / (long long)sizeof(V));
  row_table_gather_kernel<V><<<num_tiles, kThreads, 0, stream>>>(
      static_cast<const V*>(table), static_cast<const int*>(tile_block),
      static_cast<const int*>(offsets), static_cast<V*>(out), n_rows,
      block_rows, lanes, vec_per_row);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dx_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// table: (n_rows, row_bytes) bytes, n_rows % block_rows == 0;
// tile_block: (num_tiles,) int32; offsets: (num_tiles, lanes) int32;
// out: (num_tiles * lanes, row_bytes) bytes. Returns cudaGetLastError().
int dx_row_table_gather(const void* table, const void* tile_block,
                        const void* offsets, void* out, long long n_rows,
                        long long row_bytes, int num_tiles, int block_rows,
                        int lanes, void* stream) {
  if (num_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
  int vec = 16;
  while (vec > 2 && (row_bytes % vec != 0 || align % vec != 0)) vec /= 2;
  cudaError_t err;
  switch (vec) {
    case 16:
      err = launch<uint4>(table, tile_block, offsets, out, n_rows,
                          row_bytes, num_tiles, block_rows, lanes, s);
      break;
    case 8:
      err = launch<uint2>(table, tile_block, offsets, out, n_rows,
                          row_bytes, num_tiles, block_rows, lanes, s);
      break;
    case 4:
      err = launch<unsigned int>(table, tile_block, offsets, out, n_rows,
                                 row_bytes, num_tiles, block_rows, lanes, s);
      break;
    default:
      err = launch<unsigned short>(table, tile_block, offsets, out, n_rows,
                                   row_bytes, num_tiles, block_rows, lanes,
                                   s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
