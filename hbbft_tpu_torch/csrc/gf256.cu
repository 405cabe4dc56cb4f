// GF(2^8) matrix product as an F2 bit product, written by hand for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes gf256_matmul
// (hbbft_tpu/ops/gf256.py) as a jnp graph, unpack -> int8 dot -> parity ->
// pack, that XLA runs on the TPU's matrix unit.  The port's epoch runs its
// Reed-Solomon encode (and any erasure repair) through the same product on
// the card, so it gets this kernel.
//
// The function.  mwords is the (8r x 8k) F2 matrix of expand_gf_matrix,
// row 8*o + b = bit b of output byte o, column 8*i + j = bit j of input byte
// i, each row packed by pack_gf_matrix into kw = ceil(k/4) little-endian
// words (bit t of word w = column 32w + t); x is (k x L) bytes.  out[o, l]
// has bit b = parity(sum_c M[8o+b, c] * xbits[c, l]), and the k input bytes
// of column l, read little-endian, are exactly that column's 8k bits in the
// same word layout.
//
// What bounds it.  Each output bit is kw AND-XOR word steps (one LOP3 each)
// and one popcount: integer work on few bytes, bound by the integer pipe at
// large L and by launch latency at the epoch's widths (a few hundred to a
// few thousand columns).  One thread owns one column: it packs the column's
// k bytes into kw words in registers once, then for every output byte of
// its row tile ANDs them with the matrix rows, XORs the words together and
// takes __popc(.) & 1 per bit.  The block copies its tile's 8*RT packed
// rows into shared memory at its start (the host packed them once, when the
// matrix was memoised), so the product, the parity and the pack are one
// pass with no intermediate in device memory; every lane of a warp reads
// the same matrix word (a broadcast).

#include <cuda_runtime.h>
#include <stdint.h>

#define TPB 128
#define RT 8      // output bytes (8 bit rows each) per block tile
#define KWMAX 64  // words per packed row: k <= 256 (n = k + m <= 256)

__global__ void __launch_bounds__(TPB)
gf256_matmul_kernel(const uint32_t* __restrict__ mwords, const uint8_t* __restrict__ x,
                    uint8_t* __restrict__ out, int r, int k, long long L) {
  __shared__ uint32_t rows[RT * 8 * KWMAX];
  const int kw = (k + 3) / 4;
  const int o0 = blockIdx.y * RT;
  const int nrows = min(RT, r - o0) * 8;
  const uint32_t* tile = mwords + (long long)o0 * 8 * kw;
  for (int idx = threadIdx.x; idx < nrows * kw; idx += TPB) rows[idx] = tile[idx];
  __syncthreads();

  const long long l = (long long)blockIdx.x * TPB + threadIdx.x;
  if (l >= L) return;
  uint32_t col[KWMAX];
#pragma unroll
  for (int w = 0; w < KWMAX; ++w) {
    if (w < kw) {
      uint32_t word = 0u;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = 4 * w + t;
        if (i < k) word |= (uint32_t)x[(long long)i * L + l] << (8 * t);
      }
      col[w] = word;
    }
  }
  for (int o = 0; o < nrows / 8; ++o) {
    uint32_t byte = 0u;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const uint32_t* row = rows + (o * 8 + b) * kw;
      uint32_t acc = 0u;
#pragma unroll
      for (int w = 0; w < KWMAX; ++w) {
        if (w < kw) acc ^= row[w] & col[w];
      }
      byte |= (uint32_t)(__popc(acc) & 1) << b;
    }
    out[(long long)(o0 + o) * L + l] = (uint8_t)byte;
  }
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched); -1 when k is
// beyond the packed rows' room.
int gf256_matmul(const uint32_t* mwords, const uint8_t* x, uint8_t* out, int r, int k,
                 long long L, void* stream) {
  if (k > 4 * KWMAX) return -1;
  if (r <= 0 || k <= 0 || L <= 0) return 0;
  dim3 grid((unsigned)((L + TPB - 1) / TPB), (unsigned)((r + RT - 1) / RT));
  gf256_matmul_kernel<<<grid, TPB, 0, (cudaStream_t)stream>>>(mwords, x, out, r, k, L);
  return (int)cudaGetLastError();
}

const char* gf256_error_string(int code) {
  if (code == -1) return "k above 256 input bytes";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
