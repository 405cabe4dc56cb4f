// Batched tagged SHA-256 and the Merkle proof walk, written by hand for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes its device hash plane
// (hbbft_tpu/ops/sha256.py: leaf_hashes, node_hashes, tree_levels,
// verify_proofs) as jnp graphs that XLA fuses.  The port's epoch needs the
// same work on the card (the RBC's Merkle trees and its N^2 proof checks,
// repeated once per receiver), and PyTorch's eager elementwise ops would cost
// some 2,000 launches per compression, so the plane gets its own kernels:
//
//   sha256_tagged_kernel  sha256(tag || m) for a batch of equal-length
//                         messages m: leaves (tag 0x00, any length) and
//                         node pairs (tag 0x01, left32 || right32);
//   sha256_proofs_kernel  the proof walk of crypto/merkle.Proof.validate:
//                         hash the leaf, then at depth d put the accumulator
//                         on the left when bit d of the index is 0, hash the
//                         pair, and compare the result with the root.
//
// What bounds them.  A compression is ~1,400 32-bit integer instructions
// (a rotate is one SHF, a three-word boolean one LOP3, a three-word sum one
// IADD3) on 64 bytes of message, so both kernels are bound by the integer
// pipe, not by memory.  One thread owns one message (one proof): the state
// and a rolling 16-word schedule live in registers, the 64 rounds are
// unrolled so every schedule index is static, K sits in __constant__ memory
// (every lane of a warp reads the same word in the same round: a
// broadcast), and a rotate is one funnel shift.  The proof walk keeps its
// accumulator in registers across the levels and builds each node block
// from words, so only the leaf and the siblings are read from memory.
// Blocks of 64 threads spread the epoch's 10,000 proofs over more SMs than
// 256-thread blocks would.
//
// The message is tag || data, so its big-endian words are not aligned to the
// data: the leaf path loads bytes and assembles words.  Padding (0x80, zeros,
// the 64-bit bit length) is computed per byte position, so every length is
// right, including the block-count steps between 54/55 and 118/119 data
// bytes.  Digests are written as bytes in big-endian order.

#include <cuda_runtime.h>
#include <stdint.h>

#define TPB 64

__constant__ uint32_t K256[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void init_state(uint32_t h[8]) {
  h[0] = 0x6A09E667u; h[1] = 0xBB67AE85u; h[2] = 0x3C6EF372u; h[3] = 0xA54FF53Au;
  h[4] = 0x510E527Fu; h[5] = 0x9B05688Cu; h[6] = 0x1F83D9ABu; h[7] = 0x5BE0CD19u;
}

// One compression of the block w[0..15] (big-endian words) into h.  The
// schedule rolls over w in place: round t >= 16 overwrites w[t & 15].
__device__ __forceinline__ void compress(uint32_t h[8], uint32_t w[16]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = hh + S1 + ch + K256[t] + w[t & 15];
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    hh = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + S0 + maj;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

// Byte p of the padded message tag || m[0..len) (total blocks nb).
__device__ __forceinline__ uint32_t msg_byte(const uint8_t* m, int len, uint32_t tag,
                                             int nb, int p) {
  if (p == 0) return tag;
  if (p <= len) return m[p - 1];
  if (p == len + 1) return 0x80u;
  const int q = p - (nb * 64 - 8);  // position in the 64-bit bit length
  if (q < 0) return 0u;
  const unsigned long long bits = 8ull * (unsigned long long)(len + 1);
  return (uint32_t)((bits >> (8 * (7 - q))) & 0xFFull);
}

// sha256(tag || m[0..len)) into h.
__device__ __forceinline__ void hash_tagged(const uint8_t* m, int len, uint32_t tag,
                                            uint32_t h[8]) {
  const int nb = (len + 1 + 9 + 63) / 64;
  init_state(h);
  for (int blk = 0; blk < nb; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int p = blk * 64 + 4 * j;
      w[j] = (msg_byte(m, len, tag, nb, p) << 24) | (msg_byte(m, len, tag, nb, p + 1) << 16) |
             (msg_byte(m, len, tag, nb, p + 2) << 8) | msg_byte(m, len, tag, nb, p + 3);
    }
    compress(h, w);
  }
}

// sha256(0x01 || L || R) for two digests given as big-endian state words:
// 65 bytes, two blocks.  The words of L || R shift right by the tag byte.
__device__ __forceinline__ void hash_node(const uint32_t L[8], const uint32_t R[8],
                                          uint32_t h[8]) {
  uint32_t a[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) { a[j] = L[j]; a[8 + j] = R[j]; }
  uint32_t w[16];
  w[0] = 0x01000000u | (a[0] >> 8);
#pragma unroll
  for (int j = 1; j < 16; ++j) w[j] = (a[j - 1] << 24) | (a[j] >> 8);
  init_state(h);
  compress(h, w);
  w[0] = (a[15] << 24) | 0x00800000u;
#pragma unroll
  for (int j = 1; j < 15; ++j) w[j] = 0u;
  w[15] = 65u * 8u;
  compress(h, w);
}

__device__ __forceinline__ void load_digest(const uint8_t* p, uint32_t out[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    out[j] = ((uint32_t)p[4 * j] << 24) | ((uint32_t)p[4 * j + 1] << 16) |
             ((uint32_t)p[4 * j + 2] << 8) | (uint32_t)p[4 * j + 3];
}

__global__ void __launch_bounds__(TPB)
sha256_tagged_kernel(const uint8_t* __restrict__ msgs, long long n, int len, uint32_t tag,
                     uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * TPB + threadIdx.x;
  if (i >= n) return;
  uint32_t h[8];
  hash_tagged(msgs + i * (long long)len, len, tag, h);
  uint8_t* o = out + i * 32;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[4 * j] = (uint8_t)(h[j] >> 24);
    o[4 * j + 1] = (uint8_t)(h[j] >> 16);
    o[4 * j + 2] = (uint8_t)(h[j] >> 8);
    o[4 * j + 3] = (uint8_t)h[j];
  }
}

__global__ void __launch_bounds__(TPB)
sha256_proofs_kernel(const uint8_t* __restrict__ leaves, int leaf_len,
                     const uint8_t* __restrict__ paths, int depth,
                     const int* __restrict__ indices, const uint8_t* __restrict__ roots,
                     long long n, uint8_t* __restrict__ ok) {
  const long long i = (long long)blockIdx.x * TPB + threadIdx.x;
  if (i >= n) return;
  uint32_t acc[8], sib[8], nxt[8];
  hash_tagged(leaves + i * (long long)leaf_len, leaf_len, 0u, acc);
  const int idx = indices[i];
  const uint8_t* path = paths + i * (long long)depth * 32;
  for (int d = 0; d < depth; ++d) {
    load_digest(path + 32 * d, sib);
    if (((idx >> d) & 1) == 0) {
      hash_node(acc, sib, nxt);
    } else {
      hash_node(sib, acc, nxt);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = nxt[j];
  }
  uint32_t root[8];
  load_digest(roots + i * 32, root);
  uint32_t diff = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) diff |= acc[j] ^ root[j];
  ok[i] = diff == 0u ? 1 : 0;
}

extern "C" {

// Each returns cudaGetLastError() after its launch (0 = launched).
int sha256_tagged(const uint8_t* msgs, long long n, int len, int tag, uint8_t* out,
                  void* stream) {
  if (n <= 0) return 0;
  unsigned grid = (unsigned)((n + TPB - 1) / TPB);
  sha256_tagged_kernel<<<grid, TPB, 0, (cudaStream_t)stream>>>(msgs, n, len, (uint32_t)tag,
                                                                out);
  return (int)cudaGetLastError();
}

int sha256_proofs(const uint8_t* leaves, int leaf_len, const uint8_t* paths, int depth,
                  const int* indices, const uint8_t* roots, long long n, uint8_t* ok,
                  void* stream) {
  if (n <= 0) return 0;
  unsigned grid = (unsigned)((n + TPB - 1) / TPB);
  sha256_proofs_kernel<<<grid, TPB, 0, (cudaStream_t)stream>>>(leaves, leaf_len, paths, depth,
                                                                indices, roots, n, ok);
  return (int)cudaGetLastError();
}

const char* sha256_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
