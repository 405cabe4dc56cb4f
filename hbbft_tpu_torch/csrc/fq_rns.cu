// Full-RNS Montgomery multiply, fixed-exponent power and product chain for
// BLS12-381 Fq, written by hand for Hopper (sm_90a), all three on the one
// warp-wide body `mul_warp` of csrc/fq_rns_core.cuh.
//
// Replaces the JAX package's Pallas TPU kernels in hbbft_tpu/ops/fq_rns_pallas.py:
//   fq_rns_mul_kernel  <- _mul_kernel (body _mul_core), pallas_call at :295
//   fq_rns_pow_kernel  <- _pow_kernel, pallas_call at :339
//   fq_rns_chain_kernel <- _chain_kernel, pallas_call at :312 (the kernel
//                          bench's n chained products x <- x*b per launch)
// and computes the same float32 values bit for bit (checked against the plain
// PyTorch version in hbbft_tpu_torch/ops/fq_rns_cuda.py).
//
// Data layout.  Operands are the port's public (n, 79) float32 residue rows,
// [B1 (39) | B2 (39) | m_r], every value an exact integer below 2^24.
//
// fq_rns_mul.  What bounds it on the H100: one product moves 3 x 316 bytes
// (two rows in, one out) and needs 25,600 tensor-core flops for its two
// base extensions plus ~4.9k float32 operations of reductions
// (chip_smoke.MUL_EW_OPS), so at the card's peak rates it is bound by its
// bytes (~0.28 ns a lane at 3.35 TB/s against ~0.10 ns of operations).
// The first design (one lane per thread, a transposed 79 x 129 tile per
// operand, 9,360 float32 FMAs a lane) ran at ~10x that bound, on 8 warps
// per SM.  This one:
//  * each warp computes 16 lanes at once with the warp-wide tensor-core body
//    `mul_warp` (csrc/fq_rns_core.cuh): the extensions are int8 mma.sync
//    products, exact by construction, and the floors and int <-> float
//    conversions of the reductions run as float32 adds, not on the
//    conversion unit;
//  * operand rows are read row by row across the warp (lane = residue:
//    coalesced 128-byte segments), eight rows' loads in flight per lane,
//    and the pointwise product a*b is taken while staging, so one 5 KB
//    tile per warp holds the whole pipeline in place (no transposed tile,
//    no second operand tile).  Why 4-byte loads and not a 16-byte or TMA
//    copy of the block's contiguous slab: a copy into shared memory needs
//    a second tile for b (fewer warps per SM), and 16-byte loads into
//    registers put a lane's elements on changing residues, so every
//    element fetches its constants from shared memory instead of holding
//    them in registers.  Measured on the H100 (PERF.md): a variant that
//    staged each whole group of 16 rows with 16-byte loads (ten a lane
//    per operand) ran 4-7% slower (0.129 against 0.121-0.123 ms at
//    191,251 lanes; ptxas: 24 bytes of spills) -- the pass waits on its
//    latency, not on the count of load instructions;
//  * a one-row operand (a (79,) or (1, 79) row against n rows) is read
//    with lane stride 0, straight from L2, instead of being expanded;
//  * a block is 4 warps with 12.3 KB of constants (the float vectors and
//    the int8 planes in fragment order) plus 4 x 5,056 B of tiles:
//    32,528 B, so 6 blocks (24 warps) fit on an SM within its 227 KB, and
//    __launch_bounds__(128, 6) holds the registers to 85 (ptxas: 80, no
//    spills);
//  * the grid is persistent (at most the blocks that fit at once, from the
//    occupancy query), each warp walking lane groups with a grid stride,
//    so the constants are copied once per resident block rather than once
//    per 64 lanes; the 24 warps of an SM overlap one another's loads and
//    tensor-core work, so there is no explicit copy pipeline.
// What still bounds it is the latency of one warp's pass (staging, the two
// extensions' epilogues, the store), which the SM's warps do not fully
// hide: ~2.2x the byte bound at the epoch's mean width (PERF.md).  That is
// why a pass takes 16 lanes and not 32: with half the tile, 24 warps share
// an SM instead of 16, and the card measured 12% faster.
//
// fq_rns_pow runs the same warp body.  It is a chain: 608 dependent
// products per lane for the Fermat inverse Q-2 (380 squares, 228 set-bit
// multiplies), at widths from 1 to ~4k lanes, so what bounds it is the
// latency of one warp pass, 608 times over, not bytes or operations.  Each
// warp owns one group of WARP_M = 16 lanes for the whole chain: it writes
// the renormalized base loose(x) once to a per-launch scratch row set and
// the accumulator to `out`'s rows, then issues every product of the bit
// schedule through one call of `mul_warp` on those rows (the rows a warp
// writes it alone reads back, residue r always by lane r % 32, so program
// order orders the round trip through L2; a variant that kept both row
// sets in shared memory measured no faster on the H100: PERF.md).  Blocks
// hold 1, 2 or 4 warps, the fewest whose grid fits on the card's SMs at
// once (the wrapper picks it: ops/fq_rns_cuda.py group_warps_per_block), so
// a narrow launch spreads its warps over the SMs instead of sharing one
// SM's shared-memory pipe.  A pass alone takes ~5.7 us (one warp, one
// lane: PERF.md), the latency of its dependent steps.
//
// fq_rns_chain runs the power's design: n chained products x <- x*b per
// lane (the kernel bench's ceiling probe: both operands renormalized once,
// then every product `reduced`).  Each warp owns one group of WARP_M = 16
// lanes for the whole chain, writes loose(b) once to a per-launch scratch
// and loose(a) to `out`, and calls `mul_warp` n times on those rows (out
// is the accumulator).  The chain moves no device-memory bytes per product
// beyond the rows' round trip through L2, so at the bench's widths (4k to
// 256k lanes) it is bound like fq_rns_mul without the HBM traffic: by the
// latency of the warp passes the SM's warps overlap.  Blocks hold 1, 2 or
// 4 warps, the fewest whose grid fits the blocks the card holds at once
// (the occupancy query's blocks per SM x SMs; ops/fq_rns_cuda.py
// group_warps_per_block: the one sizing policy, fit_per_block, of every
// warp-body kernel), and __launch_bounds__(128, 6) lets 24 warps share an
// SM, as fq_rns_mul's do (ptxas: 78 registers, no spills).  Measured on an
// NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md), per launch of 200 products
// back to back: 6.41-6.45 ms at 87,040 lanes and 1.34 ms at 4,096 (the
// first design, a thread a lane on the float32 pipe: 20.15 and 6.05); 2.8 G
// products/s at 262,144 lanes, against fq_rns_mul's 1.69 as separate
// launches.  Two variants measured slower in the same runs and were not
// kept: the group's acc and b rows in shared memory (3 blocks an SM: 6.92
// ms at 87,040 lanes) and 4 blocks an SM (84 registers: 6.68 ms); at
// 4,096 lanes all three were within 1%.
//
// Exactness: see csrc/fq_rns_core.cuh.  Compile without --use_fast_math.

#include "fq_rns_core.cuh"

#define MUL_WARPS 4
#define MUL_TPB (32 * MUL_WARPS)
#define MUL_SMEM (TC_SMEM_BYTES + MUL_WARPS * WARP_TILE * 4)

// Lane l reads row l*sa of a and l*sb of b (sa, sb: 79, or 0 for a one-row
// operand) and writes row l of out.
__global__ void __launch_bounds__(MUL_TPB, 6)
fq_rns_mul_kernel(const float* __restrict__ a, int sa, const float* __restrict__ b, int sb,
                  float* __restrict__ out, int n, int reduced, const float* __restrict__ kc,
                  const int* __restrict__ kt) {
  extern __shared__ __align__(16) float smem[];
  load_tc_consts(smem, kc, kt);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* T = smem + NV + TC_WORDS + warp * WARP_TILE;
  const long groups = ((long)n + WARP_M - 1) / WARP_M;
  for (long gi = (long)blockIdx.x * MUL_WARPS + warp; gi < groups;
       gi += (long)gridDim.x * MUL_WARPS) {
    const long l = gi * WARP_M + min(lane, WARP_M - 1);
    const bool valid = lane < WARP_M && l < n;
    const long lr = valid ? l : (long)n - 1;  // padding lanes re-read the last row
    mul_warp(T, smem, a + lr * sa, b + lr * sb, out + lr * NL, valid, reduced != 0, lane);
  }
}

// fq_rns_pow and fq_rns_chain: 1, 2 or 4 warps a block, one lane group each.
#define GROUP_MAX_WARPS 4
#define GROUP_SMEM (TC_SMEM_BYTES + GROUP_MAX_WARPS * WARP_TILE * 4)

// dst <- loose(src) for one row, residue r by lane r % 32: the lane that
// reads it back in mul_warp's staging, so program order orders the round
// trip.  S: the shared constants.
__device__ __forceinline__ void loose_row(float* dst, const float* src, const float* S,
                                          int lane) {
#pragma unroll
  for (int rr = 0; rr < 3; ++rr) {
    const int r = lane + 32 * rr;
    if (r < NL) dst[r] = loose_w(src[r], S[OFF_P + r], S[OFF_IP + r]);
  }
}

// Warp w of block b owns lanes [16g, 16g + 16) for g = b*warps + w; base
// is a (n, 79) scratch the kernel fills with loose(x).
__global__ void __launch_bounds__(32 * GROUP_MAX_WARPS, 4)
fq_rns_pow_kernel(const float* __restrict__ x, const int* __restrict__ bits, int nbits,
                  float* __restrict__ out, float* __restrict__ base, int n,
                  const float* __restrict__ kc, const int* __restrict__ kt) {
  extern __shared__ __align__(16) float smem[];
  load_tc_consts(smem, kc, kt);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long l0 = ((long)blockIdx.x * (blockDim.x >> 5) + warp) * WARP_M;
  if (l0 >= n) return;  // warp-uniform; no barrier follows
  float* T = smem + NV + TC_WORDS + warp * WARP_TILE;
  const int cnt = (int)min((long)WARP_M, (long)n - l0);

  // base = acc = loose(x)
#pragma unroll 1
  for (int m = 0; m < cnt; ++m) {
    const long row = (l0 + m) * NL;
    loose_row(base + row, x + row, smem, lane);
    loose_row(out + row, x + row, smem, lane);
  }

  // MSB implicit: the accumulator starts at the base.  Then, for each
  // later bit, a square and, on a set bit, a multiply by the base: one
  // call site walks that schedule (the bits are warp-uniform).  Padding
  // lanes re-read the group's last row and store nothing.
  const bool valid = lane < cnt;
  const long lr = (l0 + (valid ? lane : cnt - 1)) * NL;
  float* acc = out + lr;
  const float* bs = base + lr;
  int i = 1;
  bool square = true;
#pragma unroll 1
  while (i < nbits) {
    mul_warp(T, smem, acc, square ? acc : bs, acc, valid, true, lane);
    if (square && __ldg(bits + i)) {
      square = false;
    } else {
      square = true;
      ++i;
    }
  }
}

// Warp w of block b owns lanes [16g, 16g + 16) for g = b*warps + w, as in
// fq_rns_pow_kernel; bs is a (n, 79) scratch the kernel fills with loose(b).
__global__ void __launch_bounds__(32 * GROUP_MAX_WARPS, 6)
fq_rns_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, float* __restrict__ bs, int n, int nmul,
                    const float* __restrict__ kc, const int* __restrict__ kt) {
  extern __shared__ __align__(16) float smem[];
  load_tc_consts(smem, kc, kt);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long l0 = ((long)blockIdx.x * (blockDim.x >> 5) + warp) * WARP_M;
  if (l0 >= n) return;  // warp-uniform; no barrier follows
  float* T = smem + NV + TC_WORDS + warp * WARP_TILE;
  const int cnt = (int)min((long)WARP_M, (long)n - l0);

  // acc = loose(a) in out, loose(b) in bs
#pragma unroll 1
  for (int m = 0; m < cnt; ++m) {
    const long row = (l0 + m) * NL;
    loose_row(out + row, a + row, smem, lane);
    loose_row(bs + row, b + row, smem, lane);
  }

  // nmul products acc <- acc * b in place; padding lanes re-read the
  // group's last row and store nothing.
  const bool valid = lane < cnt;
  const long lr = (l0 + (valid ? lane : cnt - 1)) * NL;
  float* acc = out + lr;
#pragma unroll 1
  for (int i = 0; i < nmul; ++i) mul_warp(T, smem, acc, bs + lr, acc, valid, true, lane);
}

// Launch set-up, once per process and device (launch_setup).
static LaunchSetup g_mul[MAX_DEVICES], g_pow[MAX_DEVICES], g_chain[MAX_DEVICES];

static const LaunchSetup& mul_setup() {
  return launch_setup(g_mul, fq_rns_mul_kernel, MUL_TPB, MUL_SMEM);
}

static const LaunchSetup& pow_setup() {
  return launch_setup(g_pow, fq_rns_pow_kernel, 32 * GROUP_MAX_WARPS, GROUP_SMEM);
}

static const LaunchSetup& chain_setup() {
  return launch_setup(g_chain, fq_rns_chain_kernel, 32 * GROUP_MAX_WARPS, GROUP_SMEM);
}

extern "C" {

int fq_rns_const_floats(void) { return N_CONSTS; }
int fq_rns_tc_bytes(void) { return TC_BYTES; }

// Blocks of fq_rns_mul_kernel resident on one SM (the occupancy the
// launch gets), or a negative CUDA error code.
int fq_rns_mul_blocks_per_sm(void) {
  const LaunchSetup& s = mul_setup();
  return s.rc ? -s.rc : s.per_sm;
}

// The same for fq_rns_pow_kernel at its widest block (4 warps).
int fq_rns_pow_blocks_per_sm(void) {
  const LaunchSetup& s = pow_setup();
  return s.rc ? -s.rc : s.per_sm;
}

// The same for fq_rns_chain_kernel at its widest block (4 warps).
int fq_rns_chain_blocks_per_sm(void) {
  const LaunchSetup& s = chain_setup();
  return s.rc ? -s.rc : s.per_sm;
}

// Each launcher returns cudaGetLastError() after its launch (0 = launched).
int fq_rns_mul(const float* a, int sa, const float* b, int sb, float* out, int n, int reduced,
               const float* kc, const int* kt, void* stream) {
  if (n <= 0) return 0;
  const LaunchSetup& s = mul_setup();
  if (s.rc) return s.rc;
  const long want = ((long)n + MUL_WARPS * WARP_M - 1) / (MUL_WARPS * WARP_M);
  const unsigned grid = (unsigned)(want < s.blocks ? want : s.blocks);
  fq_rns_mul_kernel<<<grid, MUL_TPB, MUL_SMEM, (cudaStream_t)stream>>>(a, sa, b, sb, out, n,
                                                                       reduced, kc, kt);
  return (int)cudaGetLastError();
}

// warps: warps per block (1, 2 or 4), one 16-lane group each.
int fq_rns_pow(const float* x, const int* bits, int nbits, float* out, float* base, int n,
               int warps, const float* kc, const int* kt, void* stream) {
  if (n <= 0) return 0;
  if (warps < 1 || warps > GROUP_MAX_WARPS) return (int)cudaErrorInvalidValue;
  const int rc = pow_setup().rc;
  if (rc) return rc;
  const long groups = ((long)n + WARP_M - 1) / WARP_M;
  const unsigned grid = (unsigned)((groups + warps - 1) / warps);
  const int smem = TC_SMEM_BYTES + warps * WARP_TILE * 4;
  fq_rns_pow_kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(x, bits, nbits, out,
                                                                     base, n, kc, kt);
  return (int)cudaGetLastError();
}

// warps: warps per block (1, 2 or 4), one 16-lane group each; bs: a (n, 79)
// scratch.
int fq_rns_chain(const float* a, const float* b, float* out, float* bs, int n, int nmul,
                 int warps, const float* kc, const int* kt, void* stream) {
  if (n <= 0) return 0;
  if (warps < 1 || warps > GROUP_MAX_WARPS) return (int)cudaErrorInvalidValue;
  const int rc = chain_setup().rc;
  if (rc) return rc;
  const long groups = ((long)n + WARP_M - 1) / WARP_M;
  const unsigned grid = (unsigned)((groups + warps - 1) / warps);
  const int smem = TC_SMEM_BYTES + warps * WARP_TILE * 4;
  fq_rns_chain_kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(a, b, out, bs, n, nmul,
                                                                       kc, kt);
  return (int)cudaGetLastError();
}

const char* fq_rns_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
