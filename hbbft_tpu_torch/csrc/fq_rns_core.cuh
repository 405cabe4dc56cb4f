// The RNS Montgomery body on the card: the constant layout and the
// warp-wide tensor-core body `mul_warp`, shared by csrc/fq_rns.cu (the
// multiply, power and chain kernels) and csrc/tower_fused.cu (the fused
// tower kernels).  Every Fq product of every RNS kernel runs here.  The
// kernels are sized by one policy (ops/fq_rns_cuda.py fit_per_block): the
// fewest warps or lanes a block whose grid fits at once, against the
// blocks the card holds (the kernel's occupancy query: fq_rns_chain and
// the tower kernels) or its SMs (fq_rns_pow, which spreads a narrow launch
// an SM a block); fq_rns_mul runs a persistent grid of the blocks the card
// holds.  Measured on an
// NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md): one warp's pass alone takes
// ~5.7 us (fq_rns_pow at 1 lane); the passes of 24 warps an SM overlap to
// 2.8 G products/s (fq_rns_chain at 262,144 lanes).
//
// It is a port of `_mul_core` in hbbft_tpu/ops/fq_rns_pallas.py and
// computes the same float32 values bit for bit.
//
// Exactness.  Every intermediate is an integer below 2^24 in magnitude (the
// bounds are derived in hbbft_tpu/ops/fq_rns.py and fq_rns_pallas.py):
//  * lane products |a*b| < 4p^2 < 2^24 for operands in (-p, 2p);
//  * the extensions' plane partial sums are below 39*63*63*2 < 2^19 (see
//    below), exact in any summation order; the first extension's result
//    is the canonical residue, equal to the TPU kernel's;
//  * second extension: the TPU kernel's three partial sums (ll, lh+hl, hh)
//    are kept separately because its LOOSE reductions make the result depend
//    on them;
//  * floor(x * invp) uses invp = 1/p rounded to float32 on the host exactly
//    as the TPU kernel's constants, and the product is rounded on its own
//    (__fmul_rn), never fused into a neighbouring add.
// Compile without --use_fast_math.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NB 39          // primes per RNS base
#define NL 79          // residues per element: B1 | B2 | m_r
#define NE 40          // extension outputs: B2 + m_r (first), B1 + m_r (second)

// Offsets (in floats) into the packed constant buffer built by
// hbbft_tpu_torch/ops/fq_rns_cuda.py (_pack_kernel_consts); both sides
// check the total length at load.  The extension matrices are not in it:
// the body reads them as int8 planes (load_tc_consts).
#define OFF_P 0                         // [NL] moduli
#define OFF_IP (OFF_P + NL)             // [NL] float32 1/p
#define OFF_XOFF (OFF_IP + NL)          // [NL] sign offset residues
#define OFF_SIGC (OFF_XOFF + NL)        // [NB] fused sigma constants (B1)
#define OFF_M1INV (OFF_SIGC + NB)       // [NE] M1^-1 over B2 + m_r
#define OFF_QM1INV (OFF_M1INV + NE)     // [NE] Q*M1^-1 over B2 + m_r
#define OFF_W2INV (OFF_QM1INV + NE)     // [NB] (M2/p_j)^-1 over B2
#define OFF_PB1R (OFF_W2INV + NB)       // [NE] moduli B1 + m_r
#define OFF_IPB1R (OFF_PB1R + NE)       // [NE] float32 1/p over B1 + m_r
#define OFF_M2B1 (OFF_IPB1R + NE)       // [NB] M2 mod p_i over B1
#define OFF_M2INVR (OFF_M2B1 + NB)      // [1] M2^-1 mod m_r
#define N_CONSTS (OFF_M2INVR + 2)       // padded to an even count

// ---------------------------------------------------------------------------
// The warp-wide Montgomery body on the tensor cores (`mul_warp`): the one
// body of fq_rns_mul, fq_rns_pow and fq_rns_chain (csrc/fq_rns.cu) and of
// tower_op, miller_dbl and hard_exp (csrc/tower_fused.cu).
//
// One warp computes WARP_M = 16 independent products at once.  Lanes
// 0..15 each name the rows of one task (a, b, out: 79 contiguous floats
// each); the warp walks them row by row, lane = residue, so every operand
// read and result write is a coalesced 128-byte segment of one row.  The
// extensions run as int8 tensor-core products (mma.sync m16n8k32, s8 x s8
// -> s32): M = the 16 tasks (one m-tile), N = the 40 outputs (five
// n-tiles), K = the 39 input residues padded to 64 (two k-steps).  Why 16
// and not 32 tasks: the pass is bound by its latency, not by issue; half
// the tile (5 KB) lets 24 warps instead of 16 share an SM, and each pass
// is about half as long (measured on the H100: PERF.md).  The operand (sigma, then xi)
// is split into its 6-bit lo and 5-bit hi planes, the constant matrix as
// the TPU kernel splits it (E = E_lo + 64 E_hi), and the three partials
// the reference keeps apart come out of four plane products:
//   ll = lo.E_lo,  mid = hi.E_lo + lo.E_hi,  hh = hi.E_hi.
// Every plane value lies in [0, 63] (an exact int8) and every partial sum
// is below 39*63*63*2 < 2^19, so the s32 accumulators hold the very
// integers the float32 sums of the plain version (and the TPU kernel's
// plane products) hold: bit-equal by construction, in any summation
// order.  The recombination after each product is the plain version's
// float arithmetic, entry by entry, in
// the accumulator (C-fragment) layout, where each thread knows its
// output columns j; the first extension's result is canonical, the
// second's is loose exactly as the reference's (partials kept apart).
//
// Per-warp shared tile T: WARP_M rows of 79 words, one per task, reused in
// place through the stages:
//   staging   words 39..78 <- x (B2 | m_r);  bytes 0..63 <- lo(sigma),
//             bytes 64..127 <- hi(sigma) (K padding 39..63 zero);
//   ext. 1    words 39..78 <- r2r = loose(x*M1^-1 + q-hat*(Q*M1^-1)),
//             bytes 0..38 / 64..102 <- lo/hi of xi (padding stays zero);
//   ext. 2    words 0..38 <- r1;
// then the row [r1 | r2r] is the product.  An extension's epilogue writes
// into an m-tile's rows only once every lane holds that m-tile's A
// fragments in registers (a __syncwarp after load_afrag).  A-fragment
// reads across a row stride of 79 words meet at most 2-way bank
// conflicts; column reads are conflict-free (79 is odd).
// ---------------------------------------------------------------------------

#define NV N_CONSTS                          // the float vectors: the packed buffer (516)
#define TC_NT 5                              // n-tiles of 8 outputs (NE = 40)
#define TC_KS 2                              // k-steps of 32 (NB = 39 padded to 64)
#define TC_WORDS (2 * 2 * TC_NT * TC_KS * 2 * 32)  // ext x plane x nt x ks x reg x lane
#define TC_BYTES (TC_WORDS * 4)              // 10,240: the int8 planes
#define TC_SMEM_BYTES ((NV + TC_WORDS) * 4)  // 12,304: vectors + planes
#define WARP_M 16                            // tasks of one warp pass (one m-tile)
#define WARP_TILE (WARP_M * NL)              // floats of one warp's tile (5,056 B)
#define STAGE_ROWS 8                         // rows whose loads a lane keeps in flight

// Copy the float vectors of the packed buffer and the int8 planes (in
// mma.sync B-fragment order, packed by ops/fq_rns_cuda.py _pack_tc_planes)
// into shared memory S (16-byte aligned), block-cooperatively.
__device__ __forceinline__ void load_tc_consts(float* S, const float* kc, const int* kt) {
  static_assert(NV % 4 == 0, "the vectors are copied as float4");
  const float4* v = reinterpret_cast<const float4*>(kc);
  float4* sv = reinterpret_cast<float4*>(S);
  for (int k = threadIdx.x; k < NV / 4; k += blockDim.x) sv[k] = v[k];
  const int4* p = reinterpret_cast<const int4*>(kt);
  int4* sp = reinterpret_cast<int4*>(S + NV);
  for (int k = threadIdx.x; k < TC_WORDS / 4; k += blockDim.x) sp[k] = p[k];
}

// D += A.B for one m16n8k32 tile: A 16x32 int8 (row), B 32x8 int8 (col).
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments (lo and hi planes, both k-steps) of m-tile mt.  Thread
// (g = lane/4, t = lane%4) holds rows g and g+8, bytes 4t..4t+3 and
// 16+4t..16+4t+3 of each 32-byte k-step.
struct AFrag {
  unsigned lo[TC_KS][4], hi[TC_KS][4];
};

__device__ __forceinline__ void load_afrag(AFrag& f, const float* T, int mt, int lane) {
  const unsigned* r0 = reinterpret_cast<const unsigned*>(T) + (mt * 16 + (lane >> 2)) * NL;
  const unsigned* r1 = r0 + 8 * NL;
  const int t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < TC_KS; ++ks) {
    const int w = ks * 8 + t;
    f.lo[ks][0] = r0[w];
    f.lo[ks][1] = r1[w];
    f.lo[ks][2] = r0[w + 4];
    f.lo[ks][3] = r1[w + 4];
    f.hi[ks][0] = r0[w + 16];
    f.hi[ks][1] = r1[w + 16];
    f.hi[ks][2] = r0[w + 20];
    f.hi[ks][3] = r1[w + 20];
  }
}

// The three plane partials of n-tile nt: ll, mid and hh in C-fragment
// layout (entry c: row g + 8*(c/2), column nt*8 + 2t + c%2).  PW: this
// extension's plane words, [plane][nt][ks][reg][lane].
__device__ __forceinline__ void ext_tile(const AFrag& f, const unsigned* PW, int nt, int lane,
                                         int (&ll)[4], int (&mid)[4], int (&hh)[4]) {
  int mid2[4];  // lo.E_hi apart from hi.E_lo: two short accumulator chains
#pragma unroll
  for (int c = 0; c < 4; ++c) ll[c] = mid[c] = mid2[c] = hh[c] = 0;
#pragma unroll
  for (int ks = 0; ks < TC_KS; ++ks) {
    const unsigned* lo = PW + ((0 * TC_NT + nt) * TC_KS + ks) * 64 + lane;
    const unsigned* hi = PW + ((1 * TC_NT + nt) * TC_KS + ks) * 64 + lane;
    const unsigned lo0 = lo[0], lo1 = lo[32], hi0 = hi[0], hi1 = hi[32];
    mma_s8(ll, f.lo[ks], lo0, lo1);
    mma_s8(mid, f.hi[ks], lo0, lo1);
    mma_s8(mid2, f.lo[ks], hi0, hi1);
    mma_s8(hh, f.hi[ks], hi0, hi1);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) mid[c] += mid2[c];
}

// Integer steps of the warp body on the float32 pipe.  floorf and the
// int <-> float conversions issue on the conversion unit, at a fraction of
// the float32 rate, and the body needs ~950 of them a lane; with |y| < 2^22
// (every value here: |x*(1/p)| < 2^16, the partials < 2^19, residues
// < 2^11) adding 1.5*2^23 puts y where the float32 spacing is 1, so
//   floor(y) = (y + 1.5*2^23, rounded down) - 1.5*2^23
// and the integer v is the low mantissa bits of v + 1.5*2^23: float32 adds
// with the same results bit for bit.
#define MAGIC_F 12582912.f  // 1.5 * 2^23
#define MAGIC_I 0x4B400000  // its bit pattern

__device__ __forceinline__ float floor_w(float y) { return __fadd_rd(y, MAGIC_F) - MAGIC_F; }
__device__ __forceinline__ float i2f_w(int v) { return __int_as_float(MAGIC_I + v) - MAGIC_F; }
__device__ __forceinline__ int f2i_w(float v) { return __float_as_int(v + MAGIC_F) - MAGIC_I; }

// The plain version's reductions with floor_w: loose_w, one pass to
// (-p, 2p) (floor(..)*p is an exact integer), and lanes_w, exact to [0, p).
__device__ __forceinline__ float loose_w(float x, float p, float ip) {
  return x - floor_w(__fmul_rn(x, ip)) * p;
}

__device__ __forceinline__ float lanes_w(float x, float p, float ip) {
  x = x - floor_w(__fmul_rn(x, ip)) * p;
  x = x - p * (float)(x >= p);
  x = x + p * (float)(x < 0.f);
  return x;
}

// The reference's recombination of the partials (_split_dot):
// ll + 64*loose(mid) + 4096*canonical(hh); every term an exact integer.
__device__ __forceinline__ float recombine(int ll, int mid, int hh, float p, float ip) {
  return i2f_w(ll) + 64.f * loose_w(i2f_w(mid), p, ip) + 4096.f * lanes_w(i2f_w(hh), p, ip);
}

__device__ __forceinline__ void put_planes(unsigned char* row, int k, float v) {
  const int iv = f2i_w(v);  // canonical residue, an exact integer below 2^11
  row[k] = (unsigned char)(iv & 63);
  row[64 + k] = (unsigned char)(iv >> 6);
}

// The warp-wide Montgomery product.  Every lane of the warp calls it
// together; for lane l < WARP_M the task is out <- a*b*M1^-1 on the rows
// at a, b and out (79 floats each; a and b may be the same row, or rows
// shared with other lanes); with valid = false the lane's rows are read
// but nothing is written (the caller pads a partial group with such a
// task; the arguments of lanes >= WARP_M are not read).  out must not be
// an input row of another lane of this call.  S: the shared
// constants of load_tc_consts; T: this warp's tile (WARP_TILE floats).
__device__ __forceinline__ void mul_warp(float* T, const float* S, const float* a,
                                         const float* b, float* out, bool valid,
                                         bool reduced, int lane) {
  const unsigned FULL = 0xffffffffu;
  const unsigned* PW = reinterpret_cast<const unsigned*>(S + NV);
  __syncwarp();  // the tile's previous use is over

  // Staging: x = loose(a*b) + offset for residue r = lane + 32*rr; sigma
  // (B1) straight into its planes, x (B2 | m_r) into its words.  The rows
  // go STAGE_ROWS at a time, every load of a batch issued before any is
  // used, so a warp waits on device memory WARP_M/STAGE_ROWS times.
  float pr[3], ipr[3], xo[3], sc[2];
#pragma unroll
  for (int rr = 0; rr < 3; ++rr) {
    const int r = min(lane + 32 * rr, NL - 1);
    pr[rr] = S[OFF_P + r];
    ipr[rr] = S[OFF_IP + r];
    xo[rr] = S[OFF_XOFF + r];
    if (rr < 2) sc[rr] = S[OFF_SIGC + min(r, NB - 1)];
  }
#pragma unroll 1
  for (int m0 = 0; m0 < WARP_M; m0 += STAGE_ROWS) {
    float va[STAGE_ROWS][3], vb[STAGE_ROWS][3];
#pragma unroll
    for (int q = 0; q < STAGE_ROWS; ++q) {
      const float* ra = reinterpret_cast<const float*>(
          __shfl_sync(FULL, reinterpret_cast<unsigned long long>(a), m0 + q));
      const float* rb = reinterpret_cast<const float*>(
          __shfl_sync(FULL, reinterpret_cast<unsigned long long>(b), m0 + q));
#pragma unroll
      for (int rr = 0; rr < 3; ++rr) {
        const int r = lane + 32 * rr;
        va[q][rr] = r < NL ? __ldcg(ra + r) : 0.f;
        vb[q][rr] = r < NL ? __ldcg(rb + r) : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < STAGE_ROWS; ++q) {
      float* row = T + (m0 + q) * NL;
      unsigned char* bytes = reinterpret_cast<unsigned char*>(row);
#pragma unroll
      for (int rr = 0; rr < 3; ++rr) {
        const int r = lane + 32 * rr;
        if (r >= NL) continue;
        float av = va[q][rr], bv = vb[q][rr];
        if (!reduced) {
          av = loose_w(av, pr[rr], ipr[rr]);
          bv = loose_w(bv, pr[rr], ipr[rr]);
        }
        const float x = loose_w(av * bv, pr[rr], ipr[rr]) + xo[rr];
        if (r < NB) {
          put_planes(bytes, r, lanes_w(x * sc[rr], pr[rr], ipr[rr]));
        } else {
          row[r] = x;
          if (r < 64) {
            bytes[r] = 0;
            bytes[64 + r] = 0;
          }
        }
      }
    }
  }
  __syncwarp();

  const int g = lane >> 2, t = lane & 3;

  // Extension 1 (B1 -> B2 + m_r): canonical q-hat, then in place
  // r2r = loose(x*M1^-1 + q-hat*(Q*M1^-1)), and xi = r2r*(M2/p_j)^-1 over
  // B2 into the planes: once every lane holds an m-tile's fragments, its
  // rows' sigma planes are spent.
#pragma unroll 1
  for (int mt = 0; mt < WARP_M / 16; ++mt) {
    AFrag f;
    load_afrag(f, T, mt, lane);
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < TC_NT; ++nt) {
      int ll[4], mid[4], hh[4];
      ext_tile(f, PW, nt, lane, ll, mid, hh);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = nt * 8 + 2 * t + i;
        const float pj = S[OFF_P + NB + j], ipj = S[OFF_IP + NB + j];
        const float m1 = S[OFF_M1INV + j], qm1 = S[OFF_QM1INV + j];
        const float w2 = S[OFF_W2INV + min(j, NB - 1)];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 2 * h + i;
          const float qh = lanes_w(recombine(ll[c], mid[c], hh[c], pj, ipj), pj, ipj);
          float* row = T + (mt * 16 + g + 8 * h) * NL;
          const float r2r = loose_w(row[NB + j] * m1 + qh * qm1, pj, ipj);
          row[NB + j] = r2r;
          if (j < NB)
            put_planes(reinterpret_cast<unsigned char*>(row), j, lanes_w(r2r * w2, pj, ipj));
        }
      }
    }
  }
  __syncwarp();

  // Extension 2 (B2 -> B1 + m_r) with the reference's partials and loose
  // result, then r1 = loose(raw - delta*M2) in place.  The Shenoy-Kumaresan
  // delta of each row comes from its m_r column (j = 39: n-tile 4, thread
  // t = 3, entry i = 1), so n-tile 4 goes first.
  const unsigned* PW2 = PW + 2 * TC_NT * TC_KS * 64;
#pragma unroll 1
  for (int mt = 0; mt < WARP_M / 16; ++mt) {
    AFrag f;
    load_afrag(f, T, mt, lane);
    __syncwarp();  // the m-tile's xi planes are in every lane: its rows take r1
    float delta[2];
#pragma unroll
    for (int k = 0; k < TC_NT; ++k) {
      const int nt = (k + TC_NT - 1) % TC_NT;  // 4, 0, 1, 2, 3
      int ll[4], mid[4], hh[4];
      ext_tile(f, PW2, nt, lane, ll, mid, hh);
      float raw[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = nt * 8 + 2 * t + (c & 1);
        const float pj = S[OFF_PB1R + j], ipj = S[OFF_IPB1R + j];
        raw[c] = loose_w(recombine(ll[c], mid[c], hh[c], pj, ipj), pj, ipj);
      }
      if (k == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float r_mr = T[(mt * 16 + g + 8 * h) * NL + NL - 1];
          const float d = lanes_w((raw[2 * h + 1] - r_mr) * S[OFF_M2INVR], 256.f,
                                  1.f / 256.f);
          delta[h] = __shfl_sync(FULL, d, (lane & ~3) | 3);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = nt * 8 + 2 * t + (c & 1);
        if (j < NB) {
          T[(mt * 16 + g + 8 * (c >> 1)) * NL + j] =
              loose_w(raw[c] - delta[c >> 1] * S[OFF_M2B1 + j], S[OFF_P + j],
                      S[OFF_IP + j]);
        }
      }
    }
  }
  __syncwarp();

  // The products [r1 | r2r], row by row.
#pragma unroll 4
  for (int m = 0; m < WARP_M; ++m) {
    float* ro = reinterpret_cast<float*>(
        __shfl_sync(FULL, reinterpret_cast<unsigned long long>(out), m));
    const bool ok = __shfl_sync(FULL, valid, m);
    if (ok) {
      const float* row = T + m * NL;
#pragma unroll
      for (int rr = 0; rr < 3; ++rr) {
        const int r = lane + 32 * rr;
        if (r < NL) ro[r] = row[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: per-device launch set-up, done once per process and device.  A
// kernel's dynamic shared-memory limit is raised and the occupancy query
// asked how many of its blocks one SM holds; later launches read the cache.
// ---------------------------------------------------------------------------

#define MAX_DEVICES 64

struct LaunchSetup {
  int rc = -1;     // cudaSuccess (0) once set up, else the error
  int per_sm = 0;  // blocks resident on one SM
  int blocks = 0;  // blocks resident on the card (per_sm x SMs)
};

template <typename Kernel>
static const LaunchSetup& launch_setup(LaunchSetup (&cache)[MAX_DEVICES], Kernel kernel,
                                       int threads, int smem) {
  int dev = 0;
  cudaGetDevice(&dev);
  LaunchSetup& s = cache[dev < MAX_DEVICES ? dev : 0];
  if (s.rc == 0) return s;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  s.per_sm = per_sm;
  s.blocks = per_sm * sms;
  s.rc = (int)e;
  return s;
}
