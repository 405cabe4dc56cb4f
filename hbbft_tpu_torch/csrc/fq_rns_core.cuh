// The one RNS Montgomery body on the card: the constant layout, the two
// lane reductions and `mul_core`, shared by csrc/fq_rns.cu (the multiply
// and power kernels) and csrc/tower_fused.cu (the fused tower kernels).
//
// It is the port of `_mul_core` in hbbft_tpu/ops/fq_rns_pallas.py and
// computes the same float32 values bit for bit.
//
// Exactness.  Every intermediate is an integer below 2^24 in magnitude (the
// bounds are derived in hbbft_tpu/ops/fq_rns.py and fq_rns_pallas.py):
//  * lane products |a*b| < 4p^2 < 2^24 for operands in (-p, 2p);
//  * first extension: sum_i sigma_i*E_lo < 39*2047*63 < 2^22.3 and the E_hi
//    sum below that, so any summation order and any FMA contraction is
//    exact; its result is the canonical residue, equal to the TPU kernel's;
//  * second extension: the TPU kernel's three partial sums (ll, lh+hl, hh)
//    are kept separately because its LOOSE reductions make the result depend
//    on them, each below 2^18;
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
// check the total length at load.
#define OFF_E1 0                        // float2 [NE][NB]: (lo, hi) of E1[i][j] at [j][i]
#define OFF_E2 (OFF_E1 + 2 * NE * NB)   // float2 [NE][NB]: (lo, hi) of E2[i][j] at [j][i]
#define OFF_P (OFF_E2 + 2 * NE * NB)    // [NL] moduli
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

__device__ __forceinline__ float mod_loose(float x, float p, float ip) {
  // one-pass reduction to (-p, 2p); floor(..)*p is an exact integer
  return x - floorf(__fmul_rn(x, ip)) * p;
}

__device__ __forceinline__ float mod_lanes(float x, float p, float ip) {
  // exact reduction to [0, p), written as the reference writes it
  x = x - floorf(__fmul_rn(x, ip)) * p;
  x = x - p * (float)(x >= p);
  x = x + p * (float)(x < 0.f);
  return x;
}

// One Montgomery product for one lane: O <- A*B*M1^-1.  Residue r of an
// operand lies at A[r*sa] (B[r*sb], O[r*so]), so the same body runs on a
// transposed shared-memory tile (stride = tile width) and on a lane row in
// device memory (stride 1).  O may alias A or B (same stride): every
// residue of an input is read before the output row that shares it is
// written.  The B2 + m_r part of x is parked in O's own rows.  `reduced`
// skips the input renormalization (both operands already have lanes in
// (-p, 2p), as every output of this function does).
__device__ __forceinline__ void mul_core(const float* A, int sa, const float* B,
                                         int sb, float* O, int so, bool reduced,
                                         const float* K) {
  const float* P = K + OFF_P;
  const float* IP = K + OFF_IP;
  const float* XOFF = K + OFF_XOFF;

  // x = loose(a*b) + offset, lanes in (-p, 3p); sigma (B1) stays in registers.
  float sig[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    float a = A[i * sa];
    float b = B[i * sb];
    if (!reduced) {
      a = mod_loose(a, P[i], IP[i]);
      b = mod_loose(b, P[i], IP[i]);
    }
    float x = mod_loose(a * b, P[i], IP[i]) + XOFF[i];
    sig[i] = mod_lanes(x * K[OFF_SIGC + i], P[i], IP[i]);
  }
#pragma unroll
  for (int j = NB; j < NL; ++j) {
    float a = A[j * sa];
    float b = B[j * sb];
    if (!reduced) {
      a = mod_loose(a, P[j], IP[j]);
      b = mod_loose(b, P[j], IP[j]);
    }
    O[j * so] = mod_loose(a * b, P[j], IP[j]) + XOFF[j];
  }

  // Extension 1 (B1 -> B2 + m_r), canonical q-hat, then the fused
  // r = x*M1^-1 + q-hat*(Q*M1^-1), one loose reduction, written in place.
  const float2* E1 = reinterpret_cast<const float2*>(K + OFF_E1);
#pragma unroll 1
  for (int j = 0; j < NE; ++j) {
    const float2* e = E1 + j * NB;
    float slo = 0.f, shi = 0.f;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      float2 w = e[i];
      slo = fmaf(sig[i], w.x, slo);
      shi = fmaf(sig[i], w.y, shi);
    }
    const float pj = P[NB + j], ipj = IP[NB + j];
    float qh = mod_lanes(slo + 64.f * mod_lanes(shi, pj, ipj), pj, ipj);
    float x2 = O[(NB + j) * so];
    O[(NB + j) * so] =
        mod_loose(x2 * K[OFF_M1INV + j] + qh * K[OFF_QM1INV + j], pj, ipj);
  }

  // xi over B2, split into 6-bit lo and 5-bit hi planes.
  float vlo[NB], vhi[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    float r = O[(NB + i) * so];
    float xi = mod_lanes(r * K[OFF_W2INV + i], P[NB + i], IP[NB + i]);
    vhi[i] = floorf(xi * (1.f / 64.f));
    vlo[i] = xi - 64.f * vhi[i];
  }

  // Extension 2 (B2 -> B1 + m_r) with the reference's partial sums:
  // ll + 64*loose(lh + hl) + 4096*canonical(hh), loose result.
  const float2* E2 = reinterpret_cast<const float2*>(K + OFF_E2);
  auto ext2 = [&](int j) -> float {
    const float2* e = E2 + j * NB;
    float ll = 0.f, mid = 0.f, hh = 0.f;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      float2 w = e[i];
      ll = fmaf(vlo[i], w.x, ll);
      mid = fmaf(vhi[i], w.x, mid);
      mid = fmaf(vlo[i], w.y, mid);
      hh = fmaf(vhi[i], w.y, hh);
    }
    const float pj = K[OFF_PB1R + j], ipj = K[OFF_IPB1R + j];
    float out = ll + 64.f * mod_loose(mid, pj, ipj) + 4096.f * mod_lanes(hh, pj, ipj);
    return mod_loose(out, pj, ipj);
  };

  // Shenoy-Kumaresan correction from the m_r row (output j = NB).
  const float raw_mr = ext2(NB);
  const float r_mr = O[(NL - 1) * so];
  const float delta =
      mod_lanes((raw_mr - r_mr) * K[OFF_M2INVR], 256.f, 1.f / 256.f);
#pragma unroll 1
  for (int j = 0; j < NB; ++j) {
    float raw = ext2(j);
    O[j * so] = mod_loose(raw - delta * K[OFF_M2B1 + j], P[j], IP[j]);
  }
}

// Copy the packed constants into shared memory (block-cooperative).
__device__ __forceinline__ void load_consts(float* K, const float* kc) {
  for (int k = threadIdx.x; k < N_CONSTS; k += blockDim.x) K[k] = kc[k];
}
