// Full-RNS Montgomery multiply and fixed-exponent power for BLS12-381 Fq,
// written by hand for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels in hbbft_tpu/ops/fq_rns_pallas.py:
//   fq_rns_mul_kernel  <- _mul_kernel (body _mul_core), pallas_call at :295
//   fq_rns_pow_kernel  <- _pow_kernel, pallas_call at :339
// and computes the same float32 values bit for bit (checked against the plain
// PyTorch version in hbbft_tpu_torch/ops/fq_rns_cuda.py).
//
// Data layout.  Operands are the port's public (n, 79) float32 residue rows,
// [B1 (39) | B2 (39) | m_r], every value an exact integer below 2^24.  A block
// owns TPB consecutive lanes (rows of the operand).  It copies its TPB x 79
// slab into shared memory transposed to [residue][lane] (coalesced global
// reads, stride TPB+1 against bank conflicts), and each thread then runs the
// whole Montgomery pipeline for ONE lane down its own column.  No thread ever
// touches another thread's column, so the pipeline needs no barriers and the
// power kernel chains its ~760 products without leaving shared memory.
//
// What bounds it on the H100.  Per product a lane does 39x40 (first
// extension, 2 sums) + 39x40 (second extension, 4 sums) = 9,360 float32
// multiply-adds plus ~400 ops of reductions, against 3 x 316 bytes of
// device memory traffic (two operands in, one out): ~30 operations per byte,
// so the multiply kernel is bound by the float32 pipe (67 TFLOP/s) rather
// than by memory (3.35 TB/s; the balance point is ~20 op/B).  The power
// kernel reads 316 B and writes 316 B per lane for ~570 products and is
// entirely compute bound.  This first design spends one shared-memory
// broadcast load per 2 (first extension) or 4 (second extension)
// multiply-adds on the constant matrices, so it is issue bound below the
// float32 peak; a later version moves the extensions onto the tensor cores
// (the 6-bit/5-bit planes are exact in bf16, as the TPU kernel uses them).
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

#include <cuda_runtime.h>
#include <stdint.h>

#define NB 39          // primes per RNS base
#define NL 79          // residues per element: B1 | B2 | m_r
#define NE 40          // extension outputs: B2 + m_r (first), B1 + m_r (second)
#define TPB 128        // lanes (threads) per block
#define LD (TPB + 1)   // shared-memory row stride of a transposed tile

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

#define SMEM_BYTES ((N_CONSTS + 2 * NL * LD) * 4)

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

// One Montgomery product for the lane of column t, in place: A <- A*B*M1^-1.
// A and B are transposed tiles ([residue][lane], stride LD); B may alias A.
// `reduced` skips the input renormalization (both operands already have
// lanes in (-p, 2p), as every output of this function does).
__device__ __forceinline__ void mul_core(float* A, const float* B, int t,
                                         bool reduced, const float* K) {
  const float* P = K + OFF_P;
  const float* IP = K + OFF_IP;
  const float* XOFF = K + OFF_XOFF;

  // x = loose(a*b) + offset, lanes in (-p, 3p).  sigma (B1) stays in
  // registers; the B2 + m_r part of x is parked in A's own rows, which are
  // dead once read.
  float sig[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    float a = A[i * LD + t];
    float b = B[i * LD + t];
    if (!reduced) {
      a = mod_loose(a, P[i], IP[i]);
      b = mod_loose(b, P[i], IP[i]);
    }
    float x = mod_loose(a * b, P[i], IP[i]) + XOFF[i];
    sig[i] = mod_lanes(x * K[OFF_SIGC + i], P[i], IP[i]);
  }
#pragma unroll
  for (int j = NB; j < NL; ++j) {
    float a = A[j * LD + t];
    float b = B[j * LD + t];
    if (!reduced) {
      a = mod_loose(a, P[j], IP[j]);
      b = mod_loose(b, P[j], IP[j]);
    }
    A[j * LD + t] = mod_loose(a * b, P[j], IP[j]) + XOFF[j];
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
    float x2 = A[(NB + j) * LD + t];
    A[(NB + j) * LD + t] =
        mod_loose(x2 * K[OFF_M1INV + j] + qh * K[OFF_QM1INV + j], pj, ipj);
  }

  // xi over B2, split into 6-bit lo and 5-bit hi planes.
  float vlo[NB], vhi[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    float r = A[(NB + i) * LD + t];
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
  const float r_mr = A[(NL - 1) * LD + t];
  const float delta =
      mod_lanes((raw_mr - r_mr) * K[OFF_M2INVR], 256.f, 1.f / 256.f);
#pragma unroll 1
  for (int j = 0; j < NB; ++j) {
    float raw = ext2(j);
    A[j * LD + t] = mod_loose(raw - delta * K[OFF_M2B1 + j], P[j], IP[j]);
  }
}

// Block-cooperative copies between a (n, 79) global slab and a tile.
__device__ __forceinline__ void load_tile(float* T, const float* g, int cnt) {
  for (int k = threadIdx.x; k < TPB * NL; k += TPB) {
    int lane = k / NL;
    int row = k - lane * NL;
    T[row * LD + lane] = lane < cnt ? g[k] : 0.f;
  }
}

__device__ __forceinline__ void store_tile(float* g, const float* T, int cnt) {
  for (int k = threadIdx.x; k < cnt * NL; k += TPB) {
    int lane = k / NL;
    int row = k - lane * NL;
    g[k] = T[row * LD + lane];
  }
}

__device__ __forceinline__ void load_consts(float* K, const float* kc) {
  for (int k = threadIdx.x; k < N_CONSTS; k += TPB) K[k] = kc[k];
}

__global__ void __launch_bounds__(TPB)
fq_rns_mul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, int n, int reduced,
                  const float* __restrict__ kc) {
  extern __shared__ float smem[];
  float* K = smem;
  float* A = K + N_CONSTS;
  float* B = A + NL * LD;
  const long base = (long)blockIdx.x * TPB;
  const int cnt = (int)min((long)TPB, (long)n - base);
  load_consts(K, kc);
  load_tile(A, a + base * NL, cnt);
  load_tile(B, b + base * NL, cnt);
  __syncthreads();
  mul_core(A, B, threadIdx.x, reduced != 0, K);
  __syncthreads();
  store_tile(out + base * NL, A, cnt);
}

__global__ void __launch_bounds__(TPB)
fq_rns_pow_kernel(const float* __restrict__ x, const int* __restrict__ bits,
                  int nbits, float* __restrict__ out, int n,
                  const float* __restrict__ kc) {
  extern __shared__ float smem[];
  float* K = smem;
  float* A = K + N_CONSTS;  // accumulator
  float* B = A + NL * LD;   // the (renormalized) base
  const long base = (long)blockIdx.x * TPB;
  const int cnt = (int)min((long)TPB, (long)n - base);
  const int t = threadIdx.x;
  load_consts(K, kc);
  load_tile(B, x + base * NL, cnt);
  __syncthreads();
#pragma unroll 1
  for (int r = 0; r < NL; ++r) {
    float v = mod_loose(B[r * LD + t], K[OFF_P + r], K[OFF_IP + r]);
    B[r * LD + t] = v;
    A[r * LD + t] = v;
  }
  // MSB implicit: the accumulator starts at x; the bit schedule is
  // warp-uniform, so the multiply is a branch rather than a blend.
#pragma unroll 1
  for (int i = 1; i < nbits; ++i) {
    mul_core(A, A, t, true, K);
    if (bits[i]) mul_core(A, B, t, true, K);
  }
  __syncthreads();
  store_tile(out + base * NL, A, cnt);
}

extern "C" {

int fq_rns_const_floats(void) { return N_CONSTS; }

// Each launcher returns cudaGetLastError() after its launch (0 = launched).
int fq_rns_mul(const float* a, const float* b, float* out, int n, int reduced,
               const float* kc, void* stream) {
  if (n <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      fq_rns_mul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  unsigned grid = (unsigned)((n + TPB - 1) / TPB);
  fq_rns_mul_kernel<<<grid, TPB, SMEM_BYTES, (cudaStream_t)stream>>>(
      a, b, out, n, reduced, kc);
  return (int)cudaGetLastError();
}

int fq_rns_pow(const float* x, const int* bits, int nbits, float* out, int n,
               const float* kc, void* stream) {
  if (n <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      fq_rns_pow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  unsigned grid = (unsigned)((n + TPB - 1) / TPB);
  fq_rns_pow_kernel<<<grid, TPB, SMEM_BYTES, (cudaStream_t)stream>>>(
      x, bits, nbits, out, n, kc);
  return (int)cudaGetLastError();
}

const char* fq_rns_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
