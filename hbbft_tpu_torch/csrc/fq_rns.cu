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
// Exactness: see csrc/fq_rns_core.cuh, which holds the Montgomery body
// (`mul_core`) and the constant layout this file shares with
// csrc/tower_fused.cu.  Compile without --use_fast_math.

#include "fq_rns_core.cuh"

#define TPB 128        // lanes (threads) per block
#define LD (TPB + 1)   // shared-memory row stride of a transposed tile

#define SMEM_BYTES ((N_CONSTS + 2 * NL * LD) * 4)

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
  const int t = threadIdx.x;
  mul_core(A + t, LD, B + t, LD, A + t, LD, reduced != 0, K);
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
    mul_core(A + t, LD, A + t, LD, A + t, LD, true, K);
    if (bits[i]) mul_core(A + t, LD, B + t, LD, A + t, LD, true, K);
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
