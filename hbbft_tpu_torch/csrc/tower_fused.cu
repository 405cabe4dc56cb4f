// Fused tower kernels for BLS12-381, written by hand for Hopper (sm_90a):
// one launch per tower operation, per Miller doubling, and for the whole
// final-exponentiation hard part.
//
// Replaces the JAX package's Pallas TPU kernels in hbbft_tpu/ops/tower_fused.py:
//   tower_op_kernel    <- _op_kernel   (pallas_call at :433)
//   miller_dbl_kernel  <- _dbl_kernel  (pallas_call at :574)
//   hard_exp_kernel    <- _hard_kernel (pallas_call at :707)
// and computes the same float32 values bit for bit: every Fq product is the
// shared Montgomery body of csrc/fq_rns_core.cuh with reduced = false, and the
// recombination between products is the ops/tower.py arithmetic on exact
// float32 integers (checked against the plain PyTorch versions in
// hbbft_tpu_torch/ops/tower_fused.py, which equal the Pallas kernels).
//
// Design.  A block owns LB consecutive lanes (LB is chosen by the wrapper:
// see Sizing).  A tower operation is a sequence of rounds; each round is
//   1. a pointwise phase: thread k of the block takes residue r of lane l
//      (k = l*79 + r) and computes, from the lane's state, the round's
//      operand pairs (Karatsuba sums, broadcast constants) into the staging
//      rows OPA/OPB;
//   2. a product phase, OUT[p] = OPA[p]*OPB[p] for every product p of every
//      lane, on the warp-wide tensor-core body (`mul_warp`,
//      csrc/fq_rns_core.cuh; pass `mul_pass_warp` below);
//   3. the next pointwise phase reads the products and recombines them.
// __syncthreads() separates the phases.  The lane state (the Miller f and R,
// the hard part's register file of six fq12) and the staging rows live in a
// per-block scratch in device memory, [slot][lane][residue], written and read
// back by the same block only, so it stays in L1/L2; shared memory holds the
// field constants and the warps' tiles.  One launch carries every round: the
// point of the fused chain is the launch count (one per Miller doubling
// instead of four stacked multiplies and ~60 elementwise ops, one for the
// hard part instead of ~700).
//
// What bounds it on the H100.  Per lane the double step runs 118 products and
// the hard part 11,424 (five x-chains of 63 cyclotomic squares of 30
// products, 25 set-bit multiplies of 54, and the glue), against 12,008
// (double step: 20 rows in, 18 out) and 7,584 (hard part: 12 rows in, 12
// out) bytes of device memory per lane.  Both are bound by operations, not
// bytes; at the verification path's narrow widths (~1.6k lanes for the
// double step, ~800 for tower_op's fq12 multiply and the hard part) what
// they meet first is latency: a few serial rounds of products with
// barriers between them.
//
// The product pass.  A round's np*nl products are numbered task = p*nl + l
// and dealt to the block's four warps 16 at a time (the last group padded
// with dummy tasks that store nothing); a warp reads each task's rows
// across its lanes (coalesced), runs both extensions as int8 mma.sync
// products and writes the rows back.  The round's rows stay in the
// device-memory scratch: a lane's 162 staging rows are 51 KB, so a block's
// would not fit in shared memory, and they are written and read back by
// the same block within microseconds, so they live in L2.  Shared memory
// holds the 12.3 KB of constants and the four warps' 5 KB tiles (32,528
// B); __launch_bounds__(128, 4) lets four blocks (16 warps) share an SM.
// Every kernel's block is set up by block_setup.
//
// Sizing (ops/tower_fused_cuda.py lanes_per_block, one policy for the
// three kernels, the policy fit_per_block of every warp-body kernel): the
// lanes per block LB is the smallest power of two (at most 8) for which
// the grid fits on the card at once (the kernel's blocks per SM from the
// occupancy query x SMs: 4 x 132 = 528 on the H100).  tower_op at the
// path's ~796 lanes (kind fq12_mul, the cross-pair merge): LB = 2 and 398
// blocks, its 108 products a block 7 groups of 16, two serial warp passes:
// 0.058 ms of kernel time on an NVIDIA H100 80GB HBM3 at 700.00 W (the
// first design, a thread a product on the float32 pipe: 0.184; PERF.md).
// The kinds with 2 or 3 products a lane fill a pass with few real tasks,
// the rest padding.  miller_dbl at the path's ~1,593 lanes: LB = 4 and 399
// blocks (3 per SM, 12 warps); its rounds' 192, 72, 28 and 180 products
// are 12, 5, 2 and 12 groups of 16, so a doubling is 3 + 2 + 1 + 3 serial
// warp passes.  hard_exp at the path's ~796 lanes: LB = 2 and 398 blocks;
// a cyclotomic square's 36 and 24 products are 3 and 2 groups (one warp
// pass each), an fq12 multiply's 108 are 7 (two passes); LB = 1 and 4
// measured slower (PERF.md).  Per chain a lane runs 63 cyclotomic squares,
// 5 set-bit multiplies and the glue: ~668 serial product rounds per lane,
// each a barrier-separated pointwise phase and warp pass, with three
// blocks sharing an SM; that, not its operations, is what bounds hard_exp.
//
// Layout of the operands: the port's (C, n, 79) stacked coefficient rows in
// the canonical leaf order (fq12: coefficient 6s + 2t + c for fq6-half s,
// fq2-coefficient t, component c).  Compile without --use_fast_math.

#include "fq_rns_core.cuh"

#define TPB 128        // threads per block
#define MAXP 54        // Fq products in the widest round (one fq12 multiply)
#define NTC 40         // rows of the tower constants: ONE, then K^(1..3)

// Scratch slots per lane.
#define S_OPA 0
#define S_OPB (S_OPA + MAXP)
#define S_OUT (S_OPB + MAXP)
#define S_STAGE (S_OUT + MAXP)   // 162: end of the staging rows
// miller_dbl temporaries
#define D_F2 S_STAGE             // f^2 (12)
#define D_XX (D_F2 + 12)
#define D_YY (D_XX + 2)
#define D_ZZ (D_YY + 2)
#define D_YZ (D_ZZ + 2)
#define D_C8 (D_YZ + 2)
#define D_C1A1 (D_C8 + 2)
#define DBL_SLOTS (D_C1A1 + 2)
// hard_exp register file
#define H_ACC S_STAGE
#define H_BASE (H_ACC + 12)
#define H_B (H_BASE + 12)
#define H_Y3 (H_B + 12)
#define H_Y2 (H_Y3 + 12)
#define H_Y1 (H_Y2 + 12)
#define HARD_SLOTS (H_Y1 + 12)
#define OP_SLOTS S_STAGE

// ---------------------------------------------------------------------------
// Pointwise tower arithmetic on one residue (exact float32 integers)
// ---------------------------------------------------------------------------

struct F2 { float c0, c1; };
struct F6 { F2 c[3]; };
struct F12 { F6 c[2]; };

__device__ __forceinline__ F2 add2(F2 a, F2 b) { return {a.c0 + b.c0, a.c1 + b.c1}; }
__device__ __forceinline__ F2 sub2(F2 a, F2 b) { return {a.c0 - b.c0, a.c1 - b.c1}; }
__device__ __forceinline__ F2 neg2(F2 a) { return {-a.c0, -a.c1}; }
__device__ __forceinline__ F2 conj2(F2 a) { return {a.c0, -a.c1}; }
// times xi = 1 + u:  (a0 - a1) + (a0 + a1) u
__device__ __forceinline__ F2 xi2(F2 a) { return {a.c0 - a.c1, a.c0 + a.c1}; }
__device__ __forceinline__ F2 three2(F2 t) { return add2(add2(t, t), t); }
__device__ __forceinline__ F2 two2(F2 t) { return add2(t, t); }

__device__ __forceinline__ F6 add6(const F6& a, const F6& b) {
  F6 r;
  for (int i = 0; i < 3; ++i) r.c[i] = add2(a.c[i], b.c[i]);
  return r;
}
__device__ __forceinline__ F6 sub6(const F6& a, const F6& b) {
  F6 r;
  for (int i = 0; i < 3; ++i) r.c[i] = sub2(a.c[i], b.c[i]);
  return r;
}
__device__ __forceinline__ F6 neg6(const F6& a) {
  F6 r;
  for (int i = 0; i < 3; ++i) r.c[i] = neg2(a.c[i]);
  return r;
}
// times v: (xi a2, a0, a1)
__device__ __forceinline__ F6 mulv6(const F6& a) {
  F6 r;
  r.c[0] = xi2(a.c[2]);
  r.c[1] = a.c[0];
  r.c[2] = a.c[1];
  return r;
}
__device__ __forceinline__ F12 conj12(const F12& a) {
  F12 r;
  r.c[0] = a.c[0];
  r.c[1] = neg6(a.c[1]);
  return r;
}

// An element view: coefficient c of the lane row at index k (= l*79 + r)
// lies at p[c*cs + k].  In/out tensors have cs = n*79 (p offset to the
// block's first lane), scratch slots cs = LB*79.
struct El {
  float* p;
  long cs;
  __device__ __forceinline__ float& at(int c, int k) const { return p[c * cs + k]; }
  __device__ __forceinline__ F2 f2(int c, int k) const { return {at(c, k), at(c + 1, k)}; }
  __device__ __forceinline__ F12 f12(int k) const {
    F12 r;
    for (int s = 0; s < 2; ++s)
      for (int t = 0; t < 3; ++t) r.c[s].c[t] = f2(6 * s + 2 * t, k);
    return r;
  }
  __device__ __forceinline__ void put2(int c, int k, F2 v) const {
    at(c, k) = v.c0;
    at(c + 1, k) = v.c1;
  }
  __device__ __forceinline__ void put12(int k, const F12& v) const {
    for (int s = 0; s < 2; ++s)
      for (int t = 0; t < 3; ++t) put2(6 * s + 2 * t, k, v.c[s].c[t]);
  }
  __device__ __forceinline__ El at_slot(int s) const { return {p + s * cs, cs}; }
};

// Writes the operand pairs of a round, in the order of the plain version.
struct Pairs {
  float* A;
  float* B;
  long ss;
  int k;
  int n = 0;
  __device__ __forceinline__ void fq(float a, float b) {
    A[n * ss + k] = a;
    B[n * ss + k] = b;
    ++n;
  }
  __device__ __forceinline__ void mul2(F2 a, F2 b) {  // tower.fq2_mul_pairs
    fq(a.c0, b.c0);
    fq(a.c1, b.c1);
    fq(a.c0 + a.c1, b.c0 + b.c1);
  }
  __device__ __forceinline__ void sqr2(F2 a) {  // tower.fq2_sqr_pairs
    fq(a.c0 + a.c1, a.c0 - a.c1);
    fq(a.c0, a.c1);
  }
  __device__ __forceinline__ void mul6(const F6& a, const F6& b) {  // fq6_mul_fq2_pairs
    mul2(a.c[0], b.c[0]);
    mul2(a.c[1], b.c[1]);
    mul2(a.c[2], b.c[2]);
    mul2(add2(a.c[1], a.c[2]), add2(b.c[1], b.c[2]));
    mul2(add2(a.c[0], a.c[1]), add2(b.c[0], b.c[1]));
    mul2(add2(a.c[0], a.c[2]), add2(b.c[0], b.c[2]));
  }
  __device__ __forceinline__ void mul12(const F12& a, const F12& b) {
    mul6(a.c[0], b.c[0]);
    mul6(a.c[1], b.c[1]);
    mul6(add6(a.c[0], a.c[1]), add6(b.c[0], b.c[1]));
  }
  __device__ __forceinline__ void sqr12(const F12& a) {  // fq12_sqr_pairs
    mul6(a.c[0], a.c[1]);
    mul6(add6(a.c[0], a.c[1]), add6(a.c[0], mulv6(a.c[1])));
  }
  // f x sparse line (l0, l4, l5): tower.fq12_mul_line_pairs
  __device__ __forceinline__ void mul_line(const F12& f, F2 l0, F2 l4, F2 l5) {
    const F6& a = f.c[0];
    const F6& b = f.c[1];
    mul2(a.c[0], l0);
    mul2(a.c[1], l0);
    mul2(a.c[2], l0);
    mul2(b.c[1], l5);
    mul2(b.c[2], l4);
    mul2(b.c[0], l4);
    mul2(b.c[2], l5);
    mul2(b.c[0], l5);
    mul2(b.c[1], l4);
    F6 l;
    l.c[0] = l0;
    l.c[1] = l4;
    l.c[2] = l5;
    mul6(add6(a, b), l);
  }
  // the 18 squaring lanes of tower.fq12_cyclo_sqr
  __device__ __forceinline__ void cyclo(const F12& a) {
    const F2 xs[3] = {a.c[0].c[0], a.c[0].c[1], a.c[0].c[2]};
    const F2 ys[3] = {a.c[1].c[1], a.c[1].c[2], a.c[1].c[0]};
    for (int i = 0; i < 3; ++i) {
      sqr2(xs[i]);
      sqr2(ys[i]);
      sqr2(add2(xs[i], ys[i]));
    }
  }
};

// Reads the products of a round back, recombining as ops/tower.py does.
struct Prods {
  const float* P;
  long ss;
  int k;
  int n = 0;
  __device__ __forceinline__ float fq() {
    float v = P[n * ss + k];
    ++n;
    return v;
  }
  __device__ __forceinline__ F2 mul2() {  // tower.fq2_from_products
    float t0 = fq();
    float t1 = fq();
    float t2 = fq();
    return {t0 - t1, t2 - (t0 + t1)};
  }
  __device__ __forceinline__ F2 sqr2() {  // tower.fq2_sqr_from_products
    float t0 = fq();
    float t1 = fq();
    return {t0, t1 + t1};
  }
  __device__ __forceinline__ F6 mul6() {  // tower.fq6_from_products
    F2 t0 = mul2(), t1 = mul2(), t2 = mul2();
    F2 m12 = mul2(), m01 = mul2(), m02 = mul2();
    F6 r;
    r.c[0] = add2(t0, xi2(sub2(m12, add2(t1, t2))));
    r.c[1] = add2(sub2(m01, add2(t0, t1)), xi2(t2));
    r.c[2] = add2(sub2(m02, add2(t0, t2)), t1);
    return r;
  }
  __device__ __forceinline__ F12 mul12() {
    F6 t0 = mul6();
    F6 t1 = mul6();
    F6 mid = mul6();
    F12 r;
    r.c[0] = add6(t0, mulv6(t1));
    r.c[1] = sub6(mid, add6(t0, t1));
    return r;
  }
  __device__ __forceinline__ F12 sqr12() {  // tower.fq12_sqr_from_products
    F6 t = mul6();
    F6 u = mul6();
    F12 r;
    r.c[0] = sub6(u, add6(t, mulv6(t)));
    r.c[1] = add6(t, t);
    return r;
  }
  __device__ __forceinline__ F12 mul_line() {  // tower.fq12_mul_line_from_products
    F6 t0, t1;
    t0.c[0] = mul2();
    t0.c[1] = mul2();
    t0.c[2] = mul2();
    F2 r3 = mul2(), r4 = mul2(), r5 = mul2(), r6 = mul2(), r7 = mul2(), r8 = mul2();
    t1.c[0] = xi2(add2(r3, r4));
    t1.c[1] = add2(r5, xi2(r6));
    t1.c[2] = add2(r7, r8);
    F6 mid = mul6();
    F12 r;
    r.c[0] = add6(t0, mulv6(t1));
    r.c[1] = sub6(mid, add6(t0, t1));
    return r;
  }
};

// ---------------------------------------------------------------------------
// Block-level rounds
// ---------------------------------------------------------------------------

struct Blk {
  float* S;        // this block's scratch: slot s, lane l, residue r at S[s*ss + l*79 + r]
  long ss;         // slot stride = LB*79
  int nl;          // valid lanes of this block
  const float* K;  // mul_warp's constants (shared memory)
  const float* tc; // tower constants (NTC, 79), or null
  float* T;        // this warp's mul_warp tile (shared memory)
  __device__ __forceinline__ El slot(int s) const { return {S + s * ss, ss}; }
  __device__ __forceinline__ Pairs pairs(int k) const {
    return Pairs{S + S_OPA * ss, S + S_OPB * ss, ss, k};
  }
  __device__ __forceinline__ Prods prods(int k) const { return Prods{S + S_OUT * ss, ss, k}; }
};

// OUT[p] = OPA[p] * OPB[p] for p < np, every lane; then a barrier.  Tasks
// task = p*nl + l are dealt to the warps WARP_M at a time; the lanes past
// the last task re-read task 0's rows and store nothing.  The loop bound is
// uniform across a warp.  Not inlined: one copy of the Montgomery body per
// kernel keeps the build short.
__device__ __noinline__ void mul_pass_warp(const Blk& b, int np) {
  __syncthreads();
  const float* A = b.S + S_OPA * b.ss;
  const float* B = b.S + S_OPB * b.ss;
  float* O = b.S + S_OUT * b.ss;
  const int ntask = np * b.nl, lane = threadIdx.x & 31;
  for (int g0 = (threadIdx.x >> 5) * WARP_M; g0 < ntask; g0 += (blockDim.x >> 5) * WARP_M) {
    const bool valid = lane < WARP_M && g0 + lane < ntask;
    const int task = valid ? g0 + lane : 0;
    const int p = task / b.nl;
    const long off = p * b.ss + (long)(task - p * b.nl) * NL;
    mul_warp(b.T, b.K, A + off, B + off, O + off, valid, false, lane);
  }
  __syncthreads();
}

#define FOR_K(b) for (int k = threadIdx.x; k < (b).nl * NL; k += blockDim.x)

// out = x * y (fq12).  out may be x or y.
__device__ __noinline__ void blk_mul12(const Blk& b, El x, El y, El out) {
  FOR_K(b) {
    Pairs pr = b.pairs(k);
    pr.mul12(x.f12(k), y.f12(k));
  }
  mul_pass_warp(b, 54);
  FOR_K(b) {
    Prods q = b.prods(k);
    out.put12(k, q.mul12());
  }
  __syncthreads();
}

// out = cyclotomic square of x: 18 squaring lanes, the Granger-Scott
// recombination, then the 12-lane renormalization (a product by ONE).
// out may be x.
__device__ __noinline__ void blk_cyclo(const Blk& b, El x, El out) {
  FOR_K(b) {
    Pairs pr = b.pairs(k);
    pr.cyclo(x.f12(k));
  }
  mul_pass_warp(b, 18);
  FOR_K(b) {
    Prods q = b.prods(k);
    F2 sq[9];
    for (int i = 0; i < 9; ++i) sq[i] = q.sqr2();
    const F2 x0s = sq[0], y0s = sq[1], s0s = sq[2];
    const F2 x1s = sq[3], y1s = sq[4], s1s = sq[5];
    const F2 x2s = sq[6], y2s = sq[7], s2s = sq[8];
    const F12 a = x.f12(k);
    const F2 xy0 = sub2(sub2(s0s, x0s), y0s);
    const F2 xy1 = sub2(sub2(s1s, x1s), y1s);
    const F2 xy2 = sub2(sub2(s2s, x2s), y2s);
    F2 s[6];
    s[0] = sub2(three2(add2(x0s, xi2(y0s))), two2(a.c[0].c[0]));  // a0
    s[1] = sub2(three2(add2(xi2(x2s), y2s)), two2(a.c[0].c[1]));  // a1
    s[2] = sub2(three2(add2(x1s, xi2(y1s))), two2(a.c[0].c[2]));  // a2
    s[3] = add2(xi2(three2(xy1)), two2(a.c[1].c[0]));             // b0
    s[4] = add2(three2(xy0), two2(a.c[1].c[1]));                  // b1
    s[5] = add2(three2(xy2), two2(a.c[1].c[2]));                  // b2
    Pairs pr = b.pairs(k);
    const float one = b.tc[k % NL];
    for (int i = 0; i < 6; ++i) {
      pr.fq(s[i].c0, one);
      pr.fq(s[i].c1, one);
    }
  }
  mul_pass_warp(b, 12);
  FOR_K(b) {
    Prods q = b.prods(k);
    for (int c = 0; c < 12; ++c) out.at(c, k) = q.fq();
  }
  __syncthreads();
}

#define WARP_SMEM (TC_SMEM_BYTES + (TPB / 32) * WARP_TILE * 4)  // a block's shared memory

// A block's set-up, the same in every kernel: mul_warp's constants into
// the dynamic shared memory smem, this warp's tile after them, the block's
// lanes and its scratch (nslots slots of LB lanes).  Returns the block's
// first lane.
__device__ __forceinline__ long block_setup(Blk& b, float* smem, const float* kc,
                                            const int* kt, const float* tc, float* scratch,
                                            int n, int lb, int nslots) {
  load_tc_consts(smem, kc, kt);
  const long lane0 = (long)blockIdx.x * lb;
  b.ss = (long)lb * NL;
  b.S = scratch + (long)blockIdx.x * nslots * b.ss;
  b.nl = (int)min((long)lb, (long)n - lane0);
  b.K = smem;
  b.tc = tc;
  b.T = smem + NV + TC_WORDS + (threadIdx.x >> 5) * WARP_TILE;
  __syncthreads();
  return lane0;
}

// ---------------------------------------------------------------------------
// Kernel 1: one tower operation (kind 0..6, in ops/tower_fused.py's order)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(TPB, 4)
tower_op_kernel(int kind, const float* a, const float* bb, float* out, int n, int lb,
                float* scratch, const float* __restrict__ kc, const int* __restrict__ kt,
                const float* tc) {
  extern __shared__ __align__(16) float smem[];  // mul_warp constants, then the tiles
  Blk b;
  const long lane0 = block_setup(b, smem, kc, kt, tc, scratch, n, lb, OP_SLOTS);
  const long cs = (long)n * NL;
  const El x{const_cast<float*>(a) + lane0 * NL, cs};
  const El y{const_cast<float*>(bb) + lane0 * NL, cs};
  const El o{out + lane0 * NL, cs};

  if (kind == 6) {  // fq12_cyclo_sqr
    blk_cyclo(b, x, o);
    return;
  }
  if (kind == 4) {  // fq12_mul
    blk_mul12(b, x, y, o);
    return;
  }
  FOR_K(b) {
    Pairs pr = b.pairs(k);
    switch (kind) {
      case 0: pr.mul2(x.f2(0, k), y.f2(0, k)); break;
      case 1: pr.sqr2(x.f2(0, k)); break;
      case 2:
      case 3: {
        F6 u, v;
        for (int t = 0; t < 3; ++t) {
          u.c[t] = x.f2(2 * t, k);
          v.c[t] = (kind == 2 ? y : x).f2(2 * t, k);
        }
        pr.mul6(u, v);
        break;
      }
      case 5: pr.sqr12(x.f12(k)); break;
    }
  }
  const int np = kind == 0 ? 3 : kind == 1 ? 2 : kind == 5 ? 36 : 18;
  mul_pass_warp(b, np);
  FOR_K(b) {
    Prods q = b.prods(k);
    switch (kind) {
      case 0: o.put2(0, k, q.mul2()); break;
      case 1: o.put2(0, k, q.sqr2()); break;
      case 2:
      case 3: {
        F6 r = q.mul6();
        for (int t = 0; t < 3; ++t) o.put2(2 * t, k, r.c[t]);
        break;
      }
      case 5: o.put12(k, q.sqr12()); break;
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 2: one Miller doubling, f <- f^2 * l_R(P), R <- 2R
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(TPB, 4)
miller_dbl_kernel(const float* f_in, const float* r_in, const float* p_in, float* f_out,
                  float* r_out, int n, int lb, float* scratch,
                  const float* __restrict__ kc, const int* __restrict__ kt) {
  extern __shared__ __align__(16) float smem[];  // mul_warp constants, then the tiles
  Blk b;
  const long lane0 = block_setup(b, smem, kc, kt, nullptr, scratch, n, lb, DBL_SLOTS);
  const long cs = (long)n * NL;
  const El f{const_cast<float*>(f_in) + lane0 * NL, cs};
  const El R{const_cast<float*>(r_in) + lane0 * NL, cs};
  const El P{const_cast<float*>(p_in) + lane0 * NL, cs};
  const El fo{f_out + lane0 * NL, cs};
  const El ro{r_out + lane0 * NL, cs};
  const El T = b.slot(0);

  // round 1: the 12 fq2 products of f^2, X^2, Y^2, Z^2, Y*Z
  FOR_K(b) {
    Pairs pr = b.pairs(k);
    const F2 X = R.f2(0, k), Y = R.f2(2, k), Z = R.f2(4, k);
    pr.sqr12(f.f12(k));
    pr.mul2(X, X);
    pr.mul2(Y, Y);
    pr.mul2(Z, Z);
    pr.mul2(Y, Z);
  }
  mul_pass_warp(b, 48);

  // round 2: X^3, X^2 Z^2, Y Z^3, Y^4, (X + Y^2)^2, E^2 (E = 3 X^2)
  FOR_K(b) {
    Prods q = b.prods(k);
    const F12 f2 = q.sqr12();
    const F2 XX = q.mul2(), YY = q.mul2(), ZZ = q.mul2(), YZ = q.mul2();
    T.at_slot(D_F2).put12(k, f2);
    T.put2(D_XX, k, XX);
    T.put2(D_YY, k, YY);
    T.put2(D_ZZ, k, ZZ);
    T.put2(D_YZ, k, YZ);
    const F2 X = R.f2(0, k);
    const F2 E = add2(add2(XX, XX), XX);
    const F2 XpYY = add2(X, YY);
    Pairs pr = b.pairs(k);
    pr.mul2(XX, X);
    pr.mul2(XX, ZZ);
    pr.mul2(YZ, ZZ);
    pr.mul2(YY, YY);
    pr.mul2(XpYY, XpYY);
    pr.mul2(E, E);
  }
  mul_pass_warp(b, 18);

  // round 3: E*(D - X3) and the four line-coefficient scalings
  FOR_K(b) {
    Prods q = b.prods(k);
    const F2 XXX = q.mul2(), XXZZ = q.mul2(), YZ3 = q.mul2();
    const F2 C = q.mul2(), Tt = q.mul2(), Fv = q.mul2();
    const F2 XX = T.f2(D_XX, k), YY = T.f2(D_YY, k), YZ = T.f2(D_YZ, k);
    const F2 E = add2(add2(XX, XX), XX);
    F2 D = sub2(sub2(Tt, XX), C);
    D = add2(D, D);
    const F2 X3 = sub2(Fv, add2(D, D));
    const F2 C4 = add2(add2(C, C), add2(C, C));
    const F2 C8 = add2(C4, C4);
    const F2 c1a1 = sub2(add2(add2(XXX, XXX), XXX), add2(YY, YY));
    const F2 u = xi2(add2(YZ3, YZ3));
    const F2 v = add2(add2(XXZZ, XXZZ), XXZZ);
    const F2 DmX3 = sub2(D, X3);
    T.put2(D_C8, k, C8);
    T.put2(D_C1A1, k, c1a1);
    ro.put2(0, k, X3);
    ro.put2(4, k, add2(YZ, YZ));
    const float xP = P.at(0, k), yP = P.at(1, k);
    Pairs pr = b.pairs(k);
    pr.mul2(E, DmX3);
    pr.fq(u.c0, yP);
    pr.fq(u.c1, yP);
    pr.fq(v.c0, xP);
    pr.fq(v.c1, xP);
  }
  mul_pass_warp(b, 7);

  // round 4: the 15 fq2 products of f^2 times the sparse line
  FOR_K(b) {
    Prods q = b.prods(k);
    const F2 EDX3 = q.mul2();
    const float c00 = q.fq(), c01 = q.fq(), c20 = q.fq(), c21 = q.fq();
    const F2 c0a0 = {c00, c01};
    const F2 c1a2 = {-c20, -c21};
    ro.put2(2, k, sub2(EDX3, T.f2(D_C8, k)));
    Pairs pr = b.pairs(k);
    pr.mul_line(T.at_slot(D_F2).f12(k), c0a0, T.f2(D_C1A1, k), c1a2);
  }
  mul_pass_warp(b, 45);
  FOR_K(b) {
    Prods q = b.prods(k);
    fo.put12(k, q.mul_line());
  }
}

// ---------------------------------------------------------------------------
// Kernel 3: the final-exponentiation hard part
// ---------------------------------------------------------------------------

__device__ __forceinline__ void copy12(const Blk& b, El from, El to) {
  FOR_K(b) {
    for (int c = 0; c < 12; ++c) to.at(c, k) = from.at(c, k);
  }
  __syncthreads();
}

// The rounds of the hard part other than the x-chains' own, each a
// function of the block that finds the register-file slots it touches
// from b: the kernel body then keeps few values live across its calls
// (ptxas holds those in callee-saved registers, and spills the rest).

// The glue round at the end of x-chain `chain`: the chain's value,
// conjugated (BLS x is negative), times conj(m) after chain 0 (-> b),
// conj(b) after chain 1 (-> y3), ONE after chain 2 (-> y2), conj(y3)
// after chain 3 (-> y1), ONE after chain 4 (-> y0'); the result is also
// the next chain's accumulator and base.
__device__ __noinline__ void hard_glue(const Blk& b, El M, int chain) {
  const El ACC = b.slot(H_ACC), BASE = b.slot(H_BASE);
  const El glue = chain == 0 ? M : b.slot(chain == 1 ? H_B : H_Y3);
  const bool by_one = chain == 2 || chain == 4;
  FOR_K(b) {
    const F12 ca = conj12(ACC.f12(k));
    F12 op;
    if (by_one) {
      const F2 z = {0.f, 0.f};
      for (int s = 0; s < 2; ++s)
        for (int t = 0; t < 3; ++t) op.c[s].c[t] = z;
      op.c[0].c[0].c0 = b.tc[k % NL];
    } else {
      op = conj12(glue.f12(k));
    }
    Pairs pr = b.pairs(k);
    pr.mul12(ca, op);
  }
  mul_pass_warp(b, 54);
  const El dst = b.slot(chain == 0 ? H_B : chain == 1 ? H_Y3 : chain == 2 ? H_Y2 : H_Y1);
  FOR_K(b) {
    Prods q = b.prods(k);
    const F12 val = q.mul12();
    ACC.put12(k, val);
    BASE.put12(k, val);
    if (chain < 4) dst.put12(k, val);
  }
  __syncthreads();
}

// frob(y1), frob^2(y2), frob^3(y3) in one 54-product round:
// frob^n(a)_ji = conj^n(a_ji) * K^(n)_ji.
__device__ __noinline__ void hard_frob(const Blk& b) {
  const El Y[3] = {b.slot(H_Y1), b.slot(H_Y2), b.slot(H_Y3)};
  FOR_K(b) {
    const int r = k % NL;
    Pairs pr = b.pairs(k);
    for (int nn = 1; nn <= 3; ++nn) {
      const F12 a = Y[nn - 1].f12(k);
      const int off = 1 + 12 * (nn - 1);
      for (int j = 0; j < 2; ++j)
        for (int i = 0; i < 3; ++i) {
          const int row = off + 2 * (3 * j + i);
          const F2 kk = {b.tc[row * NL + r], b.tc[(row + 1) * NL + r]};
          const F2 aji = (nn & 1) ? conj2(a.c[j].c[i]) : a.c[j].c[i];
          pr.mul2(aji, kk);
        }
    }
  }
  mul_pass_warp(b, 54);
  FOR_K(b) {
    Prods q = b.prods(k);
    for (int nn = 0; nn < 3; ++nn) {
      F12 v;
      for (int s = 0; s < 2; ++s)
        for (int t = 0; t < 3; ++t) v.c[s].c[t] = q.mul2();
      Y[nn].put12(k, v);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(TPB, 4)
hard_exp_kernel(const int* __restrict__ bits, int nbits, const float* m_in, float* out,
                int n, int lb, float* scratch, const float* __restrict__ kc,
                const int* __restrict__ kt, const float* tc) {
  extern __shared__ __align__(16) float smem[];  // mul_warp constants, then the tiles
  Blk b;
  const long lane0 = block_setup(b, smem, kc, kt, tc, scratch, n, lb, HARD_SLOTS);
  const long cs = (long)n * NL;
  const El M{const_cast<float*>(m_in) + lane0 * NL, cs};

  copy12(b, M, b.slot(H_ACC));
  copy12(b, M, b.slot(H_BASE));
  // Five x-power chains, each ending in its glue round.
  for (int chain = 0; chain < 5; ++chain) {
    for (int i = 0; i < nbits; ++i) {
      blk_cyclo(b, b.slot(H_ACC), b.slot(H_ACC));
      if (bits[i]) blk_mul12(b, b.slot(H_ACC), b.slot(H_BASE), b.slot(H_ACC));
    }
    hard_glue(b, M, chain);
  }
  // ACC = y0'.  m^3 = cyclo(m) * m -> BASE;  y0 = y0' * m^3 -> ACC.
  blk_cyclo(b, M, b.slot(H_BASE));
  blk_mul12(b, b.slot(H_BASE), M, b.slot(H_BASE));
  blk_mul12(b, b.slot(H_ACC), b.slot(H_BASE), b.slot(H_ACC));
  hard_frob(b);
  // ((y0 F1) F2) F3 regrouped as (y0 F1) (F2 F3), as the reference does.
  blk_mul12(b, b.slot(H_ACC), b.slot(H_Y1), b.slot(H_ACC));
  blk_mul12(b, b.slot(H_Y2), b.slot(H_Y3), b.slot(H_Y2));
  blk_mul12(b, b.slot(H_ACC), b.slot(H_Y2), El{out + lane0 * NL, cs});
}

// ---------------------------------------------------------------------------
// C interface (ctypes): each launcher returns cudaGetLastError() (0 = launched)
// ---------------------------------------------------------------------------

extern "C" {

int tower_fused_const_floats(void) { return N_CONSTS; }
int tower_fused_tc_bytes(void) { return TC_BYTES; }
int tower_fused_op_slots(void) { return OP_SLOTS; }
int tower_fused_dbl_slots(void) { return DBL_SLOTS; }
int tower_fused_hard_slots(void) { return HARD_SLOTS; }

// Launch set-up of the three kernels, once per process and device
// (launch_setup).
static LaunchSetup g_op[MAX_DEVICES], g_dbl[MAX_DEVICES], g_hard[MAX_DEVICES];

static const LaunchSetup& op_setup() {
  return launch_setup(g_op, tower_op_kernel, TPB, WARP_SMEM);
}

static const LaunchSetup& dbl_setup() {
  return launch_setup(g_dbl, miller_dbl_kernel, TPB, WARP_SMEM);
}

static const LaunchSetup& hard_setup() {
  return launch_setup(g_hard, hard_exp_kernel, TPB, WARP_SMEM);
}

// Blocks of tower_op_kernel (miller_dbl_kernel, hard_exp_kernel) resident
// on one SM, or a negative CUDA error.
int tower_fused_op_blocks_per_sm(void) {
  const LaunchSetup& s = op_setup();
  return s.rc ? -s.rc : s.per_sm;
}

int tower_fused_dbl_blocks_per_sm(void) {
  const LaunchSetup& s = dbl_setup();
  return s.rc ? -s.rc : s.per_sm;
}

int tower_fused_hard_blocks_per_sm(void) {
  const LaunchSetup& s = hard_setup();
  return s.rc ? -s.rc : s.per_sm;
}

int tower_op(int kind, const float* a, const float* b, float* out, int n, int lb,
             float* scratch, const float* kc, const int* kt, const float* tc, void* stream) {
  if (n <= 0) return 0;
  const int rc = op_setup().rc;
  if (rc) return rc;
  unsigned grid = (unsigned)((n + lb - 1) / lb);
  tower_op_kernel<<<grid, TPB, WARP_SMEM, (cudaStream_t)stream>>>(kind, a, b, out, n, lb,
                                                                   scratch, kc, kt, tc);
  return (int)cudaGetLastError();
}

int miller_dbl(const float* f, const float* r, const float* p, float* f_out,
               float* r_out, int n, int lb, float* scratch, const float* kc,
               const int* kt, void* stream) {
  if (n <= 0) return 0;
  const int rc = dbl_setup().rc;
  if (rc) return rc;
  unsigned grid = (unsigned)((n + lb - 1) / lb);
  miller_dbl_kernel<<<grid, TPB, WARP_SMEM, (cudaStream_t)stream>>>(f, r, p, f_out, r_out, n,
                                                                     lb, scratch, kc, kt);
  return (int)cudaGetLastError();
}

int hard_exp(const int* bits, int nbits, const float* m, float* out, int n, int lb,
             float* scratch, const float* kc, const int* kt, const float* tc, void* stream) {
  if (n <= 0) return 0;
  const int rc = hard_setup().rc;
  if (rc) return rc;
  unsigned grid = (unsigned)((n + lb - 1) / lb);
  hard_exp_kernel<<<grid, TPB, WARP_SMEM, (cudaStream_t)stream>>>(bits, nbits, m, out, n, lb,
                                                                   scratch, kc, kt, tc);
  return (int)cudaGetLastError();
}

const char* tower_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
