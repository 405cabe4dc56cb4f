// Limb-field multiply and fixed-exponent power for BLS12-381 Fq (8-bit limbs
// x 50 in float32), written by hand for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels in hbbft_tpu/ops/fq_pallas.py:
//   fq_limb_mul_kernel  <- _mul_kernel (body _mul_core), pallas_call at :195
//   fq_limb_pow_kernel  <- _pow_kernel, pallas_call at :291
// and computes the same float32 limbs bit for bit (checked against the plain
// PyTorch versions in hbbft_tpu_torch/ops/fq_limb_cuda.py).
//
// Exactness.  Carried limbs lie in [-1, 257] except the top one, which a
// carry never splits; for operand values below 2^396 in magnitude (the limb
// field's lazy bound) a carried operand's top limb is at most 18 in
// magnitude and the carried convolution's top column (98) at most 368
// (tests/test_torch_limb_body.py derives both and pins them at extreme
// inputs).  Every product, convolution sum (<= 50 * 257^2 ~ 2^21.7) and fold
// sum (< 2^22 without the top column, < 2^24 with it) is an integer below
// 2^24, so float32 is exact in any summation order and FMA contraction
// changes nothing.  A carry splits x into floor(x / 256) and x - 256 *
// floor(..); the floors and the int <-> float conversions run as float32
// FMAs and adds (floor_div below, i2f_w of fq_rns_core.cuh), not on the
// conversion unit.
// Compile without --use_fast_math.
//
// What bounds them on the H100.  A multiply moves 600 B (two rows in, one
// out) and does ~9,400 float32 operations (the convolution's 2,500
// multiply-adds, the carries) and 5,300 tensor-core flops (the folds,
// chip_smoke.LIMB_CORE_OPS): at the card's peaks the bytes bound it by a
// hair (0.18 ns a lane against 0.14 ns), but what sets the pace is the
// latency of the dependent carry passes and shuffles, which the SM's warps
// do not fully hide (PERF.md).  The first design ran one product per
// thread: a 99-float accumulator and a 50-float operand in registers (250
// registers, 8 warps an SM), ~900 floors a product on the conversion unit,
// the fold on the float32 pipe -- 324 M products/s at 262k lanes.  This
// one deals each product to a TEAM of 4 threads (the multiply's `limb_team`):
//  * the convolution: the 99 columns (padded to 104) form 8 ranges of 13;
//    thread t owns ranges t and t + 4, which balances the triangle's work
//    (5 chunks of 13 x 13 multiply-adds a thread, every thread alike); a
//    chunk loads a 25-float window of a and 13 floats of b from the lane's
//    shared-memory rows (zero-padded, so no bounds tests) and keeps 13
//    accumulators in registers;
//  * the carries of the convolution: a pass hands the top column's high
//    part of each range to the next range's owner with one __shfl_sync
//    (thread 3's first range ends at column 51, thread 0's second starts at
//    52), old values throughout, column 98 (the top limb) kept whole;
//  * fold 1 on the tensor cores: the team is one row of an m16n8k32 A tile
//    (lane g of the warp's 8 lanes = row g; rows 8-15 zero), fold inputs
//    48..97 (in [-1, 257] after three carries, whatever the operands) split
//    c = 128 h + l into signed 8-bit planes, the fold weights (integers
//    0..255, u8 B fragments built per block from FOLD_T), two s8 x u8 ->
//    s32 products per k-step; 128 H + L is the integer the float32 fold
//    sums, so the result is bit-equal by construction.  The top column,
//    which the carries keep whole, takes its fold row on the float32 pipe
//    (one FMA a limb), so the kernel is exact wherever the plain version
//    is, not only inside the lazy bound;
//  * the 50 fold outputs stay in the C-fragment layout (thread t holds
//    limbs 8 nt + 2 t + {0, 1}), where the carries hand each pair's top
//    carry on by __shfl_sync and fold 2 runs on the float32 pipe (its two
//    inputs broadcast from thread 0);
//  * registers stay under 96 (__launch_bounds__(128, 5); ptxas: 86, no
//    spills, so 5-6 blocks of 4 warps an SM); a warp of the multiply holds
//    8 lanes, each a 1,040 B region of shared memory (the operands' rows,
//    the carried convolution); the body compiles to ~2,500 SASS
//    instructions a kernel, not the first design's fully unrolled ~10k;
//  * operands come in through cp.async (4-byte copies, consecutive threads
//    on consecutive floats of the warp's contiguous slab of 8 rows) and go
//    out with coalesced stores; a one-row operand is read at lane stride
//    0; the blocks' warps (1, 2 or 4) are the fewest that spread the grid
//    over the SMs (the wrapper picks them: fq_rns_cuda.fit_per_block), and
//    the shared-memory limit is raised once per process (launch_setup).
// fq_limb_pow: the accumulator starts at the carried base (MSB implicit),
// and each later bit squares and, when set, multiplies by the base, which
// stays in shared memory; nothing is re-carried between products.  Its 608
// products a lane (e = Q-2) are serial, at ~14 lanes a launch, so what
// bounds it is the latency of one product, 608 times over.  So the power
// gives each lane a whole warp: the convolution, a thread's longest stage
// in the team body (NCH chunks of 13 x 13 multiply-adds), is dealt over the
// warp's 8 teams, one chunk a thread, and the partial sums meet in shared
// memory (conv_warp); the carries and folds follow the mma fragment layout,
// in which one A row belongs to four threads, so every team runs them
// alike on the same lane (limb_tail), and the tensor cores' 8 rows are 8
// copies of it.  A warp's region is 2,224 B: the rows, the carried
// convolution, the base, the partial sums.

#include "fq_rns_core.cuh"  // i2f_w, MAGIC_F/MAGIC_I, launch_setup

#define NLB 50         // limbs per element
#define NCV 99         // convolution width (2 * NLB - 1)
#define FF 48          // first folded limb: 2^(8 * 48) > Q
#define NF 51          // fold rows (NCV - FF)

#define TEAM 4         // threads per lane (one mma A row)
#define LPW 8          // lanes per warp (the A tile's rows 0-7)
#define CW 13          // convolution columns per range; 2 * TEAM ranges
#define NCH 5          // chunks of CW j-steps per thread
#define HSHIFT 10      // a second range's first chunk starts at j = CW * c - HSHIFT
#define TOP_M 7        // column 98 is entry TOP_M of thread 3's second range
#define NTL 7          // n-tiles of 8 fold outputs (50 -> 56)
#define KSL 2          // k-steps of 32 fold inputs (51 -> 64)
#define NS (2 * NTL)   // fold-layout slots a thread holds: limb 8 * nt + 2 * t + i

// A lane's shared-memory region (floats).
#define APAD 12        // a[i] at A_OFF + APAD + i, i in [-12, 62), zero outside [0, 50)
#define A_OFF 0
#define B_OFF 74       // b[j] at B_OFF + j, j in [0, 55), zero from 50
#define B_LEN 55       // b's row length
#define C_OFF 129      // the carried convolution, columns [0, 104)
#define X_OFF 241      // the power's carried base, B form
#define P_OFF 296      // the power's partial convolutions, [chunk][t][column]
#define NPAD (2 * APAD + B_LEN - NLB)  // zero floats of a region: a's pads, b's tail
#define MUL_RS 260     // region stride of the multiply (= 4 mod 32: see conv_team)
#define POW_RS 556     // region stride of the power (one region a warp)

#define PW_WORDS (NTL * KSL * 2 * 32)   // fold-1 B fragments: [nt][ks][reg][lane]
#define FW_FLOATS (TEAM * NS * 4)       // float weights: [t][slot] (rows 0, 1, NF - 1, 0)
#define TAB_FLOATS (PW_WORDS + FW_FLOATS)

#define MAX_WARPS 4    // warps per block at most (the wrapper picks 1, 2 or 4)
#define MUL_SMEM(w) ((TAB_FLOATS + (w) * LPW * MUL_RS) * 4)
#define POW_SMEM(w) ((TAB_FLOATS + (w) * POW_RS) * 4)

#define LFULL 0xffffffffu  // every lane of the warp

// FOLD_T[k][j] = limb k of 2^(8 * (FF + j)) mod Q, the transpose of
// fq_limb.FOLD_ROWS (the library checks it against the wrapper's at load);
// the blocks build their fold fragments from it.
__device__ float FOLD_T[NLB][NF] = {
    {253, 184, 153, 186, 175, 188, 118, 233, 102, 72, 80, 247, 252, 19, 30, 194, 157, 247, 42, 132, 75, 174, 32, 29, 231, 11, 147, 133, 96, 72, 51, 45, 15, 205, 133, 51, 32, 56, 5, 192, 215, 79, 10, 83, 89, 137, 37, 194, 70, 113, 237},
    {255, 252, 98, 152, 185, 174, 102, 117, 147, 187, 157, 79, 246, 81, 104, 29, 108, 156, 76, 212, 217, 74, 3, 117, 28, 60, 181, 61, 47, 181, 157, 136, 130, 14, 119, 218, 136, 117, 141, 4, 191, 44, 164, 95, 253, 3, 222, 36, 23, 240, 112},
    {2, 71, 14, 168, 233, 253, 227, 125, 186, 160, 192, 166, 83, 57, 136, 166, 43, 117, 200, 114, 222, 43, 128, 59, 142, 103, 83, 219, 136, 60, 215, 197, 206, 181, 52, 153, 15, 165, 197, 205, 45, 198, 119, 166, 176, 31, 51, 28, 52, 80, 3},
    {0, 3, 72, 14, 168, 233, 253, 227, 125, 186, 160, 192, 166, 84, 57, 136, 166, 43, 117, 200, 114, 223, 43, 128, 59, 142, 103, 83, 219, 136, 60, 215, 197, 206, 181, 52, 154, 15, 165, 197, 205, 45, 198, 119, 166, 177, 31, 52, 28, 52, 81},
    {0, 0, 3, 72, 14, 168, 233, 253, 227, 125, 186, 160, 192, 166, 84, 57, 136, 166, 43, 117, 200, 114, 223, 43, 128, 59, 142, 103, 83, 219, 136, 60, 215, 197, 206, 181, 52, 154, 15, 165, 197, 205, 45, 198, 119, 166, 177, 31, 52, 28, 52},
    {0, 0, 0, 3, 72, 14, 168, 233, 253, 227, 125, 186, 160, 192, 166, 84, 57, 136, 166, 43, 117, 200, 114, 223, 43, 128, 59, 142, 103, 83, 219, 136, 60, 215, 197, 206, 181, 52, 154, 15, 165, 197, 205, 45, 198, 119, 166, 177, 31, 52, 28},
    {9, 216, 53, 210, 246, 20, 172, 237, 183, 37, 243, 152, 198, 103, 102, 96, 125, 84, 10, 26, 74, 107, 104, 27, 42, 10, 199, 172, 110, 143, 186, 84, 91, 213, 72, 44, 110, 13, 37, 90, 138, 184, 167, 212, 34, 43, 8, 96, 223, 204, 109},
    {118, 25, 86, 161, 68, 191, 72, 138, 66, 168, 133, 85, 224, 49, 204, 67, 150, 223, 225, 195, 148, 143, 44, 159, 158, 37, 116, 173, 237, 94, 185, 209, 7, 49, 188, 115, 237, 127, 244, 166, 252, 188, 133, 145, 211, 193, 210, 229, 244, 45, 98},
    {2, 177, 40, 143, 228, 124, 234, 91, 195, 77, 172, 141, 88, 23, 94, 255, 78, 157, 2, 0, 203, 215, 187, 90, 179, 219, 56, 147, 234, 248, 122, 218, 11, 49, 80, 216, 158, 5, 192, 40, 199, 1, 250, 135, 212, 238, 232, 4, 241, 36, 61},
    {0, 2, 177, 40, 143, 228, 124, 234, 91, 195, 77, 172, 141, 89, 23, 94, 255, 78, 158, 3, 0, 203, 215, 187, 90, 179, 219, 56, 147, 234, 248, 122, 219, 11, 49, 80, 216, 159, 5, 193, 40, 200, 1, 250, 135, 212, 238, 233, 4, 242, 36},
    {12, 32, 158, 201, 108, 159, 12, 216, 82, 59, 131, 113, 188, 65, 225, 15, 234, 35, 166, 142, 215, 72, 75, 99, 31, 46, 103, 199, 184, 115, 30, 68, 62, 167, 247, 101, 208, 248, 139, 5, 101, 236, 160, 181, 150, 99, 64, 230, 209, 64, 62},
    {196, 109, 105, 39, 118, 29, 46, 64, 39, 157, 38, 207, 33, 228, 68, 10, 168, 55, 22, 76, 20, 112, 116, 59, 112, 167, 0, 33, 157, 3, 27, 78, 28, 67, 96, 158, 144, 219, 8, 140, 210, 59, 96, 198, 0, 160, 243, 105, 9, 251, 197},
    {11, 222, 178, 124, 101, 129, 236, 136, 78, 91, 178, 73, 223, 37, 189, 56, 63, 204, 225, 174, 117, 86, 65, 81, 157, 147, 4, 148, 70, 210, 138, 185, 98, 228, 215, 231, 111, 3, 23, 3, 44, 235, 99, 105, 7, 132, 93, 230, 166, 235, 69},
    {0, 12, 222, 179, 125, 102, 129, 236, 137, 78, 91, 178, 73, 224, 38, 190, 56, 63, 204, 225, 174, 118, 87, 66, 81, 158, 148, 4, 149, 70, 210, 138, 186, 98, 228, 215, 232, 112, 5, 24, 4, 44, 236, 99, 107, 7, 133, 94, 230, 166, 236},
    {244, 224, 112, 198, 111, 109, 62, 37, 132, 169, 142, 55, 162, 149, 88, 46, 50, 20, 231, 220, 13, 102, 246, 203, 222, 125, 234, 168, 132, 181, 18, 134, 198, 238, 118, 176, 87, 200, 132, 5, 116, 64, 84, 56, 199, 143, 155, 141, 118, 170, 90},
    {235, 18, 134, 71, 169, 254, 127, 250, 119, 185, 190, 82, 199, 202, 178, 15, 69, 246, 128, 1, 38, 148, 58, 182, 206, 38, 251, 96, 209, 185, 94, 147, 62, 113, 100, 31, 133, 204, 232, 131, 72, 45, 44, 126, 221, 173, 47, 82, 10, 188, 214},
    {186, 114, 152, 229, 254, 224, 179, 194, 233, 210, 119, 239, 160, 179, 94, 116, 70, 117, 158, 35, 162, 112, 1, 98, 33, 88, 33, 10, 197, 44, 49, 75, 206, 168, 128, 220, 140, 26, 203, 209, 40, 154, 74, 47, 236, 157, 56, 241, 213, 161, 177},
    {88, 12, 124, 174, 64, 217, 246, 91, 177, 115, 112, 129, 101, 74, 24, 136, 8, 80, 119, 22, 84, 27, 154, 131, 70, 184, 20, 124, 170, 80, 36, 218, 107, 178, 2, 119, 5, 240, 98, 48, 142, 227, 78, 143, 158, 208, 51, 97, 182, 126, 211},
    {199, 9, 105, 82, 181, 60, 161, 68, 245, 11, 100, 198, 54, 214, 139, 133, 49, 94, 115, 72, 168, 72, 129, 199, 171, 31, 164, 247, 164, 4, 29, 127, 255, 168, 150, 207, 222, 48, 88, 170, 42, 107, 170, 119, 51, 205, 149, 160, 149, 32, 23},
    {83, 162, 246, 12, 40, 32, 251, 36, 193, 106, 160, 95, 54, 114, 223, 78, 3, 44, 24, 171, 104, 154, 25, 166, 129, 199, 180, 191, 28, 25, 195, 131, 43, 143, 196, 84, 160, 17, 244, 83, 35, 219, 163, 235, 96, 223, 19, 88, 76, 224, 51},
    {87, 131, 78, 236, 66, 228, 199, 153, 157, 155, 90, 166, 212, 22, 18, 236, 135, 9, 111, 40, 45, 187, 0, 214, 126, 74, 34, 167, 232, 246, 85, 174, 216, 248, 130, 1, 186, 76, 136, 59, 253, 48, 193, 60, 223, 222, 180, 32, 108, 133, 9},
    {152, 159, 232, 134, 253, 105, 228, 2, 27, 180, 113, 35, 198, 25, 130, 9, 48, 80, 19, 254, 167, 198, 23, 243, 33, 4, 224, 41, 90, 254, 55, 199, 19, 245, 255, 196, 92, 83, 2, 144, 7, 91, 62, 255, 168, 197, 145, 171, 71, 21, 160},
    {72, 102, 131, 219, 46, 21, 71, 188, 185, 122, 167, 75, 217, 211, 112, 9, 56, 10, 133, 243, 20, 188, 67, 219, 166, 154, 121, 83, 113, 185, 90, 35, 138, 229, 104, 90, 64, 148, 93, 100, 27, 104, 65, 232, 69, 101, 30, 24, 229, 73, 54},
    {95, 55, 9, 221, 232, 244, 101, 119, 178, 153, 7, 197, 116, 162, 233, 119, 130, 86, 163, 194, 117, 235, 62, 35, 160, 194, 251, 237, 8, 81, 53, 148, 22, 221, 89, 228, 220, 199, 111, 248, 208, 114, 79, 110, 39, 143, 243, 37, 141, 41, 79},
    {69, 224, 151, 6, 46, 97, 210, 206, 114, 202, 163, 215, 204, 171, 133, 216, 207, 82, 35, 232, 149, 135, 75, 227, 16, 229, 172, 126, 115, 32, 79, 189, 210, 177, 97, 86, 67, 16, 151, 225, 1, 155, 121, 19, 65, 163, 37, 226, 192, 53, 139},
    {87, 115, 254, 54, 59, 62, 207, 196, 184, 132, 158, 168, 246, 57, 131, 230, 215, 213, 205, 164, 163, 145, 208, 234, 101, 187, 178, 102, 23, 133, 149, 114, 73, 157, 107, 214, 159, 210, 106, 135, 224, 157, 14, 246, 34, 219, 5, 134, 131, 21, 8},
    {82, 15, 230, 213, 229, 48, 28, 241, 175, 237, 51, 149, 107, 133, 239, 211, 150, 206, 65, 128, 135, 195, 101, 246, 238, 121, 211, 245, 246, 76, 250, 175, 196, 193, 224, 224, 170, 224, 139, 156, 151, 255, 35, 106, 155, 161, 124, 85, 157, 150, 116},
    {112, 218, 164, 35, 173, 215, 228, 121, 252, 162, 181, 132, 43, 31, 156, 0, 211, 231, 37, 233, 3, 133, 144, 162, 158, 205, 239, 85, 224, 233, 81, 224, 248, 57, 67, 229, 173, 244, 160, 231, 155, 132, 4, 122, 92, 135, 179, 141, 147, 12, 93},
    {83, 66, 83, 149, 240, 187, 200, 14, 125, 54, 83, 175, 73, 210, 233, 4, 181, 205, 100, 230, 208, 65, 109, 203, 175, 206, 237, 64, 0, 26, 107, 122, 75, 131, 138, 197, 205, 249, 203, 233, 6, 189, 38, 97, 61, 232, 57, 26, 169, 187, 114},
    {88, 155, 160, 96, 229, 194, 31, 110, 73, 177, 126, 92, 37, 148, 217, 11, 235, 190, 116, 43, 193, 62, 14, 146, 171, 230, 220, 152, 44, 52, 184, 185, 60, 41, 45, 39, 146, 215, 225, 39, 161, 107, 18, 21, 27, 113, 34, 91, 136, 160, 234},
    {206, 176, 232, 196, 35, 213, 34, 248, 111, 165, 60, 233, 197, 105, 57, 45, 239, 86, 42, 102, 185, 31, 175, 77, 159, 192, 208, 52, 54, 136, 52, 85, 102, 240, 129, 46, 152, 144, 137, 105, 214, 198, 27, 207, 234, 10, 224, 117, 235, 234, 16},
    {119, 9, 227, 126, 103, 20, 212, 13, 32, 188, 94, 163, 51, 172, 68, 59, 21, 87, 82, 164, 59, 47, 84, 92, 222, 27, 227, 120, 76, 131, 28, 184, 135, 90, 151, 21, 99, 15, 252, 48, 35, 97, 21, 91, 168, 71, 34, 225, 103, 6, 140},
    {109, 187, 113, 51, 10, 195, 36, 198, 187, 120, 70, 166, 139, 196, 1, 197, 188, 94, 246, 184, 143, 65, 144, 35, 65, 62, 94, 208, 0, 164, 218, 77, 48, 204, 71, 238, 118, 89, 73, 113, 179, 39, 59, 49, 56, 174, 71, 163, 45, 217, 17},
    {236, 151, 242, 169, 35, 78, 22, 142, 176, 185, 171, 11, 140, 47, 177, 108, 22, 129, 152, 164, 202, 120, 58, 118, 128, 178, 78, 19, 148, 254, 25, 40, 216, 227, 129, 188, 231, 12, 162, 168, 101, 223, 145, 129, 199, 7, 200, 178, 149, 95, 93},
    {86, 18, 236, 222, 212, 213, 154, 176, 169, 221, 254, 176, 127, 185, 29, 181, 78, 27, 19, 78, 122, 18, 44, 69, 74, 148, 181, 231, 220, 192, 140, 85, 200, 157, 124, 14, 112, 228, 206, 224, 76, 199, 16, 127, 20, 236, 42, 204, 25, 113, 134},
    {162, 143, 35, 184, 253, 51, 76, 118, 137, 37, 168, 229, 136, 47, 22, 56, 238, 53, 239, 149, 40, 208, 3, 191, 142, 171, 234, 0, 4, 88, 173, 189, 221, 144, 233, 105, 255, 78, 137, 85, 139, 77, 95, 57, 24, 135, 206, 69, 181, 159, 117},
    {151, 217, 211, 160, 182, 192, 182, 44, 204, 15, 193, 111, 90, 218, 0, 169, 7, 181, 166, 88, 131, 3, 230, 176, 89, 201, 30, 119, 134, 138, 3, 135, 131, 239, 28, 148, 126, 88, 185, 215, 195, 4, 102, 99, 203, 47, 75, 97, 133, 137, 10},
    {26, 21, 32, 63, 110, 17, 61, 130, 55, 152, 147, 17, 147, 251, 26, 37, 205, 87, 138, 168, 9, 90, 49, 46, 142, 65, 70, 23, 183, 81, 16, 190, 76, 71, 232, 162, 194, 216, 117, 240, 66, 81, 245, 208, 225, 160, 49, 113, 62, 47, 50},
    {7, 197, 92, 113, 255, 101, 0, 201, 65, 229, 221, 169, 197, 19, 13, 2, 183, 226, 76, 2, 79, 118, 17, 240, 20, 119, 150, 17, 228, 101, 49, 253, 243, 197, 18, 199, 89, 64, 207, 183, 167, 53, 230, 51, 88, 248, 246, 25, 121, 142, 7},
    {92, 167, 56, 191, 37, 37, 10, 193, 89, 132, 51, 241, 35, 99, 96, 123, 250, 203, 190, 68, 234, 34, 133, 123, 239, 167, 162, 111, 88, 40, 45, 176, 21, 15, 158, 218, 214, 136, 139, 122, 161, 20, 230, 217, 82, 182, 109, 100, 154, 183, 213},
    {147, 44, 182, 166, 74, 50, 235, 115, 153, 61, 224, 237, 182, 51, 86, 69, 196, 180, 113, 212, 148, 166, 179, 169, 71, 135, 220, 135, 109, 61, 20, 63, 133, 223, 244, 137, 107, 204, 71, 211, 88, 46, 221, 174, 47, 114, 82, 83, 170, 85, 92},
    {228, 1, 110, 139, 194, 135, 222, 195, 227, 145, 211, 141, 30, 116, 171, 202, 86, 114, 154, 243, 231, 252, 133, 119, 26, 103, 146, 18, 192, 101, 117, 21, 46, 178, 20, 44, 105, 38, 181, 83, 7, 59, 153, 143, 253, 52, 213, 198, 227, 212, 253},
    {128, 250, 134, 131, 35, 214, 150, 101, 215, 231, 146, 86, 143, 178, 132, 189, 78, 217, 127, 165, 118, 255, 12, 22, 255, 176, 238, 30, 40, 196, 239, 1, 170, 189, 62, 159, 60, 114, 190, 200, 224, 137, 81, 26, 39, 135, 194, 231, 202, 116, 89},
    {250, 252, 18, 91, 239, 81, 89, 23, 32, 219, 79, 130, 164, 220, 105, 189, 136, 61, 166, 113, 175, 53, 16, 23, 61, 232, 189, 141, 206, 44, 161, 194, 156, 76, 92, 27, 175, 120, 80, 158, 39, 155, 198, 191, 19, 120, 245, 251, 146, 239, 167},
    {195, 89, 127, 239, 6, 73, 194, 56, 157, 135, 56, 155, 135, 145, 251, 59, 58, 212, 76, 132, 20, 156, 210, 112, 120, 53, 242, 90, 154, 53, 239, 236, 180, 160, 233, 31, 183, 43, 248, 165, 21, 197, 212, 94, 150, 170, 205, 199, 229, 73, 200},
    {94, 166, 164, 204, 238, 192, 58, 238, 205, 208, 105, 84, 196, 154, 243, 247, 93, 86, 187, 46, 89, 221, 105, 254, 48, 221, 61, 10, 173, 206, 255, 119, 40, 255, 183, 180, 236, 143, 77, 136, 10, 192, 244, 87, 57, 132, 132, 201, 143, 202, 76},
    {246, 119, 109, 195, 200, 19, 23, 240, 17, 162, 191, 76, 71, 239, 232, 44, 203, 64, 203, 63, 13, 81, 50, 180, 174, 65, 145, 197, 26, 130, 95, 126, 150, 132, 134, 73, 8, 142, 141, 128, 5, 245, 206, 237, 81, 205, 233, 189, 152, 214, 141},
    {21, 5, 21, 24, 20, 16, 7, 20, 4, 1, 2, 1, 20, 16, 18, 4, 2, 13, 11, 3, 25, 16, 17, 7, 22, 7, 11, 22, 4, 10, 12, 21, 15, 11, 10, 16, 9, 24, 19, 12, 2, 22, 0, 24, 10, 14, 18, 4, 17, 5, 12},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
};

// The fold-1 B fragments (u8 weights of fold rows 0..NF-2, m16n8k32 column
// layout: lane 4g + t holds column 8 nt + g, rows 32 ks + 16 reg + 4 t +
// byte) and the float weights of each fold-layout slot (fold rows 0 and 1
// for fold 2, row NF - 1 for the top column), built into shared memory by
// the block.
__device__ __forceinline__ void load_tables(unsigned* PW, float4* FW) {
  for (int w = threadIdx.x; w < PW_WORDS; w += blockDim.x) {
    const int ln = w & 31, reg = (w >> 5) & 1, ks = (w >> 6) % KSL, nt = w / (64 * KSL);
    const int k = 8 * nt + (ln >> 2);
    unsigned word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int f = 32 * ks + 16 * reg + 4 * (ln & 3) + q;
      const unsigned v = (f < NF - 1 && k < NLB) ? (unsigned)FOLD_T[k][f] : 0u;
      word |= v << (8 * q);
    }
    PW[w] = word;
  }
  for (int s = threadIdx.x; s < TEAM * NS; s += blockDim.x) {
    const int t = s / NS, slot = s - t * NS;
    const int k = 8 * (slot >> 1) + 2 * t + (slot & 1);
    FW[s] = k < NLB ? make_float4(FOLD_T[k][0], FOLD_T[k][1], FOLD_T[k][NF - 1], 0.f)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// D += A.B for one m16n8k32 tile: A 16x32 s8 (row; rows 8-15 zero), B
// 32x8 u8 (col).
__device__ __forceinline__ void mma_s8u8(int (&d)[4], unsigned a0, unsigned a2, unsigned b0,
                                         unsigned b1) {
  const unsigned z = 0u;
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(z), "r"(a2), "r"(z), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int team_lane(int lane, int s) { return (lane & ~(TEAM - 1)) | s; }

// floor(x * inv) for a power of two inv and |x * inv| < 2^22: floor_w of
// fq_rns_core.cuh with the scaling folded in.  The FMA's exact x * inv +
// MAGIC_F, rounded down once, lands on floor(x * inv) + MAGIC_F.
__device__ __forceinline__ float floor_div(float x, float inv) {
  return __fmaf_rd(x, inv, MAGIC_F) - MAGIC_F;
}

// Limb of fold-layout slot s of team thread t (the C-fragment column).
__device__ __forceinline__ int p_limb(int s, int t) { return 8 * (s >> 1) + 2 * t + (s & 1); }

__device__ __forceinline__ void read_p(float (&x)[NS], const float* row, int t) {
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int k = p_limb(s, t);
    x[s] = k < NLB ? row[k] : 0.f;
  }
}

__device__ __forceinline__ void write_p(float* row, const float (&x)[NS], int t) {
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int k = p_limb(s, t);
    if (k < NLB) row[k] = x[s];
  }
}

// One carry pass (a pass of fq_limb.carry3: x[i] <- lo(x[i]) + hi(x[i-1])
// over the old values, the top limb kept whole) over 50 limbs in the fold
// layout.  Within a slot pair the carry stays in the thread; a pair's top
// carry goes to the next thread (thread 3's to thread 0's next pair).
__device__ __forceinline__ void carry_p(float (&x)[NS], int t, int lane) {
  float h[NS], r[NTL];
  const int src = team_lane(lane, (t + TEAM - 1) & (TEAM - 1));
#pragma unroll
  for (int s = 0; s < NS; ++s) h[s] = floor_div(x[s], 1.f / 256.f);
  if (t == 0) h[NS - 1] = 0.f;  // limb 49, the top, is kept whole
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) r[nt] = __shfl_sync(LFULL, h[2 * nt + 1], src);
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) {
    const float cin = t ? r[nt] : (nt ? r[nt - 1] : 0.f);
    x[2 * nt + 1] = fmaf(-256.f, h[2 * nt + 1], x[2 * nt + 1]) + h[2 * nt];
    x[2 * nt] = fmaf(-256.f, h[2 * nt], x[2 * nt]) + cin;
  }
}

__device__ __forceinline__ void carry3_p(float (&x)[NS], int t, int lane) {
  carry_p(x, t, lane);
  carry_p(x, t, lane);
  carry_p(x, t, lane);
}

// One carry pass over the convolution's columns as the team deals them:
// thread t holds columns CW t + m (lo) and CW (t + TEAM) + m (hi).
__device__ __forceinline__ void carry_cols(float (&lo)[CW], float (&hi)[CW], int t, int lane) {
  float hl[CW], hh[CW];
#pragma unroll
  for (int m = 0; m < CW; ++m) {
    hl[m] = floor_div(lo[m], 1.f / 256.f);
    hh[m] = floor_div(hi[m], 1.f / 256.f);
  }
  if (t == TEAM - 1) hh[TOP_M] = 0.f;  // column 98, the top, is kept whole
  const int src = team_lane(lane, (t + TEAM - 1) & (TEAM - 1));
  const float rl = __shfl_sync(LFULL, hl[CW - 1], src);
  const float rh = __shfl_sync(LFULL, hh[CW - 1], src);
  const float cl = t ? rl : 0.f;  // column 0 takes no carry
  const float ch = t ? rh : rl;   // column 52 takes thread 3's column 51
#pragma unroll
  for (int m = CW - 1; m >= 0; --m) {
    lo[m] = fmaf(-256.f, hl[m], lo[m]) + (m ? hl[m - 1] : cl);
    hi[m] = fmaf(-256.f, hh[m], hi[m]) + (m ? hh[m - 1] : ch);
  }
}

// The convolution c[k] = sum_{i+j=k} a[i] b[j] of the team's lane, dealt as
// carry_cols holds it.  A: a's padded row (a[i] at A[APAD + i]); B: b's row.
// Thread t runs NCH chunks: chunks 0..t cover its first range (k0 = CW t,
// j from CW c), the rest its second (k0 = CW (t + TEAM), j from CW c -
// HSHIFT), 13 j-steps each; out-of-range terms meet the rows' zero pads.
// conv_chunk adds chunk c of thread t into acc.
__device__ __forceinline__ void conv_chunk(const float* A, const float* B, int t, int c,
                                           float (&acc)[CW]) {
  const bool first = c <= t;
  const int k0 = first ? CW * t : CW * (t + TEAM);
  const int j0 = first ? CW * c : CW * c - HSHIFT;
  const float* w = A + APAD + k0 - j0 - (CW - 1);  // w[e] = a[k0 - j0 - 12 + e]
  float win[2 * CW - 1];
#pragma unroll
  for (int e = 0; e < 2 * CW - 1; ++e) win[e] = w[e];
#pragma unroll
  for (int d = 0; d < CW; ++d) {
    const float bj = B[j0 + d];
#pragma unroll
    for (int m = 0; m < CW; ++m) acc[m] = fmaf(win[CW - 1 + m - d], bj, acc[m]);
  }
}

// The multiply's convolution: thread t runs its NCH chunks in turn.  With a
// region stride of 4 mod 32, the 32 threads' window loads of a chunk fall
// in distinct banks whenever the team's threads are all in their first or
// all in their second range.
__device__ __forceinline__ void conv_team(const float* A, const float* B, int t,
                                          float (&lo)[CW], float (&hi)[CW]) {
  float acc[CW];
#pragma unroll
  for (int m = 0; m < CW; ++m) acc[m] = lo[m] = 0.f;
#pragma unroll 1
  for (int c = 0; c < NCH; ++c) {
    conv_chunk(A, B, t, c, acc);
    if (c == t) {  // the first range is done: keep it, start the second
#pragma unroll
      for (int m = 0; m < CW; ++m) {
        lo[m] = acc[m];
        acc[m] = 0.f;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < CW; ++m) hi[m] = acc[m];
}

// The power's convolution, one lane a warp: the warp's 8 teams all hold
// the lane, and team g < NCH runs chunk g of every thread's schedule
// (thread 4 g + t: chunk g of thread t), so each thread runs one chunk, not
// NCH.  The partial sums meet in P ([chunk][t][column], stride CW: the
// writes fall in distinct banks); every team then sums them into the
// ranges of conv_team (chunks 0..t into lo, the rest into hi).
__device__ __forceinline__ void conv_warp(const float* A, const float* B, float* P, int t,
                                          int g, float (&lo)[CW], float (&hi)[CW]) {
  if (g < NCH) {
    float acc[CW];
#pragma unroll
    for (int m = 0; m < CW; ++m) acc[m] = 0.f;
    conv_chunk(A, B, t, g, acc);
#pragma unroll
    for (int m = 0; m < CW; ++m) P[(g * TEAM + t) * CW + m] = acc[m];
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < CW; ++m) lo[m] = hi[m] = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int m = 0; m < CW; ++m) {
      const float v = P[(c * TEAM + t) * CW + m];
      if (c <= t)
        lo[m] += v;
      else
        hi[m] += v;
    }
  }
}

// The team body after the convolution: the carried convolution's columns
// (lo, hi as conv_team deals them) -> a*b mod Q as a lazy limb vector
// (fq_pallas._mul_core) for the team's lane, in the fold layout.  R: the
// lane's region.  Every thread of the warp calls it together.  On return
// the rows at A_OFF and B_OFF are spent (every thread has passed the
// convolution), so the caller may write the result there.
__device__ __forceinline__ void limb_tail(float* R, float (&lo)[CW], float (&hi)[CW],
                                          const unsigned* PW, const float4* FW, int t, int lane,
                                          float (&o)[NS]) {
  carry_cols(lo, hi, t, lane);
  carry_cols(lo, hi, t, lane);
  carry_cols(lo, hi, t, lane);
  float* C = R + C_OFF;
#pragma unroll
  for (int m = 0; m < CW; ++m) {
    C[CW * t + m] = lo[m];
    C[CW * (t + TEAM) + m] = hi[m];
  }
  __syncwarp();

  // Fold 1: the limbs >= FF through the fold rows.  Columns 48..97 (in
  // [-1, 257] after the carries, whatever the operands) on the tensor
  // cores, the top column (kept whole, so unbounded by the carries) on the
  // float32 pipe.  A fragments: this thread's fold inputs f = 32 ks + 16 reg
  // + 4 t + q < NF - 1, split c = 128 h + l (l in [0, 128), h = floor(c /
  // 128) in [-1, 2]).
  unsigned al[KSL][2], ah[KSL][2];
#pragma unroll
  for (int ks = 0; ks < KSL; ++ks) {
#pragma unroll
    for (int reg = 0; reg < 2; ++reg) {
      unsigned wl = 0, wh = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int f = 32 * ks + 16 * reg + 4 * t + q;
        const float v = f < NF - 1 ? C[FF + f] : 0.f;
        const float hm = __fmaf_rd(v, 1.f / 128.f, MAGIC_F);  // floor(v / 128) + MAGIC_F
        const float l = fmaf(-128.f, hm - MAGIC_F, v);
        const int hb = __float_as_int(hm) - MAGIC_I;
        const int lb = __float_as_int(l + MAGIC_F) - MAGIC_I;
        wl |= (unsigned)(lb & 0xff) << (8 * q);
        wh |= (unsigned)(hb & 0xff) << (8 * q);
      }
      al[ks][reg] = wl;
      ah[ks][reg] = wh;
    }
  }
  const float top = C[NCV - 1];
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) {
    int L[4] = {0, 0, 0, 0}, H[4] = {0, 0, 0, 0};
#pragma unroll
    for (int ks = 0; ks < KSL; ++ks) {
      const unsigned b0 = PW[((nt * KSL + ks) * 2 + 0) * 32 + lane];
      const unsigned b1 = PW[((nt * KSL + ks) * 2 + 1) * 32 + lane];
      mma_s8u8(L, al[ks][0], al[ks][1], b0, b1);
      mma_s8u8(H, ah[ks][0], ah[ks][1], b0, b1);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = 8 * nt + 2 * t + i;
      const float wt = FW[t * NS + 2 * nt + i].z;
      o[2 * nt + i] = fmaf(top, wt, i2f_w(128 * H[i] + L[i])) + (k < FF ? C[k] : 0.f);
    }
  }
  carry3_p(o, t, lane);

  // Fold 2 (float32 pipe): the two limbs >= FF, held by thread 0.
  const int t0 = team_lane(lane, 0);
  const float h0 = __shfl_sync(LFULL, o[NS - 2], t0);
  const float h1 = __shfl_sync(LFULL, o[NS - 1], t0);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const float4 w = FW[t * NS + s];
    const float base = p_limb(s, t) < FF ? o[s] : 0.f;
    o[s] = fmaf(h1, w.y, fmaf(h0, w.x, base));
  }
  carry3_p(o, t, lane);
}

// The multiply's team body: a's carried row at R + A_OFF, b's at R + B_OFF.
__device__ __forceinline__ void limb_team(float* R, const unsigned* PW, const float4* FW, int t,
                                          int lane, float (&o)[NS]) {
  float lo[CW], hi[CW];
  conv_team(R + A_OFF, R + B_OFF, t, lo, hi);
  limb_tail(R, lo, hi, PW, FW, t, lane, o);
}

// -- the warps' rows ------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Zero the pads of the warp's lpw regions (stride rs).
__device__ __forceinline__ void zero_pads(float* regs, int rs, int lpw, int lane) {
  for (int e = lane; e < lpw * NPAD; e += 32) {
    const int r = e / NPAD, p = e - r * NPAD;
    const int off = p < APAD ? A_OFF + p
                    : p < 2 * APAD ? A_OFF + APAD + NLB + (p - APAD)
                                   : B_OFF + NLB + (p - 2 * APAD);
    regs[r * rs + off] = 0.f;
  }
}

// Start copying the warp's lpw rows of src (row l at src + l * s: s = 50,
// or 0 for a one-row operand) into the regions at offset off; rows past n
// are zero.  Consecutive threads copy consecutive floats.
__device__ __forceinline__ void stage_rows(float* regs, int rs, int off, const float* src,
                                           int s, long l0, int n, int lpw, int lane) {
  for (int e = lane; e < lpw * NLB; e += 32) {
    const int r = e / NLB, k = e - r * NLB;
    float* dst = regs + r * rs + off + k;
    if (l0 + r < n)
      cp_async4(dst, src + (l0 + r) * s + k);
    else
      *dst = 0.f;
  }
}

// Store the warp's valid rows from the regions at offset off to out.
__device__ __forceinline__ void store_rows(float* out, const float* regs, int rs, int off,
                                           long l0, int n, int lpw, int lane) {
  const int cnt = (int)min((long)lpw, (long)n - l0);
  for (int e = lane; e < cnt * NLB; e += 32) {
    const int r = e / NLB, k = e - r * NLB;
    out[(l0 + r) * NLB + k] = regs[r * rs + off + k];
  }
}

// Warp w of block b owns lanes [8 g, 8 g + 8), g = b * warps + w; team
// (lane / 4) of the warp owns lane 8 g + lane / 4.  Lane l reads row l * sa
// of a and l * sb of b (sa, sb: 50, or 0 for a one-row operand).
__global__ void __launch_bounds__(32 * MAX_WARPS, 5)
fq_limb_mul_kernel(const float* __restrict__ a, int sa, const float* __restrict__ b, int sb,
                   float* __restrict__ out, int n) {
  extern __shared__ __align__(16) float smem[];
  unsigned* PW = reinterpret_cast<unsigned*>(smem);
  float4* FW = reinterpret_cast<float4*>(smem + PW_WORDS);
  load_tables(PW, FW);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & (TEAM - 1);
  const long l0 = ((long)blockIdx.x * (blockDim.x >> 5) + warp) * LPW;
  if (l0 >= n) return;  // warp-uniform; no block barrier follows
  float* regs = smem + TAB_FLOATS + warp * LPW * MUL_RS;
  float* R = regs + (lane / TEAM) * MUL_RS;
  zero_pads(regs, MUL_RS, LPW, lane);
  stage_rows(regs, MUL_RS, A_OFF + APAD, a, sa, l0, n, LPW, lane);
  stage_rows(regs, MUL_RS, B_OFF, b, sb, l0, n, LPW, lane);
  cp_async_wait();
  __syncwarp();
  // carry both operands in place (each thread its own slots); the two
  // carries are independent, so their passes interleave
  float x[NS], y[NS];
  read_p(x, R + A_OFF + APAD, t);
  read_p(y, R + B_OFF, t);
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    carry_p(x, t, lane);
    carry_p(y, t, lane);
  }
  write_p(R + A_OFF + APAD, x, t);
  write_p(R + B_OFF, y, t);
  __syncwarp();
  limb_team(R, PW, FW, t, lane, x);
  write_p(R + A_OFF + APAD, x, t);
  __syncwarp();
  store_rows(out, regs, MUL_RS, A_OFF + APAD, l0, n, LPW, lane);
}

// Warp w of block b owns lane b * warps + w, and each of its 8 teams holds
// that lane: the convolution is dealt over the teams (conv_warp), the rest
// of each product runs in every team alike (their mma rows are the same
// lane), so one product takes one chunk of convolution a thread, not NCH.
// The base stays carried at X_OFF; the accumulator's row is written at
// A_OFF and B_OFF after every product.
__global__ void __launch_bounds__(32 * MAX_WARPS, 4)
fq_limb_pow_kernel(const float* __restrict__ x, const int* __restrict__ bits, int nbits,
                   float* __restrict__ out, int n) {
  extern __shared__ __align__(16) float smem[];
  unsigned* PW = reinterpret_cast<unsigned*>(smem);
  float4* FW = reinterpret_cast<float4*>(smem + PW_WORDS);
  load_tables(PW, FW);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & (TEAM - 1);
  const int g = lane / TEAM;
  const long l0 = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (l0 >= n) return;  // warp-uniform; no block barrier follows
  float* R = smem + TAB_FLOATS + warp * POW_RS;
  zero_pads(R, POW_RS, 1, lane);
  // the base's row is read as b is: zero after limb 49
  if (lane < B_LEN - NLB) R[X_OFF + NLB + lane] = 0.f;
  stage_rows(R, POW_RS, A_OFF + APAD, x, NLB, l0, n, 1, lane);
  cp_async_wait();
  __syncwarp();
  float acc[NS];
  read_p(acc, R + A_OFF + APAD, t);
  carry3_p(acc, t, lane);
  write_p(R + X_OFF, acc, t);
  write_p(R + A_OFF + APAD, acc, t);
  write_p(R + B_OFF, acc, t);
  __syncwarp();
  // MSB implicit: the accumulator starts at the carried base and nothing is
  // re-carried between products.  The bit schedule is the same for every
  // lane, so the multiply is a branch rather than the reference's blend;
  // one call site walks the schedule.
  int i = 1;
  bool square = true;
#pragma unroll 1
  while (i < nbits) {
    float lo[CW], hi[CW];
    conv_warp(R + A_OFF, R + (square ? B_OFF : X_OFF), R + P_OFF, t, g, lo, hi);
    limb_tail(R, lo, hi, PW, FW, t, lane, acc);
    write_p(R + A_OFF + APAD, acc, t);
    write_p(R + B_OFF, acc, t);
    __syncwarp();
    if (square && __ldg(bits + i)) {
      square = false;
    } else {
      square = true;
      ++i;
    }
  }
  store_rows(out, R, POW_RS, A_OFF + APAD, l0, n, 1, lane);
}

// Launch set-up, once per process and device (launch_setup).
static LaunchSetup g_mul[MAX_DEVICES], g_pow[MAX_DEVICES];

static const LaunchSetup& mul_setup() {
  return launch_setup(g_mul, fq_limb_mul_kernel, 32 * MAX_WARPS, MUL_SMEM(MAX_WARPS));
}

static const LaunchSetup& pow_setup() {
  return launch_setup(g_pow, fq_limb_pow_kernel, 32 * MAX_WARPS, POW_SMEM(MAX_WARPS));
}

extern "C" {

int fq_limb_fold_floats(void) { return NLB * NF; }

// Copies the fold table the kernels use into `host` (NLB * NF floats).
int fq_limb_read_fold(float* host) {
  return (int)cudaMemcpyFromSymbol(host, FOLD_T, sizeof(FOLD_T));
}

// Blocks of 4 warps resident on one SM, or a negative CUDA error code.
int fq_limb_mul_blocks_per_sm(void) {
  const LaunchSetup& s = mul_setup();
  return s.rc ? -s.rc : s.per_sm;
}

int fq_limb_pow_blocks_per_sm(void) {
  const LaunchSetup& s = pow_setup();
  return s.rc ? -s.rc : s.per_sm;
}

// Each launcher returns cudaGetLastError() after its launch (0 = launched).
// warps: warps per block (1, 2 or 4), 8 lanes each (the multiply) or one
// (the power).
int fq_limb_mul(const float* a, int sa, const float* b, int sb, float* out, int n, int warps,
                void* stream) {
  if (n <= 0) return 0;
  if (warps < 1 || warps > MAX_WARPS) return (int)cudaErrorInvalidValue;
  const int rc = mul_setup().rc;
  if (rc) return rc;
  const long groups = ((long)n + LPW - 1) / LPW;
  const unsigned grid = (unsigned)((groups + warps - 1) / warps);
  fq_limb_mul_kernel<<<grid, 32 * warps, MUL_SMEM(warps), (cudaStream_t)stream>>>(
      a, sa, b, sb, out, n);
  return (int)cudaGetLastError();
}

int fq_limb_pow(const float* x, const int* bits, int nbits, float* out, int n, int warps,
                void* stream) {
  if (n <= 0) return 0;
  if (warps < 1 || warps > MAX_WARPS) return (int)cudaErrorInvalidValue;
  const int rc = pow_setup().rc;
  if (rc) return rc;
  const unsigned grid = (unsigned)(((long)n + warps - 1) / warps);
  fq_limb_pow_kernel<<<grid, 32 * warps, POW_SMEM(warps), (cudaStream_t)stream>>>(
      x, bits, nbits, out, n);
  return (int)cudaGetLastError();
}

const char* fq_limb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
