/* GF(2^8) Reed-Solomon matmul kernel (host side).
 *
 * Native equivalent of the reference's `reed-solomon-erasure` Rust crate
 * (SURVEY.md 2.2): the host-path hot op behind broadcast encode/decode.
 * The port keeps its erasure plane on the host: this file serves the
 * array engine's shard work (a copy of the JAX package's
 * hbbft_tpu/native/gf256_kernel.c).
 *
 * Strategy: the classic SIMD nibble-split.  For multiplier constant c the
 * product c*x factors through x's nibbles:  c*x = LO_c[x & 15] ^ HI_c[x >> 4]
 * (GF addition is XOR and the nibble decomposition is linear).  With AVX2 the
 * two 16-entry tables live in a 256-bit register and PSHUFB resolves 32 bytes
 * per shuffle.  Scalar fallback uses a 64KB full product table.
 *
 * Field: poly 0x11D, generator 2 - matching crypto/erasure.py.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

#define POLY 0x11D

static uint8_t MUL[256][256];
static uint8_t NIB_LO[256][16]; /* NIB_LO[c][n] = c * n        */
static uint8_t NIB_HI[256][16]; /* NIB_HI[c][n] = c * (n << 4) */
static int READY = 0;

static uint8_t gf_mul_slow(uint32_t a, uint32_t b) {
    uint32_t r = 0;
    while (b) {
        if (b & 1) r ^= a;
        a <<= 1;
        if (a & 0x100) a ^= POLY;
        b >>= 1;
    }
    return (uint8_t)r;
}

#if defined(__GFNI__) && defined(__AVX2__)
/* GFNI: c*x is GF(2)-linear in x, so each constant c is an 8x8 bit
 * matrix and VGF2P8AFFINEQB resolves 32 products per instruction.  The
 * qword packing convention is DERIVED at init (four candidate packings
 * probed against the MUL table) and the whole path self-disables on any
 * mismatch — correctness never rests on reading the SDM right. */
static uint64_t AFF[256];
static int GFNI_OK = 0;

static uint64_t aff_pack(uint8_t c, int variant) {
    /* row i bit j = bit i of (c * 2^j); the qword packing convention
     * (column bit order x row byte order) is probed as 4 variants —
     * on this ISA the working one is bit j unreversed, row i at qword
     * byte 7-i, but the self-test decides, not the comment. */
    int bo = variant & 1, ro = variant >> 1;
    uint64_t q = 0;
    for (int i = 0; i < 8; i++) {
        uint8_t row = 0;
        for (int j = 0; j < 8; j++)
            if ((MUL[c][1u << j] >> i) & 1)
                row |= (uint8_t)(1u << (bo ? (7 - j) : j));
        int byte_pos = ro ? (7 - i) : i;
        q |= (uint64_t)row << (8 * byte_pos);
    }
    return q;
}

static int gfni_selftest(int variant) {
    for (int c = 1; c < 256; c += 37) {
        __m128i A = _mm_set1_epi64x((long long)aff_pack((uint8_t)c, variant));
        uint8_t xs[16], got[16];
        for (int t = 0; t < 16; t++) xs[t] = (uint8_t)(t * 17 + 3);
        __m128i x = _mm_loadu_si128((const __m128i *)xs);
        __m128i r = _mm_gf2p8affine_epi64_epi8(x, A, 0);
        _mm_storeu_si128((__m128i *)got, r);
        for (int t = 0; t < 16; t++)
            if (got[t] != MUL[c][xs[t]]) return 0;
    }
    return 1;
}
#endif

void gf256_init(void) {
    if (READY) return;
    for (int a = 0; a < 256; a++)
        for (int b = 0; b < 256; b++)
            MUL[a][b] = gf_mul_slow((uint32_t)a, (uint32_t)b);
    for (int c = 0; c < 256; c++)
        for (int n = 0; n < 16; n++) {
            NIB_LO[c][n] = MUL[c][n];
            NIB_HI[c][n] = MUL[c][n << 4];
        }
#if defined(__GFNI__) && defined(__AVX2__)
    for (int variant = 0; variant < 4 && !GFNI_OK; variant++) {
        if (gfni_selftest(variant)) {
            for (int c = 0; c < 256; c++)
                AFF[c] = aff_pack((uint8_t)c, variant);
            GFNI_OK = 1;
        }
    }
#endif
    READY = 1;
}

/* dst[0..len) ^= c * src[0..len) */
static void mul_acc_row(uint8_t *dst, const uint8_t *src, uint8_t c, size_t len) {
    size_t t = 0;
    if (c == 0) return;
#if defined(__AVX2__)
    if (len >= 32) {
        const __m128i lo128 = _mm_loadu_si128((const __m128i *)NIB_LO[c]);
        const __m128i hi128 = _mm_loadu_si128((const __m128i *)NIB_HI[c]);
        const __m256i lo_tbl = _mm256_broadcastsi128_si256(lo128);
        const __m256i hi_tbl = _mm256_broadcastsi128_si256(hi128);
        const __m256i mask = _mm256_set1_epi8(0x0F);
        for (; t + 32 <= len; t += 32) {
            __m256i x = _mm256_loadu_si256((const __m256i *)(src + t));
            __m256i xl = _mm256_and_si256(x, mask);
            __m256i xh = _mm256_and_si256(_mm256_srli_epi16(x, 4), mask);
            __m256i p = _mm256_xor_si256(
                _mm256_shuffle_epi8(lo_tbl, xl),
                _mm256_shuffle_epi8(hi_tbl, xh));
            __m256i d = _mm256_loadu_si256((const __m256i *)(dst + t));
            _mm256_storeu_si256((__m256i *)(dst + t), _mm256_xor_si256(d, p));
        }
    }
#endif
    {
        const uint8_t *row = MUL[c];
        for (; t < len; t++) dst[t] ^= row[src[t]];
    }
}

#if defined(__AVX2__)
/* dst ^= c0*s0 ^ c1*s1 ^ c2*s2 ^ c3*s3: four coefficient rows combined
 * per dst read-modify-write — the inner loop is L1-bandwidth bound and
 * this cuts the dst stream 4x vs four mul_acc_row passes. */
static void mul4_acc_row(uint8_t *dst, const uint8_t *const s[4],
                         const uint8_t c[4], size_t len) {
    size_t t = 0;
#if defined(__GFNI__)
    if (GFNI_OK) {
        __m256i A[4];
        for (int q = 0; q < 4; q++)
            A[q] = _mm256_set1_epi64x((long long)AFF[c[q]]);
        for (; t + 32 <= len; t += 32) {
            __m256i acc = _mm256_loadu_si256((const __m256i *)(dst + t));
            for (int q = 0; q < 4; q++) {
                __m256i x = _mm256_loadu_si256((const __m256i *)(s[q] + t));
                acc = _mm256_xor_si256(
                    acc, _mm256_gf2p8affine_epi64_epi8(x, A[q], 0));
            }
            _mm256_storeu_si256((__m256i *)(dst + t), acc);
        }
    }
#endif
    if (t + 32 <= len) {  /* non-GFNI main loop (tables built lazily) */
        const __m256i mask = _mm256_set1_epi8(0x0F);
        __m256i lo[4], hi[4];
        for (int q = 0; q < 4; q++) {
            lo[q] = _mm256_broadcastsi128_si256(
                _mm_loadu_si128((const __m128i *)NIB_LO[c[q]]));
            hi[q] = _mm256_broadcastsi128_si256(
                _mm_loadu_si128((const __m128i *)NIB_HI[c[q]]));
        }
        for (; t + 32 <= len; t += 32) {
            __m256i acc = _mm256_loadu_si256((const __m256i *)(dst + t));
            for (int q = 0; q < 4; q++) {
                __m256i x = _mm256_loadu_si256((const __m256i *)(s[q] + t));
                __m256i xl = _mm256_and_si256(x, mask);
                __m256i xh = _mm256_and_si256(_mm256_srli_epi16(x, 4), mask);
                acc = _mm256_xor_si256(
                    acc,
                    _mm256_xor_si256(_mm256_shuffle_epi8(lo[q], xl),
                                     _mm256_shuffle_epi8(hi[q], xh)));
            }
            _mm256_storeu_si256((__m256i *)(dst + t), acc);
        }
    }
    for (; t < len; t++) {
        uint8_t v = dst[t];
        for (int q = 0; q < 4; q++) v ^= MUL[c[q]][s[q][t]];
        dst[t] = v;
    }
}
#endif

/* out(r x L) = m(r x k) * x(k x L) over GF(2^8).
 *
 * Cache-blocked over the shard axis: at the N=100 broadcast shape
 * (66 x 34 over 16 KB shards) the full working set is ~1.6 MB and the
 * naive row-major loop re-misses every out row per j; 4 KB blocks keep
 * the touched out+x stripes (~400 KB) L2-resident across the whole
 * (i, j) sweep.  Within a block, coefficients are consumed four at a
 * time (mul4_acc_row). */
#define GF_BLOCK 4096

void gf256_matmul(const uint8_t *m, const uint8_t *x, uint8_t *out,
                  long rows, long cols, long len) {
    if (!READY) gf256_init();
    memset(out, 0, (size_t)rows * (size_t)len);
    for (long b = 0; b < len; b += GF_BLOCK) {
        size_t blen = (size_t)((len - b < GF_BLOCK) ? (len - b) : GF_BLOCK);
        for (long i = 0; i < rows; i++) {
            uint8_t *drow = out + (size_t)i * len + b;
            long j = 0;
#if defined(__AVX2__)
            for (; j + 4 <= cols; j += 4) {
                const uint8_t *s[4];
                uint8_t c[4];
                int live = 0;
                for (int q = 0; q < 4; q++) {
                    c[q] = m[(size_t)i * cols + j + q];
                    s[q] = x + (size_t)(j + q) * len + b;
                    live |= c[q];
                }
                if (live) mul4_acc_row(drow, s, c, blen);
            }
#endif
            for (; j < cols; j++)
                mul_acc_row(drow, x + (size_t)j * len + b,
                            m[(size_t)i * cols + j], blen);
        }
    }
}

/* Elementwise c = a * b over GF(2^8). */
void gf256_mul_elem(const uint8_t *a, const uint8_t *b, uint8_t *c, long n) {
    if (!READY) gf256_init();
    for (long i = 0; i < n; i++) c[i] = MUL[a[i]][b[i]];
}
