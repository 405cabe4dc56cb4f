/* hash-to-G2 host kernel: the coin's and the DKG's host hash made native.
 *
 * Mirrors hbbft_tpu_torch/crypto/bls381.py's hash_to_g2 EXACTLY — same
 * try-and-increment schedule (sha256(tag + ctr_be4 + plane + data) x2
 * per Fq coordinate), same complex-method Fq2 square root with the same
 * deterministic root choice (lexicographic tuple min of y and -y over
 * CANONICAL integers), same Budroni-Pintore cofactor clearing
 * [u^2-u-1]P + [u-1]psi(P) + psi^2(2P) — so native and pure paths are
 * interchangeable point-for-point (the Python loader golden-checks this
 * at first use and falls back on any mismatch).
 *
 * Why: the pure path spends most of its time in the affine (one
 * inversion per operation) cofactor clearing, and a coin round hashes a
 * document for every BA instance, the DKG 2(N^2 + N^3) of them per era
 * change.  Here: Montgomery 6x64 Fq (schoolbook mul12 + REDC), jacobian
 * a=0 EC over Fq2 (no per-op inversions), one Fq2 inversion per point at
 * the end.
 *
 * This is the JAX package's hbbft_tpu/native/hashg2_kernel.c, copied so
 * that the port imports nothing of that package; the two compute the
 * same points.
 */

#include <stdint.h>
#include <string.h>

typedef uint64_t u64;
typedef __uint128_t u128;

/* ---------------------------------------------------------------- SHA-256 */

static const uint32_t SHA_K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

#define ROR(x, n) (((x) >> (n)) | ((x) << (32 - (n))))

static void sha256(const unsigned char *data, long len, unsigned char out[32]) {
    uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                     0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    unsigned char block[64];
    long full = len / 64, rem = len % 64, b;
    for (b = 0; b <= full; b++) {
        long n = (b < full) ? 64 : rem;
        const unsigned char *src = data + b * 64;
        uint32_t w[64];
        int i;
        int last = 0;
        if (b == full) {
            memcpy(block, src, (size_t)n);
            block[n] = 0x80;
            if (n + 9 <= 64) {
                memset(block + n + 1, 0, (size_t)(64 - n - 9));
                u64 bits = (u64)len * 8;
                for (i = 0; i < 8; i++)
                    block[56 + i] = (unsigned char)(bits >> (56 - 8 * i));
                last = 1;
            } else {
                memset(block + n + 1, 0, (size_t)(64 - n - 1));
            }
            src = block;
        }
        for (;;) {
            for (i = 0; i < 16; i++)
                w[i] = ((uint32_t)src[4 * i] << 24) | ((uint32_t)src[4 * i + 1] << 16) |
                       ((uint32_t)src[4 * i + 2] << 8) | src[4 * i + 3];
            for (i = 16; i < 64; i++) {
                uint32_t s0 = ROR(w[i - 15], 7) ^ ROR(w[i - 15], 18) ^ (w[i - 15] >> 3);
                uint32_t s1 = ROR(w[i - 2], 17) ^ ROR(w[i - 2], 19) ^ (w[i - 2] >> 10);
                w[i] = w[i - 16] + s0 + w[i - 7] + s1;
            }
            uint32_t a = h[0], bb = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
                     g = h[6], hh = h[7];
            for (i = 0; i < 64; i++) {
                uint32_t S1 = ROR(e, 6) ^ ROR(e, 11) ^ ROR(e, 25);
                uint32_t ch = (e & f) ^ (~e & g);
                uint32_t t1 = hh + S1 + ch + SHA_K[i] + w[i];
                uint32_t S0 = ROR(a, 2) ^ ROR(a, 13) ^ ROR(a, 22);
                uint32_t mj = (a & bb) ^ (a & c) ^ (bb & c);
                uint32_t t2 = S0 + mj;
                hh = g; g = f; f = e; e = d + t1;
                d = c; c = bb; bb = a; a = t1 + t2;
            }
            h[0] += a; h[1] += bb; h[2] += c; h[3] += d;
            h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
            if (b < full || last) break;
            /* padding spilled into an extra block */
            memset(block, 0, 56);
            u64 bits = (u64)len * 8;
            for (i = 0; i < 8; i++)
                block[56 + i] = (unsigned char)(bits >> (56 - 8 * i));
            src = block;
            last = 1;
        }
    }
    for (int i = 0; i < 8; i++) {
        out[4 * i] = (unsigned char)(h[i] >> 24);
        out[4 * i + 1] = (unsigned char)(h[i] >> 16);
        out[4 * i + 2] = (unsigned char)(h[i] >> 8);
        out[4 * i + 3] = (unsigned char)h[i];
    }
}

/* ------------------------------------------------- Fq (Montgomery, 6x64) */

static const u64 QL[6] = {0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL, 0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL};
static const u64 R2[6] = {0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL, 0x8de5476c4c95b6d5ULL, 0x67eb88a9939d83c0ULL, 0x9a793e85b519952dULL, 0x11988fe592cae3aaULL};
static const u64 R1[6] = {0x760900000002fffdULL, 0xebf4000bc40c0002ULL, 0x5f48985753c758baULL, 0x77ce585370525745ULL, 0x5c071a97a256ec6dULL, 0x15f65ec3fa80e493ULL};
static const u64 NPRIME = 0x89f3fffcfffcfffdULL;
static const u64 EXP_SQRT[6] = {0xee7fbfffffffeaabULL, 0x07aaffffac54ffffULL, 0xd9cc34a83dac3d89ULL, 0xd91dd2e13ce144afULL, 0x92c6e9ed90d2eb35ULL, 0x0680447a8e5ff9a6ULL};
static const u64 EXP_INV[6] = {0xb9feffffffffaaa9ULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL, 0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL};
static const u64 PSI_CX_1[6] = {0x8bfd00000000aaadULL, 0x409427eb4f49fffdULL, 0x897d29650fb85f9bULL, 0xaa0d857d89759ad4ULL, 0xec02408663d4de85ULL, 0x1a0111ea397fe699ULL};
static const u64 PSI_CY_0[6] = {0xf1ee7b04121bdea2ULL, 0x304466cf3e67fa0aULL, 0xef396489f61eb45eULL, 0x1c3dedd930b1cf60ULL, 0xe2e9c448d77a2cd9ULL, 0x135203e60180a68eULL};
static const u64 PSI_CY_1[6] = {0xc81084fbede3cc09ULL, 0xee67992f72ec05f4ULL, 0x77f76e17009241c5ULL, 0x48395dabc2d3435eULL, 0x6831e36d6bd17ffeULL, 0x06af0e0437ff400bULL};
static const u64 U_ABS = 0xd201000000010000ULL; /* u = -U_ABS for BLS12-381 */

typedef struct { u64 v[6]; } fq;   /* Montgomery domain */

static int fq_cmp_raw(const u64 *a, const u64 *b) {
    for (int i = 5; i >= 0; i--) {
        if (a[i] < b[i]) return -1;
        if (a[i] > b[i]) return 1;
    }
    return 0;
}

static void fq_sub_raw(u64 *r, const u64 *a, const u64 *b) {
    u64 borrow = 0;
    for (int i = 0; i < 6; i++) {
        u64 t = a[i] - b[i];
        u64 br2 = (a[i] < b[i]);
        u64 t2 = t - borrow;
        borrow = br2 | (t < borrow);
        r[i] = t2;
    }
}

static void fq_add(fq *r, const fq *a, const fq *b) {
    u64 carry = 0;
    for (int i = 0; i < 6; i++) {
        u128 t = (u128)a->v[i] + b->v[i] + carry;
        r->v[i] = (u64)t;
        carry = (u64)(t >> 64);
    }
    if (carry || fq_cmp_raw(r->v, QL) >= 0) fq_sub_raw(r->v, r->v, QL);
}

static void fq_sub(fq *r, const fq *a, const fq *b) {
    if (fq_cmp_raw(a->v, b->v) >= 0) {
        fq_sub_raw(r->v, a->v, b->v);
    } else {
        u64 t[6];
        fq_sub_raw(t, b->v, a->v);
        fq_sub_raw(r->v, QL, t);
    }
}

static int fq_is_zero(const fq *a) {
    u64 o = 0;
    for (int i = 0; i < 6; i++) o |= a->v[i];
    return o == 0;
}

static void fq_neg(fq *r, const fq *a) {
    if (fq_is_zero(a)) { *r = *a; return; }
    fq_sub_raw(r->v, QL, a->v);
}

/* T[12] <- a*b; then REDC in place */
static void fq_mul(fq *r, const fq *a, const fq *b) {
    u64 T[13];
    memset(T, 0, sizeof T);
    for (int i = 0; i < 6; i++) {
        u64 carry = 0;
        for (int j = 0; j < 6; j++) {
            u128 t = (u128)a->v[i] * b->v[j] + T[i + j] + carry;
            T[i + j] = (u64)t;
            carry = (u64)(t >> 64);
        }
        T[i + 6] += carry;
    }
    /* REDC: 6 rounds */
    for (int i = 0; i < 6; i++) {
        u64 m = T[i] * NPRIME;
        u64 carry = 0;
        for (int j = 0; j < 6; j++) {
            u128 t = (u128)m * QL[j] + T[i + j] + carry;
            T[i + j] = (u64)t;
            carry = (u64)(t >> 64);
        }
        for (int k = i + 6; carry; k++) {
            u128 t = (u128)T[k] + carry;
            T[k] = (u64)t;
            carry = (u64)(t >> 64);
        }
    }
    for (int i = 0; i < 6; i++) r->v[i] = T[i + 6];
    if (T[12] || fq_cmp_raw(r->v, QL) >= 0) fq_sub_raw(r->v, r->v, QL);
}

static void fq_sqr(fq *r, const fq *a) { fq_mul(r, a, a); }

static void fq_set_one(fq *r) { memcpy(r->v, R1, sizeof R1); }
static void fq_set_zero(fq *r) { memset(r->v, 0, sizeof r->v); }

/* canonical u64[6] -> Montgomery */
static void fq_from_canon(fq *r, const u64 *c) {
    fq t, r2;
    memcpy(t.v, c, 6 * sizeof(u64));
    memcpy(r2.v, R2, sizeof R2);
    fq_mul(r, &t, &r2);
}

/* Montgomery -> canonical u64[6] (REDC with 1) */
static void fq_to_canon(u64 *c, const fq *a) {
    fq one_raw, t;
    memset(one_raw.v, 0, sizeof one_raw.v);
    one_raw.v[0] = 1;
    fq_mul(&t, a, &one_raw);
    memcpy(c, t.v, 6 * sizeof(u64));
}

/* a^e for a 6-limb exponent (MSB-first square-and-multiply) */
static void fq_pow(fq *r, const fq *a, const u64 *e) {
    fq acc;
    fq_set_one(&acc);
    int started = 0;
    for (int limb = 5; limb >= 0; limb--) {
        for (int bit = 63; bit >= 0; bit--) {
            if (started) fq_sqr(&acc, &acc);
            if ((e[limb] >> bit) & 1) {
                if (started) fq_mul(&acc, &acc, a);
                else { acc = *a; started = 1; }
            }
        }
    }
    if (!started) fq_set_one(&acc);
    *r = acc;
}

static int fq_equal(const fq *a, const fq *b) {
    return fq_cmp_raw(a->v, b->v) == 0;
}

/* sqrt in Fq (q = 3 mod 4): s = a^((q+1)/4), verified.  1 on success. */
static int fq_sqrt(fq *r, const fq *a) {
    fq s, s2;
    fq_pow(&s, a, EXP_SQRT);
    fq_sqr(&s2, &s);
    if (!fq_equal(&s2, a)) return 0;
    *r = s;
    return 1;
}

static void fq_inv(fq *r, const fq *a) { fq_pow(r, a, EXP_INV); }

/* ------------------------------------------------------------------- Fq2 */

typedef struct { fq c0, c1; } fq2;

static void fq2_add(fq2 *r, const fq2 *a, const fq2 *b) {
    fq_add(&r->c0, &a->c0, &b->c0);
    fq_add(&r->c1, &a->c1, &b->c1);
}
static void fq2_sub(fq2 *r, const fq2 *a, const fq2 *b) {
    fq_sub(&r->c0, &a->c0, &b->c0);
    fq_sub(&r->c1, &a->c1, &b->c1);
}
static void fq2_neg(fq2 *r, const fq2 *a) {
    fq_neg(&r->c0, &a->c0);
    fq_neg(&r->c1, &a->c1);
}
static void fq2_conj(fq2 *r, const fq2 *a) {
    r->c0 = a->c0;
    fq_neg(&r->c1, &a->c1);
}
static void fq2_mul(fq2 *r, const fq2 *a, const fq2 *b) {
    /* Karatsuba: 3 Fq muls.  (a0b0 - a1b1, (a0+a1)(b0+b1) - a0b0 - a1b1) */
    fq m0, m1, sa, sb, cross, o0, o1;
    fq_mul(&m0, &a->c0, &b->c0);
    fq_mul(&m1, &a->c1, &b->c1);
    fq_add(&sa, &a->c0, &a->c1);
    fq_add(&sb, &b->c0, &b->c1);
    fq_mul(&cross, &sa, &sb);
    fq_sub(&o0, &m0, &m1);
    fq_sub(&cross, &cross, &m0);
    fq_sub(&o1, &cross, &m1);
    r->c0 = o0;
    r->c1 = o1;
}
static void fq2_sqr(fq2 *r, const fq2 *a) {
    /* complex squaring: 2 Fq muls.  ((a0+a1)(a0-a1), 2 a0 a1) */
    fq s, d, m, o1;
    fq_add(&s, &a->c0, &a->c1);
    fq_sub(&d, &a->c0, &a->c1);
    fq_mul(&m, &a->c1, &a->c0);
    fq_add(&o1, &m, &m);
    fq_mul(&r->c0, &s, &d);
    r->c1 = o1;
}

static int fq2_is_zero(const fq2 *a) {
    return fq_is_zero(&a->c0) && fq_is_zero(&a->c1);
}
static int fq2_equal(const fq2 *a, const fq2 *b) {
    return fq_equal(&a->c0, &b->c0) && fq_equal(&a->c1, &b->c1);
}
static void fq2_inv(fq2 *r, const fq2 *a) {
    fq n0, n1, norm, ni;
    fq_sqr(&n0, &a->c0);
    fq_sqr(&n1, &a->c1);
    fq_add(&norm, &n0, &n1);
    fq_inv(&ni, &norm);
    fq_mul(&r->c0, &a->c0, &ni);
    fq_mul(&n0, &a->c1, &ni);
    fq_neg(&r->c1, &n0);
}

/* lexicographic canonical compare of (c0, c1) tuples — mirrors Python's
 * tuple min() over canonical ints */
static int fq2_canon_cmp(const fq2 *a, const fq2 *b) {
    u64 ca[6], cb[6];
    fq_to_canon(ca, &a->c0);
    fq_to_canon(cb, &b->c0);
    int c = fq_cmp_raw(ca, cb);
    if (c) return c;
    fq_to_canon(ca, &a->c1);
    fq_to_canon(cb, &b->c1);
    return fq_cmp_raw(ca, cb);
}

/* sqrt in Fq2, complex method — EXACT mirror of bls381.fq2_sqrt */
static int fq2_sqrt(fq2 *r, const fq2 *a) {
    if (fq2_is_zero(a)) { fq_set_zero(&r->c0); fq_set_zero(&r->c1); return 1; }
    if (fq_is_zero(&a->c1)) {
        fq s;
        if (fq_sqrt(&s, &a->c0)) {
            r->c0 = s; fq_set_zero(&r->c1);
        } else {
            fq na0;
            fq_neg(&na0, &a->c0);
            if (!fq_sqrt(&s, &na0)) return 0;
            fq_set_zero(&r->c0); r->c1 = s;
        }
        /* verified below like the Python path's implicit exactness */
        fq2 chk; fq2_sqr(&chk, r);
        return fq2_equal(&chk, a);
    }
    fq n0, n1, norm, alpha, inv2, delta, x0, twox0, ix, x1;
    fq_sqr(&n0, &a->c0);
    fq_sqr(&n1, &a->c1);
    fq_add(&norm, &n0, &n1);
    if (!fq_sqrt(&alpha, &norm)) return 0;
    /* inv2 = 2^{-1}: (Q+1)/2 canonical — computed once */
    {
        fq two;
        fq_set_one(&two);
        fq_add(&two, &two, &two);
        fq_inv(&inv2, &two);
    }
    fq_add(&delta, &a->c0, &alpha);
    fq_mul(&delta, &delta, &inv2);
    if (!fq_sqrt(&x0, &delta)) {
        fq_sub(&delta, &a->c0, &alpha);
        fq_mul(&delta, &delta, &inv2);
        if (!fq_sqrt(&x0, &delta)) return 0;
    }
    fq_add(&twox0, &x0, &x0);
    fq_inv(&ix, &twox0);
    fq_mul(&x1, &a->c1, &ix);
    r->c0 = x0;
    r->c1 = x1;
    fq2 chk;
    fq2_sqr(&chk, r);
    return fq2_equal(&chk, a);
}

/* ------------------------------------------ E'(Fq2), jacobian, a = 0 ----- */

typedef struct { fq2 X, Y, Z; int inf; } g2j;

static void g2_set_inf(g2j *p) { p->inf = 1; }

static void g2_from_affine(g2j *p, const fq2 *x, const fq2 *y) {
    p->X = *x;
    p->Y = *y;
    fq_set_one(&p->Z.c0);
    fq_set_zero(&p->Z.c1);
    p->inf = 0;
}

static void g2_dbl(g2j *r, const g2j *p) {
    if (p->inf || fq2_is_zero(&p->Y)) { g2_set_inf(r); return; }
    fq2 A, B, C, D, E, F, t, X3, Y3, Z3;
    fq2_sqr(&A, &p->X);
    fq2_sqr(&B, &p->Y);
    fq2_sqr(&C, &B);
    fq2_add(&t, &p->X, &B);
    fq2_sqr(&t, &t);
    fq2_sub(&t, &t, &A);
    fq2_sub(&t, &t, &C);
    fq2_add(&D, &t, &t);
    fq2_add(&E, &A, &A);
    fq2_add(&E, &E, &A);
    fq2_sqr(&F, &E);
    fq2_sub(&X3, &F, &D);
    fq2_sub(&X3, &X3, &D);
    fq2_sub(&t, &D, &X3);
    fq2_mul(&Y3, &E, &t);
    fq2_add(&t, &C, &C);   /* 2C */
    fq2_add(&t, &t, &t);   /* 4C */
    fq2_add(&t, &t, &t);   /* 8C */
    fq2_sub(&Y3, &Y3, &t);
    fq2_mul(&Z3, &p->Y, &p->Z);
    fq2_add(&Z3, &Z3, &Z3);
    r->X = X3; r->Y = Y3; r->Z = Z3; r->inf = 0;
}

static void g2_add(g2j *r, const g2j *p, const g2j *q) {
    if (p->inf) { *r = *q; return; }
    if (q->inf) { *r = *p; return; }
    fq2 Z1Z1, Z2Z2, U1, U2, S1, S2, t, H, R_, H2, H3, X3, Y3, Z3;
    fq2_sqr(&Z1Z1, &p->Z);
    fq2_sqr(&Z2Z2, &q->Z);
    fq2_mul(&U1, &p->X, &Z2Z2);
    fq2_mul(&U2, &q->X, &Z1Z1);
    fq2_mul(&t, &q->Z, &Z2Z2);
    fq2_mul(&S1, &p->Y, &t);
    fq2_mul(&t, &p->Z, &Z1Z1);
    fq2_mul(&S2, &q->Y, &t);
    if (fq2_equal(&U1, &U2)) {
        if (fq2_equal(&S1, &S2)) { g2_dbl(r, p); return; }
        g2_set_inf(r);
        return;
    }
    fq2_sub(&H, &U2, &U1);
    fq2_sub(&R_, &S2, &S1);
    fq2_sqr(&H2, &H);
    fq2_mul(&H3, &H, &H2);
    fq2_sqr(&X3, &R_);
    fq2_sub(&X3, &X3, &H3);
    fq2_mul(&t, &U1, &H2);
    fq2_sub(&X3, &X3, &t);
    fq2_sub(&X3, &X3, &t);
    fq2_sub(&t, &t, &X3);      /* U1*H2 - X3 */
    fq2_mul(&Y3, &R_, &t);
    fq2_mul(&t, &S1, &H3);
    fq2_sub(&Y3, &Y3, &t);
    fq2_mul(&Z3, &p->Z, &q->Z);
    fq2_mul(&Z3, &Z3, &H);
    r->X = X3; r->Y = Y3; r->Z = Z3; r->inf = 0;
}

static void g2_neg(g2j *r, const g2j *p) {
    *r = *p;
    if (!p->inf) fq2_neg(&r->Y, &p->Y);
}

/* k*P for u64 k (MSB-first) */
static void g2_mul_u64(g2j *r, u64 k, const g2j *p) {
    g2j acc;
    g2_set_inf(&acc);
    int started = 0;
    for (int bit = 63; bit >= 0; bit--) {
        if (started) g2_dbl(&acc, &acc);
        if ((k >> bit) & 1) {
            if (started) g2_add(&acc, &acc, p);
            else { acc = *p; started = 1; }
        }
    }
    if (!started) g2_set_inf(&acc);
    *r = acc;
}

/* [u]P with the NEGATIVE BLS parameter (u = -U_ABS) */
static void g2_mul_u_signed(g2j *r, const g2j *p) {
    g2j t;
    g2_mul_u64(&t, U_ABS, p);
    g2_neg(r, &t);
}

/* psi(x, y) = (cx * conj(x), cy * conj(y)); jacobian: conj(Z) rides along */
static fq2 PSI_CX_M, PSI_CY_M;

/* dlopen-time init: no lazy flag, no data race — ctypes releases the GIL
 * during calls, so concurrent hashers must never observe a torn constant */
__attribute__((constructor)) static void psi_init(void) {
    fq_set_zero(&PSI_CX_M.c0);
    fq_from_canon(&PSI_CX_M.c1, PSI_CX_1);
    fq_from_canon(&PSI_CY_M.c0, PSI_CY_0);
    fq_from_canon(&PSI_CY_M.c1, PSI_CY_1);
}

static void g2_psi(g2j *r, const g2j *p) {
    if (p->inf) { g2_set_inf(r); return; }
    fq2 t;
    fq2_conj(&t, &p->X);
    fq2_mul(&r->X, &PSI_CX_M, &t);
    fq2_conj(&t, &p->Y);
    fq2_mul(&r->Y, &PSI_CY_M, &t);
    fq2_conj(&r->Z, &p->Z);
    r->inf = 0;
}

/* Budroni-Pintore: [u^2-u-1]P + [u-1]psi(P) + psi^2(2P) — mirrors
 * bls381.clear_cofactor_g2's exact composition */
static void g2_clear_cofactor(g2j *r, const g2j *p) {
    g2j uP, u1P, t, tmp, psiP, two_p, psi2;
    g2_mul_u_signed(&uP, p);
    g2_neg(&tmp, p);
    g2_add(&u1P, &uP, &tmp);          /* [u-1]P */
    g2_mul_u_signed(&t, &u1P);
    g2_add(&t, &t, &tmp);             /* [u^2-u-1]P */
    g2_psi(&psiP, p);
    g2_mul_u_signed(&tmp, &psiP);
    g2_add(&t, &t, &tmp);
    g2_neg(&tmp, &psiP);
    g2_add(&t, &t, &tmp);             /* + [u-1]psi(P) */
    g2_dbl(&two_p, p);
    g2_psi(&psi2, &two_p);
    g2_psi(&psi2, &psi2);
    g2_add(r, &t, &psi2);
}

/* ------------------------------------------------------- hash-to-G2 ------ */

/* _hash_fq: int(sha256(tag+ctr+0+data) || sha256(tag+ctr+1+data)) mod Q,
 * returned in Montgomery form.  64-byte big-endian digest -> 8 LE limbs ->
 * canonical via REDC12 + two Montgomery muls. */
static void redc12(fq *r, const u64 *T12) {
    u64 T[13];
    memcpy(T, T12, 12 * sizeof(u64));
    T[12] = 0;
    for (int i = 0; i < 6; i++) {
        u64 m = T[i] * NPRIME;
        u64 carry = 0;
        for (int j = 0; j < 6; j++) {
            u128 t = (u128)m * QL[j] + T[i + j] + carry;
            T[i + j] = (u64)t;
            carry = (u64)(t >> 64);
        }
        for (int k = i + 6; carry; k++) {
            u128 t = (u128)T[k] + carry;
            T[k] = (u64)t;
            carry = (u64)(t >> 64);
        }
    }
    for (int i = 0; i < 6; i++) r->v[i] = T[i + 6];
    if (T[12] || fq_cmp_raw(r->v, QL) >= 0) fq_sub_raw(r->v, r->v, QL);
}

static void hash_fq(fq *out_mont, const char *tag, long taglen, uint32_t ctr,
                    const unsigned char *data, long len) {
    /* message = tag + ctr_be4 + plane_byte + data */
    unsigned char buf[4200];
    unsigned char digest[64];
    long off = 0;
    memcpy(buf + off, tag, (size_t)taglen);
    off += taglen;
    buf[off++] = (unsigned char)(ctr >> 24);
    buf[off++] = (unsigned char)(ctr >> 16);
    buf[off++] = (unsigned char)(ctr >> 8);
    buf[off++] = (unsigned char)ctr;
    long plane_off = off;
    off += 1;
    memcpy(buf + off, data, (size_t)len);
    off += len;
    for (int plane = 0; plane < 2; plane++) {
        buf[plane_off] = (unsigned char)plane;
        sha256(buf, off, digest + 32 * plane);
    }
    /* big-endian 64 bytes -> little-endian limbs v[8] */
    u64 v[12];
    memset(v, 0, sizeof v);
    for (int i = 0; i < 8; i++) {
        u64 limb = 0;
        for (int b = 0; b < 8; b++)
            limb = (limb << 8) | digest[(7 - i) * 8 + b];
        v[i] = limb;
    }
    fq t, r2m, canon;
    redc12(&t, v);                 /* d * R^-1 */
    memcpy(r2m.v, R2, sizeof R2);
    fq_mul(&canon, &t, &r2m);      /* d mod Q, canonical-as-raw */
    fq_mul(out_mont, &canon, &r2m); /* d * R: Montgomery form */
}

/* Returns 0 on success.  out: x.c0, x.c1, y.c0, y.c1 canonical LE limbs. */
int hashg2_one(const unsigned char *data, long len, u64 *out) {
    if (len < 0 || len > 4096) return -1;
    fq2 x, b2, y2, x3, y;
    fq four;
    for (uint32_t ctr = 0;; ctr++) {
        if (ctr > 1000) return -2; /* unreachable for honest SHA */
        hash_fq(&x.c0, "bls381-g2c0", 11, ctr, data, len);
        hash_fq(&x.c1, "bls381-g2c1", 11, ctr, data, len);
        /* y2 = x^3 + (4, 4) */
        fq_set_one(&four);
        fq_add(&four, &four, &four);
        fq_add(&four, &four, &four);
        b2.c0 = four;
        b2.c1 = four;
        fq2_sqr(&x3, &x);
        fq2_mul(&x3, &x3, &x);
        fq2_add(&y2, &x3, &b2);
        if (!fq2_sqrt(&y, &y2)) continue;
        /* deterministic sign: lexicographic min(y, -y) over canonical */
        fq2 ny;
        fq2_neg(&ny, &y);
        if (fq2_canon_cmp(&ny, &y) < 0) y = ny;
        g2j P, C;
        g2_from_affine(&P, &x, &y);
        g2_clear_cofactor(&C, &P);
        if (C.inf) continue;
        /* to affine + canonical output */
        fq2 zi, zi2, zi3, ax, ay;
        fq2_inv(&zi, &C.Z);
        fq2_sqr(&zi2, &zi);
        fq2_mul(&zi3, &zi2, &zi);
        fq2_mul(&ax, &C.X, &zi2);
        fq2_mul(&ay, &C.Y, &zi3);
        fq_to_canon(out + 0, &ax.c0);
        fq_to_canon(out + 6, &ax.c1);
        fq_to_canon(out + 12, &ay.c0);
        fq_to_canon(out + 18, &ay.c1);
        return 0;
    }
}
