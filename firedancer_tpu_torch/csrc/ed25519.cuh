// ed25519.cuh -- GF(2^255 - 19) and Ed25519 point arithmetic shared by the
// port's Hopper kernels (verify_core.cu, decompress_niels.cu, msm.cu).
//
// Limbs.  The TPU kernels use radix 2^13 x 20 int32 limbs because the TPU's
// VPU has no widening multiply.  Hopper issues a 32x32->64 multiply-add
// (IMAD.WIDE) natively, so an element here is ref10's 10 limbs in radix
// 2^25.5 (26/25-bit limbs, int32), and products accumulate in int64
// columns.  The kernels' interface is field.py's radix-2^13 layout
// (fe_from_limbs13 at load, fe_to_limbs13 at store).
//
// Carry discipline: a carried element has |limb| <= 2^25.  fe_mul accepts
// operands with |limb| <= 2^27 (a sum or difference of up to four carried
// elements): the largest column is 267 * 2^27 * 2^27 < 2^63, and the doubled
// odd limbs of the first operand stay below 2^28 in int32.  Every point
// formula below feeds fe_mul at most three-term combinations.
//
// Compiled without __CUDACC__ (plain C++), every function is a host
// function: each kernel source then builds a host library that the CPU
// tests hold against the plain PyTorch version.

#ifndef FDT_ED25519_CUH
#define FDT_ED25519_CUH

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FDT_FN __device__ __forceinline__
#define FDT_MUL_FN __device__ __noinline__
#define FDT_UNROLL _Pragma("unroll")
#else
#define FDT_FN static inline
#define FDT_MUL_FN static
#define FDT_UNROLL
#endif

#if defined(__CUDA_ARCH__)
#define FDT_LDG(p) __ldg(p)
#else
#define FDT_LDG(p) (*(p))
#endif

// Constant block (int32, radix 2^25.5 limbs), built by
// verify_core.kernel_consts(): D, 2D, sqrt(-1), then the affine niels base
// table (y+x, y-x, 2dxy) of i*B for i in 0..8.
#define C_D 0
#define C_D2 10
#define C_SQRTM1 20
#define C_BTAB 30
#define N_CONSTS 300

struct fe {
  int32_t v[10];
};
struct ge {  // extended coordinates
  fe x, y, z, t;
};
struct niels {  // (Y+X, Y-X, 2dT, 2Z)
  fe ypx, ymx, t2d, z2;
};

FDT_FN fe fe_zero() {
  fe r;
  for (int i = 0; i < 10; i++) r.v[i] = 0;
  return r;
}

FDT_FN fe fe_one() {
  fe r = fe_zero();
  r.v[0] = 1;
  return r;
}

FDT_FN fe fe_load(const int32_t* p) {
  fe r;
  for (int i = 0; i < 10; i++) r.v[i] = p[i];
  return r;
}

FDT_FN fe fe_add(const fe& a, const fe& b) {
  fe r;
  for (int i = 0; i < 10; i++) r.v[i] = a.v[i] + b.v[i];
  return r;
}

FDT_FN fe fe_sub(const fe& a, const fe& b) {
  fe r;
  for (int i = 0; i < 10; i++) r.v[i] = a.v[i] - b.v[i];
  return r;
}

FDT_FN fe fe_neg(const fe& a) {
  fe r;
  for (int i = 0; i < 10; i++) r.v[i] = -a.v[i];
  return r;
}

// c ? b : a, branch-free
FDT_FN fe fe_select(const fe& a, const fe& b, bool c) {
  fe r;
  for (int i = 0; i < 10; i++) r.v[i] = c ? b.v[i] : a.v[i];
  return r;
}

// Centered carry of ten int64 columns into a carried element: even limbs
// end in [-2^25, 2^25), odd limbs in [-2^24, 2^24) (limb 1 may take a further
// |carry| < 2^16 from the 2^255 = 19 fold).
FDT_FN fe fe_carry_wide(int64_t* c) {
  for (int i = 0; i < 10; i++) {
    const int s = (i & 1) ? 25 : 26;
    const int64_t carry = (c[i] + ((int64_t)1 << (s - 1))) >> s;
    c[i] -= carry * ((int64_t)1 << s);
    if (i < 9) {
      c[i + 1] += carry;
    } else {
      c[0] += carry * 19;
    }
  }
  const int64_t carry = (c[0] + ((int64_t)1 << 25)) >> 26;
  c[0] -= carry * ((int64_t)1 << 26);
  c[1] += carry;
  fe r;
  for (int i = 0; i < 10; i++) r.v[i] = (int32_t)c[i];
  return r;
}

FDT_FN fe fe_carry(const fe& a) {
  int64_t c[10];
  for (int i = 0; i < 10; i++) c[i] = a.v[i];
  return fe_carry_wide(c);
}

// Product f*g: column i+j takes f_i g_j, doubled when i and j are both odd
// (limb positions ceil(25.5 i)), and columns >= 10 fold back times 19.
FDT_MUL_FN fe fe_mul(const fe f, const fe g) {
  int32_t f2[10];
  FDT_UNROLL
  for (int i = 0; i < 10; i++) f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
  int64_t c[19];
  FDT_UNROLL
  for (int k = 0; k < 19; k++) c[k] = 0;
  FDT_UNROLL
  for (int i = 0; i < 10; i++) {
    FDT_UNROLL
    for (int j = 0; j < 10; j++) {
      const int32_t fi = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
      c[i + j] += (int64_t)fi * (int64_t)g.v[j];
    }
  }
  int64_t h[10];
  FDT_UNROLL
  for (int k = 0; k < 9; k++) h[k] = c[k] + 19 * c[k + 10];
  h[9] = c[9];
  return fe_carry_wide(h);
}

FDT_FN fe fe_sq(const fe& f) { return fe_mul(f, f); }

FDT_FN fe fe_sq_n(fe f, int n) {
  for (int i = 0; i < n; i++) f = fe_sq(f);
  return f;
}

// Canonical limbs (value in [0, p), limbs in [0, 2^26) / [0, 2^25)) of an
// element with |limb| <= 2^27: carry, then ref10's q = floor(h / p) trick.
FDT_FN fe fe_canon(const fe& a) {
  const fe c = fe_carry(a);
  int64_t h[10];
  for (int i = 0; i < 10; i++) h[i] = c.v[i];
  int64_t q = (19 * h[9] + ((int64_t)1 << 24)) >> 25;
  for (int i = 0; i < 10; i++) q = (h[i] + q) >> ((i & 1) ? 25 : 26);
  h[0] += 19 * q;
  for (int i = 0; i < 9; i++) {
    const int s = (i & 1) ? 25 : 26;
    const int64_t carry = h[i] >> s;
    h[i + 1] += carry;
    h[i] -= carry * ((int64_t)1 << s);
  }
  h[9] -= (h[9] >> 25) * ((int64_t)1 << 25);  // drops 2^255 q
  fe r;
  for (int i = 0; i < 10; i++) r.v[i] = (int32_t)h[i];
  return r;
}

FDT_FN bool fe_is_zero(const fe& a) {
  const fe c = fe_canon(a);
  int32_t acc = 0;
  for (int i = 0; i < 10; i++) acc |= c.v[i];
  return acc == 0;
}

FDT_FN bool fe_eq(const fe& a, const fe& b) { return fe_is_zero(fe_sub(a, b)); }

FDT_FN int fe_parity(const fe& a) { return fe_canon(a).v[0] & 1; }

// z^((p-5)/8) = z^(2^252 - 3), the ref10 chain (z carried)
FDT_FN fe fe_pow_p58(const fe& z) {
  const fe z2 = fe_sq(z);
  const fe z9 = fe_mul(fe_sq_n(z2, 2), z);
  const fe z11 = fe_mul(z9, z2);
  const fe z_5_0 = fe_mul(fe_sq(z11), z9);
  const fe z_10_0 = fe_mul(fe_sq_n(z_5_0, 5), z_5_0);
  const fe z_20_0 = fe_mul(fe_sq_n(z_10_0, 10), z_10_0);
  const fe z_40_0 = fe_mul(fe_sq_n(z_20_0, 20), z_20_0);
  const fe z_50_0 = fe_mul(fe_sq_n(z_40_0, 10), z_10_0);
  const fe z_100_0 = fe_mul(fe_sq_n(z_50_0, 50), z_50_0);
  const fe z_200_0 = fe_mul(fe_sq_n(z_100_0, 100), z_100_0);
  const fe z_250_0 = fe_mul(fe_sq_n(z_200_0, 50), z_50_0);
  return fe_mul(fe_sq_n(z_250_0, 2), z);
}

// Bit position of radix-2^25.5 limb k: ceil(25.5 k)
FDT_FN int fe_pos(int k) { return (51 * k + 1) / 2; }

// Element from lane `lane` of a (20, B) batch-last array of radix-2^13 limbs
// (row stride B).  Limbs may be signed and loose (|limb| <= 2^17, field.py's
// LOOSE_MAX): limb i, of weight 2^(13 i), is added into the radix-2^25.5
// column at or below bit 13 i, shifted by the difference (at most 2^25 x
// 2^17 per term); bits >= 255 fold times 19 in the carry.
FDT_FN fe fe_from_limbs13(const int32_t* y, int B, int lane) {
  int64_t c[10];
  for (int k = 0; k < 10; k++) c[k] = 0;
  FDT_UNROLL
  for (int i = 0; i < 20; i++) {
    const int bit = 13 * i;
    const int k = (2 * bit) / 51 < 9 ? (2 * bit) / 51 : 9;
    c[k] += (int64_t)FDT_LDG(y + (int64_t)i * B + lane) *
            ((int64_t)1 << (bit - fe_pos(k)));
  }
  return fe_carry_wide(c);
}

// Canonical value of `a` as 20 radix-2^13 limbs in [0, 2^13), written to
// lane `lane` of a (20, B) batch-last array (row stride B).
FDT_FN void fe_to_limbs13(const fe& a, int32_t* out, int B, int lane) {
  const fe c = fe_canon(a);
  uint64_t w[5] = {0, 0, 0, 0, 0};
  for (int k = 0; k < 10; k++) {
    const uint64_t v = (uint64_t)(uint32_t)c.v[k];
    const int pos = fe_pos(k), wi = pos >> 6, sh = pos & 63;
    w[wi] |= v << sh;
    if (sh + ((k & 1) ? 25 : 26) > 64) w[wi + 1] |= v >> (64 - sh);
  }
  for (int i = 0; i < 20; i++) {
    const int lo = 13 * i, wi = lo >> 6, sh = lo & 63;
    uint64_t x = w[wi] >> sh;
    if (sh + 13 > 64) x |= w[wi + 1] << (64 - sh);
    out[(int64_t)i * B + lane] = (int32_t)(x & 0x1FFF);
  }
}

FDT_FN ge ge_identity() {
  ge p;
  p.x = fe_zero();
  p.y = fe_one();
  p.z = fe_one();
  p.t = fe_zero();
  return p;
}

// dbl-2008-hwcd, a = -1; T only when asked
FDT_FN ge ge_double(const ge& p, bool with_t) {
  const fe a = fe_sq(p.x);
  const fe b = fe_sq(p.y);
  const fe c2 = fe_sq(p.z);
  const fe e = fe_sub(fe_sub(fe_sq(fe_add(p.x, p.y)), a), b);
  const fe g = fe_sub(b, a);
  const fe f = fe_carry(fe_sub(fe_sub(g, c2), c2));
  const fe h = fe_neg(fe_add(a, b));
  ge r;
  r.x = fe_mul(e, f);
  r.y = fe_mul(g, h);
  r.z = fe_mul(f, g);
  r.t = with_t ? fe_mul(e, h) : fe_zero();
  return r;
}

// add-2008-hwcd-3, a = -1, k = 2d (table building)
FDT_FN ge ge_add(const ge& p, const ge& q, const fe& d2) {
  const fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
  const fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
  const fe c = fe_mul(fe_mul(p.t, d2), q.t);
  const fe zz = fe_mul(p.z, q.z);
  const fe zz2 = fe_add(zz, zz);
  const fe e = fe_sub(b, a);
  const fe f = fe_sub(zz2, c);
  const fe g = fe_add(zz2, c);
  const fe h = fe_add(b, a);
  ge r;
  r.x = fe_mul(e, f);
  r.y = fe_mul(g, h);
  r.z = fe_mul(f, g);
  r.t = fe_mul(e, h);
  return r;
}

FDT_FN niels to_niels(const ge& p, const fe& d2) {
  niels n;
  n.ypx = fe_carry(fe_add(p.y, p.x));
  n.ymx = fe_carry(fe_sub(p.y, p.x));
  n.t2d = fe_mul(p.t, d2);
  n.z2 = fe_carry(fe_add(p.z, p.z));
  return n;
}

// p + e, e = (Y+X, Y-X, 2dT, 2Z)
FDT_FN ge ge_add_niels(const ge& p, const niels& e) {
  const fe a = fe_mul(fe_sub(p.y, p.x), e.ymx);
  const fe b = fe_mul(fe_add(p.y, p.x), e.ypx);
  const fe c = fe_mul(p.t, e.t2d);
  const fe d2 = fe_mul(p.z, e.z2);
  const fe ec = fe_sub(b, a);
  const fe f = fe_sub(d2, c);
  const fe g = fe_add(d2, c);
  const fe h = fe_add(b, a);
  ge r;
  r.x = fe_mul(ec, f);
  r.y = fe_mul(g, h);
  r.z = fe_mul(f, g);
  r.t = fe_mul(ec, h);
  return r;
}

// p + e, e = (y+x, y-x, 2dxy) affine niels (Z == 1); T only when asked
FDT_FN ge ge_add_niels_affine(const ge& p, const fe& ypx, const fe& ymx,
                              const fe& t2d, bool with_t) {
  const fe a = fe_mul(fe_sub(p.y, p.x), ymx);
  const fe b = fe_mul(fe_add(p.y, p.x), ypx);
  const fe c = fe_mul(p.t, t2d);
  const fe z2 = fe_add(p.z, p.z);
  const fe ec = fe_sub(b, a);
  const fe f = fe_sub(z2, c);
  const fe g = fe_add(z2, c);
  const fe h = fe_add(b, a);
  ge r;
  r.x = fe_mul(ec, f);
  r.y = fe_mul(g, h);
  r.z = fe_mul(f, g);
  r.t = with_t ? fe_mul(ec, h) : fe_zero();
  return r;
}

// (y, sign) -> point; *ok is false for a failed sqrt or a negative zero
FDT_FN ge ge_decompress(const fe& y, int sign, const int32_t* cst, bool* ok) {
  const fe one = fe_one();
  const fe ysq = fe_sq(y);
  const fe u = fe_sub(ysq, one);
  const fe v = fe_add(fe_mul(fe_load(cst + C_D), ysq), one);
  const fe v3 = fe_mul(fe_sq(v), v);
  const fe v7 = fe_mul(fe_sq(v3), v);
  const fe t = fe_pow_p58(fe_mul(u, v7));
  fe x = fe_mul(fe_mul(u, v3), t);
  const fe vxx = fe_mul(v, fe_sq(x));
  const bool ok_direct = fe_eq(vxx, u);
  const bool ok_flip = fe_eq(vxx, fe_neg(u));
  x = fe_select(x, fe_mul(x, fe_load(cst + C_SQRTM1)), ok_flip);
  const bool x_zero = fe_is_zero(x);
  *ok = (ok_direct || ok_flip) && !(x_zero && sign == 1);
  x = fe_select(x, fe_neg(x), (fe_parity(x) != sign) && !x_zero);
  ge p;
  p.x = x;
  p.y = y;
  p.z = one;
  p.t = fe_mul(x, y);
  return p;
}

#endif  // FDT_ED25519_CUH
