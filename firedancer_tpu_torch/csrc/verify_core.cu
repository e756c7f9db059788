// verify_core.cu -- fused Ed25519 verify core for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel firedancer_tpu/ops/ed25519/pallas_kernel.py
// :: _verify_core_kernel (wrapper verify_core).  Per lane it decompresses A
// and R (ref10 sqrt chain: non-canonical y accepted, failed sqrt rejected,
// x == 0 with the sign bit set rejected), builds the 9-entry niels table of
// -A, runs the 64-step signed radix-16 Strauss loop over digit rows 63..0
// (4 doublings, T only on the last; + (+-)A[|k|] in projective niels form;
// + (+-)B[|s|] in affine niels form) and compares [k](-A) + [s]B with R by
// the Z_r = 1 cross-multiply.  Output: one byte per lane, 1 = equal.
//
// Design, and what differs from the TPU kernel:
//  * Limbs.  The TPU kernel uses radix 2^13 x 20 int32 limbs because its
//    VPU has no widening multiply.  Hopper issues a 32x32->64 multiply-add
//    (IMAD.WIDE) natively, so an element here is ref10's 10 limbs in radix
//    2^25.5 (26/25-bit limbs, int32), products accumulate in int64 columns.
//    The radix-13 y limbs are converted at load; the interface (digits, y
//    limbs, sign bits in; one bool per lane out) is the TPU kernel's.
//  * Grid.  One thread per lane, 32 threads per block, a 1-D grid over B;
//    the ragged edge is masked here instead of padding B to 256.  Nothing
//    carries between blocks.
//  * State.  The -A table (9 entries x 4 coordinates x 10 limbs) is
//    indexed by a per-lane digit, so it lives in local memory (L1-backed).
//    The base table and the field constants are staged in shared memory
//    (not __constant__: lanes read different entries).
//
// Carry discipline: a carried element has |limb| <= 2^25.  fe_mul accepts
// operands with |limb| <= 2^27 (a sum or difference of up to four carried
// elements): the largest column is 267 * 2^27 * 2^27 < 2^63, and the doubled
// odd limbs of the first operand stay below 2^28 in int32.  Every point
// formula below feeds fe_mul at most three-term combinations.
//
// What bounds it: 32-bit integer multiply-add issue.  Per lane the verify
// function needs 1,550 squarings and 1,821 multiplications: (255, 20) for
// each of the two decompressions, (16, 51) to build the -A table,
// (1,024, 1,728) in the 64-step loop and (0, 2) for the final compare
// (verify_core.field_ops_per_lane()).  A multiplication is 100 32x32->64
// products and a squaring 55, 267,350 products per lane
// (verify_core.products_per_lane()).  At 64 32-bit multiply-adds per SM per
// cycle (half the FP32 FMA rate), the card's floor for B = 4096 lanes is
// about 65 us.  The simple design does nothing about that bound yet: it runs
// every squaring through fe_mul (337,100 products per lane, 26 % more than
// the bound counts), one warp per SM at B = 4096 leaves the multiply pipes
// mostly idle waiting on dependent chains and local memory, and fe_mul is
// an out-of-line call.
// Register and spill counts: the build log that utils/kbuild.py keeps
// (nvcc -Xptxas -v), printed by chip_smoke.py.
//
// Compiled without __CUDACC__ (plain C++), the same lane function builds a
// host library (fdt_verify_core_host) that the CPU tests use to hold this
// file's arithmetic against the plain PyTorch version; the port itself only
// ever launches the kernel.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FDT_FN __device__ __forceinline__
#define FDT_MUL_FN __device__ __noinline__
#else
#define FDT_FN static inline
#define FDT_MUL_FN static
#endif

#if defined(__CUDA_ARCH__)
#define FDT_LDG(p) __ldg(p)
#else
#define FDT_LDG(p) (*(p))
#endif

// Constant block (int32, radix 2^25.5 limbs), built by the Python wrapper:
// D, 2D, sqrt(-1), then the affine niels base table (y+x, y-x, 2dxy) of
// i*B for i in 0..8.
#define C_D 0
#define C_D2 10
#define C_SQRTM1 20
#define C_BTAB 30
#define N_CONSTS 300
#define LANES_PER_BLOCK 32

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
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int i = 0; i < 10; i++) f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
  int64_t c[19];
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int k = 0; k < 19; k++) c[k] = 0;
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int i = 0; i < 10; i++) {
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int j = 0; j < 10; j++) {
      const int32_t fi = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
      c[i + j] += (int64_t)fi * (int64_t)g.v[j];
    }
  }
  int64_t h[10];
#ifdef __CUDACC__
#pragma unroll
#endif
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

// 13-bit limb i of a (20, B) batch-last array -> bits [13 i, 13 i + 13)
FDT_FN uint64_t bits_of(const uint64_t* w, int lo, int n) {
  const int wi = lo >> 6, sh = lo & 63;
  uint64_t x = w[wi] >> sh;
  if (sh + n > 64) x |= w[wi + 1] << (64 - sh);
  return x & (((uint64_t)1 << n) - 1);
}

// y from 20 radix-2^13 limbs (values in [0, 2^13)) -> carried element.
// Bits 255..259 (never set by decompress_bytes) fold in times 19.
FDT_FN fe fe_from_limbs13(const int32_t* y, int B, int lane) {
  uint64_t w[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < 20; i++) {
    const uint64_t v = (uint64_t)(FDT_LDG(y + (int64_t)i * B + lane) & 0x1FFF);
    const int off = 13 * i, wi = off >> 6, sh = off & 63;
    w[wi] |= v << sh;
    if (sh > 51) w[wi + 1] |= v >> (64 - sh);
  }
  int64_t c[10];
  int pos = 0;
  for (int i = 0; i < 10; i++) {
    const int n = (i & 1) ? 25 : 26;
    c[i] = (int64_t)bits_of(w, pos, n);
    pos += n;
  }
  c[0] += 19 * (int64_t)bits_of(w, 255, 5);
  return fe_carry_wide(c);
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

// p + e, e = (y+x, y-x, 2dxy) affine niels (Z == 1); no T out
FDT_FN ge ge_add_niels_affine(const ge& p, const fe& ypx, const fe& ymx,
                              const fe& t2d) {
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
  r.t = fe_zero();
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

// The whole per-lane verify core.  cst: the constant block (shared memory
// on the card); k, s: (64, B) digits; ay, ry: (20, B) y limbs; asg, rsg:
// (B,) sign bits.
FDT_FN bool verify_lane(const int32_t* cst, const int32_t* k,
                        const int32_t* s, const int32_t* ay,
                        const int32_t* asg, const int32_t* ry,
                        const int32_t* rsg, int B, int lane) {
  bool a_ok, r_ok;
  const ge a = ge_decompress(fe_from_limbs13(ay, B, lane),
                             FDT_LDG(asg + lane), cst, &a_ok);
  const ge r = ge_decompress(fe_from_limbs13(ry, B, lane),
                             FDT_LDG(rsg + lane), cst, &r_ok);
  const fe d2 = fe_load(cst + C_D2);

  // niels table of i * (-A), i in 0..8
  niels tab[9];
  ge na;
  na.x = fe_neg(a.x);
  na.y = a.y;
  na.z = a.z;
  na.t = fe_neg(a.t);
  const ge p2 = ge_double(na, true);
  const ge p3 = ge_add(p2, na, d2);
  const ge p4 = ge_double(p2, true);
  tab[0].ypx = fe_one();
  tab[0].ymx = fe_one();
  tab[0].t2d = fe_zero();
  tab[0].z2 = fe_add(fe_one(), fe_one());
  tab[1] = to_niels(na, d2);
  tab[2] = to_niels(p2, d2);
  tab[3] = to_niels(p3, d2);
  tab[4] = to_niels(p4, d2);
  tab[5] = to_niels(ge_add(p4, na, d2), d2);
  const ge p6 = ge_double(p3, true);
  tab[6] = to_niels(p6, d2);
  tab[7] = to_niels(ge_add(p6, na, d2), d2);
  tab[8] = to_niels(ge_double(p4, true), d2);

  ge acc;
  acc.x = fe_zero();
  acc.y = fe_one();
  acc.z = fe_one();
  acc.t = fe_zero();
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int idx = 63; idx >= 0; idx--) {
    const int kd = FDT_LDG(k + (int64_t)idx * B + lane);
    const int sd = FDT_LDG(s + (int64_t)idx * B + lane);
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int j = 0; j < 4; j++) acc = ge_double(acc, j == 3);

    // |digit| is clamped to the table so that malformed digits cannot read
    // out of bounds (to_signed_digits only makes digits in [-8, 7])
    const int ka = kd < 0 ? (kd < -8 ? 8 : -kd) : (kd > 8 ? 8 : kd);
    const int sa = sd < 0 ? (sd < -8 ? 8 : -sd) : (sd > 8 ? 8 : sd);
    const niels& ea = tab[ka];
    niels e;
    e.ypx = fe_select(ea.ypx, ea.ymx, kd < 0);
    e.ymx = fe_select(ea.ymx, ea.ypx, kd < 0);
    e.t2d = fe_select(ea.t2d, fe_neg(ea.t2d), kd < 0);
    e.z2 = ea.z2;
    acc = ge_add_niels(acc, e);

    const int32_t* eb = cst + C_BTAB + 30 * sa;
    const fe bypx = fe_load(eb), bymx = fe_load(eb + 10);
    const fe bt2d = fe_load(eb + 20);
    acc = ge_add_niels_affine(acc, fe_select(bypx, bymx, sd < 0),
                              fe_select(bymx, bypx, sd < 0),
                              fe_select(bt2d, fe_neg(bt2d), sd < 0));
  }

  // acc == R with Z_r == 1: X == x_r Z and Y == y_r Z
  const bool eq = fe_eq(fe_mul(r.x, acc.z), acc.x) &&
                  fe_eq(fe_mul(r.y, acc.z), acc.y);
  return a_ok && r_ok && eq;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(LANES_PER_BLOCK)
verify_core_kernel(const int32_t* __restrict__ consts,
                   const int32_t* __restrict__ k,
                   const int32_t* __restrict__ s,
                   const int32_t* __restrict__ ay,
                   const int32_t* __restrict__ asg,
                   const int32_t* __restrict__ ry,
                   const int32_t* __restrict__ rsg,
                   uint8_t* __restrict__ out, int B) {
  __shared__ int32_t cst[N_CONSTS];
  for (int i = threadIdx.x; i < N_CONSTS; i += blockDim.x) cst[i] = consts[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  out[lane] = verify_lane(cst, k, s, ay, asg, ry, rsg, B, lane) ? 1 : 0;
}

extern "C" cudaError_t fdt_verify_core_launch(
    const int32_t* consts, const int32_t* k, const int32_t* s,
    const int32_t* ay, const int32_t* asg, const int32_t* ry,
    const int32_t* rsg, uint8_t* out, int B, void* stream) {
  if (B <= 0) return cudaSuccess;
  const int blocks = (B + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK;
  verify_core_kernel<<<blocks, LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      consts, k, s, ay, asg, ry, rsg, out, B);
  return cudaGetLastError();
}

#else  // plain C++: the host build the CPU tests hold against the plain path

extern "C" void fdt_verify_core_host(const int32_t* consts, const int32_t* k,
                                     const int32_t* s, const int32_t* ay,
                                     const int32_t* asg, const int32_t* ry,
                                     const int32_t* rsg, uint8_t* out,
                                     int B) {
  for (int lane = 0; lane < B; lane++)
    out[lane] = verify_lane(consts, k, s, ay, asg, ry, rsg, B, lane) ? 1 : 0;
}

#endif
