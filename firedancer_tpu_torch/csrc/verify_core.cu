// verify_core.cu -- fused Ed25519 verify core for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel firedancer_tpu/ops/ed25519/pallas_kernel.py
// :: _verify_core_kernel (wrapper verify_core).  Per lane it decompresses A
// and R (ref10 sqrt chain: non-canonical y accepted, failed sqrt rejected,
// x == 0 with the sign bit set rejected), builds the 9-entry niels table of
// -A, runs the 64-step signed radix-16 Strauss loop over digit rows 63..0
// (4 doublings; + (+-)A[|k|] and + (+-)B[|s|] in niels form) and compares
// [k](-A) + [s]B with R by the Z_r = 1 cross-multiply.  Output: one byte
// per lane, 1 = equal.
//
// What bounds it: 32-bit integer multiply-add issue.  Per lane the verify
// function needs 1,550 squarings and 1,821 multiplications: (255, 20) for
// each of the two decompressions, (16, 51) to build the -A table,
// (1,024, 1,728) in the 64-step loop and (0, 2) for the final compare
// (verify_core.field_ops_per_lane()).  A multiplication is 100 32x32->64
// products and a squaring 55, 267,350 products per lane
// (verify_core.products_per_lane()), about 131 us for B = 4096 lanes at
// the card's 8.4e12 32x32->64 multiply-adds (IMAD.WIDE) per second, half
// its 32-bit IMAD rate (chip_smoke.py's sass phase measures both).
//
// Design, and what it does about that bound:
//  * Teams.  B = 4096 lanes at one thread each fill 128 one-warp blocks:
//    one warp on an SM, stalled on every dependent product and carry.  So a
//    lane runs as a team of 4 consecutive threads of one warp, 8 lanes per
//    warp, 32 lanes (128 threads) per block: 16,384 threads at B = 4096,
//    one warp per SM sub-partition.  Member m holds coordinate m of the
//    accumulator (X, Y, Z, T) and of every niels entry, in the order
//    (Y-X, Y+X, 2Z, 2dT).  A doubling or a niels addition is then two
//    rounds of one field product per member (the four-way parallel forms of
//    Hisil, Wong, Carter and Dawson, "Twisted Edwards Curves Revisited",
//    2008), with __shfl_sync exchanges before and between the rounds:
//    12 rounds per Strauss step where one thread ran about 47 products in
//    sequence.  Every member runs the same instructions; what differs by
//    member is chosen by selects (t_pick4), so no path diverges.
//  * Decompression.  Members 0 and 2 decompress A while members 1 and 3
//    decompress R: the two sqrt chains run side by side.
//  * Products.  fe_sq takes 55 products, each product is one mad.wide.s32
//    and every field product is inlined (ed25519.cuh): one coordinate per
//    thread leaves the register room, so nothing spills.
//  * State.  The -A table is built by the team and kept in shared memory,
//    member m's coordinate of entry i at [i][limb][thread], so the loads of
//    a warp hit 32 banks whatever the digits (9 slots x 10 limbs x 128
//    threads, 46,080 bytes per block; slot 8 keeps R's x and y for the
//    final compare).  The base table, stored in team order, and the field
//    constants are staged in shared memory as well: 47,640 bytes in all,
//    under the 48 KB of static shared memory.
//  * The ragged edge.  A shuffle needs all 32 threads of the warp, so
//    every team runs every round: a lane >= B loads lane B - 1's inputs
//    and stores nothing.  A lane whose decompression failed runs on and
//    masks its verdict.
// Register, shared-memory and spill counts: the build log that
// utils/kbuild.py keeps (nvcc -Xptxas -v), printed by chip_smoke.py.
//
// Compiled without __CUDACC__ (plain C++), the same team code builds a host
// library (fdt_verify_core_host): a team element there holds all four
// members' values, every operation runs over the members in turn and a
// shuffle reads another member's entry, so the library computes exactly
// what the card does.  The CPU tests hold it against the plain PyTorch
// version; the port itself only ever launches the kernel.

#include "team.cuh"

#define VC_LANES_PER_BLOCK 32
#define VC_THREADS (TEAM * VC_LANES_PER_BLOCK)
#define VC_SLOTS 9           // -A table entries 1..8, then R's x and y
#define VC_R_SLOT 8
#define VC_BTAB (9 * TEAM * 10)  // base table, [entry][member][limb]

// Base table word i in team order: member 0 takes y-x, member 1 y+x,
// member 2 2Z = 2 (affine entries), member 3 2dxy.
FDT_FN int32_t btab_word(const int32_t* consts, int i) {
  const int e = i / (TEAM * 10), m = (i / 10) % TEAM, l = i % 10;
  const int32_t* src = consts + C_BTAB + 30 * e;  // (y+x, y-x, 2dxy)
  if (m == 0) return src[10 + l];
  if (m == 1) return src[l];
  if (m == 3) return src[20 + l];
  return l == 0 ? 2 : 0;
}

// Member m's coordinate of a signed table entry read from `e` (member c's
// limb l at e[c * cs + l * ls]): a negative digit swaps members 0 and 1
// (Y-X <-> Y+X) and negates member 3 (2dT).
FDT_FN fe entry_coord(const int32_t* e, int cs, int ls, bool neg, int m) {
  const int c = (neg && m < 2) ? (m ^ 1) : m;
  fe v;
  FDT_UNROLL
  for (int l = 0; l < 10; l++) v.v[l] = e[c * cs + l * ls];
  return fe_select(v, fe_neg(v), neg && m == 3);
}

// Member m's coordinate of entry d of the -A table (rows of `nt` threads,
// the team's first at column `base`); entry 0, the identity (1, 1, 2, 0),
// is not stored.
FDT_FN fe atab_coord(const int32_t* atab, int nt, int base, int d, int m) {
  const int a = digit_abs(d);
  const fe v = entry_coord(atab + (a > 0 ? a - 1 : 0) * 10 * nt + base, 1,
                           nt, d < 0, m);
  fe id = fe_zero();
  id.v[0] = m < 2 ? 1 : (m == 2 ? 2 : 0);
  return fe_select(v, id, a == 0);
}

FDT_FN fe btab_coord(const int32_t* btab, int d, int m) {
  return entry_coord(btab + digit_abs(d) * TEAM * 10, 10, 1, d < 0, m);
}

// ---------------------------------------------------------------------------
// The verify core's own team functions (the team layer itself, the point
// formulas and the host build's team element are in team.cuh).
// ---------------------------------------------------------------------------

#ifdef __CUDACC__

#define VC_NT VC_THREADS  // threads per shared -A table row

FDT_FN int t_eq(const fe& a, const fe& b) { return fe_eq(a, b); }

// Members 0 and 2 decompress lane `lane`'s A, members 1 and 3 its R.
FDT_FN ge t_decompress(const int32_t* ay, const int32_t* asg,
                       const int32_t* ry, const int32_t* rsg,
                       const int32_t* cst, int B, int lane, int* ok) {
  const bool r = t_member() & 1;
  bool okb;
  const ge p = ge_decompress(fe_from_limbs13(r ? ry : ay, B, lane),
                             FDT_LDG((r ? rsg : asg) + lane), cst, &okb);
  *ok = okb;
  return p;
}

FDT_FN void t_store(int32_t* atab, int slot, const fe& v) {
  FDT_UNROLL
  for (int l = 0; l < 10; l++)
    atab[(slot * 10 + l) * VC_NT + threadIdx.x] = v.v[l];
}

FDT_FN fe t_load(const int32_t* atab, int slot) {
  fe v;
  FDT_UNROLL
  for (int l = 0; l < 10; l++) v.v[l] = atab[(slot * 10 + l) * VC_NT + threadIdx.x];
  return v;
}

FDT_FN fe t_atab_entry(const int32_t* atab, int d) {
  return atab_coord(atab, VC_NT, t_base(), d, t_member());
}

FDT_FN fe t_btab_entry(const int32_t* btab, int d) {
  return btab_coord(btab, d, t_member());
}

#else  // host build: all four members in one thread

#define VC_NT TEAM

static inline tint t_eq(const tfe& a, const tfe& b) {
  tint r;
  T_EACH r.m[m] = fe_eq(a.m[m], b.m[m]);
  return r;
}
static inline tge t_decompress(const int32_t* ay, const int32_t* asg,
                               const int32_t* ry, const int32_t* rsg,
                               const int32_t* cst, int B, int lane, tint* ok) {
  tge p;
  T_EACH {
    const bool r = m & 1;
    bool okb;
    const ge q = ge_decompress(fe_from_limbs13(r ? ry : ay, B, lane),
                               (r ? rsg : asg)[lane], cst, &okb);
    ok->m[m] = okb;
    p.x.m[m] = q.x;
    p.y.m[m] = q.y;
    p.z.m[m] = q.z;
    p.t.m[m] = q.t;
  }
  return p;
}
static inline void t_store(int32_t* atab, int slot, const tfe& v) {
  T_EACH for (int l = 0; l < 10; l++) atab[(slot * 10 + l) * VC_NT + m] = v.m[m].v[l];
}
static inline tfe t_load(const int32_t* atab, int slot) {
  tfe r;
  T_EACH for (int l = 0; l < 10; l++) r.m[m].v[l] = atab[(slot * 10 + l) * VC_NT + m];
  return r;
}
static inline tfe t_atab_entry(const int32_t* atab, int d) {
  tfe r;
  T_EACH r.m[m] = atab_coord(atab, VC_NT, 0, d, m);
  return r;
}
static inline tfe t_btab_entry(const int32_t* btab, int d) {
  tfe r;
  T_EACH r.m[m] = btab_coord(btab, d, m);
  return r;
}

#endif

// The whole verify core of lane `lane`, run by its team; the verdict on
// every member.  cst: D, 2D, sqrt(-1) (shared memory on the card); btab:
// the base table in team order; atab: the -A table rows; k, s: (64, B)
// digits; ay, ry: (20, B) y limbs; asg, rsg: (B,) sign bits.
FDT_FN bool verify_team(const int32_t* cst, const int32_t* btab,
                        int32_t* atab, const int32_t* k, const int32_t* s,
                        const int32_t* ay, const int32_t* asg,
                        const int32_t* ry, const int32_t* rsg, int B,
                        int lane) {
  const tfe one = t_all(fe_one()), zero = t_all(fe_zero());
  tint ok;
  const tge pt = t_decompress(ay, asg, ry, rsg, cst, B, lane, &ok);

  // -A = (-x, y, 1, -xy) from member 0; slot 8 keeps R's x (member 0) and
  // y (member 1) for the final compare
  const tfe na = t_pick4(fe_neg(t_from(pt.x, 0)), t_from(pt.y, 0), one,
                         fe_neg(t_from(pt.t, 0)));
  t_store(atab, VC_R_SLOT, t_pick4(t_from(pt.x, 1), pt.y, pt.y, pt.y));

  // the -A table: entry i = i (-A) in slot i - 1; the niels form of -A is
  // read back from slot 0 (this member's own column) where it is added,
  // and at most two points are live, to keep registers for the products
  const tfe d2 = t_all(fe_load(cst + C_D2));
  t_store(atab, 0, t_niels(na, one, d2));
  const tfe p2 = t_double(na);
  t_store(atab, 1, t_niels(p2, one, d2));
  const tfe p3 = t_add(p2, t_load(atab, 0));
  t_store(atab, 2, t_niels(p3, one, d2));
  const tfe p4 = t_double(p2);
  t_store(atab, 3, t_niels(p4, one, d2));
  t_store(atab, 4, t_niels(t_add(p4, t_load(atab, 0)), one, d2));
  t_store(atab, 7, t_niels(t_double(p4), one, d2));
  const tfe p6 = t_double(p3);
  t_store(atab, 5, t_niels(p6, one, d2));
  t_store(atab, 6, t_niels(t_add(p6, t_load(atab, 0)), one, d2));
  t_sync();

  tfe acc = t_pick4(zero, one, one, zero);
  FDT_NO_UNROLL
  for (int idx = 63; idx >= 0; idx--) {
    const int kd = FDT_LDG(k + (int64_t)idx * B + lane);
    const int sd = FDT_LDG(s + (int64_t)idx * B + lane);
    FDT_NO_UNROLL
    for (int j = 0; j < 4; j++) acc = t_double(acc);
    acc = t_add(acc, t_atab_entry(atab, kd));
    acc = t_add(acc, t_btab_entry(btab, sd));
  }

  // acc == R with Z_r == 1: X == x_r Z (member 0) and Y == y_r Z (member 1)
  const tint eq = t_eq(fe_mul(t_load(atab, VC_R_SLOT), t_from(acc, 2)), acc);
  return t_from(ok, 0) && t_from(ok, 1) && t_from(eq, 0) && t_from(eq, 1);
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(VC_THREADS)
verify_core_kernel(const int32_t* __restrict__ consts,
                   const int32_t* __restrict__ k,
                   const int32_t* __restrict__ s,
                   const int32_t* __restrict__ ay,
                   const int32_t* __restrict__ asg,
                   const int32_t* __restrict__ ry,
                   const int32_t* __restrict__ rsg,
                   uint8_t* __restrict__ out, int B) {
  __shared__ int32_t cst[C_BTAB];
  __shared__ int32_t btab[VC_BTAB];
  __shared__ int32_t atab[VC_SLOTS * 10 * VC_THREADS];
  for (int i = threadIdx.x; i < C_BTAB; i += blockDim.x) cst[i] = consts[i];
  for (int i = threadIdx.x; i < VC_BTAB; i += blockDim.x)
    btab[i] = btab_word(consts, i);
  __syncthreads();
  const int lane = blockIdx.x * VC_LANES_PER_BLOCK + threadIdx.x / TEAM;
  const bool ok = verify_team(cst, btab, atab, k, s, ay, asg, ry, rsg, B,
                              lane < B ? lane : B - 1);
  if (t_member() == 0 && lane < B) out[lane] = ok ? 1 : 0;
}

extern "C" cudaError_t fdt_verify_core_launch(
    const int32_t* consts, const int32_t* k, const int32_t* s,
    const int32_t* ay, const int32_t* asg, const int32_t* ry,
    const int32_t* rsg, uint8_t* out, int B, void* stream) {
  if (B <= 0) return cudaSuccess;
  const int blocks = (B + VC_LANES_PER_BLOCK - 1) / VC_LANES_PER_BLOCK;
  verify_core_kernel<<<blocks, VC_THREADS, 0, (cudaStream_t)stream>>>(
      consts, k, s, ay, asg, ry, rsg, out, B);
  return cudaGetLastError();
}

#else  // plain C++: the host build the CPU tests hold against the plain path

extern "C" void fdt_verify_core_host(const int32_t* consts, const int32_t* k,
                                     const int32_t* s, const int32_t* ay,
                                     const int32_t* asg, const int32_t* ry,
                                     const int32_t* rsg, uint8_t* out,
                                     int B) {
  int32_t btab[VC_BTAB];
  for (int i = 0; i < VC_BTAB; i++) btab[i] = btab_word(consts, i);
  int32_t atab[VC_SLOTS * 10 * VC_NT];
  for (int lane = 0; lane < B; lane++)
    out[lane] = verify_team(consts, btab, atab, k, s, ay, asg, ry, rsg, B,
                            lane) ? 1 : 0;
}

// The field products alone, on n elements of 10 radix-2^25.5 limbs (the
// CPU tests check fe_sq against fe_mul and Python integers).
extern "C" void fdt_fe_mul_host(const int32_t* f, const int32_t* g,
                                int32_t* out, int n) {
  for (int i = 0; i < n; i++) {
    const fe r = fe_mul(fe_load(f + 10 * i), fe_load(g + 10 * i));
    for (int l = 0; l < 10; l++) out[10 * i + l] = r.v[l];
  }
}

extern "C" void fdt_fe_sq_host(const int32_t* f, int32_t* out, int n) {
  for (int i = 0; i < n; i++) {
    const fe r = fe_sq(fe_load(f + 10 * i));
    for (int l = 0; l < 10; l++) out[10 * i + l] = r.v[l];
  }
}

#endif
