// msm.cu -- Pippenger bucket accumulation of the RLC batch equation for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel firedancer_tpu/ops/ed25519/msm_kernel.py
// :: _msm_kernel (wrapper msm_check).  The batch equation's right-hand side
// is the 2B-point MSM  sum_i [c_i] A_i + sum_i [z_i] R_i  over signed
// radix-16 digits; this kernel sorts every (window, point) term into
// buckets: the term d * 16^w * P goes to bucket |d| of window w as +-P.
// The bucket combine, the Horner spine over windows and the comparison with
// [u]B are plain PyTorch after it (ops/ed25519/msm.py::msm_finalize).
//
// Bucket sets.  There is one digit row per window, 64 in all.  Each window
// has S lane slots (S a power of two); bucket set (window, slot) holds 8
// buckets, one per |digit| in 1..8, and receives the lanes i = slot,
// slot + S, slot + 2S, ... in that order: for each lane +-A_i by the c
// digit, then, in the first 33 windows (z < 2^128), +-R_i by the z digit.
// Output: buckets (64, 8, 4, 20, S) int32, extended coordinates (X, Y, Z,
// T) in 20 canonical radix-2^13 limbs; the window sum is
//   W_w = sum_v v * sum_slots bucket(w, v),
// the TPU kernel's window sum.  Hopper blocks run in parallel and in no
// order, and a point addition has no atomic, so each set is accumulated by
// one owner in this fixed order, and the kernel equals its plain version
// (msm_buckets_plain) bit for bit after canonicalisation.
//
// What bounds it: the function needs one affine-niels addition with T per
// nonzero digit, 7 multiplications of 100 32x32->64 products: at most
// 97 x 700 = 67,900 products per lane (msm.py::msm_products counts this
// run's nonzero digits), 0.0309 ms for B = 4096 at the card's 8.4e12
// 32x32->64 multiply-adds (IMAD.WIDE) per second, half its 32-bit IMAD
// rate.  The output is 64 x 8 x 80 x 4 bytes per slot, 41.9 MB at S = 256,
// 0.0125 ms at 3.35 TB/s: the products bound it.  The team below runs 8
// products per addition (member 2 multiplies Z by the entry's 2Z = 2) and
// adds zero digits into a trash bucket, 800 products for each of the
// 97 x B terms at B = 4096 (msm.py::msm_kernel_products counts them),
// 0.0380 ms at that rate.  Around its 200 products a team step also issues
// the radix-2^13 conversion, the address arithmetic, the x19 folds and the
// 64-bit carries, much of it on the same multiply-add pipe (chip_smoke.py's
// sass phase counts the step loop's instructions).
//
// Design, and what it does about that bound:
//  * Teams.  A bucket set is run by a team of 4 consecutive threads of one
//    warp (csrc/team.cuh, as verify_core.cu's lanes are): member m holds
//    coordinate m of every bucket, and an addition is t_add, two rounds of
//    one product per member with warp shuffles between them, in place of
//    one thread running all 7 products in sequence.  The niels entry comes
//    in team order (Y-X, Y+X, 2Z, 2dT) = (ymx, ypx, 2, t2d), ymx and ypx
//    swapped and t2d negated for a negative digit; its E, F, G and H are
//    the values of ge_add_niels_affine (ed25519.cuh) and of
//    point.add_niels_affine, so the sums equal the plain version's.  Each
//    member converts only its own coordinate from radix 2^13.  64 x S teams,
//    65,536 threads at S = 256 where one thread per set made 16,384.
//  * Buckets in shared memory.  9 buckets per set, bucket 0 the TPU
//    kernel's trash bucket, member m's coordinate of bucket b at
//    [b][limb][thread], as verify_core's -A table: a warp's loads and
//    stores hit 32 banks whatever the digits (9 x 10 x 4 = 360 bytes a
//    thread, 46,080 bytes per block of 128 threads).  A thread reads and
//    writes only its own column, so no barrier is needed; every exchange
//    between members is a shuffle.  A zero digit, and a lane >= B at the
//    ragged edge, adds into bucket 0, so every team runs every round and
//    every shuffle with no branch; bucket 0 is never written out.
//  * Balanced waves.  Windows 0..32 carry two additions per lane, the
//    other 31 one.  Team t takes window t / S and slot t % S, so the heavy
//    windows fill the first blocks and are dispatched first.  At S = 256
//    there are 512 blocks of 128 threads.  The team code fits in 128
//    registers a thread (__launch_bounds__ below; ptxas: 128, no spills,
//    no stack), so 4 blocks fit an SM by registers (65,536 / (128 x 128))
//    and by shared memory (4 x 46,080 bytes of the SM's 228 KB; 5 do not),
//    528 block slots on 132 SMs: one wave.  Blocks dispatched in order
//    across the SMs put about 2 heavy and 2 light blocks on an SM, and 2
//    heavy and 2 light warps on each SM sub-partition (4 warps, where one
//    thread per set left one).  All the teams of a block run one loop
//    count, set by the block's first team: 2n steps for a heavy window (n
//    = ceil(B / S) lanes per slot), n for a light one.  A light team in a
//    heavy block (only where S < 32) runs past n onto lanes >= B, the
//    trash bucket.  A count that depends on the block alone lets the
//    compiler see that every warp reaches every shuffle whole.
//  * Prefetch.  The entry of step k + 1 (its digit and this member's 20
//    limbs) is loaded before step k's addition runs, so the loads are in
//    flight during the products.
//  * The ragged edge.  A shuffle needs all 32 threads of the warp, so no
//    team returns early: a lane >= B loads lane B - 1's entry, adds it into
//    bucket 0 and stores nothing.
// Register, shared-memory and spill counts: the build log that
// utils/kbuild.py keeps (nvcc -Xptxas -v), printed by chip_smoke.py.
//
// Compiled without __CUDACC__ (plain C++), the same team code builds a host
// library (fdt_msm_buckets_host) that runs one team at a time, its four
// members in one thread (team.cuh), and computes what the card does; it
// also counts the team additions it runs (fdt_msm_adds_host).  The CPU
// tests hold it against the plain PyTorch version.

#include "team.cuh"

#define MSM_WIN 64   // windows of c = z k mod L
#define MSM_ZWIN 33  // windows of z < 2^128
#define MSM_BUCKETS 8
#define MSM_NB (MSM_BUCKETS + 1)  // bucket 0: the trash bucket
#define MSM_TEAMS_PER_BLOCK 32
#define MSM_THREADS (TEAM * MSM_TEAMS_PER_BLOCK)
#define MSM_MIN_BLOCKS 4  // blocks per SM the registers must allow

// Row of n3 (rows y+x, y-x, 2dxy of 20 radix-2^13 limbs) that member m's
// coordinate of a niels entry in team order (Y-X, Y+X, 2Z, 2dT) comes
// from: a negative digit swaps members 0 and 1 (member 2's 2Z is the
// constant 2 and reads the 2dxy row for nothing).
FDT_FN int niels_row(bool neg, int m) {
  const int c = (neg && m < 2) ? (m ^ 1) : m;
  return c == 0 ? 20 : (c == 1 ? 0 : 40);
}

// Element of 20 radix-2^13 limbs y already in registers (fe_from_limbs13
// loads them itself; here they are loaded a step ahead)
FDT_FN fe fe_from_raw13(const int32_t* y) {
  int64_t c[10];
  for (int k = 0; k < 10; k++) c[k] = 0;
  FDT_UNROLL
  for (int i = 0; i < 20; i++) {
    const int bit = 13 * i;
    const int k = (2 * bit) / 51 < 9 ? (2 * bit) / 51 : 9;
    c[k] += (int64_t)y[i] * ((int64_t)1 << (bit - fe_pos(k)));
  }
  return fe_carry_wide(c);
}

// Member m's coordinate of the signed entry from its row's element v:
// member 3's 2dT negated for a negative digit, member 2's 2Z = 2
FDT_FN fe niels_coord(const fe& v, bool neg, int m) {
  fe two = fe_zero();
  two.v[0] = 2;
  return fe_select(fe_select(v, fe_neg(v), neg && m == 3), two, m == 2);
}

// Member m's coordinate of the identity (0, 1, 1, 0)
FDT_FN fe identity_coord(int m) {
  fe r = fe_zero();
  r.v[0] = (m == 1 || m == 2) ? 1 : 0;
  return r;
}

#ifdef __CUDACC__

// this member's coordinate of bucket b: shared [bucket][limb][thread]
FDT_FN fe t_bucket(const int32_t* bk, int b) {
  fe v;
  FDT_UNROLL
  for (int l = 0; l < 10; l++) v.v[l] = bk[(b * 10 + l) * MSM_THREADS + threadIdx.x];
  return v;
}

FDT_FN void t_bucket_store(int32_t* bk, int b, const fe& v) {
  FDT_UNROLL
  for (int l = 0; l < 10; l++) bk[(b * 10 + l) * MSM_THREADS + threadIdx.x] = v.v[l];
}

// this member's 20 raw limbs of lane `lane`'s entry for digit d
struct traw {
  int32_t y[20];
};

FDT_FN traw t_fetch(const int32_t* n3, int B, int lane, int d) {
  const int32_t* p = n3 + (int64_t)niels_row(d < 0, t_member()) * B + lane;
  traw r;
  FDT_UNROLL
  for (int i = 0; i < 20; i++) r.y[i] = FDT_LDG(p + (int64_t)i * B);
  return r;
}

FDT_FN fe t_entry(const traw& r, int d) {
  return niels_coord(fe_from_raw13(r.y), d < 0, t_member());
}

FDT_FN fe t_identity() { return identity_coord(t_member()); }

// this member's coordinate of every bucket 1..8 of set (w, slot) into the
// (64, 8, 4, 20, S) output
FDT_FN void t_flush(const int32_t* bk, int32_t* out, int S, int w, int slot) {
  const int m = t_member();
  FDT_NO_UNROLL
  for (int b = 1; b < MSM_NB; b++)
    fe_to_limbs13(t_bucket(bk, b),
                  out + ((int64_t)((w * MSM_BUCKETS + b - 1) * 4 + m)) * 20 * S,
                  S, slot);
}

FDT_FN void t_count_add() {}

#else  // host build: the team's four members in one thread

static long msm_adds;  // team additions of the last fdt_msm_buckets_host

static inline tfe t_bucket(const int32_t* bk, int b) {
  tfe r;
  T_EACH for (int l = 0; l < 10; l++) r.m[m].v[l] = bk[(b * 10 + l) * TEAM + m];
  return r;
}

static inline void t_bucket_store(int32_t* bk, int b, const tfe& v) {
  T_EACH for (int l = 0; l < 10; l++) bk[(b * 10 + l) * TEAM + m] = v.m[m].v[l];
}

struct traw {
  int32_t y[TEAM][20];
};

static inline traw t_fetch(const int32_t* n3, int B, int lane, int d) {
  traw r;
  T_EACH {
    const int32_t* p = n3 + (int64_t)niels_row(d < 0, m) * B + lane;
    for (int i = 0; i < 20; i++) r.y[m][i] = p[(int64_t)i * B];
  }
  return r;
}

static inline tfe t_entry(const traw& r, int d) {
  tfe e;
  T_EACH e.m[m] = niels_coord(fe_from_raw13(r.y[m]), d < 0, m);
  return e;
}

static inline tfe t_identity() {
  tfe r;
  T_EACH r.m[m] = identity_coord(m);
  return r;
}

static inline void t_flush(const int32_t* bk, int32_t* out, int S, int w,
                           int slot) {
  for (int b = 1; b < MSM_NB; b++) {
    const tfe v = t_bucket(bk, b);
    T_EACH fe_to_limbs13(v.m[m],
                         out + ((int64_t)((w * MSM_BUCKETS + b - 1) * 4 + m)) * 20 * S,
                         S, slot);
  }
}

static inline void t_count_add() { msm_adds++; }

#endif

// Step k of bucket set (w, slot): its lane, clamped to B - 1; whether it
// adds R (a heavy set adds lane i's A, then its R); its digit, 0 past B.
struct msm_at {
  int ln, d;
  bool r;
};

FDT_FN msm_at msm_step(const int32_t* cdig, const int32_t* zdig, int B, int S,
                       int w, int slot, int k) {
  const bool heavy = w < MSM_ZWIN;
  msm_at s;
  s.r = heavy && (k & 1);
  const int lane = slot + (heavy ? k >> 1 : k) * S;
  const bool live = lane < B;
  s.ln = live ? lane : B - 1;
  s.d = live ? FDT_LDG((s.r ? zdig : cdig) + (int64_t)w * B + s.ln) : 0;
  return s;
}

// Bucket set t of 64 S (window t / S, slot t % S), run by its team over
// its buckets `bk`; t_first, the first team of its block, sets the loop
// count.  cdig (64, B), zdig (33, B) digits; an3, rn3 (60, B) affine niels
// of A and R.  The entry of step k + 1 is loaded before step k's addition,
// so its loads are in flight while the products run.
FDT_FN void msm_team(const int32_t* cdig, const int32_t* zdig,
                     const int32_t* an3, const int32_t* rn3, int32_t* out,
                     int32_t* bk, int B, int S, int t, int t_first) {
  const int w = t / S, slot = t % S;
  const int n = (B + S - 1) / S;
  const int steps = t_first / S < MSM_ZWIN ? 2 * n : n;
  for (int b = 0; b < MSM_NB; b++) t_bucket_store(bk, b, t_identity());
  if (B > 0) {  // the same on every thread: an empty batch loads nothing
    msm_at s = msm_step(cdig, zdig, B, S, w, slot, 0);
    traw y = t_fetch(s.r ? rn3 : an3, B, s.ln, s.d);
    FDT_NO_UNROLL
    for (int k = 0; k < steps; k++) {
      const int a = digit_abs(s.d);
      const tfe e = t_entry(y, s.d);
      s = msm_step(cdig, zdig, B, S, w, slot, k + 1);
      y = t_fetch(s.r ? rn3 : an3, B, s.ln, s.d);
      t_bucket_store(bk, a, t_add(t_bucket(bk, a), e));
      t_count_add();
    }
  }
  t_flush(bk, out, S, w, slot);
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(MSM_THREADS, MSM_MIN_BLOCKS)
msm_buckets_kernel(const int32_t* __restrict__ cdig,
                   const int32_t* __restrict__ zdig,
                   const int32_t* __restrict__ an3,
                   const int32_t* __restrict__ rn3, int32_t* __restrict__ out,
                   int B, int S) {
  __shared__ int32_t bk[MSM_NB * 10 * MSM_THREADS];
  // the loop count depends on the block alone, so every warp runs it whole
  msm_team(cdig, zdig, an3, rn3, out, bk, B, S,
           blockIdx.x * MSM_TEAMS_PER_BLOCK + threadIdx.x / TEAM,
           blockIdx.x * MSM_TEAMS_PER_BLOCK);
}

extern "C" cudaError_t fdt_msm_buckets_launch(const int32_t* cdig,
                                              const int32_t* zdig,
                                              const int32_t* an3,
                                              const int32_t* rn3,
                                              int32_t* out, int B, int S,
                                              void* stream) {
  if (S <= 0) return cudaSuccess;
  // 64 S teams, 32 to a block
  const int blocks = MSM_WIN * S / MSM_TEAMS_PER_BLOCK;
  msm_buckets_kernel<<<blocks, MSM_THREADS, 0, (cudaStream_t)stream>>>(
      cdig, zdig, an3, rn3, out, B, S);
  return cudaGetLastError();
}

#else  // plain C++: the host build the CPU tests hold against the plain path

extern "C" void fdt_msm_buckets_host(const int32_t* cdig, const int32_t* zdig,
                                     const int32_t* an3, const int32_t* rn3,
                                     int32_t* out, int B, int S) {
  int32_t bk[MSM_NB * 10 * TEAM];
  msm_adds = 0;
  for (int t = 0; t < MSM_WIN * S; t++)
    msm_team(cdig, zdig, an3, rn3, out, bk, B, S, t,
             t & ~(MSM_TEAMS_PER_BLOCK - 1));
}

// team additions run by the last fdt_msm_buckets_host call
extern "C" long fdt_msm_adds_host() { return msm_adds; }

#endif
