// team.cuh -- the four-thread team layer shared by the port's team kernels
// (verify_core.cu, msm.cu).
//
// A team is 4 consecutive threads of one warp that together hold one
// extended point: member m holds coordinate m of (X, Y, Z, T), and of a
// niels entry in the order (Y-X, Y+X, 2Z, 2dT).  A doubling or a niels
// addition is then two rounds of one field product per member (the
// four-way parallel forms of Hisil, Wong, Carter and Dawson, "Twisted
// Edwards Curves Revisited", 2008), with exchanges before and between the
// rounds.  Every member runs the same instructions; what differs by member
// is chosen by selects (t_pick4), so no path diverges, and every exchange
// is a warp shuffle that all 32 threads of the warp must reach.
//
// On the card a team element (tfe) is this member's field element and an
// exchange is a warp shuffle.  In the host build (plain C++) a tfe holds
// the four members' elements, each operation runs over them in turn and an
// exchange reads another member's entry, so the host library of a kernel
// source computes exactly what the card does.

#ifndef FDT_TEAM_CUH
#define FDT_TEAM_CUH

#include "ed25519.cuh"

#define TEAM 4

// |digit| clamped to the 8 table entries or buckets, so that a malformed
// digit cannot index out of bounds (to_signed_digits makes digits in
// [-8, 7])
FDT_FN int digit_abs(int d) { return d < 0 ? (d < -8 ? 8 : -d) : (d > 8 ? 8 : d); }

#ifdef __CUDACC__

typedef fe tfe;
typedef ge tge;
typedef int tint;

FDT_FN int t_member() { return threadIdx.x & (TEAM - 1); }
FDT_FN int t_base() { return threadIdx.x & ~(TEAM - 1); }

// member j's v, on every member of the team
FDT_FN fe t_from(const fe& v, int j) {
  const int src = (threadIdx.x & (32 - TEAM)) | j;
  fe r;
  FDT_UNROLL
  for (int i = 0; i < 10; i++) r.v[i] = __shfl_sync(0xffffffffu, v.v[i], src);
  return r;
}

FDT_FN int t_from(int v, int j) {
  return __shfl_sync(0xffffffffu, v, (threadIdx.x & (32 - TEAM)) | j);
}

// the partner's v: members 0 <-> 1, 2 <-> 3
FDT_FN fe t_partner(const fe& v) {
  fe r;
  FDT_UNROLL
  for (int i = 0; i < 10; i++) r.v[i] = __shfl_xor_sync(0xffffffffu, v.v[i], 1);
  return r;
}

// member m takes vm
FDT_FN fe t_pick4(const fe& v0, const fe& v1, const fe& v2, const fe& v3) {
  const int m = t_member();
  fe r;
  FDT_UNROLL
  for (int i = 0; i < 10; i++)
    r.v[i] = (m & 2) ? ((m & 1) ? v3.v[i] : v2.v[i])
                     : ((m & 1) ? v1.v[i] : v0.v[i]);
  return r;
}

FDT_FN fe t_all(const fe& v) { return v; }

// the team's table stores before its loads
FDT_FN void t_sync() { __syncwarp(); }

#else  // host build: all four members in one thread

struct tfe {
  fe m[TEAM];
};
struct tge {
  tfe x, y, z, t;
};
struct tint {
  int m[TEAM];
};
#define T_EACH for (int m = 0; m < TEAM; m++)

static inline tfe fe_add(const tfe& a, const tfe& b) {
  tfe r;
  T_EACH r.m[m] = fe_add(a.m[m], b.m[m]);
  return r;
}
static inline tfe fe_sub(const tfe& a, const tfe& b) {
  tfe r;
  T_EACH r.m[m] = fe_sub(a.m[m], b.m[m]);
  return r;
}
static inline tfe fe_neg(const tfe& a) {
  tfe r;
  T_EACH r.m[m] = fe_neg(a.m[m]);
  return r;
}
static inline tfe fe_mul(const tfe& a, const tfe& b) {
  tfe r;
  T_EACH r.m[m] = fe_mul(a.m[m], b.m[m]);
  return r;
}
static inline tfe fe_sq(const tfe& a) {
  tfe r;
  T_EACH r.m[m] = fe_sq(a.m[m]);
  return r;
}
static inline tfe t_from(const tfe& v, int j) {
  tfe r;
  T_EACH r.m[m] = v.m[j];
  return r;
}
static inline int t_from(const tint& v, int j) { return v.m[j]; }
static inline tfe t_partner(const tfe& v) {
  tfe r;
  T_EACH r.m[m] = v.m[m ^ 1];
  return r;
}
static inline tfe t_pick4(const tfe& v0, const tfe& v1, const tfe& v2,
                          const tfe& v3) {
  const tfe* v[TEAM] = {&v0, &v1, &v2, &v3};
  tfe r;
  T_EACH r.m[m] = v[m]->m[m];
  return r;
}
static inline tfe t_all(const fe& v) {
  tfe r;
  T_EACH r.m[m] = v;
  return r;
}
static inline void t_sync() {}

#endif

// ---------------------------------------------------------------------------
// Team point formulas (a = -1).  A point is (X, Y, Z, T) on members 0..3, a
// niels entry (Y-X, Y+X, 2Z, 2dT); every operand below is a combination of
// at most four carried elements (ed25519.cuh's bound).
// ---------------------------------------------------------------------------

// 2p, dbl-2008-hwcd: X^2, Y^2, Z^2, (X+Y)^2 in one round, then E F, G H,
// F G, E H
FDT_FN tfe t_double(const tfe& p) {
  const tfe s = fe_sq(t_pick4(p, p, p, fe_add(t_from(p, 0), t_from(p, 1))));
  const tfe a = t_from(s, 0), b = t_from(s, 1);
  const tfe zz = t_from(s, 2), xy2 = t_from(s, 3);
  const tfe g = fe_sub(b, a);
  const tfe h = fe_neg(fe_add(a, b));
  const tfe e = fe_add(xy2, h);
  const tfe f = fe_sub(fe_sub(g, zz), zz);
  return fe_mul(t_pick4(e, g, f, e), t_pick4(f, h, g, h));
}

// p + n, add-2008-hwcd-3 on a niels entry: (Y-X)(Y-X)', (Y+X)(Y+X)',
// Z 2Z', T 2dT' in one round, then E F, G H, F G, E H
FDT_FN tfe t_add(const tfe& p, const tfe& n) {
  const tfe o = t_partner(p);  // member 0: Y, member 1: X
  const tfe r = fe_mul(t_pick4(fe_sub(o, p), fe_add(p, o), p, p), n);
  const tfe a = t_from(r, 0), b = t_from(r, 1);
  const tfe d = t_from(r, 2), c = t_from(r, 3);
  const tfe e = fe_sub(b, a), h = fe_add(b, a);
  const tfe f = fe_sub(d, c), g = fe_add(d, c);
  return fe_mul(t_pick4(e, g, f, e), t_pick4(f, h, g, h));
}

// The niels entry of p: Y-X, Y+X, 2Z, 2dT, all carried (one round: members
// 0..2 multiply by one)
FDT_FN tfe t_niels(const tfe& p, const tfe& one, const tfe& d2) {
  const tfe o = t_partner(p);  // member 0: Y, member 1: X
  return fe_mul(t_pick4(fe_sub(o, p), fe_add(p, o), fe_add(p, p), p),
                t_pick4(one, one, one, d2));
}

#endif  // FDT_TEAM_CUH
