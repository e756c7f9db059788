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
//  * Limbs.  ref10's radix 2^25.5 x 10 limbs with 32x32->64 products, from
//    the shared field and point code in ed25519.cuh (its note gives the
//    carry discipline).  The radix-13 y limbs are converted at load; the
//    interface (digits, y limbs, sign bits in; one bool per lane out) is
//    the TPU kernel's.
//  * Grid.  One thread per lane, 32 threads per block, a 1-D grid over B;
//    the ragged edge is masked here instead of padding B to 256.  Nothing
//    carries between blocks.
//  * State.  The -A table (9 entries x 4 coordinates x 10 limbs) is
//    indexed by a per-lane digit, so it lives in local memory (L1-backed).
//    The base table and the field constants are staged in shared memory
//    (not __constant__: lanes read different entries).
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

#include "ed25519.cuh"

#define LANES_PER_BLOCK 32

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

  ge acc = ge_identity();
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
                              fe_select(bt2d, fe_neg(bt2d), sd < 0), false);
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
