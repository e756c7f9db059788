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
// A zero digit adds nothing (the TPU kernel's trash bucket 0 is a skipped
// add here).  Output: buckets (64, 8, 4, 20, S) int32, extended coordinates
// (X, Y, Z, T) in 20 canonical radix-2^13 limbs; the window sum is
//   W_w = sum_v v * sum_slots bucket(w, v),
// the TPU kernel's window sum.
//
// What differs from the TPU kernel: its grid runs in order, batch tiles
// innermost, and keeps lane-private buckets for 4 windows resident in VMEM
// across all tiles.  Hopper blocks run in parallel and in no order, and a
// curve-point addition has no atomic.  So one thread owns one bucket set
// and walks its lanes itself: the order of additions is fixed, and the
// kernel equals its plain version (msm_buckets_plain) bit for bit after
// canonicalisation.  The 8-bucket state (8 x 4 x 10 int32 = 1,280 bytes) is
// indexed by a per-lane digit, so it lives in local memory (L1-backed).
// Grid: (S / 64 rounded up, 64) blocks of 64 slots; consecutive threads take
// consecutive lanes, so digit and niels loads coalesce.  A thread of the
// first 33 windows makes up to 2B/S additions, the others up to B/S.
//
// What bounds it: per nonzero digit one affine-niels addition with T, 7
// multiplications of 100 32x32->64 products; at most 97 x 700 = 67,900
// products per lane (msm.py::msm_products counts this run's nonzero
// digits), about 16.6 us for B = 4096 at 16.75e12 per second.  The output
// is 64 x 8 x 80 x 4 bytes per slot, 41.9 MB at S = 256, about 12.5 us at
// 3.35 TB/s: the products bound it.  The simple design does nothing about
// either yet: 64 x S threads (16,384 at S = 256) are under 130 per SM, each
// a dependent chain of local-memory bucket reads and writes.
//
// Compiled without __CUDACC__ (plain C++), the per-set function builds a
// host library (fdt_msm_buckets_host) that the CPU tests hold against the
// plain PyTorch version.

#include "ed25519.cuh"

#define MSM_WIN 64   // windows of c = z k mod L
#define MSM_ZWIN 33  // windows of z < 2^128
#define MSM_BUCKETS 8
#define MSM_SLOTS_PER_BLOCK 64

// Add digit d times the affine niels point of lane i in n3 (3 x 20 limb
// rows of B) into bucket |d| of bk; a zero digit adds nothing.
FDT_FN void msm_add(ge* bk, const int32_t* n3, int B, int i, int d) {
  if (d == 0) return;
  // |digit| is clamped to the buckets so that a malformed digit cannot
  // write out of bounds (to_signed_digits makes digits in [-8, 7])
  const int a = d < 0 ? (d < -8 ? 8 : -d) : (d > 8 ? 8 : d);
  const fe ypx = fe_from_limbs13(n3, B, i);
  const fe ymx = fe_from_limbs13(n3 + 20 * (int64_t)B, B, i);
  const fe t2d = fe_from_limbs13(n3 + 40 * (int64_t)B, B, i);
  bk[a - 1] = ge_add_niels_affine(bk[a - 1], fe_select(ypx, ymx, d < 0),
                                  fe_select(ymx, ypx, d < 0),
                                  fe_select(t2d, fe_neg(t2d), d < 0), true);
}

// One bucket set: window `w`, lane slot `slot` of S.
FDT_FN void msm_set(const int32_t* cdig, const int32_t* zdig,
                    const int32_t* an3, const int32_t* rn3, int32_t* out,
                    int B, int S, int w, int slot) {
  const int32_t* cd = cdig + (int64_t)w * B;
  const int32_t* zd = w < MSM_ZWIN ? zdig + (int64_t)w * B : nullptr;
  ge bk[MSM_BUCKETS];
  for (int b = 0; b < MSM_BUCKETS; b++) bk[b] = ge_identity();
  for (int i = slot; i < B; i += S) {
    msm_add(bk, an3, B, i, FDT_LDG(cd + i));
    if (zd) msm_add(bk, rn3, B, i, FDT_LDG(zd + i));
  }
  for (int b = 0; b < MSM_BUCKETS; b++) {
    int32_t* o = out + ((int64_t)(w * MSM_BUCKETS + b) * 4) * 20 * S;
    fe_to_limbs13(bk[b].x, o, S, slot);
    fe_to_limbs13(bk[b].y, o + 20 * (int64_t)S, S, slot);
    fe_to_limbs13(bk[b].z, o + 40 * (int64_t)S, S, slot);
    fe_to_limbs13(bk[b].t, o + 60 * (int64_t)S, S, slot);
  }
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(MSM_SLOTS_PER_BLOCK)
msm_buckets_kernel(const int32_t* __restrict__ cdig,
                   const int32_t* __restrict__ zdig,
                   const int32_t* __restrict__ an3,
                   const int32_t* __restrict__ rn3, int32_t* __restrict__ out,
                   int B, int S) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= S) return;
  msm_set(cdig, zdig, an3, rn3, out, B, S, blockIdx.y, slot);
}

extern "C" cudaError_t fdt_msm_buckets_launch(const int32_t* cdig,
                                              const int32_t* zdig,
                                              const int32_t* an3,
                                              const int32_t* rn3,
                                              int32_t* out, int B, int S,
                                              void* stream) {
  if (S <= 0) return cudaSuccess;
  const dim3 grid((S + MSM_SLOTS_PER_BLOCK - 1) / MSM_SLOTS_PER_BLOCK,
                  MSM_WIN);
  msm_buckets_kernel<<<grid, MSM_SLOTS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      cdig, zdig, an3, rn3, out, B, S);
  return cudaGetLastError();
}

#else  // plain C++: the host build the CPU tests hold against the plain path

extern "C" void fdt_msm_buckets_host(const int32_t* cdig, const int32_t* zdig,
                                     const int32_t* an3, const int32_t* rn3,
                                     int32_t* out, int B, int S) {
  for (int w = 0; w < MSM_WIN; w++)
    for (int slot = 0; slot < S; slot++)
      msm_set(cdig, zdig, an3, rn3, out, B, S, w, slot);
}

#endif
