// decompress_niels.cu -- Ed25519 decompression to affine niels form for
// NVIDIA Hopper (sm_90a), the first kernel of the RLC batch-verify path.
//
// Replaces the Pallas TPU kernel firedancer_tpu/ops/ed25519/msm_kernel.py
// :: _decompress_niels_kernel (wrapper decompress_niels).  Per lane it
// decompresses A and R (ref10 sqrt chain, the same ge_decompress as
// verify_core.cu: non-canonical y accepted, failed sqrt rejected, x == 0
// with the sign bit set rejected) and emits each point's affine niels form
// (y+x, y-x, 2dxy), plus one byte per lane: 1 when both decompressed.
// Lanes that fail carry the same deterministic garbage as the plain
// version; the caller masks them to the identity before the MSM.
//
// Interface: field.py's layout.  In: a_y, r_y (20, B) radix-2^13 limbs,
// a_sign, r_sign (B,) sign bits.  Out: an3, rn3 (60, B) = the three niels
// coordinates, 20 canonical radix-2^13 limbs each (in [0, 2^13), so inside
// field.py's LOOSE_MAX input contract), and ok (B,) bytes.
//
// What bounds it: 32-bit integer multiply-add issue.  Per lane the function
// needs 510 squarings and 42 multiplications (two decompressions of (255,
// 20), and one multiplication by 2d per point; msm.py's
// DECOMPRESS_NIELS_OPS), 32,250 32x32->64 products at 55 per squaring and
// 100 per multiplication: about 15.8 us for B = 4096 at the card's 8.4e12
// 32x32->64 multiply-adds (IMAD.WIDE) per second, half its 32-bit IMAD rate
// (chip_smoke.py's sass phase measures both).
//
// Design, and what it does about that bound: each point's sqrt chain
// (fe_pow_p58) is some 265 dependent field operations, so the chain's
// latency, not the card's multiply rate, sets the time while few threads
// run.  One thread per point: a block of 64 threads takes 32 lanes, its
// first warp decompressing their A and its second their R at the same time
// (8192 threads at B = 4096, where one thread per lane ran A, then R).  The
// two halves meet in shared memory for the ok byte.  The shared
// ge_decompress squares with fe_sq (55 products) and inlines every product,
// each limb product one mad.wide.s32 (ed25519.cuh).  The field constants (D, 2D, sqrt(-1)) are staged in
// shared memory from the verify_core constant block; the ragged edge is
// masked.
//
// Compiled without __CUDACC__ (plain C++), the point function builds a host
// library (fdt_decompress_niels_host) that the CPU tests hold against the
// plain PyTorch version.

#include "ed25519.cuh"

#define DN_LANES_PER_BLOCK 32
#define DN_THREADS (2 * DN_LANES_PER_BLOCK)  // warp 0: A, warp 1: R
#define DN_CONSTS 30  // D, 2D, sqrt(-1) of the verify_core block

// One point: decompress (y, sign) of `lane`, write its affine niels limbs.
FDT_FN bool niels_point(const int32_t* cst, const int32_t* y,
                        const int32_t* sg, int32_t* n3, int B, int lane) {
  bool ok;
  const ge p = ge_decompress(fe_from_limbs13(y, B, lane), FDT_LDG(sg + lane),
                             cst, &ok);
  fe_to_limbs13(fe_add(p.y, p.x), n3, B, lane);
  fe_to_limbs13(fe_sub(p.y, p.x), n3 + 20 * (int64_t)B, B, lane);
  fe_to_limbs13(fe_mul(p.t, fe_load(cst + C_D2)), n3 + 40 * (int64_t)B, B,
                lane);
  return ok;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(DN_THREADS)
decompress_niels_kernel(const int32_t* __restrict__ consts,
                        const int32_t* __restrict__ ay,
                        const int32_t* __restrict__ asg,
                        const int32_t* __restrict__ ry,
                        const int32_t* __restrict__ rsg,
                        int32_t* __restrict__ an3, int32_t* __restrict__ rn3,
                        uint8_t* __restrict__ ok, int B) {
  __shared__ int32_t cst[DN_CONSTS];
  __shared__ bool r_ok[DN_LANES_PER_BLOCK];
  for (int i = threadIdx.x; i < DN_CONSTS; i += blockDim.x) cst[i] = consts[i];
  __syncthreads();
  const bool is_r = threadIdx.x >= DN_LANES_PER_BLOCK;
  const int j = threadIdx.x % DN_LANES_PER_BLOCK;
  const int lane = blockIdx.x * DN_LANES_PER_BLOCK + j;
  bool pt_ok = false;
  if (lane < B)
    pt_ok = niels_point(cst, is_r ? ry : ay, is_r ? rsg : asg,
                        is_r ? rn3 : an3, B, lane);
  if (is_r) r_ok[j] = pt_ok;
  __syncthreads();
  if (!is_r && lane < B) ok[lane] = (pt_ok && r_ok[j]) ? 1 : 0;
}

extern "C" cudaError_t fdt_decompress_niels_launch(
    const int32_t* consts, const int32_t* ay, const int32_t* asg,
    const int32_t* ry, const int32_t* rsg, int32_t* an3, int32_t* rn3,
    uint8_t* ok, int B, void* stream) {
  if (B <= 0) return cudaSuccess;
  const int blocks = (B + DN_LANES_PER_BLOCK - 1) / DN_LANES_PER_BLOCK;
  decompress_niels_kernel<<<blocks, DN_THREADS, 0,
                            (cudaStream_t)stream>>>(consts, ay, asg, ry, rsg,
                                                    an3, rn3, ok, B);
  return cudaGetLastError();
}

#else  // plain C++: the host build the CPU tests hold against the plain path

extern "C" void fdt_decompress_niels_host(const int32_t* consts,
                                          const int32_t* ay,
                                          const int32_t* asg,
                                          const int32_t* ry,
                                          const int32_t* rsg, int32_t* an3,
                                          int32_t* rn3, uint8_t* ok, int B) {
  for (int lane = 0; lane < B; lane++) {
    const bool a_ok = niels_point(consts, ay, asg, an3, B, lane);
    const bool r_ok = niels_point(consts, ry, rsg, rn3, B, lane);
    ok[lane] = (a_ok && r_ok) ? 1 : 0;
  }
}

#endif
