// fe_probe.cu -- probes of the field products on the card, for the sass
// phase of chip_smoke.py; no kernel of the port's paths calls them.
//
//  * fdt_probe_fe_mul, fdt_probe_fe_sq: one fe_mul or fe_sq of
//    ed25519.cuh per thread, so that the SASS of each product can be read
//    and its multiply instructions counted (cuobjdump -sass).
//  * fdt_probe_rate_launch: the issue rate of one multiply instruction on
//    the whole card, from 8 independent 64-bit (mad.wide.s32, IMAD.WIDE)
//    or 32-bit (mad.lo.s32, IMAD) multiply-add chains per thread, `iters`
//    rounds each; the caller times it with CUDA events.

#include "../ed25519.cuh"

extern "C" __global__ void fdt_probe_fe_mul(const int32_t* f, const int32_t* g,
                                            int32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const fe r = fe_mul(fe_load(f + 10 * i), fe_load(g + 10 * i));
  for (int l = 0; l < 10; l++) out[10 * i + l] = r.v[l];
}

extern "C" __global__ void fdt_probe_fe_sq(const int32_t* f, int32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const fe r = fe_sq(fe_load(f + 10 * i));
  for (int l = 0; l < 10; l++) out[10 * i + l] = r.v[l];
}

#define PROBE_CHAINS 8

extern "C" __global__ void fdt_probe_imad_wide(const int32_t* in,
                                               int64_t* out, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int32_t b = in[i % 64];
  int32_t a[PROBE_CHAINS];
  int64_t acc[PROBE_CHAINS];
  for (int j = 0; j < PROBE_CHAINS; j++) {
    a[j] = in[(i + j) % 64];
    acc[j] = j;
  }
  for (int it = 0; it < iters; it++) {
    const int32_t bi = b ^ it;  // a fresh operand: no multiply is hoisted
#pragma unroll
    for (int j = 0; j < PROBE_CHAINS; j++)
      asm volatile("mad.wide.s32 %0, %1, %2, %0;" : "+l"(acc[j]) : "r"(a[j]), "r"(bi));
  }
  int64_t s = 0;
  for (int j = 0; j < PROBE_CHAINS; j++) s += acc[j];
  out[i] = s;
}

extern "C" __global__ void fdt_probe_imad(const int32_t* in, int64_t* out,
                                          int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int32_t b = in[i % 64];
  int32_t a[PROBE_CHAINS], acc[PROBE_CHAINS];
  for (int j = 0; j < PROBE_CHAINS; j++) {
    a[j] = in[(i + j) % 64];
    acc[j] = j;
  }
  for (int it = 0; it < iters; it++) {
    const int32_t bi = b ^ it;
#pragma unroll
    for (int j = 0; j < PROBE_CHAINS; j++)
      asm volatile("mad.lo.s32 %0, %1, %2, %0;" : "+r"(acc[j]) : "r"(a[j]), "r"(bi));
  }
  int64_t s = 0;
  for (int j = 0; j < PROBE_CHAINS; j++) s += acc[j];
  out[i] = s;
}

// wide != 0: IMAD.WIDE chains, else IMAD; blocks x threads threads, each
// PROBE_CHAINS * iters multiply-adds; in: 64 int32, out: one int64 a thread
extern "C" cudaError_t fdt_probe_rate_launch(int wide, const int32_t* in,
                                             int64_t* out, int iters,
                                             int blocks, int threads,
                                             void* stream) {
  if (wide)
    fdt_probe_imad_wide<<<blocks, threads, 0, (cudaStream_t)stream>>>(in, out, iters);
  else
    fdt_probe_imad<<<blocks, threads, 0, (cudaStream_t)stream>>>(in, out, iters);
  return cudaGetLastError();
}

// Latency of one dependent product: one warp runs n products in a chain
// (kind 0: f = f^2 by fe_sq, kind 1: f = f g by fe_mul); cycles[t] is
// thread t's clock64() span.
extern "C" __global__ void fdt_probe_latency(const int32_t* in, int32_t* out,
                                             long long* cycles, int n,
                                             int kind) {
  fe f = fe_load(in + 10 * threadIdx.x), g = fe_load(in + 320 + 10 * threadIdx.x);
  const long long t0 = clock64();
  if (kind == 0) {
    for (int i = 0; i < n; i++) f = fe_sq(f);
  } else {
    for (int i = 0; i < n; i++) f = fe_mul(f, g);
  }
  const long long t1 = clock64();
  for (int l = 0; l < 10; l++) out[10 * threadIdx.x + l] = f.v[l];
  cycles[threadIdx.x] = t1 - t0;
}

extern "C" cudaError_t fdt_probe_latency_launch(const int32_t* in,
                                                int32_t* out,
                                                long long* cycles, int n,
                                                int kind, void* stream) {
  fdt_probe_latency<<<1, 32, 0, (cudaStream_t)stream>>>(in, out, cycles, n, kind);
  return cudaGetLastError();
}
