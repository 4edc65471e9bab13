// ppu_update: the PPU vector unit's fixed-function R-STDP update on Hopper.
//
//   qc = clip(rint(a_causal * (gain * 8) + off), 0, 255), qa likewise
//   [CADC faults] qc = min(max(qc + fa, flo), fhi), qa likewise
//   elig = (qc - qa) * (1 / 255)
//   w' = clip(rint(w + (eta * mod) * elig + xi), 0, 63) as int8
//
// Replaces the TPU kernel repro/kernels/ppu_update/kernel.py,
// rstdp_update_pallas (_kernel), which ran the same steps per [rb, cb]
// VMEM tile with the per-column offset, gain and modulator as [1, cb] rows.
//
// Bound on the H100: element-wise, 18 bytes per synapse (int8 weight in
// and out, three float32 planes in, the float32 eligibility out). At the
// main-path shape (N=16 instances of R=256 x C=512) that is 37.7 MB, 11 us
// at 3.35 TB/s; about 15 operations per synapse are far below the float32
// rate. So the bytes bound it.
//
// Design: one thread per synapse, neighbouring threads on neighbouring
// columns, so every plane is read and written in coalesced runs; the
// per-column operands are [N, C] rows read through the cache.
//
// CADC faults (repro_torch/faults/inject.py::cadc_map): a fault overlay's
// chain of code offsets and stuck codes, folded per column into one
// clamp-shift (fa, flo, fhi) [N, C], is applied to both codes after their
// rounding and before the eligibility, as the reference's read_correlation
// hook does. Whole numbers in float32, so it is exact. Without faults the
// kernel is instantiated without it and runs as before.
//
// Exactness: built with -fmad=false, so no multiply and add contract into
// one FMA and every operation rounds where PyTorch's eager kernels round;
// the operation order is the plain version's (ref.py) and the reference
// kernel's: a * (gain * scale) + off, then (eta * mod) * elig, + w, + xi.
// rintf rounds half to even, as torch.round and jnp.round do (roundf
// would round half away from zero and differ at every .5 tie). The
// eligibility multiplies by the float32 reciprocal of 255, which is what
// PyTorch's CUDA division by a Python float and XLA's division by a
// constant compute. With these the kernel equals its plain version bit for
// bit on the card.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <bool FAULTS>
__global__ void __launch_bounds__(THREADS)
ppu_update_kernel(const int8_t* __restrict__ w, const float* __restrict__ ac,
                  const float* __restrict__ aa, const float* __restrict__ off,
                  const float* __restrict__ gain,
                  const float* __restrict__ mod, const float* __restrict__ xi,
                  const float* __restrict__ fa, const float* __restrict__ flo,
                  const float* __restrict__ fhi,
                  int8_t* __restrict__ w_out, float* __restrict__ elig_out,
                  long long total, int RC, int C, float eta, float cadc_scale,
                  float inv_max, float cadc_max, float wmax) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const long long n = i / RC;
    const int c = (int)(i % C);
    const long long nc = n * C + c;
    const float g = gain[nc] * cadc_scale;
    const float o = off[nc];
    float qc = fminf(fmaxf(rintf(ac[i] * g + o), 0.0f), cadc_max);
    float qa = fminf(fmaxf(rintf(aa[i] * g + o), 0.0f), cadc_max);
    if (FAULTS) {
      const float a = fa[nc], lo = flo[nc], hi = fhi[nc];
      qc = fminf(fmaxf(qc + a, lo), hi);
      qa = fminf(fmaxf(qa + a, lo), hi);
    }
    const float e = (qc - qa) * inv_max;
    const float step = (eta * mod[nc]) * e;
    float wn = (float)w[i] + step;
    wn = wn + xi[i];
    w_out[i] = (int8_t)(int)fminf(fmaxf(rintf(wn), 0.0f), wmax);
    elig_out[i] = e;
  }
}

}  // namespace

extern "C" int ppu_update_launch(const void* w, const void* ac, const void* aa,
                                 const void* off, const void* gain,
                                 const void* mod, const void* xi,
                                 const void* fa, const void* flo,
                                 const void* fhi, void* w_out,
                                 void* elig, int N, int R, int C, float eta,
                                 float cadc_scale, float inv_max,
                                 float cadc_max, float wmax, void* stream) {
  const long long total = (long long)N * R * C;
  if (total == 0) return 0;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  const bool faults = fa != nullptr;
  if (faults != (flo != nullptr) || faults != (fhi != nullptr)) return -1;
  auto kernel = faults ? ppu_update_kernel<true> : ppu_update_kernel<false>;
  kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)w, (const float*)ac, (const float*)aa, (const float*)off,
      (const float*)gain, (const float*)mod, (const float*)xi,
      (const float*)fa, (const float*)flo, (const float*)fhi, (int8_t*)w_out,
      (float*)elig, total, R * C, C, eta, cadc_scale, inv_max, cadc_max, wmax);
  return (int)cudaGetLastError();
}
