// stp_scan: the short-term-plasticity efficacy trajectory of a window on
// Hopper, the T-step recurrence of core/stp.py per driver row:
//
//   eff[t] = clamp((u * r) * scale, 0, 1.5) * s[t]
//   r      = r + (1 - r) * recovery
//   r      = clamp(r - (u * r) * s[t], 0, 1)
//
// No TPU kernel: the reference runs this recurrence as a lax.scan of jnp
// ops (repro/core/anncore.py:333-341, stp_body), which XLA fuses into one
// loop. The port ran it as a Python loop of about 12 PyTorch launches a
// step; this kernel is that loop as one launch.
//
// Bound on the H100: per lane T spikes read and T efficacies written as
// float32, plus r0, the scale and r_T. At the main path's shape (16
// instances x 256 rows, T = 128) that is 4.2 MB, 1.3 us at 3.35 TB/s;
// about 14 operations a step are far below the float32 rate. At the §5
// closed loop's 32 rows (T = 256) nothing fills the card: the chain of
// about 8 dependent operations a step sets the time.
//
// Design: one thread per (instance, row) lane with r in a register for the
// whole window; neighbouring threads on neighbouring rows, so each step's
// spike loads and efficacy stores are coalesced along R. The spike loads
// do not depend on r, so each chunk of CHUNK steps is loaded into
// registers while the chain of the chunk before it runs. Small blocks (64
// threads) spread the 4,096 lanes of the main path over 64 SMs.
//
// Exactness: built with -fmad=false, so no multiply and add contract into
// one FMA; the operations and their order are the plain version's (ref.py,
// stp.efficacy and stp.update): u * r (u rounded to float32, as PyTorch's
// multiply by a Python float rounds it), then * scale; 1 - r, * recovery,
// + r; u * r, * s, subtracted. The clamps are PyTorch's CUDA clamp: a NaN
// passes through, else fminf(fmaxf(v, lo), hi) with the bounds as runtime
// values, so the compiler cannot fold the [0, 1] clamp into a saturating
// add (which would differ on -0.0 and NaN). With these the kernel equals
// its plain version on the card bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int CHUNK = 8;        // steps whose spikes are loaded at once

struct Args {
  const float* r0;        // [N, R] contiguous
  const float* spikes;    // [T, N, R] through strides (t, n, r)
  const float* scale;     // [N, R] through strides (n, r)
  float* eff;             // [T, N, R] contiguous
  float* r_out;           // [N, R] contiguous
  long long st, sn, sr, cn, cr;
  int T, N, R;
  float u, recovery, eff_max, r_max;
};

__device__ __forceinline__ float clamp_like_torch(float v, float lo,
                                                  float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__global__ void __launch_bounds__(THREADS) stp_scan_kernel(Args p) {
  const long long lane = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long lanes = (long long)p.N * p.R;
  if (lane >= lanes) return;
  const int n = (int)(lane / p.R), r_i = (int)(lane % p.R);
  const float sc = p.scale[n * p.cn + r_i * p.cr];
  const float* sp = p.spikes + n * p.sn + r_i * p.sr;
  float* out = p.eff + lane;
  const float zero = 0.0f, one = 1.0f;
  float r = p.r0[lane];
  float s[CHUNK];
#pragma unroll
  for (int i = 0; i < CHUNK; ++i)
    s[i] = i < p.T ? sp[(long long)i * p.st] : 0.0f;
  for (int t0 = 0; t0 < p.T; t0 += CHUNK) {
    // the next chunk's spikes, in flight while this chunk's chain runs
    float nx[CHUNK];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const int t = t0 + CHUNK + i;
      nx[i] = t < p.T ? sp[(long long)t * p.st] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      if (t0 + i >= p.T) break;
      float e = p.u * r;
      e = e * sc;
      e = clamp_like_torch(e, zero, p.eff_max);
      out[(long long)(t0 + i) * lanes] = e * s[i];
      float q = one - r;
      q = q * p.recovery;
      const float r1 = r + q;
      float d = p.u * r1;
      d = d * s[i];
      r = clamp_like_torch(r1 - d, zero, p.r_max);
    }
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) s[i] = nx[i];
  }
  p.r_out[lane] = r;
}

}  // namespace

// r0 float32 [N, R] contiguous; spikes float32 [T, N, R] read through
// strides (t, n, r); scale float32 [N, R] read through strides (n, r)
// (0 for a broadcast axis); eff float32 [T, N, R] and r_out float32 [N, R]
// written contiguous.
extern "C" int stp_scan_launch(const void* r0, const void* spikes,
                               const void* scale, void* eff, void* r_out,
                               int T, int N, int R, long long st,
                               long long sn, long long sr, long long cn,
                               long long cr, float u, float recovery,
                               float eff_max, float r_max, void* stream) {
  const long long lanes = (long long)N * R;
  if (lanes == 0) return 0;
  Args p{(const float*)r0, (const float*)spikes, (const float*)scale,
         (float*)eff, (float*)r_out, st, sn, sr, cn, cr, T, N, R, u,
         recovery, eff_max, r_max};
  const long long blocks = (lanes + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  stp_scan_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
