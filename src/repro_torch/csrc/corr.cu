// corr: the T-step correlation-sensor window with per-step saturation.
//
//   tp = lam * tp + pre[t]                      (per row)
//   tq = lam * tq + post[t]                     (per column)
//   a_c = min(a_c + tp (outer) post[t], sat)
//   a_a = min(a_a + pre[t] (outer) tq, sat)
//
// Replaces the TPU kernel repro/kernels/corr/kernel.py,
// correlation_window_pallas (_kernel), which kept one [rb, cb] accumulator
// tile in VMEM and ran a fori_loop over T.
//
// Bound on the H100: at the main-path shape (N=16 instances, T=128,
// R=256, C=512) one launch reads and writes the two [16, 256, 512] float32
// accumulators (4 x 8.4 MB = 33.6 MB) and reads the spike windows (2.1 MB
// + 4.2 MB): about 40 MB, 12 us at 3.35 TB/s. Per step and synapse it does
// one multiply, one add and one min for each accumulator: 2 x 3 x T*R*C*N
// = 1.6G float32 operations, 24 us at 67 TFLOP/s. The arithmetic bounds
// it, because the accumulators stay in registers across all T steps and
// are read and written once.
//
// Design: one block per (instance, RB x CB tile); each thread holds RPT
// rows of one column, two accumulators each, in registers. The trace
// trajectories tp[t] and tq[t] of the tile are computed once per chunk of
// TC steps into shared memory (a short serial scan by one thread per row
// or column) with the spikes beside them, and every thread reads them
// from there: the [T, R] and [T, C] spike windows are read once per
// block, not once per synapse. The clamp runs at every step, exactly as
// the reference kernel does (a min over the window would differ where it
// saturates). Built with -fmad=false so that the multiply and the add
// round separately, as PyTorch's eager ops do: the result matches the
// per-step plain version bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int CB = 128;             // columns per block (threadIdx.x)
constexpr int RY = 8;               // threadIdx.y
constexpr int RPT = 4;              // rows per thread
constexpr int RB = RY * RPT;        // rows per block
constexpr int TC = 32;              // steps per shared-memory chunk

__global__ void __launch_bounds__(CB * RY)
corr_kernel(const float* __restrict__ pre, const float* __restrict__ post,
            const float* __restrict__ tp0, const float* __restrict__ tq0,
            const float* __restrict__ ac0, const float* __restrict__ aa0,
            float* __restrict__ ac_out, float* __restrict__ aa_out,
            float* __restrict__ tp_out, float* __restrict__ tq_out, int N,
            int T, int R, int C, float lam, float sat) {
  __shared__ float s_pre[TC][RB];
  __shared__ float s_tp[TC][RB];
  __shared__ float s_post[TC][CB];
  __shared__ float s_tq[TC][CB];

  const int n = blockIdx.z;
  const int r0 = blockIdx.y * RB;
  const int c0 = blockIdx.x * CB;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * CB + tx;
  const int c = c0 + tx;

  // serial trace owners: threads 0..RB-1 own a row, RB..RB+CB-1 a column
  const bool row_owner = tid < RB && r0 + tid < R;
  const bool col_owner = tid >= RB && tid < RB + CB && c0 + tid - RB < C;
  float trace = 0.0f;
  if (row_owner) trace = tp0[(long long)n * R + r0 + tid];
  if (col_owner) trace = tq0[(long long)n * C + c0 + tid - RB];

  float ac[RPT], aa[RPT];
  const long long acc_n = (long long)n * R * C;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = r0 + ty + k * RY;
    const bool ok = r < R && c < C;
    ac[k] = ok ? ac0[acc_n + (long long)r * C + c] : 0.0f;
    aa[k] = ok ? aa0[acc_n + (long long)r * C + c] : 0.0f;
  }

  for (int t0 = 0; t0 < T; t0 += TC) {
    const int tn = min(TC, T - t0);
    __syncthreads();
    if (row_owner) {
      const int r = r0 + tid;
      for (int j = 0; j < tn; ++j) {
        const float p = pre[((long long)(t0 + j) * N + n) * R + r];
        trace = trace * lam + p;
        s_pre[j][tid] = p;
        s_tp[j][tid] = trace;
      }
    } else if (col_owner) {
      const int cc = tid - RB;
      for (int j = 0; j < tn; ++j) {
        const float q = post[((long long)(t0 + j) * N + n) * C + c0 + cc];
        trace = trace * lam + q;
        s_post[j][cc] = q;
        s_tq[j][cc] = trace;
      }
    }
    __syncthreads();
    for (int j = 0; j < tn; ++j) {
      const float q = s_post[j][tx];
      const float tq = s_tq[j][tx];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int rl = ty + k * RY;
        ac[k] = fminf(ac[k] + s_tp[j][rl] * q, sat);
        aa[k] = fminf(aa[k] + s_pre[j][rl] * tq, sat);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = r0 + ty + k * RY;
    if (r < R && c < C) {
      ac_out[acc_n + (long long)r * C + c] = ac[k];
      aa_out[acc_n + (long long)r * C + c] = aa[k];
    }
  }
  // final traces: the first column block writes the rows, the first row
  // block the columns
  if (row_owner && blockIdx.x == 0) tp_out[(long long)n * R + r0 + tid] = trace;
  if (col_owner && blockIdx.y == 0)
    tq_out[(long long)n * C + c0 + tid - RB] = trace;
}

}  // namespace

extern "C" int corr_launch(const void* pre, const void* post, const void* tp0,
                           const void* tq0, const void* ac0, const void* aa0,
                           void* ac, void* aa, void* tp, void* tq, int N,
                           int T, int R, int C, float lam, float sat,
                           void* stream) {
  if (N == 0 || R == 0 || C == 0) return 0;
  dim3 grid((C + CB - 1) / CB, (R + RB - 1) / RB, N);
  dim3 block(CB, RY);
  corr_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)pre, (const float*)post, (const float*)tp0,
      (const float*)tq0, (const float*)ac0, (const float*)aa0, (float*)ac,
      (float*)aa, (float*)tp, (float*)tq, N, T, R, C, lam, sat);
  return (int)cudaGetLastError();
}
