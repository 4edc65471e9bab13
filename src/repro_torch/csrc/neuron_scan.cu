// neuron_scan: a T-step AdEx window with the neuron state in registers.
//
// Replaces the TPU kernel repro/kernels/neuron_scan/kernel.py,
// neuron_window_pallas (_kernel), which kept the state in a VMEM scratch
// buffer across a sequential time-block grid axis and padded T up to the
// block size. Here the T loop runs inside one thread, over exactly T
// steps: there is no padding and no masking.
//
// Bound on the H100: at the main-path shape (N=16 instances, T=128, C=512)
// one launch reads the two current slabs (2 x 4.2 MB), the packed state
// and parameters (0.2 + 0.4 MB) and writes the spikes (4.2 MB) and the
// state: about 12.6 MB, 3.8 us at 3.35 TB/s. The arithmetic (about 40
// operations and one expf per neuron and step, 42M in all) is far below
// the float32 rate, so bytes bound it. In practice the T steps are a
// sequential chain per neuron and only N*C = 8192 threads exist, so the
// latency of each step's loads and of the dependent arithmetic sets the
// time; the loads of step t+1 do not depend on step t, so the compiler
// and the memory system can run them ahead.
//
// Design: one thread per (instance, column); v, w, i_exc, i_inh, refrac
// and the rate counter live in registers for the whole window. The
// currents stream in and the spikes stream out time-major, so the
// threads of a warp touch consecutive columns (coalesced along C).
//
// Exactness: each step is repro_torch/core/adex.py's integrate_currents
// then membrane_step, operation by operation in the same order. Built
// with -fmad=false (no multiply-add contraction) and with IEEE division
// and the accurate expf (no fast math), every operation rounds as
// PyTorch's eager kernels do, so the spikes and the state match the plain
// version bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;

// parameter rows of the packed [N, 12, C] tensor (kernels/neuron_scan/ops.py)
enum { E_LEAK, V_THRES, DELTA_T, G_LEAK, A, B, E_RESET, TAU_REFRAC,
       DE, DI, ALPHA, AW, N_PARAM };
// state rows of the packed [N, 6, C] tensor
enum { S_V, S_W, S_IEXC, S_IINH, S_REFRAC, S_RC, N_STATE };

__global__ void __launch_bounds__(THREADS)
neuron_scan_kernel(const float* __restrict__ ie, const float* __restrict__ ii,
                   const float* __restrict__ st_in,
                   const float* __restrict__ par,
                   float* __restrict__ spikes, float* __restrict__ st_out,
                   float* __restrict__ v_rec, int N, int T, int C, float dt,
                   int use_adex) {
  const int n = blockIdx.y;
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;

  const float* p = par + (long long)n * N_PARAM * C + c;
  const float e_leak = p[E_LEAK * C], v_thres = p[V_THRES * C];
  const float delta_t = p[DELTA_T * C], g_l = p[G_LEAK * C];
  const float a = p[A * C], b = p[B * C], e_reset = p[E_RESET * C];
  const float tau_refrac = p[TAU_REFRAC * C];
  const float de = p[DE * C], di = p[DI * C];
  const float alpha = p[ALPHA * C], aw = p[AW * C];

  const float* s = st_in + (long long)n * N_STATE * C + c;
  float v = s[S_V * C], w = s[S_W * C];
  float i_exc = s[S_IEXC * C], i_inh = s[S_IINH * C];
  float refrac = s[S_REFRAC * C], rc = s[S_RC * C];

  // spike_v = v_thres + (2.0 * delta_t if adex else 0.0)
  const float spike_v = use_adex ? v_thres + 2.0f * delta_t : v_thres + 0.0f;

  const long long step = (long long)N * C;
  long long off = (long long)n * C + c;
  for (int t = 0; t < T; ++t, off += step) {
    // integrate_currents
    i_exc = i_exc * de + ie[off];
    i_inh = i_inh * di + ii[off];
    const float i_drive = i_exc - i_inh;

    // membrane_step
    const float i_total = i_drive - w;
    float i_exp = 0.0f;
    if (use_adex) {
      const float arg = fminf(fmaxf((v - v_thres) / delta_t, -20.0f), 3.0f);
      i_exp = g_l * delta_t * expf(arg);
    }
    const float v_inf = e_leak + (i_total + i_exp) / g_l;
    float v_new = v_inf + (v - v_inf) * alpha;
    const float w_inf = a * (v - e_leak);
    float w_new = w_inf + (w - w_inf) * aw;

    const bool in_refrac = refrac > 0.0f;
    if (in_refrac) {
      v_new = e_reset;
      w_new = w;
    }
    const bool spk = (v_new > spike_v) && !in_refrac;
    if (spk) {
      v_new = e_reset;
      w_new = w_new + b;
      refrac = tau_refrac;
    } else {
      refrac = fmaxf(refrac - dt, 0.0f);
    }
    v = v_new;
    w = w_new;
    const float out = spk ? 1.0f : 0.0f;
    rc = rc + out;
    spikes[off] = out;
    if (v_rec) v_rec[off] = v;
  }

  float* so = st_out + (long long)n * N_STATE * C + c;
  so[S_V * C] = v;
  so[S_W * C] = w;
  so[S_IEXC * C] = i_exc;
  so[S_IINH * C] = i_inh;
  so[S_REFRAC * C] = refrac;
  so[S_RC * C] = rc;
}

}  // namespace

extern "C" int neuron_scan_launch(const void* ie, const void* ii,
                                  const void* st_in, const void* par,
                                  void* spikes, void* st_out, void* v_rec,
                                  int N, int T, int C, float dt,
                                  int use_adex, void* stream) {
  if (N == 0 || C == 0) return 0;
  dim3 grid((C + THREADS - 1) / THREADS, N);
  neuron_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ie, (const float*)ii, (const float*)st_in,
      (const float*)par, (float*)spikes, (float*)st_out, (float*)v_rec, N, T,
      C, dt, use_adex);
  return (int)cudaGetLastError();
}
