// neuron_scan: a T-step AdEx window with the neuron state in registers and
// the currents staged ahead of the membrane chain.
//
// Replaces the TPU kernel repro/kernels/neuron_scan/kernel.py,
// neuron_window_pallas (_kernel), which kept the state in a VMEM scratch
// buffer across a sequential time-block grid axis and padded T up to the
// block size. Here the T loop runs inside one thread, over exactly T
// steps: there is no padding and no masking.
//
// Bound on the H100: at the main-path shape (N=16 instances, T=128, C=512)
// one launch reads the two current slabs (2 x 4.2 MB), the state and the
// parameters (0.2 + 0.4 MB) and writes the spikes (4.2 MB) and the state:
// about 12.6 MB, 3.8 us at 3.35 TB/s. The arithmetic (about 40 operations
// and one expf per neuron and step) is far below the float32 rate. Neither
// sets the time: the T steps are a dependent chain per neuron and only
// N*C = 8192 threads exist (under one warp per scheduler), so the latency
// of one step, v -> (v - v_thres) / delta_t -> expf -> / g_leak -> v_new ->
// compare, times T is the floor. chip_smoke.py measures that floor with
// the probe form of this kernel (currents from registers, no loads).
//
// Design: one thread per (instance, column), one warp a block; v, w,
// i_exc, i_inh, refrac and the spike count live in registers for the
// whole window. The window runs in chunks of TC steps. Each thread stages
// its own column of chunk k+1's currents into shared memory with 4-byte
// cp.async while it integrates chunk k (two stages), so no load waits on
// the chain. A thread reads only what it staged itself, so a
// cp.async.wait_group suffices and no block barrier is needed. Within a
// chunk the synaptic-current recurrences, which never read v, run first
// and leave the drive i_exc - i_inh in the stage; then the membrane steps
// run over it. Spikes (and the v record) stream out time-major, the
// threads of a warp on consecutive columns. A ragged last chunk, T = 0 and
// a ragged last block of columns need no padding.
//
// The chain's two divisions have divisors fixed over the window. IEEE
// division puts a range check and a branch to its slow path on the chain
// at every step; here each quotient is three dependent operations from
// 1 / d (q0 = x / d's first guess x * r, one FMA correction), and a
// branch-free test off the chain proves it correctly rounded from its
// exact FMA residual (not_rounded_quotient). A chunk in which any test
// fails (a quotient one ulp off, a residual at a rounding tie, a quotient
// out of range: all rare) runs again from its saved state with IEEE
// division, so every quotient is the one IEEE division returns.
//
// Exactness: each step is repro_torch/core/adex.py's integrate_currents
// then membrane_step, operation by operation in the same order. Built
// with -fmad=false (no multiply-add contraction), with the accurate expf
// (no fast math) and with quotients equal to IEEE division's, every
// operation rounds as PyTorch's eager kernels do, so the spikes and the
// state match the plain version bit for bit. The rate counters add the
// window's spike count once, as the plain version does (a sum of 0/1
// values is exact).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;     // columns a block
constexpr int TC = 64;          // steps a chunk

// parameter rows of the packed [N, 12, C] tensor (kernels/neuron_scan/ops.py)
enum { E_LEAK, V_THRES, DELTA_T, G_LEAK, A, B, E_RESET, TAU_REFRAC,
       DE, DI, ALPHA, AW, N_PARAM };
// the state leaves, each [N, C]: v, w, i_exc, i_inh, refrac, rate counters
enum { S_V, S_W, S_IEXC, S_IINH, S_REFRAC, S_RC, N_STATE };

struct StateIn {
  const float* p[N_STATE];
};
struct StateOut {
  float* p[N_STATE];
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The neuron's constants for the window.
struct Par {
  float e_leak, v_thres, delta_t, g_l, a, b, e_reset, tau_refrac, alpha, aw;
  float dt, spike_v;
  float r_delta, r_gl;     // 1 / delta_t, 1 / g_leak
};

// The membrane state a chunk carries (and restores when it reruns).
struct Mem {
  float v, w, refrac, count;
};

// Is q the correctly rounded x / d? q0 = x * (1 / d) is the first guess q
// was refined from. Zero numerators: q0 is exact, so q must equal it.
// Otherwise e = x - d * q is exact (one FMA: q is within an ulp of x / d,
// and with |q| in [2^-80, 2^80) and |d| in [2^-20, 2^20] nothing
// underflows), so q is the nearest float to x / d iff |e| / |d| is below
// half the gap to q's neighbour on the side of x / d (the gap below a
// power of two is half the one above it: take the smaller for both). A
// tie fails the test too. Branch-free, so that the test never holds up
// the membrane chain: every term is computed and combined bitwise.
__device__ __forceinline__ unsigned not_rounded_quotient(float x, float d,
                                                         float q, float q0) {
  const float e = __fmaf_rn(-d, q, x);
  const int qi = __float_as_int(q) & 0x7fffffff;
  const int half_gap = (qi & 0x7f800000) - (24 << 23)
                       - ((unsigned)((qi & 0x007fffff) == 0) << 23);
  const unsigned residual_ok =
      (unsigned)(qi >= (47 << 23)) & (unsigned)(qi < (207 << 23))
      & (unsigned)(fabsf(e) < fabsf(d) * __int_as_float(half_gap));
  const unsigned zero_ok = __float_as_int(q) == __float_as_int(q0);
  return (x == 0.0f ? zero_ok : residual_ok) ^ 1u;
}

// x / d for a divisor fixed over the window (r = 1 / d). FAST: three
// dependent operations and no branch on the chain, q0 = x * r, then one
// correction q = q0 + r * (x - d * q0); `bad` is set unless q is proved
// to be the correctly rounded quotient, which is what IEEE division
// returns. Otherwise: IEEE division.
template <bool FAST>
__device__ __forceinline__ float quotient(float x, float d, float r,
                                          unsigned& bad) {
  if (!FAST) return x / d;
  const float q0 = __fmul_rn(x, r);
  const float q = __fmaf_rn(r, __fmaf_rn(-d, q0, x), q0);
  bad |= not_rounded_quotient(x, d, q, q0);
  return q;
}

// membrane_step over m steps of a chunk's drive (a column of the stage),
// spikes (and v) streamed out. Returns false when a FAST quotient could
// not be proved exact: the caller then reruns the chunk with FAST off.
template <bool ADEX, bool REC_V, bool FAST>
__device__ __forceinline__ bool membrane_chunk(
    const float (*drive)[THREADS], int tx, int m, const Par& P, Mem& M,
    float* sp, float* vr, long long NC) {
  unsigned bad = 0;
#pragma unroll 8
  for (int k = 0; k < m; ++k) {
    const float i_total = drive[k][tx] - M.w;
    float i_exp = 0.0f;
    if (ADEX) {
      const float arg = fminf(
          fmaxf(quotient<FAST>(M.v - P.v_thres, P.delta_t, P.r_delta, bad),
                -20.0f), 3.0f);
      i_exp = P.g_l * P.delta_t * expf(arg);
    }
    const float v_inf =
        P.e_leak + quotient<FAST>(i_total + i_exp, P.g_l, P.r_gl, bad);
    float v_new = v_inf + (M.v - v_inf) * P.alpha;
    const float w_inf = P.a * (M.v - P.e_leak);
    float w_new = w_inf + (M.w - w_inf) * P.aw;

    // refractory clamp, then spike detection and reset: in refractoriness
    // v is e_reset either way, so one select after one compare of v_new
    // ends the chain (the plain version's two selects give the same bits)
    const bool in_refrac = M.refrac > 0.0f;
    const bool above = v_new > P.spike_v;
    const bool spk = above && !in_refrac;
    M.v = (above || in_refrac) ? P.e_reset : v_new;
    if (in_refrac) {
      w_new = M.w;
    } else if (spk) {
      w_new = w_new + P.b;
    }
    M.refrac = spk ? P.tau_refrac : fmaxf(M.refrac - P.dt, 0.0f);
    M.w = w_new;
    const float out = spk ? 1.0f : 0.0f;
    M.count += out;
    *sp = out;
    sp += NC;
    if (REC_V) {
      *vr = M.v;
      vr += NC;
    }
  }
  return bad == 0;
}

// FLOOR: the measurement probe. The same kernel with every step's currents
// taken from registers (step 0's values) instead of the staged window, so
// its time is the chain's alone. Its outputs are not the window's.
template <bool ADEX, bool REC_V, bool FLOOR>
__global__ void __launch_bounds__(THREADS)
neuron_scan_kernel(const float* __restrict__ ie, const float* __restrict__ ii,
                   StateIn st_in, const float* __restrict__ par,
                   float* __restrict__ spikes, StateOut st_out,
                   float* __restrict__ v_rec, int N, int T, int C,
                   float dt) {
  // [stage][exc, inh][step][column]; the exc slot holds the drive once the
  // chunk's currents are integrated
  __shared__ float s_cur[2][2][TC][THREADS];
  const int n = blockIdx.y;
  const int tx = threadIdx.x;
  const int c = blockIdx.x * THREADS + tx;
  if (c >= C) return;

  const long long NC = (long long)N * C;
  const long long base = (long long)n * C + c;
  const float* p = par + (long long)n * N_PARAM * C + c;
  Par P;
  P.e_leak = p[E_LEAK * C];
  P.v_thres = p[V_THRES * C];
  P.delta_t = p[DELTA_T * C];
  P.g_l = p[G_LEAK * C];
  P.a = p[A * C];
  P.b = p[B * C];
  P.e_reset = p[E_RESET * C];
  P.tau_refrac = p[TAU_REFRAC * C];
  P.alpha = p[ALPHA * C];
  P.aw = p[AW * C];
  P.dt = dt;
  // spike_v = v_thres + (2.0 * delta_t if adex else 0.0)
  P.spike_v = ADEX ? P.v_thres + 2.0f * P.delta_t : P.v_thres + 0.0f;
  P.r_delta = 1.0f / P.delta_t;
  P.r_gl = 1.0f / P.g_l;
  // the FAST quotients' proof needs divisors of moderate size
  const auto moderate = [](float d) {
    return fabsf(d) >= 0x1p-20f && fabsf(d) <= 0x1p20f;
  };
  const bool fast = moderate(P.g_l) && (!ADEX || moderate(P.delta_t));
  const float de = p[DE * C], di = p[DI * C];

  Mem M{st_in.p[S_V][base], st_in.p[S_W][base], st_in.p[S_REFRAC][base],
        0.0f};
  float i_exc = st_in.p[S_IEXC][base], i_inh = st_in.p[S_IINH][base];
  const float rc = st_in.p[S_RC][base];

  const float* pe = ie + base;
  const float* pi = ii + base;
  const int n_chunks = (T + TC - 1) / TC;
  auto stage = [&](int s, int t0) {
    const int m = min(TC, T - t0);
    const float* e = pe + t0 * NC;
    const float* i = pi + t0 * NC;
    for (int k = 0; k < m; ++k, e += NC, i += NC) {
      cp_async4(&s_cur[s][0][k][tx], e);
      cp_async4(&s_cur[s][1][k][tx], i);
    }
    cp_async_commit();
  };
  float x_e = 0.0f, x_i = 0.0f;
  if (FLOOR) {
    if (T > 0) {
      x_e = pe[0];
      x_i = pi[0];
    }
  } else if (n_chunks > 0) {
    stage(0, 0);
  }

  float* sp = spikes + base;
  float* vr = REC_V ? v_rec + base : nullptr;
  for (int j = 0; j < n_chunks; ++j) {
    const int t0 = j * TC;
    const int m = min(TC, T - t0);
    float (*cur)[TC][THREADS] = s_cur[j & 1];
    if (!FLOOR) {
      if (j + 1 < n_chunks) {
        stage((j + 1) & 1, t0 + TC);
        cp_async_wait<1>();          // chunk j has landed, j + 1 in flight
      } else {
        cp_async_wait<0>();
      }
    }

    // integrate_currents over the chunk; the drive replaces the exc slot
#pragma unroll 8
    for (int k = 0; k < m; ++k) {
      const float xe = FLOOR ? x_e : cur[0][k][tx];
      const float xi = FLOOR ? x_i : cur[1][k][tx];
      i_exc = i_exc * de + xe;
      i_inh = i_inh * di + xi;
      cur[0][k][tx] = i_exc - i_inh;
    }

    // membrane_step over the chunk's drive: with FAST quotients, and
    // again with IEEE division in the rare chunk where one is not proved
    const Mem saved = M;
    if (!(fast && membrane_chunk<ADEX, REC_V, true>(cur[0], tx, m, P, M,
                                                    sp, vr, NC))) {
      M = saved;
      membrane_chunk<ADEX, REC_V, false>(cur[0], tx, m, P, M, sp, vr, NC);
    }
    sp += m * NC;
    if (REC_V) vr += m * NC;
  }

  st_out.p[S_V][base] = M.v;
  st_out.p[S_W][base] = M.w;
  st_out.p[S_IEXC][base] = i_exc;
  st_out.p[S_IINH][base] = i_inh;
  st_out.p[S_REFRAC][base] = M.refrac;
  st_out.p[S_RC][base] = rc + M.count;
}

template <bool FLOOR>
int launch(const void* ie, const void* ii, const void* const* st_in,
           const void* par, void* spikes, void* const* st_out, void* v_rec,
           int N, int T, int C, float dt, int use_adex, void* stream) {
  if (N == 0 || C == 0) return 0;
  if (N > 65535) return (int)cudaErrorInvalidValue;
  StateIn si;
  StateOut so;
  for (int k = 0; k < N_STATE; ++k) {
    si.p[k] = (const float*)st_in[k];
    so.p[k] = (float*)st_out[k];
  }
  const dim3 grid((C + THREADS - 1) / THREADS, N);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* e = (const float*)ie;
  const float* i = (const float*)ii;
  const float* p = (const float*)par;
  float* sp = (float*)spikes;
  float* vr = (float*)v_rec;
  if (FLOOR) {
    neuron_scan_kernel<true, false, true><<<grid, THREADS, 0, s>>>(
        e, i, si, p, sp, so, nullptr, N, T, C, dt);
  } else if (use_adex && vr) {
    neuron_scan_kernel<true, true, false><<<grid, THREADS, 0, s>>>(
        e, i, si, p, sp, so, vr, N, T, C, dt);
  } else if (use_adex) {
    neuron_scan_kernel<true, false, false><<<grid, THREADS, 0, s>>>(
        e, i, si, p, sp, so, nullptr, N, T, C, dt);
  } else if (vr) {
    neuron_scan_kernel<false, true, false><<<grid, THREADS, 0, s>>>(
        e, i, si, p, sp, so, vr, N, T, C, dt);
  } else {
    neuron_scan_kernel<false, false, false><<<grid, THREADS, 0, s>>>(
        e, i, si, p, sp, so, nullptr, N, T, C, dt);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ie, ii, spikes, v_rec float32 [T, N, C] (v_rec may be null); st_in and
// st_out six float32 [N, C] planes each (v, w, i_exc, i_inh, refrac, rate
// counters); par float32 [N, 12, C].
extern "C" int neuron_scan_launch(const void* ie, const void* ii,
                                  const void* const* st_in, const void* par,
                                  void* spikes, void* const* st_out,
                                  void* v_rec, int N, int T, int C, float dt,
                                  int use_adex, void* stream) {
  return launch<false>(ie, ii, st_in, par, spikes, st_out, v_rec, N, T, C,
                       dt, use_adex, stream);
}

// The chain-floor probe (AdEx, no v record): the same kernel with the
// currents held in registers. A measurement aid, not a window.
extern "C" int neuron_scan_floor_launch(const void* ie, const void* ii,
                                        const void* const* st_in,
                                        const void* par, void* spikes,
                                        void* const* st_out, int N, int T,
                                        int C, float dt, void* stream) {
  return launch<true>(ie, ii, st_in, par, spikes, st_out, nullptr, N, T, C,
                      dt, 1, stream);
}
