// census: the event-sparse route's gate on the device.
//
//   n_events = max over instances n of  sum_{t, r} (ev[t, n, r] != 0)
//   k_max    = max over (n, t)        of  sum_r    (ev[t, n, r] != 0)
//   fits     = n_events <= max_events && k_max <= k_cap
//
// No TPU kernel: the reference computes this census with jnp ops
// (repro/core/events.py window_stats and census_fits) and branches on it
// with lax.cond (repro/core/synapse.py:250-257). This kernel is the device
// form of that predicate. It writes out[0] = fits, out[1] = n_events,
// out[2] = k_max (int32), and adds the decision to routes[fits] (int64
// [dense, sparse], may be null). synray_sparse.cu and synray.cu read
// out[0] as their flag, so the window's route is decided without a read
// back to the host.
//
// Bound on the H100: the efficacy plane is read once; a Dale half of the
// [T, N, 256] main-path window touches all its 32-byte sectors, 2 MB,
// 0.6 us at 3.35 TB/s. The operations (a compare, a ballot, a popc) are
// fewer. So the bytes bound it.
//
// Design: a grid of (step blocks, instances). A unit is (step, 32-row
// group), lane j reading row 32 g + j; each lane reads U units before it
// ballots them, so the loads are in flight together. A step's count is
// the sum of its units' popcounts (shared integer atomics: exact in any
// order); each block writes its steps' sum and maximum. The last block to
// finish (a ticket taken after a __threadfence, wrapping to 0 for the next
// launch) reduces every block's pair to the window's census, decides and
// counts the route.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 8;                // warps per block
constexpr int NT = NW * 32;          // threads per block
constexpr int U = 16;                // units a lane reads at once
constexpr int UB = NW * U;           // units a block reads at once

struct Args {
  const float* ev;
  long long st, sn, sr;
  int T, N, R, ts;                   // ts: steps a block
  int max_events, k_cap;
  int* part;                         // [N][step blocks][2]: sum, max
  unsigned* ticket;
  int* out;
  unsigned long long* routes;
};

__global__ void __launch_bounds__(NT) census_kernel(Args p) {
  __shared__ int s_cnt[UB];
  __shared__ int s_best[2];
  __shared__ bool s_last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = blockIdx.y, t0 = blockIdx.x * p.ts;
  const int G = max(1, (p.R + 31) / 32), nu = p.ts * G;
  for (int i = tid; i < UB; i += NT) s_cnt[i] = 0;
  if (tid < 2) s_best[tid] = 0;
  __syncthreads();

  const float* ev_n = p.ev + n * p.sn;
  // unit u's step and group, advanced from unit to unit without a
  // division: NW / G steps and NW % G groups (with a carry)
  const int dq = NW / G, dr = NW % G;
  int dt = warp / G, g = warp % G;
  for (int u0 = 0; u0 < nu; u0 += UB) {
    float e[U];
    int s[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int t = t0 + dt, r = g * 32 + lane;
      const bool ok = u0 + warp + NW * i < nu && t < p.T && r < p.R
                      && n < p.N;
      e[i] = ok ? ev_n[t * p.st + r * p.sr] : 0.0f;
      s[i] = dt;
      dt += dq;
      g += dr;
      if (g >= G) {
        g -= G;
        ++dt;
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (u0 + warp + NW * i >= nu) break;   // uniform across the warp
      const unsigned m = __ballot_sync(0xffffffffu, e[i] != 0.0f);
      if (lane == 0 && m != 0u) atomicAdd(&s_cnt[s[i]], __popc(m));
    }
  }
  __syncthreads();

  const int n_sb = gridDim.x;
  if (warp == 0) {
    int sum = 0, mx = 0;
    for (int i = lane; i < p.ts; i += 32) {
      sum += s_cnt[i];
      mx = max(mx, s_cnt[i]);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, d);
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, d));
    }
    if (lane == 0) {
      int* q = p.part + ((long long)n * n_sb + blockIdx.x) * 2;
      q[0] = sum;
      q[1] = mx;
      __threadfence();                      // the pair before the ticket
      const unsigned total = gridDim.x * gridDim.y;
      s_last = atomicInc(p.ticket, total - 1) == total - 1;
    }
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: every block's pair has landed
  __threadfence();
  for (int i = tid; i < p.N; i += NT) {
    int sum = 0, mx = 0;
    const int* q = p.part + (long long)i * n_sb * 2;
    for (int b = 0; b < n_sb; b += 8) {      // eight pairs in flight
      int2 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = b + k < n_sb ? __ldcg(reinterpret_cast<const int2*>(q) + b + k)
                            : make_int2(0, 0);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        sum += v[k].x;
        mx = max(mx, v[k].y);
      }
    }
    atomicMax(&s_best[0], sum);
    atomicMax(&s_best[1], mx);
  }
  __syncthreads();
  if (tid == 0) {
    const int fits = s_best[0] <= p.max_events && s_best[1] <= p.k_cap;
    p.out[0] = fits;
    p.out[1] = s_best[0];
    p.out[2] = s_best[1];
    if (p.routes != nullptr) atomicAdd(p.routes + fits, 1ull);
  }
}

}  // namespace

// ev float32 [T, N, R] read through strides (t, n, r); part int32 scratch
// of at least 2 * max(N, 1) * max(T, 1) ints, 8-byte aligned; ticket a
// device unsigned that is 0 between launches (the kernel leaves it so);
// out int32 [3]; routes int64 [2] or null.
extern "C" int census_launch(const void* ev, int T, int N, int R,
                             long long st, long long sn, long long sr,
                             int max_events, int k_cap, void* part,
                             void* ticket, void* out, void* routes,
                             void* stream) {
  const int G = R > 32 ? (R + 31) / 32 : 1;
  Args p{(const float*)ev, st, sn, sr, T, N, R, G >= UB ? 1 : UB / G,
         max_events, k_cap, (int*)part, (unsigned*)ticket, (int*)out,
         (unsigned long long*)routes};
  const int n_sb = (T + p.ts - 1) / p.ts;
  dim3 grid(n_sb > 0 ? n_sb : 1, N > 0 ? N : 1);
  census_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
