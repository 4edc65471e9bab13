// stp_scan: the short-term-plasticity efficacy trajectory of a window on
// Hopper, the T-step recurrence of core/stp.py per driver row:
//
//   eff[t] = clamp((u * r) * scale, 0, 1.5) * s[t]
//   r      = r + (1 - r) * recovery
//   r      = clamp(r - (u * r) * s[t], 0, 1)
//
// and, in its census form, the sparse route's gate of both Dale halves of
// the efficacies it writes (rows 0::2 and 1::2), the census of
// core/events.py window_stats and census_fits per half:
//
//   n_events = max over instances n of sum_{t, r in half} (eff[t, n, r] != 0)
//   k_max    = max over (n, t)       of sum_{r in half}    (eff[t, n, r] != 0)
//   fits     = n_events <= max_events && k_max <= k_cap  (the half's own)
//
// No TPU kernel: the reference runs the recurrence as a lax.scan of jnp
// ops (repro/core/anncore.py:333-341, stp_body), which XLA fuses into one
// loop, and the census with jnp ops under lax.cond
// (repro/core/synapse.py:250-257). This kernel is that scan as one launch,
// with each half's census taken from the values as they are stored: the
// census kernel's separate pass over the efficacy plane (every sector of
// it, once per half) and its two launches are gone.
//
// Bound on the H100: per lane T spikes read and T efficacies written as
// float32, plus r0, the scale and r_T (and the two censuses out). At the
// main path's shape (16 instances x 256 rows, T = 128) that is 4.2 MB,
// 1.3 us at 3.35 TB/s; about 15 operations a step are far below the
// float32 rate. What sets the time is the chain of 8 dependent operations
// a step of each row's resource r (six multiplies and adds and the
// clamp's max and min): the chain-floor probe below measures it.
//
// Design: a grid of (instance, row block), one thread a row, at most
// MAX_THREADS rows a block, r in a register for the whole window: every
// row's chain runs at once. The block's spike window goes to shared
// memory by cp.async copies (16 bytes a copy where rows are contiguous and
// the step stride a multiple of 4 floats: the block's rows from the
// 16-byte boundary at or below its first, read back at their offset; one
// float a copy otherwise, four times the copies to issue and slower)
// through a ring of NS stages of CH steps, NS - 1 of them issued
// before the chain starts (the whole main-path window of 128 steps is 4
// stages: one round trip). Each stage's spikes are read into registers
// before its steps run, so no load waits inside the chain. The clamps use
// the .NaN forms of max and min: PyTorch's NaN rule as a select compiled
// into a predicated block that reloaded its bound after the NaN test, on
// the chain of every step (the earlier form's largest cost).
// Census: at each step each warp ballots eff != 0 over the values it
// stores (the ballot taken at the start of the next step, off the chain),
// lane i of the warp keeping step i's ballot; after a stage each lane adds
// the popcounts of its step's even-row and odd-row lanes (the half taken
// from the row index), packed in one int, to that step's count. Where one
// block holds an instance's rows (R <= MAX_THREADS) the counts go to a
// pair of 32-step buffers in shared memory, and the first warp folds each
// stage's into a running (sum, max) per half while the next stage runs,
// so no array grows with T; each block then writes its instance's pair.
// Where an instance spans row blocks the counts go to a [N, T] array in
// global memory (integer atomics), which the last block reduces and
// leaves at 0. The last block to finish (a ticket taken after a
// __threadfence, wrapping to 0 for the next launch) takes the maximum
// over instances, decides each half against its capacities, writes the
// two censuses and adds the decisions to the route counter. Integers
// only: exact in any order.
//
// Exactness: built with -fmad=false, so no multiply and add contract into
// one FMA; the operations and their order are the plain version's (ref.py,
// stp.efficacy and stp.update): u * r (u rounded to float32, as PyTorch's
// multiply by a Python float rounds it), then * scale; 1 - r, * recovery,
// + r; u * r, * s, subtracted. The clamps give PyTorch's CUDA clamp's
// bits (see clamp_like_torch). With these the kernel equals its plain
// version on the card bit for bit, the sign of zero and NaNs included.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 256;    // rows a block
constexpr int NS = 4;               // ring stages of CH steps
constexpr int CH = 32;              // steps a stage (a warp's lanes: the
                                    // census keeps one step's ballot a lane)
constexpr int FLOOR_THREADS = 1024; // the chain-floor probe's largest block
constexpr int FLOOR_CHUNK = 8;      // spikes the chain-floor probe holds
constexpr int PAD = 4;              // a staged row's room for the floats
                                    // below its first row's 16-byte boundary
constexpr unsigned FULL = 0xffffffffu;

using Idx = long long;              // offsets into the operands

// census forms: none, one block an instance (counts folded in shared
// memory), an instance over row blocks (counts in a global [N, T] array)
enum Form { NONE = 0, FOLD = 1, GLOBAL = 2 };

struct Args {
  Idx st, sn, sr;            // spike strides (t, n, r)
  Idx cn, cr;                // scale strides (n, r)
  Idx NR;                    // N * R: the efficacy plane's step stride
  int T, N, R, B;            // B: threads a block, a multiple of 32
  int nst;                   // stages of CH steps
  float u, recovery, eff_max, r_max;
  int me0, kc0, me1, kc1;    // capacities of the even and the odd half
  bool vec;                  // 16-byte copies (rows contiguous, st % 4 == 0)
};

// max / min that return NaN if an operand is NaN (sm_80's .NaN forms);
// otherwise fmaxf / fminf, the sign of zero included
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// PyTorch's CUDA clamp (a NaN passes through, else fminf(fmaxf(v, lo),
// hi)) on the values this kernel clamps. Each is the result of a float
// multiply or add, which on the card is the canonical NaN when it is a
// NaN, so the .NaN forms give the same bits as passing v through; they
// keep the select off the chain (a predicated form with a reload of the
// bound waited on the NaN test at every step).
__device__ __forceinline__ float clamp_like_torch(float v, float lo,
                                                  float hi) {
  return min_nan(max_nan(v, lo), hi);
}

// copy 16 bytes, of which the first `bytes` are read and the rest zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Consts {
  float u, recovery, eff_max, r_max;
};

// One step of the recurrence on spike s: returns the efficacy, advances r.
__device__ __forceinline__ float stp_step(float& r, float s, float sc,
                                          const Consts& c) {
  const float zero = 0.0f, one = 1.0f;
  float e = c.u * r;
  e = e * sc;
  e = clamp_like_torch(e, zero, c.eff_max);
  e = e * s;
  float q = one - r;
  q = q * c.recovery;
  const float r1 = r + q;
  float d = c.u * r1;
  d = d * s;
  r = clamp_like_torch(r1 - d, zero, c.r_max);
  return e;
}

// a step's packed (even, odd) counts
__device__ __forceinline__ int unpack_even(int v) { return v & 0xffff; }
__device__ __forceinline__ int unpack_odd(int v) {
  return static_cast<int>(static_cast<unsigned>(v) >> 16);
}

// One stage of nt <= CH steps from its slot (sl: this thread's spike of
// step 0; steps P floats apart), the spikes read into registers first.
// With a census, lane i
// keeps the ballot of step i; after the stage each lane adds its step's
// packed (even, odd) count to cnt[lane]. Each step's ballot is taken at
// the start of the next step, when its operand has long been computed:
// a ballot orders the code around it, and one on the step's own
// efficacy held the next step's chain back by the efficacy's latency.
template <int FORM, bool WHOLE>
__device__ __forceinline__ void run_stage(const float* sl, int P, int nt,
                                          float& r, float sc,
                                          const Consts& c, float* o, Idx NR,
                                          bool valid, int lane,
                                          unsigned even, unsigned odd,
                                          int* cnt) {
  float s[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) s[i] = (WHOLE || i < nt) ? sl[i * P] : 0.0f;
  unsigned mine = 0u;
  bool fired = false;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    if (!WHOLE && i >= nt) break;
    if (FORM != NONE && i > 0) {
      const unsigned m = __ballot_sync(FULL, fired);
      mine = lane == i - 1 ? m : mine;
    }
    const float e = stp_step(r, s[i], sc, c);
    if (valid) *o = e;
    o += NR;
    fired = e != 0.0f;
  }
  if (FORM != NONE) {
    const unsigned m = __ballot_sync(FULL, fired);
    mine = lane == (WHOLE ? CH : nt) - 1 ? m : mine;
    if (WHOLE || lane < nt)
      atomicAdd(cnt + lane, __popc(mine & even) | (__popc(mine & odd) << 16));
  }
}

// adds a slot of CH packed counts to a lane's (sum, max) per half and
// zeroes it for the stage after next
__device__ __forceinline__ void fold(int* slot, int lane, int& se, int& so,
                                     int& xe, int& xo) {
  const int v = slot[lane];
  slot[lane] = 0;
  se += unpack_even(v);
  so += unpack_odd(v);
  xe = max(xe, unpack_even(v));
  xo = max(xo, unpack_odd(v));
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

// grid (N, row blocks); counts: the GLOBAL form's [N, T] packed counts,
// 0 before the launch and left at 0
template <int FORM>
__global__ void __launch_bounds__(MAX_THREADS)
stp_scan_kernel(const float* __restrict__ r0,
                const float* __restrict__ spikes,
                const float* __restrict__ scale, float* __restrict__ eff,
                float* __restrict__ r_out, int* __restrict__ census,
                int4* __restrict__ part, int* __restrict__ counts,
                unsigned* __restrict__ ticket,
                unsigned long long* __restrict__ routes, Args p) {
  extern __shared__ __align__(16) float ring[];   // [NS][CH][B + PAD]
  __shared__ int s_cnt[2 * CH];                    // FOLD: two stages' counts
  __shared__ int s_best[4];
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x, B = p.B, P = B + PAD, row0 = blockIdx.y * B;
  const int row = row0 + tid, nr = min(B, p.R - row0);
  const bool valid = row < p.R;
  const Consts c{p.u, p.recovery, p.eff_max, p.r_max};
  if (FORM != NONE) {
    for (int i = tid; i < 2 * CH; i += B) s_cnt[i] = 0;
    if (tid < 4) s_best[tid] = 0;
  }
  const float* sp_n = spikes + (Idx)n * p.sn;

  // the copies of a stage: unit cc of a step (a 16-byte chunk or one
  // float), spi steps a round. With 16-byte copies the block's first row
  // sits mis floats above a 16-byte boundary at every step; the chunks
  // start at that boundary (the first reads the mis floats below the row,
  // which lie in the spikes' storage: it starts on a 16-byte boundary)
  const float* sp_r = sp_n + row0;
  const int mis = p.vec ? static_cast<int>(
      (reinterpret_cast<uintptr_t>(sp_r) >> 2) & 3) : 0;
  const int cpr = max(1, p.vec ? (nr + mis + 3) / 4 : nr);
  const int spi = B / cpr, cj = tid / cpr, cc = tid - cj * cpr;
  // this thread's copies: steps cj, cj + spi, ... of a stage (pointers
  // advanced, not recomputed), chunk or float cc of each
  const float* sp_c = p.vec ? sp_r : sp_r + (Idx)cc * p.sr;
  const Idx src_step = (Idx)spi * p.st;
  auto issue = [&](int k) {
    const int t0 = k * CH, nt = min(CH, p.T - t0);
    if (cj >= spi || nr <= 0) return;
    const float* src = sp_c + (Idx)(t0 + cj) * p.st;
    float* dst = ring + (k % NS) * CH * P + cj * P;
    for (int i = cj; i < nt; i += spi) {
      if (p.vec) {
        const int c4 = 4 * cc;
        cp_async16(dst + c4, src + (c4 - mis), 4 * min(4, mis + nr - c4));
      } else {
        cp_async4(dst + cc, src);
      }
      src += src_step;
      dst += spi * P;
    }
  };
  for (int k = 0; k < NS - 1; ++k) {     // one group a stage
    if (k < p.nst) issue(k);
    cp_async_commit();
  }

  float r = 0.0f, sc = 0.0f;
  if (valid) {
    r = r0[(Idx)n * p.R + row];
    sc = scale[(Idx)n * p.cn + (Idx)row * p.cr];
  }
  unsigned even = 0u, odd = 0u;
  if (FORM != NONE) {
    even = __ballot_sync(FULL, valid && (row & 1) == 0);
    odd = __ballot_sync(FULL, valid && (row & 1) == 1);
  }
  int se = 0, so = 0, xe = 0, xo = 0;   // FOLD: the first warp's fold
  float* out = eff + (Idx)n * p.R + row;
  for (int k = 0; k < p.nst; ++k) {
    cp_async_wait<NS - 2>();
    __syncthreads();                  // stage k landed; slot k - 1 is free
    if (FORM == FOLD && k > 0 && warp == 0)
      fold(s_cnt + ((k - 1) & 1) * CH, lane, se, so, xe, xo);
    if (k + NS - 1 < p.nst) issue(k + NS - 1);
    cp_async_commit();
    const float* sl = ring + (k % NS) * CH * P + mis + tid;
    const int t0 = k * CH, nt = min(CH, p.T - t0);
    float* o = out + (Idx)t0 * p.NR;
    int* cnt = FORM == GLOBAL ? counts + (Idx)n * p.T + t0
                              : s_cnt + (k & 1) * CH;
    if (nt == CH)
      run_stage<FORM, true>(sl, P, nt, r, sc, c, o, p.NR, valid, lane,
                            even, odd, cnt);
    else
      run_stage<FORM, false>(sl, P, nt, r, sc, c, o, p.NR, valid, lane,
                             even, odd, cnt);
  }
  if (valid) r_out[(Idx)n * p.R + row] = r;
  if (FORM == NONE) return;

  if (FORM == FOLD) {
    // the instance's census per half: (sum, max) of its steps' counts
    __syncthreads();                  // the last stage's counts landed
    if (warp == 0) {
      if (p.nst > 0) fold(s_cnt + ((p.nst - 1) & 1) * CH, lane, se, so, xe,
                          xo);
      se = warp_sum(se);
      so = warp_sum(so);
      xe = warp_max(xe);
      xo = warp_max(xo);
      if (lane == 0) {
        part[n] = make_int4(se, so, xe, xo);
        __threadfence();              // the census before the ticket
        const unsigned total = gridDim.x * gridDim.y;
        s_last = atomicInc(ticket, total - 1) == total - 1;
      }
    }
  } else {
    __threadfence();                  // the block's counts before the ticket
    __syncthreads();
    if (tid == 0) {
      const unsigned total = gridDim.x * gridDim.y;
      s_last = atomicInc(ticket, total - 1) == total - 1;
    }
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: every instance's census has landed
  __threadfence();
  if (FORM == FOLD) {
    for (int i = tid; i < p.N; i += B) {
      const int4 v = __ldcg(part + i);
      atomicMax(&s_best[0], v.x);
      atomicMax(&s_best[1], v.y);
      atomicMax(&s_best[2], v.z);
      atomicMax(&s_best[3], v.w);
    }
  } else {
    // a warp an instance: its steps' counts summed and their maximum,
    // each left at 0 for the next launch
    int ne = 0, no = 0;
    for (int m = warp; m < p.N; m += B / 32) {
      int* cm = counts + (Idx)m * p.T;
      int me = 0, mo = 0;
      for (int t = lane; t < p.T; t += 32) {
        const int v = __ldcg(cm + t);
        cm[t] = 0;
        me += unpack_even(v);
        mo += unpack_odd(v);
        xe = max(xe, unpack_even(v));
        xo = max(xo, unpack_odd(v));
      }
      ne = max(ne, warp_sum(me));
      no = max(no, warp_sum(mo));
    }
    xe = warp_max(xe);
    xo = warp_max(xo);
    if (lane == 0) {
      atomicMax(&s_best[0], ne);
      atomicMax(&s_best[1], no);
      atomicMax(&s_best[2], xe);
      atomicMax(&s_best[3], xo);
    }
  }
  __syncthreads();
  if (tid == 0) {
    const int f0 = s_best[0] <= p.me0 && s_best[2] <= p.kc0;
    const int f1 = s_best[1] <= p.me1 && s_best[3] <= p.kc1;
    census[0] = f0;
    census[1] = s_best[0];
    census[2] = s_best[2];
    census[4] = f1;
    census[5] = s_best[1];
    census[6] = s_best[3];
    if (routes != nullptr) {
      atomicAdd(routes + f0, 1ull);
      atomicAdd(routes + f1, 1ull);
    }
  }
}

// The chain floor, a measurement aid: the same recurrence and stores, one
// thread per (instance, row) lane in blocks of `blockDim.x`, with each
// lane's first FLOOR_CHUNK spikes loaded into registers before the loop
// and reused in turn, so no memory load sits inside it.
__global__ void __launch_bounds__(FLOOR_THREADS)
stp_floor_kernel(const float* __restrict__ r0,
                 const float* __restrict__ spikes,
                 const float* __restrict__ scale, float* __restrict__ eff,
                 float* __restrict__ r_out, Args p) {
  const Idx lane = (Idx)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.NR) return;
  const int n = static_cast<int>(lane / p.R);
  const int row = static_cast<int>(lane - (Idx)n * p.R);
  const Consts c{p.u, p.recovery, p.eff_max, p.r_max};
  const float sc = scale[(Idx)n * p.cn + (Idx)row * p.cr];
  const float* sp = spikes + (Idx)n * p.sn + (Idx)row * p.sr;
  float s[FLOOR_CHUNK];
#pragma unroll
  for (int i = 0; i < FLOOR_CHUNK; ++i)
    s[i] = i < p.T ? sp[(Idx)i * p.st] : 0.0f;
  float r = r0[lane];
  float* o = eff + lane;
  for (int t0 = 0; t0 < p.T; t0 += FLOOR_CHUNK) {
#pragma unroll
    for (int i = 0; i < FLOOR_CHUNK; ++i) {
      if (t0 + i >= p.T) break;
      *o = stp_step(r, s[i], sc, c);
      o += p.NR;
    }
  }
  r_out[lane] = r;
}

Args make_args(int T, int N, int R, long long st, long long sn,
               long long sr, long long cn, long long cr, float u,
               float recovery, float eff_max, float r_max) {
  Args p{};
  p.st = st;
  p.sn = sn;
  p.sr = sr;
  p.cn = cn;
  p.cr = cr;
  p.NR = (Idx)N * R;
  p.T = T;
  p.N = N;
  p.R = R;
  p.u = u;
  p.recovery = recovery;
  p.eff_max = eff_max;
  p.r_max = r_max;
  return p;
}

template <int FORM>
int launch(Args p, dim3 grid, size_t smem, const void* r0,
           const void* spikes, const void* scale, void* eff, void* r_out,
           void* census, void* part, void* counts, void* ticket,
           void* routes, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stp_scan_kernel<FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  stp_scan_kernel<FORM><<<grid, p.B, smem, stream>>>(
      (const float*)r0, (const float*)spikes, (const float*)scale,
      (float*)eff, (float*)r_out, (int*)census, (int4*)part, (int*)counts,
      (unsigned*)ticket, (unsigned long long*)routes, p);
  return (int)cudaGetLastError();
}

}  // namespace

// r0 float32 [N, R] contiguous; spikes float32 [T, N, R] read through
// strides (t, n, r) (non-negative), in a storage that starts on a 16-byte
// boundary (a 16-byte copy may read up to 3 floats before a row); scale float32 [N, R] read through
// strides (n, r) (0 for a broadcast axis); eff float32 [T, N, R] and r_out
// float32 [N, R] written contiguous. With `census` (int32 [8], 16-byte
// aligned) the census form: census[0:3] and census[4:7] get (fits,
// n_events, k_max) of rows 0::2 and 1::2 against caps (max_events, k_cap)
// of each; part is int32 scratch of 4 * N ints, 16-byte aligned; counts
// int32 [N, T] at 0 (the kernel leaves it so), read where an instance
// spans row blocks (R > MAX_THREADS); ticket a device unsigned that is 0
// between launches (the kernel leaves it so); routes int64 [2] (dense,
// sparse) or null. A null census is the form without the gate (part,
// counts, ticket and routes unused).
extern "C" int stp_scan_launch(const void* r0, const void* spikes,
                               const void* scale, void* eff, void* r_out,
                               int T, int N, int R, long long st,
                               long long sn, long long sr, long long cn,
                               long long cr, float u, float recovery,
                               float eff_max, float r_max, void* census,
                               int me0, int kc0, int me1, int kc1,
                               void* part, void* counts, void* ticket,
                               void* routes, void* stream) {
  if (N <= 0 || R < 0 || T < 0 || R > 65535 || st < 0 || sn < 0 || sr < 0
      || cn < 0 || cr < 0)
    return N == 0 && census == nullptr ? 0 : (int)cudaErrorInvalidValue;
  Args p = make_args(T, N, R, st, sn, sr, cn, cr, u, recovery, eff_max,
                     r_max);
  const int rows = R < MAX_THREADS ? R : MAX_THREADS;
  p.B = rows < 32 ? 32 : (rows + 31) / 32 * 32;
  p.vec = sr == 1 && st % 4 == 0
          && (reinterpret_cast<uintptr_t>(spikes) & 3) == 0;
  p.nst = (T + CH - 1) / CH;
  p.me0 = me0;
  p.kc0 = kc0;
  p.me1 = me1;
  p.kc1 = kc1;
  const int nb = R > p.B ? (R + p.B - 1) / p.B : 1;
  const dim3 grid(N, nb);
  const int nslot = p.nst < NS ? p.nst : NS;
  const size_t smem = (size_t)nslot * CH * (p.B + PAD) * 4;
  cudaStream_t s = (cudaStream_t)stream;
  if (census == nullptr)
    return launch<NONE>(p, grid, smem, r0, spikes, scale, eff, r_out,
                        nullptr, nullptr, nullptr, nullptr, nullptr, s);
  if (nb == 1)
    return launch<FOLD>(p, grid, smem, r0, spikes, scale, eff, r_out,
                        census, part, nullptr, ticket, routes, s);
  if (counts == nullptr) return (int)cudaErrorInvalidValue;
  return launch<GLOBAL>(p, grid, smem, r0, spikes, scale, eff, r_out,
                        census, part, counts, ticket, routes, s);
}

// The chain-floor probe (a measurement aid, not a window): operands as
// stp_scan_launch's, `threads` lanes a block over the flattened (n, r)
// lanes; eff and r_out are the recurrence's on each lane's first
// FLOOR_CHUNK spikes reused in turn.
extern "C" int stp_scan_floor_launch(const void* r0, const void* spikes,
                                     const void* scale, void* eff,
                                     void* r_out, int T, int N, int R,
                                     long long st, long long sn,
                                     long long sr, long long cn,
                                     long long cr, float u, float recovery,
                                     float eff_max, float r_max, int threads,
                                     void* stream) {
  const long long lanes = (long long)N * R;
  if (lanes == 0) return 0;
  if (threads < 32 || threads > FLOOR_THREADS || threads % 32 != 0
      || st < 0 || sn < 0 || sr < 0 || cn < 0 || cr < 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (lanes + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Args p = make_args(T, N, R, st, sn, sr, cn, cr, u, recovery,
                           eff_max, r_max);
  stp_floor_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)r0, (const float*)spikes, (const float*)scale,
      (float*)eff, (float*)r_out, p);
  return (int)cudaGetLastError();
}
