// synray_sparse: the event-sparse synapse-array path on Hopper.
//
//   out[n, t, c] = sum over the kept events (t, row) of instance n of
//                  eff[t, n, row] * w[n, row, c]
//                  * (addr_store[n, row, c] == addr[t, n, row])
//
// Replaces the TPU kernel repro/kernels/synray_sparse/kernel.py,
// sparse_window_pallas (_kernel): a grid of (instance, column block),
// each step staging the instance's whole [R, cb] store slice in VMEM and
// contracting the gathered rows of its [T, K] records in one dot.
//
// Two forms share one accumulate loop:
//   * the window form (the route's: synapse.synaptic_current_window)
//     reads the [T, N, R] efficacy and event-address planes through their
//     strides (a Dale half of the [T, N, 2R] planes in place) and keeps
//     the records that events.regroup_window keeps: a row fires at a step
//     when eff != 0.0 (a float compare: -0.0 is silent), and a fired row
//     is kept when its rank within the step is below k_cap and its t-major
//     ordinal within the instance below max_events. So the window needs
//     no pack: on every window, also one that overflows, it equals
//     regroup_window followed by the record form, bit for bit;
//   * the record form takes the [N, T, K] records (rows, addresses,
//     efficacies) of repro's sparse_window, empty slots with eff == 0.
//
// Bound on the H100: at the main-path shape (N = 16 instances, T = 128
// steps, one Dale half of R = 128 rows, C = 512 columns) the window form
// touches every 32-byte sector of the efficacy and address planes of the
// whole [T, N, 256] window (a Dale half is every other element: 2 MB and
// 0.5 MB), reads the two int8 stores of its half (2 x 1 MB) and writes
// 4 MB of currents: about 8.9 MB, 2.7 us at 3.35 TB/s. The FMAs the
// window needs (kept records x matched columns, about 150 records an
// instance) are a few hundred thousand. So the bytes bound it.
//
// Design: a block takes an instance and CB = 256 columns, NT = 512
// threads.
//   * It stages its [R, CB] tile of weights and store addresses in shared
//     memory once (16-byte cp.async where the rows allow), 64 KB at the
//     main path's shape; the accumulate loop reads it from there.
//   * The window is read in chunks of tc steps. A unit is (step, 32-row
//     group): lane j holds row 32 g + j. A lane reads its UPW units of a
//     chunk into registers at once, so their loads are in flight
//     together; a ballot of eff != 0 gives each unit's fired rows, and
//     the efficacies and addresses of the fired rows go to shared memory.
//   * Each thread owns TN = 4 neighbouring columns and a share of the
//     chunk's steps; per step it walks the kept rows (set bits, ascending,
//     the same for the whole warp), reads each kept row's 4 weights and 4
//     store addresses as one word each, accumulates with explicit fmaf,
//     and stores its 4 outputs as one 16-byte word. No atomics, no split
//     over rows.
// The route (synapse.synaptic_current_window) launches it behind the
// census's flag (census.cu): where the flag is 0 the window does not fit
// and every block returns at once (the dense kernel, synray.cu, writes
// the output); where it is 1 the window fits its capacities, so no
// record is dropped and every fired row is kept, and each block takes
// one chunk of steps on its own (a grid of column blocks x instances x
// chunks: 2 x 16 x 4 = 128 blocks at the main path's shape). A window of unknown
// census (sparse="always", no flag) takes the ordered form: one block
// walks all the steps of its instance in order, so the t-major ordinal
// is a running count, reading the next chunk while it works on the
// current one (double-buffered), and one warp turns each chunk's ballots
// into kept counts: the step's fired count (popc over its groups), a
// warp prefix sum on top of the instance's running count, and kept =
// min(fired, k_cap, max_events - ordinal of the step's first event), at
// least 0; the kept records of a step are its first `kept` fired rows.
// The record form splits the steps over blocks too.

// Exactness: every output is one fmaf chain over the kept rows in
// ascending row order, the same chain the record form runs over its
// slots and the dense kernel (synray.cu) runs over all rows, where a
// silent or unmatched row adds fmaf(0, w, acc) == acc: the sum starts at
// +0 and is never -0 (fmaf gives -0 only from a -0 sum), so those no-ops
// change no bit. On a window that fits its capacities the three are
// therefore equal bit for bit. Built with the default flags: the kernels
// use explicit fmaf.
//
// Windows with more than MAX_WINDOW_ROWS rows take the record form after
// regroup_window (the wrapper does that); tiles of more than
// MAX_STAGED_TILE bytes are read from global memory instead of staged.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TN = 4;                 // columns a thread
constexpr int CW = 2;                 // warps across the columns
constexpr int CB = CW * 32 * TN;      // columns per block
constexpr int NW = 16;                // warps per block
constexpr int NT = NW * 32;           // threads per block
constexpr int UPW = 8;                // window units a lane reads a chunk
constexpr int UNITS = NW * UPW;       // units per chunk
constexpr int TC_MAX = 128;           // steps per chunk (the scan's 4 x 32)
constexpr int TR = 32;                // record form: steps per chunk
constexpr int KB = 32;                // record form: slots per chunk
constexpr int SL = NW / CW;           // warps across the steps
constexpr int MAX_STAGED_TILE = 96 * 1024;
constexpr int MAX_WINDOW_ROWS = UNITS * 32;
constexpr int R_ALL = 1 << 30;        // keep every fired row
static_assert(TN == 4, "a thread's columns are one 4-byte word of a row");
static_assert(NW % CW == 0, "block shape");
static_assert(TR % SL == 0, "record steps split evenly over the warps");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

struct Args {
  // window form: [T, N, R] planes read through (t, n, r) strides
  const float* ev;
  const int8_t* ea;
  long long ev_st, ev_sn, ev_sr, ea_st, ea_sn, ea_sr;
  int max_events, k_cap, tc;
  // record form: [N, T, K] records, each instance's [T, K] contiguous
  const int* rows;
  const int* raddr;
  const float* reff;
  long long rec_sn;
  int K;
  // stores [N, R, C] (columns contiguous), output through (n, t) strides
  const int8_t* w;
  const int8_t* st;
  long long w_sn, w_sr, a_sn, a_sr;
  float* out;
  long long o_sn, o_st;
  const int* flag;    // null: run; else run only where *flag != 0
  int N, T, R, C;
  bool vec;           // stores 16-byte aligned with 16-byte row strides
  bool vec_out;       // output 16-byte aligned, strides a multiple of 4
};

// The store tile: [R][CB] weights and addresses in shared memory (STAGED)
// or read in place (zeros past column C).
template <bool STAGED>
struct Tile {
  const int8_t* w;
  const int8_t* a;
  long long sw, sa;
  int cn;                        // columns left from the tile's first
  // the TN bytes of row r from column q, four to a word
  __device__ __forceinline__ void row4(int r, int q, unsigned& wb,
                                       unsigned& ab) const {
    if (STAGED) {
      wb = *reinterpret_cast<const unsigned*>(w + r * CB + q);
      ab = *reinterpret_cast<const unsigned*>(a + r * CB + q);
    } else {
      wb = ab = 0u;
#pragma unroll
      for (int k = 0; k < TN; ++k)
        if (q + k < cn) {
          wb |= (unsigned)(uint8_t)w[r * sw + q + k] << (8 * k);
          ab |= (unsigned)(uint8_t)a[r * sa + q + k] << (8 * k);
        }
    }
  }
};

// One record of a step on a thread's TN columns: acc += eff * w[row, c]
// where the store address matches the event's.
template <bool STAGED>
__device__ __forceinline__ void accumulate(float (&acc)[TN],
                                           const Tile<STAGED>& tl, int r,
                                           int q, float e, int a) {
  unsigned wb, ab;
  tl.row4(r, q, wb, ab);
#pragma unroll
  for (int k = 0; k < TN; ++k)
    if ((int)(int8_t)(ab >> (8 * k)) == a)
      acc[k] = fmaf(e, (float)(int8_t)(wb >> (8 * k)), acc[k]);
}

// A thread's TN outputs of one step (16 bytes at once where aligned).
__device__ __forceinline__ void store4(const Args& p, float* o, int c,
                                       const float (&acc)[TN]) {
  if (p.vec_out && c + TN <= p.C) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2],
                                                acc[3]);
  } else {
#pragma unroll
    for (int k = 0; k < TN; ++k)
      if (c + k < p.C) o[k] = acc[k];
  }
}

// Stage rows [0, R) x columns [c0, c0 + CB) of both stores (zeros past C).
template <bool STAGED>
__device__ Tile<STAGED> stage_tile(const Args& p, int n, int c0,
                                   unsigned char* smem, int tid) {
  const int8_t* w_n = p.w + n * p.w_sn;
  const int8_t* a_n = p.st + n * p.a_sn;
  if (!STAGED)
    return Tile<STAGED>{w_n + c0, a_n + c0, p.w_sr, p.a_sr, p.C - c0};
  int8_t* s_w = reinterpret_cast<int8_t*>(smem);
  int8_t* s_a = s_w + p.R * CB;
  if (p.vec && c0 + CB <= p.C) {
    for (int k = tid; k < p.R * (CB / 16); k += NT) {
      const int r = k / (CB / 16), q = (k % (CB / 16)) * 16;
      cp_async16(s_w + r * CB + q, w_n + r * p.w_sr + c0 + q);
      cp_async16(s_a + r * CB + q, a_n + r * p.a_sr + c0 + q);
    }
  } else {
    for (int k = tid; k < p.R * CB; k += NT) {
      const int r = k / CB, q = k % CB, c = c0 + q;
      s_w[k] = c < p.C ? w_n[r * p.w_sr + c] : 0;
      s_a[k] = c < p.C ? a_n[r * p.a_sr + c] : 0;
    }
  }
  return Tile<STAGED>{s_w, s_a, CB, CB, p.C - c0};
}

__host__ __device__ constexpr int tile_bytes(int R) {
  return (2 * R * CB + 15) / 16 * 16;
}

// A lane's units of one chunk, read ahead into registers (the addresses
// four bytes to a register).
struct Ahead {
  float e[UPW];
  unsigned a[UPW / 4];
};
static_assert(UPW % 4 == 0, "addresses pack four to a register");

// the window form's shared chunk: fired rows' efficacies and addresses by
// (step, row), and the units' ballots
struct Chunk {
  float ev[UNITS * 32];
  int8_t ea[UNITS * 32];
  unsigned mask[UNITS];
};

// This lane's part of instance n's window: unit u = warp + NW * i of a
// chunk is step u / G, rows 32 (u % G) .. + 31, the lane's row among them.
// From one unit to the next the step advances by NW / G and the group by
// NW % G (with a carry), so no unit needs a division.
struct Lane {
  const float* ev;
  const int8_t* ea;
  int G, nu, warp, lane;
  int dt0, g0, dq, dr;           // the first unit's step and group; steps
                                 // and groups from one unit to the next
  __device__ Lane(const Args& p, int n, int G_, int tc, int warp_,
                  int lane_)
      : ev(p.ev + n * p.ev_sn), ea(p.ea + n * p.ea_sn), G(G_),
        nu(tc * G_), warp(warp_), lane(lane_), dt0(warp_ / G_),
        g0(warp_ % G_), dq(NW / G_), dr(NW % G_) {}
};

__device__ __forceinline__ void read_units(Ahead& A, const Args& p,
                                           const Lane& L, int t0) {
  int dt = L.dt0, g = L.g0;
#pragma unroll
  for (int i = 0; i < UPW / 4; ++i) A.a[i] = 0u;
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    const int t = t0 + dt, r = g * 32 + L.lane;
    const bool ok = L.warp + NW * i < L.nu && t < p.T && r < p.R;
    A.e[i] = ok ? L.ev[t * p.ev_st + r * p.ev_sr] : 0.0f;
    const unsigned b = ok ? (uint8_t)L.ea[t * p.ea_st + r * p.ea_sr] : 0u;
    A.a[i / 4] |= b << (8 * (i % 4));
    dt += L.dq;
    g += L.dr;
    if (g >= L.G) {
      g -= L.G;
      ++dt;
    }
  }
}

// ballot each unit's fired rows (eff != 0.0), keep their values
__device__ __forceinline__ void commit_units(const Ahead& A, Chunk& ch,
                                             const Lane& L) {
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    const int u = L.warp + NW * i;           // uniform across the warp
    if (u >= L.nu) break;
    const bool fired = A.e[i] != 0.0f;
    const unsigned m = __ballot_sync(0xffffffffu, fired);
    if (L.lane == 0) ch.mask[u] = m;
    if (fired) {
      ch.ev[u * 32 + L.lane] = A.e[i];
      ch.ea[u * 32 + L.lane] = (int8_t)(A.a[i / 4] >> (8 * (i % 4)));
    }
  }
}

// Step s of a chunk: the sum over its first `kept` fired rows, ascending
// (the same rows for the whole warp).
template <bool STAGED>
__device__ __forceinline__ void step_sum(float (&acc)[TN], const Chunk& ch,
                                         const Tile<STAGED>& tl, int s,
                                         int G, int kept, int q) {
#pragma unroll
  for (int k = 0; k < TN; ++k) acc[k] = 0.0f;
  const unsigned* mask = ch.mask + s * G;
  const float* ev = ch.ev + s * G * 32;
  const int8_t* ea = ch.ea + s * G * 32;
  // the groups' ballots read four ahead, so their loads overlap
  unsigned b0 = mask[0], b1 = G > 1 ? mask[1] : 0u;
  unsigned b2 = G > 2 ? mask[2] : 0u, b3 = G > 3 ? mask[3] : 0u;
  for (int g = 0; kept > 0 && g < G; ++g) {
    unsigned m = b0;
    b0 = b1;
    b1 = b2;
    b2 = b3;
    b3 = g + 4 < G ? mask[g + 4] : 0u;
    while (m != 0u && kept > 0) {
      const int r = g * 32 + __ffs(m) - 1;
      m &= m - 1;
      --kept;
      accumulate(acc, tl, r, q, ev[r], (int)ea[r]);
    }
  }
}

// The gated window: the census's flag says whether the window fits its
// capacities. Where it does not, the dense kernel computes and every
// block returns; where it does, no record is dropped, every fired row is
// kept, and each block takes one chunk of steps (grid z) on its own.
template <bool STAGED>
__global__ void __launch_bounds__(NT) gated_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.y, c0 = blockIdx.x * CB, t0 = blockIdx.z * p.tc;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (*p.flag == 0) return;
  const Tile<STAGED> tl = stage_tile<STAGED>(p, n, c0, smem, tid);
  Chunk& ch = *reinterpret_cast<Chunk*>(smem +
                                        (STAGED ? tile_bytes(p.R) : 0));
  const int G = max(1, (p.R + 31) / 32);
  const Lane L(p, n, G, p.tc, warp, lane);
  Ahead A;
  read_units(A, p, L, t0);
  commit_units(A, ch, L);
  cp_async_wait_all();                       // the tile
  __syncthreads();                           // the chunk's ballots landed
  const int q = ((warp % CW) * 32 + lane) * TN, c = c0 + q;
  const int steps = min(p.tc, p.T - t0);
  if (c >= p.C) return;
  float* o = p.out + n * p.o_sn + t0 * p.o_st + c;
  for (int s = warp / CW; s < steps; s += SL) {
    float acc[TN];
    step_sum(acc, ch, tl, s, G, R_ALL, q);
    store4(p, o + s * p.o_st, c, acc);
  }
}

// A window of unknown census (sparse="always"): the block walks all T
// steps of its instance in order, so the t-major ordinal is a running
// count, and keeps the records regroup_window keeps.
template <bool STAGED>
__global__ void __launch_bounds__(NT, 1) ordered_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.y, c0 = blockIdx.x * CB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Tile<STAGED> tl = stage_tile<STAGED>(p, n, c0, smem, tid);
  Chunk* buf = reinterpret_cast<Chunk*>(smem + (STAGED ? tile_bytes(p.R) : 0));
  int* s_kept = reinterpret_cast<int*>(buf + 2);      // [TC_MAX]
  const int G = max(1, (p.R + 31) / 32), tc = p.tc;
  const Lane L(p, n, G, tc, warp, lane);
  const int q = ((warp % CW) * 32 + lane) * TN, c = c0 + q;
  int ordinal = 0;                           // warp 0: events so far
  Ahead A;
  read_units(A, p, L, 0);
  for (int t0 = 0, k = 0; t0 < p.T; t0 += tc, ++k) {
    Chunk& ch = buf[k & 1];
    commit_units(A, ch, L);
    if (t0 + tc < p.T) read_units(A, p, L, t0 + tc);   // in flight now
    cp_async_wait_all();                     // the tile (first chunk)
    __syncthreads();                         // the chunk's ballots landed
    const int steps = min(tc, p.T - t0);
    if (warp == 0) {
      // kept counts: lane l takes steps 4l .. 4l + 3
      int cnt[4], total = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = lane * 4 + j;
        cnt[j] = 0;
        if (s < steps)
          for (int g = 0; g < G; ++g) cnt[j] += __popc(ch.mask[s * G + g]);
        total += cnt[j];
      }
      int incl = total;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += x;
      }
      long long first = (long long)ordinal + incl - total;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = lane * 4 + j;
        const long long room = min((long long)p.k_cap,
                                   (long long)p.max_events - first);
        if (s < steps)
          s_kept[s] = (int)max(0LL, min((long long)cnt[j], room));
        first += cnt[j];
      }
      ordinal += __shfl_sync(0xffffffffu, incl, 31);
    }
    __syncthreads();                         // kept counts landed
    if (c < p.C) {
      float* o = p.out + n * p.o_sn + t0 * p.o_st + c;
      for (int s = warp / CW; s < steps; s += SL) {
        float acc[TN];
        step_sum(acc, ch, tl, s, G, s_kept[s], q);
        store4(p, o + s * p.o_st, c, acc);
      }
    }
  }
}

// The record form: each block takes TR steps (grid z) of one instance's
// records, K slots at a time.
template <bool STAGED>
__global__ void __launch_bounds__(NT) record_kernel(Args p) {
  if (p.flag != nullptr && *p.flag == 0) return;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.y, c0 = blockIdx.x * CB, t0 = blockIdx.z * TR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Tile<STAGED> tl = stage_tile<STAGED>(p, n, c0, smem, tid);
  unsigned char* rec = smem + (STAGED ? tile_bytes(p.R) : 0);
  int(*s_row)[KB] = reinterpret_cast<int(*)[KB]>(rec);
  int(*s_addr)[KB] = s_row + TR;
  float(*s_eff)[KB] = reinterpret_cast<float(*)[KB]>(s_addr + TR);

  const int q = ((warp % CW) * 32 + lane) * TN, c = c0 + q;
  const int sl = warp / CW;
  const long long rec_n = n * p.rec_sn;
  float acc[TR / SL][TN];
#pragma unroll
  for (int i = 0; i < TR / SL; ++i)
#pragma unroll
    for (int k = 0; k < TN; ++k) acc[i][k] = 0.0f;
  for (int k0 = 0; k0 < p.K; k0 += KB) {
    const int kn = min(KB, p.K - k0);
    __syncthreads();                         // the last slots are used up
    for (int x = tid; x < TR * KB; x += NT) {
      const int i = x / KB, j = x % KB, t = t0 + i;
      const bool ok = t < p.T && j < kn;
      const long long at = rec_n + (long long)t * p.K + k0 + j;
      s_row[i][j] = ok ? p.rows[at] : 0;
      s_addr[i][j] = ok ? p.raddr[at] : 0;
      s_eff[i][j] = ok ? p.reff[at] : 0.0f;
    }
    cp_async_wait_all();
    __syncthreads();
    if (c < p.C) {
#pragma unroll
      for (int i = 0; i < TR / SL; ++i) {
        const int s = sl + SL * i;
        for (int j = 0; j < kn; ++j) {       // ascending slots
          const float e = s_eff[s][j];
          if (e == 0.0f) continue;
          accumulate(acc[i], tl, s_row[s][j], q, e, s_addr[s][j]);
        }
      }
    }
  }
  if (c < p.C) {
#pragma unroll
    for (int i = 0; i < TR / SL; ++i) {
      const int t = t0 + sl + SL * i;
      if (t < p.T) store4(p, p.out + n * p.o_sn + t * p.o_st + c, c, acc[i]);
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <typename K>
int launch(K kernel, const Args& p, int steps, int smem,
           cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.C + CB - 1) / CB, p.N, (p.T + steps - 1) / steps);
  kernel<<<grid, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

Args stores(const void* w, const void* st, void* out, const void* flag,
            int N, int T, int R, int C, long long w_sn, long long w_sr,
            long long a_sn, long long a_sr, long long o_sn,
            long long o_st) {
  Args p{};
  p.w = (const int8_t*)w;
  p.st = (const int8_t*)st;
  p.out = (float*)out;
  p.flag = (const int*)flag;
  p.N = N; p.T = T; p.R = R; p.C = C;
  p.w_sn = w_sn; p.w_sr = w_sr; p.a_sn = a_sn; p.a_sr = a_sr;
  p.o_sn = o_sn; p.o_st = o_st;
  p.vec = aligned16(w) && aligned16(st) && w_sn % 16 == 0 &&
          w_sr % 16 == 0 && a_sn % 16 == 0 && a_sr % 16 == 0;
  p.vec_out = aligned16(out) && o_sn % 4 == 0 && o_st % 4 == 0;
  return p;
}

}  // namespace

// The window form. ev float32 / ea int8 [T, N, R] read through strides
// (t, n, r); w / st int8 [N, R, C] with contiguous columns; out float32
// written through (n, t) strides; flag int32 or null. R must be at most
// MAX_WINDOW_ROWS.
extern "C" int synray_sparse_window_launch(
    const void* ev, const void* ea, const void* w, const void* st,
    void* out, const void* flag, int N, int T, int R, int C,
    long long ev_st, long long ev_sn, long long ev_sr, long long ea_st,
    long long ea_sn, long long ea_sr, long long w_sn, long long w_sr,
    long long a_sn, long long a_sr, long long o_sn, long long o_st,
    int max_events, int k_cap, void* stream) {
  if (N == 0 || T == 0 || C == 0) return 0;
  if (R > MAX_WINDOW_ROWS) return (int)cudaErrorInvalidValue;
  Args p = stores(w, st, out, flag, N, T, R, C, w_sn, w_sr, a_sn, a_sr,
                  o_sn, o_st);
  p.ev = (const float*)ev;
  p.ea = (const int8_t*)ea;
  p.ev_st = ev_st; p.ev_sn = ev_sn; p.ev_sr = ev_sr;
  p.ea_st = ea_st; p.ea_sn = ea_sn; p.ea_sr = ea_sr;
  p.max_events = max_events;
  p.k_cap = k_cap;
  const int G = max(1, (R + 31) / 32);
  p.tc = min(min(UNITS / G, TC_MAX), T);
  const int tile = tile_bytes(R) <= MAX_STAGED_TILE ? tile_bytes(R) : 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (flag != nullptr) {     // gated: the steps split over blocks
    const int smem = tile + (int)sizeof(Chunk);
    return tile ? launch(gated_kernel<true>, p, p.tc, smem, s)
                : launch(gated_kernel<false>, p, p.tc, smem, s);
  }
  const int smem = tile + 2 * (int)sizeof(Chunk) + TC_MAX * (int)sizeof(int);
  return tile ? launch(ordered_kernel<true>, p, T, smem, s)
              : launch(ordered_kernel<false>, p, T, smem, s);
}

// The record form. rows / addr int32, eff float32 [N, T, K] with each
// instance's [T, K] block contiguous (instance stride rec_sn); w / st int8
// [N, R, C]; out float32 through (n, t) strides; flag int32 or null.
extern "C" int synray_sparse_launch(
    const void* rows, const void* addr, const void* eff, const void* w,
    const void* st, void* out, const void* flag, int N, int T, int K, int R,
    int C, long long rec_sn, long long w_sn, long long w_sr, long long a_sn,
    long long a_sr, long long o_sn, long long o_st, void* stream) {
  if (N == 0 || T == 0 || C == 0) return 0;
  Args p = stores(w, st, out, flag, N, T, R, C, w_sn, w_sr, a_sn, a_sr,
                  o_sn, o_st);
  p.rows = (const int*)rows;
  p.raddr = (const int*)addr;
  p.reff = (const float*)eff;
  p.rec_sn = rec_sn;
  p.K = K;
  const int recs = 3 * TR * KB * 4;
  const bool staged = tile_bytes(R) <= MAX_STAGED_TILE;
  const cudaStream_t s = (cudaStream_t)stream;
  return staged ? launch(record_kernel<true>, p, TR, tile_bytes(R) + recs, s)
                : launch(record_kernel<false>, p, TR, recs, s);
}
