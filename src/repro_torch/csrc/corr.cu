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
// + 4.2 MB): about 40 MB, 12 us at 3.35 TB/s. The operations the data
// needs are spike-driven: a post spike at (t, c) updates column c of a_c
// and a pre spike at (t, r) row r of a_a (a multiply, an add and a min
// each), 3 * (n_post * R + n_pre * C) in all: at 5% density about 80M,
// 1.2 us at 67 TFLOP/s. So the bytes bound it.
//
// Design: one block of 16 warps per (instance, 128 x 128 tile), both
// accumulators of the tile in registers for the whole window (32 of each
// a thread), each read and written once: a_a straight from global memory
// (lanes over columns, coalesced), a_c through a swizzled tile in shared
// memory (its register layout has lanes over rows). The block's spike
// windows come in 32-step chunks through a three-slot cp.async ring; the
// trace scans of a chunk (one thread a row or column, from shared memory)
// also record, per row and per column, a bit mask of the chunk's steps
// with a non-zero spike. The accumulators are updated only at those
// steps, in a layout that keeps the skip warp-uniform: for a_c each warp
// owns 8 columns and its lanes run over rows, so post[t, c] is the same
// for the whole warp; for a_a each warp owns 8 rows and its lanes run over
// columns, so pre[t, r] is. A warp walks a mask's set bits in ascending
// step order. One barrier a chunk: after it, the trace owners scan chunk
// k + 1 into a second trace slot while every warp updates from chunk k.
// The tile is 128 x 128 because each block stages the spike windows of
// its rows and columns: a larger tile stages fewer bytes per accumulator
// (the staging, not the arithmetic, is the cost after the accumulators'
// own traffic).
//
// Why the skip is exact (bit-equal to the per-step plain version on
// finite inputs). With q == 0 (+0 or -0) and a finite trace, tp * q is
// +0 or -0; ac + (+-0) == ac unless ac is -0 (-0 + +0 = +0); and
// min(ac, sat) == ac once ac <= sat. The same holds for a_a with p == 0.
// So:
//  - step 0 of the window runs in full for every element: that clamps an
//    initial accumulator above sat as the plain version does;
//  - after it, a warp in which any accumulator is -0 runs the full update
//    at every step (a -0 stays -0 only while -0 is added; once it is not
//    -0 no sum of this window makes it -0 again, since x + -x is +0);
//  - with sat not > 0 every warp runs the full update at every step;
//  - a non-zero spike of any value or sign (non-binary, negative) always
//    takes the full update; -0 spikes count as zero;
//  - traces that start or turn negative change nothing above: only the
//    spike decides.
// Built with -fmad=false so that the multiply and the add round
// separately, as PyTorch's eager ops do.
#include <cuda_runtime.h>

namespace {

constexpr int NW = 16;             // warps per block
constexpr int NT = 32 * NW;        // threads per block
constexpr int RB = 128;            // rows per block
constexpr int CB = 128;            // columns per block
constexpr int TC = 32;             // steps per chunk (bits of a mask)
constexpr int L = 4;               // accumulators of one row/column a lane
constexpr int PW = 8;              // columns (a_c) or rows (a_a) a warp
constexpr int G = CB / 4;          // 16-byte granules of a tile row

struct Stage {                     // one slot of the cp.async ring
  float p[TC][RB];                 // pre spikes of the block's rows
  float q[TC][CB];                 // post spikes of the block's columns
};

struct Traces {
  float tp[TC][RB];                // row traces of a chunk
  float tq[TC][CB];                // column traces of a chunk
};

// a three-slot ring of spike chunks; two slots of traces and masks (the
// chunk being used and the next one, scanned meanwhile), which also hold
// the a_c tile while it moves between global memory and registers
// (162 KB: one block of 512 threads an SM)
struct Smem {
  Stage st[3];
  union {
    Traces tr[2];
    float tile[RB * CB];           // a_c tile, granules XOR-swizzled by row
  } u;
  unsigned mp[2][RB];              // chunk steps with pre != 0, per row
  unsigned mq[2][CB];              // chunk steps with post != 0, per column
};

// a_c tile: granule g (4 floats) of row r
__device__ __forceinline__ float* granule(Smem& s, int r, int g) {
  return &s.u.tile[r * CB + ((g ^ (r & 7)) * 4)];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
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
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ bool is_neg_zero(float x) {
  return __float_as_uint(x) == 0x80000000u;
}

struct Args {
  const float *pre, *post, *tp0, *tq0, *ac0, *aa0;
  float *ac_out, *aa_out, *tp_out, *tq_out;
  int N, T, R, C;
  float lam, sat;
  bool vec_r, vec_c;   // rows of R / of C floats start 16-byte aligned
};

// Copy the 4 floats of `src` of which the first `valid` exist (zeros past
// them) to shared memory, 16 bytes at once where it can.
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      int valid, bool vec) {
  if (vec && valid >= 4) {
    cp_async16(dst, src);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < valid) cp_async4(dst + i, src + i);
    else dst[i] = 0.0f;
  }
}

// Issue the copies of chunk kc (steps [kc TC, kc TC + TC)) of the block's
// spike windows; steps past T, rows past R and columns past C are zeros.
__device__ void load_chunk(Stage& st, const Args& a, int n, int r0, int c0,
                           int kc, int tid) {
  for (int k = tid; k < TC * (RB / 4); k += NT) {
    const int j = k / (RB / 4), g = k % (RB / 4), t = kc * TC + j;
    const int valid = t < a.T ? a.R - r0 - 4 * g : 0;
    copy4(&st.p[j][4 * g], a.pre + ((long long)t * a.N + n) * a.R + r0 + 4 * g,
          valid, a.vec_r);
  }
  for (int k = tid; k < TC * (CB / 4); k += NT) {
    const int j = k / (CB / 4), g = k % (CB / 4), t = kc * TC + j;
    const int valid = t < a.T ? a.C - c0 - 4 * g : 0;
    copy4(&st.q[j][4 * g], a.post + ((long long)t * a.N + n) * a.C + c0 + 4 * g,
          valid, a.vec_c);
  }
}

// The chunk's trace scan of one row or column (x -> trace into tr_out),
// and the mask of its non-zero spikes.
__device__ __forceinline__ unsigned scan(const float* x, float* tr_out,
                                         int stride, int tn, float& tr,
                                         float lam) {
  unsigned m = 0;
  if (tn == TC) {
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const float v = x[j * stride];
      tr = tr * lam + v;
      tr_out[j * stride] = tr;
      m |= (v != 0.0f ? 1u : 0u) << j;
    }
  } else {
    for (int j = 0; j < tn; ++j) {
      const float v = x[j * stride];
      tr = tr * lam + v;
      tr_out[j * stride] = tr;
      m |= (v != 0.0f ? 1u : 0u) << j;
    }
  }
  return m;
}

// One block: the RB x CB tile of both accumulators of instance n.
// a_c: lanes over rows (lane + 32 k), warp w owns columns PW w .. + PW-1,
//      so post[t, c] (the skip) is the same for the whole warp;
// a_a: lanes over columns (lane + 32 k), warp w owns rows PW w .. + PW-1,
//      so pre[t, r] is.
__global__ void __launch_bounds__(NT, 1) corr_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int n = blockIdx.z;
  const int r0 = blockIdx.y * RB, c0 = blockIdx.x * CB;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const long long base = (long long)n * a.R * a.C;
  const int nk = (a.T + TC - 1) / TC;

  // group 0: the a_c tile (coalesced: a warp per row) and chunk 0;
  // group 1: chunk 1
  for (int k = tid; k < RB * G; k += NT) {
    const int i = k / G, g = k % G, r = r0 + i;
    copy4(granule(s, i, g), a.ac0 + base + (long long)r * a.C + c0 + 4 * g,
          r < a.R ? a.C - c0 - 4 * g : 0, a.vec_c);
  }
  if (nk > 0) load_chunk(s.st[0], a, n, r0, c0, 0, tid);
  cp_async_commit();
  if (nk > 1) load_chunk(s.st[1], a, n, r0, c0, 1, tid);
  cp_async_commit();

  float aa[PW][L];
#pragma unroll
  for (int rr = 0; rr < PW; ++rr) {
    const int r = r0 + PW * w + rr;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int c = c0 + lane + 32 * k;
      aa[rr][k] = r < a.R && c < a.C ? a.aa0[base + (long long)r * a.C + c]
                                     : 0.0f;
    }
  }
  // trace owners: threads [0, RB) own a row, [RB, RB + CB) a column
  const bool row_owner = tid < RB, col_owner = tid >= RB && tid < RB + CB;
  float tr = 0.0f;
  if (row_owner && r0 + tid < a.R) tr = a.tp0[(long long)n * a.R + r0 + tid];
  if (col_owner && c0 + tid - RB < a.C)
    tr = a.tq0[(long long)n * a.C + c0 + tid - RB];
  // the trace scan of chunk k into trace slot k % 2
  auto scan_chunk = [&](int k) {
    const int tn = min(TC, a.T - k * TC);
    const Stage& st = s.st[k % 3];
    Traces& t = s.u.tr[k & 1];
    if (row_owner)
      s.mp[k & 1][tid] = scan(&st.p[0][tid], &t.tp[0][tid], RB, tn, tr,
                              a.lam);
    else if (col_owner)
      s.mq[k & 1][tid - RB] = scan(&st.q[0][tid - RB], &t.tq[0][tid - RB],
                                   CB, tn, tr, a.lam);
  };

  cp_async_wait<1>();
  __syncthreads();
  float ac[PW][L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int r = lane + 32 * k;
#pragma unroll
    for (int h = 0; h < PW / 4; ++h) {
      const float4 x = *reinterpret_cast<const float4*>(
          granule(s, r, PW / 4 * w + h));
      ac[4 * h][k] = x.x; ac[4 * h + 1][k] = x.y;
      ac[4 * h + 2][k] = x.z; ac[4 * h + 3][k] = x.w;
    }
  }
  __syncthreads();   // the tile's space becomes the trace slots
  if (nk > 2) load_chunk(s.st[2], a, n, r0, c0, 2, tid);
  cp_async_commit();
  if (nk > 0) scan_chunk(0);

  // Iteration kc: one barrier, after which chunk kc's traces and masks are
  // complete and chunk kc + 1 has landed; then the trace owners scan chunk
  // kc + 1 into the other slot while every warp updates from chunk kc.
  bool force_c = !(a.sat > 0.0f), force_a = force_c;
  for (int kc = 0; kc < nk; ++kc) {
    const int tn = min(TC, a.T - kc * TC);
    cp_async_wait<0>();
    __syncthreads();
    // chunk kc + 2 into the slot chunk kc - 1 used (its readers are done);
    // it has this iteration's updates to land in
    if (kc > 0 && kc + 2 < nk)
      load_chunk(s.st[(kc + 2) % 3], a, n, r0, c0, kc + 2, tid);
    cp_async_commit();
    if (kc + 1 < nk) scan_chunk(kc + 1);
    const Stage& st = s.st[kc % 3];
    const float(*tp)[RB] = s.u.tr[kc & 1].tp;
    const float(*tq)[CB] = s.u.tr[kc & 1].tq;
    const unsigned* mq = s.mq[kc & 1];
    const unsigned* mp = s.mp[kc & 1];

    unsigned done = 0;
    if (kc == 0) {     // step 0 in full for every element
      bool neg_c = false, neg_a = false;
#pragma unroll
      for (int i = 0; i < PW; ++i) {
        const float qv = st.q[0][PW * w + i];
        const float pv = st.p[0][PW * w + i];
#pragma unroll
        for (int k = 0; k < L; ++k) {
          ac[i][k] = fminf(ac[i][k] + tp[0][lane + 32 * k] * qv, a.sat);
          aa[i][k] = fminf(aa[i][k] + pv * tq[0][lane + 32 * k], a.sat);
          neg_c |= is_neg_zero(ac[i][k]);
          neg_a |= is_neg_zero(aa[i][k]);
        }
      }
      force_c |= __any_sync(0xffffffffu, neg_c);
      force_a |= __any_sync(0xffffffffu, neg_a);
      done = 1u;
    }
    const unsigned all = tn == 32 ? 0xffffffffu : (1u << tn) - 1u;
#pragma unroll
    for (int i = 0; i < PW; ++i) {
      unsigned m = (force_c ? all : mq[PW * w + i]) & ~done;
      while (m) {                      // uniform across the warp
        const int j = __ffs(m) - 1;
        m &= m - 1;
        const float qv = st.q[j][PW * w + i];
#pragma unroll
        for (int k = 0; k < L; ++k)
          ac[i][k] = fminf(ac[i][k] + tp[j][lane + 32 * k] * qv, a.sat);
      }
      m = (force_a ? all : mp[PW * w + i]) & ~done;
      while (m) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        const float pv = st.p[j][PW * w + i];
#pragma unroll
        for (int k = 0; k < L; ++k)
          aa[i][k] = fminf(aa[i][k] + pv * tq[j][lane + 32 * k], a.sat);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < PW; ++rr) {
    const int r = r0 + PW * w + rr;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int c = c0 + lane + 32 * k;
      if (r < a.R && c < a.C) a.aa_out[base + (long long)r * a.C + c] = aa[rr][k];
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the trace slots become the a_c tile
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int r = lane + 32 * k;
#pragma unroll
    for (int h = 0; h < PW / 4; ++h)
      *reinterpret_cast<float4*>(granule(s, r, PW / 4 * w + h)) =
          make_float4(ac[4 * h][k], ac[4 * h + 1][k], ac[4 * h + 2][k],
                      ac[4 * h + 3][k]);
  }
  __syncthreads();
  for (int k = tid; k < RB * G; k += NT) {
    const int i = k / G, g = k % G, r = r0 + i, c = c0 + 4 * g;
    if (r >= a.R || c >= a.C) continue;
    float* dst = a.ac_out + base + (long long)r * a.C + c;
    const float* src = granule(s, i, g);
    if (a.vec_c && c + 4 <= a.C) {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
      for (int x = 0; x < 4 && c + x < a.C; ++x) dst[x] = src[x];
    }
  }
  // final traces: the first column block writes the rows, the first row
  // block the columns
  if (row_owner && blockIdx.x == 0 && r0 + tid < a.R)
    a.tp_out[(long long)n * a.R + r0 + tid] = tr;
  if (col_owner && blockIdx.y == 0 && c0 + tid - RB < a.C)
    a.tq_out[(long long)n * a.C + c0 + tid - RB] = tr;
}

bool aligned16(const void* p) {
  return ((unsigned long long)p & 15) == 0;
}

}  // namespace

extern "C" int corr_launch(const void* pre, const void* post, const void* tp0,
                           const void* tq0, const void* ac0, const void* aa0,
                           void* ac, void* aa, void* tp, void* tq, int N,
                           int T, int R, int C, float lam, float sat,
                           void* stream) {
  if (N == 0 || R == 0 || C == 0) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (e != cudaSuccess) return (int)e;
  Args a{(const float*)pre, (const float*)post, (const float*)tp0,
         (const float*)tq0, (const float*)ac0, (const float*)aa0,
         (float*)ac, (float*)aa, (float*)tp, (float*)tq, N, T, R, C, lam,
         sat, false, false};
  a.vec_r = R % 4 == 0 && aligned16(pre);
  a.vec_c = C % 4 == 0 && aligned16(post) && aligned16(ac0) &&
            aligned16(ac);
  dim3 grid((C + CB - 1) / CB, (R + RB - 1) / RB, N);
  corr_kernel<<<grid, NT, sizeof(Smem), (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
