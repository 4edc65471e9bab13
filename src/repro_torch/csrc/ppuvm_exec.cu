// ppuvm_exec: the PPU-VM tile executor on Hopper, the whole program per
// lane (synapse), the register file in registers.
//
// Replaces the TPU kernel repro/kernels/ppuvm_exec/kernel.py,
// run_program_pallas (_kernel), which ran a fori_loop over the words with
// a lax.switch over the 19 opcodes per [rb, cb] VMEM tile, the [8, rb, cb]
// register file held on-chip for the whole program.
//
// Bound on the H100: per lane, the weight (1 byte as int8, 4 as int32),
// qc, qa and the noise plane (4 bytes each) in, 4 bytes of weight and 32
// bytes of registers out; the column operands are [N, C] rows. At the main
// path's [16, 256, 512] with int8 weights and no noise (path C) that is
// about 94 MB, 28 us at 3.35 TB/s; the integer work (a few operations per
// word and lane) is below it. So the bytes bound it.
//
// Design: every word is the same for all lanes, so everything that
// depends on the word alone is done once:
//   * each block decodes the words into shared memory once (opcode with
//     unknown ones made NOP, the three register fields mod 8, which
//     operands the word reads, and one payload: SPLAT's immediate, the
//     clamped shift of MULF / SHL / SHR, LDMOD's clamped slot). A program
//     longer than MAX_WORDS words (48 KB decoded) is decoded and run
//     MAX_WORDS words at a time on each tile instead, each chunk's decode
//     between two block barriers, the register file staying in registers
//     across the chunks (every thread of a block walks the same tiles, so
//     every thread reaches each barrier; a tile's operands live in
//     registers, so no decode overwrites them);
//   * a thread runs K consecutive columns of one row (K lanes) through the
//     program, so each word's dispatch is paid once for K lanes;
//   * the register file is 8 x K named registers: a word's register
//     indices are uniform across the block, so operands are read and the
//     result written through a 3-level tree on the index's bits (every
//     leaf a fixed register), never a dynamically indexed array, and the
//     file never goes to local memory (-Xptxas -v: no stack frame). ptxas
//     keeps the top level a uniform branch and turns the two lower ones
//     into predicated selects: 2 a lane per access, where a select chain
//     over all 8 registers takes 7, and without the register copies that
//     a switch on the index drew from it.
// A tile is TY rows x TX * K columns of one instance. As many blocks as
// fit on the card at once walk the tiles with a stride of the grid, and
// each thread reads its next tile's operands before it runs the program
// on the current one, so a tile's loads overlap the last tile's program
// (one block per tile would load, compute and store in lockstep, leaving
// the memory idle while it computes). A lane's instance and column come
// from its tile, with two 32-bit divisions per tile and thread, not per
// lane. Rows whose length is a multiple of K, with 16-byte aligned planes,
// load and store 16 bytes (int8 weights 4) a thread; other shapes take
// the same program with one scalar access per lane and the ragged columns
// masked. qc, qa, the noise and the weight are read once per lane, the
// rate counters (converted to Q8.8 here: rates_to_fixed) and the
// modulator slots when a word loads them.
//
// Semantics: bit for bit those of the reference's make_semantics
// (repro/ppuvm/interp.py:96-150) and of the plain version (ref.py).
//   * rd, ra, rb are 5-bit fields taken mod 8; SEL reads rd before
//     writing it; opcodes >= 19 run as NOP.
//   * LDMOD's slot is clip(simm & 0xFF, 0, n_mod - 1); STW's value is the
//     live weight a later LDW reads.
//   * Shift amounts clamp: MULF min(sh, 16), SHL min(sh, 15), SHR
//     min(sh, 31).
//   * Two's-complement wrap as XLA, numpy and PyTorch wrap: sums, products
//     and left shifts are done in unsigned and cast back (signed overflow
//     and a left shift of a negative int are undefined in C++); right
//     shifts of an int are arithmetic.
//   * ADD, SUB, MULF, SHL saturate to [-32768, 32767]; STW stores
//     clip((a + 128) >> 8, 0, 63).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K = 4;             // lanes (consecutive columns) a thread
static_assert(K % 4 == 0, "16-byte accesses take 4 lanes each");
constexpr int TX = 32;           // threads across a block's columns
constexpr int TY = 4;            // rows a block
constexpr int THREADS = TX * TY;
constexpr int N_REGS = 8;
constexpr int WMAX = 63;
constexpr int MAX_WORDS = 12288;  // words decoded at a time: 48 KB

enum Op {
  NOP = 0, SPLAT = 1, MOV = 2, ADD = 3, SUB = 4, MULF = 5, SHL = 6, SHR = 7,
  CMPGE = 8, SEL = 9, MAXS = 10, MINS = 11, LDW = 12, STW = 13,
  LDCAUSAL = 14, LDACAUSAL = 15, LDRATE = 16, LDMOD = 17, LDNOISE = 18
};

// a decoded word: op | rd << 5 | ra << 8 | rb << 11 | READS_A | READS_B
// | payload << 16
constexpr int READS_A = 1 << 14;
constexpr int READS_B = 1 << 15;

__device__ __forceinline__ int decode(unsigned word, int n_mod) {
  int op = (word >> 26) & 0x3F;
  if (op > LDNOISE) op = NOP;
  const int rd = (word >> 21) & 0x7;           // 5-bit fields mod 8
  const int ra = (word >> 16) & 0x7;
  const int imm = word & 0xFFFF;
  const int rb = (imm >> 8) & 0x7;
  const int sh = imm & 0xFF;
  int payload = 0, reads = 0;
  switch (op) {
    case SPLAT: payload = (int)(int16_t)(uint16_t)imm; break;
    case MOV: case STW: reads = READS_A; break;
    case ADD: case SUB: case CMPGE: case SEL: case MAXS: case MINS:
      reads = READS_A | READS_B; break;
    case MULF: payload = min(sh, 16); reads = READS_A | READS_B; break;
    case SHL: payload = min(sh, 15); reads = READS_A; break;
    case SHR: payload = min(sh, 31); reads = READS_A; break;
    case LDMOD: payload = min(sh, n_mod - 1); break;  // simm & 0xFF == sh
    default: break;
  }
  return op | rd << 5 | ra << 8 | rb << 11 | reads
         | (int)((unsigned)payload << 16);
}

__device__ __forceinline__ int sat16(int x) {
  return min(max(x, -32768), 32767);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// the VM's register file of K lanes; only ever indexed by constants
struct RegFile {
  int r[N_REGS][K];
};

// get / set: a balanced tree on the index's three bits, each leaf a fixed
// register
#define VM_PICK(I)                                                      \
  {                                                                     \
    _Pragma("unroll") for (int k = 0; k < K; ++k) dst[k] = f.r[I][k];   \
  }
#define VM_PUT(I)                                                       \
  {                                                                     \
    _Pragma("unroll") for (int k = 0; k < K; ++k) f.r[I][k] = src[k];   \
  }

__device__ __forceinline__ void get(const RegFile& f, int i, int (&dst)[K]) {
  if (i & 4) {
    if (i & 2) { if (i & 1) VM_PICK(7) else VM_PICK(6) }
    else { if (i & 1) VM_PICK(5) else VM_PICK(4) }
  } else {
    if (i & 2) { if (i & 1) VM_PICK(3) else VM_PICK(2) }
    else { if (i & 1) VM_PICK(1) else VM_PICK(0) }
  }
}

__device__ __forceinline__ void set(RegFile& f, int i, const int (&src)[K]) {
  if (i & 4) {
    if (i & 2) { if (i & 1) VM_PUT(7) else VM_PUT(6) }
    else { if (i & 1) VM_PUT(5) else VM_PUT(4) }
  } else {
    if (i & 2) { if (i & 1) VM_PUT(3) else VM_PUT(2) }
    else { if (i & 1) VM_PUT(1) else VM_PUT(0) }
  }
}

// K lanes of a plane at x (VEC: 16-byte accesses, 4 bytes for int8)
template <bool VEC>
__device__ __forceinline__ void load(const int* __restrict__ x, int nk,
                                     int (&v)[K]) {
  if (VEC) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const int4 q = *reinterpret_cast<const int4*>(x + k);
      v[k] = q.x; v[k + 1] = q.y; v[k + 2] = q.z; v[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = k < nk ? x[k] : 0;
  }
}

template <bool VEC>
__device__ __forceinline__ void load(const int8_t* __restrict__ x, int nk,
                                     int (&v)[K]) {
  if (VEC) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const char4 q = *reinterpret_cast<const char4*>(x + k);
      v[k] = q.x; v[k + 1] = q.y; v[k + 2] = q.z; v[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = k < nk ? (int)x[k] : 0;
  }
}

// K lanes of an output plane, streamed (evict-first: no lane is read again
// here, and the 75 MB of outputs would only push the inputs out of L2)
template <bool VEC>
__device__ __forceinline__ void store(int* __restrict__ x, int nk,
                                      const int (&v)[K]) {
  if (VEC) {
#pragma unroll
    for (int k = 0; k < K; k += 4)
      __stcs(reinterpret_cast<int4*>(x + k),
             make_int4(v[k], v[k + 1], v[k + 2], v[k + 3]));
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < nk) __stcs(x + k, v[k]);
  }
}

// A tile's per-lane operands (K lanes of one row), read a tile ahead.
struct Lanes {
  int w[K], qc[K], qa[K], nz[K];
};

template <bool VEC, typename WT>
__device__ __forceinline__ void load_lanes(Lanes& L, const WT* __restrict__ w,
                                           const int* __restrict__ qc,
                                           const int* __restrict__ qa,
                                           const int* __restrict__ noise,
                                           long long i, int nk) {
  load<VEC>(w + i, nk, L.w);
  load<VEC>(qc + i, nk, L.qc);
  load<VEC>(qa + i, nk, L.qa);
  if (noise) {
    load<VEC>(noise + i, nk, L.nz);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) L.nz[k] = 0;
  }
}

// LDRATE's operand: rates_to_fixed of K columns' rate counters, rounded
// half to even, converted as PyTorch's CUDA conversion does (saturating),
// shifted with wrap and saturated to int16
template <bool VEC>
__device__ __forceinline__ void load_rates(const float* __restrict__ x,
                                           int nk, int (&v)[K]) {
  float f[K];
  if (VEC) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(x + k);
      f[k] = q.x; f[k + 1] = q.y; f[k + 2] = q.z; f[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) f[k] = k < nk ? x[k] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    v[k] = sat16((int)((unsigned)__float2int_rz(rintf(f[k])) << 8));
}

// this thread's lanes of a tile: the first lane, its column, how many
struct Place {
  long long i, nc;
  int nk;
  bool live;
};

// Words [0, n) of the decoded program on this thread's K lanes.
template <bool VEC>
__device__ __forceinline__ void run_words(const int* s_dec, int n,
                                          RegFile& f, int (&wm)[K],
                                          const Lanes& L, const Place& at,
                                          const float* __restrict__ rates,
                                          const int* __restrict__ mod,
                                          long long NC) {
  for (int p = 0; p < n; ++p) {
    const int d = s_dec[p];
    const int payload = d >> 16;
    int a[K], b[K], v[K];
    if (d & READS_A) get(f, (d >> 8) & 0x7, a);
    if (d & READS_B) get(f, (d >> 11) & 0x7, b);
    // the word's result in v, written to rd at the one place below
    switch (d & 0x1F) {
      case SPLAT:
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = payload;
        break;
      case MOV:
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = a[k];
        break;
      case ADD:
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = sat16(wrap_add(a[k], b[k]));
        break;
      case SUB:
#pragma unroll
        for (int k = 0; k < K; ++k)
          v[k] = sat16((int)((unsigned)a[k] - (unsigned)b[k]));
        break;
      case MULF: {
        const unsigned half = (1u << payload) >> 1;
#pragma unroll
        for (int k = 0; k < K; ++k)
          v[k] = sat16((int)((unsigned)a[k] * (unsigned)b[k] + half)
                       >> payload);
        break;
      }
      case SHL:
#pragma unroll
        for (int k = 0; k < K; ++k)
          v[k] = sat16((int)((unsigned)a[k] << payload));
        break;
      case SHR:
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = a[k] >> payload;
        break;
      case CMPGE:
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = a[k] >= b[k] ? 256 : 0;
        break;
      case SEL: {
        int dd[K];
        get(f, (d >> 5) & 0x7, dd);
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = dd[k] != 0 ? a[k] : b[k];
        break;
      }
      case MAXS:
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = max(a[k], b[k]);
        break;
      case MINS:
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = min(a[k], b[k]);
        break;
      case LDW:
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = (int)((unsigned)wm[k] << 8);
        break;
      case LDCAUSAL:
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = L.qc[k];
        break;
      case LDACAUSAL:
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = L.qa[k];
        break;
      case LDRATE:
        load_rates<VEC>(rates + at.nc, at.nk, v);
        break;
      case LDMOD:
        if (mod) {
          load<VEC>(mod + payload * NC + at.nc, at.nk, v);
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) v[k] = 0;
        }
        break;
      case LDNOISE:
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = L.nz[k];
        break;
      case STW:
#pragma unroll
        for (int k = 0; k < K; ++k)
          wm[k] = min(max(wrap_add(a[k], 128) >> 8, 0), WMAX);
        continue;                            // writes no register
      default:
        continue;                            // NOP, unknown opcodes
    }
    set(f, (d >> 5) & 0x7, v);
  }}

__device__ __forceinline__ void start_lanes(RegFile& f, int (&wm)[K],
                                          const Lanes& L) {
#pragma unroll
for (int k = 0; k < K; ++k) wm[k] = L.w[k];
#pragma unroll
for (int j = 0; j < N_REGS; ++j)
#pragma unroll
  for (int k = 0; k < K; ++k) f.r[j][k] = 0;
}

template <bool VEC>
__device__ __forceinline__ void store_lanes(const RegFile& f,
                                            const int (&wm)[K],
                                            const Place& at,
                                            int* __restrict__ w_out,
                                            int* __restrict__ regs_out,
                                            long long total) {
  store<VEC>(w_out + at.i, at.nk, wm);
#pragma unroll
  for (int j = 0; j < N_REGS; ++j)
    store<VEC>(regs_out + j * total + at.i, at.nk, f.r[j]);
}

// Persistent blocks walk the tiles (an instance, TY rows, TX * K columns)
// with a stride of the grid; each thread reads its next tile's operands
// before it runs the program on the current one, so the loads of one
// tile overlap the program of the last. CHUNKED: the program is longer
// than MAX_WORDS words and is decoded a chunk at a time on every tile
// (no read-ahead there; the launcher takes the scalar lanes for it).
template <bool VEC, bool CHUNKED, typename WT>
__global__ void __launch_bounds__(THREADS)
ppuvm_exec_kernel(const int* __restrict__ words, int n_words,
                  const WT* __restrict__ w, const int* __restrict__ qc,
                  const int* __restrict__ qa,
                  const float* __restrict__ rates,
                  const int* __restrict__ mod, int n_mod,
                  const int* __restrict__ noise, int* __restrict__ w_out,
                  int* __restrict__ regs_out, int N, int R, int C) {
  extern __shared__ int s_dec[];
  const int tid = threadIdx.y * TX + threadIdx.x;
  if (!CHUNKED) {
    for (int p = tid; p < n_words; p += THREADS)
      s_dec[p] = decode((unsigned)words[p], n_mod);
    __syncthreads();
  }

  const int tiles_x = (C + TX * K - 1) / (TX * K);
  const int tiles_y = (R + TY - 1) / TY;
  const int n_tiles = N * tiles_y * tiles_x;     // fits: the launcher checks
  const long long total = (long long)N * R * C;
  const long long NC = (long long)N * C;

  // this thread's lanes of tile t
  const auto place = [&](int t) {
    Place q{0, 0, 0, false};
    if (t >= n_tiles) return q;
    const int rest = t / tiles_x;
    const int c0 = ((t - rest * tiles_x) * TX + threadIdx.x) * K;
    const int n = rest / tiles_y;
    const int row = (rest - n * tiles_y) * TY + threadIdx.y;
    if (row >= R || c0 >= C) return q;
    q.i = ((long long)n * R + row) * C + c0;
    q.nc = (long long)n * C + c0;
    q.nk = min(K, C - c0);
    q.live = true;
    return q;
  };

  if (CHUNKED) {
    // each tile's operands read as it starts (a program this long
    // outlasts any read-ahead; the registers are the file's), then the
    // program a chunk at a time; every thread reaches the barriers, live
    // lanes or not
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const Place at = place(t);
      Lanes L{};
      if (at.live) load_lanes<VEC>(L, w, qc, qa, noise, at.i, at.nk);
      int wm[K];
      RegFile f;
      start_lanes(f, wm, L);
      for (int p0 = 0; p0 < n_words; p0 += MAX_WORDS) {
        const int pn = min(MAX_WORDS, n_words - p0);
        __syncthreads();   // every thread is done with the last chunk
        // one word at a time: the file and the tile's operands are live
#pragma unroll 1
        for (int p = tid; p < pn; p += THREADS)
          s_dec[p] = decode((unsigned)words[p0 + p], n_mod);
        __syncthreads();
        if (at.live) run_words<VEC>(s_dec, pn, f, wm, L, at, rates, mod, NC);
      }
      if (at.live) store_lanes<VEC>(f, wm, at, w_out, regs_out, total);
    }
    return;
  }
  Place at = place(blockIdx.x);
  Lanes L{};
  if (at.live) load_lanes<VEC>(L, w, qc, qa, noise, at.i, at.nk);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Place next = place(t + gridDim.x);
    Lanes L_next{};
    if (next.live) load_lanes<VEC>(L_next, w, qc, qa, noise, next.i,
                                   next.nk);
    if (at.live) {
      int wm[K];
      RegFile f;
      start_lanes(f, wm, L);
      run_words<VEC>(s_dec, n_words, f, wm, L, at, rates, mod, NC);
      store_lanes<VEC>(f, wm, at, w_out, regs_out, total);
    }
    at = next;
    L = L_next;
  }
}

// the launch's operands, as ppuvm_exec_launch takes them
struct Operands {
  const void *words;
  int n_words;
  const void *w, *qc, *qa, *rates, *mod;
  int n_mod;
  const void* noise;
  void *w_out, *regs;
  int N, R, C;
};

template <bool VEC, bool CHUNKED, typename WT>
int launch(const Operands& o, cudaStream_t stream) {
  const long long tiles = (long long)o.N * ((o.R + TY - 1) / TY)
                          * ((o.C + TX * K - 1) / (TX * K));
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  // as many blocks as fit on the card at once, each walking its tiles
  const size_t smem = (size_t)min(o.n_words, MAX_WORDS) * sizeof(int);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ppuvm_exec_kernel<VEC, CHUNKED, WT>, THREADS, smem);
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(tiles < fit ? tiles : fit);
  ppuvm_exec_kernel<VEC, CHUNKED, WT><<<blocks, dim3(TX, TY), smem,
                                        stream>>>(
      (const int*)o.words, o.n_words, (const WT*)o.w, (const int*)o.qc,
      (const int*)o.qa, (const float*)o.rates, (const int*)o.mod, o.n_mod,
      (const int*)o.noise, (int*)o.w_out, (int*)o.regs, o.N, o.R, o.C);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, unsigned bytes) {
  return ((uintptr_t)p % bytes) == 0;
}

}  // namespace

// words int32 [P]; w int8 or int32 [N, R, C]
// (w_bytes 1 or 4); qc, qa, noise int32 [N, R, C] (noise may be null: a
// zero plane); rates float32 [N, C] (the rate counters); mod int32
// [n_mod, N, C] (null: one zero slot); w_out int32 [N, R, C]; regs int32
// [8, N, R, C].
extern "C" int ppuvm_exec_launch(const void* words, int n_words,
                                 const void* w, int w_bytes, const void* qc,
                                 const void* qa, const void* rates,
                                 const void* mod, int n_mod,
                                 const void* noise, void* w_out, void* regs,
                                 int N, int R, int C, void* stream) {
  if ((long long)N * R * C == 0) return 0;
  if (n_words < 0 || (w_bytes != 1 && w_bytes != 4))
    return (int)cudaErrorInvalidValue;
  if (n_mod < 1) n_mod = 1;
  const bool vec = C % K == 0 && aligned(w, 4 * w_bytes) && aligned(qc, 16)
                   && aligned(qa, 16) && aligned(rates, 16)
                   && aligned(mod, 16) && aligned(noise, 16)
                   && aligned(w_out, 16) && aligned(regs, 16);
  const Operands o{words, n_words, w, qc, qa, rates, mod, n_mod, noise,
                   w_out, regs, N, R, C};
  // the instantiation: scalar or 16-byte lanes, or a chunked program
  // (longer than MAX_WORDS words: its lanes are read one at a time, its
  // time is the words'), then int32 or int8 weights
  int (*const form[6])(const Operands&, cudaStream_t) = {
      launch<false, false, int>, launch<false, false, int8_t>,
      launch<true, false, int>,  launch<true, false, int8_t>,
      launch<false, true, int>,  launch<false, true, int8_t>};
  const int i = n_words > MAX_WORDS ? 4 : 2 * vec;
  return form[i + (w_bytes == 1)](o, (cudaStream_t)stream);
}
