// ppuvm_exec: the PPU-VM tile executor on Hopper, the whole program per
// lane (synapse).
//
// Replaces the TPU kernel repro/kernels/ppuvm_exec/kernel.py,
// run_program_pallas (_kernel), which ran a fori_loop over the words with
// a lax.switch over the 19 opcodes per [rb, cb] VMEM tile, the [8, rb, cb]
// register file held on-chip for the whole program.
//
// Design: one thread per lane; the lane is a flat index over N * R * C
// (columns fastest) and a grid-stride loop walks the lanes. Each block
// copies the words into shared memory once; every thread of a warp then
// runs the same word, so the opcode switch never diverges. A thread keeps
// its register file (int r[8]) and its live weight in registers (the
// dynamic register index may put r[] in local memory: the -Xptxas -v line
// of the build reports it as a stack frame). qc, qa and noise are read
// once per lane, the rate and the modulator slots of its column when a
// word loads them. The weights and the [8, N * R * C] register file are
// written with coalesced stores.
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
//
// Bound on the H100: per lane, 16 bytes in (int32 weight, qc, qa, noise),
// 4 bytes of weight and 32 bytes of registers out; the column operands
// are [N, C] rows. At the main path's [16, 256, 512] that is about 109 MB,
// 33 us at 3.35 TB/s; the integer work (about 5 operations per word) is
// far below it. So the bytes bound it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int N_REGS = 8;
constexpr int WMAX = 63;

enum Op {
  NOP = 0, SPLAT = 1, MOV = 2, ADD = 3, SUB = 4, MULF = 5, SHL = 6, SHR = 7,
  CMPGE = 8, SEL = 9, MAXS = 10, MINS = 11, LDW = 12, STW = 13,
  LDCAUSAL = 14, LDACAUSAL = 15, LDRATE = 16, LDMOD = 17, LDNOISE = 18
};

__device__ __forceinline__ int sat16(int x) {
  return min(max(x, -32768), 32767);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__global__ void __launch_bounds__(THREADS)
ppuvm_exec_kernel(const int* __restrict__ words, int n_words,
                  const int* __restrict__ w, const int* __restrict__ qc,
                  const int* __restrict__ qa,
                  const int* __restrict__ rates_fx,
                  const int* __restrict__ mod, int n_mod,
                  const int* __restrict__ noise, int* __restrict__ w_out,
                  int* __restrict__ regs_out, long long total, int RC,
                  int C, long long NC) {
  extern __shared__ int s_words[];
  for (int p = threadIdx.x; p < n_words; p += THREADS) s_words[p] = words[p];
  __syncthreads();

  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const long long nc = (i / RC) * C + (int)(i % C);   // [n, c] of the lane
    const int q_c = qc[i], q_a = qa[i];
    const int nz = noise ? noise[i] : 0;
    int wm = w[i];
    int r[N_REGS];
#pragma unroll
    for (int k = 0; k < N_REGS; ++k) r[k] = 0;

    for (int p = 0; p < n_words; ++p) {
      const unsigned word = (unsigned)s_words[p];
      const int op = (word >> 26) & 0x3F;
      const int rd = (word >> 21) & 0x7;       // 5-bit field mod 8
      const int ra = (word >> 16) & 0x7;
      const int imm = word & 0xFFFF;
      const int simm = (int)(int16_t)(uint16_t)imm;
      const int rb = (imm >> 8) & 0x7;
      const int sh = imm & 0xFF;
      const int a = r[ra], b = r[rb];
      switch (op) {
        case SPLAT: r[rd] = simm; break;
        case MOV: r[rd] = a; break;
        case ADD: r[rd] = sat16(wrap_add(a, b)); break;
        case SUB: r[rd] = sat16((int)((unsigned)a - (unsigned)b)); break;
        case MULF: {
          const int s = min(sh, 16);
          const unsigned prod = (unsigned)a * (unsigned)b
                                + ((1u << s) >> 1);
          r[rd] = sat16((int)prod >> s);
          break;
        }
        case SHL: r[rd] = sat16((int)((unsigned)a << min(sh, 15))); break;
        case SHR: r[rd] = a >> min(sh, 31); break;
        case CMPGE: r[rd] = a >= b ? 256 : 0; break;
        case SEL: r[rd] = r[rd] != 0 ? a : b; break;
        case MAXS: r[rd] = max(a, b); break;
        case MINS: r[rd] = min(a, b); break;
        case LDW: r[rd] = (int)((unsigned)wm << 8); break;
        case STW: wm = min(max(wrap_add(a, 128) >> 8, 0), WMAX); break;
        case LDCAUSAL: r[rd] = q_c; break;
        case LDACAUSAL: r[rd] = q_a; break;
        case LDRATE: r[rd] = rates_fx[nc]; break;
        case LDMOD: {
          const int slot = min(simm & 0xFF, n_mod - 1);
          r[rd] = mod ? mod[slot * NC + nc] : 0;
          break;
        }
        case LDNOISE: r[rd] = nz; break;
        default: break;                          // NOP, unknown opcodes
      }
    }
    w_out[i] = wm;
#pragma unroll
    for (int k = 0; k < N_REGS; ++k) regs_out[k * total + i] = r[k];
  }
}

}  // namespace

// words int32 [P] (on the card); w, qc, qa, noise int32 [N, R, C]
// (noise may be null: a zero plane); rates_fx int32 [N, C]; mod int32
// [n_mod, N, C] (null: one zero slot); w_out int32 [N, R, C]; regs int32
// [8, N, R, C].
extern "C" int ppuvm_exec_launch(const void* words, int n_words,
                                 const void* w, const void* qc,
                                 const void* qa, const void* rates_fx,
                                 const void* mod, int n_mod,
                                 const void* noise, void* w_out, void* regs,
                                 int N, int R, int C, void* stream) {
  const long long total = (long long)N * R * C;
  if (total == 0) return 0;
  const size_t smem = (size_t)n_words * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  ppuvm_exec_kernel<<<(unsigned)blocks, THREADS, smem,
                      (cudaStream_t)stream>>>(
      (const int*)words, n_words, (const int*)w, (const int*)qc,
      (const int*)qa, (const int*)rates_fx, (const int*)mod,
      n_mod < 1 ? 1 : n_mod, (const int*)noise, (int*)w_out, (int*)regs,
      total, R * C, C, (long long)N * C);
  return (int)cudaGetLastError();
}
