// synray: the synapse array's event path on Hopper.
//
//   out[n, b, c] = sum_r ev[n, b, r] * w[n, r, c] * (addr[n, r, c] == ea[n, b, r])
//
// Replaces the TPU kernel repro/kernels/synray/kernel.py,
// synaptic_current_pallas (_kernel), which built a [bb, rb, cb] mask tile in
// VMEM and contracted it on the vector unit.
//
// Bound on the H100: at the main-path shape (N=16 instances, B=T=128 steps,
// R=128 rows of one Dale half, C=512 columns) one launch reads the int8
// weight and address stores (2 x 1 MB), the event values and addresses
// (1.0 MB + 0.26 MB) and writes 4 MB of currents: about 7.6 MB, 2.3 us at
// 3.35 TB/s. It does B*R*C*N = 134M multiply-adds, 4 us at the 67 TFLOP/s
// float32 rate outside the tensor cores. So the float32 FMAs bound it.
//
// Design: the address comparison stays in registers; no mask is built.
// One block per (instance, time block of BB steps, column block of CB
// columns), one thread per column keeping BB accumulators in registers.
// The block stages the events of its time block for a chunk of RB rows in
// shared memory (each value read by all CB threads), and each thread reads
// its column's weight and address once per row and reuses them over the
// BB steps. Rows are summed in ascending order with fmaf, with no split-K
// and no atomics, so every output has one fixed reduction order. The
// tensor cores are not used: the mask depends on (b, r, c) and the values
// are float32; a faster variant is later work.
//
// Operands are read through strides, so the Dale halves (every other row
// of the [R, C] store) and the time-major event windows are read in place.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BB = 16;   // time steps per block (accumulators per thread)
constexpr int CB = 128;  // columns per block (threads)
constexpr int RB = 64;   // rows staged per shared-memory chunk

__global__ void __launch_bounds__(CB)
synray_kernel(const float* __restrict__ ev, const int8_t* __restrict__ ea,
              const int8_t* __restrict__ w, const int8_t* __restrict__ addr,
              float* __restrict__ out, int B, int R, int C,
              long long ev_sn, long long ev_sb, long long ev_sr,
              long long ea_sn, long long ea_sb, long long ea_sr,
              long long w_sn, long long w_sr,
              long long a_sn, long long a_sr,
              long long o_sn, long long o_sb) {
  __shared__ float s_ev[BB][RB];
  __shared__ int s_ea[BB][RB];

  const int n = blockIdx.z;
  const int b0 = blockIdx.y * BB;
  const int c = blockIdx.x * CB + threadIdx.x;
  const bool col_ok = c < C;

  const float* ev_n = ev + n * ev_sn;
  const int8_t* ea_n = ea + n * ea_sn;
  const int8_t* w_n = w + n * w_sn;
  const int8_t* a_n = addr + n * a_sn;

  float acc[BB];
#pragma unroll
  for (int i = 0; i < BB; ++i) acc[i] = 0.0f;

  for (int r0 = 0; r0 < R; r0 += RB) {
    const int rn = min(RB, R - r0);
    __syncthreads();
    for (int k = threadIdx.x; k < BB * RB; k += CB) {
      const int i = k / RB, j = k % RB;
      const int b = b0 + i;
      const bool ok = b < B && j < rn;
      s_ev[i][j] = ok ? ev_n[b * ev_sb + (r0 + j) * ev_sr] : 0.0f;
      s_ea[i][j] = ok ? (int)ea_n[b * ea_sb + (r0 + j) * ea_sr] : -1000;
    }
    __syncthreads();
    if (col_ok) {
      for (int j = 0; j < rn; ++j) {
        const int r = r0 + j;
        const float wf = (float)w_n[r * w_sr + c];
        const int st = (int)a_n[r * a_sr + c];
#pragma unroll
        for (int i = 0; i < BB; ++i) {
          if (s_ea[i][j] == st) acc[i] = fmaf(s_ev[i][j], wf, acc[i]);
        }
      }
    }
  }
  if (col_ok) {
#pragma unroll
    for (int i = 0; i < BB; ++i) {
      const int b = b0 + i;
      if (b < B) out[n * o_sn + b * o_sb + c] = acc[i];
    }
  }
}

}  // namespace

extern "C" int synray_launch(const void* ev, const void* ea, const void* w,
                             const void* addr, void* out, int N, int B, int R,
                             int C, long long ev_sn, long long ev_sb,
                             long long ev_sr, long long ea_sn, long long ea_sb,
                             long long ea_sr, long long w_sn, long long w_sr,
                             long long a_sn, long long a_sr, long long o_sn,
                             long long o_sb, void* stream) {
  if (N == 0 || B == 0 || C == 0) return 0;
  dim3 grid((C + CB - 1) / CB, (B + BB - 1) / BB, N);
  synray_kernel<<<grid, CB, 0, (cudaStream_t)stream>>>(
      (const float*)ev, (const int8_t*)ea, (const int8_t*)w,
      (const int8_t*)addr, (float*)out, B, R, C, ev_sn, ev_sb, ev_sr, ea_sn,
      ea_sb, ea_sr, w_sn, w_sr, a_sn, a_sr, o_sn, o_sb);
  return (int)cudaGetLastError();
}
