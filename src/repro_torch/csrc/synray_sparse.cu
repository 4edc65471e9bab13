// synray_sparse: the event-sparse synapse-array path on Hopper.
//
//   out[n, t, c] = sum_k eff[n, t, k] * w[n, rows[n, t, k], c]
//                  * (addr_store[n, rows[n, t, k], c] == addr[n, t, k])
//
// Replaces the TPU kernel repro/kernels/synray_sparse/kernel.py,
// sparse_window_pallas (_kernel), which gathered the fired weight rows of
// a whole [T, K] record grid into VMEM and contracted them in one dot.
//
// Bound on the H100: at the main-path shape (N=16 instances, T=128 steps,
// K=16 record slots, one Dale half of R=128 rows, C=512 columns) one launch
// reads 0.4 MB of records and at most the two int8 stores (2 x 1 MB) and
// writes 4.2 MB of currents, about 6.7 MB or 2 us at 3.35 TB/s; the FMAs
// the records need (live slots x C) are far fewer than the dense kernel's.
// So the output bytes bound it.
//
// Design: one block per (instance, block of TB steps, block of CB
// columns), one thread per column with TB accumulators in registers. The
// block stages its steps' records in shared memory, KB slots at a time,
// and each thread walks the slots of every step in ascending order,
// reading w[n, row, c] and addr_store[n, row, c] by pointer arithmetic
// (neighbouring threads read neighbouring bytes of the same row). Empty
// slots (eff == 0) are skipped. K is never split and there are no
// atomics, so every output is one fmaf chain over the step's fired rows in
// ascending row order: the same chain the dense kernel (synray.cu) runs,
// whose silent rows are exact no-ops (fmaf(0, w, acc) == acc for the
// non-negative sums here). On a window that fits its capacities the two
// routes are therefore equal bit for bit. Built with the default flags:
// both kernels use explicit fmaf.
//
// The stores are read through strides, so a Dale half (every other row of
// the [R, C] store) is read in place. The records may have an instance
// stride of their own (the packer's slices of a buffer one slot longer);
// each instance's [T, K] block is contiguous. The output is written
// through (instance, step) strides, so the wrapper hands out a time-major
// [T, N, C] buffer that the window's consumers read without a copy.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TB = 8;    // steps per block (accumulators per thread)
constexpr int CB = 128;  // columns per block (threads)
constexpr int KB = 32;   // record slots staged per shared-memory chunk

__global__ void __launch_bounds__(CB)
synray_sparse_kernel(const int* __restrict__ rows, const int* __restrict__ addr,
                     const float* __restrict__ eff,
                     const int8_t* __restrict__ w,
                     const int8_t* __restrict__ st, float* __restrict__ out,
                     int T, int K, int C, long long rec_sn,
                     long long w_sn, long long w_sr, long long a_sn,
                     long long a_sr, long long o_sn, long long o_st) {
  __shared__ int s_row[TB][KB];
  __shared__ int s_addr[TB][KB];
  __shared__ float s_eff[TB][KB];

  const int n = blockIdx.z;
  const int t0 = blockIdx.y * TB;
  const int c = blockIdx.x * CB + threadIdx.x;
  const bool col_ok = c < C;

  const long long rec_n = n * rec_sn;
  const int8_t* w_n = w + n * w_sn;
  const int8_t* a_n = st + n * a_sn;

  float acc[TB];
#pragma unroll
  for (int i = 0; i < TB; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += KB) {
    const int kn = min(KB, K - k0);
    __syncthreads();
    for (int q = threadIdx.x; q < TB * KB; q += CB) {
      const int i = q / KB, j = q % KB;
      const int t = t0 + i;
      const bool ok = t < T && j < kn;
      const long long at = rec_n + (long long)t * K + k0 + j;
      s_row[i][j] = ok ? rows[at] : 0;
      s_addr[i][j] = ok ? addr[at] : 0;
      s_eff[i][j] = ok ? eff[at] : 0.0f;
    }
    __syncthreads();
    if (col_ok) {
#pragma unroll
      for (int i = 0; i < TB; ++i) {
        for (int j = 0; j < kn; ++j) {
          const float e = s_eff[i][j];
          const int r = s_row[i][j];
          if (e == 0.0f) continue;
          const float wf = (float)w_n[r * w_sr + c];
          if ((int)a_n[r * a_sr + c] == s_addr[i][j])
            acc[i] = fmaf(e, wf, acc[i]);
        }
      }
    }
  }
  if (col_ok) {
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      const int t = t0 + i;
      if (t < T) out[n * o_sn + t * o_st + c] = acc[i];
    }
  }
}

}  // namespace

extern "C" int synray_sparse_launch(const void* rows, const void* addr,
                                    const void* eff, const void* w,
                                    const void* st, void* out, int N, int T,
                                    int K, int C, long long rec_sn,
                                    long long w_sn, long long w_sr,
                                    long long a_sn, long long a_sr,
                                    long long o_sn, long long o_st,
                                    void* stream) {
  if (N == 0 || T == 0 || C == 0) return 0;
  dim3 grid((C + CB - 1) / CB, (T + TB - 1) / TB, N);
  synray_sparse_kernel<<<grid, CB, 0, (cudaStream_t)stream>>>(
      (const int*)rows, (const int*)addr, (const float*)eff,
      (const int8_t*)w, (const int8_t*)st, (float*)out, T, K, C, rec_sn,
      w_sn, w_sr, a_sn, a_sr, o_sn, o_st);
  return (int)cudaGetLastError();
}
