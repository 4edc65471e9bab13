// synray: the synapse array's event path on Hopper.
//
//   out[n, b, c] = sum_r ev[n, b, r] * w[n, r, c] * (addr[n, r, c] == ea[n, b, r])
//
// Replaces the TPU kernel repro/kernels/synray/kernel.py,
// synaptic_current_pallas (_kernel), which built a [bb, rb, cb] mask tile in
// VMEM and contracted it on the vector unit.
//
// Bound on the H100: at the main-path shape (N=16 instances, B=T=128 steps,
// R=128 rows of one Dale half, C=512 columns) one launch of the const
// form reads the int8 weight and address stores (2 x 1 MB), the event
// values (1.0 MB) and the addresses of step 0 (2 KB; the general form reads
// all 0.26 MB) and writes 4 MB of currents: about 7.3 MB, 2.2 us at
// 3.35 TB/s. The dense product is B*R*C*N = 134M multiply-adds, 4 us at the
// 67 TFLOP/s float32 rate outside the tensor cores; the FMAs the data needs
// (non-zero events x matched columns) are far fewer, so the bytes bound it.
//
// Design: a register-tiled product. A block of 16 warps computes a
// BT x BC = 64-step x 128-column output tile; each thread keeps a TM x TN
// = 4 x 4 register tile (4 steps of 4 neighbouring columns), so one staged
// event value serves 4 columns and one staged weight serves 4 steps: per
// row a thread issues two 128-bit shared loads (its 4 events, broadcast
// across the warp, and its 4 weights) for 16 FMAs. Rows are staged RK = 32
// at a time through a four-slot ring in shared memory: the int8 weight and
// address rows with 16-byte cp.async (4-byte cp.async for the strided
// event values), three chunks in flight while one is used. Once a chunk
// has landed, each weight is converted to float once per block (through
// the integer units: the byte goes into the mantissa of 2^23).
//
// Event sparsity: in each chunk, lane j of a warp tests row j's events at
// the warp's 4 steps, and a ballot gives the rows with any non-zero event;
// the warp runs the FMAs of those rows only, in ascending order. At the
// main path's densities (2-7% of rows fire at a step) most rows are
// skipped. A skipped row adds fmaf(0, w, acc) == acc, so the skip changes
// no bit.
//
// Two forms. const_addr (the main path: every row's event address is the
// same at every step of the window, the reference's promise for
// const_addr): the address match is folded into the staged weight,
// (addr == ea[0, r]) ? (float)w : 0, and the inner loop is pure fmaf. The
// general form keeps the event address of every (step, row) in shared
// memory and compares it against the thread's 4 column addresses.
//
// Order: every output is one fmaf chain over ascending r (no split-K, no
// atomics, no tensor cores). An FMA with a weight or an event of 0 leaves
// the sum unchanged bit for bit (the sum is never -0: it starts at +0 and
// fmaf only gives -0 from -0), so the const form equals the general form,
// which skips a mismatch, and both equal synray_sparse, which runs the
// same chain over the fired rows only. Events must be finite (an infinite
// event times a folded 0 would be NaN).
//
// Operands are read through strides, so the Dale halves (every other row
// of the [R, C] store) and the time-major event windows are read in place.
//
// A flag pointer gates the launch on the device, as the reference's
// lax.cond between the routes (repro/core/synapse.py:252-257): null runs
// the kernel; else every block returns at once when *flag != 0 (the
// census, census.cu, found that the window fits the sparse route, and
// synray_sparse.cu writes the output).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 4;            // steps per thread
constexpr int TN = 4;            // columns per thread
constexpr int WX = 32;           // threads along the columns (one warp)
constexpr int WY = 16;           // warps along the steps
constexpr int NT = WX * WY;      // threads per block
constexpr int BT = WY * TM;      // steps per block
constexpr int BC = WX * TN;      // columns per block
constexpr int RK = 32;           // rows per staged chunk (one per lane)
constexpr int BTP = BT + 4;      // padded event row (16-byte aligned)
constexpr int S = 4;             // slots of the cp.async ring

struct Stage {                   // one slot of the ring
  int8_t w[RK][BC];
  int8_t a[RK][BC];
  float ev[RK][BTP];             // [row][step]
};

constexpr int WF_OFF = S * (int)sizeof(Stage);           // float [RK][BC]
constexpr int EA_OFF = WF_OFF + RK * BC * (int)sizeof(float);

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

// wait until at most S - 2 groups are in flight: the oldest has landed
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2));
}

struct Args {
  const float* ev;
  const int8_t* ea;
  const int8_t* w;
  const int8_t* addr;
  float* out;
  const int* flag;  // null: run; else run only where *flag == 0
  int B, R, C;
  long long ev_sn, ev_sb, ev_sr, ea_sn, ea_sb, ea_sr;
  long long w_sn, w_sr, a_sn, a_sr, o_sn, o_sb;
  bool vec_in;    // stores 16-byte aligned with 16-byte row strides
  bool vec_out;   // output 16-byte aligned with strides a multiple of 4
};

// Issue the copies of rows [r0, r0 + RK) of the block's tile into slot s.
// Rows past R, steps past B and columns past C are zero-filled.
__device__ void load_chunk(Stage& s, const Args& p, int n, int b0, int c0,
                           int r0, bool vec, int tid) {
  const int rn = min(RK, p.R - r0);
  const int8_t* w_n = p.w + n * p.w_sn;
  const int8_t* a_n = p.addr + n * p.a_sn;
  if (vec) {
    for (int k = tid; k < RK * (BC / 16); k += NT) {
      const int j = k / (BC / 16), q = (k % (BC / 16)) * 16;
      if (j < rn) {
        cp_async16(&s.w[j][q], w_n + (r0 + j) * p.w_sr + c0 + q);
        cp_async16(&s.a[j][q], a_n + (r0 + j) * p.a_sr + c0 + q);
      } else {
        *reinterpret_cast<int4*>(&s.w[j][q]) = make_int4(0, 0, 0, 0);
        *reinterpret_cast<int4*>(&s.a[j][q]) = make_int4(0, 0, 0, 0);
      }
    }
  } else {
    for (int k = tid; k < RK * BC; k += NT) {
      const int j = k / BC, q = k % BC, c = c0 + q;
      const bool ok = j < rn && c < p.C;
      s.w[j][q] = ok ? w_n[(r0 + j) * p.w_sr + c] : 0;
      s.a[j][q] = ok ? a_n[(r0 + j) * p.a_sr + c] : 0;
    }
  }
  const float* ev_n = p.ev + n * p.ev_sn;
  for (int k = tid; k < RK * BT; k += NT) {
    const int j = k % RK, i = k / RK, b = b0 + i;   // neighbours: rows
    if (j < rn && b < p.B)
      cp_async4(&s.ev[j][i], ev_n + b * p.ev_sb + (r0 + j) * p.ev_sr);
    else
      s.ev[j][i] = 0.0f;
  }
}

template <bool CONST>
__global__ void __launch_bounds__(NT) synray_kernel(Args p) {
  if (p.flag != nullptr && *p.flag != 0) return;
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* ring = reinterpret_cast<Stage*>(smem);
  float(*s_wf)[BC] = reinterpret_cast<float(*)[BC]>(smem + WF_OFF);
  // event addresses: CONST [R] (step 0), else [R][BT] (the block's steps)
  int8_t* s_ea = reinterpret_cast<int8_t*>(smem + EA_OFF);

  const int n = blockIdx.z;
  const int b0 = blockIdx.y * BT;
  const int c0 = blockIdx.x * BC;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * WX + tx;
  const bool vec = p.vec_in && c0 + BC <= p.C;
  const int8_t* ea_n = p.ea + n * p.ea_sn;

  const int nk = (p.R + RK - 1) / RK;
  for (int k = 0; k < S - 1; ++k) {
    if (k < nk) load_chunk(ring[k], p, n, b0, c0, k * RK, vec, tid);
    cp_async_commit();
  }
  // the event addresses, while the first chunks are in flight
  if (CONST) {
    for (int r = tid; r < p.R; r += NT) s_ea[r] = ea_n[r * p.ea_sr];
  } else {
    for (int k = tid; k < p.R * BT; k += NT) {
      const int r = k % p.R, i = k / p.R, b = b0 + i;
      s_ea[r * BT + i] = b < p.B ? ea_n[b * p.ea_sb + r * p.ea_sr] : 0;
    }
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int k = 0; k < TN; ++k) acc[i][k] = 0.0f;

  for (int kc = 0; kc < nk; ++kc) {
    const int r0 = kc * RK, rn = min(RK, p.R - r0);
    Stage& cur = ring[kc % S];
    cp_async_wait_oldest();
    __syncthreads();   // chunk kc landed; chunk kc-1's readers are done
    if (kc + S - 1 < nk)
      load_chunk(ring[(kc + S - 1) % S], p, n, b0, c0, (kc + S - 1) * RK,
                 vec, tid);
    cp_async_commit();

    // convert the weights once (const form: fold the match in). int8 to
    // float without the slow conversion unit: byte b + 128 goes into the
    // mantissa of 2^23, and 2^23 + 128 is subtracted (both exact)
    for (int j = tid / WX; j < RK; j += NT / WX) {
      const int q = (tid % WX) * TN;
      const unsigned wb =
          *reinterpret_cast<const unsigned*>(&cur.w[j][q]) ^ 0x80808080u;
      unsigned keep = 0xffffffffu;
      if (CONST) {
        const unsigned ab = *reinterpret_cast<const unsigned*>(&cur.a[j][q]);
        const unsigned e0 = j < rn ? (unsigned)(uint8_t)s_ea[r0 + j] : 0u;
        keep = __vcmpeq4(ab, e0 * 0x01010101u);   // 0xff where it matches
      }
      float f[TN];
#pragma unroll
      for (int k = 0; k < TN; ++k) {
        const float x =
            __uint_as_float(0x4b000000u | __byte_perm(wb, 0u, 0x4440 + k)) -
            8388736.0f;
        f[k] = __uint_as_float(__float_as_uint(x) &
                               __byte_perm(keep, 0u, 0x1111 * k));
      }
      *reinterpret_cast<float4*>(&s_wf[j][q]) = make_float4(f[0], f[1], f[2], f[3]);
    }
    __syncthreads();

    // the chunk's rows with a non-zero event in this warp's steps (lane j
    // tests row j): the others add nothing, so the warp skips them
    bool live = false;
#pragma unroll
    for (int h = 0; h < TM; h += 4) {
      const float4 x = *reinterpret_cast<const float4*>(&cur.ev[tx][ty * TM + h]);
      live |= x.x != 0.0f || x.y != 0.0f || x.z != 0.0f || x.w != 0.0f;
    }
    unsigned rows = __ballot_sync(0xffffffffu, live && tx < rn);
    while (rows) {                     // ascending rows, uniform in the warp
      const int j = __ffs(rows) - 1;
      rows &= rows - 1;
      float e[TM];
#pragma unroll
      for (int h = 0; h < TM; h += 4) {
        const float4 x = *reinterpret_cast<const float4*>(&cur.ev[j][ty * TM + h]);
        e[h] = x.x; e[h + 1] = x.y; e[h + 2] = x.z; e[h + 3] = x.w;
      }
      const float4 wv = *reinterpret_cast<const float4*>(&s_wf[j][tx * TN]);
      const float wf[TN] = {wv.x, wv.y, wv.z, wv.w};
      if (CONST) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int k = 0; k < TN; ++k) acc[i][k] = fmaf(e[i], wf[k], acc[i][k]);
      } else {
        const char4 av = *reinterpret_cast<const char4*>(&cur.a[j][tx * TN]);
        const int a[TN] = {av.x, av.y, av.z, av.w};
        int ea[TM];
#pragma unroll
        for (int h = 0; h < TM; h += 4) {
          const char4 x = *reinterpret_cast<const char4*>(
              &s_ea[(r0 + j) * BT + ty * TM + h]);
          ea[h] = x.x; ea[h + 1] = x.y; ea[h + 2] = x.z; ea[h + 3] = x.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int k = 0; k < TN; ++k)
            if (ea[i] == a[k]) acc[i][k] = fmaf(e[i], wf[k], acc[i][k]);
      }
    }
  }

  const int c = c0 + tx * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = b0 + ty * TM + i;
    if (b >= p.B || c >= p.C) continue;
    float* o = p.out + n * p.o_sn + b * p.o_sb + c;
    if (p.vec_out && c + TN <= p.C) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int k = 0; k < TN; ++k)
        if (c + k < p.C) o[k] = acc[i][k];
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <bool CONST>
int launch(const Args& p, int N, cudaStream_t stream) {
  const int ea_bytes = CONST ? p.R : p.R * BT;
  const int smem = EA_OFF + (ea_bytes + 15) / 16 * 16;
  const cudaError_t e = cudaFuncSetAttribute(
      synray_kernel<CONST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.C + BC - 1) / BC, (p.B + BT - 1) / BT, N);
  synray_kernel<CONST><<<grid, dim3(WX, WY), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int synray_launch(const void* ev, const void* ea, const void* w,
                             const void* addr, void* out, const void* flag,
                             int N, int B, int R, int C, long long ev_sn,
                             long long ev_sb, long long ev_sr,
                             long long ea_sn, long long ea_sb,
                             long long ea_sr, long long w_sn, long long w_sr,
                             long long a_sn, long long a_sr, long long o_sn,
                             long long o_sb, int const_addr, void* stream) {
  if (N == 0 || B == 0 || C == 0) return 0;
  Args p{(const float*)ev, (const int8_t*)ea, (const int8_t*)w,
         (const int8_t*)addr, (float*)out, (const int*)flag, B, R, C,
         ev_sn, ev_sb, ev_sr, ea_sn, ea_sb, ea_sr, w_sn, w_sr, a_sn, a_sr,
         o_sn, o_sb, false, false};
  p.vec_in = aligned16(w) && aligned16(addr) && w_sn % 16 == 0 &&
             w_sr % 16 == 0 && a_sn % 16 == 0 && a_sr % 16 == 0;
  p.vec_out = aligned16(out) && o_sn % 4 == 0 && o_sb % 4 == 0;
  return const_addr ? launch<true>(p, N, (cudaStream_t)stream)
                    : launch<false>(p, N, (cudaStream_t)stream);
}
