// Block-ELL SpMM and fused Chebyshev step for 4x4 complex64 blocks (sm_90a).
//
// Two kernels share one device body:
//
//   ell_spmm       y[n,a,k] = sum_s sum_b data[n,s,a,b] * v[cols[n,s],b,k]
//   ell_cheb_step  t_next   = 2*inv*(H t_cur) - t_prev, written out, plus
//                  per-thread-block partial sums, per probe column k, of
//                  Re<t_cur,t_cur> and Re<t_next,t_cur> over the block's sites.
//
// They replace the four stencil Pallas kernels of bodge_tpu/ops/pallas_spmm.py
// (_flat_spmm_kernel and _plane_stencil_kernel; _flat_cheb_kernel and
// _plane_cheb_kernel).  Those come in a flat and a plane layout because the
// TPU's fast memory is small and has no gather; here a thread simply reads
// cols[n,s] and gathers, so one kernel serves every lattice size, every probe
// count K, and generic (non-stencil) skeletons as well.  No packing pass: the
// arrays are the natural complex64 tensors viewed as float pairs.
//
// Bound: both are far below the card's operations-per-byte ridge (a step does
// 8*16*K real operations per 128-byte block, i.e. K flops per byte of
// operator), so the bound is bytes: the operator once, t_cur and t_prev once,
// t_next once (ops/spmm.py: chebyshev_step_bytes / spmm_bytes) over the
// device-memory rate.  What the design does about it: k is the fastest
// thread index, so the K loads of v[col,b,:] and the K stores of t_next
// coalesce; the 16 block entries of a site are 16-byte broadcast loads shared
// by the K threads of that site through L1; the recursion tail and both
// reductions happen in registers in the same pass, so no intermediate H*t
// and no separate dot-product pass touches device memory.
//
// Mapping: 256 threads = TK probe columns x TN = 256/TK sites, TK a power of
// two <= 32 chosen by the caller (the smallest that covers min(K, 32)).
// grid = (ceil(N/TN), ceil(K/TK)).  All element offsets are 64-bit.
//
// Partials: thread block (bx, by) writes partials[bx, k] and partials[bx, K+k]
// for its own columns k.  The reduction inside the block is a fixed tree in
// shared memory and there are no atomics, so results repeat bit for bit from
// run to run; the caller sums partials over bx.
//
// Aliasing: t_next must not alias t_cur (other threads gather from it).  It
// MAY alias t_prev: each thread reads its own t_prev entries before it
// writes the same entries of t_next, and no other thread touches them.
// t_prev may be null, meaning zero (the first step of the recursion).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLK = 4;               // 4x4 blocks: Nambu x spin
constexpr int BLK_FLOAT4 = 8;        // 16 complex64 = 32 floats = 8 float4

__device__ __forceinline__ void cfma(float2& acc, float dre, float dim, const float2& v) {
  acc.x = fmaf(dre, v.x, fmaf(-dim, v.y, acc.x));
  acc.y = fmaf(dre, v.y, fmaf(dim, v.x, acc.y));
}

template <bool CHEB>
__global__ void __launch_bounds__(THREADS)
ell_kernel(const float4* __restrict__ data, const int* __restrict__ cols,
           const float2* __restrict__ t_cur, const float2* t_prev, float2* t_next,
           float* __restrict__ partials, float two_inv,
           long long N, int S, int K, int TK) {
  const int tid = threadIdx.x;
  const int kk = tid & (TK - 1);
  const int nn = tid / TK;
  const int TN = THREADS / TK;
  const long long n = (long long)blockIdx.x * TN + nn;
  const int k = blockIdx.y * TK + kk;

  float cc = 0.f, nc = 0.f;
  if (n < N && k < K) {
    float2 acc[BLK];
#pragma unroll
    for (int a = 0; a < BLK; ++a) acc[a] = make_float2(0.f, 0.f);

    const int* crow = cols + (size_t)n * S;
    const float4* drow = data + (size_t)n * S * BLK_FLOAT4;
    for (int s = 0; s < S; ++s) {
      const int col = __ldg(crow + s);
      if (col < 0) continue;  // padding slot
      const float2* vrow = t_cur + (size_t)col * BLK * K + k;
      float2 vb[BLK];
#pragma unroll
      for (int b = 0; b < BLK; ++b) vb[b] = __ldg(vrow + (size_t)b * K);
      const float4* blk = drow + (size_t)s * BLK_FLOAT4;
#pragma unroll
      for (int a = 0; a < BLK; ++a) {
        const float4 d01 = __ldg(blk + 2 * a);      // entries (a,0), (a,1)
        const float4 d23 = __ldg(blk + 2 * a + 1);  // entries (a,2), (a,3)
        cfma(acc[a], d01.x, d01.y, vb[0]);
        cfma(acc[a], d01.z, d01.w, vb[1]);
        cfma(acc[a], d23.x, d23.y, vb[2]);
        cfma(acc[a], d23.z, d23.w, vb[3]);
      }
    }

    const size_t base = (size_t)n * BLK * K + k;
#pragma unroll
    for (int a = 0; a < BLK; ++a) {
      const size_t o = base + (size_t)a * K;
      if (CHEB) {
        const float2 c = __ldg(t_cur + o);
        float2 p = make_float2(0.f, 0.f);
        if (t_prev != nullptr) p = t_prev[o];  // read before the write below
        float2 nx;
        nx.x = fmaf(two_inv, acc[a].x, -p.x);
        nx.y = fmaf(two_inv, acc[a].y, -p.y);
        t_next[o] = nx;
        cc = fmaf(c.x, c.x, fmaf(c.y, c.y, cc));
        nc = fmaf(nx.x, c.x, fmaf(nx.y, c.y, nc));
      } else {
        t_next[o] = acc[a];
      }
    }
  }

  if (CHEB) {
    __shared__ float s_cc[THREADS];
    __shared__ float s_nc[THREADS];
    s_cc[tid] = cc;
    s_nc[tid] = nc;
    __syncthreads();
    for (int h = TN / 2; h > 0; h >>= 1) {
      if (nn < h) {
        s_cc[tid] += s_cc[tid + h * TK];
        s_nc[tid] += s_nc[tid + h * TK];
      }
      __syncthreads();
    }
    if (nn == 0 && k < K) {
      float* row = partials + (size_t)blockIdx.x * 2 * K;
      row[k] = s_cc[tid];
      row[K + k] = s_nc[tid];
    }
  }
}

bool bad_tile(int TK) { return TK < 1 || TK > 32 || (TK & (TK - 1)) != 0; }

dim3 grid_for(long long N, int K, int TK) {
  const int TN = THREADS / TK;
  return dim3((unsigned)((N + TN - 1) / TN), (unsigned)((K + TK - 1) / TK), 1);
}

}  // namespace

// Both entry points launch on the given stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() (0 = launched).

extern "C" int ell_spmm_launch(const void* data, const void* cols, const void* v, void* y,
                               long long N, int S, int K, int TK, void* stream) {
  if (bad_tile(TK) || N < 0 || S < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  ell_kernel<false><<<grid_for(N, K, TK), THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)data, (const int*)cols, (const float2*)v, nullptr, (float2*)y,
      nullptr, 0.f, N, S, K, TK);
  return (int)cudaGetLastError();
}

extern "C" int ell_cheb_step_launch(const void* data, const void* cols, const void* t_cur,
                                    const void* t_prev, void* t_next, void* partials,
                                    float inv, long long N, int S, int K, int TK,
                                    void* stream) {
  if (bad_tile(TK) || N < 0 || S < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  ell_kernel<true><<<grid_for(N, K, TK), THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)data, (const int*)cols, (const float2*)t_cur, (const float2*)t_prev,
      (float2*)t_next, (float*)partials, 2.0f * inv, N, S, K, TK);
  return (int)cudaGetLastError();
}
