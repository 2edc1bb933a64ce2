// Block-ELL SpMM and fused Chebyshev step for 4x4 complex64 blocks (sm_90a).
//
// Three kernels share one device body:
//
//   ell_spmm          y[n,a,k] = sum_s sum_b data[n,s,a,b] * v[cols[n,s],b,k]
//   ell_cheb_step     t_next   = 2*inv*(H t_cur) - t_prev, written out, plus
//                     per-thread-block partial sums, per probe column k, of
//                     Re<t_cur,t_cur> and Re<t_next,t_cur> over the block's sites.
//   ell_spmm_adjoint  y[n,a,k] = sum_s sum_b conj(data[j,m,b,a]) * v[j,b,k] with
//                     j = cols[n,s] and m = mirror(n,s), the slot of row j that
//                     names column n: the product with the conjugate transpose
//                     of the stored matrix, whatever its entries (it is not
//                     assumed Hermitian).  This is the vector cotangent of the
//                     two kernels above, i.e. the backward pass that the
//                     reference takes from the XLA VJP of _flat_cheb_step_ref /
//                     _plane_cheb_step_halo_ref (cheb_step_pallas_ad,
//                     bodge_tpu/ops/pallas_spmm.py:1397).  mirror is the
//                     skeleton's trans_slot, [S] on stencil skeletons and
//                     [N,S] on generic ones.  Bytes as ell_spmm; the operator
//                     read becomes a gather of whole 128-byte blocks (one
//                     cache line each), loaded as 8 float4 per thread.
//                     Its epilogue can scale the product and add row-local
//                     terms, y = alpha*(H^dagger v) + add + c1[k]*x1 + c2[k]*x2,
//                     so that the step's vector cotangent
//                     2*inv*H^dagger G + 2*cc_bar*t_cur + nc_bar*t_next (+ what
//                     later steps already sent to t_cur) is one pass over
//                     memory instead of four elementwise ones.  y may be the
//                     buffer of `add` (read and written by the same thread).
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
//
// Halo forms (template flag HALO): ell_spmm_halo, ell_cheb_step_halo and
// ell_spmm_adjoint_halo compute the same functions on one x-slab of a
// row-sharded lattice.  They replace _plane_stencil_kernel_halo and
// _plane_cheb_kernel_halo (bodge_tpu/ops/pallas_spmm.py:1163, :1219) and the
// vector cotangent of their VJPs (:1430, :1449).  The slab holds n_local rows;
// its column table holds local indices: a column in [0, n_local) reads the
// slab, one in [-P, 0) the plane `hm` before it and one in [n_local,
// n_local + P) the plane `hp` after it (P sites a plane, each plane its own
// buffer, as the ring exchange delivers it: the slab is never copied); a
// column below -P is padding.  The adjoint also reads the blocks of rows in
// those two planes, `dm` and `dp` [P, S, 4, 4], for the mirror blocks of the
// slab's boundary rows.  The forward forms take a row range [row0, row1) of
// the slab, so that the rows that read no halo can run while the halo
// planes travel, and the boundary rows after; partials then hold one row per
// thread block of the range.  The bound is the same as above, plus the two
// halo planes read once.
//
// Operator forms (template parameter OP, operator_form.cuh): the forward
// kernels and their halo forms take the operator as complex64 (OP = float4)
// or in the bf16 form (OP = uint4: each entry a bf16 (re, im) pair, a block
// row one 16-byte load, upcast to float32 in registers), the counterpart of
// the reference's bfloat16 operator storage.  Only the operator's bytes
// change; vectors, sums and the arithmetic stay float32.  The adjoint takes
// complex64 only, as the reference's differentiable paths take a float32
// operator only.

#include <cuda_runtime.h>
#include <stdint.h>

#include "operator_form.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLK = 4;               // 4x4 blocks: Nambu x spin
constexpr int BLK_FLOAT4 = 8;        // 16 complex64 = 32 floats = 8 float4

// Epilogue of the adjoint product: y = alpha*acc + add + c1[k]*x1 + c2[k]*x2.
// Null pointers drop their term; c1, c2 are real, one per probe column.
struct Epilogue {
  float alpha;
  const float2* add;
  const float2* x1;
  const float* c1;
  const float2* x2;
  const float* c2;
};

__device__ __forceinline__ void cfma(float2& acc, float dre, float dim, const float2& v) {
  acc.x = fmaf(dre, v.x, fmaf(-dim, v.y, acc.x));
  acc.y = fmaf(dre, v.y, fmaf(dim, v.x, acc.y));
}

// The halo planes of a slab and the rows it computes.  Without HALO, P = 0,
// the planes are null and the rows are [0, N).
struct Halo {
  const float2* vm;  // vector plane before the slab, [P, 4, K]
  const float2* vp;  // vector plane after the slab
  const float4* dm;  // operator rows of the plane before (adjoint only), [P, S, 4, 4]
  const float4* dp;  // operator rows of the plane after
  int P;
  long long row0, row1;
};

// Row `col` of a [rows, 4, K] vector, or of the halo plane that holds it.
template <bool HALO>
__device__ __forceinline__ const float2* vec_row(const float2* v, const Halo& h, int col,
                                                 long long N, int K) {
  if (HALO) {
    if (col < 0) return h.vm + (size_t)(col + h.P) * BLK * K;
    if (col >= N) return h.vp + (size_t)(col - N) * BLK * K;
  }
  return v + (size_t)col * BLK * K;
}

// Block (col, slot) of the operator, or of the halo rows that hold it.
template <bool HALO>
__device__ __forceinline__ const float4* blk_at(const float4* data, const Halo& h, int col,
                                                int slot, long long N, int S) {
  if (HALO) {
    if (col < 0) return h.dm + ((size_t)(col + h.P) * S + slot) * BLK_FLOAT4;
    if (col >= N) return h.dp + ((size_t)(col - N) * S + slot) * BLK_FLOAT4;
  }
  return data + ((size_t)col * S + slot) * BLK_FLOAT4;
}

template <bool CHEB, bool ADJ, bool HALO, typename OP>
__global__ void __launch_bounds__(THREADS)
ell_kernel(const OP* __restrict__ data, const int* __restrict__ cols,
           const int* __restrict__ mirror, int mirror_per_row,
           const float2* __restrict__ t_cur, const float2* t_prev, float2* t_next,
           float* __restrict__ partials, float two_inv, Epilogue ep, Halo halo,
           long long N, int S, int K, int TK) {
  const int tid = threadIdx.x;
  const int kk = tid & (TK - 1);
  const int nn = tid / TK;
  const int TN = THREADS / TK;
  const long long n = (HALO ? halo.row0 : 0) + (long long)blockIdx.x * TN + nn;
  const long long end = HALO ? halo.row1 : N;
  const int k = blockIdx.y * TK + kk;
  const int pad = HALO ? -halo.P : 0;  // columns below this are padding

  float cc = 0.f, nc = 0.f;
  if (n < end && k < K) {
    float2 acc[BLK];
#pragma unroll
    for (int a = 0; a < BLK; ++a) acc[a] = make_float2(0.f, 0.f);

    const int* crow = cols + (size_t)n * S;
    const OP* drow = data + (size_t)n * S * opform::Op<OP>::PER_BLOCK;
    for (int s = 0; s < S; ++s) {
      const int col = __ldg(crow + s);
      if (col < pad) continue;  // padding slot
      const float2* vrow = vec_row<HALO>(t_cur, halo, col, N, K) + k;
      float2 vb[BLK];
#pragma unroll
      for (int b = 0; b < BLK; ++b) vb[b] = __ldg(vrow + (size_t)b * K);
      if constexpr (ADJ) {
        // The mirror block lives in row `col`; row b of it feeds column b of
        // its conjugate transpose: acc[a] += conj(blk[b][a]) * v[b].
        const int ms = __ldg(mirror + (mirror_per_row ? (size_t)n * S + s : (size_t)s));
        const float4* blk = blk_at<HALO>(data, halo, col, ms, N, S);
#pragma unroll
        for (int b = 0; b < BLK; ++b) {
          const float4 d01 = __ldg(blk + 2 * b);      // entries (b,0), (b,1)
          const float4 d23 = __ldg(blk + 2 * b + 1);  // entries (b,2), (b,3)
          cfma(acc[0], d01.x, -d01.y, vb[b]);
          cfma(acc[1], d01.z, -d01.w, vb[b]);
          cfma(acc[2], d23.x, -d23.y, vb[b]);
          cfma(acc[3], d23.z, -d23.w, vb[b]);
        }
      } else {
        const OP* blk = drow + (size_t)s * opform::Op<OP>::PER_BLOCK;
#pragma unroll
        for (int a = 0; a < BLK; ++a) {
          float2 d[BLK];  // entries (a,0) .. (a,3)
          opform::load_row(blk, a, d);
          cfma(acc[a], d[0].x, d[0].y, vb[0]);
          cfma(acc[a], d[1].x, d[1].y, vb[1]);
          cfma(acc[a], d[2].x, d[2].y, vb[2]);
          cfma(acc[a], d[3].x, d[3].y, vb[3]);
        }
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
      } else if (ADJ) {
        float2 r = make_float2(ep.alpha * acc[a].x, ep.alpha * acc[a].y);
        if (ep.add != nullptr) {
          const float2 q = ep.add[o];  // may be the buffer written below
          r.x += q.x;
          r.y += q.y;
        }
        if (ep.x1 != nullptr) {
          const float c = __ldg(ep.c1 + k);
          const float2 q = __ldg(ep.x1 + o);
          r.x = fmaf(c, q.x, r.x);
          r.y = fmaf(c, q.y, r.y);
        }
        if (ep.x2 != nullptr) {
          const float c = __ldg(ep.c2 + k);
          const float2 q = __ldg(ep.x2 + o);
          r.x = fmaf(c, q.x, r.x);
          r.y = fmaf(c, q.y, r.y);
        }
        t_next[o] = r;
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

constexpr Epilogue NO_EPILOGUE = {1.f, nullptr, nullptr, nullptr, nullptr, nullptr};

dim3 grid_for(long long rows, int K, int TK) {
  const int TN = THREADS / TK;
  return dim3((unsigned)((rows + TN - 1) / TN), (unsigned)((K + TK - 1) / TK), 1);
}

Halo whole(long long N) { return Halo{nullptr, nullptr, nullptr, nullptr, 0, 0, N}; }

bool bad_range(long long N, long long row0, long long row1) {
  return row0 < 0 || row1 < row0 || row1 > N;
}

// A forward form (product or step, whole or halo) on the operator form the
// caller names: bf16 != 0 is the bf16 form, else complex64.
template <bool CHEB, bool HALO>
void launch_forward(int bf16, long long rows, const void* data, const void* cols, const void* t_cur,
                    const void* t_prev, void* t_next, void* partials, float two_inv, const Halo& halo,
                    long long N, int S, int K, int TK, void* stream) {
  const dim3 grid = grid_for(rows, K, TK);
  if (bf16)
    ell_kernel<CHEB, false, HALO, uint4><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint4*)data, (const int*)cols, nullptr, 0, (const float2*)t_cur, (const float2*)t_prev,
        (float2*)t_next, (float*)partials, two_inv, NO_EPILOGUE, halo, N, S, K, TK);
  else
    ell_kernel<CHEB, false, HALO, float4><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float4*)data, (const int*)cols, nullptr, 0, (const float2*)t_cur, (const float2*)t_prev,
        (float2*)t_next, (float*)partials, two_inv, NO_EPILOGUE, halo, N, S, K, TK);
}

}  // namespace

// All entry points launch on the given stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() (0 = launched).  The forward ones
// take `bf16`: 0 for a complex64 operator, 1 for the bf16 form.

extern "C" int ell_spmm_launch(const void* data, int bf16, const void* cols, const void* v, void* y,
                               long long N, int S, int K, int TK, void* stream) {
  if (bad_tile(TK) || N < 0 || S < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  launch_forward<false, false>(bf16, N, data, cols, v, nullptr, y, nullptr, 0.f, whole(N), N, S, K, TK,
                               stream);
  return (int)cudaGetLastError();
}

// y = alpha * (H^dagger v) + add + c1[k]*x1 + c2[k]*x2; add, x1/c1 and x2/c2
// may be null.  y must not be v (other threads gather from it); it may be add.
extern "C" int ell_spmm_adjoint_launch(const void* data, const void* cols, const void* mirror,
                                       int mirror_per_row, const void* v, void* y, float alpha,
                                       const void* add, const void* x1, const void* c1,
                                       const void* x2, const void* c2,
                                       long long N, int S, int K, int TK, void* stream) {
  if (bad_tile(TK) || N < 0 || S < 1 || K < 1 || mirror == nullptr) return (int)cudaErrorInvalidValue;
  if ((x1 == nullptr) != (c1 == nullptr) || (x2 == nullptr) != (c2 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const Epilogue ep = {alpha, (const float2*)add, (const float2*)x1, (const float*)c1,
                       (const float2*)x2, (const float*)c2};
  ell_kernel<false, true, false, float4><<<grid_for(N, K, TK), THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)data, (const int*)cols, (const int*)mirror, mirror_per_row,
      (const float2*)v, nullptr, (float2*)y, nullptr, 0.f, ep, whole(N), N, S, K, TK);
  return (int)cudaGetLastError();
}

extern "C" int ell_cheb_step_launch(const void* data, int bf16, const void* cols, const void* t_cur,
                                    const void* t_prev, void* t_next, void* partials,
                                    float inv, long long N, int S, int K, int TK,
                                    void* stream) {
  if (bad_tile(TK) || N < 0 || S < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  launch_forward<true, false>(bf16, N, data, cols, t_cur, t_prev, t_next, partials, 2.0f * inv, whole(N),
                              N, S, K, TK, stream);
  return (int)cudaGetLastError();
}

// The halo forms.  N is the slab's row count n_local, P the sites of a plane;
// rows [row0, row1) of y / t_next are written (partials: one row per thread
// block of the range).  hm and hp are the vector planes before and after the
// slab, [P, 4, K]; for the adjoint, dm and dp the operator rows of those
// planes, [P, S, 4, 4].  None of them may be null, and none may be written.

extern "C" int ell_spmm_halo_launch(const void* data, int bf16, const void* cols, const void* v,
                                    const void* hm, const void* hp, void* y, long long N, int P,
                                    long long row0, long long row1, int S, int K, int TK,
                                    void* stream) {
  if (bad_tile(TK) || N < 0 || P < 1 || S < 1 || K < 1 || bad_range(N, row0, row1) ||
      hm == nullptr || hp == nullptr)
    return (int)cudaErrorInvalidValue;
  if (row1 == row0) return 0;
  const Halo halo = {(const float2*)hm, (const float2*)hp, nullptr, nullptr, P, row0, row1};
  launch_forward<false, true>(bf16, row1 - row0, data, cols, v, nullptr, y, nullptr, 0.f, halo, N, S, K,
                              TK, stream);
  return (int)cudaGetLastError();
}

extern "C" int ell_cheb_step_halo_launch(const void* data, int bf16, const void* cols, const void* t_cur,
                                         const void* hm, const void* hp, const void* t_prev,
                                         void* t_next, void* partials, float inv, long long N,
                                         int P, long long row0, long long row1, int S, int K,
                                         int TK, void* stream) {
  if (bad_tile(TK) || N < 0 || P < 1 || S < 1 || K < 1 || bad_range(N, row0, row1) ||
      hm == nullptr || hp == nullptr)
    return (int)cudaErrorInvalidValue;
  if (row1 == row0) return 0;
  const Halo halo = {(const float2*)hm, (const float2*)hp, nullptr, nullptr, P, row0, row1};
  launch_forward<true, true>(bf16, row1 - row0, data, cols, t_cur, t_prev, t_next, partials, 2.0f * inv,
                             halo, N, S, K, TK, stream);
  return (int)cudaGetLastError();
}

extern "C" int ell_spmm_adjoint_halo_launch(const void* data, const void* dm, const void* dp,
                                            const void* cols, const void* mirror, const void* v,
                                            const void* vm, const void* vp, void* y, float alpha,
                                            const void* add, const void* x1, const void* c1,
                                            const void* x2, const void* c2, long long N, int P,
                                            int S, int K, int TK, void* stream) {
  if (bad_tile(TK) || N < 0 || P < 1 || S < 1 || K < 1 || mirror == nullptr || vm == nullptr ||
      vp == nullptr || dm == nullptr || dp == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((x1 == nullptr) != (c1 == nullptr) || (x2 == nullptr) != (c2 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const Epilogue ep = {alpha, (const float2*)add, (const float2*)x1, (const float*)c1,
                       (const float2*)x2, (const float*)c2};
  const Halo halo = {(const float2*)vm, (const float2*)vp, (const float4*)dm, (const float4*)dp,
                     P, 0, N};
  ell_kernel<false, true, true, float4><<<grid_for(N, K, TK), THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)data, (const int*)cols, (const int*)mirror, 0, (const float2*)v, nullptr,
      (float2*)y, nullptr, 0.f, ep, halo, N, S, K, TK);
  return (int)cudaGetLastError();
}
