// Operator cotangent of the block-ELL product for 4x4 complex64 blocks (sm_90a).
//
//   ell_block_outer  hbar[n,s,a,b] (+)= alpha * sum_k G[n,a,k] * conj(t[cols[n,s],b,k])
//                    with G = g + shift[k] * t   (g or shift may be absent),
//                    and, where asked for, neg_out = -G written out as well.
//
// For y = H t with H stored as data[N,S,4,4] this is the cotangent of `data`
// given the cotangent g of y (PyTorch's convention for complex gradients);
// padding slots (cols < 0) get zero.  It is the new arithmetic of the backward
// pass of the fused Chebyshev step, which the reference takes from the XLA VJP
// of _flat_cheb_step_ref / _plane_cheb_step_halo_ref (cheb_step_pallas_ad,
// bodge_tpu/ops/pallas_spmm.py:1397); the reference has no kernel of its own
// there.  `accumulate` adds into hbar instead of overwriting it, so that the
// steps of a moment sweep can sum their cotangents into one buffer.  In the
// step's backward pass G = g_next + nc_bar * t_cur and -G is the cotangent of
// t_prev: forming G here and writing -G out saves the two elementwise passes
// that would otherwise build them.
//
// Bound: bytes.  g is read once (N*4*K*8), t once (gathered through cols),
// hbar written once (N*S*128) and read once more when accumulating (plus -G
// written once where asked for); the
// arithmetic is 8*16*K real operations per 128-byte block, K operations per
// byte written, far below the card's ridge.  What the design does about it:
// a group of TK lanes owns one site, the lanes run over the probe columns k
// (the fastest index of g and t, so their loads coalesce), every lane sums its
// columns' 16 complex products in registers, and the group adds them up with
// a halving exchange (__shfl_xor_sync) that leaves each lane with 32/TK
// consecutive floats of the block, so the block goes out as one coalesced
// 128-byte write.  g of a site is re-read for each of its S slots, from L1.
//
// A row belongs to one group, nothing is atomic and the order of the sums is
// fixed, so results repeat bit for bit.  Every lane of a warp runs every
// shuffle: rows past N and padding slots contribute zeros instead of
// branching around the exchange.
//
// Mapping: 256 threads = TK lanes x TN = 256/TK sites, TK a power of two
// <= 32 chosen by the caller (the smallest that covers min(K, 32)); a lane
// takes columns kk, kk+TK, ...  grid = ceil(N/TN).  All offsets are 64-bit.
//
// Halo form (ell_block_outer_halo): the same function on one x-slab of a
// row-sharded lattice, the operator cotangent of the halo kernels
// _plane_stencil_kernel_halo / _plane_cheb_kernel_halo
// (bodge_tpu/ops/pallas_spmm.py:1430, :1449).  The slab's column table holds
// local indices: [0, N) reads t, [-P, 0) the plane tm before the slab and
// [N, N + P) the plane tp after it (the forward step's halo planes of t,
// kept for this); a column below -P is padding.  Bound: as above, plus the
// two planes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLK = 4;
constexpr int BLOCK_FLOATS = 32;  // 16 complex64

// One round per lane bit, from the highest down: lanes with the bit clear keep
// the lower half of their LEN sums, lanes with it set the upper half, and each
// adds what its partner held of that half.  After the last round lane kk holds
// floats [kk*32/TK, (kk+1)*32/TK) of the block in acc[0 .. 32/TK).
template <int M, int LEN>
__device__ __forceinline__ void reduce_scatter(float (&acc)[BLOCK_FLOATS], int kk) {
  if constexpr (M >= 1) {
    const bool upper = (kk & M) != 0;
#pragma unroll
    for (int i = 0; i < LEN / 2; ++i) {
      const float keep = upper ? acc[i + LEN / 2] : acc[i];
      const float send = upper ? acc[i] : acc[i + LEN / 2];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    reduce_scatter<M / 2, LEN / 2>(acc, kk);
  }
}

// G[n,a,k] for a = 0..3 at one (row, column): g + shift[k]*t, either term optional.
__device__ __forceinline__ void load_G(float2 (&gv)[BLK], const float2* g, const float2* t,
                                       const float* shift, size_t base, int K, int k) {
  const float c = shift != nullptr ? __ldg(shift + k) : 0.f;
#pragma unroll
  for (int a = 0; a < BLK; ++a) {
    const size_t o = base + (size_t)a * K;
    float2 v = g != nullptr ? __ldg(g + o) : make_float2(0.f, 0.f);
    if (shift != nullptr) {
      const float2 q = __ldg(t + o);
      v.x = fmaf(c, q.x, v.x);
      v.y = fmaf(c, q.y, v.y);
    }
    gv[a] = v;
  }
}

template <int TK, bool HALO>
__global__ void __launch_bounds__(THREADS)
block_outer_kernel(const float2* __restrict__ g, const float2* __restrict__ t,
                   const float2* __restrict__ tm, const float2* __restrict__ tp, int P,
                   const float* __restrict__ shift, float2* __restrict__ neg_out,
                   const int* __restrict__ cols, float* hbar, float alpha, int accumulate,
                   long long N, int S, int K) {
  constexpr int TN = THREADS / TK;
  constexpr int CH = BLOCK_FLOATS / TK;  // floats of a block that one lane writes
  const int tid = threadIdx.x;
  const int kk = tid % TK;
  const int nn = tid / TK;
  const long long n = (long long)blockIdx.x * TN + nn;
  const bool row = n < N;

  if (row && neg_out != nullptr) {
    for (int k = kk; k < K; k += TK) {
      const size_t base = (size_t)n * BLK * K + k;
      float2 gv[BLK];
      load_G(gv, g, t, shift, base, K, k);
#pragma unroll
      for (int a = 0; a < BLK; ++a) neg_out[base + (size_t)a * K] = make_float2(-gv[a].x, -gv[a].y);
    }
  }

  for (int s = 0; s < S; ++s) {
    const int pad = HALO ? -P : 0;  // columns below this are padding
    const int col = row ? __ldg(cols + (size_t)n * S + s) : pad - 1;
    float acc[BLOCK_FLOATS];
#pragma unroll
    for (int i = 0; i < BLOCK_FLOATS; ++i) acc[i] = 0.f;

    if (col >= pad) {
      const float2* tcol = (HALO && col < 0)    ? tm + (size_t)(col + P) * BLK * K
                           : (HALO && col >= N) ? tp + (size_t)(col - N) * BLK * K
                                                : t + (size_t)col * BLK * K;
      for (int k = kk; k < K; k += TK) {
        const float2* trow = tcol + k;
        float2 gv[BLK], tv[BLK];
        load_G(gv, g, t, shift, (size_t)n * BLK * K + k, K, k);
#pragma unroll
        for (int b = 0; b < BLK; ++b) tv[b] = __ldg(trow + (size_t)b * K);
#pragma unroll
        for (int a = 0; a < BLK; ++a) {
#pragma unroll
          for (int b = 0; b < BLK; ++b) {
            // g * conj(t) = (gx tx + gy ty) + i (gy tx - gx ty)
            float& re = acc[(a * BLK + b) * 2];
            float& im = acc[(a * BLK + b) * 2 + 1];
            re = fmaf(gv[a].x, tv[b].x, fmaf(gv[a].y, tv[b].y, re));
            im = fmaf(gv[a].y, tv[b].x, fmaf(-gv[a].x, tv[b].y, im));
          }
        }
      }
    }

    reduce_scatter<TK / 2, BLOCK_FLOATS>(acc, kk);

    if (row) {
      float* out = hbar + ((size_t)n * S + s) * BLOCK_FLOATS + kk * CH;
      if constexpr (CH % 4 == 0) {
#pragma unroll
        for (int i = 0; i < CH; i += 4) {
          float4 v = make_float4(alpha * acc[i], alpha * acc[i + 1], alpha * acc[i + 2],
                                 alpha * acc[i + 3]);
          if (accumulate) {
            const float4 old = *reinterpret_cast<const float4*>(out + i);
            v.x += old.x; v.y += old.y; v.z += old.z; v.w += old.w;
          }
          *reinterpret_cast<float4*>(out + i) = v;
        }
      } else {
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          float v = alpha * acc[i];
          if (accumulate) v += out[i];
          out[i] = v;
        }
      }
    }
  }
}

template <int TK, bool HALO>
int launch(const void* g, const void* t, const void* tm, const void* tp, int P, const void* shift,
           void* neg_out, const void* cols, void* hbar, float alpha, int accumulate, long long N,
           int S, int K, cudaStream_t stream) {
  constexpr int TN = THREADS / TK;
  const unsigned blocks = (unsigned)((N + TN - 1) / TN);
  block_outer_kernel<TK, HALO><<<blocks, THREADS, 0, stream>>>(
      (const float2*)g, (const float2*)t, (const float2*)tm, (const float2*)tp, P,
      (const float*)shift, (float2*)neg_out, (const int*)cols, (float*)hbar, alpha, accumulate,
      N, S, K);
  return (int)cudaGetLastError();
}

template <bool HALO>
int dispatch(const void* g, const void* t, const void* tm, const void* tp, int P,
             const void* shift, void* neg_out, const void* cols, void* hbar, float alpha,
             int accumulate, long long N, int S, int K, int TK, cudaStream_t st) {
  switch (TK) {
    case 1: return launch<1, HALO>(g, t, tm, tp, P, shift, neg_out, cols, hbar, alpha, accumulate, N, S, K, st);
    case 2: return launch<2, HALO>(g, t, tm, tp, P, shift, neg_out, cols, hbar, alpha, accumulate, N, S, K, st);
    case 4: return launch<4, HALO>(g, t, tm, tp, P, shift, neg_out, cols, hbar, alpha, accumulate, N, S, K, st);
    case 8: return launch<8, HALO>(g, t, tm, tp, P, shift, neg_out, cols, hbar, alpha, accumulate, N, S, K, st);
    case 16: return launch<16, HALO>(g, t, tm, tp, P, shift, neg_out, cols, hbar, alpha, accumulate, N, S, K, st);
    case 32: return launch<32, HALO>(g, t, tm, tp, P, shift, neg_out, cols, hbar, alpha, accumulate, N, S, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on the given stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError() (0 = launched).  g and shift may be null (not
// both); neg_out may be null; neg_out must be a buffer of its own.
extern "C" int ell_block_outer_launch(const void* g, const void* t, const void* shift,
                                      void* neg_out, const void* cols, void* hbar,
                                      float alpha, int accumulate, long long N, int S, int K,
                                      int TK, void* stream) {
  if (N < 0 || S < 1 || K < 1 || (g == nullptr && shift == nullptr)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  return dispatch<false>(g, t, nullptr, nullptr, 0, shift, neg_out, cols, hbar, alpha, accumulate,
                         N, S, K, TK, (cudaStream_t)stream);
}

// The halo form: N is the slab's row count, P the sites of a plane, tm and tp
// the planes of t before and after the slab ([P, 4, K], not null).
extern "C" int ell_block_outer_halo_launch(const void* g, const void* t, const void* tm,
                                           const void* tp, const void* shift, void* neg_out,
                                           const void* cols, void* hbar, float alpha,
                                           int accumulate, long long N, int P, int S, int K,
                                           int TK, void* stream) {
  if (N < 0 || P < 1 || S < 1 || K < 1 || (g == nullptr && shift == nullptr) || tm == nullptr ||
      tp == nullptr)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  return dispatch<true>(g, t, tm, tp, P, shift, neg_out, cols, hbar, alpha, accumulate, N, S, K,
                        TK, (cudaStream_t)stream);
}
