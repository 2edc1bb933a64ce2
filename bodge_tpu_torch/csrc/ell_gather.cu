// Windowed block-ELL SpMM and fused Chebyshev step for relabelled generic
// skeletons, 4x4 complex64 blocks (sm_90a).
//
//   ell_gather_spmm       y[n,a,k] = sum_s sum_b data[n,s,a,b] * v[n + rel[n,s], b, k]
//   ell_gather_cheb_step  t_next   = 2*inv*(H t_cur) - t_prev, written out, plus
//                         per-thread-block partial sums, per probe column k, of
//                         Re<t_cur,t_cur> and Re<t_next,t_cur> over the block's sites.
//
// They replace the gather kernel of bodge_tpu/ops/pallas_gather.py
// (_gather_kernel under spmm_gather_packed; moments_gather_packed scans it
// with the scale and the inner products as separate passes).  What that kernel
// computes: the product on a skeleton whose sites were relabelled (reverse
// Cuthill-McKee) so that every neighbour lies within `bwb` rows of its row,
// with each vector row read from fast memory instead of device memory once
// per slot.  There the gather itself is a one-hot matrix product, the only
// gather that machine has; that is not carried over.  Here data, the offsets
// and the vectors stay in relabelled order for a whole sweep, and
//
//   - a thread block owns T consecutive relabelled sites x TK probe columns;
//   - it copies the window of vector rows [t*T - bwb, t*T + T + bwb) x 4
//     orbitals x TK columns into shared memory (rows outside [0, N) as
//     zeros), 16 bytes per load where K and TK are even, synchronises, and
//   - each thread takes its neighbours from shared memory by the per-(site,
//     slot) offset rel[n,s] = (relabelled column) - n, an int32 in
//     [-bwb, bwb]; INT_MIN marks a padding slot, which is skipped;
//   - then the same complex FMAs as ell_kernel in ell_spmm.cu.
//
// The Chebyshev form fuses the recursion tail and both reductions into the
// pass (the sweep is bound by bytes, so the unfused scan of the reference
// would move each vector three more times).  Its own t_cur entries come from
// the window too.  The reduction is a fixed tree in shared memory, no
// atomics: results repeat bit for bit.
//
// Bound: bytes, as for ell_spmm / ell_cheb_step with rel read in place of
// cols: the operator once, N*S offsets, t_cur (and t_prev) once, t_next once.
// What the window changes is the traffic between L2 and the SMs: each vector
// row crosses (1 + 2*bwb/T) times instead of S times, and never as a
// scattered 64-byte segment.
//
// Shared memory: (T + 2*bwb) window sites of (4*TK + pad) float2 each, pad = 2
// (16-byte loads) or 1, so that neighbouring window sites start in different
// banks; where the window and the step's reduction tree together pass 48 KB
// the launch raises the kernel's dynamic limit with cudaFuncSetAttribute.  The caller's plan picks T, TK and the thread count
// (a power of two up to 1024) so that the window fits 227 KB less the 8 KB of
// the reduction tree.  Columns beyond TK go to gridDim.y.
//
// Aliasing as in ell_spmm.cu: t_next must not alias t_cur (other blocks stage
// it); it may alias t_prev (each thread reads its own entries before writing).
// All element offsets are 64-bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int BLK = 4;
constexpr int BLK_FLOAT4 = 8;
constexpr int PAD_REL = INT_MIN;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB a block may use on sm_90

__device__ __forceinline__ void cfma(float2& acc, float dre, float dim, const float2& v) {
  acc.x = fmaf(dre, v.x, fmaf(-dim, v.y, acc.x));
  acc.y = fmaf(dre, v.y, fmaf(dim, v.x, acc.y));
}

template <bool CHEB, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
gather_kernel(const float4* __restrict__ data, const int* __restrict__ rel,
              const float2* __restrict__ t_cur, const float2* t_prev, float2* t_next,
              float* __restrict__ partials, float two_inv,
              long long N, int S, int K, int TK, int T, int bwb, int stride) {
  extern __shared__ float4 window4[];
  float2* win = reinterpret_cast<float2*>(window4);

  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const long long tile0 = (long long)blockIdx.x * T;
  const int k0 = blockIdx.y * TK;
  const int W = T + 2 * bwb;

  // Stage the window: element (w, b, kv) holds VEC columns of orbital b of
  // window site w; kv is the fastest index, so a warp reads whole segments.
  const int TKV = TK / VEC;
  const int per_site = BLK * TKV;
  for (int e = tid; e < W * per_site; e += threads) {
    const int w = e / per_site;
    const int r = e - w * per_site;
    const int b = r / TKV;
    const int kk = (r - b * TKV) * VEC;
    const long long g = tile0 - bwb + w;
    const bool inside = g >= 0 && g < N && k0 + kk < K;
    const size_t src = ((size_t)(inside ? g : 0) * BLK + b) * K + k0 + kk;
    float2* dst = win + (size_t)w * stride + b * TK + kk;
    if (VEC == 2) {
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (inside) val = __ldg(reinterpret_cast<const float4*>(t_cur + src));
      *reinterpret_cast<float4*>(dst) = val;
    } else {
      float2 val = make_float2(0.f, 0.f);
      if (inside) val = __ldg(t_cur + src);
      *dst = val;
    }
  }
  __syncthreads();

  const int kk = tid & (TK - 1);
  const int row = tid / TK;
  const int rows = threads / TK;
  const int k = k0 + kk;

  float cc = 0.f, nc = 0.f;
  if (k < K) {
    for (int i = row; i < T; i += rows) {
      const long long n = tile0 + i;
      if (n >= N) break;
      float2 acc[BLK];
#pragma unroll
      for (int a = 0; a < BLK; ++a) acc[a] = make_float2(0.f, 0.f);

      const int* rrow = rel + (size_t)n * S;
      const float4* drow = data + (size_t)n * S * BLK_FLOAT4;
      const float2* own = win + (size_t)(i + bwb) * stride + kk;
      for (int s = 0; s < S; ++s) {
        const int r = __ldg(rrow + s);
        if (r == PAD_REL) continue;  // padding slot
        const float2* vrow = own + (long long)r * stride;
        float2 vb[BLK];
#pragma unroll
        for (int b = 0; b < BLK; ++b) vb[b] = vrow[b * TK];
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
          const float2 c = own[a * TK];
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
  }

  if constexpr (CHEB) {
    __shared__ float s_cc[MAX_THREADS];
    __shared__ float s_nc[MAX_THREADS];
    s_cc[tid] = cc;
    s_nc[tid] = nc;
    __syncthreads();
    for (int h = rows / 2; h > 0; h >>= 1) {
      if (row < h) {
        s_cc[tid] += s_cc[tid + h * TK];
        s_nc[tid] += s_nc[tid + h * TK];
      }
      __syncthreads();
    }
    if (row == 0 && k < K) {
      float* out = partials + (size_t)blockIdx.x * 2 * K;
      out[k] = s_cc[tid];
      out[K + k] = s_nc[tid];
    }
  }
}

bool power_of_two(int v) { return v >= 1 && (v & (v - 1)) == 0; }

template <bool CHEB, int VEC>
int launch(const void* data, const void* rel, const void* t_cur, const void* t_prev, void* t_next,
           void* partials, float two_inv, long long N, int S, int K, int TK, int T, int bwb,
           int threads, int stride, size_t smem, cudaStream_t stream) {
  auto kernel = gather_kernel<CHEB, VEC>;
  // Without the opt-in a block gets 48 KB in all, and the step's reduction
  // tree is static shared memory on top of the window.
  const size_t tree = CHEB ? 2 * MAX_THREADS * sizeof(float) : 0;
  if (smem + tree > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((N + T - 1) / T), (unsigned)((K + TK - 1) / TK), 1);
  kernel<<<grid, threads, smem, stream>>>(
      (const float4*)data, (const int*)rel, (const float2*)t_cur, (const float2*)t_prev,
      (float2*)t_next, (float*)partials, two_inv, N, S, K, TK, T, bwb, stride);
  return (int)cudaGetLastError();
}

template <bool CHEB>
int dispatch(const void* data, const void* rel, const void* t_cur, const void* t_prev, void* t_next,
             void* partials, float two_inv, long long N, int S, int K, int TK, int T, int bwb,
             int threads, void* stream) {
  if (!power_of_two(TK) || TK > 32 || !power_of_two(threads) || threads > MAX_THREADS ||
      threads < TK || N < 0 || S < 1 || K < 1 || T < 1 || bwb < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int vec = (TK % 2 == 0 && K % 2 == 0) ? 2 : 1;
  const int stride = BLK * TK + vec;
  const size_t smem = (size_t)(T + 2 * (long long)bwb) * stride * sizeof(float2);
  if (smem + (CHEB ? 2 * MAX_THREADS * sizeof(float) : 0) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (vec == 2)
    return launch<CHEB, 2>(data, rel, t_cur, t_prev, t_next, partials, two_inv, N, S, K, TK, T, bwb,
                           threads, stride, smem, (cudaStream_t)stream);
  return launch<CHEB, 1>(data, rel, t_cur, t_prev, t_next, partials, two_inv, N, S, K, TK, T, bwb,
                         threads, stride, smem, (cudaStream_t)stream);
}

}  // namespace

// Both entry points launch on the given stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() (0 = launched).

extern "C" int ell_gather_spmm_launch(const void* data, const void* rel, const void* v, void* y,
                                      long long N, int S, int K, int TK, int T, int bwb,
                                      int threads, void* stream) {
  return dispatch<false>(data, rel, v, nullptr, y, nullptr, 0.f, N, S, K, TK, T, bwb, threads, stream);
}

extern "C" int ell_gather_cheb_step_launch(const void* data, const void* rel, const void* t_cur,
                                           const void* t_prev, void* t_next, void* partials,
                                           float inv, long long N, int S, int K, int TK, int T,
                                           int bwb, int threads, void* stream) {
  return dispatch<true>(data, rel, t_cur, t_prev, t_next, partials, 2.0f * inv, N, S, K, TK, T,
                        bwb, threads, stream);
}
