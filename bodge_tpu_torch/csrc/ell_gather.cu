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
//   - the grid is one wave: a thread block per SM and column tile (TK probe
//     columns), each owning a contiguous run of `run` relabelled rows, which
//     it walks in tiles of T rows;
//   - shared memory holds a ring of R = 2*bwb + (D + 1)*T vector rows.  Tile
//     t needs the window [a - bwb, a + T + bwb) (a its first row); moving to
//     the next tile brings in only the T rows past the window's end.  Those of
//     the D tiles after this one are in flight while this one is computed:
//     cp.async copies (16 bytes where K and TK are even, else 8) to padded
//     addresses, one commit group a tile, cp.async.wait_group, one barrier a
//     tile.  Rows outside [0, N) are never read and never copied;
//   - each thread takes its neighbours from the ring by the per-(site, slot)
//     offset rel[n,s] = (relabelled column) - n, an int32 in [-bwb, bwb];
//     INT_MIN marks a padding slot, which is skipped;
//   - then the same complex FMAs as ell_kernel in ell_spmm.cu.
//
// The Chebyshev form fuses the recursion tail and both reductions into the
// pass (the sweep is bound by bytes, so the unfused scan of the reference
// would move each vector three more times).  Its own t_cur entries come from
// the ring too.  Each thread keeps its column's two sums in registers over
// all its tiles; one fixed tree in shared memory at the end writes one row of
// partials per thread block, no atomics: results repeat bit for bit.
//
// Bound: bytes, as for ell_spmm / ell_cheb_step with rel read in place of
// cols: the operator once, N*S offsets, t_cur (and t_prev) once, t_next once.
// What the design does about it: a block copies its run plus 2*bwb rows once
// (the window slides, it is not re-staged), so each vector row crosses
// L2 -> SM about (1 + 2*bwb/run) times, never as a scattered 64-byte
// segment, and the copies of the next tiles overlap this tile's arithmetic.
// At K > TK the column tiles of one run are resident side by side, so the
// operator's and the offsets' second reads come from L2.
//
// Shared memory: R ring rows of (4*TK + pad) float2 each, pad = 2 (16-byte
// copies) or 1, so that neighbouring rows start in different banks; the
// reduction tree reuses it at the end.  The caller's plan (ops/cuda_gather)
// picks T, TK, D, the run and the thread count (a power of two up to 1024)
// so that the ring fits 227 KB.  Columns beyond TK go to gridDim.y.
//
// Aliasing as in ell_spmm.cu: t_next must not alias t_cur (other blocks stage
// it); it may alias t_prev (each thread reads its own entries before writing).
// All element offsets are 64-bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_DEPTH = 2;  // tiles in flight
constexpr int BLK = 4;
constexpr int BLK_FLOAT4 = 8;
constexpr int PAD_REL = INT_MIN;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB a block may use on sm_90

// The operator's shape and the launch plan.
struct Plan {
  long long N;
  int S, K, TK, T, bwb, D, R;
  long long run;
};

__device__ __forceinline__ void cfma(float2& acc, float dre, float dim, const float2& v) {
  acc.x = fmaf(dre, v.x, fmaf(-dim, v.y, acc.x));
  acc.y = fmaf(dre, v.y, fmaf(dim, v.x, acc.y));
}

__device__ __forceinline__ void copy_async(float2* dst, const float2* src, bool sixteen) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (sixteen)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_group() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most `pending` of this thread's commit groups are in flight.
__device__ __forceinline__ void wait_groups(int pending) {
  if (pending <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

template <bool CHEB, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
gather_kernel(const float4* __restrict__ data, const int* __restrict__ rel,
              const float2* __restrict__ t_cur, const float2* t_prev, float2* t_next,
              float* __restrict__ partials, float two_inv, Plan pl) {
  extern __shared__ float4 ring4[];
  float2* ring = reinterpret_cast<float2*>(ring4);

  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lg_tk = __ffs(pl.TK) - 1;
  const int kk = tid & (pl.TK - 1);
  const int row = tid >> lg_tk;
  const int rows = threads >> lg_tk;
  const int k0 = blockIdx.y * pl.TK;
  const int k = k0 + kk;
  const int K = pl.K, S = pl.S, T = pl.T, bwb = pl.bwb, D = pl.D, R = pl.R;
  const long long N = pl.N;
  const int stride = BLK * pl.TK + VEC;  // float2 a ring row (VEC of padding)
  const int lg_tkv = lg_tk - (VEC == 2 ? 1 : 0);
  const int lg_site = lg_tkv + 2;  // log2 of the copies a row: 4 orbitals x TK/VEC

  const long long r0 = (long long)blockIdx.x * pl.run;
  const long long r1 = min(r0 + pl.run, N);
  const long long base = r0 - bwb;        // global row g sits in ring row (g - base) mod R
  const long long hi = min(N, r1 + bwb);  // rows past this are never read
  const int tiles = (int)((r1 - r0 + T - 1) / T);

  // Issue the copies of rows [g_lo, g_hi) (clipped to [0, hi)) into the ring;
  // the caller commits the group.  At most R rows, so one wrap of the ring.
  auto stage = [&](long long g_lo, long long g_hi) {
    g_lo = max(g_lo, 0LL);
    g_hi = min(g_hi, hi);
    if (g_lo >= g_hi) return;
    const int q0 = (int)((g_lo - base) % R);
    const float2* src = t_cur + (size_t)g_lo * BLK * K + k0;
    const int count = (int)(g_hi - g_lo) << lg_site;
    for (int e = tid; e < count; e += threads) {
      const int w = e >> lg_site;
      const int r = e & ((1 << lg_site) - 1);
      const int b = r >> lg_tkv;
      const int c = (r & ((1 << lg_tkv) - 1)) * VEC;
      if (k0 + c >= K) continue;  // columns past K are never read
      int q = q0 + w;
      q -= q >= R ? R : 0;
      copy_async(ring + (size_t)q * stride + b * pl.TK + c, src + ((size_t)w * BLK + b) * K + c, VEC == 2);
    }
  };
  // The rows tile t adds to the window of tile t - 1 (t >= 1).
  auto stage_tile = [&](int t) {
    if (t < tiles) stage(r0 + (long long)t * T + bwb, r0 + (long long)(t + 1) * T + bwb);
    commit_group();  // empty groups keep the count of groups in flight uniform
  };

  stage(r0 - bwb, r0 + T + bwb);  // the window of tile 0
  commit_group();
  for (int t = 1; t < D; ++t) stage_tile(t);

  float cc = 0.f, nc = 0.f;
  int qa = bwb;  // ring row of the tile's first row
  for (int t = 0; t < tiles; ++t) {
    if (D == 0) {
      if (t > 0) {
        __syncthreads();  // every thread is done with tile t - 1
        stage_tile(t);
      }
      wait_groups(0);
    } else {
      wait_groups(D - 1);  // tile t has landed (this thread's copies)
    }
    __syncthreads();  // ... everyone's; and every thread is done with tile t - 1
    if (D > 0) stage_tile(t + D);

    const long long a = r0 + (long long)t * T;
    const int Te = (int)min((long long)T, r1 - a);
    if (k < K) {
      for (int i = row; i < Te; i += rows) {
        const long long n = a + i;
        int qn = qa + i;
        qn -= qn >= R ? R : 0;
        const size_t base_o = (size_t)n * BLK * K + k;

        float2 pv[BLK];
        if (CHEB) {
#pragma unroll
          for (int a2 = 0; a2 < BLK; ++a2)  // read before the write below
            pv[a2] = t_prev != nullptr ? t_prev[base_o + (size_t)a2 * K] : make_float2(0.f, 0.f);
        }
        float2 acc[BLK];
#pragma unroll
        for (int a2 = 0; a2 < BLK; ++a2) acc[a2] = make_float2(0.f, 0.f);

        const int* rrow = rel + (size_t)n * S;
        const float4* drow = data + (size_t)n * S * BLK_FLOAT4;
#pragma unroll 4
        for (int s = 0; s < S; ++s) {
          // The block's loads come first and unconditionally (a padding
          // slot's block is allocated too), so that the compiler can keep the
          // loads of several slots in flight.
          const float4* blk = drow + (size_t)s * BLK_FLOAT4;
          float4 d[2 * BLK];
#pragma unroll
          for (int e = 0; e < 2 * BLK; ++e) d[e] = __ldg(blk + e);
          const int r = __ldg(rrow + s);
          if (r == PAD_REL) continue;  // padding slot
          int q = qn + r;
          q += q < 0 ? R : 0;
          q -= q >= R ? R : 0;
          const float2* vrow = ring + (size_t)q * stride + kk;
          float2 vb[BLK];
#pragma unroll
          for (int b = 0; b < BLK; ++b) vb[b] = vrow[b * pl.TK];
#pragma unroll
          for (int a2 = 0; a2 < BLK; ++a2) {
            const float4 d01 = d[2 * a2];      // entries (a,0), (a,1)
            const float4 d23 = d[2 * a2 + 1];  // entries (a,2), (a,3)
            cfma(acc[a2], d01.x, d01.y, vb[0]);
            cfma(acc[a2], d01.z, d01.w, vb[1]);
            cfma(acc[a2], d23.x, d23.y, vb[2]);
            cfma(acc[a2], d23.z, d23.w, vb[3]);
          }
        }

        const float2* own = ring + (size_t)qn * stride + kk;
#pragma unroll
        for (int a2 = 0; a2 < BLK; ++a2) {
          const size_t o = base_o + (size_t)a2 * K;
          if (CHEB) {
            const float2 c = own[a2 * pl.TK];
            float2 nx;
            nx.x = fmaf(two_inv, acc[a2].x, -pv[a2].x);
            nx.y = fmaf(two_inv, acc[a2].y, -pv[a2].y);
            t_next[o] = nx;
            cc = fmaf(c.x, c.x, fmaf(c.y, c.y, cc));
            nc = fmaf(nx.x, c.x, fmaf(nx.y, c.y, nc));
          } else {
            t_next[o] = acc[a2];
          }
        }
      }
    }
    qa += T;
    qa -= qa >= R ? R : 0;
  }

  if constexpr (CHEB) {
    wait_groups(0);
    __syncthreads();  // the ring is free: the tree reuses it
    float* s_cc = reinterpret_cast<float*>(ring4);
    float* s_nc = s_cc + threads;
    s_cc[tid] = cc;
    s_nc[tid] = nc;
    __syncthreads();
    for (int h = rows / 2; h > 0; h >>= 1) {
      if (row < h) {
        s_cc[tid] += s_cc[tid + (h << lg_tk)];
        s_nc[tid] += s_nc[tid + (h << lg_tk)];
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
           void* partials, float two_inv, const Plan& pl, int threads, int ctas, size_t smem,
           cudaStream_t stream) {
  auto kernel = gather_kernel<CHEB, VEC>;
  // Without the opt-in a block gets 48 KB; one block an SM is planned, so the
  // carveout gives shared memory all it can take.
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ctas, (unsigned)((pl.K + pl.TK - 1) / pl.TK), 1);
  kernel<<<grid, threads, smem, stream>>>((const float4*)data, (const int*)rel, (const float2*)t_cur,
                                          (const float2*)t_prev, (float2*)t_next, (float*)partials,
                                          two_inv, pl);
  return (int)cudaGetLastError();
}

template <bool CHEB>
int dispatch(const void* data, const void* rel, const void* t_cur, const void* t_prev, void* t_next,
             void* partials, float two_inv, long long N, int S, int K, int TK, int T, int bwb, int D,
             long long run, int ctas, int threads, void* stream) {
  if (!power_of_two(TK) || TK > 32 || !power_of_two(threads) || threads > MAX_THREADS ||
      threads < TK || N < 0 || S < 1 || K < 1 || T < 1 || bwb < 0 || D < 0 || D > MAX_DEPTH ||
      run < 1 || ctas < 0 || ctas != (N + run - 1) / run)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int vec = (TK % 2 == 0 && K % 2 == 0) ? 2 : 1;
  const int stride = BLK * TK + vec;
  const long long R = 2 * (long long)bwb + (long long)(D + 1) * T;
  size_t smem = (size_t)R * stride * sizeof(float2);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (CHEB && smem < 2 * threads * sizeof(float)) smem = 2 * threads * sizeof(float);  // the tree
  const Plan pl{N, S, K, TK, T, bwb, D, (int)R, run};
  if (vec == 2)
    return launch<CHEB, 2>(data, rel, t_cur, t_prev, t_next, partials, two_inv, pl, threads, ctas, smem,
                           (cudaStream_t)stream);
  return launch<CHEB, 1>(data, rel, t_cur, t_prev, t_next, partials, two_inv, pl, threads, ctas, smem,
                         (cudaStream_t)stream);
}

}  // namespace

// Both entry points launch on the given stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() (0 = launched).  The plan
// (ops/cuda_gather.plan_gather): TK probe columns and `run` rows a block,
// ctas = ceil(N / run) blocks a column tile, tiles of T rows, D tiles in
// flight (0 <= D <= MAX_DEPTH), `threads` a block; the step's partials are
// ctas rows of 2K floats.

extern "C" int ell_gather_spmm_launch(const void* data, const void* rel, const void* v, void* y,
                                      long long N, int S, int K, int TK, int T, int bwb, int D,
                                      long long run, int ctas, int threads, void* stream) {
  return dispatch<false>(data, rel, v, nullptr, y, nullptr, 0.f, N, S, K, TK, T, bwb, D, run, ctas,
                         threads, stream);
}

extern "C" int ell_gather_cheb_step_launch(const void* data, const void* rel, const void* t_cur,
                                           const void* t_prev, void* t_next, void* partials,
                                           float inv, long long N, int S, int K, int TK, int T,
                                           int bwb, int D, long long run, int ctas, int threads,
                                           void* stream) {
  return dispatch<true>(data, rel, t_cur, t_prev, t_next, partials, 2.0f * inv, N, S, K, TK, T,
                        bwb, D, run, ctas, threads, stream);
}
