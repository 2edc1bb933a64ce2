// Chebyshev sweeps, and the power iteration, on the block-ELL operator in one
// launch (sm_90a).
//
//   ell_cheb_filter      y = sum_{m<M} c_m T_m(inv*H) v
//   ell_cheb_moments     the column sums <t_m,t_m>, <t_{m+1},t_m> of every step
//                        of the KPM doubled-moment recursion (template flag MOMENTS)
//   ell_power_iteration  the norms n_k = |w_k| of w_0 = H v, w_k = H w_{k-1} / n_{k-1}
//                        (a sibling kernel, ell_power_kernel: see below)
//
// by the three-term recursion t_0 = v, t_1 = inv*H t_0 (the first step
// half-scaled with t_prev = 0), t_{m+1} = 2*inv*H t_m - t_{m-1}; a zero
// coefficient adds nothing, and no partial sums are formed.
//
// It replaces the reference's whole filter scan, _filter_apply_packed
// (bodge_tpu/ops/lanczos.py:122-143): a lax.scan whose body is one fused
// Chebyshev step of bodge_tpu/ops/pallas_spmm.py (_flat_cheb_kernel, :468, and
// _plane_cheb_kernel, :1081; P2/P4) plus an axpy that XLA fuses, with nothing
// on the host between steps.  Run as a Python loop of ell_cheb_step launches
// (ell_spmm.cu) and torch axpys, a step at the filter's sizes (N = 1024 and
// 10 000 sites, 16-128 probe columns) costs the host's launch rate, not bytes.
//
// Bound: bytes a step, the same as ell_cheb_step's (ops/spmm.py:
// chebyshev_step_bytes): the operator once, t_cur and t_prev once, t_next
// once, over the device-memory rate; a step does about K real operations per
// operator byte, far below the card's ridge.  At 32x32 the whole working set
// (operator 0.66 MB, two vectors of at most 3.7 MB at K = 112) lies in the
// 50 MB L2, so the bound is a few microseconds a step, about what one launch
// costs: no design that launches once a step can come near it.
//
// What the design does about it:
//   - One cooperative launch a sweep (cudaLaunchCooperativeKernel), steps
//     separated by a grid-wide barrier (cooperative_groups::this_grid().sync()).
//     The grid is at most the blocks that fit the card at once (occupancy x
//     SMs); a launch the card cannot hold is refused, and the error returned.
//   - Each block owns SB consecutive sites and every probe column of them; a
//     thread owns fixed (site, column) pairs for the whole sweep, columns the
//     fastest index, pairs dense (pair p of the block = site_local*K + k).
//   - The block stages its sites' block rows (S blocks of 128 bytes, 64 in the
//     bf16 form, one 16-byte pad a site against bank conflicts) and column
//     indices into shared memory once a launch; every step reads the operator
//     from there.
//   - Register mode (REG, one pair a thread): t_prev, t_cur and the running
//     sum y of the thread's pair live in registers for the whole sweep and
//     reach memory once, y at the end.  Global mode (any number of pairs a
//     thread): t_prev is read from the buffer t_next is written to, and y is
//     the caller's output, read and written by the owning thread where the
//     step's coefficient is not zero.  Either way the axpy is fused.
//   - Coefficients are a float32 device array, uploaded once a sweep.
//
// Why one barrier a step is enough.  Two ping-pong buffers P0, P1: t_m lives
// in P[m % 2] for m >= 1 (t_0 is v, never written).  Step m gathers only t_m
// (v for m = 0) and writes t_{m+1} into P[(m + 1) % 2], only the entries of
// the writing thread's own pairs.  That buffer last held t_{m-1}, which step
// m - 1 gathered; the barrier between steps m - 1 and m orders every such
// gather before any write of step m.  Step m + 1 gathers t_{m+1} after the
// barrier between m and m + 1, which makes every write of step m visible.
// Nobody else reads t_prev: in register mode it is in the owner's registers;
// in global mode the owner reads its entries of t_{m-1} from P[(m + 1) % 2]
// (from v at m = 1) before it writes t_{m+1} over the same entries, in
// program order.  y is touched by its owner alone.  Vectors written in the
// launch are read with plain loads, never through the read-only path.
//
// Operator forms (template parameter OP, operator_form.cuh): complex64
// (float4) and the bf16 form (uint4, upcast to float32 on load).  The product
// is ell_kernel's of ell_spmm.cu, the same FMAs in the same order, so each
// t_m repeats the per-step kernel's bit for bit; y is accumulated as torch's
// axpy (acc.add_(t, alpha=c)) rounds it, the product and then the sum each
// rounded (__fmul_rn, __fadd_rn: never contracted into one FMA), so the sweep
// repeats the per-step path's result bit for bit, and the solver that adapts
// its filter to it takes the same rounds.
//
// The moment sweep (MOMENTS, beside OP and REG as HALO is in ell_spmm.cu) is
// the reference's moments_pallas_fused scan (bodge_tpu/ops/pallas_spmm.py:
// 1547-1582) over the same fused step: the half-scaled first step (t_prev = 0)
// and ceil((order - 2) / 2) full ones, M - 1 steps in all.  The same staged
// rows, pair ownership, ping-pong buffers and one barrier a step; the axpy
// into y is replaced by the step's two column sums of the owned pairs,
// Re<t_m,t_m> and Re<t_{m+1},t_m> (ell_kernel's FMAs), which each block
// reduces over its sites in a fixed tree in shared memory (no atomics) and
// writes as row (m, block) of a [M - 1, grid, 2K] float32 buffer.  No
// partial is read inside the launch, so no second barrier is needed; the
// caller sums the rows over the grid after it.  The t_m are the per-step
// kernel's bit for bit; the sums differ from its partials in order only.
//
// The power iteration (ell_power_kernel, complex64 operator, one column) is
// the reference's _power_iteration scan (bodge_tpu/ops/chebyshev.py:134-141:
// spmm, norm and division a step, the spmm the Pallas product of
// pallas_spmm.py:440 / :985, P1/P3), which a host loop runs as three
// dependent launches an iteration: at 10^3-10^4 sites each costs the host's
// launch rate, some 20-50 us, against a byte bound of a few us.  The kernel
// shares the filter's staging and its grid (the plan differs only in the
// few bytes a block reduces in).  Step k gathers w_{k-1} (v at k = 0, which
// the caller normalised), divides the product by n_{k-1} and writes w_k into
// P[k % 2]: the same ping-pong and one grid barrier a step as above.  The norm
// needs a grid-wide sum inside the launch without a second barrier: each
// block sums |w_k|^2 of its sites in a fixed tree (a thread's sites in order,
// then warp shuffles, then the eight warps in order) and writes it to row
// (k, block) of an [iters, grid] buffer; after the barrier that ends step k
// every block sums row k over the grid in the same fixed tree, so every block
// divides by the same n_k bit for bit.  No atomics: a second call repeats the
// result bit for bit.  The caller reads n_{iters-1} from the last row.
// Dividing H w_{k-1} rather than w_{k-1} by n_{k-1} moves each w_k by a
// rounding; the products are ell_kernel's FMAs.  A step is bound by the
// grid barrier at these sizes: the operator sits in shared memory and the
// vector (at most 1.3 MB) in L2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "operator_form.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;  // at most 64 registers a thread
constexpr int BLK = 4;            // 4x4 blocks: Nambu x spin
constexpr int WARPS = THREADS / 32;

// The kernels of this file, as the occupancy entry point names them.
enum Sweep : int { SWEEP_FILTER = 0, SWEEP_MOMENTS = 1, SWEEP_POWER = 2 };

struct Args {
  const void* data;       // [N, S, 4, 4] complex64 or [N, S, 4, 4, 2] bf16
  const int* cols;        // [N, S], negative = padding
  const float2* v;        // [N, 4, K], t_0
  const float* coeffs;    // [M] (the filter only)
  float2* p0;             // [N, 4, K] scratch: t_m for even m >= 2 (power: w_k for even k)
  float2* p1;             // [N, 4, K] scratch: t_m for odd m (power: w_k for odd k)
  float2* y;              // [N, 4, K] the result (the filter only)
  float* partials;        // [M - 1, grid, 2K] (the moment sweep), [M - 1, grid] (the power iteration)
  float inv;
  int M;                  // vectors of the sweep: steps + 1
  long long N;
  int S, K, SB;
};

// Bytes of shared memory a block of SB sites takes; the moment sweep adds its
// reduction buffer, two floats a pair, the power iteration one float a warp.
size_t smem_bytes(int bf16, int SB, int S, int K, int sweep) {
  const int per = bf16 ? opform::Op<uint4>::PER_BLOCK : opform::Op<float4>::PER_BLOCK;
  const size_t extra = sweep == SWEEP_MOMENTS ? (size_t)2 * SB * K * sizeof(float)
                                        : sweep == SWEEP_POWER ? (size_t)WARPS * sizeof(float) : 0;
  return (size_t)SB * (S * per + 1) * 16 + (size_t)SB * S * sizeof(int) + extra;
}

// A block's sites staged in shared memory: their block rows (stride OP units
// a site, the last a pad) and column indices; `tail` is where the kernel's own
// buffer begins.
template <typename OP>
struct Staged {
  OP* op;
  int* cols;
  float* tail;
  int stride;
  long long site0;
  int sites;
};

template <typename OP>
__device__ __forceinline__ Staged<OP> stage_sites(const Args& a, uint4* smem) {
  constexpr int PER = opform::Op<OP>::PER_BLOCK;
  const int S = a.S;
  Staged<OP> st;
  st.stride = S * PER + 1;
  st.op = reinterpret_cast<OP*>(smem);
  st.cols = reinterpret_cast<int*>(st.op + (size_t)a.SB * st.stride);
  st.tail = reinterpret_cast<float*>(st.cols + (size_t)a.SB * S);
  st.site0 = (long long)blockIdx.x * a.SB;
  st.sites = (int)min((long long)a.SB, a.N - st.site0);
  const OP* g_op = reinterpret_cast<const OP*>(a.data) + (size_t)st.site0 * S * PER;
  for (int i = threadIdx.x; i < st.sites * S * PER; i += THREADS) {
    const int site = i / (S * PER);
    st.op[site * st.stride + (i - site * S * PER)] = __ldg(g_op + i);
  }
  for (int i = threadIdx.x; i < st.sites * S; i += THREADS) st.cols[i] = __ldg(a.cols + (size_t)st.site0 * S + i);
  __syncthreads();
  return st;
}

__device__ __forceinline__ void cfma(float2& acc, float dre, float dim, const float2& v) {
  acc.x = fmaf(dre, v.x, fmaf(-dim, v.y, acc.x));
  acc.y = fmaf(dre, v.y, fmaf(dim, v.x, acc.y));
}

// acc + c*x as torch's add_(x, alpha=c) rounds it: the product, then the sum.
__device__ __forceinline__ float2 axpy(const float2& acc, float c, const float2& x) {
  return make_float2(__fadd_rn(acc.x, __fmul_rn(c, x.x)), __fadd_rn(acc.y, __fmul_rn(c, x.y)));
}

// Row a of a block staged in shared memory, as four complex entries.
__device__ __forceinline__ void shared_row(const float4* blk, int a, float2 (&d)[4]) {
  const float4 d01 = blk[2 * a];
  const float4 d23 = blk[2 * a + 1];
  d[0] = make_float2(d01.x, d01.y);
  d[1] = make_float2(d01.z, d01.w);
  d[2] = make_float2(d23.x, d23.y);
  d[3] = make_float2(d23.z, d23.w);
}

__device__ __forceinline__ void shared_row(const uint4* blk, int a, float2 (&d)[4]) {
  const uint4 q = blk[a];
  d[0] = opform::bf16_pair(q.x);
  d[1] = opform::bf16_pair(q.y);
  d[2] = opform::bf16_pair(q.z);
  d[3] = opform::bf16_pair(q.w);
}

// (H t)[n, :, k] of one pair from the staged block rows and column indices of
// its site; t is read with plain loads (it may have been written in this launch).
template <typename OP>
__device__ __forceinline__ void product(const OP* s_site, const int* s_col, const float2* t, int S, int K,
                                        int k, float2 (&acc)[BLK]) {
#pragma unroll
  for (int a = 0; a < BLK; ++a) acc[a] = make_float2(0.f, 0.f);
  for (int s = 0; s < S; ++s) {
    const int col = s_col[s];
    if (col < 0) continue;  // padding slot
    const float2* vrow = t + (size_t)col * BLK * K + k;
    float2 vb[BLK];
#pragma unroll
    for (int b = 0; b < BLK; ++b) vb[b] = vrow[(size_t)b * K];
    const OP* blk = s_site + s * opform::Op<OP>::PER_BLOCK;
#pragma unroll
    for (int a = 0; a < BLK; ++a) {
      float2 d[BLK];
      shared_row(blk, a, d);
      cfma(acc[a], d[0].x, d[0].y, vb[0]);
      cfma(acc[a], d[1].x, d[1].y, vb[1]);
      cfma(acc[a], d[2].x, d[2].y, vb[2]);
      cfma(acc[a], d[3].x, d[3].y, vb[3]);
    }
  }
}

// Step m's row of the moment sweep: the sums s_cc[p], s_nc[p] of the block's
// pairs p = site_local * K + k (written before the call) reduced over the
// block's sites in a fixed tree — level h adds site sl + h into site sl —
// then written by thread k.  Entries of sites beyond the block's are never
// read.  Ends before the row is written: the caller's grid barrier orders it
// before the next step's writes into the buffer.
__device__ __forceinline__ void block_column_sums(float* s_cc, float* s_nc, int sites, int K, float* row) {
  __syncthreads();
  int span = 1;
  while (span < sites) span <<= 1;
  for (int h = span >> 1; h > 0; h >>= 1) {
    for (int p = threadIdx.x; p < h * K; p += THREADS) {
      if (p / K + h < sites) {
        s_cc[p] += s_cc[p + h * K];
        s_nc[p] += s_nc[p + h * K];
      }
    }
    __syncthreads();
  }
  for (int k = threadIdx.x; k < K; k += THREADS) {
    row[k] = s_cc[k];
    row[K + k] = s_nc[k];
  }
}

// The two column sums of one entry of a pair, as ell_kernel forms them.
__device__ __forceinline__ void pair_sums(const float2& c, const float2& nx, float& cc, float& nc) {
  cc = fmaf(c.x, c.x, fmaf(c.y, c.y, cc));
  nc = fmaf(nx.x, c.x, fmaf(nx.y, c.y, nc));
}

// The sum of x over the block's threads, returned to every thread: warp
// shuffles, then the eight warps in order (a fixed tree: the same inputs give
// the same bits in every block).  Every thread calls it; s_warp holds WARPS
// floats.
__device__ __forceinline__ float block_sum(float x, float* s_warp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  __syncthreads();  // every thread has read the previous sum out of s_warp
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = x;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total += s_warp[w];
  return total;
}

template <typename OP, bool REG, bool MOMENTS>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) ell_filter_kernel(const Args a) {
  extern __shared__ uint4 smem[];  // 16-byte aligned
  const Staged<OP> st = stage_sites<OP>(a, smem);
  const int S = a.S, K = a.K;
  const int stride = st.stride;  // OP units a staged site
  const OP* s_op = st.op;
  const int* s_cols = st.cols;
  const long long site0 = st.site0;
  const int sites = st.sites;
  float* s_cc = st.tail;  // MOMENTS: [SB * K] each
  float* s_nc = s_cc + (size_t)a.SB * K;

  cg::grid_group grid = cg::this_grid();
  const int pairs = sites * K;
  const float two_inv = 2.0f * a.inv;
  float c0 = 0.f;
  if constexpr (!MOMENTS) c0 = __ldg(a.coeffs);

  if constexpr (REG) {
    const int p = threadIdx.x;
    const bool own = p < pairs;
    const int sl = own ? p / K : 0;
    const int k = p - sl * K;
    const size_t base = ((size_t)(site0 + sl) * BLK) * K + k;
    float2 prev[BLK], cur[BLK], sum[BLK];
#pragma unroll
    for (int r = 0; r < BLK; ++r) {
      cur[r] = own ? __ldg(a.v + base + (size_t)r * K) : make_float2(0.f, 0.f);
      prev[r] = make_float2(0.f, 0.f);
      if constexpr (!MOMENTS) sum[r] = make_float2(__fmul_rn(c0, cur[r].x), __fmul_rn(c0, cur[r].y));
    }
    for (int m = 0; m + 1 < a.M; ++m) {
      const float2* t = m == 0 ? a.v : ((m & 1) ? a.p1 : a.p0);
      float2* out = (m & 1) ? a.p0 : a.p1;
      float c = 0.f;
      if constexpr (!MOMENTS) c = __ldg(a.coeffs + m + 1);
      const float f = m == 0 ? a.inv : two_inv;
      float cc = 0.f, nc = 0.f;
      if (own) {
        float2 hv[BLK];
        product<OP>(s_op + sl * stride, s_cols + sl * S, t, S, K, k, hv);
#pragma unroll
        for (int r = 0; r < BLK; ++r) {
          float2 nx;
          nx.x = fmaf(f, hv[r].x, -prev[r].x);
          nx.y = fmaf(f, hv[r].y, -prev[r].y);
          out[base + (size_t)r * K] = nx;
          if constexpr (MOMENTS) {
            pair_sums(cur[r], nx, cc, nc);
          } else if (c != 0.f) {
            sum[r] = axpy(sum[r], c, nx);
          }
          prev[r] = cur[r];
          cur[r] = nx;
        }
      }
      if constexpr (MOMENTS) {
        if (own) {
          s_cc[p] = cc;
          s_nc[p] = nc;
        }
        block_column_sums(s_cc, s_nc, sites, K, a.partials + ((size_t)m * gridDim.x + blockIdx.x) * 2 * K);
      }
      if (m + 2 < a.M) grid.sync();
    }
    if (!MOMENTS && own) {
#pragma unroll
      for (int r = 0; r < BLK; ++r) a.y[base + (size_t)r * K] = sum[r];
    }
  } else {
    if constexpr (!MOMENTS) {
      for (int p = threadIdx.x; p < pairs; p += THREADS) {
        const int sl = p / K;
        const size_t base = ((size_t)(site0 + sl) * BLK) * K + (p - sl * K);
#pragma unroll
        for (int r = 0; r < BLK; ++r) {
          const float2 x = __ldg(a.v + base + (size_t)r * K);
          a.y[base + (size_t)r * K] = make_float2(__fmul_rn(c0, x.x), __fmul_rn(c0, x.y));
        }
      }
    }
    for (int m = 0; m + 1 < a.M; ++m) {
      const float2* t = m == 0 ? a.v : ((m & 1) ? a.p1 : a.p0);
      float2* out = (m & 1) ? a.p0 : a.p1;
      const float2* prev = m == 1 ? a.v : out;  // m >= 2: t_{m-1}'s own entries, overwritten below
      float c = 0.f;
      if constexpr (!MOMENTS) c = __ldg(a.coeffs + m + 1);
      const float f = m == 0 ? a.inv : two_inv;
      for (int p = threadIdx.x; p < pairs; p += THREADS) {
        const int sl = p / K;
        const int k = p - sl * K;
        const size_t base = ((size_t)(site0 + sl) * BLK) * K + k;
        float2 hv[BLK];
        product<OP>(s_op + sl * stride, s_cols + sl * S, t, S, K, k, hv);
        float cc = 0.f, nc = 0.f;
#pragma unroll
        for (int r = 0; r < BLK; ++r) {
          const size_t o = base + (size_t)r * K;
          float2 pr = make_float2(0.f, 0.f);
          if (m > 0) pr = prev[o];  // read before the write below
          float2 nx;
          nx.x = fmaf(f, hv[r].x, -pr.x);
          nx.y = fmaf(f, hv[r].y, -pr.y);
          if constexpr (MOMENTS) pair_sums(t[o], nx, cc, nc);  // the owner's own entries of t_m
          out[o] = nx;
          if constexpr (!MOMENTS) {
            if (c != 0.f) a.y[o] = axpy(a.y[o], c, nx);
          }
        }
        if constexpr (MOMENTS) {
          s_cc[p] = cc;
          s_nc[p] = nc;
        }
      }
      if constexpr (MOMENTS)
        block_column_sums(s_cc, s_nc, sites, K, a.partials + ((size_t)m * gridDim.x + blockIdx.x) * 2 * K);
      if (m + 2 < a.M) grid.sync();
    }
  }
}

// The power iteration (see the top of the file): M - 1 steps on the complex64
// operator, K = 1, a thread's sites p, p + THREADS, ... of its block.  Nothing
// of a site carries over between steps in registers, so the plan's two modes
// differ only in the sites a block.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) ell_power_kernel(const Args a) {
  extern __shared__ uint4 smem[];  // 16-byte aligned
  const Staged<float4> st = stage_sites<float4>(a, smem);
  float* s_warp = st.tail;  // [WARPS]
  cg::grid_group grid = cg::this_grid();
  const int S = a.S;
  const int steps = a.M - 1;
  float norm = 1.f;  // of v: the caller normalised it
  for (int m = 0; m < steps; ++m) {
    const float2* w = m == 0 ? a.v : ((m & 1) ? a.p0 : a.p1);  // w_{m-1}, written in the last step
    float2* out = (m & 1) ? a.p1 : a.p0;
    if (m > 0) {  // n_{m-1} from row m - 1, summed in the same order by every block
      const float* row = a.partials + (size_t)(m - 1) * gridDim.x;
      float x = 0.f;
      for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS) x += row[b];
      norm = sqrtf(block_sum(x, s_warp));
    }
    float sq = 0.f;
    for (int p = threadIdx.x; p < st.sites; p += THREADS) {
      float2 hv[BLK];
      product<float4>(st.op + p * st.stride, st.cols + p * S, w, S, 1, 0, hv);
      float2* o = out + (size_t)(st.site0 + p) * BLK;
#pragma unroll
      for (int r = 0; r < BLK; ++r) {
        const float2 x = make_float2(hv[r].x / norm, hv[r].y / norm);
        o[r] = x;
        sq = fmaf(x.x, x.x, fmaf(x.y, x.y, sq));
      }
    }
    const float total = block_sum(sq, s_warp);
    if (threadIdx.x == 0) a.partials[(size_t)m * gridDim.x + blockIdx.x] = total;
    if (m + 1 < steps) grid.sync();
  }
}

template <typename OP, bool REG, bool MOMENTS>
void* kernel_of() {
  return reinterpret_cast<void*>(&ell_filter_kernel<OP, REG, MOMENTS>);
}

template <bool MOMENTS>
void* pick(int bf16, int registers) {
  if (bf16) return registers ? kernel_of<uint4, true, MOMENTS>() : kernel_of<uint4, false, MOMENTS>();
  return registers ? kernel_of<float4, true, MOMENTS>() : kernel_of<float4, false, MOMENTS>();
}

// The kernel of a sweep kind and form; nullptr where none is built (the power
// iteration has no bf16 form).
void* pick_sweep(int sweep, int bf16, int registers) {
  if (sweep == SWEEP_POWER) return bf16 ? nullptr : reinterpret_cast<void*>(&ell_power_kernel);
  return sweep == SWEEP_MOMENTS ? pick<true>(bf16, registers) : pick<false>(bf16, registers);
}

cudaError_t allow_smem(void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int occupancy(int sweep, int bf16, int registers, int SB, int S, int K, int* blocks, long long* smem) {
  if (sweep < SWEEP_FILTER || sweep > SWEEP_POWER || SB < 1 || S < 1 || K < 1 || blocks == nullptr || smem == nullptr)
    return (int)cudaErrorInvalidValue;
  void* kernel = pick_sweep(sweep, bf16, registers);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  *smem = (long long)smem_bytes(bf16, SB, S, K, sweep);
  cudaError_t err = allow_smem(kernel, (size_t)*smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, (size_t)*smem);
}

int launch(const Args& args, int sweep, int bf16, int registers, void* stream) {
  const long long N = args.N;
  const int S = args.S, K = args.K, SB = args.SB;
  if (N < 1 || S < 1 || K < 1 || args.M < (sweep == SWEEP_FILTER ? 1 : 2) || SB < 1 ||
      (registers && (long long)SB * K > THREADS) || (sweep == SWEEP_POWER && K != 1))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (N + SB - 1) / SB;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  void* kernel = pick_sweep(sweep, bf16, registers);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(bf16, SB, S, K, sweep);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  Args copy = args;
  void* params[] = {&copy};
  err = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)blocks), dim3(THREADS), params, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the filter kernel (sweep == 0), the moment kernel (1) or the
// power kernel (2, complex64 only) one SM holds at the dynamic shared memory a
// block of SB sites takes (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// and those bytes: what the caller's plan sizes the grid with.  K counts only
// for the moment kernel, whose reduction buffer grows with it.
extern "C" int ell_cheb_sweep_occupancy(int sweep, int bf16, int registers, int SB, int S, int K, int* blocks,
                                        long long* smem) {
  return occupancy(sweep, bf16, registers, SB, S, sweep == SWEEP_MOMENTS ? K : 1, blocks, smem);
}

// One sweep: ceil(N / SB) blocks of THREADS threads, each SB sites, on the
// given stream; the coefficients, p0, p1 and y are the caller's device
// buffers (p0 unused when M <= 2, p1 when M == 1).  `registers` != 0 asks for
// register mode, which needs SB * K <= THREADS.  Does not synchronise,
// allocates nothing, returns the launch's error (0 = launched):
// cudaErrorCooperativeLaunchTooLarge where the card cannot hold the grid.
extern "C" int ell_cheb_filter_launch(const void* data, int bf16, const void* cols, const void* v,
                                      const void* coeffs, int M, float inv, void* p0, void* p1, void* y,
                                      long long N, int S, int K, int SB, int registers, void* stream) {
  const Args args = {data, (const int*)cols, (const float2*)v, (const float*)coeffs, (float2*)p0, (float2*)p1,
                     (float2*)y, nullptr, inv, M, N, S, K, SB};
  return launch(args, SWEEP_FILTER, bf16, registers, stream);
}

// One moment sweep of `steps` >= 1 fused steps (the half-scaled first one
// included), as the filter's launch: p0 and p1 are scratch vectors (p0 unused
// when steps == 1), `partials` the caller's [steps, ceil(N / SB), 2K]
// float32 buffer, every entry of which is written.
extern "C" int ell_cheb_moments_launch(const void* data, int bf16, const void* cols, const void* v, int steps,
                                       float inv, void* p0, void* p1, void* partials, long long N, int S, int K,
                                       int SB, int registers, void* stream) {
  const Args args = {data, (const int*)cols, (const float2*)v, nullptr, (float2*)p0, (float2*)p1,
                     nullptr, (float*)partials, inv, steps + 1, N, S, K, SB};
  return launch(args, SWEEP_MOMENTS, bf16, registers, stream);
}

// One power iteration of `iters` >= 1 steps on the complex64 operator from v
// ([N, 4, 1], normalised), as the sweeps above: p0 and p1 are scratch vectors
// (p1 unused when iters == 1), `partials` the caller's [iters, ceil(N / SB)]
// float32 buffer, every entry of which is written: row k holds the blocks'
// sums of |w_k|^2, so n_{iters-1} is the square root of the last row's sum.
extern "C" int ell_power_iteration_launch(const void* data, const void* cols, const void* v, int iters, void* p0,
                                          void* p1, void* partials, long long N, int S, int SB, void* stream) {
  const Args args = {data, (const int*)cols, (const float2*)v, nullptr, (float2*)p0, (float2*)p1,
                     nullptr, (float*)partials, 1.f, iters + 1, N, S, 1, SB};
  return launch(args, SWEEP_POWER, 0, 0, stream);
}
