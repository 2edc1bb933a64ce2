// Tiled fused Chebyshev step for stencil (cubic-lattice) skeletons, 4x4
// complex64 blocks (sm_90a).
//
//   stencil_cheb_step_tiled  t_next = 2*inv*(H t_cur) - t_prev, written out, plus
//                            per-tile partial sums, per probe column k, of
//                            Re<t_cur,t_cur> and Re<t_next,t_cur>.
//
// It replaces the lane-tiled plane kernel of bodge_tpu/ops/pallas_spmm.py
// (_plane_cheb_kernel_tiled under _plane_cheb_step_tiled, the opt-in
// BODGE_PLANE_TILED=1 form of the plane-layout step).  What that kernel
// computes: the same function as the untiled step, with a tile of the lattice
// (8 x-planes by a chunk of in-plane sites) and its halo held in fast memory
// and the neighbours found by stencil arithmetic instead of an index table.
//
// Here a thread block owns a tile of XB x-rows by PB in-plane sites (in-plane
// index p = y*Lz + z) by TK probe columns.  It stages t_cur for the rectangle
// of (XB + 2) x-rows by (PB + 2h) in-plane sites around the tile into shared
// memory once, every index taken modulo the lattice (x modulo Lx, p modulo
// Ly*Lz), with h = Lz where the lattice extends in y and Lz - 1 otherwise.
// Modular staging makes the periodic links plain offsets in the window:
//   x +- 1  ->  one window row up or down (the wrap row was staged there);
//   y +- 1  ->  p +- Lz (p + Lz modulo Ly*Lz is the wrapped site);
//   z +- 1  ->  p +- 1, or p -+ (Lz - 1) at the ends of a z-run.
// It reads no `cols`.  Open boundaries need nothing special: their wrap blocks
// hold zeros, as in every other product of the package.  The only slots that
// are skipped are those the skeleton marks as padding everywhere: the -1 slot
// of an axis of extent 2, whose neighbour is the +1 slot's (the table passed
// in says so with axis = -2).  The operator blocks are broadcast loads from
// device memory as in ell_spmm.cu; the tail and the reduction are the same,
// with one row of partials per tile (fixed tree, no atomics, bit-equal
// repeats).
//
// Bound: bytes, with no index table at all: the operator once, t_cur and
// t_prev once, t_next once.  What the tile changes is the traffic between L2
// and the SMs: each vector row crosses about (1 + halo/tile) times instead of
// S times.
//
// Aliasing as in ell_spmm.cu: t_next must not alias t_cur; it may alias
// t_prev.  All element offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;
constexpr int BLK = 4;
constexpr int BLK_FLOAT4 = 8;
constexpr int MAX_SLOTS = 8;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB a block may use on sm_90

// Per slot: the axis it shifts along (-1: the diagonal, -2: padding on every
// row, skipped) and the direction (+1 / -1).
struct SlotTable {
  int axis[MAX_SLOTS];
  int dir[MAX_SLOTS];
};

__device__ __forceinline__ void cfma(float2& acc, float dre, float dim, const float2& v) {
  acc.x = fmaf(dre, v.x, fmaf(-dim, v.y, acc.x));
  acc.y = fmaf(dre, v.y, fmaf(dim, v.x, acc.y));
}

__device__ __forceinline__ int wrap(long long v, int extent) {
  const int m = (int)(v % extent);
  return m < 0 ? m + extent : m;
}

template <int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
tiled_kernel(const float4* __restrict__ data, const float2* __restrict__ t_cur,
             const float2* t_prev, float2* t_next, float* __restrict__ partials, float two_inv,
             int Lx, int Ly, int Lz, int S, int K, int TK, int XB, int PB, int h, int stride,
             SlotTable slots) {
  extern __shared__ float4 window4[];
  float2* win = reinterpret_cast<float2*>(window4);

  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int M = Ly * Lz;
  const int p_tiles = (M + PB - 1) / PB;
  const int x0 = (blockIdx.x / p_tiles) * XB;
  const int p0 = (blockIdx.x % p_tiles) * PB;
  const int k0 = blockIdx.y * TK;
  const int WC = PB + 2 * h;
  const int sites = (XB + 2) * WC;

  const int TKV = TK / VEC;
  const int per_site = BLK * TKV;
  for (int e = tid; e < sites * per_site; e += threads) {
    const int w = e / per_site;
    const int r = e - w * per_site;
    const int b = r / TKV;
    const int kk = (r - b * TKV) * VEC;
    const int wr = w / WC;
    const int wc = w - wr * WC;
    const size_t g = (size_t)wrap((long long)x0 - 1 + wr, Lx) * M + wrap((long long)p0 - h + wc, M);
    const bool inside = k0 + kk < K;
    const size_t src = (g * BLK + b) * K + (inside ? k0 + kk : 0);
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
    for (int i = row; i < XB * PB; i += rows) {
      const int xi = i / PB;
      const int pi = i - xi * PB;
      const int x = x0 + xi;
      const int p = p0 + pi;
      if (x >= Lx || p >= M) continue;
      const size_t n = (size_t)x * M + p;
      const int z = p % Lz;

      float2 acc[BLK];
#pragma unroll
      for (int a = 0; a < BLK; ++a) acc[a] = make_float2(0.f, 0.f);

      const float4* drow = data + n * S * BLK_FLOAT4;
      const float2* own = win + (size_t)((xi + 1) * WC + pi + h) * stride + kk;
      for (int s = 0; s < S; ++s) {
        const int axis = slots.axis[s];
        if (axis == -2) continue;  // padding slot on every row
        const int d = slots.dir[s];
        int off = 0;  // in window sites
        if (axis == 0) {
          off = d * WC;
        } else if (axis == 1) {
          off = d * Lz;
        } else if (axis == 2) {
          const int zn = z + d;
          off = zn < 0 ? Lz - 1 : (zn >= Lz ? -(Lz - 1) : d);
        }
        const float2* vrow = own + (long long)off * stride;
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

      const size_t base = n * BLK * K + k;
#pragma unroll
      for (int a = 0; a < BLK; ++a) {
        const size_t o = base + (size_t)a * K;
        const float2 c = own[a * TK];
        float2 pv = make_float2(0.f, 0.f);
        if (t_prev != nullptr) pv = t_prev[o];  // read before the write below
        float2 nx;
        nx.x = fmaf(two_inv, acc[a].x, -pv.x);
        nx.y = fmaf(two_inv, acc[a].y, -pv.y);
        t_next[o] = nx;
        cc = fmaf(c.x, c.x, fmaf(c.y, c.y, cc));
        nc = fmaf(nx.x, c.x, fmaf(nx.y, c.y, nc));
      }
    }
  }

  __shared__ float s_cc[MAX_THREADS];
  __shared__ float s_nc[MAX_THREADS];
  s_cc[tid] = cc;
  s_nc[tid] = nc;
  __syncthreads();
  for (int hh = rows / 2; hh > 0; hh >>= 1) {
    if (row < hh) {
      s_cc[tid] += s_cc[tid + hh * TK];
      s_nc[tid] += s_nc[tid + hh * TK];
    }
    __syncthreads();
  }
  if (row == 0 && k < K) {
    float* out = partials + (size_t)blockIdx.x * 2 * K;
    out[k] = s_cc[tid];
    out[K + k] = s_nc[tid];
  }
}

bool power_of_two(int v) { return v >= 1 && (v & (v - 1)) == 0; }

template <int VEC>
int launch(const void* data, const void* t_cur, const void* t_prev, void* t_next, void* partials,
           float two_inv, int Lx, int Ly, int Lz, int S, int K, int TK, int XB, int PB, int h,
           int threads, int stride, size_t smem, const SlotTable& slots, cudaStream_t stream) {
  auto kernel = tiled_kernel<VEC>;
  // Without the opt-in a block gets 48 KB in all, and the reduction tree is
  // static shared memory on top of the window.
  if (smem + 2 * MAX_THREADS * sizeof(float) > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int M = Ly * Lz;
  const dim3 grid((unsigned)(((Lx + XB - 1) / XB) * ((M + PB - 1) / PB)), (unsigned)((K + TK - 1) / TK), 1);
  kernel<<<grid, threads, smem, stream>>>(
      (const float4*)data, (const float2*)t_cur, (const float2*)t_prev, (float2*)t_next,
      (float*)partials, two_inv, Lx, Ly, Lz, S, K, TK, XB, PB, h, stride, slots);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on the given stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError() (0 = launched).  slot_axis / slot_dir are host
// arrays of S ints (axis -1: diagonal, -2: padding on every row).
extern "C" int stencil_cheb_step_tiled_launch(const void* data, const void* t_cur, const void* t_prev,
                                              void* t_next, void* partials, float inv,
                                              int Lx, int Ly, int Lz, int S, int K, int TK,
                                              int XB, int PB, int h, int threads,
                                              const int* slot_axis, const int* slot_dir,
                                              void* stream) {
  if (!power_of_two(TK) || TK > 32 || !power_of_two(threads) || threads > MAX_THREADS ||
      threads < TK || Lx < 1 || Ly < 1 || Lz < 1 || S < 1 || S > MAX_SLOTS || K < 1 || XB < 1 ||
      PB < 1 || h < 0 || slot_axis == nullptr || slot_dir == nullptr)
    return (int)cudaErrorInvalidValue;
  SlotTable slots;
  for (int s = 0; s < MAX_SLOTS; ++s) {
    slots.axis[s] = s < S ? slot_axis[s] : -2;
    slots.dir[s] = s < S ? slot_dir[s] : 0;
  }
  const int vec = (TK % 2 == 0 && K % 2 == 0) ? 2 : 1;
  const int stride = BLK * TK + vec;
  const size_t smem = (size_t)(XB + 2) * (PB + 2 * h) * stride * sizeof(float2);
  if (smem + 2 * MAX_THREADS * sizeof(float) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (vec == 2)
    return launch<2>(data, t_cur, t_prev, t_next, partials, 2.0f * inv, Lx, Ly, Lz, S, K, TK, XB, PB, h,
                     threads, stride, smem, slots, (cudaStream_t)stream);
  return launch<1>(data, t_cur, t_prev, t_next, partials, 2.0f * inv, Lx, Ly, Lz, S, K, TK, XB, PB, h,
                   threads, stride, smem, slots, (cudaStream_t)stream);
}
