// Tiled fused Chebyshev step for stencil (cubic-lattice) skeletons, 4x4
// complex64 blocks (sm_90a).
//
//   stencil_cheb_step_tiled  t_next = 2*inv*(H t_cur) - t_prev, written out, plus
//                            per-thread-block partial sums, per probe column k, of
//                            Re<t_cur,t_cur> and Re<t_next,t_cur>.
//
// It replaces the lane-tiled plane kernel of bodge_tpu/ops/pallas_spmm.py
// (_plane_cheb_kernel_tiled under _plane_cheb_step_tiled, the opt-in
// BODGE_PLANE_TILED=1 form of the plane-layout step).  What that kernel
// computes: the same function as the untiled step, with a tile of the lattice
// and its halo held in fast memory and the neighbours found by stencil
// arithmetic instead of an index table.
//
// Here the lattice is streamed along x.  Site n = x*M + p, with the in-plane
// index p = y*Lz + z and M = Ly*Lz.  The plane is cut into strips of PB
// in-plane sites (the last one ragged); a work item is one strip of one
// x-row, items are numbered strip-major, and thread block b owns the items
// [b*XR, b*XR + XR) of its column tile blockIdx.y (TK probe columns), walking
// them as runs of consecutive x-rows of one strip.  Shared memory holds a
// ring of NR strip rows, each the strip's PB sites plus h on either side
// (h = Lz where the lattice extends in y, Lz - 1 otherwise), every index
// taken modulo the lattice.  While row x is computed from ring rows x-1, x
// and x+1, rows x+2 .. x+1+D (D = NR - 3) are in flight: cp.async copies
// (16 bytes where K and TK are even, else 8), one commit group a row, waited
// for with cp.async.wait_group, one barrier a row.  Modular staging makes the
// periodic links plain offsets:
//   x +- 1  ->  the ring row before or after (the wrap row was staged there);
//   y +- 1  ->  p +- Lz (p + Lz modulo M is the wrapped site);
//   z +- 1  ->  p +- 1, or p -+ (Lz - 1) at the ends of a z-run.
// The row index is taken modulo Lx once a row, the in-plane index wraps by
// one conditional add once a staged site; no 64-bit division remains in a
// loop.  It reads no `cols`.  Open boundaries need nothing special: their wrap
// blocks hold zeros, as in every other product of the package.  The only
// slots that are skipped are those the skeleton marks as padding everywhere:
// the -1 slot of an axis of extent 2 (axis = -2 in the table passed in).
// The operator blocks are broadcast loads from device memory as in
// ell_spmm.cu, issued before the padding test and with S (1, 3, 5 or 7 for a
// cubic stencil) a template parameter, so that several slots' loads are in
// flight at once.  Each thread keeps its column's two sums in registers over all
// its items; one fixed tree at the end writes one row of partials per thread
// block (no atomics, bit-equal repeats).
//
// Bound: bytes, with no index table at all: the operator once, t_cur and
// t_prev once, t_next once.  What the design does about it: each vector row
// crosses L2 -> SM about (1 + 2h/PB) times, plus two warm-up rows per run
// of x-rows; the copies of the next rows overlap the arithmetic of this one;
// the grid is one wave (the plan sizes it to the blocks that fit the card),
// so at K > TK the column tiles of one strip run side by side and the
// operator's second and later reads come from L2.
//
// Aliasing as in ell_spmm.cu: t_next must not alias t_cur; it may alias
// t_prev.  All element offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 3;  // the plan's occupancy: 80 registers a thread at most
constexpr int BLK = 4;
constexpr int BLK_FLOAT4 = 8;
constexpr int MAX_SLOTS = 8;
constexpr int MAX_DEPTH = 3;  // rows in flight
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB a block may use on sm_90

// Per slot: the axis it shifts along (-1: the diagonal, -2: padding on every
// row, skipped) and the direction (+1 / -1).
struct SlotTable {
  int axis[MAX_SLOTS];
  int dir[MAX_SLOTS];
};

// The lattice and the launch plan.
struct Plan {
  int Lx, M, Lz, K, TK, PB, h, NR, XR, n_strips;
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

template <int VEC, int S>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
tiled_kernel(const float4* __restrict__ data, const float2* __restrict__ t_cur,
             const float2* t_prev, float2* t_next, float* __restrict__ partials, float two_inv,
             Plan pl, SlotTable slots) {
  extern __shared__ float4 ring4[];
  float2* ring = reinterpret_cast<float2*>(ring4);
  __shared__ float s_cc[THREADS];
  __shared__ float s_nc[THREADS];

  const int tid = threadIdx.x;
  const int lg_tk = __ffs(pl.TK) - 1;
  const int kk = tid & (pl.TK - 1);
  const int row = tid >> lg_tk;
  const int rows = THREADS >> lg_tk;
  const int k0 = blockIdx.y * pl.TK;
  const int k = k0 + kk;
  const int K = pl.K, M = pl.M, Lz = pl.Lz, h = pl.h, NR = pl.NR;
  const int D = NR - 3;
  const int stride = BLK * pl.TK + VEC;  // float2 a ring site (VEC of padding)
  const int slot_elems = (pl.PB + 2 * h) * stride;
  const int lg_tkv = lg_tk - (VEC == 2 ? 1 : 0);
  const int lg_site = lg_tkv + 2;  // log2 of the copies a site: 4 orbitals x TK/VEC

  // Issue the copies of x-row xr (in [-1, Lx]) of the strip [p0, p0 + W - 2h)
  // plus its halo into ring row `slot`; the caller commits the group.
  auto stage = [&](int slot, int xr, int p0, int W) {
    xr += xr < 0 ? pl.Lx : 0;
    xr -= xr >= pl.Lx ? pl.Lx : 0;
    const float2* src_row = t_cur + (size_t)xr * M * BLK * K + k0;
    float2* dst_row = ring + (size_t)slot * slot_elems;
    const int count = W << lg_site;
    for (int e = tid; e < count; e += THREADS) {
      const int w = e >> lg_site;
      const int r = e & ((1 << lg_site) - 1);
      const int b = r >> lg_tkv;
      const int c = (r & ((1 << lg_tkv) - 1)) * VEC;
      if (k0 + c >= K) continue;  // columns past K are never read
      int p = p0 - h + w;
      p += p < 0 ? M : 0;
      p -= p >= M ? M : 0;
      copy_async(dst_row + w * stride + b * pl.TK + c, src_row + ((size_t)p * BLK + b) * K + c, VEC == 2);
    }
  };

  float cc = 0.f, nc = 0.f;
  const long long items = (long long)pl.n_strips * pl.Lx;
  long long u = (long long)blockIdx.x * pl.XR;
  const long long u_end = min(u + pl.XR, items);
  while (u < u_end) {
    // One run: x-rows [xa, xb) of strip `strip`.
    const int strip = (int)(u / pl.Lx);
    const int xa = (int)(u - (long long)strip * pl.Lx);
    const int xb = (int)min((long long)pl.Lx, u_end - (long long)strip * pl.Lx);
    const int p0 = strip * pl.PB;
    const int PBe = min(pl.PB, M - p0);
    const int W = PBe + 2 * h;
    const int last = xb - xa + 1;  // ring index of row xb, the last one the run reads

    // Ring index i holds x-row xa - 1 + i, in ring row i % NR.  Prologue:
    // indices 0 .. 2 (0 .. 1 without depth) as one group, then one group each
    // up to index 1 + D.
    const int first = min(3, 2 + D);
    for (int i = 0; i < first; ++i) stage(i, xa - 1 + i, p0, W);
    commit_group();
    for (int i = first; i < 2 + D; ++i) {
      if (i <= last) stage(i, xa - 1 + i, p0, W);
      commit_group();  // empty groups keep the count of groups in flight uniform
    }

    int rm = 0, r0 = 1, rp = 2;  // ring rows of x - 1, x, x + 1
    for (int j = 0; xa + j < xb; ++j) {
      const int x = xa + j;
      if (D == 0) {
        __syncthreads();  // every thread is done with row x - 2's ring row
        stage(rp, x + 1, p0, W);
        commit_group();
        wait_groups(0);
      } else {
        wait_groups(D - 1);  // row x + 1 has landed (this thread's copies)
      }
      __syncthreads();  // ... everyone's; and every thread is done with row x - 2
      if (D > 0) {
        const int i = j + 2 + D;
        int slot = rm + NR - 1;  // ring row of index j - 1 = (j + 2 + D) % NR
        slot -= slot >= NR ? NR : 0;
        if (i <= last) stage(slot, xa - 1 + i, p0, W);
        commit_group();
      }

      if (k < K) {
        const float2* ring_m = ring + (size_t)rm * slot_elems;
        const float2* ring_0 = ring + (size_t)r0 * slot_elems;
        const float2* ring_p = ring + (size_t)rp * slot_elems;
        for (int i = row; i < PBe; i += rows) {
          const int p = p0 + i;
          const int z = Lz > 1 ? p % Lz : 0;
          const size_t n = (size_t)x * M + p;
          const size_t base = n * BLK * K + k;

          float2 pv[BLK];
#pragma unroll
          for (int a = 0; a < BLK; ++a)  // read before the write below
            pv[a] = t_prev != nullptr ? t_prev[base + (size_t)a * K] : make_float2(0.f, 0.f);

          float2 acc[BLK];
#pragma unroll
          for (int a = 0; a < BLK; ++a) acc[a] = make_float2(0.f, 0.f);

          const float4* drow = data + n * S * BLK_FLOAT4;
          const int own = (i + h) * stride + kk;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            // The block's loads come first and unconditionally (a padding
            // slot's block is allocated too), so that the compiler can keep
            // the loads of several slots in flight.
            const float4* blk = drow + s * BLK_FLOAT4;
            float4 d[2 * BLK];
#pragma unroll
            for (int e = 0; e < 2 * BLK; ++e) d[e] = __ldg(blk + e);
            const int axis = slots.axis[s];
            if (axis == -2) continue;  // padding slot on every row
            const int dir = slots.dir[s];
            const float2* vrow;
            if (axis == 0) {
              vrow = (dir > 0 ? ring_p : ring_m) + own;
            } else {
              int off = 0;  // in ring sites
              if (axis == 1) {
                off = dir * Lz;
              } else if (axis == 2) {
                const int zn = z + dir;
                off = zn < 0 ? Lz - 1 : (zn >= Lz ? -(Lz - 1) : dir);
              }
              vrow = ring_0 + own + off * stride;
            }
            float2 vb[BLK];
#pragma unroll
            for (int b = 0; b < BLK; ++b) vb[b] = vrow[b * pl.TK];
#pragma unroll
            for (int a = 0; a < BLK; ++a) {
              const float4 d01 = d[2 * a];      // entries (a,0), (a,1)
              const float4 d23 = d[2 * a + 1];  // entries (a,2), (a,3)
              cfma(acc[a], d01.x, d01.y, vb[0]);
              cfma(acc[a], d01.z, d01.w, vb[1]);
              cfma(acc[a], d23.x, d23.y, vb[2]);
              cfma(acc[a], d23.z, d23.w, vb[3]);
            }
          }

#pragma unroll
          for (int a = 0; a < BLK; ++a) {
            const float2 c = ring_0[own + a * pl.TK];
            float2 nx;
            nx.x = fmaf(two_inv, acc[a].x, -pv[a].x);
            nx.y = fmaf(two_inv, acc[a].y, -pv[a].y);
            t_next[base + (size_t)a * K] = nx;
            cc = fmaf(c.x, c.x, fmaf(c.y, c.y, cc));
            nc = fmaf(nx.x, c.x, fmaf(nx.y, c.y, nc));
          }
        }
      }
      rm = r0;
      r0 = rp;
      rp = rp + 1 == NR ? 0 : rp + 1;
    }
    wait_groups(0);
    __syncthreads();  // the ring is free for the next run
    u += xb - xa;
  }

  s_cc[tid] = cc;
  s_nc[tid] = nc;
  __syncthreads();
  for (int hh = rows / 2; hh > 0; hh >>= 1) {
    if (row < hh) {
      s_cc[tid] += s_cc[tid + (hh << lg_tk)];
      s_nc[tid] += s_nc[tid + (hh << lg_tk)];
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

// The carveout (percent of the SM's 228 KB) of the smallest shared-memory
// configuration of sm_90 that holds `bytes`, rounded up.
int carveout_for(size_t bytes) {
  static const int configs_kb[] = {0, 8, 16, 32, 64, 100, 132, 164, 196, 228};
  for (int c : configs_kb)
    if ((size_t)c * 1024 >= bytes) return (c * 100 + 227) / 228;
  return 100;
}

template <int VEC, int S>
int launch(const void* data, const void* t_cur, const void* t_prev, void* t_next, void* partials,
           float two_inv, const Plan& pl, int ctas, size_t smem, const SlotTable& slots,
           cudaStream_t stream) {
  auto kernel = tiled_kernel<VEC, S>;
  // Without the opt-in a block gets 48 KB in all, the reduction tree's static
  // 2 KB included.  The carveout asks for the shared memory of the
  // BLOCKS_PER_SM blocks an SM is planned to hold, and leaves the rest to L1.
  constexpr size_t tree = 2 * THREADS * sizeof(float);
  if (smem + tree > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         carveout_for(BLOCKS_PER_SM * (smem + tree + 1024)));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ctas, (unsigned)((pl.K + pl.TK - 1) / pl.TK), 1);
  kernel<<<grid, THREADS, smem, stream>>>((const float4*)data, (const float2*)t_cur, (const float2*)t_prev,
                                          (float2*)t_next, (float*)partials, two_inv, pl, slots);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on the given stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError() (0 = launched).  slot_axis / slot_dir are host
// arrays of S ints (axis -1: diagonal, -2: padding on every row).  The plan
// (ops/cuda_spmm.tile_plan): TK probe columns a block, strips of PB in-plane
// sites, halo h, a ring of NR rows (3 <= NR <= 3 + MAX_DEPTH), XR items a
// block, and ctas = ceil(ceil(M / PB) * Lx / XR) blocks a column tile, whose
// partials are ctas rows of 2K floats.
extern "C" int stencil_cheb_step_tiled_launch(const void* data, const void* t_cur, const void* t_prev,
                                              void* t_next, void* partials, float inv,
                                              int Lx, int Ly, int Lz, int S, int K, int TK,
                                              int PB, int h, int NR, int XR, int ctas,
                                              const int* slot_axis, const int* slot_dir,
                                              void* stream) {
  if (!power_of_two(TK) || TK > 32 || Lx < 1 || Ly < 1 || Lz < 1 || S < 1 || S > MAX_SLOTS || K < 1 ||
      PB < 1 || h < 0 || NR < 3 || NR > 3 + MAX_DEPTH || XR < 1 || slot_axis == nullptr ||
      slot_dir == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)Ly * Lz;
  if (PB > M || h > M || (long long)Lx * M > (1LL << 40)) return (int)cudaErrorInvalidValue;
  const long long n_strips = (M + PB - 1) / PB;
  if (ctas != (n_strips * Lx + XR - 1) / XR) return (int)cudaErrorInvalidValue;
  SlotTable slots;
  for (int s = 0; s < MAX_SLOTS; ++s) {
    slots.axis[s] = s < S ? slot_axis[s] : -2;
    slots.dir[s] = s < S ? slot_dir[s] : 0;
  }
  const Plan pl{Lx, (int)M, Lz, K, TK, PB, h, NR, XR, (int)n_strips};
  const int vec = (TK % 2 == 0 && K % 2 == 0) ? 2 : 1;
  const int stride = BLK * TK + vec;
  const size_t smem = (size_t)NR * (PB + 2 * h) * stride * sizeof(float2);
  if (smem + 2 * THREADS * sizeof(float) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const float two_inv = 2.0f * inv;
  cudaStream_t st = (cudaStream_t)stream;
#define TILED_LAUNCH(V, NS) \
  launch<V, NS>(data, t_cur, t_prev, t_next, partials, two_inv, pl, ctas, smem, slots, st)
  // A cubic stencil has the diagonal and two slots an axis that is not flat.
  switch (S * 2 + (vec == 2 ? 1 : 0)) {
    case 2: return TILED_LAUNCH(1, 1);
    case 3: return TILED_LAUNCH(2, 1);
    case 6: return TILED_LAUNCH(1, 3);
    case 7: return TILED_LAUNCH(2, 3);
    case 10: return TILED_LAUNCH(1, 5);
    case 11: return TILED_LAUNCH(2, 5);
    case 14: return TILED_LAUNCH(1, 7);
    case 15: return TILED_LAUNCH(2, 7);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TILED_LAUNCH
}
