// Windowed block-ELL SpMM and fused Chebyshev step for relabelled generic
// skeletons, 4x4 complex blocks (sm_90a).
//
//   ell_gather_spmm       y[n,a,k] = sum_s sum_b data[n,s,a,b] * v[n + rel[n,s], b, k]
//   ell_gather_cheb_step  t_next   = 2*inv*(H t_cur) - t_prev, written out, plus
//                         per-run partial sums, per probe column k, of
//                         Re<t_cur,t_cur> and Re<t_next,t_cur> over the run's sites.
//
// They replace the gather kernel of bodge_tpu/ops/pallas_gather.py
// (_gather_kernel under spmm_gather_packed; moments_gather_packed scans it
// with the scale and the inner products as separate passes).  What that kernel
// computes: the product on a skeleton whose sites were relabelled (reverse
// Cuthill-McKee) so that every neighbour lies within `bwb` rows of its row,
// with each vector row read from fast memory instead of device memory once
// per slot.  There the gather itself is a one-hot matrix product, the only
// gather that machine has; that is not carried over.  Here data, the offsets
// and the vectors stay in relabelled order for a whole sweep.  The grid is one
// wave: each run of `run` contiguous relabelled rows and each column tile
// (probe columns) has its own SM, which walks the run in tiles of T rows.
// Shared memory holds a ring of R = 2*bwb + (D + 1)*T vector rows: tile t
// needs the window [a - bwb, a + T + bwb) (a its first row); moving to the
// next tile brings in only the T rows past the window's end, so each vector
// row crosses L2 -> SM about (1 + 2*bwb/run) times, never as a scattered
// 64-byte segment.  Rows outside [0, N) are never read.  A thread takes its
// neighbours from the ring by the per-(site, slot) offset rel[n,s] =
// (relabelled column) - n, an int32 in [-bwb, bwb]; INT_MIN marks a padding
// slot, which is skipped.  Then the same complex FMAs as ell_kernel in
// ell_spmm.cu.  The Chebyshev form fuses the recursion tail and both
// reductions into the pass; each thread keeps its column's two sums in
// registers over all its tiles, and one fixed tree in shared memory at the
// end writes one row of partials per run, no atomics: results repeat bit for
// bit.
//
// What bounds them on this card.  Bytes at best: the operator once, N*S
// offsets, t_cur (and t_prev) once, t_next once.  In the one-block form a
// tile is also a chain of round trips: the operator's blocks and the offsets
// come from device memory after the tile's barrier, the ring reads wait for
// the offsets, the FMAs for both.  With the window's ring in nearly all of
// shared memory one block holds the SM, 1024 threads at 64 registers, and
// nothing else hides that chain.  On the 1024x256 hole sheet at K = 8 (bwb
// 293: a 229 KB ring) the variants of tools/gather_variants.py showed it
// (H100 80GB HBM3, 700 W): a constant operator in place of its loads halves
// the time (bf16 product 0.1435 -> 0.0776 ms), tiles of 64 rows or 512
// threads add 35-41 % (a cost a tile, not a byte), dropping the barrier 9 %;
// the bf16 operator's fewer bytes bought 7 %.
//
// Two forms, chosen by the caller's plan (ops/cuda_gather.plan_gather):
//
//   one block a run (cluster = 1): TK probe columns a block (gridDim.y column
//     tiles), T*TK sites x columns in flight, the ring filled by cp.async
//     copies of all threads (16 bytes where K and TK are even, else 8), one
//     commit group and one barrier a tile, the copies of the D tiles after
//     this one in flight while it is computed; the operator and the offsets
//     read from device memory.  The complex64 operator's plan (its operator
//     stages would not fit beside the ring), K = 1, and any band too wide
//     for the form below.
//   a cluster of two blocks a run (cluster = 2), the bf16 operator's plan:
//     the pair splits a column tile of 2*TK columns, so each ring row holds
//     half the columns, and the room that frees holds P = D + 1 stages of a
//     tile's operator rows and offsets.  One producer warp a block fills the
//     stages ahead of the consumers: the tile's operator rows [a, a + T), one
//     contiguous run of bytes, by two bulk copies (cp.async.bulk), each block
//     copying half and multicasting it to both, and the tile's offsets by a
//     third from block 0, so device memory reads them once for the pair; the
//     block's ring rows by cp.async.  Each stage has a "full" mbarrier (the
//     bulk bytes expected, and the producer lanes' cp.async arrivals) and an
//     "empty" one (one arrival of each consumer warp of both blocks: the
//     peer's multicast writes into this block's stage).  Consumers wait on
//     "full" only: no block-wide barrier lies on a tile's path, and the
//     operator and the offsets are shared-memory reads.  The waits and
//     arrivals keep the block's scope; at the cluster's scope each arrival
//     waited for the warp's stores of t_next (bf16 product on the sheet
//     0.139 ms, against 0.1036 with the block's scope, two stages of 128
//     rows; tools/gather_variants.py).  On the sheet the plan takes tiles of
//     96 rows in three stages, 223 824 bytes a block: the product 0.0948 ms
//     against its 0.0638 ms bound, the one-block form's 0.1435 (chip_smoke.py,
//     the same card).  Partials are written per run, each block its columns.
//
// Light-cone form of the one-block complex64 step (ell_gather_cheb_step_window):
// the same runs, of a shorter `run`, split rows [row0, row1) of the lattice
// instead of [0, N), so that a sweep from probes on a few sites steps only the
// rows it has reached (ops/cuda_spmm.LightCone) on every SM.  Each run still
// reads the band around it from [0, N); rows outside [row0, row1) are neither
// read as t_prev nor written.  The whole-lattice kernel keeps its signature:
// both are gather_kernel, over one body, gather_run.
//
// Aliasing as in ell_spmm.cu: t_next must not alias t_cur (other blocks stage
// it); it may alias t_prev (each thread reads its own entries before writing).
// All element offsets are 64-bit.
//
// Operator forms (operator_form.cuh): the one-block form takes either, as its
// template parameter OP: complex64 (OP = float4) or the bf16 form (OP = uint4,
// four 16-byte loads a block, upcast to float32 in registers), the
// counterpart of the reference's bfloat16 operator storage
// (pallas_gather.py:223-226); the cluster form takes the bf16 form only.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "operator_form.cuh"

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_DEPTH = 2;  // tiles in flight
constexpr int BLK = 4;
constexpr int PAD_REL = INT_MIN;
constexpr int PRODUCER = 32;                 // the producer warp of the cluster form
constexpr int MAX_CONSUMERS = 512;           // consumer threads a block of the cluster form
constexpr int MAX_STAGES = 4;                // stages of the cluster form (D + 1)
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB a block may use on sm_90

// The operator's shape and the launch plan.
struct Plan {
  long long N;
  int S, K, TK, T, bwb, D, R;
  long long run;
};

// The cluster form's plan: the byte offsets of its stages and barriers in
// shared memory beside the above.
struct StagedPlan {
  Plan p;
  int op_off, rel_off, bar_off;
};

__device__ __forceinline__ void cfma(float2& acc, float dre, float dim, const float2& v) {
  acc.x = fmaf(dre, v.x, fmaf(-dim, v.y, acc.x));
  acc.y = fmaf(dre, v.y, fmaf(dim, v.x, acc.y));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void copy_async(float2* dst, const float2* src, bool sixteen) {
  const unsigned s = smem_addr(dst);
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

// mbarriers (shared::cta addresses) and the cluster.
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// The waits and arrivals take the default semantics (acquire / release at
// the block's scope): what they order are shared-memory reads and the
// copies' writes, never this thread's stores to device memory, which a
// release at the cluster's scope would wait for.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_peer(unsigned bar, unsigned peer) {
  asm volatile(
      "{\n .reg .b32 remote;\n"
      " mapa.shared::cluster.u32 remote, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(peer)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// The thread's cp.async copies so far arrive on `bar` when they land (counted
// among the barrier's expected arrivals).
__device__ __forceinline__ void mbar_arrive_copies(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// `bytes` from device memory into the same shared-memory offset of both
// blocks of the cluster, completing on the barrier at the same offset in each.
__device__ __forceinline__ void bulk_multicast(unsigned dst, const void* src, unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"((unsigned short)0x3)
      : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One block a run: the ring filled by all threads, one barrier a tile.  The
// block walks its run, rows [r0, r1).

template <bool CHEB, int VEC, typename OP>
__device__ __forceinline__ void gather_run(const OP* __restrict__ data, const int* __restrict__ rel,
                                           const float2* __restrict__ t_cur, const float2* t_prev, float2* t_next,
                                           float* __restrict__ partials, float two_inv, Plan pl, long long r0,
                                           long long r1) {
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
        const OP* drow = data + (size_t)n * S * opform::Op<OP>::PER_BLOCK;
#pragma unroll 4
        for (int s = 0; s < S; ++s) {
          // The block's loads come first and unconditionally (a padding
          // slot's block is allocated too), so that the compiler can keep the
          // loads of several slots in flight.
          const OP* blk = drow + (size_t)s * opform::Op<OP>::PER_BLOCK;
          OP d[opform::Op<OP>::PER_BLOCK];
#pragma unroll
          for (int e = 0; e < opform::Op<OP>::PER_BLOCK; ++e) d[e] = __ldg(blk + e);
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
            if constexpr (opform::Op<OP>::PER_BLOCK == 8) {  // complex64
              const float4 d01 = d[2 * a2];      // entries (a,0), (a,1)
              const float4 d23 = d[2 * a2 + 1];  // entries (a,2), (a,3)
              cfma(acc[a2], d01.x, d01.y, vb[0]);
              cfma(acc[a2], d01.z, d01.w, vb[1]);
              cfma(acc[a2], d23.x, d23.y, vb[2]);
              cfma(acc[a2], d23.z, d23.w, vb[3]);
            } else {  // bf16 pairs: entries (a,0) .. (a,3) in one 16-byte word
              const float2 e0 = opform::bf16_pair(d[a2].x), e1 = opform::bf16_pair(d[a2].y);
              const float2 e2 = opform::bf16_pair(d[a2].z), e3 = opform::bf16_pair(d[a2].w);
              cfma(acc[a2], e0.x, e0.y, vb[0]);
              cfma(acc[a2], e1.x, e1.y, vb[1]);
              cfma(acc[a2], e2.x, e2.y, vb[2]);
              cfma(acc[a2], e3.x, e3.y, vb[3]);
            }
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

// The whole lattice: run b is rows [b * run, (b + 1) * run) of [0, N).
template <bool CHEB, int VEC, typename OP>
__global__ void __launch_bounds__(MAX_THREADS)
gather_kernel(const OP* __restrict__ data, const int* __restrict__ rel,
              const float2* __restrict__ t_cur, const float2* t_prev, float2* t_next,
              float* __restrict__ partials, float two_inv, Plan pl) {
  const long long r0 = (long long)blockIdx.x * pl.run;
  gather_run<CHEB, VEC, OP>(data, rel, t_cur, t_prev, t_next, partials, two_inv, pl, r0, min(r0 + pl.run, pl.N));
}

// The light-cone form (WIN): the runs split rows [row0, row1) of the lattice
// instead, each block reading the band around its run from [0, N) as above.
template <bool CHEB, int VEC, typename OP, bool WIN>
__global__ void __launch_bounds__(MAX_THREADS)
gather_kernel(const OP* __restrict__ data, const int* __restrict__ rel,
              const float2* __restrict__ t_cur, const float2* t_prev, float2* t_next,
              float* __restrict__ partials, float two_inv, Plan pl, long long row0, long long row1) {
  static_assert(WIN, "the whole lattice is the form without a row range");
  const long long r0 = row0 + (long long)blockIdx.x * pl.run;
  gather_run<CHEB, VEC, OP>(data, rel, t_cur, t_prev, t_next, partials, two_inv, pl, r0, min(r0 + pl.run, row1));
}

// The cluster form's consumers: one site n, its bf16 operator blocks at
// `drow` and its offsets at `rrow` in shared memory, the neighbours in the
// ring; then the write of t_next and, for the Chebyshev form, the tail and
// the two sums.  The arithmetic of gather_kernel's loop, which keeps its own
// copy: its loads come from device memory, and its schedule is tuned for them.
template <bool CHEB>
__device__ __forceinline__ void staged_site(const uint4* drow, const int* rrow, const float2* ring, int qn, int R,
                                            int stride, int TK, int kk, int S, int K, size_t base_o,
                                            const float2* t_prev, float2* t_next, float two_inv, float& cc,
                                            float& nc) {
  float2 pv[BLK];
  if (CHEB) {
#pragma unroll
    for (int a2 = 0; a2 < BLK; ++a2)  // read before the write below
      pv[a2] = t_prev != nullptr ? t_prev[base_o + (size_t)a2 * K] : make_float2(0.f, 0.f);
  }
  float2 acc[BLK];
#pragma unroll
  for (int a2 = 0; a2 < BLK; ++a2) acc[a2] = make_float2(0.f, 0.f);
#pragma unroll 4
  for (int s = 0; s < S; ++s) {
    const int r = rrow[s];
    if (r == PAD_REL) continue;  // padding slot
    const uint4* blk = drow + (size_t)s * BLK;
    int q = qn + r;
    q += q < 0 ? R : 0;
    q -= q >= R ? R : 0;
    const float2* vrow = ring + (size_t)q * stride + kk;
    float2 vb[BLK];
#pragma unroll
    for (int b = 0; b < BLK; ++b) vb[b] = vrow[b * TK];
#pragma unroll
    for (int a2 = 0; a2 < BLK; ++a2) {  // entries (a,0) .. (a,3) in one 16-byte word
      const uint4 w = blk[a2];
      const float2 e0 = opform::bf16_pair(w.x), e1 = opform::bf16_pair(w.y);
      const float2 e2 = opform::bf16_pair(w.z), e3 = opform::bf16_pair(w.w);
      cfma(acc[a2], e0.x, e0.y, vb[0]);
      cfma(acc[a2], e1.x, e1.y, vb[1]);
      cfma(acc[a2], e2.x, e2.y, vb[2]);
      cfma(acc[a2], e3.x, e3.y, vb[3]);
    }
  }
  const float2* own = ring + (size_t)qn * stride + kk;
#pragma unroll
  for (int a2 = 0; a2 < BLK; ++a2) {
    const size_t o = base_o + (size_t)a2 * K;
    if (CHEB) {
      const float2 c = own[a2 * TK];
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

// The producer warp's cp.async copies of the vector rows [g_lo, g_hi)
// (clipped to [0, hi)) into the ring: each lane a fixed (orbital, column
// pair) of every (32 / copies-a-row)-th row, from column k0 of t_cur.
template <int VEC>
__device__ __forceinline__ void produce_rows(float2* ring, const float2* t_cur, long long g_lo, long long g_hi,
                                             long long hi, long long base, int R, int stride, int K, int TK,
                                             int k0, int lg_tk, int lane) {
  g_lo = max(g_lo, 0LL);
  g_hi = min(g_hi, hi);
  const int lg_tkv = lg_tk - (VEC == 2 ? 1 : 0);
  const int lg_site = lg_tkv + 2;  // log2 of the copies a row (at most 16: TK <= 4)
  const int sub = lane & ((1 << lg_site) - 1);
  const int b = sub >> lg_tkv;
  const int c = (sub & ((1 << lg_tkv) - 1)) * VEC;
  const int step = PRODUCER >> lg_site;  // rows a pass
  const long long g0 = g_lo + (lane >> lg_site);
  if (k0 + c >= K || g0 >= g_hi) return;  // columns past K are never read
  int q = (int)((g0 - base) % R);
  const float2* src = t_cur + ((size_t)g0 * BLK + b) * K + k0 + c;
  float2* dst = ring + b * TK + c;
  for (long long g = g0; g < g_hi; g += step) {
    copy_async(dst + (size_t)q * stride, src, VEC == 2);
    src += (size_t)step * BLK * K;
    q += step;
    q -= q >= R ? R : 0;
  }
}

// A cluster of two blocks a run, each TK of the pair's 2*TK columns; the bf16
// operator and the offsets staged ahead by a producer warp (see the note).
// blockDim.x = consumer threads + PRODUCER; gridDim.x = 2 * runs.  `rel` has
// its rows padded to a multiple of 4, and runs and tiles are multiples of 4
// rows, so that a tile's offsets are 16-byte aligned.
template <bool CHEB, int VEC>
__global__ void __launch_bounds__(MAX_CONSUMERS + PRODUCER)
gather_cluster_kernel(const uint4* __restrict__ data, const int* __restrict__ rel,
                      const float2* __restrict__ t_cur, const float2* t_prev, float2* t_next,
                      float* __restrict__ partials, float two_inv, StagedPlan sp) {
  constexpr int PB = BLK;  // uint4 words a bf16 block
  const Plan& pl = sp.p;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float2* ring = reinterpret_cast<float2*>(smem);
  uint4* op_s = reinterpret_cast<uint4*>(smem + sp.op_off);
  int* rel_s = reinterpret_cast<int*>(smem + sp.rel_off);
  const int P = pl.D + 1;                               // stages
  const unsigned full0 = smem_addr(smem + sp.bar_off);  // full[p] at full0 + 8p, empty[p] at empty0 + 8p
  const unsigned empty0 = full0 + 8 * P;

  const int tid = threadIdx.x;
  const int consumers = blockDim.x - PRODUCER;
  const unsigned rank = cluster_rank();
  const int lg_tk = __ffs(pl.TK) - 1;
  const int kk = tid & (pl.TK - 1);
  const int row = tid >> lg_tk;
  const int rows = consumers >> lg_tk;
  const int k0 = (blockIdx.y * 2 + (int)rank) * pl.TK;
  const int k = k0 + kk;
  const int K = pl.K, S = pl.S, T = pl.T, bwb = pl.bwb, R = pl.R;
  const long long N = pl.N;
  const int stride = BLK * pl.TK + VEC;

  const long long r0 = (long long)(blockIdx.x >> 1) * pl.run;
  const long long r1 = min(r0 + pl.run, N);
  const long long base = r0 - bwb;
  const long long hi = min(N, r1 + bwb);
  const int tiles = (int)((r1 - r0 + T - 1) / T);
  const int op_stage = T * S * PB;  // uint4 words of a stage
  const int rel_stage = T * S;

  if (tid == 0) {
    for (int p = 0; p < P; ++p) {
      mbar_init(full0 + 8 * p, PRODUCER + 1);           // the lanes' copies and the bulk bytes
      mbar_init(empty0 + 8 * p, 2 * (consumers / 32));  // every consumer warp of both blocks
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // both blocks' barriers exist before any copy or remote arrival

  float cc = 0.f, nc = 0.f;
  if (tid >= consumers) {  // the producer warp
    const int lane = tid - consumers;
    for (int u = 0; u < tiles; ++u) {
      const int st = u % P;
      if (u >= P) mbar_wait(empty0 + 8 * st, (unsigned)((u / P - 1) & 1));  // both blocks are done with tile u - P
      const long long a = r0 + (long long)u * T;
      const int Te = (int)min((long long)T, r1 - a);
      // Vector rows: the whole window for tile 0, the T rows past it after.
      produce_rows<VEC>(ring, t_cur, u == 0 ? r0 - bwb : a + bwb, a + T + bwb, hi, base, R, stride, K, pl.TK, k0,
                        lg_tk, lane);
      mbar_arrive_copies(full0 + 8 * st);
      if (lane == 0) {
        // The tile's operator rows, half from each block, and (block 0) its
        // offsets, to both blocks.
        const int half = (Te + 1) / 2;
        const int lo = rank == 0 ? 0 : half;
        const int n = rank == 0 ? half : Te - half;
        const unsigned rel_bytes = (unsigned)(((Te + 3) & ~3) * S * 4);
        mbar_expect_bytes(full0 + 8 * st, (unsigned)(Te * S * PB * 16) + rel_bytes);
        if (n > 0)
          bulk_multicast(smem_addr(op_s + (size_t)st * op_stage + (size_t)lo * S * PB),
                         data + ((size_t)a + lo) * S * PB, (unsigned)(n * S * PB * 16), full0 + 8 * st);
        if (rank == 0)
          bulk_multicast(smem_addr(rel_s + st * rel_stage), rel + (size_t)a * S, rel_bytes, full0 + 8 * st);
      }
    }
  } else {  // consumers
    const unsigned peer = rank ^ 1u;
    int qa = bwb;  // ring row of the tile's first row
    for (int t = 0; t < tiles; ++t) {
      const int st = t % P;
      mbar_wait(full0 + 8 * st, (unsigned)((t / P) & 1));
      const long long a = r0 + (long long)t * T;
      const int Te = (int)min((long long)T, r1 - a);
      if (k < K) {
        for (int i = row; i < Te; i += rows) {
          const long long n = a + i;
          int qn = qa + i;
          qn -= qn >= R ? R : 0;
          staged_site<CHEB>(op_s + (size_t)st * op_stage + (size_t)i * S * PB, rel_s + st * rel_stage + i * S, ring,
                            qn, R, stride, pl.TK, kk, S, K, (size_t)n * BLK * K + k, t_prev, t_next, two_inv, cc,
                            nc);
        }
      }
      __syncwarp();
      if ((tid & 31) == 0) {  // this warp is done with the stage, here and in the peer
        mbar_arrive(empty0 + 8 * st);
        mbar_arrive_peer(empty0 + 8 * st, peer);
      }
      qa += T;
      qa -= qa >= R ? R : 0;
    }
  }
  cluster_sync();  // no block leaves while its peer may still arrive on its barriers

  if constexpr (CHEB) {  // the ring is free: one fixed tree over the consumers
    float* s_cc = reinterpret_cast<float*>(smem4);
    float* s_nc = s_cc + consumers;
    if (tid < consumers) {
      s_cc[tid] = cc;
      s_nc[tid] = nc;
    }
    __syncthreads();
    for (int h = rows / 2; h > 0; h >>= 1) {
      if (tid < consumers && row < h) {
        s_cc[tid] += s_cc[tid + (h << lg_tk)];
        s_nc[tid] += s_nc[tid + (h << lg_tk)];
      }
      __syncthreads();
    }
    if (tid < consumers && row == 0 && k < K) {
      float* out = partials + (size_t)(blockIdx.x >> 1) * 2 * K;
      out[k] = s_cc[tid];
      out[K + k] = s_nc[tid];
    }
  }
}

bool power_of_two(int v) { return v >= 1 && (v & (v - 1)) == 0; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  // Without the opt-in a block gets 48 KB; one block an SM is planned, so the
  // carveout gives shared memory all it can take.
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <bool CHEB, int VEC, typename OP>
int launch(const void* data, const void* rel, const void* t_cur, const void* t_prev, void* t_next,
           void* partials, float two_inv, const Plan& pl, int threads, int ctas, size_t smem, cudaStream_t stream) {
  void (*kernel)(const OP*, const int*, const float2*, const float2*, float2*, float*, float, Plan) =
      gather_kernel<CHEB, VEC, OP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ctas, (unsigned)((pl.K + pl.TK - 1) / pl.TK), 1);
  kernel<<<grid, threads, smem, stream>>>((const OP*)data, (const int*)rel, (const float2*)t_cur,
                                          (const float2*)t_prev, (float2*)t_next, (float*)partials, two_inv, pl);
  return (int)cudaGetLastError();
}

// The light-cone form, complex64: `ctas` runs of pl.run rows split [row0, row1).
template <bool CHEB, int VEC>
int launch_window(const void* data, const void* rel, const void* t_cur, const void* t_prev, void* t_next,
                  void* partials, float two_inv, const Plan& pl, long long row0, long long row1, int threads,
                  int ctas, size_t smem, cudaStream_t stream) {
  void (*kernel)(const float4*, const int*, const float2*, const float2*, float2*, float*, float, Plan, long long,
                 long long) = gather_kernel<CHEB, VEC, float4, true>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ctas, (unsigned)((pl.K + pl.TK - 1) / pl.TK), 1);
  kernel<<<grid, threads, smem, stream>>>((const float4*)data, (const int*)rel, (const float2*)t_cur,
                                          (const float2*)t_prev, (float2*)t_next, (float*)partials, two_inv, pl,
                                          row0, row1);
  return (int)cudaGetLastError();
}

template <bool CHEB, int VEC>
int launch_cluster(const void* data, const void* rel, const void* t_cur, const void* t_prev, void* t_next,
                   void* partials, float two_inv, const StagedPlan& sp, int threads, int ctas, size_t smem,
                   cudaStream_t stream) {
  auto kernel = gather_cluster_kernel<CHEB, VEC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2u * (unsigned)ctas, (unsigned)((sp.p.K + 2 * sp.p.TK - 1) / (2 * sp.p.TK)), 1);
  cfg.blockDim = dim3((unsigned)(threads + PRODUCER), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const uint4*)data, (const int*)rel, (const float2*)t_cur,
                           (const float2*)t_prev, (float2*)t_next, (float*)partials, two_inv, sp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

size_t round16(size_t v) { return (v + 15) & ~(size_t)15; }

// The launch of either form on the whole lattice, or (window) of the
// one-block complex64 form's light-cone instantiation on rows [row0, row1).
template <bool CHEB>
int dispatch(const void* data, int bf16, const void* rel, const void* t_cur, const void* t_prev, void* t_next,
             void* partials, float two_inv, long long N, int S, int K, int TK, int T, int bwb, int D,
             long long run, int ctas, int threads, int cluster, void* stream, bool window = false,
             long long row0 = 0, long long row1 = 0) {
  const int max_threads = cluster == 2 ? MAX_CONSUMERS : MAX_THREADS;
  if (!window) row1 = N;
  if (!power_of_two(TK) || TK > 32 || !power_of_two(threads) || threads > max_threads ||
      threads < TK || N < 0 || S < 1 || K < 1 || T < 1 || bwb < 0 || D < 0 ||
      D > (cluster == 2 ? MAX_STAGES - 1 : MAX_DEPTH) || row0 < 0 || row1 < row0 || row1 > N ||
      run < 1 || ctas < 0 || ctas != (row1 - row0 + run - 1) / run || (cluster != 1 && cluster != 2) ||
      (window && (cluster != 1 || bf16)) ||
      (cluster == 2 && (!bf16 || threads < 32 || TK > 4 || T % 4 || run % 4 || ((uintptr_t)data & 15) ||
                        ((uintptr_t)rel & 15))))
    return (int)cudaErrorInvalidValue;
  if (row1 == row0) return 0;
  const int vec = (TK % 2 == 0 && K % 2 == 0) ? 2 : 1;
  const int stride = BLK * TK + vec;
  const long long R = 2 * (long long)bwb + (long long)(D + 1) * T;
  size_t smem = (size_t)R * stride * sizeof(float2);
  StagedPlan sp{{N, S, K, TK, T, bwb, D, (int)R, run}, 0, 0, 0};
  if (cluster == 2) {  // D + 1 stages of a tile's bf16 operator rows and offsets, then the barriers
    const size_t stages = (size_t)(D + 1) * T * S;
    sp.op_off = (int)round16(smem);
    sp.rel_off = (int)(sp.op_off + stages * BLK * sizeof(uint4));  // a bf16 block: 4 uint4
    sp.bar_off = (int)round16(sp.rel_off + stages * sizeof(int));
    smem = sp.bar_off + 16 * (size_t)(D + 1);
  }
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (CHEB && smem < 2 * threads * sizeof(float)) smem = 2 * threads * sizeof(float);  // the tree
  const cudaStream_t st = (cudaStream_t)stream;
  if constexpr (CHEB) {
    if (window) {
      auto go = vec == 2 ? launch_window<CHEB, 2> : launch_window<CHEB, 1>;
      return go(data, rel, t_cur, t_prev, t_next, partials, two_inv, sp.p, row0, row1, threads, ctas, smem, st);
    }
  }
  if (cluster == 2) {
    auto go = vec == 2 ? launch_cluster<CHEB, 2> : launch_cluster<CHEB, 1>;
    return go(data, rel, t_cur, t_prev, t_next, partials, two_inv, sp, threads, ctas, smem, st);
  }
#define GATHER_LAUNCH(V, OP) \
  launch<CHEB, V, OP>(data, rel, t_cur, t_prev, t_next, partials, two_inv, sp.p, threads, ctas, smem, st)
  if (bf16) return vec == 2 ? GATHER_LAUNCH(2, uint4) : GATHER_LAUNCH(1, uint4);
  return vec == 2 ? GATHER_LAUNCH(2, float4) : GATHER_LAUNCH(1, float4);
#undef GATHER_LAUNCH
}

}  // namespace

// The entry points launch on the given stream, do not synchronise, allocate
// nothing, and return the CUDA error of the launch (0 = launched).  The plan
// (ops/cuda_gather.plan_gather): TK probe columns a block and `run` rows a
// block (cluster = 1) or a pair of blocks (cluster = 2, 2*TK columns a pair),
// ctas = ceil(N / run) runs a column tile, tiles of T rows, D tiles in flight
// (0 <= D <= MAX_DEPTH; the cluster form keeps D + 1 stages), `threads` a
// block (the cluster form's consumers, at most 512, beside its producer
// warp); the step's partials are ctas rows of 2K floats.  `bf16`: 0 for a
// complex64 operator, 1 for the bf16 form.

extern "C" int ell_gather_spmm_launch(const void* data, int bf16, const void* rel, const void* v, void* y,
                                      long long N, int S, int K, int TK, int T, int bwb, int D,
                                      long long run, int ctas, int threads, int cluster, void* stream) {
  return dispatch<false>(data, bf16, rel, v, nullptr, y, nullptr, 0.f, N, S, K, TK, T, bwb, D, run, ctas,
                         threads, cluster, stream);
}

extern "C" int ell_gather_cheb_step_launch(const void* data, int bf16, const void* rel, const void* t_cur,
                                           const void* t_prev, void* t_next, void* partials,
                                           float inv, long long N, int S, int K, int TK, int T,
                                           int bwb, int D, long long run, int ctas, int threads,
                                           int cluster, void* stream) {
  return dispatch<true>(data, bf16, rel, t_cur, t_prev, t_next, partials, 2.0f * inv, N, S, K, TK, T,
                        bwb, D, run, ctas, threads, cluster, stream);
}

// The light-cone form: the step on relabelled rows [row0, row1), split into
// ctas = ceil((row1 - row0) / run) runs; partials are ctas rows of 2K floats.
// The complex64 operator and the one-block form only.
extern "C" int ell_gather_cheb_step_window_launch(const void* data, const void* rel, const void* t_cur,
                                                  const void* t_prev, void* t_next, void* partials, float inv,
                                                  long long N, long long row0, long long row1, int S, int K,
                                                  int TK, int T, int bwb, int D, long long run, int ctas,
                                                  int threads, void* stream) {
  return dispatch<true>(data, 0, rel, t_cur, t_prev, t_next, partials, 2.0f * inv, N, S, K, TK, T, bwb, D, run,
                        ctas, threads, 1, stream, true, row0, row1);
}
