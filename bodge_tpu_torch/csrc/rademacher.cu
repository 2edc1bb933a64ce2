// Rademacher probe block on the card, bit for bit NumPy's draw (sm_90a).
//
//   rademacher  out[e] = 2 * numpy.random.default_rng(seed).integers(0, 2, size)[e] - 1
//               for the flat index e of the [N, 4, samples] block, as complex64
//               (real part +-1, imaginary part 0) or float32.
//
// The trace estimators of the KPM driver (ops/chebyshev.py: trace_function,
// dos_kpm, and the gap objective's default probes) draw their probes by that
// rule, which is also what the benchmark's check redraws.  The reference
// draws them on the host too (bodge_tpu/ops/chebyshev.py: rademacher_probes);
// no TPU kernel is replaced.  This one exists because the host's draw, its
// float64 arithmetic, its cast and its pageable upload took most of a
// free-energy call at 10^6 sites while the card waited.
//
// The rule.  default_rng(seed) is PCG64 (XSL-RR 128/64) with the 128-bit state
// and increment that NumPy's SeedSequence makes of the seed; the host passes
// both in.  Each draw steps the state first, s <- s*M + inc (mod 2^128), and
// outputs rotr64(hi ^ lo, hi >> 58) of the new state.  integers(0, 2) is
// Lemire's bounded draw on 32-bit halves, low half first, which for a range of
// one never rejects and returns bit 31 of the half.  So entry 2j of the block
// is bit 31 of the j-th 64-bit output and entry 2j+1 is bit 63 of it: each
// output gives one pair of entries.  The block always has an even number of
// entries (4 a site and column).
//
// Parallel draw.  PCG64 is an LCG underneath, so s_{j+d} = A_d*s_j + C_d with
// (A_d, C_d) the d-fold composition of (M, inc), found in O(log d) squarings.
// Thread t of T owns outputs j = t, t + T, t + 2T, ...: it jumps from the seed's
// state by t + 1 with that binary jump, then steps by T with (A_T, C_T), which
// the host computes once.  ops/cuda_probes.py: rademacher_plain is the same
// algorithm in NumPy.
//
// Bound: bytes written.  The kernel reads nothing; it writes 8 bytes an entry
// (complex64) or 4 (float32): 256 MB at 10^6 sites and 8 columns, 0.077 ms at
// 3.35 TB/s.  The arithmetic is a 128-bit multiply-add an output (about a dozen
// 32-bit integer multiplies) plus the start jump, well under the stores' time.
// What the design does about it: each output is one 16-byte store of two
// complex64 (8 bytes of two float32), lanes on consecutive pairs so that a
// warp's stores are coalesced; enough threads in flight (BLOCKS_PER_SM blocks
// of 256 on every SM) to keep the stores streaming; no shared memory, no
// scratch, no host round trip.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned __int128 u128;

constexpr int THREADS = 256;
// PCG64's multiplier, 0x2360ED051FC65DA44385DF649FCCF645.
constexpr uint64_t MULT_HI = 0x2360ED051FC65DA4ULL;
constexpr uint64_t MULT_LO = 0x4385DF649FCCF645ULL;

__device__ __forceinline__ u128 u128_of(uint64_t hi, uint64_t lo) { return ((u128)hi << 64) | lo; }

__device__ __forceinline__ uint64_t pcg_output(u128 s) {
  const uint64_t hi = (uint64_t)(s >> 64), lo = (uint64_t)s;
  const uint64_t x = hi ^ lo;
  const unsigned r = (unsigned)(hi >> 58);
  return (x >> r) | (x << ((64u - r) & 63u));
}

// The state d steps after s: the d-fold composition of s <- s*mult + plus.
__device__ __forceinline__ u128 jump(u128 s, unsigned long long d, u128 mult, u128 plus) {
  u128 acc_mult = 1, acc_plus = 0;
  while (d) {
    if (d & 1ULL) {
      acc_mult *= mult;
      acc_plus = acc_plus * mult + plus;
    }
    plus = (mult + 1) * plus;
    mult *= mult;
    d >>= 1;
  }
  return acc_mult * s + acc_plus;
}

template <bool COMPLEX>
__global__ void __launch_bounds__(THREADS) rademacher_kernel(uint64_t s_hi, uint64_t s_lo, uint64_t inc_hi,
                                                             uint64_t inc_lo, uint64_t at_hi, uint64_t at_lo,
                                                             uint64_t ct_hi, uint64_t ct_lo, long long pairs,
                                                             float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= pairs) return;
  const long long T = (long long)gridDim.x * THREADS;
  const u128 a_T = u128_of(at_hi, at_lo), c_T = u128_of(ct_hi, ct_lo);
  u128 s = jump(u128_of(s_hi, s_lo), (unsigned long long)t + 1, u128_of(MULT_HI, MULT_LO), u128_of(inc_hi, inc_lo));
  for (long long j = t; j < pairs; j += T) {
    const uint64_t x = pcg_output(s);
    const float lo = ((x >> 31) & 1ULL) ? 1.0f : -1.0f;
    const float hi = (x >> 63) ? 1.0f : -1.0f;
    if (COMPLEX) {
      reinterpret_cast<float4*>(out)[j] = make_float4(lo, 0.0f, hi, 0.0f);
    } else {
      reinterpret_cast<float2*>(out)[j] = make_float2(lo, hi);
    }
    s = a_T * s + c_T;
  }
}

}  // namespace

// out: 2 * pairs entries, 16-byte aligned (complex64) or 8-byte aligned
// (float32).  state / inc: the generator's 128-bit state and increment as they
// stand before the first draw; step_mult / step_plus: (A_T, C_T) for
// T = blocks * 256.  Returns the launch's cudaError.
extern "C" int rademacher_launch(unsigned long long state_hi, unsigned long long state_lo,
                                 unsigned long long inc_hi, unsigned long long inc_lo,
                                 unsigned long long step_mult_hi, unsigned long long step_mult_lo,
                                 unsigned long long step_plus_hi, unsigned long long step_plus_lo,
                                 long long pairs, int complex_out, int blocks, void* out, void* stream) {
  if (pairs < 0 || blocks < 1 || out == nullptr) return (int)cudaErrorInvalidValue;
  if (pairs == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (complex_out)
    rademacher_kernel<true><<<blocks, THREADS, 0, s>>>(state_hi, state_lo, inc_hi, inc_lo, step_mult_hi,
                                                        step_mult_lo, step_plus_hi, step_plus_lo, pairs,
                                                        (float*)out);
  else
    rademacher_kernel<false><<<blocks, THREADS, 0, s>>>(state_hi, state_lo, inc_hi, inc_lo, step_mult_hi,
                                                         step_mult_lo, step_plus_hi, step_plus_lo, pairs,
                                                         (float*)out);
  return (int)cudaGetLastError();
}
