// The two forms the forward kernels take the block operator in (sm_90a).
//
//   complex64  data[N, S, 4, 4] complex64: a block is 128 bytes, 8 float4; row a
//              of a block is float4 2a (entries (a,0), (a,1)) and 2a+1.
//   bf16       data[N, S, 4, 4, 2] bfloat16, each complex entry one (re, im)
//              pair of 4 bytes: a block is 64 bytes, 4 uint4; row a of a block
//              is uint4 a, one 16-byte load.
//
// The bf16 form is the counterpart of the reference's bfloat16 operator
// storage (bodge_tpu/ops/pallas_spmm.py:332 `b_ref[...].astype(jnp.float32)`,
// :737-743 `_bload_from_ref`, bodge_tpu/ops/pallas_gather.py:223-226): the
// kernels upcast each entry to float32 on load and do all arithmetic, sums
// and accumulation in float32, as with the complex64 form.  It halves the
// operator's bytes, the largest stream of a step at small K.  A bf16 value is
// the upper half of the float32 with the same bits, so the upcast is exact:
// a shift for the real part (the low half of the pair's 32-bit word) and a
// mask for the imaginary part, what __bfloat162float does.

#pragma once

#include <cuda_runtime.h>

namespace opform {

template <typename OP>
struct Op;

template <>
struct Op<float4> {  // complex64
  static constexpr int PER_BLOCK = 8;
};

template <>
struct Op<uint4> {  // bf16 pairs
  static constexpr int PER_BLOCK = 4;
};

// One (re, im) bf16 pair, the 32-bit word w = re | im << 16, as float32.
__device__ __forceinline__ float2 bf16_pair(unsigned w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// Row a of the block at `blk` as four complex entries.
__device__ __forceinline__ void load_row(const float4* blk, int a, float2 (&d)[4]) {
  const float4 d01 = __ldg(blk + 2 * a);
  const float4 d23 = __ldg(blk + 2 * a + 1);
  d[0] = make_float2(d01.x, d01.y);
  d[1] = make_float2(d01.z, d01.w);
  d[2] = make_float2(d23.x, d23.y);
  d[3] = make_float2(d23.z, d23.w);
}

__device__ __forceinline__ void load_row(const uint4* blk, int a, float2 (&d)[4]) {
  const uint4 q = __ldg(blk + a);
  d[0] = bf16_pair(q.x);
  d[1] = bf16_pair(q.y);
  d[2] = bf16_pair(q.z);
  d[3] = bf16_pair(q.w);
}

}  // namespace opform
