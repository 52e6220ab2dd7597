// Two ceilings of the card, measured for the benchmark harness's roofline
// mode (flashe_tpu_torch/tools/bench.py, through tools/ceiling.py).
//
//   ceiling_int_chain  the 32-bit integer rate.  It replaces the XLA chain
//                      of bench.py's roofline mode (bench.py:906-917), which
//                      measured the TPU's vector unit; no Pallas kernel.
//                      Each thread runs one element through 64 dependent
//                      steps of x ^= c_s; x += x >> 7; x ^= x << 3 (5
//                      operations a step in the source, 320 an element).
//                      The chain is dependent within a thread and
//                      independent across threads, one element a thread,
//                      256 threads a block and n / 256 blocks, so that 132
//                      SMs are full many times over.  ptxas may fuse steps
//                      (a 3-input LOP3 takes one xor into the next, LEA.HI
//                      a shift and its add): the harness counts the
//                      integer instructions in the SASS and states the rate
//                      in both counts.
//   ceiling_lds_chain  the shared-memory load rate, which bounds the mask
//                      kernel (224 table loads an AES block,
//                      tools/roofline.py).  Each thread walks 4 independent
//                      chains of 64 dependent loads through a 4 KB table,
//                      v = tbl[(v & 0xF80) | lane * 4] by byte offset: one
//                      LOP3 and one LDS a load, the lane's own bank, so no
//                      two lanes of a warp conflict.
//
// Bytes: an element is read once and written once (8 bytes), against 320
// operations or 256 loads: both kernels are bound by their pipe, not by
// device memory.  The chains' results are written out, so no work can be
// dropped; the harness checks them against the same chains in plain torch
// (tools/ceiling.py).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChainSteps = 64;
constexpr int kLdsSteps = 64;
constexpr int kLdsChains = 4;
constexpr int kTableWords = 1024;  // 32 rows of 32 words
constexpr int kThreads = 256;

struct ChainConsts {
  uint32_t c[kChainSteps];
};

__device__ __forceinline__ uint32_t table_word(uint32_t j) {
  return j * 2654435761u ^ 0x5bd1e995u;
}

__global__ void __launch_bounds__(kThreads)
    int_chain_kernel(const uint32_t* __restrict__ in,
                     uint32_t* __restrict__ out, int64_t n,
                     const ChainConsts k) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t x = in[i];
#pragma unroll
  for (int s = 0; s < kChainSteps; ++s) {
    x ^= k.c[s];
    x += x >> 7;
    x ^= x << 3;
  }
  out[i] = x;
}

__global__ void __launch_bounds__(kThreads)
    lds_chain_kernel(const uint32_t* __restrict__ in,
                     uint32_t* __restrict__ out, int64_t n) {
  __shared__ uint32_t tbl[kTableWords];
  for (int j = threadIdx.x; j < kTableWords; j += kThreads)
    tbl[j] = table_word(j);
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t lane4 = (threadIdx.x & 31u) << 2;
  const char* base = reinterpret_cast<const char*>(tbl);
  uint32_t v[kLdsChains];
  const uint32_t x = in[i];
#pragma unroll
  for (int c = 0; c < kLdsChains; ++c) v[c] = x ^ (0x9e3779b9u * c);
#pragma unroll
  for (int s = 0; s < kLdsSteps; ++s) {
#pragma unroll
    for (int c = 0; c < kLdsChains; ++c)
      v[c] = *reinterpret_cast<const uint32_t*>(base + ((v[c] & 0xF80u) |
                                                         lane4));
  }
  out[i] = v[0] ^ v[1] ^ v[2] ^ v[3];
}

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Both entry points take device pointers to contiguous int32 tensors of n
// elements (uint32 bit patterns) and a cudaStream_t, and return
// cudaGetLastError() after the launch (0 on success).  consts: the host's
// kChainSteps uint32 constants, passed by value in the kernel's parameters.

extern "C" int ceiling_int_chain(const void* in, void* out, int64_t n,
                                 const uint32_t* consts, void* stream) {
  if (n < 0 || n > (int64_t)0x7fffffff * kThreads)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  ChainConsts k;
  for (int s = 0; s < kChainSteps; ++s) k.c[s] = consts[s];
  int_chain_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, n, k);
  return (int)cudaGetLastError();
}

extern "C" int ceiling_lds_chain(const void* in, void* out, int64_t n,
                                 void* stream) {
  if (n < 0 || n > (int64_t)0x7fffffff * kThreads)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  lds_chain_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

// The chains' shapes, for the host's plain versions and its op counts:
// (int steps, load steps, load chains, threads a block, table words).
extern "C" int ceiling_shape(int which) {
  switch (which) {
    case 0: return kChainSteps;
    case 1: return kLdsSteps;
    case 2: return kLdsChains;
    case 3: return kThreads;
    case 4: return kTableWords;
    default: return -1;
  }
}
