// FLASHE double-mask apply on Hopper: AES-256-CTR mask generation fused with
// the mod-2^m lane update.
//
// Replaces flashe_tpu/ops/pallas_flashe.py::_kernel (the Pallas TPU kernel
// behind pallas_mask_apply / pallas_encrypt / pallas_decrypt).  Lane i of q
// belongs to AES block b = base_block + i / merge and is lane j = i % merge
// of that block, merge = 128 / m:
//
//   out[i] = (q[i] + L(add_idx, b, j) - L(minus_idx, b, j)) mod 2^m
//
// where L(s, b, j) is bits [j*m, (j+1)*m) of the big-endian 128-bit value
// AES256_rk(iter (4B BE) || s (4B BE) || b (8B BE)) -- the contract of
// flashe_tpu/ops/masks.py, bit for bit.  m <= 32; lanes are int32 tensors
// holding uint32 bit patterns, and all arithmetic here is uint32.
//
// What bounds it on this card: integer ALU work.  Each block costs two
// AES-256 encryptions (2 x 14 rounds of 16 S-box lookups plus MixColumns)
// against only 8 bytes of device-memory traffic per lane (read q, write out),
// so the kernel sits far on the compute side of the roofline.  The design:
// one thread computes one block for both streams, entirely in registers
// (all loops over state bytes and rounds are unrolled), with the S-box and
// the 240 round-key bytes in shared memory, loaded once per thread block;
// round-key reads are warp-uniform broadcasts.  The 128-bit block is shifted
// down one lane at a time, so no register array is indexed dynamically.
// The TPU kernel's permuted lane layout, 32-aligned counters and tile-size
// switches are not carried over: this kernel reads and writes linear lane
// order and takes any 64-bit base_block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__constant__ uint8_t kSbox[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16};

__device__ __forceinline__ uint32_t xtime(uint32_t a) {
  return ((a << 1) ^ ((a >> 7) * 0x1bu)) & 0xffu;
}

// AES-256 encrypt of the 16 state bytes s (byte i = row i%4 of column i/4).
__device__ __forceinline__ void aes256_encrypt(const uint32_t* sbox,
                                               const uint32_t* rk,
                                               uint32_t s[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] ^= rk[i];
#pragma unroll
  for (int r = 1; r < 14; ++r) {
    uint32_t t[16];
    // SubBytes + ShiftRows: t[row + 4c] = S(s[row + 4((c + row) % 4)])
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int row = i & 3, col = i >> 2;
      t[i] = sbox[s[row + 4 * ((col + row) & 3)]];
    }
    // MixColumns + AddRoundKey
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t a0 = t[4 * c], a1 = t[4 * c + 1], a2 = t[4 * c + 2],
                     a3 = t[4 * c + 3];
      const uint32_t x0 = xtime(a0), x1 = xtime(a1), x2 = xtime(a2),
                     x3 = xtime(a3);
      s[4 * c + 0] = x0 ^ x1 ^ a1 ^ a2 ^ a3 ^ rk[16 * r + 4 * c + 0];
      s[4 * c + 1] = a0 ^ x1 ^ x2 ^ a2 ^ a3 ^ rk[16 * r + 4 * c + 1];
      s[4 * c + 2] = a0 ^ a1 ^ x2 ^ x3 ^ a3 ^ rk[16 * r + 4 * c + 2];
      s[4 * c + 3] = x0 ^ a0 ^ a1 ^ a2 ^ x3 ^ rk[16 * r + 4 * c + 3];
    }
  }
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int row = i & 3, col = i >> 2;
    t[i] = sbox[s[row + 4 * ((col + row) & 3)]];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = t[i] ^ rk[224 + i];
}

// The 128-bit output of one counter block as words w[0] (least significant,
// bytes 12..15 big-endian) .. w[3].
__device__ __forceinline__ void counter_block(const uint32_t* sbox,
                                              const uint32_t* rk,
                                              uint32_t iter, uint32_t idx,
                                              uint64_t ctr, uint32_t w[4]) {
  uint32_t s[16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[k] = (iter >> (24 - 8 * k)) & 0xffu;
    s[4 + k] = (idx >> (24 - 8 * k)) & 0xffu;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) s[8 + k] = (uint32_t)(ctr >> (56 - 8 * k)) & 0xffu;
  aes256_encrypt(sbox, rk, s);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = (s[12 - 4 * k] << 24) | (s[13 - 4 * k] << 16) |
           (s[14 - 4 * k] << 8) | s[15 - 4 * k];
}

// Shift the 128-bit value w right by m bits, 0 < m <= 32.  m == 32 is a
// whole-word move: a C shift by 32 is undefined.
__device__ __forceinline__ void shift_down(uint32_t w[4], int m) {
  if (m == 32) {
    w[0] = w[1];
    w[1] = w[2];
    w[2] = w[3];
    w[3] = 0;
  } else {
    w[0] = (w[0] >> m) | (w[1] << (32 - m));
    w[1] = (w[1] >> m) | (w[2] << (32 - m));
    w[2] = (w[2] >> m) | (w[3] << (32 - m));
    w[3] >>= m;
  }
}

__global__ void __launch_bounds__(kThreads)
    flashe_mask_kernel(const uint32_t* __restrict__ q,
                       uint32_t* __restrict__ out, int64_t count,
                       const int32_t* __restrict__ round_keys, uint32_t iter,
                       uint32_t add_idx, uint32_t minus_idx, int int_bits,
                       uint64_t base_block) {
  __shared__ uint32_t sbox[256];
  __shared__ uint32_t rk[240];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) sbox[i] = kSbox[i];
  for (int i = threadIdx.x; i < 240; i += blockDim.x)
    rk[i] = (uint32_t)round_keys[i] & 0xffu;
  __syncthreads();

  const int merge = 128 / int_bits;
  const int64_t blk = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t first = blk * merge;
  if (first >= count) return;

  const uint64_t ctr = base_block + (uint64_t)blk;
  uint32_t a[4], b[4];
  counter_block(sbox, rk, iter, add_idx, ctr, a);
  counter_block(sbox, rk, iter, minus_idx, ctr, b);

  const uint32_t mask = int_bits == 32 ? 0xffffffffu : (1u << int_bits) - 1u;
  const int n = count - first < merge ? (int)(count - first) : merge;
  for (int j = 0; j < n; ++j) {
    out[first + j] = (q[first + j] + a[0] - b[0]) & mask;
    shift_down(a, int_bits);
    shift_down(b, int_bits);
  }
}

}  // namespace

// q, out: `count` int32 lanes on the device; round_keys: (15, 16) int32 on the
// device; stream: a cudaStream_t.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int flashe_mask_apply(const void* q, void* out, int64_t count,
                                 const void* round_keys, int iter_index,
                                 int add_idx, int minus_idx, int int_bits,
                                 int64_t base_block, void* stream) {
  if (int_bits < 1 || int_bits > 32) return (int)cudaErrorInvalidValue;
  if (count <= 0) return (int)cudaSuccess;
  const int merge = 128 / int_bits;
  const int64_t nblocks = (count + merge - 1) / merge;
  const int64_t grid = (nblocks + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flashe_mask_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)q, (uint32_t*)out, count, (const int32_t*)round_keys,
      (uint32_t)iter_index, (uint32_t)add_idx, (uint32_t)minus_idx, int_bits,
      (uint64_t)base_block);
  return (int)cudaGetLastError();
}
