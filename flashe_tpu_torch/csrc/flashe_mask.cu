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
// flashe_tpu/ops/masks.py, bit for bit.  Lanes are int32 tensors holding
// uint32 bit patterns, and all arithmetic here is uint32.
//
// The kernel is a template on (STREAMS, LIMBS, SCATTER), one instance a
// mode of the cipher:
//  * STREAMS: bit 0 the add stream, bit 1 the minus stream.  The double
//    mask takes both (3); the single mask's encrypt only the add stream
//    (1, +a_idx) and its decrypt only the minus stream (2, -a_i), so that
//    a launch makes half the AES work.
//  * LIMBS: 32-bit limbs a lane, ceil(m / 32).  At 32 < m <= 128 q and out
//    are (count, LIMBS) little-endian limb rows; a lane is cut limb by limb
//    from the staged words, added and subtracted with add.cc / sub.cc
//    chains, and masked to m bits in its top limb.
//  * SCATTER: the sparse decrypt.  Lane k of the run (counters 0 .. of the
//    client's compact stream) updates the dense aggregate in place at
//    loc[k]: out[loc[k]] = (out[loc[k]] + L(add) - L(minus)) mod 2^m.  A
//    client's locations are distinct, so a launch needs no atomics; the
//    launches of several clients are ordered by their stream.  m <= 32.
// The instance of the dense double mask at m <= 32, <3, 1, 0>, is the one
// that the bound and the design below describe; the others share its AES
// and its staging and have not been tuned.
//
// What bounds it on this card: the kernel's own work in shared memory and
// on the integer pipe, not device memory.  A counter block costs two AES-256
// encryptions against 8 bytes of device memory a lane; an SM takes 32
// shared-memory loads and 64 integer operations a clock.  As built (ptxas,
// CUDA 12.8) a counter block at m = 20 is about 475 loads (436 table words:
// 448 less the 12 that the two streams share in the first round; 15 of round
// keys; 4 for each of its 6 lanes) and about 930 PRMT and LOP3, so the two
// pipes are level, 0.24 us a span of 32 counter blocks on an SM at 1,980
// MHz, and the kernel runs at that rate on an H100 80GB HBM3 at 700 W; a
// launch's fixed cost (the launch, the 64 KB of tables) is about 4 us.  The
// design, each point against one cost:
//
//  * The state is four big-endian column words.  A main round is, for each
//    column, four table words and the round-key word:
//      Te0[s0>>24] ^ Te2[(s2>>8)&255] ^ rk ^ ror8(Te0[(s1>>16)&255] ^ Te2[s3&255])
//    with Te0[x] = (2S, S, S, 3S), Te2 = ror16(Te0), and Te1, Te3 their
//    rotations by 8, taken after the XOR because rotation is linear.  The
//    input is (iter, idx, ctr >> 32, ctr) as it stands and the output
//    columns 3..0 are the words w[0..3] of the 128-bit value: there are no
//    byte splits or merges.  The last round takes S(x) from the tables' own
//    bytes (byte 3 and 0 of Te2[x], byte 2 and 1 of Te0[x]), so there is no
//    S-box table.
//  * The tables are laid out as 256 rows of 256 bytes: row x holds 32 copies
//    of Te0[x], then 32 copies of Te2[x].  Lane l of a warp reads copy l, so
//    it reads bank l whatever x is: no load takes a second pass, and the
//    time does not depend on the data.  The 64 KB lie on a 64 KB boundary
//    of the shared window, so a load's address is the lane's address in row
//    0 with byte 1 replaced by the state byte: one PRMT and no add, and Te2
//    is the immediate offset 128.  A column is 4 PRMT, 4 loads, 2 LOP3 and
//    1 PRMT.
//  * The 60 round-key words are packed once a thread block and read as 15
//    warp-uniform 16-byte loads a counter block, shared by both streams.
//    (Registers would take 60 a thread; a by-value kernel parameter would
//    need the words on the host, a synchronize on every launch.)
//  * One resident set of thread blocks, a block an SM, walks the spans of 32
//    counter blocks: the 64 KB of tables is filled once an SM a launch, and
//    a thread has two streams x four columns of independent chains in
//    flight.  Spans go round-robin over the blocks first, so every SM gets
//    the same number of spans to within one whatever the count is.
//  * A warp's span is 32 x merge consecutive lanes.  The threads put their
//    eight output words in shared memory (5 words a block and stream, an
//    odd stride); then thread t of the warp takes lanes t, t + 32, .. of the
//    span, each cut from the one or two words it lies in with a funnel
//    shift, so q is read and out is written as whole 128-byte lines.
//
// The TPU kernel's bitsliced circuit, permuted lane layout, 32-aligned
// counters and tile-size switches are not carried over: that circuit exists
// because the TPU has no gather.  This kernel reads and writes linear lane
// order and takes any 64-bit base_block.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 32;  // warps a thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kSpan = 32;  // counter blocks a warp makes at a time
constexpr int kMaxDevices = 64;

// Shared memory: the round-key words, each warp's output words, then the
// tables on the next 64 KB boundary of the shared window (the window's base
// is the runtime's, so room for the largest gap is asked for).
constexpr int kRowBytes = 256;  // 32 x Te0[x], 32 x Te2[x]
constexpr int kTe2 = 128;       // byte offset of the Te2 copies in a row
constexpr int kTableBytes = 256 * kRowBytes;
constexpr int kKeyBytes = 256;  // 60 words, padded
constexpr int kWordStride = 5;  // words a counter block and stream (4 + 1)
constexpr int kStageWords = 2 * kSpan * kWordStride;  // a warp, both streams
constexpr int kHeadBytes = kKeyBytes + 4 * kWarps * kStageWords;
constexpr int kSmemBytes = kHeadBytes + 2 * kTableBytes;
static_assert(kTableBytes == 1 << 16, "a row address is the table's with "
                                      "byte 1 replaced");

// A 32-bit load at byte address `addr` + OFFSET of the shared window.
template <int OFFSET>
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm("ld.shared.u32 %0, [%1+%2];" : "=r"(v) : "r"(addr), "n"(OFFSET));
  return v;
}

// Address of this lane's copy in the table row of state byte ROW of s (row 0
// is the most significant byte).  `tab` is the address of the lane's copy in
// row 0, whose byte 1 is 0 because the tables lie on a 64 KB boundary of the
// shared window: the row's address is tab with byte 1 replaced by the state
// byte, one PRMT and no add.
template <int ROW>
__device__ __forceinline__ uint32_t row_addr(uint32_t s, uint32_t tab) {
  return __byte_perm(s, tab, 0x7604 | ((3 - ROW) << 4));
}

// One column of a main round: SubBytes, ShiftRows (a, b, c, d are the state
// words that rows 0..3 of this column come from), MixColumns, AddRoundKey.
__device__ __forceinline__ uint32_t column(uint32_t tab, uint32_t a,
                                           uint32_t b, uint32_t c, uint32_t d,
                                           uint32_t k) {
  const uint32_t ta = lds32<0>(row_addr<0>(a, tab));
  const uint32_t tb = lds32<0>(row_addr<1>(b, tab));
  const uint32_t tc = lds32<kTe2>(row_addr<2>(c, tab));
  const uint32_t td = lds32<kTe2>(row_addr<3>(d, tab));
  return ta ^ tc ^ k ^ __byte_perm(tb ^ td, 0, 0x0321);  // ror 8
}

// One column of the last round (no MixColumns): S(x) is byte 3 and byte 0 of
// Te2[x] and byte 2 and byte 1 of Te0[x].
__device__ __forceinline__ uint32_t last_column(uint32_t tab, uint32_t a,
                                                uint32_t b, uint32_t c,
                                                uint32_t d, uint32_t k) {
  const uint32_t ta = lds32<kTe2>(row_addr<0>(a, tab));
  const uint32_t tb = lds32<0>(row_addr<1>(b, tab));
  const uint32_t tc = lds32<0>(row_addr<2>(c, tab));
  const uint32_t td = lds32<kTe2>(row_addr<3>(d, tab));
  const uint32_t hi = __byte_perm(ta, tb, 0x3600);  // ta.3, tb.2, -, -
  const uint32_t lo = __byte_perm(tc, td, 0x0014);  // -, -, tc.1, td.0
  return __byte_perm(hi, lo, 0x3254) ^ k;
}

template <bool LAST>
__device__ __forceinline__ void aes_round(uint32_t tab, const uint4 k,
                                          uint32_t s[4]) {
  uint32_t t[4];
  if (LAST) {
    t[0] = last_column(tab, s[0], s[1], s[2], s[3], k.x);
    t[1] = last_column(tab, s[1], s[2], s[3], s[0], k.y);
    t[2] = last_column(tab, s[2], s[3], s[0], s[1], k.z);
    t[3] = last_column(tab, s[3], s[0], s[1], s[2], k.w);
  } else {
    t[0] = column(tab, s[0], s[1], s[2], s[3], k.x);
    t[1] = column(tab, s[1], s[2], s[3], s[0], k.y);
    t[2] = column(tab, s[2], s[3], s[0], s[1], k.z);
    t[3] = column(tab, s[3], s[0], s[1], s[2], k.w);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = t[c];
}

// AES-256 of (iter, add_idx, ctr) into a and of (iter, minus_idx, ctr) into
// b, as column words: a[c] holds output bytes 4c .. 4c + 3, big-endian.  The
// two blocks share every round-key load, and in the first round the lookups
// of the three words they have in common.
__device__ __forceinline__ void aes256_pair(uint32_t tab, const uint4* rk,
                                            uint32_t iter, uint32_t add_idx,
                                            uint32_t minus_idx, uint64_t ctr,
                                            uint32_t a[4], uint32_t b[4]) {
  uint4 k = rk[0];
  a[0] = b[0] = iter ^ k.x;
  a[1] = add_idx ^ k.y;
  b[1] = minus_idx ^ k.y;
  a[2] = b[2] = (uint32_t)(ctr >> 32) ^ k.z;
  a[3] = b[3] = (uint32_t)ctr ^ k.w;
#pragma unroll
  for (int r = 1; r < 14; ++r) {
    k = rk[r];
    aes_round<false>(tab, k, a);
    aes_round<false>(tab, k, b);
  }
  k = rk[14];
  aes_round<true>(tab, k, a);
  aes_round<true>(tab, k, b);
}

// AES-256 of (iter, idx, ctr) alone into s, for a launch with one stream.
__device__ __forceinline__ void aes256_one(uint32_t tab, const uint4* rk,
                                           uint32_t iter, uint32_t idx,
                                           uint64_t ctr, uint32_t s[4]) {
  uint4 k = rk[0];
  s[0] = iter ^ k.x;
  s[1] = idx ^ k.y;
  s[2] = (uint32_t)(ctr >> 32) ^ k.z;
  s[3] = (uint32_t)ctr ^ k.w;
#pragma unroll
  for (int r = 1; r < 14; ++r) aes_round<false>(tab, rk[r], s);
  aes_round<true>(tab, rk[14], s);
}

// r += v (ADD) or r -= v, mod 2^(32 L), one carry or borrow chain.
template <int L, bool ADD>
__device__ __forceinline__ void limbs_add(uint32_t r[L], const uint32_t v[L]) {
  static_assert(L >= 2 && L <= 4, "multi-limb lanes have 2 to 4 limbs");
  if (L == 2) {
    if (ADD)
      asm("add.cc.u32 %0, %0, %2;\n\taddc.u32 %1, %1, %3;"
          : "+r"(r[0]), "+r"(r[1]) : "r"(v[0]), "r"(v[1]));
    else
      asm("sub.cc.u32 %0, %0, %2;\n\tsubc.u32 %1, %1, %3;"
          : "+r"(r[0]), "+r"(r[1]) : "r"(v[0]), "r"(v[1]));
  } else if (L == 3) {
    if (ADD)
      asm("add.cc.u32 %0, %0, %3;\n\taddc.cc.u32 %1, %1, %4;\n\t"
          "addc.u32 %2, %2, %5;"
          : "+r"(r[0]), "+r"(r[1]), "+r"(r[2])
          : "r"(v[0]), "r"(v[1]), "r"(v[2]));
    else
      asm("sub.cc.u32 %0, %0, %3;\n\tsubc.cc.u32 %1, %1, %4;\n\t"
          "subc.u32 %2, %2, %5;"
          : "+r"(r[0]), "+r"(r[1]), "+r"(r[2])
          : "r"(v[0]), "r"(v[1]), "r"(v[2]));
  } else {
    if (ADD)
      asm("add.cc.u32 %0, %0, %4;\n\taddc.cc.u32 %1, %1, %5;\n\t"
          "addc.cc.u32 %2, %2, %6;\n\taddc.u32 %3, %3, %7;"
          : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3])
          : "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]));
    else
      asm("sub.cc.u32 %0, %0, %4;\n\tsubc.cc.u32 %1, %1, %5;\n\t"
          "subc.cc.u32 %2, %2, %6;\n\tsubc.u32 %3, %3, %7;"
          : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3])
          : "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]));
  }
}

// The L limbs of a lane that starts at bit `bit` of the staged words w
// (w[0] least significant; bits past the lane's end are masked off later,
// so the fifth word of a block, never written, is read only into them).
template <int L>
__device__ __forceinline__ void cut_limbs(const uint32_t* w, uint32_t p,
                                          uint32_t bit, uint32_t v[L]) {
#pragma unroll
  for (int l = 0; l < L; ++l) v[l] = __funnelshift_r(w[p + l], w[p + l + 1], bit);
}

template <int STREAMS, int LIMBS, int SCATTER>
__global__ void __launch_bounds__(kThreads, 1)
    flashe_mask_kernel(const uint32_t* __restrict__ q,
                       uint32_t* __restrict__ out, int64_t count,
                       const int32_t* __restrict__ round_keys,
                       const uint32_t* __restrict__ te0, uint32_t iter,
                       uint32_t add_idx, uint32_t minus_idx, int int_bits,
                       uint64_t base_block, int64_t nspans, uint32_t magic,
                       const int64_t* __restrict__ loc, int64_t n_out) {
  static_assert(STREAMS >= 1 && STREAMS <= 3, "at least one stream");
  static_assert(!SCATTER || LIMBS == 1, "the scatter takes m <= 32");
  extern __shared__ __align__(256) unsigned char smem[];
  const uint32_t window = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t gap = -(window + kHeadBytes) & (kTableBytes - 1);
  // The tables: word e of the 256 x 64 is copy e % 32 of Te0 (e & 32 clear)
  // or Te2 of x = e / 64.  A warp writes 32 neighbouring words.
  uint32_t* tabw = reinterpret_cast<uint32_t*>(smem + kHeadBytes + gap);
#pragma unroll 4
  for (int e = threadIdx.x; e < kTableBytes / 4; e += kThreads) {
    const uint32_t t = te0[e >> 6];
    tabw[e] = (e & 32) ? __byte_perm(t, 0, 0x1032) : t;  // ror 16
  }
  // The round keys, (15, 16) byte values, as 60 big-endian words.
  uint32_t* rkw = reinterpret_cast<uint32_t*>(smem);
  if (threadIdx.x < 60) {
    const int32_t* p = round_keys + 4 * threadIdx.x;
    rkw[threadIdx.x] = ((uint32_t)p[0] & 0xffu) << 24 |
                       ((uint32_t)p[1] & 0xffu) << 16 |
                       ((uint32_t)p[2] & 0xffu) << 8 | ((uint32_t)p[3] & 0xffu);
  }
  __syncthreads();

  const uint4* rk = reinterpret_cast<const uint4*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this lane's copy in row 0: a multiple of 64 KB plus 4 * lane
  const uint32_t tab = window + kHeadBytes + gap + 4 * lane;
  uint32_t* wa = reinterpret_cast<uint32_t*>(smem + kKeyBytes) +
                 warp * kStageWords;
  uint32_t* wb = wa + kSpan * kWordStride;
  const uint32_t merge = 128 / int_bits;
  // m == 32 is a whole-word lane: a C shift by 32 is undefined.  With
  // limbs, the mask of the top limb.
  const int top_bits = int_bits - 32 * (LIMBS - 1);
  const uint32_t mask = top_bits == 32 ? 0xffffffffu : (1u << top_bits) - 1u;

  // Span s belongs to warp s / gridDim.x % kWarps of block s % gridDim.x.
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  for (int64_t span = (int64_t)warp * gridDim.x + blockIdx.x; span < nspans;
       span += stride) {
    const uint64_t ctr = base_block + (uint64_t)(span * kSpan + lane);
    uint32_t a[4], b[4];
    if (STREAMS == 3)
      aes256_pair(tab, rk, iter, add_idx, minus_idx, ctr, a, b);
    else if (STREAMS == 1)
      aes256_one(tab, rk, iter, add_idx, ctr, a);
    else
      aes256_one(tab, rk, iter, minus_idx, ctr, b);
    // w[0] (least significant, bytes 12..15) .. w[3]; the fifth word of a
    // block is never written: a lane's bits end at or below bit 128
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (STREAMS & 1) wa[lane * kWordStride + w] = a[3 - w];
      if (STREAMS & 2) wb[lane * kWordStride + w] = b[3 - w];
    }
    __syncwarp();
    const int64_t lane0 = span * kSpan * merge;
    for (uint32_t i = lane; i < kSpan * merge; i += 32) {
      // lane i of the span: block i / merge (magic = 2^32 / merge, rounded
      // up, exact for i < 4096; at m > 64 a block is one lane), bits
      // [bit, bit + m) of its 128
      const uint32_t blk = LIMBS > 2 ? i : __umulhi(i, magic);
      const uint32_t bit = (i - blk * merge) * int_bits;
      const uint32_t p = blk * kWordStride + (bit >> 5);
      const int64_t g = lane0 + i;
      if (LIMBS == 1) {
        const uint32_t va =
            (STREAMS & 1) ? __funnelshift_r(wa[p], wa[p + 1], bit) : 0u;
        const uint32_t vb =
            (STREAMS & 2) ? __funnelshift_r(wb[p], wb[p + 1], bit) : 0u;
        if (SCATTER) {
          if (g < count) {
            const int64_t d = loc[g];
            // a location outside the aggregate is refused by the caller;
            // here it only must not write out of bounds
            if ((uint64_t)d < (uint64_t)n_out)
              out[d] = (out[d] + va - vb) & mask;
          }
        } else if (g < count) {
          out[g] = (q[g] + va - vb) & mask;
        }
      } else if (g < count) {
        constexpr int L = LIMBS > 1 ? LIMBS : 2;  // LIMBS == 1 never here
        uint32_t r[L], v[L];
#pragma unroll
        for (int l = 0; l < L; ++l) r[l] = q[g * L + l];
        if (STREAMS & 1) {
          cut_limbs<L>(wa, p, bit, v);
          limbs_add<L, true>(r, v);
        }
        if (STREAMS & 2) {
          cut_limbs<L>(wb, p, bit, v);
          limbs_add<L, false>(r, v);
        }
        r[L - 1] &= mask;
#pragma unroll
        for (int l = 0; l < L; ++l) out[g * L + l] = r[l];
      }
    }
    __syncwarp();
  }
}

// Thread blocks of a kernel instance resident on the current device at once
// (SMs x blocks an SM), asked of the runtime on the instance's first launch
// on the device and kept, one slot a device (0: not yet asked).  The
// kernel's shared memory, above 48 KB, is asked for first.  0 with *rc set
// if the kernel cannot be resident.
template <int S, int L, int X>
int64_t resident_blocks(int* rc) {
  static std::atomic<int64_t> cache[kMaxDevices];
  const auto kernel = flashe_mask_kernel<S, L, X>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= kMaxDevices) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess) {
    const int64_t known = cache[dev].load(std::memory_order_acquire);
    if (known > 0) return known;
  }
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, kSmemBytes);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) {
    *rc = (int)e;
    return 0;
  }
  const int64_t resident = (int64_t)sms * per_sm;
  cache[dev].store(resident, std::memory_order_release);
  return resident;
}

struct Launch {
  const void* q;
  void* out;
  int64_t count;
  const void* round_keys;
  int iter_index, add_idx, minus_idx, int_bits;
  int64_t base_block;
  const void* loc;
  int64_t n_out;
  void* stream;
  const void* te0;
};

// One launch of instance <S, L, X> over `count` lanes (count > 0).
template <int S, int L, int X>
int launch(const Launch& a) {
  int rc = (int)cudaSuccess;
  const int64_t resident = resident_blocks<S, L, X>(&rc);
  if (resident == 0) return rc;
  const int64_t merge = 128 / a.int_bits;
  const int64_t nblocks = (a.count + merge - 1) / merge;
  const int64_t nspans = (nblocks + kSpan - 1) / kSpan;
  const int64_t grid = nspans < resident ? nspans : resident;
  flashe_mask_kernel<S, L, X><<<(unsigned)grid, kThreads, kSmemBytes,
                                (cudaStream_t)a.stream>>>(
      (const uint32_t*)a.q, (uint32_t*)a.out, a.count,
      (const int32_t*)a.round_keys, (const uint32_t*)a.te0,
      (uint32_t)a.iter_index, (uint32_t)a.add_idx, (uint32_t)a.minus_idx,
      a.int_bits, (uint64_t)a.base_block, nspans,
      0xffffffffu / (uint32_t)merge + 1u, (const int64_t*)a.loc, a.n_out);
  return (int)cudaGetLastError();
}

template <int S>
int launch_dense(const Launch& a, int limbs) {
  switch (limbs) {
    case 1: return launch<S, 1, 0>(a);
    case 2: return launch<S, 2, 0>(a);
    case 3: return launch<S, 3, 0>(a);
    default: return launch<S, 4, 0>(a);
  }
}

}  // namespace

// The dense double mask at m <= 32, instance <3, 1, 0>.  q, out: `count`
// int32 lanes on the device; round_keys: (15, 16) int32 on the device;
// stream: a cudaStream_t; te0: the 256 words Te0[x] = (2 S(x), S(x), S(x),
// 3 S(x)), most significant byte first, on the device.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flashe_mask_apply(const void* q, void* out, int64_t count,
                                 const void* round_keys, int iter_index,
                                 int add_idx, int minus_idx, int int_bits,
                                 int64_t base_block, void* stream,
                                 const void* te0) {
  if (int_bits < 1 || int_bits > 32 || te0 == nullptr)
    return (int)cudaErrorInvalidValue;
  if (count <= 0) return (int)cudaSuccess;
  return launch<3, 1, 0>({q, out, count, round_keys, iter_index, add_idx,
                          minus_idx, int_bits, base_block, nullptr, 0, stream,
                          te0});
}

// Every mode.  streams: bit 0 the add stream (add_idx), bit 1 the minus
// stream (minus_idx), at least one.  int_bits 1 to 128: above 32, q and out
// are `count` rows of ceil(int_bits / 32) int32 limbs.  loc null: the dense
// apply, out = q + add - minus.  loc non-null: the scatter, which takes
// int_bits <= 32 and the minus stream, reads no q, and updates `out` (n_out
// lanes) in place at the `count` distinct int64 positions loc[0 ..
// count - 1], from counter block base_block on.  Returns as
// flashe_mask_apply.
extern "C" int flashe_mask_apply_modes(const void* q, void* out, int64_t count,
                                       const void* round_keys, int iter_index,
                                       int add_idx, int minus_idx, int streams,
                                       int int_bits, int64_t base_block,
                                       const void* loc, int64_t n_out,
                                       void* stream, const void* te0) {
  const bool scatter = loc != nullptr;
  if (streams < 1 || streams > 3 || int_bits < 1 || int_bits > 128 ||
      te0 == nullptr || (scatter && (int_bits > 32 || !(streams & 2))))
    return (int)cudaErrorInvalidValue;
  if (count <= 0) return (int)cudaSuccess;
  const Launch a{q, out, count, round_keys, iter_index, add_idx, minus_idx,
                 int_bits, base_block, loc, n_out, stream, te0};
  if (scatter)
    return streams == 3 ? launch<3, 1, 1>(a) : launch<2, 1, 1>(a);
  const int limbs = (int_bits + 31) / 32;
  switch (streams) {
    case 1: return launch_dense<1>(a, limbs);
    case 2: return launch_dense<2>(a, limbs);
    default: return launch_dense<3>(a, limbs);
  }
}

// Counter blocks a warp makes at a time: its span is this many x merge lanes.
extern "C" int flashe_mask_span_blocks(void) { return kSpan; }

// Counter blocks one pass of the resident grid covers on the current device
// (resident threads); minus the CUDA error if the kernel cannot be resident.
extern "C" int64_t flashe_mask_pass_blocks(void) {
  int rc = (int)cudaSuccess;
  const int64_t resident = resident_blocks<3, 1, 0>(&rc);
  return resident == 0 ? -(int64_t)rc : resident * kThreads;
}
