// Montgomery arithmetic on Hopper for the Paillier baseline: three kernels.
//
//   mont_mul       replaces flashe_tpu/ops/pallas_modmath.py::_kernel
//                  (CIOS a*b*R^-1 mod n, one modulus shared by every row);
//   mont_mul_vec   replaces pallas_modmath.py::_kernel_vec
//                  (the same product with a modulus and n' per row);
//   mont_exp_rows  replaces pallas_modmath.py::_kernel_exp and its helper
//                  _cios_val (a whole fixed-window modexp per row).
//
// Numbers are rows of L uint32 little-endian limbs, 1 <= L <= 128, and
// R = 2^(32 L).  L is never padded: a wider L would change R.  Operands are
// below their modulus n (odd, n < R), n' = -n^-1 mod 2^32, and every result
// is fully reduced, below n.
//
// What bounds them on this card: 32-bit integer multiplies.  A Montgomery
// product of L limbs is 2 L^2 limb products (a_i b_j and m n_j), each two
// IMADs (low and high word), so 4 L^2 IMADs a row; the IMAD pipe issues 64
// lanes a clock an SM, 1.67e13 IMAD/s on 132 SMs at 1.98 GHz.  Device memory
// moves 12 L bytes a row a product (a, b, out), a tenth of that time.
//
// Design.  A row is held by a group of TPI threads of one warp (TPI = 8, 16
// or 32; 32 / TPI rows a warp), each lane l of the group holding the K
// limbs l K .. l K + K - 1 of each operand in registers, K = ceil(L / TPI)
// rounded up to even by the table below; limbs at or above L are zero and
// stay zero.  The accumulator is two arrays of K 32-bit words a lane, as in
// sppark's mont_t: x[j] at limb l K + j takes the products of the even
// limbs of b (and n), y[j] at limb l K + j + 1 those of the odd ones, so
// that a product's low and high words go to neighbouring words of one carry
// chain (mad.lo.cc then madc.hi.cc on the same operands), which ptxas fuses
// into one IMAD.WIDE.U32 with carry in and out; one carry word c sits at
// limb l K + K + 1.  CIOS step i (i < L):
//   - the previous step's division by 2^32: y becomes x (with x's limb 1
//     added to its word 0), and x two limbs down becomes y, topped by the
//     upper neighbour's x[0] (a shuffle; the group's top lane gets lane 0's,
//     which is 0) and by c.  The moves are the addends of the next chain;
//   - a_i is broadcast from its lane with a shuffle of width TPI;
//   - y += a_i b_odd, x += a_i b_even: two chains of K/2 fused products;
//   - m = x_0 n' is formed on the group's lane 0 and broadcast;
//   - y += m n_odd, x += m n_even; the group's limb 0 is now 0.
// Each chain's carry out goes into c (x's by way of y's top word), so c
// stays below 5.  A limb product costs one IMAD.WIDE (the two IMADs of the
// bound) and nothing else; a step adds 3 shuffles and a dozen other
// instructions (carry adds, n', register moves).  The limb loop is unrolled
// four steps of K deep, which removes most of the moves that the swap of x
// and y costs at a loop's back edge.
// After the last step its division by 2^32 adds x one limb down into y,
// and the end adds each lane's c into its upper neighbour and resolves the
// carries between lanes at once from ballots of the lanes' generate and
// propagate bits (a 32-bit add of the two masks is the Kogge-Stone scan).
// A value at or above position L is the overflow limb: the CIOS result
// T < 2n may exceed R, and n is subtracted when that limb is set or the low
// L limbs are >= n (pallas_modmath.py:113-123); the same ballot trick gives
// low + (R - n) and its carry out, which is set iff low >= n.
//
// (TPI, K) by L, in dispatch(), the one place that decides it (mont_layout
// reports it to the host):
//   L <= 16: (8, 2)    L <= 32: (8, 4)    L <= 64: (8, 8)    L <= 128: (16, 8)
// The two wide widths are the Paillier round's (mod p^2 and q^2 in the
// decrypt, L = 64; mod n^2 in the encrypt, L = 128); their TPI was chosen by
// timing 8, 16 and 32 threads a row on an H100 at the round's shapes.  At
// L = 64, 8 threads of 8 limbs win: mont_exp_rows is held to 14 warps an SM
// by its 4 KB a row of table, and 16 products a step hide more latency than
// 8.  At L = 128, 16 threads of 8 limbs win: 8 threads of 16 limbs need 128
// registers a thread.  The narrow widths run in tests only.
//
// Whole waves.  Every kernel runs one resident set of blocks, sized from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor: with W waves of row groups
// needed at full occupancy, the grid is 1 / W of the groups' blocks, and
// each block strides over W of them, so no SM is left with a partial wave.
// The resident count is asked of the runtime once per kernel instance and
// device and kept, so a launch does only the arithmetic and the launch.
// The stride loop's trip count depends on the block alone: a count that
// depended on the warp would leave the compiler unsure that a warp is
// converged, and it wraps every shuffle in a WARPSYNC.COLLECTIVE region.
//
// mont_exp_rows keeps its 2^4-entry table in shared memory (16 L words a
// row, 4 KB at L = 64), laid out so that lane j of a warp reads word j of
// each 32-word line: conflict-free, and only the lane that wrote an entry
// reads it.  Its rows pick their modulus from a small table by mod_idx, so
// rows of several moduli mix in one launch.  The exponent is secret in
// Paillier's CRT decrypt: every digit does 4 squarings and one multiply, and
// the table entry is selected by a loop over all 16 entries with predicated
// moves, so no branch and no address depends on a digit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 4;     // warps a block of mont_mul and mont_mul_vec
constexpr int kExpWarps = 2;  // warps a block of mont_exp_rows
constexpr int kMaxLimbs = 128;
constexpr int kWindow = 4;
constexpr int kTable = 1 << kWindow;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// 32-bit carry-chain primitives; a chain's instructions are issued back to
// back, with no other carry-flag user between them.
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t d;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The TPI lanes of a warp that hold one row.
template <int TPI>
struct Group {
  static constexpr int kRows = 32 / TPI;  // rows a warp
  int lane;   // lane within the group, 0 .. TPI - 1
  int first;  // the group's first lane in the warp
  __device__ __forceinline__ Group()
      : lane(threadIdx.x & (TPI - 1)), first((threadIdx.x & 31) & ~(TPI - 1)) {}
  // this group's bits of a warp ballot, lane 0 in bit 0
  __device__ __forceinline__ uint32_t bits(uint32_t ballot) const {
    if constexpr (TPI == 32) {
      return ballot;
    } else {
      return (ballot >> first) & ((1u << TPI) - 1u);
    }
  }
};

template <int K>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ p, int L,
                                         int lane, uint32_t v[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane * K + k;
    v[k] = j < L ? p[j] : 0u;
  }
}

template <int K>
__device__ __forceinline__ void store_row(uint32_t* __restrict__ p, int L,
                                          int lane, const uint32_t v[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane * K + k;
    if (j < L) p[j] = v[k];
  }
}

// Limbs t (position lane K + k) and carry words c (position lane K + K)
// -> the 32-bit digits d of their value's low 32 TPI K bits.  Returns
// whether the value has any part at or above position L.
template <int TPI, int K>
__device__ __forceinline__ bool normalize(const uint32_t t[K], uint32_t c,
                                          int L, const Group<TPI>& g,
                                          uint32_t d[K]) {
  // the lower neighbour's c (< 8) joins limb 0; that ripple makes at most
  // a one-bit carry out of the lane
  uint32_t cin = __shfl_up_sync(kFull, c, 1, TPI);
  const uint32_t top = __shfl_sync(kFull, c, TPI - 1, TPI);
  if (g.lane == 0) cin = 0;
  d[0] = add_cc(t[0], cin);
#pragma unroll
  for (int k = 1; k < K; ++k) d[k] = addc_cc(t[k], 0u);
  const uint32_t gen = addc(0u, 0u);
  bool ones = true;
#pragma unroll
  for (int k = 0; k < K; ++k) ones = ones && d[k] == 0xffffffffu;
  // a lane that carried out holds a small low limb, so it never
  // propagates: generate and propagate masks are disjoint, and the carry
  // into lane l is bit l of (G|P) + G xor (G|P) xor G
  const uint32_t G = g.bits(__ballot_sync(kFull, gen != 0));
  const uint32_t X = G | g.bits(__ballot_sync(kFull, ones));
  const uint64_t sum = (uint64_t)X + G;
  const uint32_t cbit = (uint32_t)((sum ^ X ^ G) >> g.lane) & 1u;
  d[0] = add_cc(d[0], cbit);
#pragma unroll
  for (int k = 1; k < K; ++k) d[k] = addc_cc(d[k], 0u);
  bool high = false;
#pragma unroll
  for (int k = 0; k < K; ++k) high = high || (g.lane * K + k >= L && d[k] != 0);
  return g.bits(__ballot_sync(kFull, high)) != 0 || top != 0 ||
         ((sum >> TPI) & 1u) != 0;
}

// d <- d - n when `over` or d >= n (d's limbs below L), else d unchanged.
template <int TPI, int K>
__device__ __forceinline__ void cond_sub(uint32_t d[K], const uint32_t n[K],
                                         bool over, int L,
                                         const Group<TPI>& g) {
  uint32_t low[K], s[K];
#pragma unroll
  for (int k = 0; k < K; ++k) low[k] = g.lane * K + k < L ? d[k] : 0u;
  s[0] = add_cc(low[0], ~n[0]);
#pragma unroll
  for (int k = 1; k < K; ++k) s[k] = addc_cc(low[k], ~n[k]);
  const uint32_t c = addc(0u, 0u);
  bool ones = true;
#pragma unroll
  for (int k = 0; k < K; ++k) ones = ones && s[k] == 0xffffffffu;
  // low + ~n + 1 over the group: the +1 is the carry into lane 0.  Limbs
  // at or above L are 0 + ~0 and pass a carry on, so the carry out of the
  // top lane is the carry out of limb L - 1: set iff low >= n.
  const uint32_t G = g.bits(__ballot_sync(kFull, c != 0));
  const uint32_t X = G | g.bits(__ballot_sync(kFull, ones));
  const uint64_t sum = (uint64_t)X + G + 1u;
  const uint32_t cbit = (uint32_t)((sum ^ X ^ G) >> g.lane) & 1u;
  s[0] = add_cc(s[0], cbit);
#pragma unroll
  for (int k = 1; k < K; ++k) s[k] = addc_cc(s[k], 0u);
  const bool need = over || ((sum >> TPI) & 1u) != 0;  // group-uniform
  // limbs at or above L stay zero: after a borrow s holds ones there, and
  // mont_exp_rows feeds d back into the next product from registers
#pragma unroll
  for (int k = 0; k < K; ++k)
    d[k] = (need && g.lane * K + k < L) ? s[k] : low[k];
}

// acc[j], acc[j + 1] += lo, hi of u v[j + 1 - odd] for j = 0, 2, .., K - 2:
// one carry chain of fused (lo, hi) pairs, carry out left in the flag.
template <int K, int odd>
__device__ __forceinline__ void mad_pairs(uint32_t u, const uint32_t v[K],
                                          uint32_t acc[K]) {
  acc[0] = mad_lo_cc(u, v[odd], acc[0]);
  acc[1] = madc_hi_cc(u, v[odd], acc[1]);
#pragma unroll
  for (int j = 2; j < K; j += 2) {
    acc[j] = madc_lo_cc(u, v[j + odd], acc[j]);
    acc[j + 1] = madc_hi_cc(u, v[j + odd], acc[j + 1]);
  }
}

// One CIOS step with the broadcast limb ai (see the note at the top): the
// previous step's division by 2^32, then t += ai b and t += m n.
template <int TPI, int K>
__device__ __forceinline__ void cios_step(uint32_t ai, const uint32_t b[K],
                                          const uint32_t n[K], uint32_t npr,
                                          int lane, uint32_t x[K],
                                          uint32_t y[K], uint32_t& c) {
  // the group's x[0] is 0; lane TPI - 1 reads lane 0's (source lanes wrap
  // modulo the width)
  const uint32_t next = __shfl_sync(kFull, x[0], lane + 1, TPI);
  // y' = x two limbs down, topped by the next lane's x[0] and c, plus
  // ai b_odd; x' = y with x[1] added to its limb 0 (whose carry starts
  // the chain)
  uint32_t ny[K];
  const uint32_t x0 = add_cc(y[0], x[1]);
#pragma unroll
  for (int j = 0; j < K; j += 2) {
    ny[j] = madc_lo_cc(ai, b[j + 1], j + 2 < K ? x[j + 2] : next);
    ny[j + 1] = madc_hi_cc(ai, b[j + 1], j + 3 < K ? x[j + 3] : c);
  }
  c = addc(0u, 0u);
  x[0] = x0;
#pragma unroll
  for (int k = 1; k < K; ++k) x[k] = y[k];
#pragma unroll
  for (int k = 0; k < K; ++k) y[k] = ny[k];
  mad_pairs<K, 0>(ai, b, x);  // its carry lands on y's top limb
  y[K - 1] = addc_cc(y[K - 1], 0u);
  c = addc(c, 0u);
  const uint32_t m = __shfl_sync(kFull, x[0] * npr, 0, TPI);
  mad_pairs<K, 1>(m, n, y);
  c = addc(c, 0u);
  mad_pairs<K, 0>(m, n, x);
  y[K - 1] = addc_cc(y[K - 1], 0u);
  c = addc(c, 0u);
}

// out = a*b*R^-1 mod n for the group's row; out may alias a or b.
template <int TPI, int K>
__device__ __forceinline__ void mont_product(const uint32_t a[K],
                                             const uint32_t b[K],
                                             const uint32_t n[K], uint32_t npr,
                                             int L, const Group<TPI>& g,
                                             uint32_t out[K]) {
  static_assert(K % 2 == 0, "the even/odd accumulator needs an even K");
  uint32_t x[K], y[K], c = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = y[k] = 0;
  // limb i of a is a[i % K] on lane i / K: L / K whole lanes, then the
  // first L % K limbs of the next
  const int whole = L / K, rest = L - whole * K;
#pragma unroll 4
  for (int src = 0; src < whole; ++src) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
      cios_step<TPI, K>(__shfl_sync(kFull, a[kk], src, TPI), b, n, npr,
                        g.lane, x, y, c);
  }
  if (rest != 0) {  // uniform: every row of a launch has the same L
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
      if (kk < rest)
        cios_step<TPI, K>(__shfl_sync(kFull, a[kk], whole, TPI), b, n, npr,
                          g.lane, x, y, c);
  }
  // the last step's division by 2^32: t = y + x one limb down
  const uint32_t next = __shfl_sync(kFull, x[0], g.lane + 1, TPI);
  uint32_t t[K];
  t[0] = add_cc(y[0], x[1]);
#pragma unroll
  for (int k = 1; k < K; ++k) t[k] = addc_cc(y[k], k + 1 < K ? x[k + 1] : next);
  c = addc(c, 0u);
  const bool over = normalize<TPI, K>(t, c, L, g, out);
  cond_sub<TPI, K>(out, n, over, L, g);
}

// Row groups (one a warp) in whole waves: in iteration i, block b takes
// the W groups from (b + i gridDim) W.  The count of iterations depends
// on the block alone, so the loop is uniform and every shuffle runs in a
// converged warp.
template <int W>
__device__ __forceinline__ int64_t block_iters(int64_t groups) {
  const int64_t blocks = (groups + W - 1) / W;
  return (blocks - blockIdx.x + gridDim.x - 1) / gridDim.x;
}

// The row a group works on in iteration i: groups past the last row redo
// the last row (every lane of a warp takes part in its shuffles) and store
// nothing.
struct RowOf {
  int64_t row, src;
};

template <int TPI, int W>
__device__ __forceinline__ RowOf row_of(int64_t i, int64_t rows) {
  const int64_t w = ((int64_t)blockIdx.x + i * gridDim.x) * W + threadIdx.x / 32;
  const int64_t row = w * Group<TPI>::kRows + (threadIdx.x & 31) / TPI;
  return {row, row < rows ? row : rows - 1};
}

template <int TPI, int K>
__global__ void __launch_bounds__(32 * kWarps)
    mont_mul_kernel(const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b,
                    const uint32_t* __restrict__ n, uint32_t npr,
                    uint32_t* __restrict__ out, int64_t rows, int L) {
  const Group<TPI> g;
  uint32_t rn[K];
  load_row<K>(n, L, g.lane, rn);
  const int64_t iters = block_iters<kWarps>(
      (rows + Group<TPI>::kRows - 1) / Group<TPI>::kRows);
  for (int64_t i = 0; i < iters; ++i) {
    const RowOf r = row_of<TPI, kWarps>(i, rows);
    uint32_t ra[K], rb[K], ro[K];
    load_row<K>(a + r.src * L, L, g.lane, ra);
    load_row<K>(b + r.src * L, L, g.lane, rb);
    mont_product<TPI, K>(ra, rb, rn, npr, L, g, ro);
    if (r.row < rows) store_row<K>(out + r.row * L, L, g.lane, ro);
  }
}

template <int TPI, int K>
__global__ void __launch_bounds__(32 * kWarps)
    mont_mul_vec_kernel(const uint32_t* __restrict__ a,
                        const uint32_t* __restrict__ b,
                        const uint32_t* __restrict__ n_rows,
                        const uint32_t* __restrict__ npr_rows,
                        uint32_t* __restrict__ out, int64_t rows, int L) {
  const Group<TPI> g;
  const int64_t iters = block_iters<kWarps>(
      (rows + Group<TPI>::kRows - 1) / Group<TPI>::kRows);
  for (int64_t i = 0; i < iters; ++i) {
    const RowOf r = row_of<TPI, kWarps>(i, rows);
    uint32_t ra[K], rb[K], rn[K], ro[K];
    load_row<K>(a + r.src * L, L, g.lane, ra);
    load_row<K>(b + r.src * L, L, g.lane, rb);
    load_row<K>(n_rows + r.src * L, L, g.lane, rn);
    mont_product<TPI, K>(ra, rb, rn, npr_rows[r.src], L, g, ro);
    if (r.row < rows) store_row<K>(out + r.row * L, L, g.lane, ro);
  }
}

// Shared memory of one warp's tables: entry e, limb k of warp lane j at
// word (e K + k) 32 + j.
template <int K>
constexpr size_t exp_smem_bytes() {
  return (size_t)kExpWarps * kTable * K * 32 * sizeof(uint32_t);
}

template <int TPI, int K>
__global__ void __launch_bounds__(32 * kExpWarps)
    mont_exp_kernel(const uint32_t* __restrict__ a,
                    const int32_t* __restrict__ mod_idx,
                    const uint32_t* __restrict__ n_tab,
                    const uint32_t* __restrict__ npr_tab,
                    const uint32_t* __restrict__ r2_tab,
                    const uint32_t* __restrict__ one_tab,
                    const int32_t* __restrict__ dig_tab, int ndig,
                    uint32_t* __restrict__ out, int64_t rows, int L) {
  extern __shared__ uint32_t smem[];
  const Group<TPI> g;
  const int wlane = threadIdx.x & 31;
  uint32_t* tab = smem + (threadIdx.x / 32) * (kTable * K * 32) + wlane;
  const int64_t iters = block_iters<kExpWarps>(
      (rows + Group<TPI>::kRows - 1) / Group<TPI>::kRows);
  for (int64_t i = 0; i < iters; ++i) {
    const RowOf r = row_of<TPI, kExpWarps>(i, rows);
    const int64_t mi = mod_idx[r.src];
    uint32_t n[K], base[K], acc[K];
    load_row<K>(n_tab + mi * L, L, g.lane, n);
    const uint32_t npr = npr_tab[mi];
    load_row<K>(a + r.src * L, L, g.lane, acc);
    load_row<K>(r2_tab + mi * L, L, g.lane, base);
    mont_product<TPI, K>(acc, base, n, npr, L, g, base);  // a*R mod n
    load_row<K>(one_tab + mi * L, L, g.lane, acc);        // R mod n
#pragma unroll
    for (int k = 0; k < K; ++k) tab[k * 32] = acc[k];
#pragma unroll 1
    for (int e = 1; e < kTable; ++e) {
      mont_product<TPI, K>(acc, base, n, npr, L, g, acc);
#pragma unroll
      for (int k = 0; k < K; ++k) tab[(e * K + k) * 32] = acc[k];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = tab[k * 32];
    const int32_t* dig = dig_tab + mi * ndig;
#pragma unroll 1
    for (int s = 0; s < ndig; ++s) {
#pragma unroll 1
      for (int sq = 0; sq < kWindow; ++sq)
        mont_product<TPI, K>(acc, acc, n, npr, L, g, acc);
      const int32_t d = dig[s];
      uint32_t sel[K];
#pragma unroll
      for (int k = 0; k < K; ++k) sel[k] = 0;
#pragma unroll
      for (int e = 0; e < kTable; ++e) {
        const bool hit = d == e;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const uint32_t v = tab[(e * K + k) * 32];
          sel[k] = hit ? v : sel[k];
        }
      }
      mont_product<TPI, K>(acc, sel, n, npr, L, g, acc);
    }
    // leave the Montgomery domain: a product with the limb vector 1
    uint32_t one[K];
#pragma unroll
    for (int k = 0; k < K; ++k) one[k] = (g.lane == 0 && k == 0) ? 1u : 0u;
    mont_product<TPI, K>(acc, one, n, npr, L, g, acc);
    if (r.row < rows) store_row<K>(out + r.row * L, L, g.lane, acc);
  }
}

// Blocks of one kernel instance resident on the current device at once
// (SMs x blocks an SM), asked of the runtime on the device's first launch
// and kept in the instance's `cache`, one slot a device (0: not yet asked).
// With `shared` the kernel's shared-memory attributes are set first: above
// 48 KB only when asked for, and shared memory preferred over L1.  0 with
// *rc set if the kernel cannot be resident.
template <typename Kernel>
int64_t resident_blocks(std::atomic<int64_t>* cache, Kernel kernel, int warps,
                        size_t smem, bool shared, int* rc) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= kMaxDevices) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess) {
    const int64_t known = cache[dev].load(std::memory_order_acquire);
    if (known > 0) return known;
  }
  if (e == cudaSuccess && shared)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess && shared)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      32 * warps, smem);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) {
    *rc = (int)e;
    return 0;
  }
  const int64_t resident = (int64_t)sms * per_sm;
  cache[dev].store(resident, std::memory_order_release);
  return resident;
}

// The grid that covers `groups` row groups, `warps` a block, in whole waves
// of `resident` blocks.
int64_t wave_grid(int64_t groups, int warps, int64_t resident) {
  const int64_t blocks = (groups + warps - 1) / warps;
  const int64_t waves = (blocks + resident - 1) / resident;
  return (blocks + waves - 1) / waves;
}

template <int TPI, int K>
int launch_mul(const uint32_t* a, const uint32_t* b, const uint32_t* n,
               uint32_t npr, uint32_t* out, int64_t rows, int L,
               cudaStream_t s) {
  static std::atomic<int64_t> cache[kMaxDevices];
  int rc = (int)cudaSuccess;
  const int64_t resident = resident_blocks(cache, mont_mul_kernel<TPI, K>,
                                           kWarps, 0, false, &rc);
  if (resident == 0) return rc;
  const int64_t groups = (rows + Group<TPI>::kRows - 1) / Group<TPI>::kRows;
  mont_mul_kernel<TPI, K>
      <<<(unsigned)wave_grid(groups, kWarps, resident), 32 * kWarps, 0, s>>>(
          a, b, n, npr, out, rows, L);
  return (int)cudaGetLastError();
}

template <int TPI, int K>
int launch_mul_vec(const uint32_t* a, const uint32_t* b, const uint32_t* n,
                   const uint32_t* npr, uint32_t* out, int64_t rows, int L,
                   cudaStream_t s) {
  static std::atomic<int64_t> cache[kMaxDevices];
  int rc = (int)cudaSuccess;
  const int64_t resident = resident_blocks(
      cache, mont_mul_vec_kernel<TPI, K>, kWarps, 0, false, &rc);
  if (resident == 0) return rc;
  const int64_t groups = (rows + Group<TPI>::kRows - 1) / Group<TPI>::kRows;
  mont_mul_vec_kernel<TPI, K>
      <<<(unsigned)wave_grid(groups, kWarps, resident), 32 * kWarps, 0, s>>>(
          a, b, n, npr, out, rows, L);
  return (int)cudaGetLastError();
}

template <int TPI, int K>
int launch_exp(const uint32_t* a, const int32_t* mod_idx,
               const uint32_t* n_tab, const uint32_t* npr_tab,
               const uint32_t* r2_tab, const uint32_t* one_tab,
               const int32_t* dig_tab, int ndig, uint32_t* out, int64_t rows,
               int L, cudaStream_t s) {
  static std::atomic<int64_t> cache[kMaxDevices];
  constexpr size_t smem = exp_smem_bytes<K>();
  int rc = (int)cudaSuccess;
  const int64_t resident = resident_blocks(cache, mont_exp_kernel<TPI, K>,
                                           kExpWarps, smem, true, &rc);
  if (resident == 0) return rc;
  const int64_t groups = (rows + Group<TPI>::kRows - 1) / Group<TPI>::kRows;
  mont_exp_kernel<TPI, K><<<(unsigned)wave_grid(groups, kExpWarps, resident),
                            32 * kExpWarps, smem, s>>>(
      a, mod_idx, n_tab, npr_tab, r2_tab, one_tab, dig_tab, ndig, out, rows,
      L);
  return (int)cudaGetLastError();
}

// Calls F::run<TPI, K>(args...) for the (TPI, K) that L takes.
template <typename F, typename... Args>
int dispatch(int L, Args... args) {
  if (L <= 16) return F::template run<8, 2>(args...);
  if (L <= 32) return F::template run<8, 4>(args...);
  if (L <= 64) return F::template run<8, 8>(args...);
  return F::template run<16, 8>(args...);
}

struct Layout {
  template <int TPI, int K>
  static int run() { return TPI << 16 | K; }
};
struct Mul {
  template <int TPI, int K, typename... Args>
  static int run(Args... args) { return launch_mul<TPI, K>(args...); }
};
struct MulVec {
  template <int TPI, int K, typename... Args>
  static int run(Args... args) { return launch_mul_vec<TPI, K>(args...); }
};
struct Exp {
  template <int TPI, int K, typename... Args>
  static int run(Args... args) { return launch_exp<TPI, K>(args...); }
};

bool bad_shape(int64_t rows, int L) {
  return L < 1 || L > kMaxLimbs || rows < 0;
}

}  // namespace

// The layout that rows of L limbs launch: TPI << 16 | K, or -1 for an L
// the kernels refuse.  Launches nothing.
extern "C" int mont_layout(int L) {
  if (bad_shape(0, L)) return -1;
  return dispatch<Layout>(L);
}

// Every entry point takes device pointers to contiguous int32 tensors (uint32
// limbs), `rows` rows of L limbs, and a cudaStream_t; it returns
// cudaGetLastError() after the launch (0 on success), or an error code for a
// shape it refuses.

extern "C" int mont_mul(const void* a, const void* b, const void* n,
                        uint32_t n_prime, void* out, int64_t rows, int L,
                        void* stream) {
  if (bad_shape(rows, L)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  return dispatch<Mul>(L, (const uint32_t*)a, (const uint32_t*)b,
                       (const uint32_t*)n, n_prime, (uint32_t*)out, rows, L,
                       (cudaStream_t)stream);
}

// n_rows: rows x L; npr_rows: rows.
extern "C" int mont_mul_vec(const void* a, const void* b, const void* n_rows,
                            const void* npr_rows, void* out, int64_t rows,
                            int L, void* stream) {
  if (bad_shape(rows, L)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  return dispatch<MulVec>(L, (const uint32_t*)a, (const uint32_t*)b,
                          (const uint32_t*)n_rows, (const uint32_t*)npr_rows,
                          (uint32_t*)out, rows, L, (cudaStream_t)stream);
}

// mod_idx: rows, each in [0, nmod); n_tab, r2_tab (R^2 mod n), one_tab
// (R mod n): nmod x L; npr_tab: nmod; dig_tab: nmod x ndig MSB-first base-16
// exponent digits.
extern "C" int mont_exp_rows(const void* a, const void* mod_idx,
                             const void* n_tab, const void* npr_tab,
                             const void* r2_tab, const void* one_tab,
                             const void* dig_tab, int ndig, int nmod,
                             void* out, int64_t rows, int L, void* stream) {
  if (bad_shape(rows, L) || ndig < 0 || nmod < 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  return dispatch<Exp>(L, (const uint32_t*)a, (const int32_t*)mod_idx,
                       (const uint32_t*)n_tab, (const uint32_t*)npr_tab,
                       (const uint32_t*)r2_tab, (const uint32_t*)one_tab,
                       (const int32_t*)dig_tab, ndig, (uint32_t*)out, rows, L,
                       (cudaStream_t)stream);
}
