// Batch Ed25519 verification kernels for sm_90a.
//
// ed25519_prep   replaces the jnp prep of the JAX main path
//                (sha512.sha512_96 / mod_l, ed25519_kernel._lt_const,
//                _is_torsion_y, _pow_p58, decompress_neg and the flags of
//                _verify_full): k on one lane per signature, the
//                decompression chain's products split by output columns
//                over kPrepLanes lanes per signature (field.cuh); plain
//                version ops/ed25519_kernel.py::prep_plain.
// ed25519_ladder replaces the Pallas kernel ed25519_pallas.py::ladder
//                (1-bit ladder over all 256 bits, 4-entry select, Z^-1)
//                with a signed radix-16 Straus schedule on four lanes per
//                signature, and the tail of _verify_full (compress, the
//                compare with R, the AND with prep's flags): it writes
//                one verdict byte per signature, and canonical affine
//                bytes where asked; plain versions
//                ops/ladder.py::ladder_verdict_plain and ladder_plain.
//
// Both are bound by integer multiplies (see the notes in ladder.py and
// ed25519_kernel.py). Rows travel as 16-byte loads and stay 64-bit words
// in registers; field elements stay in registers; the ladder's tables
// and digits sit in shared memory.
//
// C interface for ctypes: each launch function returns cudaGetLastError()
// after the launch; nothing synchronises.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"
#include "point.cuh"
#include "scalar.cuh"
#include "sha512.cuh"

// Field constants in ten limbs (ops/field.py: D, D2, SQRT_M1) and B's
// niels table (ladder.py: NIELS_B, 1B .. 8B as (y+x, y-x, 2dxy));
// tests/test_torch_field.py checks every table here against the values
// the plain version computes.
__constant__ int32_t C_D[10] = {56195235, 13857412, 51736253, 6949390, 114729,
                                24766616, 60832955, 30306712, 48412415, 21499315};
__constant__ int32_t C_D2[10] = {45281625, 27714825, 36363642, 13898781, 229458,
                                 15978800, 54557047, 27058993, 29715967, 9444199};
__constant__ int32_t C_SQRT_M1[10] = {34513072, 25610706, 9377949, 3500415, 12389472,
                                      33281959, 41962654, 31548777, 326685, 11406482};
__constant__ int32_t C_NIELS_B[8][3][10] = {
    {{25967493, 19198397, 29566455, 3660896, 54414519, 4014786, 27544626, 21800161, 61029707, 2047604},
     {54563134, 934261, 64385954, 3049989, 66381436, 9406985, 12720692, 5043384, 19500929, 18085054},
     {58370664, 4489569, 9688441, 18769238, 10184608, 21191052, 29287918, 11864899, 42594502, 29115885}},
    {{54292951, 20578084, 45527620, 11784319, 41753206, 30803714, 55390960, 29739860, 66750418, 23343128},
     {45405608, 6903824, 27185491, 6451973, 37531140, 24000426, 51492312, 11189267, 40279186, 28235350},
     {26966623, 11152617, 32442495, 15396054, 14353839, 20802097, 63980037, 24013313, 51636816, 29387734}},
    {{15636272, 23865875, 24204772, 25642034, 616976, 16869170, 27787599, 18782243, 28944399, 32004408},
     {16568933, 4717097, 55552716, 32452109, 15682895, 21747389, 16354576, 21778470, 7689661, 11199574},
     {30464137, 27578307, 55329429, 17883566, 23220364, 15915852, 7512774, 10017326, 49359771, 23634074}},
    {{50071967, 13921891, 10945806, 27521001, 27105051, 17470053, 38182653, 15006022, 3284568, 27277892},
     {23599295, 25248385, 55915199, 25867015, 13236773, 10506355, 7464579, 9656445, 13059162, 10374397},
     {7798537, 16710257, 3033922, 2874086, 28997861, 2835604, 32406664, 29715387, 66467155, 33453106}},
    {{10861363, 11473154, 27284546, 1981175, 37044515, 12577860, 32867885, 14515107, 51670560, 10819379},
     {4708026, 6336745, 20377586, 9066809, 55836755, 6594695, 41455196, 12483687, 54440373, 5581305},
     {19563141, 16186464, 37722007, 4097518, 10237984, 29206317, 28542349, 13850243, 43430843, 17738489}},
    {{51736881, 20691677, 32573249, 4720197, 40672342, 5875510, 47920237, 18329612, 57289923, 21468654},
     {58559652, 109982, 15149363, 2178705, 22900618, 4543417, 3044240, 17864545, 1762327, 14866737},
     {48909169, 17603008, 56635573, 1707277, 49922944, 3916100, 38872452, 3959420, 27914454, 4383652}},
    {{5153727, 9909285, 1723747, 30776558, 30523604, 5516873, 19480852, 5230134, 43156425, 18378665},
     {36839857, 30090922, 7665485, 10083793, 28475525, 1649722, 20654025, 16520125, 30598449, 7715701},
     {28881826, 14381568, 9657904, 3680757, 46927229, 7843315, 35708204, 1370707, 29794553, 32145132}},
    {{14499471, 30824833, 33917750, 29299779, 28494861, 14271267, 30290735, 10876454, 33954766, 2381725},
     {59913433, 30899068, 52378708, 462250, 39384538, 3941371, 60872247, 3696004, 34808032, 15351954},
     {27431194, 8222322, 16448760, 29646437, 48401861, 11938354, 34147463, 30583916, 29551812, 10109425}},
};

// L, p and the canonical y of the 8-torsion points (sorted), as
// little-endian 64-bit words
__constant__ uint64_t C_L[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                                0x0000000000000000ULL, 0x1000000000000000ULL};
__constant__ uint64_t C_P[4] = {0xffffffffffffffedULL, 0xffffffffffffffffULL,
                                0xffffffffffffffffULL, 0x7fffffffffffffffULL};
__constant__ uint64_t C_TORSION_Y[5][4] = {
    {0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL},
    {0x0000000000000001ULL, 0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL},
    {0xb027b2c28f95e826ULL, 0xf098eff289f4c345ULL, 0x3933c6d305acdfd5ULL, 0x05fc536d880238b1ULL},
    {0x4fd84d3d706a17c7ULL, 0x0f67100d760b3cbaULL, 0xc6cc392cfa53202aULL, 0x7a03ac9277fdc74eULL},
    {0xffffffffffffffecULL, 0xffffffffffffffffULL, 0xffffffffffffffffULL, 0x7fffffffffffffffULL}};

// Launch geometry. A variant build (ops/_build.py KNOBS, defines_of) sets
// the macros; the defaults below are the main path's.
#ifndef ED25519_PREP_THREADS
#define ED25519_PREP_THREADS 128
#endif
#ifndef ED25519_PREP_MIN_BLOCKS
#define ED25519_PREP_MIN_BLOCKS 3
#endif
#ifndef ED25519_LADDER_THREADS
#define ED25519_LADDER_THREADS 128
#endif
#ifndef ED25519_LADDER_MIN_BLOCKS
#define ED25519_LADDER_MIN_BLOCKS 4
#endif
constexpr int kPrepThreads = ED25519_PREP_THREADS;   // kPrepLanes lanes per signature
constexpr int kPrepSigs = kPrepThreads / kPrepLanes;
constexpr int kPrepMinBlocks = ED25519_PREP_MIN_BLOCKS;  // 3: 12 warps per SM, <= 168 registers
constexpr int kLadderThreads = ED25519_LADDER_THREADS;   // four lanes per signature
constexpr int kLadderSigs = kLadderThreads / 4;
constexpr int kLadderMinBlocks = ED25519_LADDER_MIN_BLOCKS;  // 4: 16 warps per SM, <= 128 registers
constexpr int kWindows = 65;                // signed radix-16 digits per scalar
constexpr int kNielsStride = 44;            // words per entry of B's table

// 32 bytes at p (16-byte aligned) as four little-endian 64-bit words, from
// two 16-byte loads.
__device__ __forceinline__ void load_words(uint64_t w[4], const uint8_t* p) {
  const uint4* src = reinterpret_cast<const uint4*>(p);
  const uint4 a = src[0], b = src[1];
  w[0] = ((uint64_t)a.y << 32) | a.x;
  w[1] = ((uint64_t)a.w << 32) | a.z;
  w[2] = ((uint64_t)b.y << 32) | b.x;
  w[3] = ((uint64_t)b.w << 32) | b.z;
}

// Row i of an (n, 32) byte array.
__device__ __forceinline__ void load_row(uint64_t w[4], const uint8_t* base, size_t i) {
  load_words(w, base + 32 * i);
}

__device__ __forceinline__ void store_row(uint8_t* base, size_t byte_off, const uint64_t w[4]) {
  uint4* dst = reinterpret_cast<uint4*>(base + byte_off);
  dst[0] = make_uint4((uint32_t)w[0], (uint32_t)(w[0] >> 32), (uint32_t)w[1],
                      (uint32_t)(w[1] >> 32));
  dst[1] = make_uint4((uint32_t)w[2], (uint32_t)(w[2] >> 32), (uint32_t)w[3],
                      (uint32_t)(w[3] >> 32));
}

__device__ __forceinline__ bool is_torsion_y(const uint64_t y[4]) {
  bool hit = false;
#pragma unroll
  for (int t = 0; t < 5; t++) hit = hit || words_eq(y, C_TORSION_Y[t]);
  return hit;
}

// Candidate root of x^2 = (y^2 - 1) / (d y^2 + 1) and its check values,
// as ed25519_kernel.recover_x, every product on the group's lanes.
__device__ __forceinline__ void recover_x(const fe& y, const lanes& q, fe* x, fe* vx2, fe* u) {
  const fe one = fe_small(1);
  const fe y2 = fe_sq_lanes(y, q);
  *u = fe_sub(y2, one);
  const fe v = fe_add(fe_mul_lanes(fe_const(C_D), y2, q), one);
  const fe v2 = fe_sq_lanes(v, q);
  const fe v3 = fe_mul_lanes(v2, v, q);
  const fe uv3 = fe_mul_lanes(*u, v3, q);
  const fe uv7 = fe_mul_lanes(uv3, fe_sq_lanes(v2, q), q);
  *x = fe_mul_lanes(uv3, fe_pow_p58_lanes(uv7, q), q);
  *vx2 = fe_mul_lanes(v, fe_sq_lanes(*x, q), q);
}

// k (msg32: SHA-512 and sc_reduce; k mode: a copy) on one lane per
// signature, the block's first kPrepSigs threads, stored at once: the
// decompression does not read it. Then the decompression of A, about 255
// squarings and 18 multiplies in one dependent chain, on kPrepLanes lanes
// per signature, so that n signatures fill kPrepLanes times the warps of
// one thread each; then the strict checks and the stores of NEGA and OK
// on each group's first lane. At 128 threads a block holds kPrepSigs
// signatures; a minimum of kPrepMinBlocks lets ptxas keep the chain in
// up to 168 registers (held to 128 it measured slower), which leaves 12
// resident warps per SM, more than n = 16384 fills.
__global__ void __launch_bounds__(kPrepThreads, kPrepMinBlocks)
ed25519_prep_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ R,
                    const uint8_t* __restrict__ S, const uint8_t* __restrict__ MK, int mode,
                    uint8_t* __restrict__ K, uint8_t* __restrict__ NEGA,
                    uint8_t* __restrict__ OK, int n) {
  const int tid = threadIdx.x;
  const int sig0 = blockIdx.x * kPrepSigs;
  if (tid < kPrepSigs && sig0 + tid < n) {
    const size_t i = sig0 + tid;
    uint64_t k[4];
    load_row(k, MK, i);
    if (mode == 0) {  // msg32: k = SHA512(R‖A‖M) mod L; M arrived in k
      uint64_t a[4], r[4], d[8];
      load_row(a, A, i);
      load_row(r, R, i);
      sha512_96(d, r, a, k);
      sc_reduce(k, d);
    }
    store_row(K, 32 * i, k);
  }
  // a warp whose groups all lie past n has nothing to decompress
  if (sig0 + (tid & ~31) / kPrepLanes >= n) return;

  // strict decompression of A, negated (ed25519_kernel.decompress_neg);
  // groups past n work on row n - 1 and store nothing, so every lane of
  // a warp runs every shuffle
  const lanes q = lanes_of(tid);
  const int g = tid / kPrepLanes;
  const size_t row = (size_t)min(sig0 + g, n - 1);
  uint64_t a[4];
  load_row(a, A, row);
  fe x, vx2, u;
  recover_x(fe_fromwords(a), q, &x, &vx2, &u);
  uint64_t t[4];
  fe_towords(t, fe_sub(vx2, u));
  const bool root_ok = words_is_zero(t);
  fe_towords(t, fe_add(vx2, u));
  const bool root_flip = words_is_zero(t);
  x = fe_select(root_flip, fe_mul_lanes(x, fe_const(C_SQRT_M1), q), x);
  if (q.r != 0 || sig0 + g >= n) return;

  uint64_t r[4], s[4];
  load_row(a, A, row);  // again, rather than held across the chain
  load_row(r, R, row);
  load_row(s, S, row);
  const bool sign = (a[3] >> 63) != 0;
  const uint64_t top = 0x7fffffffffffffffULL;
  const uint64_t ya[4] = {a[0], a[1], a[2], a[3] & top};
  const uint64_t yr[4] = {r[0], r[1], r[2], r[3] & top};
  const bool ok = words_lt(s, C_L) && words_lt(ya, C_P) && !is_torsion_y(ya) &&
                  words_lt(yr, C_P) && !is_torsion_y(yr);
  bool valid = root_ok || root_flip;
  uint64_t xc[4];
  fe_towords(xc, x);
  valid = valid && !(words_is_zero(xc) && sign);  // "-0" is invalid
  const bool flip = ((xc[0] & 1) != 0) != sign;
  fe_towords(t, fe_neg(x));
#pragma unroll
  for (int j = 0; j < 4; j++) t[j] = flip ? xc[j] : t[j];
  store_row(NEGA, 64 * row, t);
  fe_towords(t, fe_fromwords(a));
  store_row(NEGA, 64 * row + 32, t);
  OK[row] = (ok && valid) ? 1 : 0;
}

// Signed radix-16 digits of a 256-bit scalar, as ladder.recode: digit i
// in [-8, 8) for i < 64, digit 64 in {0, 1}; written with stride
// kLadderSigs.
__device__ __forceinline__ void recode(int8_t* out, const uint64_t w[4]) {
  int c = 0;
#pragma unroll
  for (int i = 0; i < 64; i++) {
    const int d = (int)((w[i >> 4] >> (4 * (i & 15))) & 15) + c;
    c = (d + 8) >> 4;
    out[i * kLadderSigs] = (int8_t)(d - (c << 4));
  }
  out[64 * kLadderSigs] = (int8_t)c;
}

// Shared layout of the table of -A: word (e * 10 + j) * kLadderThreads +
// lane holds limb j of that lane's coordinate of entry e ((e+1)(-A)), so
// a warp's 32 loads of one limb fall in 32 banks whatever the digits.
__device__ __forceinline__ void store_cached(int32_t* tab, int e, int tid, const fe& c) {
#pragma unroll
  for (int j = 0; j < 10; j++) tab[(e * 10 + j) * kLadderThreads + tid] = c.v[j];
}

// This lane's coordinate of f(-A) in cached form: |f| picks the entry
// (0: the identity (1, 1, 0, 1)); f < 0 swaps Y+X and Y-X (the lanes 0
// and 1 read each other's word) and negates 2dT.
__device__ __forceinline__ fe cached_coord(const int32_t* tab, int f, int tid, const quad& q) {
  const int a = f < 0 ? -f : f;
  const bool neg = f < 0;
  const int slot = tid ^ ((neg && q.r < 2) ? 1 : 0);
  const int32_t* src = tab + (a > 0 ? a - 1 : 0) * 10 * kLadderThreads + slot;
  fe c;
#pragma unroll
  for (int j = 0; j < 10; j++) {
    const int32_t x = src[j * kLadderThreads];
    c.v[j] = a ? x : (j == 0 && q.r != 2);
  }
  return (neg && q.r == 2) ? fe_neg(c) : c;
}

// This lane's coordinate of eB in niels form (lanes 0..2; 0: the identity
// (1, 1, 0)); e < 0 swaps y+x and y-x and negates 2dxy. B's table holds
// entry e at words e * kNielsStride + 4j + c, which spreads the eight
// entries over distinct banks.
__device__ __forceinline__ fe niels_coord(const int32_t* tab, int e, const quad& q) {
  const int a = e < 0 ? -e : e;
  const bool neg = e < 0;
  const int c = q.r < 2 ? (q.r ^ (int)neg) : 2;
  const int32_t* src = tab + (a > 0 ? a - 1 : 0) * kNielsStride + c;
  fe n;
#pragma unroll
  for (int j = 0; j < 10; j++) {
    const int32_t x = src[4 * j];
    n.v[j] = a ? x : (j == 0 && q.r < 2);
  }
  return (neg && q.r == 2) ? fe_neg(n) : n;
}

// What a ladder launch writes after the windows: the template parameter
// of ladder_block, one body for both.
enum class LadderEnd {
  // the main path's epilogue: Z^-1, canonical x and y (stored where X and
  // Y are given), and where V is given the verdict, the encoding of (x, y)
  // compared with R's row and ANDed with prep's OK byte (no flags where
  // OK is null)
  kVerdict,
  // a variant build only, to measure the epilogue
  // (scripts/kernel_profile.py): the canonical bytes of X, Y and Z from
  // lanes 0..2; plain version ops/ladder.py::ladder_windows_plain
  kWindowsOnly,
};

// The ladder of one block, on lane q.r of each group of four: the table
// build and the windows give this lane's coordinate of the P2 point
// [S]B + [k](-A) (X, Y and Z on lanes 0..2, lane 3's unused); then the
// epilogue regroups and one thread per signature inverts Z and finishes
// the verification (kEnd). -A's x and y of row i sit at NAX and NAY plus
// i * a_stride bytes: 64 in prep's (n, 64) output, 32 in two (n, 32)
// arrays.
template <LadderEnd kEnd>
__device__ __forceinline__ void ladder_block(const uint8_t* __restrict__ S,
                                             const uint8_t* __restrict__ K,
                                             const uint8_t* __restrict__ NAX,
                                             const uint8_t* __restrict__ NAY, int a_stride,
                                             const uint8_t* __restrict__ R,
                                             const uint8_t* __restrict__ OK,
                                             uint8_t* __restrict__ V, uint8_t* __restrict__ X,
                                             uint8_t* __restrict__ Y, uint8_t* __restrict__ Z,
                                             int n) {
  __shared__ int32_t tab_a[8 * 10 * kLadderThreads];
  __shared__ int32_t tab_b[8 * kNielsStride];
  __shared__ int8_t dig[2 * kWindows * kLadderSigs];
  const int tid = threadIdx.x, g = tid >> 2;
  quad q;
  q.lane = tid & 31;
  q.base = q.lane & ~3;
  q.r = tid & 3;
  const int sig0 = blockIdx.x * kLadderSigs;
  // groups past n work on row n - 1 and store nothing, so every lane of
  // a warp runs every shuffle
  const size_t row = (size_t)min(sig0 + g, n - 1);

  for (int idx = tid; idx < 8 * 3 * 10; idx += kLadderThreads) {
    const int e = idx / 30, c = (idx / 10) % 3, j = idx % 10;
    tab_b[e * kNielsStride + 4 * j + c] = C_NIELS_B[e][c][j];
  }
  uint64_t w[4];
  if (q.r < 2) {
    load_row(w, q.r ? K : S, row);
    recode(dig + q.r * kWindows * kLadderSigs + g, w);
  }

  // the table of -A, lane r keeping coordinate r: A1 = (x, y, 1, xy),
  // A(e+1) = A(e) + cached(A1) (ladder.neg_a_table)
  load_words(w, NAX + a_stride * row);
  const fe nax = fe_fromwords(w);
  load_words(w, NAY + a_stride * row);
  const fe nay = fe_fromwords(w);
  fe v = q.r == 0 ? nax : q.r == 1 ? nay : fe_small(1);
  if (q.r == 3) v = fe_mul(nax, nay);
  const fe d2 = fe_const(C_D2);
  const fe c1 = quad_to_cached(v, d2, q);
  store_cached(tab_a, 0, tid, c1);
#pragma unroll 1
  for (int e = 1; e < 8; e++) {
    v = quad_p1p1_to(quad_add(v, c1, q), q, true);
    store_cached(tab_a, e, tid, quad_to_cached(v, d2, q));
  }
  __syncthreads();

  v = fe_small(q.r == 1 || q.r == 2);  // the identity (0, 1, 1, 0)
#pragma unroll 1
  for (int i = kWindows - 1; i >= 0; i--) {
    if (i < kWindows - 1) {
#pragma unroll 1
      for (int d = 0; d < 4; d++) v = quad_p1p1_to(quad_dbl(v, q), q, d == 3);
    }
    const int e = dig[i * kLadderSigs + g];
    const int f = dig[(kWindows + i) * kLadderSigs + g];
    v = quad_p1p1_to(quad_madd(v, niels_coord(tab_b, e, q), q), q, true);
    v = quad_p1p1_to(quad_add(v, cached_coord(tab_a, f, tid, q), q), q, false);
  }

  if constexpr (kEnd == LadderEnd::kWindowsOnly) {
    if (q.r < 3 && sig0 + g < n) {
      fe_towords(w, v);
      store_row(q.r == 0 ? X : q.r == 1 ? Y : Z, 32 * row, w);
    }
    return;
  }

  // the epilogue. Regroup: one thread per signature inverts Z and
  // finishes
  __syncthreads();
  int32_t* fin = tab_a;
  if (q.r < 3) {
#pragma unroll
    for (int j = 0; j < 10; j++) fin[(q.r * 10 + j) * kLadderSigs + g] = v.v[j];
  }
  __syncthreads();
  if (tid < kLadderSigs && sig0 + tid < n) {
    const size_t i = (size_t)(sig0 + tid);
    fe p[3];
#pragma unroll
    for (int c = 0; c < 3; c++)
#pragma unroll
      for (int j = 0; j < 10; j++) p[c].v[j] = fin[(c * 10 + j) * kLadderSigs + tid];
    const fe zi = fe_invert(p[2]);
    uint64_t x[4];
    fe_towords(x, fe_mul(p[0], zi));
    fe_towords(w, fe_mul(p[1], zi));
    if (X) store_row(X, 32 * i, x);
    if (Y) store_row(Y, 32 * i, w);
    if (V) {
      // compress (y < p leaves bit 255 free for x's parity), compare with
      // R, AND the strict flags: _verify_full's eq & s_ok & a_canon &
      // ~a_small & a_valid & r_canon & ~r_small, prep's OK holding the six
      uint64_t r[4];
      load_row(r, R, i);
      w[3] |= x[0] << 63;
      V[i] = (words_eq(w, r) && (OK == nullptr || OK[i] != 0)) ? 1 : 0;
    }
  }
}

__global__ void __launch_bounds__(kLadderThreads, kLadderMinBlocks)
ed25519_ladder_kernel(const uint8_t* __restrict__ S, const uint8_t* __restrict__ K,
                      const uint8_t* __restrict__ NAX, const uint8_t* __restrict__ NAY,
                      int a_stride, const uint8_t* __restrict__ R,
                      const uint8_t* __restrict__ OK, uint8_t* __restrict__ V,
                      uint8_t* __restrict__ X, uint8_t* __restrict__ Y, int n) {
  ladder_block<LadderEnd::kVerdict>(S, K, NAX, NAY, a_stride, R, OK, V, X, Y, nullptr, n);
}

#ifdef ED25519_LADDER_WINDOWS_ONLY
__global__ void __launch_bounds__(kLadderThreads, kLadderMinBlocks)
ed25519_ladder_windows_kernel(const uint8_t* __restrict__ S, const uint8_t* __restrict__ K,
                              const uint8_t* __restrict__ NAX,
                              const uint8_t* __restrict__ NAY, int a_stride,
                              uint8_t* __restrict__ X, uint8_t* __restrict__ Y,
                              uint8_t* __restrict__ Z, int n) {
  ladder_block<LadderEnd::kWindowsOnly>(S, K, NAX, NAY, a_stride, nullptr, nullptr, nullptr, X,
                                        Y, Z, n);
}
#endif

extern "C" int ed25519_prep_launch(const void* a, const void* r, const void* s,
                                   const void* mk, int mode, void* k, void* neg_a,
                                   void* ok, int n, void* stream) {
  const int blocks = (n + kPrepSigs - 1) / kPrepSigs;
  ed25519_prep_kernel<<<blocks, kPrepThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)r, (const uint8_t*)s, (const uint8_t*)mk, mode,
      (uint8_t*)k, (uint8_t*)neg_a, (uint8_t*)ok, n);
  return (int)cudaGetLastError();
}

// The ladder on n rows: -A's x and y of row i at neg_ax and neg_ay plus
// i * a_stride bytes; the verdicts into v (null: none; then r and ok are
// not read; ok null: no flags), canonical x and y into x and y (each
// null: not stored).
extern "C" int ed25519_ladder_launch(const void* s, const void* k, const void* neg_ax,
                                     const void* neg_ay, int a_stride, const void* r,
                                     const void* ok, void* v, void* x, void* y, int n,
                                     void* stream) {
  const int blocks = (n + kLadderSigs - 1) / kLadderSigs;
  ed25519_ladder_kernel<<<blocks, kLadderThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)s, (const uint8_t*)k, (const uint8_t*)neg_ax, (const uint8_t*)neg_ay,
      a_stride, (const uint8_t*)r, (const uint8_t*)ok, (uint8_t*)v, (uint8_t*)x, (uint8_t*)y,
      n);
  return (int)cudaGetLastError();
}

#ifdef ED25519_LADDER_WINDOWS_ONLY
extern "C" int ed25519_ladder_windows_launch(const void* s, const void* k,
                                             const void* neg_ax, const void* neg_ay,
                                             int a_stride, void* x, void* y, void* z, int n,
                                             void* stream) {
  const int blocks = (n + kLadderSigs - 1) / kLadderSigs;
  ed25519_ladder_windows_kernel<<<blocks, kLadderThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)s, (const uint8_t*)k, (const uint8_t*)neg_ax, (const uint8_t*)neg_ay,
      a_stride, (uint8_t*)x, (uint8_t*)y, (uint8_t*)z, n);
  return (int)cudaGetLastError();
}
#endif

// Launch geometry and resources of kernel `which` (0 prep, 1 ladder, 2
// the windows-only ladder of a variant build):
// info = {threads per block, threads per signature, resident blocks per
// SM, registers per thread, local (spill and stack) bytes per thread,
// static shared bytes per block}.
extern "C" int ed25519_kernel_info(int which, int* info) {
  const void* fn = which ? (const void*)ed25519_ladder_kernel : (const void*)ed25519_prep_kernel;
#ifdef ED25519_LADDER_WINDOWS_ONLY
  if (which == 2) fn = (const void*)ed25519_ladder_windows_kernel;
#else
  if (which == 2) return (int)cudaErrorInvalidDeviceFunction;
#endif
  const int threads = which ? kLadderThreads : kPrepThreads;
  cudaFuncAttributes at;
  int err = (int)cudaFuncGetAttributes(&at, fn);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, 0);
  if (err) return err;
  info[0] = threads;
  info[1] = which ? 4 : kPrepLanes;
  info[2] = blocks;
  info[3] = at.numRegs;
  info[4] = (int)at.localSizeBytes;
  info[5] = (int)at.sharedSizeBytes;
  return 0;
}

extern "C" const char* ed25519_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
