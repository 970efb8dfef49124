// Batch Ed25519 verification kernels for sm_90a, one thread per signature.
//
// ed25519_prep   replaces the jnp prep of the JAX main path
//                (sha512.sha512_96 / mod_l, ed25519_kernel._lt_const,
//                _is_torsion_y, _pow_p58, decompress_neg and the flags of
//                _verify_full); plain version ops/ed25519_kernel.py::prep_plain.
// ed25519_ladder replaces the Pallas kernel ed25519_pallas.py::ladder
//                (1-bit ladder over all 256 bits, 4-entry select, Z^-1)
//                and returns canonical bytes; plain version
//                ops/ladder.py::ladder_plain.
//
// Both are bound by integer multiplies (see the notes in ladder.py and
// ed25519_kernel.py): field elements stay in registers, constants sit in
// constant memory, and the only memory traffic is each thread's inputs
// and outputs, 16-byte aligned rows of 32 bytes.
//
// C interface for ctypes: each launch function returns cudaGetLastError()
// after the launch; nothing synchronises.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"
#include "point.cuh"
#include "scalar.cuh"
#include "sha512.cuh"

// Field constants in ten limbs (ops/field.py: D, D2, SQRT_M1; ladder.py:
// BASE and to_cached(BASE)); tests/test_torch_field.py checks every table
// here against the values the plain version computes.
__constant__ int32_t C_D[10] = {56195235, 13857412, 51736253, 6949390, 114729,
                                24766616, 60832955, 30306712, 48412415, 21499315};
__constant__ int32_t C_D2[10] = {45281625, 27714825, 36363642, 13898781, 229458,
                                 15978800, 54557047, 27058993, 29715967, 9444199};
__constant__ int32_t C_SQRT_M1[10] = {34513072, 25610706, 9377949, 3500415, 12389472,
                                      33281959, 41962654, 31548777, 326685, 11406482};
__constant__ int32_t C_BASE_X[10] = {52811034, 25909283, 16144682, 17082669, 27570973,
                                     30858332, 40966398, 8378388, 20764389, 8758491};
__constant__ int32_t C_BASE_Y[10] = {40265304, 26843545, 13421772, 20132659, 26843545,
                                     6710886, 53687091, 13421772, 40265318, 26843545};
__constant__ int32_t C_BASE_T[10] = {28827043, 27438313, 39759291, 244362, 8635006,
                                     11264893, 19351346, 13413597, 16611511, 27139452};
// to_cached(B): Y+X, Y-X, 2Z, 2dT
__constant__ int32_t C_CACHED_B[4][10] = {
    {93076338, 52752828, 29566454, 37215328, 54414518, 37569218, 94653489, 21800160, 61029707, 35602036},
    {-12545730, 934262, -2722910, 3049990, -727428, -24147446, 12720693, 5043384, 19500929, 18085054},
    {2, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {-8738181, 4489570, 9688441, -14785194, 10184609, -12363380, 29287919, 11864899, -24514362, -4438546}};
// to_cached(identity)
__constant__ int32_t C_CACHED_ID[4][10] = {
    {1, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};

__constant__ uint8_t C_L[32] = {
    0xed, 0xd3, 0xf5, 0x5c, 0x1a, 0x63, 0x12, 0x58, 0xd6, 0x9c, 0xf7, 0xa2, 0xde, 0xf9, 0xde, 0x14,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x10};
__constant__ uint8_t C_P[32] = {
    0xed, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
    0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0x7f};
// canonical y of the 8-torsion points, sorted
__constant__ uint8_t C_TORSION_Y[5][32] = {
    {0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
     0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00},
    {0x01, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
     0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00},
    {0x26, 0xe8, 0x95, 0x8f, 0xc2, 0xb2, 0x27, 0xb0, 0x45, 0xc3, 0xf4, 0x89, 0xf2, 0xef, 0x98, 0xf0,
     0xd5, 0xdf, 0xac, 0x05, 0xd3, 0xc6, 0x33, 0x39, 0xb1, 0x38, 0x02, 0x88, 0x6d, 0x53, 0xfc, 0x05},
    {0xc7, 0x17, 0x6a, 0x70, 0x3d, 0x4d, 0xd8, 0x4f, 0xba, 0x3c, 0x0b, 0x76, 0x0d, 0x10, 0x67, 0x0f,
     0x2a, 0x20, 0x53, 0xfa, 0x2c, 0x39, 0xcc, 0xc6, 0x4e, 0xc7, 0xfd, 0x77, 0x92, 0xac, 0x03, 0x7a},
    {0xec, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
     0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0x7f}};

constexpr int kThreads = 32;   // n = 16384 -> 512 blocks, ~4 per SM

union Row32 {
  uint4 q[2];
  uint8_t b[32];
};

__device__ __forceinline__ void load_row(uint8_t out[32], const uint8_t* base, int i) {
  const uint4* src = reinterpret_cast<const uint4*>(base + 32 * (size_t)i);
  Row32 u;
  u.q[0] = src[0];
  u.q[1] = src[1];
#pragma unroll
  for (int j = 0; j < 32; j++) out[j] = u.b[j];
}

__device__ __forceinline__ void store_row(uint8_t* base, size_t byte_off, const uint8_t in[32]) {
  Row32 u;
#pragma unroll
  for (int j = 0; j < 32; j++) u.b[j] = in[j];
  uint4* dst = reinterpret_cast<uint4*>(base + byte_off);
  dst[0] = u.q[0];
  dst[1] = u.q[1];
}

__device__ __forceinline__ bool is_torsion_y(const uint8_t y[32]) {
  bool hit = false;
#pragma unroll
  for (int t = 0; t < 5; t++) {
    bool eq = true;
#pragma unroll
    for (int j = 0; j < 32; j++) eq = eq && (y[j] == C_TORSION_Y[t][j]);
    hit = hit || eq;
  }
  return hit;
}

__device__ __forceinline__ fe fe_one() {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = (i == 0);
  return r;
}

// Candidate root of x^2 = (y^2 - 1) / (d y^2 + 1) and its check values,
// as ed25519_kernel.recover_x.
__device__ __forceinline__ void recover_x(const fe& y, fe* x, fe* vx2, fe* u) {
  const fe one = fe_one();
  const fe y2 = fe_sq(y);
  *u = fe_sub(y2, one);
  const fe v = fe_add(fe_mul(fe_const(C_D), y2), one);
  const fe v2 = fe_sq(v);
  const fe v3 = fe_mul(v2, v);
  const fe uv3 = fe_mul(*u, v3);
  const fe uv7 = fe_mul(uv3, fe_sq(v2));
  *x = fe_mul(uv3, fe_pow_p58(uv7));
  *vx2 = fe_mul(v, fe_sq(*x));
}

__global__ void __launch_bounds__(kThreads)
ed25519_prep_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ R,
                    const uint8_t* __restrict__ S, const uint8_t* __restrict__ MK, int mode,
                    uint8_t* __restrict__ K, uint8_t* __restrict__ NEGA,
                    uint8_t* __restrict__ OK, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint8_t a[32], r[32], s[32], k[32];
  load_row(a, A, i);
  load_row(r, R, i);
  load_row(s, S, i);
  load_row(k, MK, i);
  if (mode == 0) {  // msg32: k = SHA512(R‖A‖M) mod L; M arrived in k
    uint8_t d[64];
    sha512_96(d, r, a, k);
    sc_reduce(k, d);
  }
  const bool sign = (a[31] >> 7) != 0;
  uint8_t ya[32], yr[32];
#pragma unroll
  for (int j = 0; j < 32; j++) {
    ya[j] = a[j];
    yr[j] = r[j];
  }
  ya[31] &= 0x7f;
  yr[31] &= 0x7f;
  bool ok = bytes_lt(s, C_L) && bytes_lt(ya, C_P) && !is_torsion_y(ya) &&
            bytes_lt(yr, C_P) && !is_torsion_y(yr);

  // strict decompression of A, negated (ed25519_kernel.decompress_neg)
  const fe y = fe_frombytes(a);
  fe x, vx2, u;
  recover_x(y, &x, &vx2, &u);
  uint8_t t[32];
  fe_tobytes(t, fe_sub(vx2, u));
  const bool root_ok = bytes_is_zero(t);
  fe_tobytes(t, fe_add(vx2, u));
  const bool root_flip = bytes_is_zero(t);
  const fe xm = fe_mul(x, fe_const(C_SQRT_M1));
#pragma unroll
  for (int j = 0; j < 10; j++) x.v[j] = root_flip ? xm.v[j] : x.v[j];
  bool valid = root_ok || root_flip;
  uint8_t xc[32];
  fe_tobytes(xc, x);
  valid = valid && !(bytes_is_zero(xc) && sign);  // "-0" is invalid
  const bool flip = ((xc[0] & 1) != 0) != sign;
  fe zero;
#pragma unroll
  for (int j = 0; j < 10; j++) zero.v[j] = 0;
  fe_tobytes(t, fe_sub(zero, x));
  uint8_t neg_x[32];
#pragma unroll
  for (int j = 0; j < 32; j++) neg_x[j] = flip ? xc[j] : t[j];
  fe_tobytes(t, y);
  ok = ok && valid;

  store_row(K, 32 * (size_t)i, k);
  store_row(NEGA, 64 * (size_t)i, neg_x);
  store_row(NEGA, 64 * (size_t)i + 32, t);
  OK[i] = ok ? 1 : 0;
}

// one fe of the 4-entry table: identity and B from constant memory, -A
// and B-A from registers; picked by the bits (bs of S, bk of k)
__device__ __forceinline__ fe select_fe(int bs, int bk, const int32_t* c0, const int32_t* c1,
                                        const fe& e2, const fe& e3) {
  fe r;
#pragma unroll
  for (int j = 0; j < 10; j++)
    r.v[j] = bk ? (bs ? e3.v[j] : e2.v[j]) : (bs ? c1[j] : c0[j]);
  return r;
}

__device__ __forceinline__ void shl256(uint64_t w[4]) {
  w[3] = (w[3] << 1) | (w[2] >> 63);
  w[2] = (w[2] << 1) | (w[1] >> 63);
  w[1] = (w[1] << 1) | (w[0] >> 63);
  w[0] <<= 1;
}

__global__ void __launch_bounds__(kThreads)
ed25519_ladder_kernel(const uint8_t* __restrict__ S, const uint8_t* __restrict__ K,
                      const uint8_t* __restrict__ NAX, const uint8_t* __restrict__ NAY,
                      uint8_t* __restrict__ X, uint8_t* __restrict__ Y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint8_t buf[32];
  uint64_t sw[4], kw[4];
  load_row(buf, S, i);
  load_words(sw, buf);
  load_row(buf, K, i);
  load_words(kw, buf);
  load_row(buf, NAX, i);
  const fe nax = fe_frombytes(buf);
  load_row(buf, NAY, i);
  const fe nay = fe_frombytes(buf);
  const fe d2 = fe_const(C_D2);

  ge a;
  a.x = nax;
  a.y = nay;
  a.z = fe_one();
  a.t = fe_mul(nax, nay);
  const ge_cached ca = ge_to_cached(a, d2);
  ge b;
  b.x = fe_const(C_BASE_X);
  b.y = fe_const(C_BASE_Y);
  b.z = fe_one();
  b.t = fe_const(C_BASE_T);
  const ge_cached cba = ge_to_cached(ge_add_cached(b, ca), d2);

  ge p;
#pragma unroll
  for (int j = 0; j < 10; j++) {
    p.x.v[j] = 0;
    p.y.v[j] = (j == 0);
    p.z.v[j] = (j == 0);
    p.t.v[j] = 0;
  }
#pragma unroll 1
  for (int bit = 255; bit >= 0; bit--) {
    const int bs = (int)(sw[3] >> 63), bk = (int)(kw[3] >> 63);
    shl256(sw);
    shl256(kw);
    p = ge_dbl(p);
    ge_cached q;
    q.yx = select_fe(bs, bk, C_CACHED_ID[0], C_CACHED_B[0], ca.yx, cba.yx);
    q.ym = select_fe(bs, bk, C_CACHED_ID[1], C_CACHED_B[1], ca.ym, cba.ym);
    q.z2 = select_fe(bs, bk, C_CACHED_ID[2], C_CACHED_B[2], ca.z2, cba.z2);
    q.t2d = select_fe(bs, bk, C_CACHED_ID[3], C_CACHED_B[3], ca.t2d, cba.t2d);
    p = ge_add_cached(p, q);
  }
  const fe zi = fe_invert(p.z);
  fe_tobytes(buf, fe_mul(p.x, zi));
  store_row(X, 32 * (size_t)i, buf);
  fe_tobytes(buf, fe_mul(p.y, zi));
  store_row(Y, 32 * (size_t)i, buf);
}

extern "C" int ed25519_prep_launch(const void* a, const void* r, const void* s,
                                   const void* mk, int mode, void* k, void* neg_a,
                                   void* ok, int n, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  ed25519_prep_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)r, (const uint8_t*)s, (const uint8_t*)mk, mode,
      (uint8_t*)k, (uint8_t*)neg_a, (uint8_t*)ok, n);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_ladder_launch(const void* s, const void* k, const void* neg_ax,
                                     const void* neg_ay, void* x, void* y, int n,
                                     void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  ed25519_ladder_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)s, (const uint8_t*)k, (const uint8_t*)neg_ax, (const uint8_t*)neg_ay,
      (uint8_t*)x, (uint8_t*)y, n);
  return (int)cudaGetLastError();
}

extern "C" const char* ed25519_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
