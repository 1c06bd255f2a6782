// Dense-IIC displacement joints (E1) and their backward (E2): a linear dense
// cluster head's per-subhead softmaxes over two NHWC feature maps and the
// joints of their displaced pairs, on bf16 or f32 features.
//
//   E1 iic_joints      replaces contrastyou_tpu/ops/pallas/iic.py _fwd_kernel:
//                      p = softmax_K(f W_s + b_s) per pixel and subhead s, then
//                      raw[s,ty,tx,i,j] = sum_{b,h,w} p1[b,h+dy,w+dx,s,i] p2[b,h,w,s,j]
//                      with (dy,dx) = (ty,tx) - pad and p1 zero outside the image
//                      (the zero padding is on the probabilities, not on the
//                      features: a border pixel's displaced partner contributes 0).
//   E2 iic_joints_bwd  replaces iic.py _bwd_kernel (:183): for the cotangent Jbar
//                      of raw, dp2(l) = sum_t Jbar_t^T p1(l + off_t), dp1(m) =
//                      sum_t Jbar_t p2(m - off_t) (both maps zero outside the
//                      image), dz = s (dp - <dp, s>) per subhead on real pixels,
//                      then df = W dz, dW = sum f dz^T, db = sum dz. W and b
//                      carry 1/T already.
//
// The TPU layout is not carried over: no row-band chunks with halo masks, no
// K -> 24 padding with -1e9 bias slots, no lane rolls, and only the S diagonal
// K x K blocks of each displacement's joint are formed (the TPU kernel
// contracts the whole [S*Kp, S*Kp] product and keeps its diagonal blocks,
// 7.2x the joint arithmetic at S = 5, K = 20).
//
// What bounds it on the H100: at the udaiic shapes (B = 5, 224 x 224, C = 32,
// S = 5, K = 20, 9 displacements) E1 does ~12.2 GFLOP of useful work on 32
// MB of features and E2 ~27.7 GFLOP on 64 MB (features in, feature
// gradients out), 380-430 FLOP per byte: arithmetic, not the memory, sets
// the bound. So both keep every probability map on chip. Blocks are
// persistent and walk pixel tiles. Both run on the tensor cores (mma.sync
// m16n8k16 / m16n8k8, bf16 operands, f32 accumulators; helpers in mma.cuh).
//
// Operand precision: every f32 operand x is split into bf16 pieces, x ~=
// x0 + x1 (+ x2), x_i the rounding of what the earlier pieces left; a
// product takes the pairs of pieces (i, j) with i + j < pieces (hi hi + hi
// lo + lo hi for two), so it keeps ~16 (two pieces) or ~24 bits (three)
// instead of bf16's 8 at 3 (6) times the mma work. bf16 features are exact
// and take no split. tests/test_torch_split_bf16.py emulates each kernel's
// roundings on the CPU and holds them to the card tests' tolerances.
//
// - E1: a block of 8 warps per (set of 16 x 16 tiles, subhead), grid
//   (blocks, S); blocks of the S subheads walk the same tiles at the same
//   time, so the features come from device memory about once and from L2
//   S times. Per tile, cp.async brings f1's (16 + 2 pad)^2 halo and f2's
//   tile (bf16, the border zero-filled by the copy) into the one feature
//   buffer, the next tile's while this one's joints run. Then:
//     * the projection Z = F W_s of the halo and tile pixels on the tensor
//       cores (16-pixel chunks, K = 20 padded to three n8 tiles; W_s split
//       in three pieces in the block, so three products), the softmax on
//       the accumulator fragments (__expf, one reciprocal a row), written as
//       two bf16 pieces of the halo map p1 and the tile map p2, [piece]
//       [pixel][24] (pixel stride 48 bytes: ldmatrix without bank
//       conflicts), 0 outside the image. f32 features project on the FP32
//       cores (exact f32), one pixel a thread, into the same maps;
//     * the joints as an implicit GEMM that reduces over pixels: M = (t, i)
//       in row groups of 8 clusters (20 -> 8 + 8 + 4 and 4 zero rows), two
//       row groups to an m16 fragment, so that the two halves of a fragment
//       may come from two displacements (27 groups, 14 fragments at pad 1:
//       80% useful rows); N = j as three n8 tiles; k = the 16 pixels of a
//       tile row. A = p1^T by ldmatrix.x4.trans, each of its four 8 x 8
//       matrices at its own lane addresses, so a displacement is a shifted
//       pixel address; B = p2 by ldmatrix.trans, loaded once a row for all
//       of the warp's fragments; hi hi + hi lo + lo hi.
//   The accumulators stay in registers across the block's tiles (a tile's
//   sums in fresh ones first): at pads 1 and 2 the warps split the
//   fragments (2 a warp at pad 1, 5 at pad 2), at pad 0 (2 fragments) the
//   tile's rows, whose sums are added in a fixed order through shared
//   memory. One f32 partial per block. The padding is a template constant.
//   Registers (ptxas) and shared bytes a block, pads 0 / 1 / 2:
//     bf16 C 32: 100 / 113 / 191, 94,800 / 107,728 / 120,144
//     bf16 C 16:  93 /  96 / 191, 76,112 /  86,480 /  96,848
//     bf16 C  8:  94 /  91 / 188, 66,768 /  75,856 /  85,200
//     f32  C 32: 125 / 128 / 181, 51,792 /  58,320 /  65,616
//     f32  C 16: 123 / 128 / 182, 50,512 /  57,040 /  64,336
//     f32  C  8: 113 / 123 / 182, 49,872 /  56,400 /  63,696
//   Pads 0 and 1 ask for two blocks of 8 warps per SM (<= 128 registers; f32
//   C 16 and 32 at pad 1 spill 4 bytes), pad 2 for one.
//   What bounds it (the card, [5, 224, 224, 32] bf16, S = 5, pad 1; phases
//   timed by removing one): the projection with its softmax epilogue and
//   the joints each take a large share, neither dominant; the feature
//   copies, which cross L2 once per subhead, and two barriers a tile take
//   much of the rest. The split's bound is 0.037 ms; the kernel issues ~54
//   GFLOP of mma for its 12.2 useful (the split's three products, K padded
//   to 24, the spare rows of the fragments, the halo's recomputed
//   projections).
//
// - E2: one block of 8 warps per SM walks
//   16 x 16 tiles (bf16 features, pad <= 1) or 8 x 16 tiles, all subheads of
//   a tile in turn, each warp one or two tile rows (m16 fragments of pixels).
//   Per tile, cp.async brings both views' feature halos (bf16, the border
//   zero-filled by the copy) once, not once per subhead. Per subhead:
//     * the projection Z = F W_s of every halo pixel on the tensor cores
//       (16-pixel chunks, K = 20 padded to three n8 tiles), the softmax on
//       the accumulator fragments (a quad holds a pixel's row: two shuffles
//       per reduction), written as bf16 pieces of the halo maps p1, p2;
//     * dp2 = sum_t Jbar_t^T p1(+off_t) and dp1 = sum_t Jbar_t p2(-off_t) as
//       implicit GEMMs: displacement t is a shifted ldmatrix view of the halo
//       map (pixel stride 48 bytes, no bank conflicts), the reduction over
//       the 20 clusters as k16 + k8;
//     * the softmax VJP on the dp accumulators in registers; dz, still in
//       registers, is the A operand of df += dz W_s^T (the m16n8 accumulator
//       layout of two n8 tiles is the A layout of one k16) and, transposed
//       in registers (movmatrix), the B operand of dW_s += F^T dz; db sums dz.
//   df stays in registers across the subheads and is written once per tile;
//   each warp's dW / db sums go through shared memory into the block's f32
//   partial in a fixed order.
//   Operand precision: p, dz and W take two pieces for bf16 features and
//   three for f32 features (whose gradients are held to 1e-5); the cotangent
//   takes two, three at pad 0, after a centring that drops out of dz
//   exactly: dp2 uses Jbar_t minus its mean over j and dp1 Jbar_t minus its
//   mean over i (the VJP removes a per-pixel constant). At pad 0 the loss's
//   joint is divided by the pixel count, not min-shift normalized: its
//   cotangent carries a large constant part, and db sums terms that cancel
//   over every pixel, so the rounding of a two-piece cotangent, centred or
//   not, reaches db. tests/test_torch_split_bf16.py emulates these roundings
//   on the CPU and holds them to the card tests' tolerances. A small kernel
//   (iic_joints_bwd_prep, one block per subhead) writes each subhead's
//   centred, split cotangent and split W_s as one image that the main kernel
//   copies with cp.async, into a second slot while the current subhead
//   runs where shared memory holds two (218 KB at pad 1). f32 features
//   project on the FP32 cores (exact f32) and read their dW fragments from
//   device memory.
//   What holds it back (per-phase clock counts on the card): the dp
//   products run at about half the mma.sync rate with 8 warps per SM (two
//   per scheduler hide little latency; 238 registers at C = 32, 16-row tiles), and
//   the projection recomputes the halo (324 of 256 pixels at pad 1) for
//   every subhead.
//
// A last kernel sums the partials in a fixed order: no atomics, and every
// run gives the same result.
//
// Every entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not
// take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kT = 16;               // tile side in pixels
constexpr int kTile = kT * kT;       // pixels of a tile
constexpr int kK = 20;               // clusters per subhead the kernels are built for
constexpr int kMaxPad = 2;
constexpr int kMaxSK = 160;          // largest S * K
constexpr int kSumThreads = 256;

struct Geo {
  int B, H, W, S, pad;
  int td, td2;                       // displacements per axis, in all
  int hw, nh;                        // halo tile side, halo tile pixels
  int ntx, ntiles;                   // tiles per image row, tiles in all
  int nhp;                           // halo tile pixels padded to 16
};

Geo make_geo(int B, int H, int W, int S, int pad) {
  Geo g;
  g.B = B;
  g.H = H;
  g.W = W;
  g.S = S;
  g.pad = pad;
  g.td = 2 * pad + 1;
  g.td2 = g.td * g.td;
  g.hw = kT + 2 * pad;
  g.nh = g.hw * g.hw;
  g.ntx = (W + kT - 1) / kT;
  g.ntiles = B * ((H + kT - 1) / kT) * g.ntx;
  g.nhp = (g.nh + 15) / 16 * 16;
  return g;
}

__device__ __forceinline__ void tile_origin(const Geo& g, int tile, int& b, int& y0, int& x0) {
  const int per_image = ((g.H + kT - 1) / kT) * g.ntx;
  b = tile / per_image;
  const int r = tile - b * per_image;
  y0 = (r / g.ntx) * kT;
  x0 = (r % g.ntx) * kT;
}

// One pixel's C features -> f32 registers (rows are 16-byte aligned: C % 8 == 0).
template <int C>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p, float (&f)[C]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int v = 0; v < C / 8; ++v) {
    const uint4 u = __ldg(q + v);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(h[e]);
      f[8 * v + 2 * e] = x.x;
      f[8 * v + 2 * e + 1] = x.y;
    }
  }
}

template <int C>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&f)[C]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int v = 0; v < C / 4; ++v) {
    const float4 u = __ldg(q + v);
    f[4 * v] = u.x;
    f[4 * v + 1] = u.y;
    f[4 * v + 2] = u.z;
    f[4 * v + 3] = u.w;
  }
}

// p = softmax(z), z[k] = bias[k] + sum_c f[c] w[c][k]; w [C][K] and bias [K] in
// shared memory (read by every thread alike: broadcasts).
template <int C, int K>
__device__ __forceinline__ void project_softmax(const float (&f)[C], const float* w,
                                                const float* bias, float (&p)[K]) {
#pragma unroll
  for (int k = 0; k < K; k += 4) {
    const float4 b4 = *reinterpret_cast<const float4*>(bias + k);
    p[k] = b4.x;
    p[k + 1] = b4.y;
    p[k + 2] = b4.z;
    p[k + 3] = b4.w;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(w + c * K + k);
      p[k] = fmaf(f[c], w4.x, p[k]);
      p[k + 1] = fmaf(f[c], w4.y, p[k + 1]);
      p[k + 2] = fmaf(f[c], w4.z, p[k + 2]);
      p[k + 3] = fmaf(f[c], w4.w, p[k + 3]);
    }
  }
  float m = p[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = fmaxf(m, p[k]);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    p[k] = expf(p[k] - m);
    s += p[k];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) p[k] = p[k] / s;
}

// x ~= p[0] + p[1] (+ p[2]) for a pair (a, b): each piece is the bf16 rounding
// of what the earlier pieces left (low half: a)
template <int N>
__device__ __forceinline__ void split2(float a, float b, unsigned (&p)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    p[i] = *reinterpret_cast<const unsigned*>(&h);
    a -= __low2float(h);
    b -= __high2float(h);
  }
}

// ------------------------------------------ tensor-core projection -----

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;            // warps of an E1 or E2 block
constexpr int kThr = 32 * kWarps;
constexpr int kKP = 24;              // clusters padded to three n8 tiles (k16 + k8)

// k16 steps of the projection over C channels (C = 8: one k8 step)
template <int C>
constexpr int kSteps = C >= 16 ? C / 16 : 1;

// The B fragments of W_s [C][24] (NW bf16 pieces in shared memory, piece
// stride C x 24) for Z = F W_s: per piece and k step, three n8 tiles
template <int NW, int C>
__device__ __forceinline__ void load_w_frags(const bf16* sW, int lane,
                                             unsigned (&wb)[NW][kSteps<C>][6]) {
  const int lj = lane >> 3, lr = lane & 7;
#pragma unroll
  for (int i = 0; i < NW; ++i)
#pragma unroll
    for (int kc = 0; kc < kSteps<C>; ++kc) {
      const bf16* wp = sW + (size_t)i * C * kKP;
      if constexpr (C >= 16) {
        unsigned r4[4], r2[2];
        tc::ldsm_x4_trans(tc::smem_addr(wp + (kc * 16 + lr + 8 * (lj & 1)) * kKP + 8 * (lj >> 1)), r4);
        tc::ldsm_x2_trans(tc::smem_addr(wp + (kc * 16 + lr + 8 * (lj & 1)) * kKP + 16), r2);
        wb[i][kc][0] = r4[0]; wb[i][kc][1] = r4[1];
        wb[i][kc][2] = r4[2]; wb[i][kc][3] = r4[3];
        wb[i][kc][4] = r2[0]; wb[i][kc][5] = r2[1];
      } else {
        unsigned r2[2];
        tc::ldsm_x2_trans(tc::smem_addr(wp + lr * kKP + 8 * (lj & 1)), r2);
        wb[i][kc][0] = r2[0];
        wb[i][kc][1] = r2[1];
        wb[i][kc][2] = tc::ldsm_x1_trans(tc::smem_addr(wp + lr * kKP + 16));
      }
    }
}

// this lane's six bias columns of a fragment row (-inf on the padding 20-23)
__device__ __forceinline__ void bias_cols(const float* bias, int lane, float (&bl)[3][2]) {
#pragma unroll
  for (int n = 0; n < 3; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * n + 2 * (lane & 3) + e;
      bl[n][e] = col < kK ? bias[col] : -CUDART_INF_F;
    }
}

// z = F W_s for 16 pixels (rows of F at stride CS elements) x 24 clusters:
// the products of the exact bf16 features with each of W_s's NW pieces
template <int NW, int C, int CS>
__device__ __forceinline__ void project_chunk(const bf16* F, int lane,
                                              const unsigned (&wb)[NW][kSteps<C>][6],
                                              float (&z)[3][4]) {
  const int lj = lane >> 3, lr = lane & 7;
#pragma unroll
  for (int n = 0; n < 3; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) z[n][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < kSteps<C>; ++kc) {
    if constexpr (C >= 16) {
      unsigned a[4];
      tc::ldsm_x4(tc::smem_addr(F + (lr + 8 * (lj & 1)) * CS + kc * 16 + 8 * (lj >> 1)), a);
#pragma unroll
      for (int i = 0; i < NW; ++i)
#pragma unroll
        for (int n = 0; n < 3; ++n) tc::mma_bf16(z[n], a, wb[i][kc][2 * n], wb[i][kc][2 * n + 1]);
    } else {
      unsigned a[2];
      tc::ldsm_x2(tc::smem_addr(F + (lr + 8 * (lj & 1)) * CS), a);
#pragma unroll
      for (int i = 0; i < NW; ++i)
#pragma unroll
        for (int n = 0; n < 3; ++n) tc::mma_bf16_k8(z[n], a[0], a[1], wb[i][kc][n]);
    }
  }
}

// The softmax of fragment row h (rows gq, gq + 8) over its 20 clusters, in
// place: adds the bias columns, exponentiates and returns the row's sum (a
// quad holds one pixel's row: two shuffles per reduction)
__device__ __forceinline__ float softmax_row(float (&z)[3][4], int h, const float (&bl)[3][2]) {
  float m = -CUDART_INF_F;
#pragma unroll
  for (int n = 0; n < 3; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      z[n][2 * h + e] += bl[n][e];
      m = fmaxf(m, z[n][2 * h + e]);
    }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  float sum = 0.f;
#pragma unroll
  for (int n = 0; n < 3; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float x = __expf(z[n][2 * h + e] - m);
      z[n][2 * h + e] = x;
      sum += x;
    }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  return sum;
}

// ---------------------------------------------------------------- E1 -----

namespace e1 {

constexpr int kWP = 3;               // pieces of W_s (bf16 features)
constexpr int kPP = 2;               // pieces of p

// E1 at padding PAD: the warps of a block as RG row groups x FG = kWarps /
// RG fragment groups, a warp holding at most MF m16 fragments of the
// joints; MINB blocks per SM asked of ptxas (2: at most 128 registers).
template <int PAD_, int MF_, int RG_, int MINB_>
struct Plan {
  static constexpr int PAD = PAD_, MF = MF_, RG = RG_, MINB = MINB_, FG = kWarps / RG_;
  static constexpr int HW = kT + 2 * PAD, NH = HW * HW, NHP = (NH + 15) / 16 * 16;
  static constexpr int TD = 2 * PAD + 1, TD2 = TD * TD;
  static constexpr int NFRAG = (3 * TD2 + 1) / 2;  // 3 TD2 row groups of 8 clusters, in pairs
  static_assert(MF * FG >= NFRAG, "every fragment has a warp");
};
using Pad0 = Plan<0, 2, 8, 2>;       // 2 fragments, each warp 2 of the tile's rows
using Pad1 = Plan<1, 2, 1, 2>;       // 14 fragments over 8 warps
using Pad2 = Plan<2, 5, 1, 1>;       // 38 fragments over 8 warps

// bytes of each shared-memory region (the same on host and device)
struct Lay {
  size_t f, p, w, bias, total;
};

__host__ __device__ inline Lay layout(const Geo& g, int C, bool bf) {
  Lay L;
  size_t o = 0;
  L.f = o;                           // bf16 features: f1's halo [nhp][C + 8], f2's tile [256][C + 8]
  if (bf) o += (size_t)(g.nhp + kTile) * (C + 8) * 2;
  L.p = o;                           // [piece][nh][24] p1 halo map, then [piece][256][24] p2 tile map
  o += (size_t)kPP * (g.nh + kTile) * kKP * 2;
  L.w = o;                           // W_s: [piece][C][24] bf16 pieces, or [C][K] f32 (f32 features)
  o += bf ? (size_t)kWP * C * kKP * 2 : (size_t)C * kK * 4;
  L.bias = o;                        // [K] f32
  o += kK * 4;
  L.total = o;
  return L;
}

template <typename T, int C, typename P>
__global__ void __launch_bounds__(kThr, P::MINB)
    iic_joints_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                      const float* __restrict__ w, const float* __restrict__ b,
                      float* __restrict__ part, Geo g) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int MF = P::MF, RG = P::RG, FG = P::FG, PAD = P::PAD, HW = P::HW, NH = P::NH;
  constexpr int NHP = P::NHP, TD = P::TD, TD2 = P::TD2;
  constexpr int CS = C + 8;          // feature pixel stride (elements)
  static_assert(C % 8 == 0 && C <= 32, "channels");
  extern __shared__ __align__(16) unsigned char smem[];
  const Lay L = layout(g, C, BF);
  bf16* sF = reinterpret_cast<bf16*>(smem + L.f);
  bf16* sP1 = reinterpret_cast<bf16*>(smem + L.p);
  float* sB = reinterpret_cast<float*>(smem + L.bias);
  const int s = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;      // mma fragment row / column pair
  const int lj = lane >> 3, lr = lane & 7;      // ldmatrix matrix / row of this lane
  const int rg = warp / FG, fg = warp % FG;
  const int SK = g.S * kK;
  constexpr size_t m1 = (size_t)NH * kKP;        // one piece of the p1 halo map
  constexpr size_t m2 = (size_t)kTile * kKP;     // one piece of the p2 tile map
  bf16* sP2 = sP1 + kPP * m1;

  // W_s, split in the block (bf16 features), and b_s
  if constexpr (BF) {
    bf16* sW = reinterpret_cast<bf16*>(smem + L.w);
    for (int e = tid; e < C * (kKP / 2); e += kThr) {
      const int c = e / (kKP / 2), k = 2 * (e % (kKP / 2));
      const float x0 = k < kK ? w[(size_t)c * SK + s * kK + k] : 0.f;
      const float x1 = k + 1 < kK ? w[(size_t)c * SK + s * kK + k + 1] : 0.f;
      unsigned pc[kWP];
      split2<kWP>(x0, x1, pc);
#pragma unroll
      for (int i = 0; i < kWP; ++i)
        *reinterpret_cast<unsigned*>(sW + ((size_t)i * C + c) * kKP + k) = pc[i];
    }
  } else {
    float* sWf = reinterpret_cast<float*>(smem + L.w);
    for (int e = tid; e < C * kK; e += kThr) sWf[e] = w[(size_t)(e / kK) * SK + s * kK + e % kK];
  }
  for (int k = tid; k < kK; k += kThr) sB[k] = b[s * kK + k];

  // f1's halo and f2's tile (bf16), zero outside the image
  auto load_f = [&](int tile) {
    int bi, y0, x0;
    tile_origin(g, tile, bi, y0, x0);
    constexpr int CV = C / 8;
    for (int e = tid; e < (NHP + kTile) * CV; e += kThr) {
      const int hp = e / CV, c8 = e % CV;
      const bool halo = hp < NHP;
      const int l = halo ? hp : hp - NHP;
      const int y = halo ? y0 - PAD + l / HW : y0 + l / kT;
      const int x = halo ? x0 - PAD + l % HW : x0 + l % kT;
      const bool in = (!halo || l < NH) && y >= 0 && y < g.H && x >= 0 && x < g.W;
      const T* src = in ? (halo ? f1 : f2) + (((size_t)bi * g.H + y) * g.W + x) * C + c8 * 8 : f1;
      tc::cp_async16(tc::smem_addr(sF + (size_t)hp * CS + c8 * 8), src, in ? 16 : 0);
    }
  };

  // This lane's ldmatrix offset (elements) into the p1 halo map for each of
  // its fragments at tile row 0: half (lj & 1) of fragment f is row group
  // h = 2 f + (lj & 1), i.e. displacement t = h / 3 and clusters 8 (h % 3)
  // .. + 7; the lane addresses pixel 8 (lj >> 1) + lr of the tile row,
  // shifted by t.
  int aoff[MF];
  bool has[MF];
#pragma unroll
  for (int m = 0; m < MF; ++m) {
    const int f = fg + FG * m;
    has[m] = f < P::NFRAG;
    int h = 2 * f + (lj & 1);
    if (h >= 3 * TD2) h = 3 * TD2 - 1;           // the last fragment's spare half: discarded
    const int t = h / 3;
    aoff[m] = ((t / TD) * HW + t % TD + 8 * (lj >> 1) + lr) * kKP + 8 * (h % 3);
  }
  float acc[MF][3][4];
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int n = 0; n < 3; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  if constexpr (BF) {
    load_f(blockIdx.x);
    tc::cp_async_commit();
  }
  for (int tile = blockIdx.x; tile < g.ntiles; tile += gridDim.x) {
    int bi, y0, x0;
    tile_origin(g, tile, bi, y0, x0);
    if constexpr (BF) tc::cp_async_wait<0>();
    __syncthreads();  // (A) the features are in; the last tile's maps consumed

    // ---- p1 on the halo and p2 on the tile -> kPP bf16 pieces, 0 outside the image
    if constexpr (BF) {
      // Z = F W_s on the tensor cores, 16 pixels x 24 clusters a chunk; the
      // features are exact in bf16, W_s takes kWP pieces
      unsigned wb[kWP][kSteps<C>][6];
      load_w_frags<kWP, C>(reinterpret_cast<const bf16*>(smem + L.w), lane, wb);
      float bl[3][2];
      bias_cols(sB, lane, bl);
      constexpr int nhc = NHP / 16;   // chunks of the halo; the tile's 16 follow
      for (int q = warp; q < nhc + kTile / 16; q += kWarps) {
        float z[3][4];
        project_chunk<kWP, C, CS>(sF + (size_t)16 * q * CS, lane, wb, z);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float sum = softmax_row(z, h, bl);
          const int l = 16 * q + gq + 8 * h;
          bool in, store = true;
          bf16* dst;
          size_t pstride;
          if (q < nhc) {
            const int y = y0 - PAD + l / HW, x = x0 - PAD + l % HW;
            in = y >= 0 && y < g.H && x >= 0 && x < g.W;
            store = l < NH;
            dst = sP1 + (size_t)l * kKP;
            pstride = m1;
          } else {
            const int lt = l - NHP;
            in = y0 + lt / kT < g.H && x0 + lt % kT < g.W;
            dst = sP2 + (size_t)lt * kKP;
            pstride = m2;
          }
          const float rs = in ? 1.f / sum : 0.f;
          if (store) {
#pragma unroll
            for (int n = 0; n < 3; ++n) {
              unsigned pc[kPP];
              split2<kPP>(z[n][2 * h] * rs, z[n][2 * h + 1] * rs, pc);
#pragma unroll
              for (int i = 0; i < kPP; ++i)
                *reinterpret_cast<unsigned*>(dst + i * pstride + 8 * n + 2 * tq) = pc[i];
            }
          }
        }
      }
    } else {
      // f32 features: one pixel a thread on the FP32 cores (exact f32)
      const float* sWf = reinterpret_cast<const float*>(smem + L.w);
      for (int idx = tid; idx < NH + kTile; idx += kThr) {
        const bool halo = idx < NH;
        const int l = halo ? idx : idx - NH;
        const int y = halo ? y0 - PAD + l / HW : y0 + l / kT;
        const int x = halo ? x0 - PAD + l % HW : x0 + l % kT;
        bf16* dst = (halo ? sP1 : sP2) + (size_t)l * kKP;
        const size_t pstride = halo ? m1 : m2;
        float p[kK];
        if (y >= 0 && y < g.H && x >= 0 && x < g.W) {
          float fr[C];
          load_row<C>((halo ? f1 : f2) + (((size_t)bi * g.H + y) * g.W + x) * C, fr);
          project_softmax<C, kK>(fr, sWf, sB, p);
        } else {
#pragma unroll
          for (int k = 0; k < kK; ++k) p[k] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < kKP; k += 2) {
          unsigned pc[kPP] = {0u, 0u};
          if (k < kK) split2<kPP>(p[k], p[k + 1], pc);
#pragma unroll
          for (int i = 0; i < kPP; ++i) *reinterpret_cast<unsigned*>(dst + i * pstride + k) = pc[i];
        }
      }
    }
    __syncthreads();  // (B) the maps are complete, the features consumed
    if constexpr (BF) {
      if (tile + (int)gridDim.x < g.ntiles) {
        load_f(tile + gridDim.x);     // lands while the joints run
        tc::cp_async_commit();
      }
    }

    // ---- the joints as an implicit GEMM over the tile's pixels: per tile
    // row (k = its 16 pixels) A = p1^T of the fragment's two row groups (a
    // shifted ldmatrix.trans view of the halo map) and B = p2 (three n8
    // tiles of j); the pieces' products hi hi + hi lo + lo hi. The tile's
    // sums go into fresh accumulators, added to the block's once a tile:
    // the tensor cores' f32 accumulation rounds toward zero, so one long
    // chain into a large accumulator drifts (4e-5 of the largest joint over
    // ~19 tiles a block at pad 1, twice that over twice the tiles at pad 2)
    float tacc[MF][3][4];
#pragma unroll
    for (int m = 0; m < MF; ++m)
#pragma unroll
      for (int n = 0; n < 3; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) tacc[m][n][e] = 0.f;
#pragma unroll 1
    for (int y = rg; y < kT; y += RG) {
      unsigned bq[kPP][6];
#pragma unroll
      for (int i = 0; i < kPP; ++i) {
        const bf16* Bp = sP2 + i * m2 + (size_t)(y * kT + lr + 8 * (lj & 1)) * kKP;
        unsigned r4[4], r2[2];
        tc::ldsm_x4_trans(tc::smem_addr(Bp + 8 * (lj >> 1)), r4);
        tc::ldsm_x2_trans(tc::smem_addr(Bp + 16), r2);
        bq[i][0] = r4[0]; bq[i][1] = r4[1]; bq[i][2] = r4[2]; bq[i][3] = r4[3];
        bq[i][4] = r2[0]; bq[i][5] = r2[1];
      }
      const bf16* Ay = sP1 + (size_t)y * HW * kKP;
#pragma unroll
      for (int m = 0; m < MF; ++m) {
        if (!has[m]) continue;
        unsigned a[kPP][4];
#pragma unroll
        for (int i = 0; i < kPP; ++i) tc::ldsm_x4_trans(tc::smem_addr(Ay + i * m1 + aoff[m]), a[i]);
#pragma unroll
        for (int i = 0; i < kPP; ++i)
#pragma unroll
          for (int j = 0; j < kPP; ++j) {
            if (i + j >= kPP) continue;
#pragma unroll
            for (int n = 0; n < 3; ++n) tc::mma_bf16(tacc[m][n], a[i], bq[j][2 * n], bq[j][2 * n + 1]);
          }
      }
    }
#pragma unroll
    for (int m = 0; m < MF; ++m)
#pragma unroll
      for (int n = 0; n < 3; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] += tacc[m][n][e];
  }

  // ---- the block's partial: the row groups' sums added in order through
  // shared memory (over the maps, once consumed), no atomics
  constexpr int nel = TD2 * kK * kK;
  float* out = part + ((size_t)s * gridDim.x + blockIdx.x) * nel;
  float* red = reinterpret_cast<float*>(smem + L.p);
  if constexpr (RG > 1) __syncthreads();
#pragma unroll 1
  for (int r = 0; r < RG; ++r) {
    if (rg == r) {
#pragma unroll
      for (int m = 0; m < MF; ++m) {
        if (!has[m]) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int h = 2 * (fg + FG * m) + hh;
          const int t = h / 3, i = 8 * (h % 3) + gq;
          if (h >= 3 * TD2 || i >= kK) continue;
#pragma unroll
          for (int n = 0; n < 3; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = 8 * n + 2 * tq + e, idx = (t * kK + i) * kK + j;
              if (j >= kK) continue;
              float v = acc[m][n][2 * hh + e];
              if (r > 0) v += red[idx];
              if (r == RG - 1) out[idx] = v;
              else red[idx] = v;
            }
        }
      }
    }
    if constexpr (RG > 1) __syncthreads();
  }
}

}  // namespace e1

// out[y][e] = sum_{q < nparts} part[y][q][e], q in order (slab y = blockIdx.y).
__global__ void __launch_bounds__(kSumThreads)
    sum_partials(const float* __restrict__ part, float* __restrict__ out, int nparts, int n) {
  const int e = blockIdx.x * kSumThreads + threadIdx.x;
  if (e >= n) return;
  const float* p = part + (size_t)blockIdx.y * nparts * n + e;
  float s = 0.f;
#pragma unroll 8
  for (int q = 0; q < nparts; ++q) s += p[(size_t)q * n];
  out[(size_t)blockIdx.y * n + e] = s;
}

// ---------------------------------------------------------------- E2 -----

namespace e2 {

constexpr int kTW = 16;              // tile columns: one m16 fragment of pixels

template <typename T>
struct Feat;
template <>
struct Feat<bf16> {
  static constexpr int NP = 2;       // pieces of p, dz and W
  static constexpr int NF = 1;       // pieces of a feature (exact in bf16)
};
template <>
struct Feat<float> {
  static constexpr int NP = 3;
  static constexpr int NF = 3;
};

struct G2 {
  int B, H, W, S, pad, td, td2;
  int th, hw, nh, nhp;               // tile rows; halo cols, pixels, pixels padded to 16
  int ntx, per_image, ntiles;
  int jrows;                         // rows of one (orientation, piece) cotangent block
  int jp;                            // pieces of the cotangent: 3 at pad 0, else 2
  int img;                           // bf16 elements of one subhead's operand image
  int nslot;                         // operand image slots in shared memory (1 or 2)
};

// bytes of each shared-memory region (the same on host and device)
struct Lay {
  size_t f, p, img, wf, bias, red, total;
};

__host__ __device__ inline Lay layout(const G2& g, int C, int np, bool bf) {
  Lay L;
  size_t o = 0;
  L.f = o;                           // bf16 features: [view][nhp][C + 8] halo tiles
  if (bf) o += 2ull * g.nhp * (C + 8) * 2;
  L.p = o;                           // [view][piece][nh][24] softmax halo maps
  o += 2ull * np * g.nh * kKP * 2;
  L.img = o;                         // [slot][img] cotangent and weight pieces
  o += (size_t)g.nslot * g.img * 2;
  L.wf = o;                          // f32 features: [S][C][K] weights for the f32 projection
  if (!bf) o += (size_t)g.S * C * kK * 4;
  L.bias = o;                        // [S][K]
  o += (size_t)g.S * kK * 4;
  L.red = o;                         // [warp][C + 1][24] dW and db sums of the warps
  o += (size_t)kWarps * (C + 1) * kKP * 4;
  L.total = o;
  return L;
}

__device__ __forceinline__ float2 unpack(unsigned u) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&u);
  return __bfloat1622float2(h);
}

// Operand image of subhead s (one block per subhead), read by the main
// kernel with 16-byte copies: the cotangent centred per view and split in
// JP pieces, [orientation][piece][jrows][24] (orientation 0 for dp2: rows j,
// columns i, Jbar_t[i][j] minus its mean over j; orientation 1 for dp1: rows
// i, columns j, minus its mean over i; rows of displacement t from 20 t, four
// zero rows at the end, columns 20-23 zero), then W_s split in NP pieces,
// [piece][C][24]. The means drop out of dz exactly (the softmax's VJP removes
// a pixel's constant), and without them the split would carry the rounding
// of a large constant.
template <int NP, int JP>
__global__ void __launch_bounds__(kThr)
    iic_joints_bwd_prep(const float* __restrict__ jbar, const float* __restrict__ w,
                        bf16* __restrict__ img, G2 g, int C) {
  __shared__ float rmean[25 * kK], cmean[25 * kK];
  const int s = blockIdx.x, tid = threadIdx.x, SK = g.S * kK;
  const float* J = jbar + (size_t)s * g.td2 * kK * kK;
  for (int e = tid; e < g.td2 * kK; e += kThr) {
    const int t = e / kK, a = e % kK;
    float r = 0.f, c = 0.f;
    for (int u = 0; u < kK; ++u) {
      r += J[(t * kK + a) * kK + u];
      c += J[(t * kK + u) * kK + a];
    }
    rmean[e] = r / kK;
    cmean[e] = c / kK;
  }
  __syncthreads();
  bf16* out = img + (size_t)s * g.img;
  const int nj = 2 * g.jrows * (kKP / 2);
  for (int e = tid; e < nj; e += kThr) {
    const int o = e / (g.jrows * (kKP / 2)), rem = e % (g.jrows * (kKP / 2));
    const int r = rem / (kKP / 2), k = 2 * (rem % (kKP / 2));
    float x[2] = {0.f, 0.f};
    if (r < g.td2 * kK) {
      const int t = r / kK, n = r % kK;
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (k + q < kK)
          x[q] = o == 0 ? J[(t * kK + k + q) * kK + n] - rmean[t * kK + k + q]
                        : J[(t * kK + n) * kK + k + q] - cmean[t * kK + k + q];
    }
    unsigned pc[JP];
    split2<JP>(x[0], x[1], pc);
#pragma unroll
    for (int i = 0; i < JP; ++i)
      *reinterpret_cast<unsigned*>(out + ((size_t)(o * JP + i) * g.jrows + r) * kKP + k) = pc[i];
  }
  bf16* wo = out + (size_t)2 * JP * g.jrows * kKP;
  for (int e = tid; e < C * (kKP / 2); e += kThr) {
    const int c = e / (kKP / 2), k = 2 * (e % (kKP / 2));
    const float a = k < kK ? w[(size_t)c * SK + s * kK + k] : 0.f;
    const float b = k + 1 < kK ? w[(size_t)c * SK + s * kK + k + 1] : 0.f;
    unsigned pc[NP];
    split2<NP>(a, b, pc);
#pragma unroll
    for (int i = 0; i < NP; ++i)
      *reinterpret_cast<unsigned*>(wo + ((size_t)i * C + c) * kKP + k) = pc[i];
  }
}

template <typename T, int C, int MF, int JP>
__global__ void __launch_bounds__(kThr, 1)
    iic_joints_bwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                          const float* __restrict__ w, const float* __restrict__ b,
                          const bf16* __restrict__ img, T* __restrict__ df1, T* __restrict__ df2,
                          float* __restrict__ part, G2 g) {
  constexpr bool BF = Feat<T>::NF == 1;
  constexpr int NP = Feat<T>::NP, NF = Feat<T>::NF;
  constexpr int NPJ = NP > JP ? NP : JP;  // products: pieces (i, j) with i + j < NPJ
  constexpr int CS = C + 8;          // feature halo pixel stride (elements)
  constexpr int CT = C / 8;          // n8 tiles of df (channels)
  constexpr int MT = (C + 15) / 16;  // m16 tiles of dW (channels)
  constexpr int RS = (C + 1) * kKP;  // floats of one warp's dW / db sums
  static_assert(C % 8 == 0 && C <= 32, "channels");
  extern __shared__ __align__(16) unsigned char smem[];
  const Lay L = layout(g, C, NP, BF);
  bf16* sF = reinterpret_cast<bf16*>(smem + L.f);
  bf16* sP = reinterpret_cast<bf16*>(smem + L.p);
  bf16* sImg = reinterpret_cast<bf16*>(smem + L.img);
  float* sWf = reinterpret_cast<float*>(smem + L.wf);
  float* sB = reinterpret_cast<float*>(smem + L.bias);
  float* sRed = reinterpret_cast<float*>(smem + L.red);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;      // mma fragment row / column pair
  const int lj = lane >> 3, lr = lane & 7;      // ldmatrix matrix / row of this lane
  const int S = g.S, SK = S * kK;
  const size_t mapsz = (size_t)g.nh * kKP;      // one piece of one view's halo map
  float* mypart = part + (size_t)blockIdx.x * (C + 1) * SK;

  for (int i = tid; i < SK; i += kThr) sB[i] = b[i];
  if (!BF)
    for (int i = tid; i < S * C * kK; i += kThr) {
      const int s = i / (C * kK), r = i % (C * kK), c = r / kK, k = r % kK;
      sWf[i] = w[(size_t)c * SK + s * kK + k];
    }

  auto load_img = [&](int s, int slot) {
    const char* src = reinterpret_cast<const char*>(img + (size_t)s * g.img);
    const unsigned dst = tc::smem_addr(sImg + (size_t)slot * g.img);
    for (int e = tid; e < g.img / 8; e += kThr) tc::cp_async16(dst + 16 * e, src + 16 * e, 16);
  };
  auto origin = [&](int tile, int& bi, int& y0, int& x0) {
    bi = tile / g.per_image;
    const int r = tile % g.per_image;
    y0 = (r / g.ntx) * g.th;
    x0 = (r % g.ntx) * kTW;
  };
  // both views' feature halos, zero outside the image (bf16 features)
  auto load_f = [&](int tile) {
    int bi, y0, x0;
    origin(tile, bi, y0, x0);
    for (int e = tid; e < 2 * g.nhp * (C / 8); e += kThr) {
      const int v = e / (g.nhp * (C / 8)), rem = e % (g.nhp * (C / 8));
      const int hp = rem / (C / 8), c8 = rem % (C / 8);
      const int y = y0 - g.pad + hp / g.hw, x = x0 - g.pad + hp % g.hw;
      const bool in = hp < g.nh && y >= 0 && y < g.H && x >= 0 && x < g.W;
      const T* src = in ? (v ? f2 : f1) + (((size_t)bi * g.H + y) * g.W + x) * C + c8 * 8 : f1;
      tc::cp_async16(tc::smem_addr(sF + ((size_t)v * g.nhp + hp) * CS + c8 * 8), src, in ? 16 : 0);
    }
  };

  load_img(0, 0);
  if constexpr (BF) load_f(blockIdx.x);
  tc::cp_async_commit();

  int k = 0;                          // subheads this block has run
  for (int tile = blockIdx.x; tile < g.ntiles; tile += gridDim.x) {
    int bi, y0, x0;
    origin(tile, bi, y0, x0);
    const bool first = tile == (int)blockIdx.x;
    float dfa[2][MF][CT][4];
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int f = 0; f < MF; ++f)
#pragma unroll
        for (int n = 0; n < CT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dfa[o][f][n][e] = 0.f;

    for (int s = 0; s < S; ++s, ++k) {
      const int slot = g.nslot == 2 ? (k & 1) : 0;
      tc::cp_async_wait<0>();
      __syncthreads();  // (A) features, this subhead's image; the last one's maps and sums consumed
      if (g.nslot == 2) {
        load_img((s + 1) % S, slot ^ 1);
        tc::cp_async_commit();
      }
      const bf16* sJ = sImg + (size_t)slot * g.img;
      const bf16* sW = sJ + (size_t)2 * JP * g.jrows * kKP;
      const float* bias = sB + s * kK;

      // ---- both views' softmaxes on the halo tile -> NP bf16 pieces
      if constexpr (BF) {
        // Z = F W_s on the tensor cores: 16 halo pixels x 24 clusters a chunk
        unsigned wb[NP][kSteps<C>][6];
        load_w_frags<NP, C>(sW, lane, wb);
        float bl[3][2];
        bias_cols(bias, lane, bl);
        const float hw_inv = 1.f / g.hw;
        const int nch = g.nhp / 16;
        for (int ch = warp; ch < 2 * nch; ch += kWarps) {
          const int v = ch >= nch, q = ch - v * nch;
          float z[3][4];
          project_chunk<NP, C, CS>(sF + ((size_t)v * g.nhp + 16 * q) * CS, lane, wb, z);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float sum = softmax_row(z, h, bl);
            const int l = 16 * q + gq + 8 * h;
            const int hy = (int)((l + 0.5f) * hw_inv);           // l / hw for l < 2^16
            const int y = y0 - g.pad + hy, x = x0 - g.pad + l - hy * g.hw;
            const float rs = y >= 0 && y < g.H && x >= 0 && x < g.W ? 1.f / sum : 0.f;
            if (l < g.nh) {
#pragma unroll
              for (int n = 0; n < 3; ++n) {
                unsigned pc[NP];
                split2<NP>(z[n][2 * h] * rs, z[n][2 * h + 1] * rs, pc);
#pragma unroll
                for (int i = 0; i < NP; ++i)
                  *reinterpret_cast<unsigned*>(sP + (v * NP + i) * mapsz + (size_t)l * kKP + 8 * n +
                                               2 * tq) = pc[i];
              }
            }
          }
        }
      } else {
        // f32 features: one halo pixel a thread on the FP32 cores (exact f32)
        for (int idx = tid; idx < 2 * g.nh; idx += kThr) {
          const int v = idx / g.nh, l = idx % g.nh;
          const int y = y0 - g.pad + l / g.hw, x = x0 - g.pad + l % g.hw;
          float p[kKP];
#pragma unroll
          for (int q = 0; q < kKP; ++q) p[q] = 0.f;
          if (y >= 0 && y < g.H && x >= 0 && x < g.W) {
            float fr[C], pk[kK];
            load_row<C>((v ? f2 : f1) + (((size_t)bi * g.H + y) * g.W + x) * C, fr);
            project_softmax<C, kK>(fr, sWf + s * C * kK, bias, pk);
#pragma unroll
            for (int q = 0; q < kK; ++q) p[q] = pk[q];
          }
#pragma unroll
          for (int q = 0; q < kKP; q += 2) {
            unsigned pc[NP];
            split2<NP>(p[q], p[q + 1], pc);
#pragma unroll
            for (int i = 0; i < NP; ++i)
              *reinterpret_cast<unsigned*>(sP + (v * NP + i) * mapsz + (size_t)l * kKP + q) = pc[i];
          }
        }
      }
      __syncthreads();  // (B) the halo maps are complete

      float dwa[MT][3][4], dba[3][2];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < 3; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dwa[m][n][e] = 0.f;
#pragma unroll
      for (int n = 0; n < 3; ++n) dba[n][0] = dba[n][1] = 0.f;

      // ---- view o: o = 1 gives dz2 (f2's pixels), o = 0 dz1 (f1's pixels)
#pragma unroll
      for (int o = 1; o >= 0; --o) {
        const bf16* A0 = sP + (size_t)(1 - o) * NP * mapsz;   // the other view's halo map
        const bf16* So = sP + (size_t)o * NP * mapsz;         // this view's softmaxes
        const bf16* Jo = sJ + (size_t)(1 - o) * JP * g.jrows * kKP;
        float acc[MF][3][4];
#pragma unroll
        for (int f = 0; f < MF; ++f)
#pragma unroll
          for (int n = 0; n < 3; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[f][n][e] = 0.f;
        // dp as implicit GEMMs: displacement t is a shifted ldmatrix view of
        // the halo map (dp2 at +off_t, dp1 at -off_t), K = 24 as k16 + k8.
        // Output columns 20-23 read the next block's rows: finite, and the
        // VJP multiplies them by s = 0
        for (int t = 0; t < g.td2; ++t) {
          const int ty = t / g.td, tx = t % g.td;
          const int hy = o ? ty : g.td - 1 - ty, hx = o ? tx : g.td - 1 - tx;
          unsigned bj[JP][9];
#pragma unroll
          for (int j = 0; j < JP; ++j) {
            const bf16* Jt = Jo + ((size_t)j * g.jrows + t * kK) * kKP;
            unsigned r4[4], r2[2], s2[2];
            tc::ldsm_x4(tc::smem_addr(Jt + (lr + 8 * (lj >> 1)) * kKP + 8 * (lj & 1)), r4);
            tc::ldsm_x2(tc::smem_addr(Jt + (16 + lr) * kKP + 8 * (lj & 1)), r2);
            tc::ldsm_x2(tc::smem_addr(Jt + (lr + 8 * (lj & 1)) * kKP + 16), s2);
            bj[j][0] = r4[0]; bj[j][1] = r4[1]; bj[j][2] = r4[2]; bj[j][3] = r4[3];
            bj[j][4] = r2[0]; bj[j][5] = r2[1];
            bj[j][6] = s2[0]; bj[j][7] = s2[1];
            bj[j][8] = tc::ldsm_x1(tc::smem_addr(Jt + (16 + lr) * kKP + 16));
          }
#pragma unroll
          for (int f = 0; f < MF; ++f) {
            const int base = (MF * warp + f + hy) * g.hw + hx;
            unsigned a[NP][6];
#pragma unroll
            for (int i = 0; i < NP; ++i) {
              const bf16* Ap = A0 + i * mapsz + (size_t)(base + lr + 8 * (lj & 1)) * kKP;
              unsigned r4[4], r2[2];
              tc::ldsm_x4(tc::smem_addr(Ap + 8 * (lj >> 1)), r4);
              tc::ldsm_x2(tc::smem_addr(Ap + 16), r2);
              a[i][0] = r4[0]; a[i][1] = r4[1]; a[i][2] = r4[2]; a[i][3] = r4[3];
              a[i][4] = r2[0]; a[i][5] = r2[1];
            }
#pragma unroll
            for (int i = 0; i < NP; ++i)
#pragma unroll
              for (int j = 0; j < JP; ++j) {
                if (i + j >= NPJ) continue;
                const unsigned a4[4] = {a[i][0], a[i][1], a[i][2], a[i][3]};
#pragma unroll
                for (int n = 0; n < 3; ++n) {
                  tc::mma_bf16(acc[f][n], a4, bj[j][2 * n], bj[j][2 * n + 1]);
                  tc::mma_bf16_k8(acc[f][n], a[i][4], a[i][5], bj[j][6 + n]);
                }
              }
          }
        }

        // W_s^T fragments for df: k16 (clusters 0-15) and k8 (16-23) per channel tile
        unsigned wd[NP][CT][3];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const bf16* wp = sW + (size_t)i * C * kKP;
          if constexpr (C >= 16) {
#pragma unroll
            for (int cp = 0; cp < C / 16; ++cp) {
              unsigned r4[4];
              tc::ldsm_x4(tc::smem_addr(wp + (16 * cp + lr + 8 * (lj >> 1)) * kKP + 8 * (lj & 1)), r4);
              wd[i][2 * cp][0] = r4[0]; wd[i][2 * cp][1] = r4[1];
              wd[i][2 * cp + 1][0] = r4[2]; wd[i][2 * cp + 1][1] = r4[3];
            }
          } else {
            unsigned r2[2];
            tc::ldsm_x2(tc::smem_addr(wp + lr * kKP + 8 * (lj & 1)), r2);
            wd[i][0][0] = r2[0];
            wd[i][0][1] = r2[1];
          }
          if constexpr (C == 32) {
            unsigned r4[4];
            tc::ldsm_x4(tc::smem_addr(wp + (lr + 8 * lj) * kKP + 16), r4);
#pragma unroll
            for (int n = 0; n < 4; ++n) wd[i][n][2] = r4[n];
          } else if constexpr (C == 16) {
            unsigned r2[2];
            tc::ldsm_x2(tc::smem_addr(wp + (lr + 8 * (lj & 1)) * kKP + 16), r2);
            wd[i][0][2] = r2[0];
            wd[i][1][2] = r2[1];
          } else {
            wd[i][0][2] = tc::ldsm_x1(tc::smem_addr(wp + lr * kKP + 16));
          }
        }

#pragma unroll
        for (int f = 0; f < MF; ++f) {
          const int row = MF * warp + f;
          const int own = (row + g.pad) * g.hw + g.pad;      // halo index of the row's pixel 0
          // the softmax's VJP on the accumulators: dz = s (dp - <dp, s>)
          float sv[3][4], in2[2] = {0.f, 0.f};
#pragma unroll
          for (int n = 0; n < 3; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float2 x = make_float2(0.f, 0.f);
#pragma unroll
              for (int i = 0; i < NP; ++i) {
                const float2 u = unpack(*reinterpret_cast<const unsigned*>(
                    So + i * mapsz + (size_t)(own + gq + 8 * h) * kKP + 8 * n + 2 * tq));
                x.x += u.x;
                x.y += u.y;
              }
              sv[n][2 * h] = x.x;
              sv[n][2 * h + 1] = x.y;
              in2[h] = fmaf(acc[f][n][2 * h], x.x, fmaf(acc[f][n][2 * h + 1], x.y, in2[h]));
            }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            in2[h] += __shfl_xor_sync(0xffffffffu, in2[h], 1);
            in2[h] += __shfl_xor_sync(0xffffffffu, in2[h], 2);
          }
          float dz[3][4];
#pragma unroll
          for (int n = 0; n < 3; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) dz[n][e] = sv[n][e] * (acc[f][n][e] - in2[e >> 1]);
#pragma unroll
          for (int n = 0; n < 3; ++n) {
            dba[n][0] += dz[n][0] + dz[n][2];
            dba[n][1] += dz[n][1] + dz[n][3];
          }
          // dz in NP pieces, as the A fragments of df (k = clusters): the
          // accumulator layout of two n8 tiles is the A layout of one k16
          unsigned az[NP][6];
#pragma unroll
          for (int n = 0; n < 3; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              unsigned pc[NP];
              split2<NP>(dz[n][2 * h], dz[n][2 * h + 1], pc);
#pragma unroll
              for (int i = 0; i < NP; ++i) az[i][2 * n + h] = pc[i];
            }
          // df += dz W_s^T
#pragma unroll
          for (int i = 0; i < NP; ++i)
#pragma unroll
            for (int j = 0; j < NP; ++j) {
              if (i + j >= NP) continue;
              const unsigned a4[4] = {az[i][0], az[i][1], az[i][2], az[i][3]};
#pragma unroll
              for (int n = 0; n < CT; ++n) {
                tc::mma_bf16(dfa[o][f][n], a4, wd[j][n][0], wd[j][n][1]);
                tc::mma_bf16_k8(dfa[o][f][n], az[i][4], az[i][5], wd[j][n][2]);
              }
            }
          // dW_s += F^T dz: dz's B fragments (k = pixels) by an in-register transpose
          unsigned bz[NP][3][2];
#pragma unroll
          for (int i = 0; i < NP; ++i)
#pragma unroll
            for (int n = 0; n < 3; ++n) {
              bz[i][n][0] = tc::movmatrix_trans(az[i][2 * n]);
              bz[i][n][1] = tc::movmatrix_trans(az[i][2 * n + 1]);
            }
          unsigned af[NF][MT][4];
          if constexpr (BF) {
            const bf16* F = sF + (size_t)o * g.nhp * CS;
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              if constexpr (C >= 16) {
                tc::ldsm_x4_trans(tc::smem_addr(F + (own + lr + 8 * (lj >> 1)) * CS + 16 * m + 8 * (lj & 1)),
                                  af[0][m]);
              } else {
                unsigned r2[2];
                tc::ldsm_x2_trans(tc::smem_addr(F + (own + lr + 8 * (lj & 1)) * CS), r2);
                af[0][m][0] = r2[0];
                af[0][m][1] = 0u;
                af[0][m][2] = r2[1];
                af[0][m][3] = 0u;
              }
            }
          } else {
            // f32 features: the transposed fragments straight from device memory
            const T* fo = o ? f2 : f1;
            const int y = y0 + row;
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int c = 16 * m + gq + 8 * (r & 1), x = x0 + 2 * tq + 8 * (r >> 1);
                float v0 = 0.f, v1 = 0.f;
                if (c < C && y < g.H) {
                  const T* pp = fo + (((size_t)bi * g.H + y) * g.W + x) * C + c;
                  if (x < g.W) v0 = pp[0];
                  if (x + 1 < g.W) v1 = pp[C];
                }
                unsigned pc[NF];
                split2<NF>(v0, v1, pc);
#pragma unroll
                for (int i = 0; i < NF; ++i) af[i][m][r] = pc[i];
              }
          }
#pragma unroll
          for (int i = 0; i < NF; ++i)
#pragma unroll
            for (int j = 0; j < NP; ++j) {
              if (i + j >= NP) continue;
#pragma unroll
              for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int n = 0; n < 3; ++n) tc::mma_bf16(dwa[m][n], af[i][m], bz[j][n][0], bz[j][n][1]);
            }
        }
      }

      // ---- this warp's dW and db sums of the subhead -> sRed[warp]
      float* red = sRed + warp * RS;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < 3; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 16 * m + gq + 8 * (e >> 1);
            if (c < C) red[c * kKP + 8 * n + 2 * tq + (e & 1)] = dwa[m][n][e];
          }
#pragma unroll
      for (int n = 0; n < 3; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = dba[n][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (gq == 0) red[C * kKP + 8 * n + 2 * tq + e] = v;
        }
      __syncthreads();  // (C) the maps and this image are consumed; the warps' sums are complete
      if (g.nslot == 1) load_img((s + 1) % S, 0);
      if constexpr (BF)
        if (s == S - 1 && tile + (int)gridDim.x < g.ntiles) load_f(tile + gridDim.x);
      tc::cp_async_commit();
      // the block's partial: warps summed in order, tiles in order (no
      // atomics); each thread's earlier values are read together
      constexpr int NE = ((C + 1) * kK + kThr - 1) / kThr;
      float v[NE], old[NE];
      size_t dst[NE];
#pragma unroll
      for (int r = 0; r < NE; ++r) {
        const int e = tid + r * kThr, c = e / kK, kk = e % kK;
        v[r] = old[r] = 0.f;
        dst[r] = c < C ? (size_t)(s * C + c) * kK + kk : (size_t)S * C * kK + s * kK + kk;
        if (e < (C + 1) * kK) {
#pragma unroll
          for (int q = 0; q < kWarps; ++q) v[r] += sRed[q * RS + c * kKP + kk];
          if (!first) old[r] = mypart[dst[r]];
        }
      }
#pragma unroll
      for (int r = 0; r < NE; ++r)
        if (tid + r * kThr < (C + 1) * kK) mypart[dst[r]] = old[r] + v[r];
    }

    // ---- df of the tile's real pixels, summed over the subheads
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      T* dfo = o ? df2 : df1;
#pragma unroll
      for (int f = 0; f < MF; ++f) {
        const int y = y0 + MF * warp + f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = x0 + gq + 8 * h;
          if (y >= g.H || x >= g.W) continue;
          T* dst = dfo + (((size_t)bi * g.H + y) * g.W + x) * C + 2 * tq;
#pragma unroll
          for (int n = 0; n < CT; ++n) {
            if constexpr (BF)
              *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
                  __floats2bfloat162_rn(dfa[o][f][n][2 * h], dfa[o][f][n][2 * h + 1]);
            else
              *reinterpret_cast<float2*>(dst + 8 * n) =
                  make_float2(dfa[o][f][n][2 * h], dfa[o][f][n][2 * h + 1]);
          }
        }
      }
    }
  }
  tc::cp_async_wait<0>();
}

}  // namespace e2

// dw[c][s*K + k] = sum_q part[q][(s*C + c)*K + k], db[s*K + k] = sum_q
// part[q][S*C*K + s*K + k], q in order.
__global__ void __launch_bounds__(kSumThreads)
    sum_dw(const float* __restrict__ part, float* __restrict__ dw, float* __restrict__ db,
           int nparts, int C, int S, int K) {
  const int n = S * C * K + S * K;
  const int e = blockIdx.x * kSumThreads + threadIdx.x;
  if (e >= n) return;
  int src;
  float* dst;
  if (e < S * C * K) {
    const int c = e / (S * K), col = e - c * S * K, s = col / K, k = col - s * K;
    src = (s * C + c) * K + k;
    dst = dw + e;
  } else {
    src = e;
    dst = db + (e - S * C * K);
  }
  float a = 0.f;
#pragma unroll 8
  for (int q = 0; q < nparts; ++q) a += part[(size_t)q * n + src];
  *dst = a;
}

// ------------------------------------------------------------- host -----

struct Args {
  const void *f1, *f2, *w, *b, *jbar;
  void *df1, *df2, *part, *out, *dw, *db;
  Geo g;
  int C;
  cudaStream_t stream;
};

template <typename K>
int resident_blocks(K kern, size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThr, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  return 0;
}

// E2's geometry: 16-row tiles for bf16 features at padding <= 1, else 8 rows;
// two operand image slots where shared memory holds them
int make_g2(const Geo& in, int C, bool bf, e2::G2* out) {
  e2::G2 g;
  g.B = in.B;
  g.H = in.H;
  g.W = in.W;
  g.S = in.S;
  g.pad = in.pad;
  g.td = in.td;
  g.td2 = in.td2;
  g.th = bf && in.pad <= 1 ? 16 : 8;
  g.hw = e2::kTW + 2 * in.pad;
  g.nh = (g.th + 2 * in.pad) * g.hw;
  g.nhp = (g.nh + 15) / 16 * 16;
  g.ntx = (in.W + e2::kTW - 1) / e2::kTW;
  g.per_image = ((in.H + g.th - 1) / g.th) * g.ntx;
  g.ntiles = in.B * g.per_image;
  g.jrows = g.td2 * kK + 4;
  // a third piece of the cotangent at pad 0: there the loss's joint is not
  // min-shift normalized, and db, a sum over every pixel of terms that
  // cancel, keeps the rounding of the cotangent's second piece
  g.jp = in.pad == 0 ? 3 : 2;
  const int np = bf ? e2::Feat<__nv_bfloat16>::NP : e2::Feat<float>::NP;
  g.img = 2 * g.jp * g.jrows * kKP + np * C * kKP;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  g.nslot = 2;
  if (e2::layout(g, C, np, bf).total > (size_t)optin) g.nslot = 1;
  if (e2::layout(g, C, np, bf).total > (size_t)optin) return (int)cudaErrorInvalidConfiguration;
  *out = g;
  return 0;
}

template <typename T, int C>
struct Impl {
  static constexpr bool BF = e2::Feat<T>::NF == 1;
  static constexpr int NP = e2::Feat<T>::NP;

  // E2's main kernel at the tile height of g (16 rows: two m16 row fragments
  // a warp) and its pieces of the cotangent
  template <typename F>
  static int with_bwd_kernel(const e2::G2& g, F&& fn) {
    if constexpr (BF) {
      if (g.th == 8) return fn(e2::iic_joints_bwd_kernel<T, C, 1, 2>);  // pad 2
      return g.jp == 3 ? fn(e2::iic_joints_bwd_kernel<T, C, 2, 3>)
                       : fn(e2::iic_joints_bwd_kernel<T, C, 2, 2>);
    } else {
      return g.jp == 3 ? fn(e2::iic_joints_bwd_kernel<T, C, 1, 3>)
                       : fn(e2::iic_joints_bwd_kernel<T, C, 1, 2>);
    }
  }

  // E1's kernel at padding pad, with its warp plan
  template <typename F>
  static int with_fwd_kernel(int pad, F&& fn) {
    if (pad == 0) return fn(e1::iic_joints_kernel<T, C, e1::Pad0>);
    if (pad == 1) return fn(e1::iic_joints_kernel<T, C, e1::Pad1>);
    return fn(e1::iic_joints_kernel<T, C, e1::Pad2>);
  }

  // blocks of the grid's x dimension, one partial each, per subhead (E1) /
  // the block partials and the rows that hold the operand images (E2)
  static int plan(int mode, const Geo& g, int* nblk, int* nparts) {
    int blocks = 0, rc;
    if (mode == 0) {
      const e1::Lay L = e1::layout(g, C, BF);
      rc = with_fwd_kernel(g.pad, [&](auto kern) { return resident_blocks(kern, L.total, &blocks); });
      if (rc) return rc;
      *nblk = blocks / g.S > 1 ? blocks / g.S : 1;
      if (*nblk > g.ntiles) *nblk = g.ntiles;
      *nparts = *nblk;
    } else {
      e2::G2 g2;
      if ((rc = make_g2(g, C, BF, &g2))) return rc;
      const size_t smem = e2::layout(g2, C, NP, BF).total;
      rc = with_bwd_kernel(g2, [&](auto kern) { return resident_blocks(kern, smem, &blocks); });
      if (rc) return rc;
      *nblk = blocks < g2.ntiles ? blocks : g2.ntiles;
      const size_t row = sizeof(float) * (size_t)g.S * (C + 1) * kK;
      *nparts = *nblk + (int)((sizeof(__nv_bfloat16) * (size_t)g.S * g2.img + row - 1) / row);
    }
    return 0;
  }

  static int fwd(const Args& a) {
    int nblk = 0, nparts = 0;
    int rc = plan(0, a.g, &nblk, &nparts);
    if (rc) return rc;
    with_fwd_kernel(a.g.pad, [&](auto kern) {
      kern<<<dim3(nblk, a.g.S), kThr, e1::layout(a.g, C, BF).total, a.stream>>>(
          static_cast<const T*>(a.f1), static_cast<const T*>(a.f2),
          static_cast<const float*>(a.w), static_cast<const float*>(a.b),
          static_cast<float*>(a.part), a.g);
      return 0;
    });
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n = a.g.td2 * kK * kK;
    sum_partials<<<dim3((n + kSumThreads - 1) / kSumThreads, a.g.S), kSumThreads, 0, a.stream>>>(
        static_cast<const float*>(a.part), static_cast<float*>(a.out), nparts, n);
    return (int)cudaGetLastError();
  }

  // E2: the operand images (prep, one block a subhead), the main kernel, then
  // the fixed-order sum of the block partials
  static int bwd(const Args& a) {
    int nblk = 0, nparts = 0;
    int rc = plan(1, a.g, &nblk, &nparts);
    if (rc) return rc;
    e2::G2 g2;
    if ((rc = make_g2(a.g, C, BF, &g2))) return rc;
    float* part = static_cast<float*>(a.part);
    auto* img = reinterpret_cast<__nv_bfloat16*>(part + (size_t)nblk * a.g.S * (C + 1) * kK);
    auto prep = g2.jp == 3 ? e2::iic_joints_bwd_prep<NP, 3> : e2::iic_joints_bwd_prep<NP, 2>;
    prep<<<a.g.S, kThr, 0, a.stream>>>(static_cast<const float*>(a.jbar),
                                           static_cast<const float*>(a.w), img, g2, C);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t smem = e2::layout(g2, C, NP, BF).total;
    with_bwd_kernel(g2, [&](auto kern) {
      kern<<<nblk, kThr, smem, a.stream>>>(
          static_cast<const T*>(a.f1), static_cast<const T*>(a.f2),
          static_cast<const float*>(a.w), static_cast<const float*>(a.b), img,
          static_cast<T*>(a.df1), static_cast<T*>(a.df2), part, g2);
      return 0;
    });
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n = a.g.S * (C + 1) * kK;
    sum_dw<<<(n + kSumThreads - 1) / kSumThreads, kSumThreads, 0, a.stream>>>(
        part, static_cast<float*>(a.dw), static_cast<float*>(a.db), nblk, C, a.g.S, kK);
    return (int)cudaGetLastError();
  }
};

bool valid(int B, int H, int W, int C, int S, int K, int pad, int bf16) {
  return B > 0 && H > 0 && W > 0 && S > 0 && K == kK && S * K <= kMaxSK && pad >= 0 &&
         pad <= kMaxPad && (C == 8 || C == 16 || C == 32) && (bf16 == 0 || bf16 == 1);
}

// mode 0: E1 plan, 1: E2 plan, 2: E1 run, 3: E2 run
int dispatch(int mode, int bf16, const Args& a, int* nblk, int* nparts) {
#define IIC_CASE(T, C)                                                        \
  if (mode < 2) return Impl<T, C>::plan(mode, a.g, nblk, nparts);          \
  return mode == 2 ? Impl<T, C>::fwd(a) : Impl<T, C>::bwd(a);
  if (bf16) {
    if (a.C == 8) { IIC_CASE(__nv_bfloat16, 8) }
    if (a.C == 16) { IIC_CASE(__nv_bfloat16, 16) }
    IIC_CASE(__nv_bfloat16, 32)
  }
  if (a.C == 8) { IIC_CASE(float, 8) }
  if (a.C == 16) { IIC_CASE(float, 16) }
  IIC_CASE(float, 32)
#undef IIC_CASE
}

}  // namespace

extern "C" {

const char* iic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Rows of the f32 buffer the caller allocates: mode 0 (E1) [S, n, td^2, K, K],
// the blocks' partials; mode 1 (E2) [n, S (C + 1) K], the blocks' partials
// followed by E2's workspace (rows that hold each subhead's centred, split
// cotangent and split W_s, written by iic_joints_bwd_prep). Returns n, or
// minus a CUDA error code.
int iic_num_partials(int mode, int B, int H, int W, int C, int S, int K, int pad, int bf16) {
  if (!valid(B, H, W, C, S, K, pad, bf16) || (mode != 0 && mode != 1))
    return -(int)cudaErrorInvalidValue;
  Args a{};
  a.g = make_geo(B, H, W, S, pad);
  a.C = C;
  int nblk = 0, nparts = 0;
  const int rc = dispatch(mode, bf16, a, &nblk, &nparts);
  return rc != 0 ? -rc : nparts;
}

// E1. f1, f2 [B,H,W,C] (bf16 if bf16 else f32), w [C, S*K] and b [S*K] f32
// (1/T folded in); part: the mode-0 partials; raw [S, td, td, K, K] f32.
int iic_joints(const void* f1, const void* f2, const void* w, const void* b, void* part,
               void* raw, int B, int H, int W, int C, int S, int K, int pad, int bf16,
               void* stream) {
  if (!valid(B, H, W, C, S, K, pad, bf16)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.f1 = f1;
  a.f2 = f2;
  a.w = w;
  a.b = b;
  a.part = part;
  a.out = raw;
  a.g = make_geo(B, H, W, S, pad);
  a.C = C;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(2, bf16, a, nullptr, nullptr);
}

// E2. The inputs of E1 plus jbar [S, td, td, K, K] f32 -> df1, df2 [B,H,W,C]
// (the features' dtype), dw [C, S*K] and db [S*K] f32; work: the mode-1 buffer
// (partials, then workspace).
int iic_joints_bwd(const void* f1, const void* f2, const void* w, const void* b,
                   const void* jbar, void* df1, void* df2, void* work, void* dw, void* db,
                   int B, int H, int W, int C, int S, int K, int pad, int bf16, void* stream) {
  if (!valid(B, H, W, C, S, K, pad, bf16)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.f1 = f1;
  a.f2 = f2;
  a.w = w;
  a.b = b;
  a.jbar = jbar;
  a.df1 = df1;
  a.df2 = df2;
  a.part = work;
  a.dw = dw;
  a.db = db;
  a.g = make_geo(B, H, W, S, pad);
  a.C = C;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(3, bf16, a, nullptr, nullptr);
}

}  // extern "C"
