// Dense-IIC displacement joints (E1) and their backward (E2): a linear dense
// cluster head's per-subhead softmaxes over two NHWC feature maps and the
// joints of their displaced pairs, f32 math on bf16 or f32 features.
//
//   E1 iic_joints      replaces contrastyou_tpu/ops/pallas/iic.py _fwd_kernel:
//                      p = softmax_K(f W_s + b_s) per pixel and subhead s, then
//                      raw[s,ty,tx,i,j] = sum_{b,h,w} p1[b,h+dy,w+dx,s,i] p2[b,h,w,s,j]
//                      with (dy,dx) = (ty,tx) - pad and p1 zero outside the image
//                      (the zero padding is on the probabilities, not on the
//                      features: a border pixel's displaced partner contributes 0).
//   E2 iic_joints_bwd  replaces iic.py _bwd_kernel: for the cotangent Jbar of raw,
//                      dp2(l) = sum_t Jbar_t^T p1(l + off_t), dp1(m) = sum_t Jbar_t
//                      p2(m - off_t) (both maps zero outside the image), dz = s (dp -
//                      <dp, s>) per subhead on real pixels, then df = W dz, dW = sum
//                      f dz^T, db = sum dz. W and b carry 1/T already.
//
// The TPU layout is not carried over: no row-band chunks with halo masks, no
// K -> 24 padding with -1e9 bias slots, no lane rolls, and only the S diagonal
// K x K blocks of each displacement's joint are formed (the TPU kernel
// contracts the whole [S*Kp, S*Kp] product and keeps its diagonal blocks,
// 7.2x the joint arithmetic at S = 5, K = 20).
//
// What bounds it on the H100: at the udaiic shapes (B = 5, 224 x 224, C = 32,
// S = 5, K = 20, 9 displacements) E1 does ~12.2 GFLOP on 32 MB of features
// and E2 ~27.7 GFLOP on 64 MB (features in, feature gradients out), 380-430
// FLOP per byte: the FP32 cores (67 TFLOP/s), not the memory, set the bound.
// So the design keeps every probability map on chip and spends its shared
// memory on them. Blocks are persistent and walk 16 x 16-pixel tiles:
//
// - E1: one block per (set of tiles, subhead). Per tile it projects the
//   tile's f2 pixels and the (16 + 2 pad)^2 halo of f1 pixels into softmaxes
//   in shared memory, then each thread accumulates 4 x 4 blocks of the K x K
//   joints of one or more displacements in registers across all its tiles
//   (several thread groups split the pixels when there are few blocks, as at
//   pad 0). Each (block, group) writes one f32 partial.
// - E2: one block per set of tiles, one thread per pixel, all subheads in
//   turn (df sums over them). Per subhead: Jbar_s and both halo softmaxes in
//   shared memory; each thread forms dp, dz and the df sums of its own pixel
//   in registers; then the block folds f dz^T into a dW partial in shared
//   memory (one (channel, 4-cluster) item per thread).
//
// A second kernel sums the partials in a fixed order: no atomics, and every
// run gives the same result. FP32 cores with f32 accumulation, as the TPU
// kernel's preferred_element_type=f32 dots; tensor cores are later work (the
// loss's min-shift normalization amplifies joint errors, so TF32 needs an
// accuracy study first).
//
// Every entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not
// take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 16;               // tile side in pixels
constexpr int kTile = kT * kT;       // pixels of a tile
constexpr int kThreads = kTile;      // E2: one thread per tile pixel
constexpr int kK = 20;               // clusters per subhead the kernels are built for
constexpr int kMaxPad = 2;
constexpr int kMaxSK = 160;          // largest S * K
constexpr int kMaxPer = 4;           // E1 accumulator items per thread
constexpr int kSumThreads = 256;

struct Geo {
  int B, H, W, S, pad;
  int td, td2;                       // displacements per axis, in all
  int hw, nh;                        // halo tile side, halo tile pixels
  int ntx, ntiles;                   // tiles per image row, tiles in all
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

// f32 registers -> one pixel's C values in the features' dtype (round to nearest even).
template <int C>
__device__ __forceinline__ void store_row(__nv_bfloat16* __restrict__ p, const float (&f)[C]) {
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int v = 0; v < C / 8; ++v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(f[8 * v + 2 * e], f[8 * v + 2 * e + 1]);
    q[v] = u;
  }
}

template <int C>
__device__ __forceinline__ void store_row(float* __restrict__ p, const float (&f)[C]) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int v = 0; v < C / 4; ++v)
    q[v] = make_float4(f[4 * v], f[4 * v + 1], f[4 * v + 2], f[4 * v + 3]);
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

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

// The softmax's VJP: dz = s (dp - <dp, s>), s read from shared memory.
template <int K>
__device__ __forceinline__ void softmax_vjp(const float (&dp)[K], const float* s, float (&dz)[K]) {
  float sv[K];
  float inner = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    sv[k] = s[k];
    inner = fmaf(dp[k], sv[k], inner);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) dz[k] = sv[k] * (dp[k] - inner);
}

// d[c] += sum_k w[c][k] dz[k] (w: one subhead's [C][K] in shared memory).
template <int C, int K>
__device__ __forceinline__ void accumulate_df(const float* w, const float (&dz)[K], float (&d)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(w + c * K + k);
      a = fmaf(w4.x, dz[k], a);
      a = fmaf(w4.y, dz[k + 1], a);
      a = fmaf(w4.z, dz[k + 2], a);
      a = fmaf(w4.w, dz[k + 3], a);
    }
    d[c] += a;
  }
}

// ---------------------------------------------------------------- E1 -----

template <typename T, int C, int K>
__global__ void __launch_bounds__(kTile)
    iic_joints_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                      const float* __restrict__ w, const float* __restrict__ b,
                      float* __restrict__ part, Geo g) {
  static_assert(K % 4 == 0, "clusters come in groups of 4");
  constexpr int NB = K / 4;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                  // [C][K] weights of this block's subhead
  float* bs = ws + C * K;            // [K]
  float* p1h = bs + K;               // [nh][K] p1 on the halo tile, zero outside the image
  float* p2t = p1h + g.nh * K;       // [kTile][K] p2 on the tile, zero outside the image
  const int tid = threadIdx.x, s = blockIdx.y, SK = g.S * K;
  for (int i = tid; i < C * K; i += kTile) {
    const int c = i / K, k = i - c * K;
    ws[i] = w[(size_t)c * SK + s * K + k];
  }
  for (int k = tid; k < K; k += kTile) bs[k] = b[s * K + k];

  // accumulator items (t, ib, jb): the 4 x 4 block (ib, jb) of displacement t's
  // K x K joint; with fewer items than threads, `groups` thread groups split the
  // tile's pixels and each keeps its own partial
  const int nitems = g.td2 * NB * NB;
  const bool few = nitems < kTile;
  const int groups = few ? kTile / nitems : 1;
  const int nper = (nitems + kTile - 1) / kTile;
  const int grp = few ? tid / nitems : 0;
  const bool active = grp < groups;
  int tix[kMaxPer], toff[kMaxPer], iofs[kMaxPer], jofs[kMaxPer];
  bool has[kMaxPer];
  float acc[kMaxPer][16];
#pragma unroll
  for (int r = 0; r < kMaxPer; ++r) {
    const int it = (few ? tid % nitems : tid) + r * kTile;
    has[r] = active && r < nper && it < nitems;
    const int t = it / (NB * NB), ij = it - t * NB * NB;
    tix[r] = t;
    toff[r] = (t / g.td) * g.hw + t % g.td;
    iofs[r] = (ij / NB) * 4;
    jofs[r] = (ij % NB) * 4;
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[r][e] = 0.f;
  }

  for (int tile = blockIdx.x; tile < g.ntiles; tile += gridDim.x) {
    int bi, y0, x0;
    tile_origin(g, tile, bi, y0, x0);
    __syncthreads();                   // weights staged / the last tile's maps consumed
    for (int idx = tid; idx < g.nh + kTile; idx += kTile) {
      const bool halo = idx < g.nh;
      const int l = halo ? idx : idx - g.nh;
      const int y = halo ? y0 - g.pad + l / g.hw : y0 + l / kT;
      const int x = halo ? x0 - g.pad + l % g.hw : x0 + l % kT;
      float* dst = (halo ? p1h : p2t) + l * K;
      float p[K];
      if (y >= 0 && y < g.H && x >= 0 && x < g.W) {
        float f[C];
        load_row<C>((halo ? f1 : f2) + (((size_t)bi * g.H + y) * g.W + x) * C, f);
        project_softmax<C, K>(f, ws, bs, p);
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) p[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < K; k += 4)
        *reinterpret_cast<float4*>(dst + k) = make_float4(p[k], p[k + 1], p[k + 2], p[k + 3]);
    }
    __syncthreads();
    if (!active) continue;
    for (int l = grp; l < kTile; l += groups) {
      const int hb = (l / kT) * g.hw + l % kT;    // halo index of pixel l at displacement 0, 0
      const float* q2 = p2t + l * K;
#pragma unroll
      for (int r = 0; r < kMaxPer; ++r) {
        if (!has[r]) continue;
        const float4 a = *reinterpret_cast<const float4*>(p1h + (hb + toff[r]) * K + iofs[r]);
        const float4 c = *reinterpret_cast<const float4*>(q2 + jofs[r]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[r][u * 4 + v] = fmaf(av[u], cv[v], acc[r][u * 4 + v]);
      }
    }
  }
  if (!active) return;
  const int nparts = gridDim.x * groups;
  float* out = part + ((size_t)s * nparts + (size_t)blockIdx.x * groups + grp) * g.td2 * K * K;
#pragma unroll
  for (int r = 0; r < kMaxPer; ++r) {
    if (!has[r]) continue;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        out[(tix[r] * K + iofs[r] + u) * K + jofs[r] + v] = acc[r][u * 4 + v];
  }
}

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

// dw[c][k] += sum_l f(l)[c] dz(l)[k], db[k] += sum_l dz(l)[k] over the tile's
// real pixels (dz rows [kTile][K] in shared memory, zero on pixels outside the
// image). One (channel, 4-cluster) item per thread, channel fastest, so a warp
// reads one pixel's channels in one transaction.
template <typename T, int C, int K>
__device__ void accumulate_dw(const T* __restrict__ f, const float* dzs, float* dw, float* db,
                              const Geo& g, int bi, int y0, int x0) {
  constexpr int NI = C * (K / 4);
  const int ny = min(kT, g.H - y0), nx = min(kT, g.W - x0);
  for (int it = threadIdx.x; it < NI + K; it += kThreads) {
    if (it < NI) {
      const int c = it % C, k = (it / C) * 4;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int ly = 0; ly < ny; ++ly) {
        const T* row = f + (((size_t)bi * g.H + y0 + ly) * g.W + x0) * C + c;
        const float* dzr = dzs + ly * kT * K + k;
#pragma unroll 4
        for (int lx = 0; lx < nx; ++lx) {
          const float fv = to_f32(row[(size_t)lx * C]);
          const float4 d = *reinterpret_cast<const float4*>(dzr + lx * K);
          a0 = fmaf(fv, d.x, a0);
          a1 = fmaf(fv, d.y, a1);
          a2 = fmaf(fv, d.z, a2);
          a3 = fmaf(fv, d.w, a3);
        }
      }
      dw[c * K + k] += a0;
      dw[c * K + k + 1] += a1;
      dw[c * K + k + 2] += a2;
      dw[c * K + k + 3] += a3;
    } else {
      const int k = it - NI;
      float a = 0.f;
      for (int l = 0; l < kTile; ++l) a += dzs[l * K + k];
      db[k] += a;
    }
  }
}

template <typename T, int C, int K>
__global__ void __launch_bounds__(kThreads, 1)
    iic_joints_bwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                          const float* __restrict__ w, const float* __restrict__ b,
                          const float* __restrict__ jbar, T* __restrict__ df1,
                          T* __restrict__ df2, float* __restrict__ part, Geo g) {
  static_assert(K % 4 == 0, "clusters come in groups of 4");
  constexpr int KH = K + 1;          // odd row stride: one pixel per thread, distinct banks
  extern __shared__ __align__(16) float smem[];
  const int S = g.S, SK = S * K, JN = g.td2 * K * K;
  float* ws = smem;                  // [S][C][K] weights of every subhead
  float* bs = ws + S * C * K;        // [S][K]
  float* dws = bs + SK;              // [S][C][K] this block's dW partial,
  float* dbs = dws + S * C * K;      // [S][K] then its db partial
  float* jb = dbs + SK;              // [td2][K][K] Jbar of the current subhead
  float* dzs = jb + JN;              // [kTile][K] dz of the current subhead and view
  float* p1h = dzs + kTile * K;      // [nh][KH] p1 on the halo tile, zero outside the image
  float* p2h = p1h + g.nh * KH;      // [nh][KH] p2 likewise
  const int tid = threadIdx.x;
  for (int i = tid; i < S * C * K; i += kThreads) {
    const int s = i / (C * K), r = i - s * C * K, c = r / K, k = r - c * K;
    ws[i] = w[(size_t)c * SK + s * K + k];
    dws[i] = 0.f;
  }
  for (int i = tid; i < SK; i += kThreads) {
    bs[i] = b[i];
    dbs[i] = 0.f;
  }
  const int ly = tid / kT, lx = tid % kT;
  const int own = (ly + g.pad) * g.hw + lx + g.pad;   // this thread's pixel in the halo maps

  for (int tile = blockIdx.x; tile < g.ntiles; tile += gridDim.x) {
    int bi, y0, x0;
    tile_origin(g, tile, bi, y0, x0);
    const bool real = y0 + ly < g.H && x0 + lx < g.W;
    const size_t pix = ((size_t)bi * g.H + y0 + ly) * g.W + x0 + lx;
    float d1[C], d2[C];
#pragma unroll
    for (int c = 0; c < C; ++c) d1[c] = d2[c] = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* wsub = ws + s * C * K;
      __syncthreads();                 // the last subhead's maps, Jbar and dz consumed
      for (int i = tid; i < JN; i += kThreads) jb[i] = jbar[(size_t)s * JN + i];
      for (int idx = tid; idx < 2 * g.nh; idx += kThreads) {
        const bool v2 = idx >= g.nh;
        const int hp = v2 ? idx - g.nh : idx;
        const int y = y0 - g.pad + hp / g.hw, x = x0 - g.pad + hp % g.hw;
        float* dst = (v2 ? p2h : p1h) + hp * KH;
        float p[K];
        if (y >= 0 && y < g.H && x >= 0 && x < g.W) {
          float f[C];
          load_row<C>((v2 ? f2 : f1) + (((size_t)bi * g.H + y) * g.W + x) * C, f);
          project_softmax<C, K>(f, wsub, bs + s * K, p);
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) p[k] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < K; ++k) dst[k] = p[k];
      }
      __syncthreads();

      // view 2: dp2(l)[j] = sum_t sum_i p1(l + off_t)[i] Jbar_t[i][j]
      float dz[K];
      if (real) {
        float dp[K];
#pragma unroll
        for (int k = 0; k < K; ++k) dp[k] = 0.f;
        for (int t = 0; t < g.td2; ++t) {
          const float* pr = p1h + ((ly + t / g.td) * g.hw + lx + t % g.td) * KH;
          const float* jt = jb + t * K * K;
#pragma unroll 4
          for (int i = 0; i < K; ++i) {
            const float pi = pr[i];
#pragma unroll
            for (int j = 0; j < K; j += 4) {
              const float4 j4 = *reinterpret_cast<const float4*>(jt + i * K + j);
              dp[j] = fmaf(pi, j4.x, dp[j]);
              dp[j + 1] = fmaf(pi, j4.y, dp[j + 1]);
              dp[j + 2] = fmaf(pi, j4.z, dp[j + 2]);
              dp[j + 3] = fmaf(pi, j4.w, dp[j + 3]);
            }
          }
        }
        softmax_vjp<K>(dp, p2h + own * KH, dz);
        accumulate_df<C, K>(wsub, dz, d2);
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) dz[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < K; k += 4)
        *reinterpret_cast<float4*>(dzs + tid * K + k) = make_float4(dz[k], dz[k + 1], dz[k + 2], dz[k + 3]);
      __syncthreads();
      accumulate_dw<T, C, K>(f2, dzs, dws + s * C * K, dbs + s * K, g, bi, y0, x0);

      // view 1: dp1(m)[i] = sum_t sum_j Jbar_t[i][j] p2(m - off_t)[j]
      if (real) {
        float dp[K];
#pragma unroll
        for (int k = 0; k < K; ++k) dp[k] = 0.f;
        for (int t = 0; t < g.td2; ++t) {
          const float* pr = p2h + ((ly + g.td - 1 - t / g.td) * g.hw + lx + g.td - 1 - t % g.td) * KH;
          const float* jt = jb + t * K * K;
          float pv[K];
#pragma unroll
          for (int j = 0; j < K; ++j) pv[j] = pr[j];
#pragma unroll
          for (int i = 0; i < K; ++i) {
            float a = dp[i];
#pragma unroll
            for (int j = 0; j < K; j += 4) {
              const float4 j4 = *reinterpret_cast<const float4*>(jt + i * K + j);
              a = fmaf(j4.x, pv[j], a);
              a = fmaf(j4.y, pv[j + 1], a);
              a = fmaf(j4.z, pv[j + 2], a);
              a = fmaf(j4.w, pv[j + 3], a);
            }
            dp[i] = a;
          }
        }
        softmax_vjp<K>(dp, p1h + own * KH, dz);
        accumulate_df<C, K>(wsub, dz, d1);
      }
      __syncthreads();                 // the view-2 dW pass has read dzs
#pragma unroll
      for (int k = 0; k < K; k += 4)
        *reinterpret_cast<float4*>(dzs + tid * K + k) = make_float4(dz[k], dz[k + 1], dz[k + 2], dz[k + 3]);
      __syncthreads();
      accumulate_dw<T, C, K>(f1, dzs, dws + s * C * K, dbs + s * K, g, bi, y0, x0);
    }
    if (real) {
      store_row<C>(df1 + pix * C, d1);
      store_row<C>(df2 + pix * C, d2);
    }
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * (S * C * K + SK);
  for (int i = tid; i < S * C * K + SK; i += kThreads) out[i] = dws[i];
}

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

size_t fwd_smem(int C, const Geo& g) {
  return sizeof(float) * ((size_t)C * kK + kK + (size_t)g.nh * kK + (size_t)kTile * kK);
}

size_t bwd_smem(int C, const Geo& g) {
  return sizeof(float) * (2 * (size_t)g.S * (C + 1) * kK + (size_t)g.td2 * kK * kK +
                          (size_t)kTile * kK + 2 * (size_t)g.nh * (kK + 1));
}

// E1: thread groups per block (pixels split among them when items are few).
int fwd_groups(const Geo& g) {
  const int nitems = g.td2 * (kK / 4) * (kK / 4);
  return nitems < kTile ? kTile / nitems : 1;
}

template <typename K>
int resident_blocks(K kern, size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kTile, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  return 0;
}

template <typename T, int C>
struct Impl {
  // blocks of the grid's x dimension and partials per subhead (E1) / in all (E2)
  static int plan(int mode, const Geo& g, int* nblk, int* nparts) {
    int blocks = 0, rc;
    if (mode == 0) {
      rc = resident_blocks(iic_joints_kernel<T, C, kK>, fwd_smem(C, g), &blocks);
      if (rc) return rc;
      *nblk = blocks / g.S > 1 ? blocks / g.S : 1;
      if (*nblk > g.ntiles) *nblk = g.ntiles;
      *nparts = *nblk * fwd_groups(g);
    } else {
      rc = resident_blocks(iic_joints_bwd_kernel<T, C, kK>, bwd_smem(C, g), &blocks);
      if (rc) return rc;
      *nblk = blocks < g.ntiles ? blocks : g.ntiles;
      *nparts = *nblk;
    }
    return 0;
  }

  static int fwd(const Args& a) {
    int nblk = 0, nparts = 0;
    int rc = plan(0, a.g, &nblk, &nparts);
    if (rc) return rc;
    iic_joints_kernel<T, C, kK><<<dim3(nblk, a.g.S), kTile, fwd_smem(C, a.g), a.stream>>>(
        static_cast<const T*>(a.f1), static_cast<const T*>(a.f2), static_cast<const float*>(a.w),
        static_cast<const float*>(a.b), static_cast<float*>(a.part), a.g);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n = a.g.td2 * kK * kK;
    sum_partials<<<dim3((n + kSumThreads - 1) / kSumThreads, a.g.S), kSumThreads, 0, a.stream>>>(
        static_cast<const float*>(a.part), static_cast<float*>(a.out), nparts, n);
    return (int)cudaGetLastError();
  }

  static int bwd(const Args& a) {
    int nblk = 0, nparts = 0;
    int rc = plan(1, a.g, &nblk, &nparts);
    if (rc) return rc;
    iic_joints_bwd_kernel<T, C, kK><<<nblk, kThreads, bwd_smem(C, a.g), a.stream>>>(
        static_cast<const T*>(a.f1), static_cast<const T*>(a.f2), static_cast<const float*>(a.w),
        static_cast<const float*>(a.b), static_cast<const float*>(a.jbar), static_cast<T*>(a.df1),
        static_cast<T*>(a.df2), static_cast<float*>(a.part), a.g);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n = a.g.S * (C + 1) * kK;
    sum_dw<<<(n + kSumThreads - 1) / kSumThreads, kSumThreads, 0, a.stream>>>(
        static_cast<const float*>(a.part), static_cast<float*>(a.dw), static_cast<float*>(a.db),
        nparts, C, a.g.S, kK);
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

// Partials the caller allocates: mode 0 (E1) [S, n, td^2, K, K] f32 with the
// returned n; mode 1 (E2) [n, S (C + 1) K] f32. Returns n, or minus a CUDA
// error code.
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
// (the features' dtype), dw [C, S*K] and db [S*K] f32; part: the mode-1 partials.
int iic_joints_bwd(const void* f1, const void* f2, const void* w, const void* b,
                   const void* jbar, void* df1, void* df2, void* part, void* dw, void* db,
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
  a.part = part;
  a.dw = dw;
  a.db = db;
  a.g = make_geo(B, H, W, S, pad);
  a.C = C;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(3, bf16, a, nullptr, nullptr);
}

}  // extern "C"
