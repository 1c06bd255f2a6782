// Tap-set convolutions for the wide U-Net levels (NHWC bf16, f32 accumulate).
//
// Three entry points, one templated kernel body:
//
//   K1 conv3x3_stats   replaces contrastyou_tpu/ops/pallas/convblock.py
//                      _conv_plane_kernel, _conv_plane_kernel_dyg and the dense
//                      3x3 use of _conv_plane_kernel_multi: a SAME 3x3
//                      correlation with zero padding, an optional second input
//                      (the decoder skip, with its own weight slice, so the
//                      channel concat is never built) and per-(sample, tile)
//                      sum / sum-of-squares partials of the bf16-rounded output
//                      for the next BatchNorm. On spatially flipped,
//                      channel-swapped weights and without stats it is the dx
//                      pass of its own backward.
//   K2 upconv3x3_stats replaces the Up2 role of _conv_plane_kernel /
//                      _conv_plane_kernel_multi (upconv_plane,
//                      upconv_plane_parity): conv3x3_SAME(upsample2x_nearest(x))
//                      as four 2x2-tap convs at input resolution, one per output
//                      parity (taps folded in torch, convblock.py _parity_taps),
//                      writing the interleaved NHWC output directly.
//   K3 upconv3x3_dx    K2's adjoint (convblock.py _pcts_bwd): every input pixel
//                      gathers the four parity planes of the cotangent at the
//                      negated tap offsets.
//
// What bounds it on the H100: at the main-path widths (Cin, Cout <= 64) each
// output pixel costs 9*Cin*Cout MACs against (Cin + Cout) * 2 bytes of
// traffic, so the layers are compute bound on paper; this first version does
// its MACs on the FP32 cores (no tensor cores), so it is bound by FP32 FMA
// issue and shared-memory reads. The design keeps what the TPU kernel kept out
// of device memory out of it too: the im2col patches live only in shared
// memory (an 8x16 output tile plus a one-pixel halo, 8 input channels at a
// time), the upsampled Up2 input is never built, the skip concat is never
// built, and the BN statistics are reduced in-block from the rounded output
// (deterministic: warp shuffles and a fixed-order sum, no atomics). Tensor
// cores (mma.sync / wgmma) and TMA staging are later work.
//
// Every entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 8;                 // output tile rows
constexpr int kTW = 16;                // output tile cols
constexpr int kTile = kTH * kTW;       // pixels per block
constexpr int kHaloH = kTH + 2;
constexpr int kHaloW = kTW + 2;
constexpr int kCK = 8;                 // input channels per shared-memory chunk
constexpr int kThreads = 256;

// Tap kinds: 0 = dense 3x3 (9 taps), 1 = upconv forward (4 taps of one output
// parity), 2 = upconv adjoint (4 taps of one cotangent parity, negated).
template <int KIND>
__device__ __forceinline__ void tap_offset(int t, int par, int& dy, int& dx) {
  if (KIND == 0) {
    dy = t / 3 - 1;
    dx = t % 3 - 1;
  } else {
    // parity 0 reads rows {-1, 0}, parity 1 rows {0, +1}
    dy = (t >> 1) + (par >> 1) - 1;
    dx = (t & 1) + (par & 1) - 1;
    if (KIND == 2) {
      dy = -dy;
      dx = -dx;
    }
  }
}

struct Params {
  const __nv_bfloat16* src[2];  // NHWC inputs (K1: x and optional skip)
  const __nv_bfloat16* w[2];    // [taps, C, COUT] per input (K2/K3: per parity, 4 blocks)
  int C[2];                     // channels of each input
  int nsrc;                     // inputs of K1 (1 or 2); 1 otherwise
  __nv_bfloat16* out;           // NHWC output
  float* part;                  // [B, nblk, 2, COUT] stat partials, or null
  int B, H, W;                  // tile-grid resolution (K2/K3: input resolution)
};

template <int COUT, int KIND>
__global__ void __launch_bounds__(kThreads) tapconv_kernel(const Params p) {
  constexpr int NT = (KIND == 0) ? 9 : 4;
  constexpr int NCG = COUT / 8;            // groups of 8 output channels
  constexpr int PG = kThreads / NCG;       // threads sharing one group
  constexpr int PX = kTile / PG;           // pixels per thread
  static_assert(PG % 32 == 0, "a warp must stay inside one channel group");
  static_assert(PX * PG == kTile, "tile must split evenly");

  __shared__ __align__(16) float s_in[kCK][kHaloH][kHaloW];
  __shared__ __align__(16) float s_w[NT][kCK][COUT];
  __shared__ float s_red[kThreads / 32][2][8];

  const int tid = threadIdx.x;
  const int cg = tid / PG;
  const int pg = tid % PG;
  const int H = p.H, W = p.W;
  const int ntx = (W + kTW - 1) / kTW;
  const int ty0 = (blockIdx.x / ntx) * kTH;
  const int tx0 = (blockIdx.x % ntx) * kTW;
  const int nvar = (KIND == 1) ? 4 : 1;    // K2: one block per output parity
  const int b = blockIdx.y / nvar;
  const int var = blockIdx.y % nvar;
  const int sstr = (KIND == 2) ? 2 : 1;    // K3 reads the full-resolution cotangent
  const int Hs = H * sstr, Ws = W * sstr;

  float acc[PX][8];
#pragma unroll
  for (int k = 0; k < PX; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;

  const int npass = (KIND == 2) ? 4 : ((KIND == 1) ? 1 : p.nsrc);
  for (int pass = 0; pass < npass; ++pass) {
    const int s = (KIND == 0) ? pass : 0;
    const int par = (KIND == 1) ? var : pass;
    const __nv_bfloat16* src = p.src[s];
    const int C = p.C[s];
    const __nv_bfloat16* w =
        p.w[s] + (KIND == 0 ? (size_t)0 : (size_t)par * NT * C * COUT);
    const int sa = (KIND == 2) ? (par >> 1) : 0;
    const int sb = (KIND == 2) ? (par & 1) : 0;

    for (int c0 = 0; c0 < C; c0 += kCK) {
      __syncthreads();  // the previous chunk's reads are done
      for (int i = tid; i < kHaloH * kHaloW; i += kThreads) {
        const int r = i / kHaloW, c = i % kHaloW;
        const int y = ty0 - 1 + r, x = tx0 - 1 + c;
        float v[kCK];
#pragma unroll
        for (int j = 0; j < kCK; ++j) v[j] = 0.f;
        if (y >= 0 && y < H && x >= 0 && x < W) {
          const __nv_bfloat16* px =
              src + (((size_t)b * Hs + (size_t)y * sstr + sa) * Ws +
                     (size_t)x * sstr + sb) * C + c0;
          if ((C & 7) == 0) {
            // 8 channels = one aligned 16-byte load
            const uint4 u = *reinterpret_cast<const uint4*>(px);
            const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
            for (int j = 0; j < kCK; ++j) v[j] = __bfloat162float(e[j]);
          } else {
#pragma unroll
            for (int j = 0; j < kCK; ++j)
              if (c0 + j < C) v[j] = __bfloat162float(px[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kCK; ++j) s_in[j][r][c] = v[j];
      }
      for (int i = tid; i < NT * kCK * COUT; i += kThreads) {
        const int co = i % COUT;
        const int ci = (i / COUT) % kCK;
        const int t = i / (COUT * kCK);
        s_w[t][ci][co] =
            (c0 + ci < C)
                ? __bfloat162float(w[((size_t)t * C + c0 + ci) * COUT + co])
                : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int t = 0; t < NT; ++t) {
        int dy, dx;
        tap_offset<KIND>(t, par, dy, dx);
#pragma unroll
        for (int ci = 0; ci < kCK; ++ci) {
          const float4 w0 = *reinterpret_cast<const float4*>(&s_w[t][ci][cg * 8]);
          const float4 w1 = *reinterpret_cast<const float4*>(&s_w[t][ci][cg * 8 + 4]);
#pragma unroll
          for (int k = 0; k < PX; ++k) {
            const int pix = pg + k * PG;
            const float xv = s_in[ci][pix / kTW + 1 + dy][pix % kTW + 1 + dx];
            acc[k][0] = fmaf(xv, w0.x, acc[k][0]);
            acc[k][1] = fmaf(xv, w0.y, acc[k][1]);
            acc[k][2] = fmaf(xv, w0.z, acc[k][2]);
            acc[k][3] = fmaf(xv, w0.w, acc[k][3]);
            acc[k][4] = fmaf(xv, w1.x, acc[k][4]);
            acc[k][5] = fmaf(xv, w1.y, acc[k][5]);
            acc[k][6] = fmaf(xv, w1.z, acc[k][6]);
            acc[k][7] = fmaf(xv, w1.w, acc[k][7]);
          }
        }
      }
    }
  }

  // epilogue: round to bf16, store 8 channels as one 16-byte write, and
  // accumulate the statistics of the ROUNDED values (what the next BN sees)
  const int Ho = (KIND == 1) ? 2 * H : H;
  const int Wo = (KIND == 1) ? 2 * W : W;
  float ssum[8], ssq[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) ssum[j] = ssq[j] = 0.f;
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int pix = pg + k * PG;
    const int y = ty0 + pix / kTW, x = tx0 + pix % kTW;
    if (y < H && x < W) {
      __align__(16) __nv_bfloat16 o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j] = __float2bfloat16(acc[k][j]);
        const float r = __bfloat162float(o[j]);
        ssum[j] += r;
        ssq[j] += r * r;
      }
      const size_t oy = (KIND == 1) ? (size_t)2 * y + (var >> 1) : (size_t)y;
      const size_t ox = (KIND == 1) ? (size_t)2 * x + (var & 1) : (size_t)x;
      *reinterpret_cast<uint4*>(p.out + (((size_t)b * Ho + oy) * Wo + ox) * COUT +
                                cg * 8) = *reinterpret_cast<const uint4*>(o);
    }
  }
  if (p.part == nullptr) return;  // uniform across the block

#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ssum[j] += __shfl_xor_sync(0xffffffffu, ssum[j], off);
      ssq[j] += __shfl_xor_sync(0xffffffffu, ssq[j], off);
    }
  }
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s_red[warp][0][j] = ssum[j];
      s_red[warp][1][j] = ssq[j];
    }
  }
  __syncthreads();
  if (tid < COUT) {
    constexpr int WPG = PG / 32;            // warps per channel group
    const int g = tid / 8, j = tid % 8;
    float a = 0.f, q = 0.f;
    for (int wi = 0; wi < WPG; ++wi) {
      a += s_red[g * WPG + wi][0][j];
      q += s_red[g * WPG + wi][1][j];
    }
    const int nblk = gridDim.x * nvar;
    const int blk = var * gridDim.x + blockIdx.x;
    float* dst = p.part + ((size_t)b * nblk + blk) * 2 * COUT;
    dst[tid] = a;
    dst[COUT + tid] = q;
  }
}

template <int KIND>
int launch(const Params& p, int cout, void* stream) {
  const int tiles = ((p.H + kTH - 1) / kTH) * ((p.W + kTW - 1) / kTW);
  const int gy = p.B * ((KIND == 1) ? 4 : 1);
  if (p.B <= 0 || p.H <= 0 || p.W <= 0 || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles, gy);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (cout == 32) {
    tapconv_kernel<32, KIND><<<grid, kThreads, 0, st>>>(p);
  } else if (cout == 64) {
    tapconv_kernel<64, KIND><<<grid, kThreads, 0, st>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Stat-partial blocks per sample of K1 (K2 has four times as many).
int tapconv_num_tiles(int H, int W) {
  return ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
}

const char* tapconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1. x [B,H,W,cin], w [9,cin,cout]; skip [B,H,W,cs] with ws [9,cs,cout] or
// null; out [B,H,W,cout]; part [B,tiles,2,cout] or null.
int conv3x3_stats(const void* x, int cin, const void* w, const void* skip,
                  int cs, const void* ws, void* out, void* part, int B, int H,
                  int W, int cout, void* stream) {
  Params p{};
  p.src[0] = static_cast<const __nv_bfloat16*>(x);
  p.w[0] = static_cast<const __nv_bfloat16*>(w);
  p.C[0] = cin;
  p.nsrc = 1;
  if (skip != nullptr) {
    p.src[1] = static_cast<const __nv_bfloat16*>(skip);
    p.w[1] = static_cast<const __nv_bfloat16*>(ws);
    p.C[1] = cs;
    p.nsrc = 2;
  }
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part = static_cast<float*>(part);
  p.B = B;
  p.H = H;
  p.W = W;
  return launch<0>(p, cout, stream);
}

// K2. x [B,H,W,cin], taps [4 parities,4 taps,cin,cout]; out [B,2H,2W,cout];
// part [B,4*tiles,2,cout] or null.
int upconv3x3_stats(const void* x, const void* taps, void* out, void* part,
                    int B, int H, int W, int cin, int cout, void* stream) {
  Params p{};
  p.src[0] = static_cast<const __nv_bfloat16*>(x);
  p.w[0] = static_cast<const __nv_bfloat16*>(taps);
  p.C[0] = cin;
  p.nsrc = 1;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part = static_cast<float*>(part);
  p.B = B;
  p.H = H;
  p.W = W;
  return launch<1>(p, cout, stream);
}

// K3. g [B,2H,2W,cg], taps_t [4 parities,4 taps,cg,cin] (K2's taps with the
// channel axes swapped); dx [B,H,W,cin].
int upconv3x3_dx(const void* g, const void* taps_t, void* dx, int B, int H,
                 int W, int cg, int cin, void* stream) {
  Params p{};
  p.src[0] = static_cast<const __nv_bfloat16*>(g);
  p.w[0] = static_cast<const __nv_bfloat16*>(taps_t);
  p.C[0] = cg;
  p.nsrc = 1;
  p.out = static_cast<__nv_bfloat16*>(dx);
  p.part = nullptr;
  p.B = B;
  p.H = H;
  p.W = W;
  return launch<2>(p, cin, stream);
}

}  // extern "C"
