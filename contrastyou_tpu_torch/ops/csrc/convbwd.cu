// Weight gradient (C1) and fused dx + weight gradient (C2) of the narrow
// U-Net levels' convolutions (NHWC bf16 operands, f32 accumulation).
//
//   C1 conv_dw_taps       replaces contrastyou_tpu/ops/pallas/convblock.py
//                         _dw_plane_kernel (plane_conv_dw): dk[t,i,o] =
//                         sum_{b,h,w} x[b,h+dy_t,w+dx_t,i] * g[b,h,w,o], zero
//                         outside the image, over a static tap set: the 9 taps
//                         of a SAME 3x3 conv, or the 16 parity taps of Up2 (4
//                         output parities (a,b) x 4 taps, g read on the
//                         parity's sub-grid g[:, a::2, b::2] at the offsets of
//                         ops/convblock.py _parity_offsets).
//   C2 conv3x3_bwd_fused  replaces _fused_bwd_kernel (plane_conv_bwd_fused):
//                         dx of a SAME 3x3 conv (one bf16 rounding of f32
//                         sums) and its dk [3,3,Cin,Cout] in HWIO tap order,
//                         both from one load of the cotangent tile.
//
// Both run in the q-form: with q = p + off_t,
//   dk[t,i,o] = sum_q x[q,i] * g[q - off_t, o]
//   dx[q,i]   = sum_t sum_o g[q - off_t, o] * w[t,i,o]
// so a block loads an 8x16-pixel tile of x (16 input channels: its channel
// slice) and the cotangent tile with a one-pixel halo into shared memory once;
// every tap is a shifted view of that cotangent tile, read by both products
// (the point of the fused form). The TPU kernel builds the same shifted
// patches with lane rolls; its per-batch dk partials (convblock.py:736-737)
// become per-block partials here.
//
// What bounds it on the H100: dk costs 2*B*H*W*T*Cin*Cout FLOP (C2 twice
// that) against reading x and g once. At the main-path widths (Cin, Cout in
// 32..64) that is 100-300 FLOP per byte, near the bf16 ridge (~295), so both
// limits matter. The products run on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 accumulate) fed by ldmatrix from shared memory (.trans for dk,
// whose reduction runs over pixels while NHWC keeps channels contiguous);
// pixel rows are padded by 16 bytes so ldmatrix rows hit distinct banks. The
// blocks are persistent: each walks a fixed strided set of tiles and keeps its
// dk accumulators in registers across them, writes one f32 partial, and a
// second kernel sums the partials in a fixed order: no atomics, and the
// result is the same on every run. wgmma, TMA and double buffering are later
// work.
//
// Every entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not
// take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using tc::ldsm_x2_trans;
using tc::ldsm_x4;
using tc::ldsm_x4_trans;
using tc::mma_bf16;
using tc::smem_addr;

constexpr int kTH = 8;                   // tile rows
constexpr int kTW = 16;                  // tile cols: one mma K step (dk) / M tile (dx)
constexpr int kTile = kTH * kTW;
constexpr int kHW = kTW + 2;             // halo tile cols
constexpr int kHalo = (kTH + 2) * kHW;   // halo tile pixels
constexpr int kCS = 16;                  // input channels of one block (its slice)
constexpr int kXS = kCS + 8;             // padded pixel stride of the x tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Mode { kDw3x3 = 0, kDwUp2 = 1, kFused = 2 };

struct Params {
  const __nv_bfloat16* x;  // [B,H,W,cin]
  const __nv_bfloat16* g;  // [B,H,W,COUT] (3x3, fused) or [B,2H,2W,COUT] (Up2)
  const __nv_bfloat16* w;  // [9,cin,COUT] (fused)
  __nv_bfloat16* dx;       // [B,H,W,cin] (fused)
  float* part;             // [nb, T, cin, COUT] per-block partials
  int B, H, W, cin;        // H, W: the x grid (Up2: input resolution)
  int nb, nslice;          // blocks per channel slice, channel slices
};

// Tap t -> (dy, dx). 3x3: HWIO order, t = 3*ky + kx at offset (ky-1, kx-1).
// Up2: t = 4*parity + tap, parity (a, b) = divmod(parity, 2), tap (r, c) =
// divmod(tap, 2), offset (r + a - 1, c + b - 1).
template <int MODE>
__device__ __forceinline__ void tap_offset(int t, int& dy, int& dx) {
  if (MODE == kDwUp2) {
    const int par = t >> 2, tt = t & 3;
    dy = (tt >> 1) + (par >> 1) - 1;
    dx = (tt & 1) + (par & 1) - 1;
  } else {
    dy = t / 3 - 1;
    dx = t % 3 - 1;
  }
}

template <int COUT, int MODE>
constexpr size_t smem_bytes() {
  return 2 * ((size_t)kHalo * (COUT + 8) + (size_t)kTile * kXS +
              (MODE == kFused ? (size_t)9 * kCS * (COUT + 8) : 0));
}

template <int COUT, int MODE>
__global__ void __launch_bounds__(kThreads) convbwd_kernel(const Params p) {
  constexpr int T = (MODE == kDwUp2) ? 16 : 9;
  constexpr int NT = COUT / 8;                  // n8 tiles of dk's output channels
  constexpr int NF = T * NT;                    // dk fragments [16 x 8] of a block
  constexpr int NJ = (NF + kWarps - 1) / kWarps;
  constexpr int GS = COUT + 8;                  // padded pixel stride of the g tile
  constexpr int G8 = COUT / 8;                  // 16-byte groups per g pixel

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sG = reinterpret_cast<__nv_bfloat16*>(smem);   // [kHalo][GS]
  __nv_bfloat16* sX = sG + kHalo * GS;                           // [kTile][kXS]
  __nv_bfloat16* sW = sX + kTile * kXS;                          // [9][kCS][GS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;      // mma fragment row / column pair
  const int lj = lane >> 3, lr = lane & 7;      // ldmatrix matrix / row of this lane
  const int slice = blockIdx.x % p.nslice;
  const int blk = blockIdx.x / p.nslice;
  const int c0 = slice * kCS;
  const int H = p.H, W = p.W, cin = p.cin;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int tiles_img = ((H + kTH - 1) / kTH) * tiles_x;
  const int ntiles = p.B * tiles_img;
  const int sub = (MODE == kDwUp2) ? 2 : 1;     // Up2: g holds the 4 parity sub-grids
  const int Hg = H * sub, Wg = W * sub;

  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (MODE == kFused) {
    // this slice's weights, [t][i][o], once per block
    for (int e = tid; e < 9 * kCS * G8; e += kThreads) {
      const int o8 = e % G8, i = (e / G8) % kCS, t = e / (G8 * kCS);
      *reinterpret_cast<uint4*>(sW + (t * kCS + i) * GS + o8 * 8) =
          *reinterpret_cast<const uint4*>(p.w + ((size_t)t * cin + c0 + i) * COUT + o8 * 8);
    }
  }

  for (int tile = blk; tile < ntiles; tile += p.nb) {
    const int b = tile / tiles_img;
    const int ty0 = ((tile % tiles_img) / tiles_x) * kTH;
    const int tx0 = ((tile % tiles_img) % tiles_x) * kTW;

#pragma unroll 1
    for (int par = 0; par < (MODE == kDwUp2 ? 4 : 1); ++par) {
      __syncthreads();  // the previous tile's (parity's) reads are done
      if (par == 0) {
        // x tile: 128 pixels x this slice's 16 channels, zero outside
        for (int e = tid; e < kTile * 2; e += kThreads) {
          const int pix = e >> 1, ch = c0 + (e & 1) * 8;
          const int y = ty0 + pix / kTW, x = tx0 + pix % kTW;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (y < H && x < W) {
            const __nv_bfloat16* src = p.x + (((size_t)b * H + y) * W + x) * cin + ch;
            if ((cin & 7) == 0 && ch + 8 <= cin) {
              v = *reinterpret_cast<const uint4*>(src);
            } else {
              __nv_bfloat16* e8 = reinterpret_cast<__nv_bfloat16*>(&v);
              for (int j = 0; j < 8 && ch + j < cin; ++j) e8[j] = src[j];
            }
          }
          *reinterpret_cast<uint4*>(sX + pix * kXS + (e & 1) * 8) = v;
        }
      }
      // cotangent tile with a one-pixel halo (Up2: on parity par's sub-grid)
      const int pa = par >> 1, pb = par & 1;
      for (int e = tid; e < kHalo * G8; e += kThreads) {
        const int hp = e / G8, o8 = e % G8;
        const int y = ty0 - 1 + hp / kHW, x = tx0 - 1 + hp % kHW;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (y >= 0 && y < H && x >= 0 && x < W) {
          const size_t gy = (size_t)y * sub + pa, gx = (size_t)x * sub + pb;
          v = *reinterpret_cast<const uint4*>(p.g + (((size_t)b * Hg + gy) * Wg + gx) * COUT +
                                              o8 * 8);
        }
        *reinterpret_cast<uint4*>(sG + hp * GS + o8 * 8) = v;
      }
      __syncthreads();

      if (MODE == kFused) {
        // dx: warp w computes tile row w (16 pixels) x the slice's 16 channels;
        // A = shifted g [pixel][o] (row-major), B = w[t] stored [i][o]
        float dacc[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dacc[n][e] = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int dy = t / 3 - 1, dx = t % 3 - 1;
          const int col = lr + 8 * (lj & 1);
          const __nv_bfloat16* arow = sG + ((warp + 1 - dy) * kHW + col + 1 - dx) * GS + 8 * (lj >> 1);
          const __nv_bfloat16* brow = sW + (t * kCS + lr + 8 * (lj >> 1)) * GS + 8 * (lj & 1);
#pragma unroll
          for (int ok = 0; ok < COUT / 16; ++ok) {
            unsigned a[4], bf[4];
            ldsm_x4(smem_addr(arow + ok * 16), a);
            ldsm_x4(smem_addr(brow + ok * 16), bf);
            mma_bf16(dacc[0], a, bf[0], bf[1]);
            mma_bf16(dacc[1], a, bf[2], bf[3]);
          }
        }
        const int y = ty0 + warp;
        if (y < H) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int x = tx0 + gq + 8 * h;
              if (x < W) {
                *reinterpret_cast<__nv_bfloat162*>(
                    p.dx + (((size_t)b * H + y) * W + x) * cin + c0 + n * 8 + 2 * tq) =
                    __floats2bfloat162_rn(dacc[n][2 * h], dacc[n][2 * h + 1]);
              }
            }
          }
        }
      }

      // dk: per tile row (16 pixels = one K step), A = x^T [i][pixel] and
      // B = shifted g [pixel][o], both through ldmatrix.trans
#pragma unroll 1
      for (int ks = 0; ks < kTH; ++ks) {
        unsigned a[4];
        ldsm_x4_trans(smem_addr(sX + (ks * kTW + lr + 8 * (lj >> 1)) * kXS + 8 * (lj & 1)), a);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int f = warp + kWarps * j;
          if (f >= NF) continue;
          const int t = f / NT, n = f % NT;
          if (MODE == kDwUp2 && (t >> 2) != par) continue;
          int dy, dx;
          tap_offset<MODE>(t, dy, dx);
          const int col = lane & 15;
          unsigned bf[2];
          ldsm_x2_trans(smem_addr(sG + ((ks + 1 - dy) * kHW + col + 1 - dx) * GS + n * 8), bf);
          mma_bf16(acc[j], a, bf[0], bf[1]);
        }
      }
    }
  }

  // this block's partial: acc[j] is dk[t][c0 + m][n*8 + k] for the fragment
  // rows m in {gq, gq + 8} and columns k in {2tq, 2tq + 1}
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int f = warp + kWarps * j;
    if (f >= NF) continue;
    const int t = f / NT, n = f % NT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = c0 + gq + 8 * h;
      if (i < cin) {
        float2* dst = reinterpret_cast<float2*>(
            p.part + (((size_t)blk * T + t) * cin + i) * COUT + n * 8 + 2 * tq);
        *dst = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
  }
}

// dk[e] = sum_k part[k][e] in a fixed order: a block takes 32 consecutive
// outputs, warp w sums the partials k = w, w + 8, ... (coalesced rows), then
// the 8 warp sums are added in warp order.
constexpr int kSumWarps = 8;

__global__ void __launch_bounds__(32 * kSumWarps)
    sum_partials(const float* __restrict__ part, float* __restrict__ out, int nb, int n) {
  __shared__ float s_red[kSumWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (e < n) {
#pragma unroll 4
    for (int k = w; k < nb; k += kSumWarps) s += part[(size_t)k * n + e];
  }
  s_red[w][lane] = s;
  __syncthreads();
  if (w == 0 && e < n) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kSumWarps; ++i) t += s_red[i][lane];
    out[e] = t;
  }
}

template <int COUT, int MODE>
int plan_t(int cin, int ntiles, int* nb) {
  auto kern = convbwd_kernel<COUT, MODE>;
  constexpr size_t smem = smem_bytes<COUT, MODE>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem)) !=
      cudaSuccess)
    return (int)err;
  const int nslice = (cin + kCS - 1) / kCS;
  int n = sms * (per_sm > 0 ? per_sm : 1) / nslice;
  if (n < 1) n = 1;
  *nb = n < ntiles ? n : ntiles;
  return 0;
}

int plan(int mode, int cout, int cin, int ntiles, int* nb) {
  if (cout == 32) {
    if (mode == kDw3x3) return plan_t<32, kDw3x3>(cin, ntiles, nb);
    if (mode == kDwUp2) return plan_t<32, kDwUp2>(cin, ntiles, nb);
    return plan_t<32, kFused>(cin, ntiles, nb);
  }
  if (mode == kDw3x3) return plan_t<64, kDw3x3>(cin, ntiles, nb);
  if (mode == kDwUp2) return plan_t<64, kDwUp2>(cin, ntiles, nb);
  return plan_t<64, kFused>(cin, ntiles, nb);
}

bool valid(int mode, int B, int H, int W, int cin, int cout) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0) return false;
  if (cout != 32 && cout != 64) return false;
  return mode != kFused || cin % kCS == 0;
}

int num_tiles(int B, int H, int W) {
  return B * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
}

template <int COUT, int MODE>
void launch_t(const Params& p, cudaStream_t st) {
  convbwd_kernel<COUT, MODE>
      <<<p.nb * p.nslice, kThreads, smem_bytes<COUT, MODE>(), st>>>(p);
}

int run(int mode, Params p, int cout, float* dk, void* stream) {
  if (!valid(mode, p.B, p.H, p.W, p.cin, cout)) return (int)cudaErrorInvalidValue;
  int nb = 0;
  const int rc = plan(mode, cout, p.cin, num_tiles(p.B, p.H, p.W), &nb);
  if (rc != 0) return rc;
  p.nb = nb;
  p.nslice = (p.cin + kCS - 1) / kCS;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (cout == 32) {
    if (mode == kDw3x3) launch_t<32, kDw3x3>(p, st);
    else if (mode == kDwUp2) launch_t<32, kDwUp2>(p, st);
    else launch_t<32, kFused>(p, st);
  } else {
    if (mode == kDw3x3) launch_t<64, kDw3x3>(p, st);
    else if (mode == kDwUp2) launch_t<64, kDwUp2>(p, st);
    else launch_t<64, kFused>(p, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = (mode == kDwUp2 ? 16 : 9) * p.cin * cout;
  sum_partials<<<(n + 31) / 32, 32 * kSumWarps, 0, st>>>(p.part, dk, nb, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* convbwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Blocks per channel slice, i.e. the leading dimension of the partials
// buffer [nb, T, cin, cout] the caller passes (mode 0: C1 3x3, 1: C1 Up2,
// 2: C2). Returns nb, or minus a CUDA error code.
int convbwd_num_partials(int mode, int B, int H, int W, int cin, int cout) {
  if (!valid(mode, B, H, W, cin, cout)) return -(int)cudaErrorInvalidValue;
  int nb = 0;
  const int rc = plan(mode, cout, cin, num_tiles(B, H, W), &nb);
  return rc != 0 ? -rc : nb;
}

// C1. x [B,H,W,cin]; g [B,H,W,cout] (up2 = 0) or [B,2H,2W,cout] (up2 = 1);
// part [nb,T,cin,cout] f32 scratch; dk [T,cin,cout] f32 with T = 9 or 16.
int conv_dw_taps(const void* x, const void* g, int up2, void* part, void* dk, int B, int H,
                 int W, int cin, int cout, void* stream) {
  Params p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.part = static_cast<float*>(part);
  p.B = B;
  p.H = H;
  p.W = W;
  p.cin = cin;
  return run(up2 ? kDwUp2 : kDw3x3, p, cout, static_cast<float*>(dk), stream);
}

// C2. x [B,H,W,cin], w [3,3,cin,cout] (HWIO), g [B,H,W,cout]; dx [B,H,W,cin];
// part [nb,9,cin,cout] f32 scratch; dk [3,3,cin,cout] f32.
int conv3x3_bwd_fused(const void* x, const void* w, const void* g, void* dx, void* part,
                      void* dk, int B, int H, int W, int cin, int cout, void* stream) {
  Params p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.dx = static_cast<__nv_bfloat16*>(dx);
  p.part = static_cast<float*>(part);
  p.B = B;
  p.H = H;
  p.W = W;
  p.cin = cin;
  return run(kFused, p, cout, static_cast<float*>(dk), stream);
}

}  // extern "C"
