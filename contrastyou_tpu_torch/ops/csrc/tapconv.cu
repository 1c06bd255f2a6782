// Tap-set convolutions for the narrow U-Net levels (NHWC bf16, f32 accumulate).
//
//   K1 conv3x3_stats   replaces contrastyou_tpu/ops/pallas/convblock.py
//                      _conv_plane_kernel (:298), _conv_plane_kernel_dyg (:230)
//                      and the dense 3x3 use of _conv_plane_kernel_multi (:341):
//                      a SAME 3x3 correlation with zero padding, an optional
//                      second input (the decoder skip, with its own weight
//                      slice, so the channel concat is never built) and
//                      per-(sample, tile) sum / sum-of-squares partials of the
//                      bf16-rounded output for the next BatchNorm. On spatially
//                      flipped, channel-swapped weights and without stats it is
//                      the dx pass of its own backward.
//   K2 upconv3x3_stats replaces the Up2 role of _conv_plane_kernel /
//                      _conv_plane_kernel_multi (upconv_plane,
//                      upconv_plane_parity): conv3x3_SAME(upsample2x_nearest(x))
//                      as four 2x2-tap convs at input resolution, one per output
//                      parity (taps folded in torch, convblock.py parity_taps),
//                      writing the interleaved 2x output directly.
//   K3 upconv3x3_dx    K2's adjoint (convblock.py _UpconvStats.backward): every
//                      input pixel gathers the four parity planes of the
//                      cotangent at the negated tap offsets.
//
// What bounds K1 and K2 on the H100: each output pixel costs 9*Cin*Cout MACs
// (K2: 4*Cin*Cout) against (Cin + Cout) * 2 bytes, 144-288 FLOP per byte at
// Cin, Cout in 32..64: below the bf16 tensor ridge (~295), so the bytes bound
// them and the MACs have to hide under the copies. The design:
//
// - Implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//   accumulate; helpers in mma.cuh). M is the pixels of an output tile, N all
//   of Cout in one tile (so each input tile is read once), K taps x Cin. A
//   group of warps computes an 8192-output tile (K1: 16x16 pixels x 32
//   channels or 8x16 x 64; K2: a 4x16 input tile x 4 parities x 32 channels):
//   K1 4 warps of 64 pixels x 32 channels (4 x 4 fragments), K2 8 warps of
//   32 x 32. mma.sync, not wgmma: at N = 32/64 the mma.sync rate is within a
//   small factor of the bytes' time, and every tap stays a plain shifted
//   ldmatrix view of one halo tile (wgmma would want its A and B operands in
//   descriptor layouts, a separate descriptor and swizzled copy per tap).
// - Operand A comes from a halo tile of the input held in shared memory as
//   bf16, its pixel stride padded by 16 bytes so the eight rows of every
//   ldmatrix hit distinct banks; each tap is a shifted view of that tile, so
//   no im2col exists anywhere. Operand B is the weights, [tap][Cin][Cout+8]
//   in shared memory, read with ldmatrix.trans.
// - The grid is persistent (one block per SM): each block stages the whole
//   kernel once (K1 with a skip: both slices, 162 KB at 64+64 -> 64) and
//   holds one to three groups, as many as fit beside it; each group walks
//   (sample, tile) items in a fixed stride with its own ring, so one group's
//   epilogue overlaps another's MMAs and no weight is read twice by a block.
// - cp.async 16-byte copies into a two-stage ring: the next (tile, input)
//   halo arrives while this one's MMAs run; the halo outside the image is
//   zero-filled by the copy (src-size 0), not by the pixels' code.
// - Epilogue: the accumulators are rounded to bf16 and staged in the ring
//   slot just read, then leave as 16-byte coalesced row writes (K2: whole
//   contiguous rows of the interleaved 2x output). The BN sums of the rounded
//   values reduce over the fragment rows with shuffles (lane xor 4, 8, 16),
//   across warps in shared memory in a fixed order, into one f32 partial per
//   (sample, tile); no atomics, so two launches give the same bits.
// - Cin = 1 (Conv1.conv0) has its own kernel: 9 MACs per output channel
//   against 2 bytes in and 2*Cout out per pixel is a bytes-bound FP32 loop,
//   with the same tiles, partials and staged 16-byte stores.
//
// K3 keeps the first version's FP32 body: an 8x16 output tile plus a one-pixel
// halo in shared memory 8 input channels at a time, FMAs on the FP32 cores; it
// is the next kernel to redesign.
//
// Every entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not
// take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;          // threads of the Cin = 1 and K3 blocks
constexpr int kTW = 16;                // tile cols (input grid): one m16 fragment
constexpr int kHW = kTW + 2;           // halo tile cols

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// K1 (Cin >= 32) and K2: implicit GEMM on the tensor cores
// ---------------------------------------------------------------------------

// A group of WG = 16 / MF warps computes one tile; each warp MF rows of 16
// pixels (m16 fragments) x 32 output channels. MF = 2 and 4 give the same
// tile, so the partials do not depend on it.
template <int COUT, int CIN, bool UP, int MF = 2>
struct Cfg {
  static constexpr int WG = 16 / MF;                    // warps of a group
  static constexpr int GT = 32 * WG;                    // threads of a group
  static constexpr int NWN = COUT / 32;                 // warps along Cout
  static constexpr int NPAR = UP ? 4 : 1;               // output parities of a tile
  static constexpr int NWM = WG / (NWN * NPAR);         // warps along pixel rows
  static constexpr int TH = MF * NWM;                   // tile rows (input grid)
  static constexpr int NT = UP ? 16 : 9;                // taps of one input's weights
  static constexpr int TPW = UP ? 4 : 9;                // taps one warp applies
  static constexpr int CS = CIN + 8;                    // halo pixel stride (elements)
  static constexpr int WS = COUT + 8;                   // weight / output row stride
  static constexpr int HALO = (TH + 2) * kHW;           // halo pixels
  static constexpr int OUT_PX = TH * kTW * NPAR;        // output pixels of a tile
  static constexpr int STAGE = (HALO * CS > OUT_PX * WS) ? HALO * CS : OUT_PX * WS;
  static constexpr int WELEMS = NT * CIN * WS;          // one input's weights
  static constexpr int NRED = NPAR * NWM;               // stat rows per channel
  static_assert(NWM >= 1 && NWN * NPAR * NWM == WG, "warps must tile the group");
  static_assert(CIN % 16 == 0 && COUT % 32 == 0, "mma tiling");

  // a group's ring and stat rows; the weights are shared by the groups
  static constexpr size_t GROUP_BYTES = sizeof(bf16) * 2 * STAGE + sizeof(float) * NRED * 2 * COUT;

  static constexpr size_t smem_bytes(int nsrc, int ngroups) {
    return sizeof(bf16) * (size_t)nsrc * WELEMS + ngroups * GROUP_BYTES;
  }
};

struct MmaParams {
  const bf16* src[2];  // NHWC inputs [B,H,W,CIN] (K1: x and optional skip)
  const bf16* w[2];    // K1: [9,CIN,COUT] per input; K2: [4 parities * 4 taps,CIN,COUT]
  int nsrc;            // inputs (1 or 2)
  bf16* out;           // K1 [B,H,W,COUT]; K2 [B,2H,2W,COUT]
  float* part;         // [B,tiles,2,COUT] stat partials, or null
  int B, H, W;         // input resolution
};

// the warps of one group (named barrier 1 + group)
template <int THREADS>
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + group), "n"(THREADS) : "memory");
}

// NG groups share one staged copy of the weights; each group runs its own
// two-stage ring over its own items, so one group's epilogue overlaps the
// others' MMAs.
template <int COUT, int CIN, bool UP, int NG, int MF>
__global__ void __launch_bounds__(Cfg<COUT, CIN, UP, MF>::GT * NG) tapmma_kernel(const MmaParams p) {
  using C = Cfg<COUT, CIN, UP, MF>;
  constexpr int GT = C::GT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = threadIdx.x / GT;
  bf16* sW = reinterpret_cast<bf16*>(smem);                  // [nsrc][NT*CIN][WS]
  bf16* sBuf = reinterpret_cast<bf16*>(                      // this group's [2][STAGE]
      smem + sizeof(bf16) * (size_t)p.nsrc * C::WELEMS + group * C::GROUP_BYTES);
  float* sRed = reinterpret_cast<float*>(sBuf + 2 * C::STAGE);  // [NRED][2][COUT]

  const int tid = threadIdx.x % GT, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;      // mma fragment row / column pair
  const int lj = lane >> 3, lr = lane & 7;      // ldmatrix matrix / row of this lane
  const int wn = warp % C::NWN;
  const int wm = (warp / C::NWN) % C::NWM;
  const int par = warp / (C::NWN * C::NWM);     // K2: this warp's output parity
  const int pa = par >> 1, pb = par & 1;
  const int co0 = 32 * wn;
  const int H = p.H, W = p.W;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int tiles = ((H + C::TH - 1) / C::TH) * tiles_x;
  const int nitems = p.B * tiles;
  const int g0 = blockIdx.x * NG + group, ngrid = gridDim.x * NG;  // this group, all groups
  const int nmine = (nitems - g0 + ngrid - 1) / ngrid;
  const int nst = nmine * p.nsrc;               // stages: (item, input) pairs

  // the whole kernel once per block, shared by its groups
  for (int s = 0; s < p.nsrc; ++s) {
    const bf16* w = s ? p.w[1] : p.w[0];
    for (int e = threadIdx.x; e < C::NT * CIN * (COUT / 8); e += GT * NG) {
      const int row = e / (COUT / 8), c8 = e % (COUT / 8);
      tc::cp_async16(tc::smem_addr(sW + (size_t)s * C::WELEMS + row * C::WS + c8 * 8),
                     w + (size_t)row * COUT + c8 * 8, 16);
    }
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();  // every group sees every thread's weight copies

  auto load_stage = [&](int k, bf16* buf) {
    const int item = g0 + (k / p.nsrc) * ngrid;
    const bf16* src = (k % p.nsrc) ? p.src[1] : p.src[0];
    const int b = item / tiles, t = item % tiles;
    const int ty0 = (t / tiles_x) * C::TH, tx0 = (t % tiles_x) * kTW;
    for (int e = tid; e < C::HALO * (CIN / 8); e += GT) {
      const int hp = e / (CIN / 8), c8 = e % (CIN / 8);
      const int y = ty0 - 1 + hp / kHW, x = tx0 - 1 + hp % kHW;
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
      const bf16* g = in ? src + (((size_t)b * H + y) * W + x) * CIN + c8 * 8 : src;
      tc::cp_async16(tc::smem_addr(buf + hp * C::CS + c8 * 8), g, in ? 16 : 0);
    }
  };

  if (nst > 0) load_stage(0, sBuf);  // the last block's later groups may have no item
  tc::cp_async_commit();

  float acc[MF][4][4];
  for (int k = 0; k < nst; ++k) {
    bf16* buf = sBuf + (k & 1) * C::STAGE;
    if (k + 1 < nst) load_stage(k + 1, sBuf + ((k + 1) & 1) * C::STAGE);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    group_sync<GT>(group);  // stage k visible to every thread of the group

    const int s = k % p.nsrc;
    if (s == 0) {
#pragma unroll
      for (int f = 0; f < MF; ++f)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[f][n][e] = 0.f;
    }
    const bf16* sWs = sW + (size_t)s * C::WELEMS;
#pragma unroll
    for (int i = 0; i < C::TPW; ++i) {
      // halo offset of this tap and its weight row block
      const int hy = UP ? (i >> 1) + pa : i / 3;
      const int hx = UP ? (i & 1) + pb : i % 3;
      const int wt = UP ? par * 4 + i : i;
#pragma unroll
      for (int kc = 0; kc < CIN / 16; ++kc) {
        unsigned a[MF][4], bq[2][4];
#pragma unroll
        for (int f = 0; f < MF; ++f)
          tc::ldsm_x4(tc::smem_addr(buf + ((MF * wm + f + hy) * kHW + lr + 8 * (lj & 1) + hx) * C::CS +
                                    kc * 16 + 8 * (lj >> 1)),
                      a[f]);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
          tc::ldsm_x4_trans(tc::smem_addr(sWs + (wt * CIN + kc * 16 + lr + 8 * (lj & 1)) * C::WS +
                                          co0 + 16 * nn + 8 * (lj >> 1)),
                            bq[nn]);
#pragma unroll
        for (int f = 0; f < MF; ++f)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            tc::mma_bf16(acc[f][n], a[f], bq[n >> 1][2 * (n & 1)], bq[n >> 1][2 * (n & 1) + 1]);
      }
    }

    if (s == p.nsrc - 1) {
      // epilogue: round, stage the tile in buf, BN sums, coalesced stores
      const int item = g0 + (k / p.nsrc) * ngrid;
      const int b = item / tiles, t = item % tiles;
      const int ty0 = (t / tiles_x) * C::TH, tx0 = (t % tiles_x) * kTW;
      group_sync<GT>(group);  // every warp is done reading the halo in buf
      float ssum[4][2], ssq[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) ssum[n][0] = ssum[n][1] = ssq[n][0] = ssq[n][1] = 0.f;
#pragma unroll
      for (int f = 0; f < MF; ++f) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = MF * wm + f, m = gq + 8 * h;
          const bool in = ty0 + row < H && tx0 + m < W;
          const int sp = UP ? (2 * row + pa) * (2 * kTW) + 2 * m + pb : row * kTW + m;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(acc[f][n][2 * h], acc[f][n][2 * h + 1]);
            *reinterpret_cast<__nv_bfloat162*>(buf + sp * C::WS + co0 + 8 * n + 2 * tq) = v;
            if (in) {
              const float r0 = __low2float(v), r1 = __high2float(v);
              ssum[n][0] += r0;
              ssum[n][1] += r1;
              ssq[n][0] += r0 * r0;
              ssq[n][1] += r1 * r1;
            }
          }
        }
      }
      if (p.part != nullptr) {  // uniform across the block
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
              ssum[n][j] += __shfl_xor_sync(0xffffffffu, ssum[n][j], off);
              ssq[n][j] += __shfl_xor_sync(0xffffffffu, ssq[n][j], off);
            }
        if (gq == 0) {
          float* red = sRed + (par * C::NWM + wm) * 2 * COUT;
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              red[co0 + 8 * n + 2 * tq + j] = ssum[n][j];
              red[COUT + co0 + 8 * n + 2 * tq + j] = ssq[n][j];
            }
        }
      }
      group_sync<GT>(group);  // the staged tile and the warps' sums are complete
      // rows of the tile: K1 16 pixels of the output, K2 32 (both parities)
      constexpr int ROW_PX = UP ? 2 * kTW : kTW;
      const int Ho = UP ? 2 * H : H, Wo = UP ? 2 * W : W;
      const int oy0 = UP ? 2 * ty0 : ty0, ox0 = UP ? 2 * tx0 : tx0;
      for (int e = tid; e < C::OUT_PX * (COUT / 8); e += GT) {
        const int sp = e / (COUT / 8), c8 = e % (COUT / 8);
        const int oy = oy0 + sp / ROW_PX, ox = ox0 + sp % ROW_PX;
        if (oy < Ho && ox < Wo)
          *reinterpret_cast<uint4*>(p.out + (((size_t)b * Ho + oy) * Wo + ox) * COUT + c8 * 8) =
              *reinterpret_cast<const uint4*>(buf + sp * C::WS + c8 * 8);
      }
      if (p.part != nullptr && tid < 2 * COUT) {
        float v = 0.f;
        for (int r = 0; r < C::NRED; ++r) v += sRed[r * 2 * COUT + tid];
        p.part[((size_t)b * tiles + t) * 2 * COUT + tid] = v;
      }
    }
    group_sync<GT>(group);  // buf is free for stage k + 2 (and sRed for the next tile)
  }
  tc::cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// K1 with Cin = 1: a bytes-bound FP32 loop on the same tiles
// ---------------------------------------------------------------------------

// three blocks per SM (<= 85 registers): a tile's work is short, so the
// next blocks' halo loads and stores hide each block's latency
template <int COUT>
__global__ void __launch_bounds__(kThreads, 3)
    conv1ch_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* out,
                   float* part, int B, int H, int W) {
  constexpr int TH = 512 / COUT;                // K1's tile rows at this Cout
  constexpr int NPX = TH * kTW;                 // pixels of a tile
  constexpr int NCG = kThreads / NPX;           // groups of 32 output channels
  constexpr int WS = COUT + 8;
  constexpr int NGRP = kThreads / COUT;         // pixel groups of the stat sums
  static_assert(NCG * 32 == COUT, "one thread: one pixel x 32 channels");

  __shared__ __align__(16) float s_w[9][COUT];
  __shared__ float s_in[(TH + 2) * kHW];
  __shared__ __align__(16) bf16 s_out[NPX * WS];
  __shared__ float s_red[NGRP][2][COUT];

  const int tid = threadIdx.x;
  const int pix = tid % NPX, cg = tid / NPX;
  const int py = pix / kTW, px = pix % kTW;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int tiles = ((H + TH - 1) / TH) * tiles_x;

  for (int e = tid; e < 9 * COUT; e += kThreads) s_w[e / COUT][e % COUT] = __bfloat162float(w[e]);

  for (int item = blockIdx.x; item < B * tiles; item += gridDim.x) {
    const int b = item / tiles, t = item % tiles;
    const int ty0 = (t / tiles_x) * TH, tx0 = (t % tiles_x) * kTW;
    for (int e = tid; e < (TH + 2) * kHW; e += kThreads) {
      const int y = ty0 - 1 + e / kHW, xx = tx0 - 1 + e % kHW;
      s_in[e] = (y >= 0 && y < H && xx >= 0 && xx < W)
                    ? __bfloat162float(x[((size_t)b * H + y) * W + xx])
                    : 0.f;
    }
    __syncthreads();  // halo (and, on the first tile, the weights) loaded

    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float xv = s_in[(py + tap / 3) * kHW + px + tap % 3];
#pragma unroll
      for (int j = 0; j < 32; j += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(&s_w[tap][cg * 32 + j]);
        acc[j] = fmaf(xv, wv.x, acc[j]);
        acc[j + 1] = fmaf(xv, wv.y, acc[j + 1]);
        acc[j + 2] = fmaf(xv, wv.z, acc[j + 2]);
        acc[j + 3] = fmaf(xv, wv.w, acc[j + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 32; j += 8) {
      __align__(16) __nv_bfloat162 o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) o[q] = __floats2bfloat162_rn(acc[j + 2 * q], acc[j + 2 * q + 1]);
      *reinterpret_cast<uint4*>(s_out + pix * WS + cg * 32 + j) = *reinterpret_cast<const uint4*>(o);
    }
    __syncthreads();  // the rounded tile is staged

    for (int e = tid; e < NPX * (COUT / 8); e += kThreads) {
      const int sp = e / (COUT / 8), c8 = e % (COUT / 8);
      const int y = ty0 + sp / kTW, xx = tx0 + sp % kTW;
      if (y < H && xx < W)
        *reinterpret_cast<uint4*>(out + (((size_t)b * H + y) * W + xx) * COUT + c8 * 8) =
            *reinterpret_cast<const uint4*>(s_out + sp * WS + c8 * 8);
    }
    if (part != nullptr) {  // uniform across the block
      const int ch = tid % COUT, grp = tid / COUT;
      float a = 0.f, q = 0.f;
      for (int sp = grp; sp < NPX; sp += NGRP) {
        if (ty0 + sp / kTW < H && tx0 + sp % kTW < W) {
          const float r = __bfloat162float(s_out[sp * WS + ch]);
          a += r;
          q += r * r;
        }
      }
      s_red[grp][0][ch] = a;
      s_red[grp][1][ch] = q;
      __syncthreads();
      if (tid < 2 * COUT) {
        float v = 0.f;
        for (int g = 0; g < NGRP; ++g) v += s_red[g][tid / COUT][tid % COUT];
        part[((size_t)b * tiles + t) * 2 * COUT + tid] = v;
      }
    }
    __syncthreads();  // s_in, s_out and s_red are free for the next tile
  }
}

// ---------------------------------------------------------------------------
// K3: the first version's FP32 body (upconv adjoint)
// ---------------------------------------------------------------------------

constexpr int kTH3 = 8;                // output tile rows
constexpr int kTile3 = kTH3 * kTW;     // pixels per block
constexpr int kHaloH3 = kTH3 + 2;
constexpr int kCK = 8;                 // input channels per shared-memory chunk

struct DxParams {
  const bf16* g;        // [B,2H,2W,C] cotangent
  const bf16* w;        // [4 parities, 4 taps, C, COUT] (K2's taps, channels swapped)
  int C;                // cotangent channels
  bf16* out;            // [B,H,W,COUT]
  int B, H, W;          // input resolution
};

template <int COUT>
__global__ void __launch_bounds__(kThreads) upconv_dx_kernel(const DxParams p) {
  constexpr int NT = 4;
  constexpr int NCG = COUT / 8;            // groups of 8 output channels
  constexpr int PG = kThreads / NCG;       // threads sharing one group
  constexpr int PX = kTile3 / PG;          // pixels per thread
  static_assert(PG % 32 == 0, "a warp must stay inside one channel group");
  static_assert(PX * PG == kTile3, "tile must split evenly");

  __shared__ __align__(16) float s_in[kCK][kHaloH3][kHW];
  __shared__ __align__(16) float s_w[NT][kCK][COUT];

  const int tid = threadIdx.x;
  const int cg = tid / PG;
  const int pg = tid % PG;
  const int H = p.H, W = p.W;
  const int ntx = (W + kTW - 1) / kTW;
  const int ty0 = (blockIdx.x / ntx) * kTH3;
  const int tx0 = (blockIdx.x % ntx) * kTW;
  const int b = blockIdx.y;
  const int Hs = H * 2, Ws = W * 2;        // the full-resolution cotangent
  const int C = p.C;

  float acc[PX][8];
#pragma unroll
  for (int k = 0; k < PX; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;

  for (int par = 0; par < 4; ++par) {
    const bf16* w = p.w + (size_t)par * NT * C * COUT;
    const int sa = par >> 1, sb = par & 1;

    for (int c0 = 0; c0 < C; c0 += kCK) {
      __syncthreads();  // the previous chunk's reads are done
      for (int i = tid; i < kHaloH3 * kHW; i += kThreads) {
        const int r = i / kHW, c = i % kHW;
        const int y = ty0 - 1 + r, x = tx0 - 1 + c;
        float v[kCK];
#pragma unroll
        for (int j = 0; j < kCK; ++j) v[j] = 0.f;
        if (y >= 0 && y < H && x >= 0 && x < W) {
          const bf16* px =
              p.g + (((size_t)b * Hs + (size_t)y * 2 + sa) * Ws + (size_t)x * 2 + sb) * C + c0;
          if ((C & 7) == 0) {
            // 8 channels = one aligned 16-byte load
            const uint4 u = *reinterpret_cast<const uint4*>(px);
            const bf16* e = reinterpret_cast<const bf16*>(&u);
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
        s_w[t][ci][co] = (c0 + ci < C) ? __bfloat162float(w[((size_t)t * C + c0 + ci) * COUT + co])
                                       : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int t = 0; t < NT; ++t) {
        // tap (r, c) of parity (a, b) reads offset (r + a - 1, c + b - 1);
        // the adjoint gathers at the negated offset
        const int dy = -((t >> 1) + (par >> 1) - 1);
        const int dx = -((t & 1) + (par & 1) - 1);
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

  // round to bf16 and store 8 channels as one 16-byte write
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int pix = pg + k * PG;
    const int y = ty0 + pix / kTW, x = tx0 + pix % kTW;
    if (y < H && x < W) {
      __align__(16) bf16 o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16(acc[k][j]);
      *reinterpret_cast<uint4*>(p.out + (((size_t)b * H + y) * W + x) * COUT + cg * 8) =
          *reinterpret_cast<const uint4*>(o);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 16;
// shared memory a block may opt in to on the H100 / H200 (227 KB); the
// launches read the card's own value, this only prunes instantiations
constexpr size_t kSmemOptinHopper = 232448;

// What a launch needs of the card, queried once per device: SMs and the
// shared memory a block may opt in to.
struct Card {
  int sms = 0, smem_optin = 0;
};

int card(Card* out) {
  static Card cards[kMaxDevices];
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  Card& c = cards[dev];
  if (c.sms == 0) {
    if ((err = cudaDeviceGetAttribute(&c.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                      dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess) {
      c.sms = 0;
      return (int)err;
    }
  }
  *out = c;
  return 0;
}

// Blocks of a persistent grid: as many as fit on the card at once, at most
// one per ``per_block`` items. The kernel's dynamic shared-memory ceiling is
// raised to what the card lets a block opt in to, and its residency computed,
// once per (device, kernel, shared memory); later launches read the cache.
template <typename Kern>
int persistent_grid(Kern kern, int threads, size_t smem, int nitems, int per_block, int* grid) {
  struct Entry {
    const void* fn;
    size_t smem;
    int blocks;
  };
  constexpr int kSlots = 32;
  static Entry cache[kMaxDevices][kSlots];
  Card c;
  int rc = card(&c);
  if (rc != 0) return rc;
  if (smem > (size_t)c.smem_optin) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  const void* fn = reinterpret_cast<const void*>(kern);
  Entry* e = cache[dev];
  int i = 0;
  while (i < kSlots - 1 && e[i].fn != nullptr && (e[i].fn != fn || e[i].smem != smem)) ++i;
  if (e[i].fn != fn || e[i].smem != smem) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kern);
    if (err == cudaSuccess)  // the ceiling: the opt-in less the static shared memory
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 c.smem_optin - (int)attr.sharedSizeBytes);
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    e[i] = Entry{fn, smem, c.sms * per_sm};
  }
  const int need = (nitems + per_block - 1) / per_block;
  *grid = e[i].blocks < need ? e[i].blocks : need;
  return 0;
}

// K1 tile rows at a Cout (K1's MMA and Cin = 1 kernels share them), K2's
template <bool UP>
int tile_rows(int cout) {
  return UP ? (cout == 32 ? Cfg<32, 64, true>::TH : Cfg<64, 64, true>::TH)
            : (cout == 32 ? Cfg<32, 32, false>::TH : Cfg<64, 32, false>::TH);
}

int num_tiles(bool up, int H, int W, int cout) {
  const int th = up ? tile_rows<true>(cout) : tile_rows<false>(cout);
  return ((H + th - 1) / th) * ((W + kTW - 1) / kTW);
}

template <int COUT, int CIN, bool UP, int NG, int MF>
int launch_mma_t(const MmaParams& p, int nitems, cudaStream_t st) {
  using C = Cfg<COUT, CIN, UP, MF>;
  auto kern = tapmma_kernel<COUT, CIN, UP, NG, MF>;
  const size_t smem = C::smem_bytes(p.nsrc, NG);
  int grid = 0;
  const int rc = persistent_grid(kern, C::GT * NG, smem, nitems, NG, &grid);
  if (rc != 0) return rc;
  kern<<<grid, C::GT * NG, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// K1: the first that fits beside the staged weights of three or two groups of
// 4 warps with 64-pixel warp tiles (a quarter fewer ldmatrix per MMA than
// 32-pixel tiles), else one group of 8 warps with 32-pixel tiles (the skip
// conv at 64 + 64 channels, and 64 -> 32). K2: two groups of 8 warps with
// 32-pixel tiles where they fit, else one.
template <int COUT, int CIN, bool UP>
int launch_mma(const MmaParams& p, cudaStream_t st) {
  using C2 = Cfg<COUT, CIN, UP, 2>;
  Card c;
  const int rc = card(&c);
  if (rc != 0) return rc;
  const int nitems = p.B * num_tiles(UP, p.H, p.W, COUT);
  const size_t optin = (size_t)c.smem_optin;
  if constexpr (!UP) {
    using C4 = Cfg<COUT, CIN, UP, 4>;
    // three groups are compiled only where they can fit on a Hopper card
    if constexpr (C4::smem_bytes(1, 3) <= kSmemOptinHopper) {
      if (C4::smem_bytes(p.nsrc, 3) <= optin) return launch_mma_t<COUT, CIN, UP, 3, 4>(p, nitems, st);
    }
    if (C4::smem_bytes(p.nsrc, 2) <= optin) return launch_mma_t<COUT, CIN, UP, 2, 4>(p, nitems, st);
  } else {
    if (C2::smem_bytes(p.nsrc, 2) <= optin) return launch_mma_t<COUT, CIN, UP, 2, 2>(p, nitems, st);
  }
  return launch_mma_t<COUT, CIN, UP, 1, 2>(p, nitems, st);
}

template <int COUT>
int launch_conv1ch(const bf16* x, const bf16* w, bf16* out, float* part, int B, int H, int W,
                   cudaStream_t st) {
  auto kern = conv1ch_kernel<COUT>;
  int grid = 0;
  const int rc = persistent_grid(kern, kThreads, 0, B * num_tiles(false, H, W, COUT), 1, &grid);
  if (rc != 0) return rc;
  kern<<<grid, kThreads, 0, st>>>(x, w, out, part, B, H, W);
  return (int)cudaGetLastError();
}

bool valid(int B, int H, int W, int cout) {
  return B > 0 && H > 0 && W > 0 && (cout == 32 || cout == 64);
}

}  // namespace

extern "C" {

// Stat partials per sample: kind 0 = K1 (any Cin), 1 = K2; 0 for a Cout the
// kernels do not take.
int tapconv_num_partials(int kind, int H, int W, int cout) {
  if (!valid(1, H, W, cout)) return 0;
  return num_tiles(kind == 1, H, W, cout);
}

const char* tapconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1. x [B,H,W,cin], w [9,cin,cout]; skip [B,H,W,cs] with ws [9,cs,cout] or
// null; out [B,H,W,cout]; part [B,tapconv_num_partials(0,...),2,cout] or
// null. Takes cin = 1 without a skip, or cin in {32, 64} with cs = cin.
int conv3x3_stats(const void* x, int cin, const void* w, const void* skip, int cs,
                  const void* ws, void* out, void* part, int B, int H, int W, int cout,
                  void* stream) {
  if (!valid(B, H, W, cout)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  float* pf = static_cast<float*>(part);
  if (cin == 1) {
    if (skip != nullptr) return (int)cudaErrorInvalidValue;
    return cout == 32 ? launch_conv1ch<32>(xb, wb, ob, pf, B, H, W, st)
                      : launch_conv1ch<64>(xb, wb, ob, pf, B, H, W, st);
  }
  if ((cin != 32 && cin != 64) || (skip != nullptr && cs != cin)) return (int)cudaErrorInvalidValue;
  MmaParams p{};
  p.src[0] = xb;
  p.w[0] = wb;
  p.nsrc = 1;
  if (skip != nullptr) {
    p.src[1] = static_cast<const bf16*>(skip);
    p.w[1] = static_cast<const bf16*>(ws);
    p.nsrc = 2;
  }
  p.out = ob;
  p.part = pf;
  p.B = B;
  p.H = H;
  p.W = W;
  if (cout == 32) return cin == 32 ? launch_mma<32, 32, false>(p, st) : launch_mma<32, 64, false>(p, st);
  return cin == 32 ? launch_mma<64, 32, false>(p, st) : launch_mma<64, 64, false>(p, st);
}

// K2. x [B,H,W,64], taps [4 parities,4 taps,64,cout]; out [B,2H,2W,cout];
// part [B,tapconv_num_partials(1,...),2,cout] (never null).
int upconv3x3_stats(const void* x, const void* taps, void* out, void* part, int B, int H,
                    int W, int cin, int cout, void* stream) {
  if (!valid(B, H, W, cout) || cin != 64 || part == nullptr) return (int)cudaErrorInvalidValue;
  MmaParams p{};
  p.src[0] = static_cast<const bf16*>(x);
  p.w[0] = static_cast<const bf16*>(taps);
  p.nsrc = 1;
  p.out = static_cast<bf16*>(out);
  p.part = static_cast<float*>(part);
  p.B = B;
  p.H = H;
  p.W = W;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return cout == 32 ? launch_mma<32, 64, true>(p, st) : launch_mma<64, 64, true>(p, st);
}

// K3. g [B,2H,2W,cg], taps_t [4 parities,4 taps,cg,cin] (K2's taps with the
// channel axes swapped); dx [B,H,W,cin].
int upconv3x3_dx(const void* g, const void* taps_t, void* dx, int B, int H, int W, int cg,
                 int cin, void* stream) {
  if (!valid(B, H, W, cin) || B > 65535) return (int)cudaErrorInvalidValue;
  DxParams p{};
  p.g = static_cast<const bf16*>(g);
  p.w = static_cast<const bf16*>(taps_t);
  p.C = cg;
  p.out = static_cast<bf16*>(dx);
  p.B = B;
  p.H = H;
  p.W = W;
  const dim3 grid(((H + kTH3 - 1) / kTH3) * ((W + kTW - 1) / kTW), B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (cin == 32) {
    upconv_dx_kernel<32><<<grid, kThreads, 0, st>>>(p);
  } else {
    upconv_dx_kernel<64><<<grid, kThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
