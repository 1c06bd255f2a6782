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
//   K3 upconv3x3_dx    K2's adjoint (convblock.py _UpconvStats.backward;
//                      _pcts_bwd, which runs _conv_plane_kernel_multi at
//                      negated offsets on transposed taps): every input pixel
//                      gathers the four parity planes of the cotangent at the
//                      negated tap offsets.
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
// K3 is the same body with four sources: M the pixels of an input-grid tile,
// N dx's channels, K 4 parities x 4 taps x the cotangent's channels (512 at
// the path's 32). Source s is parity s's sub-grid g[:, a::2, b::2] with a
// one-pixel halo, loaded by the ring at stride 2; its 4 taps read it at the
// negated offsets; the accumulators persist across the four sources as they
// do across K1's skip input, and the epilogue is K1's without statistics.
// Its weights are K2's taps as they are, [16][Cin][Cout] = [tap][N][K] with
// K contiguous, so they are read with plain ldmatrix (no .trans) and the
// wrapper makes no transposed copy; they are staged once per block (80 KB at
// 32 -> 64). The four parity stages of a tile are loaded back to back rather
// than as one full-resolution halo: parities (a, 0) and (a, 1) read the two
// halves of the same 128-byte lines one stage apart, so L2 serves the second
// and HBM is read once, while every stage stays an ordinary halo tile whose
// ldmatrix rows fall on distinct banks. At batch 96 K3 moves 462 MB for
// 79 GFLOP: bytes bound it (0.138 ms), as for K1 and K2.
//
// Every entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not
// take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;          // threads of the Cin = 1 blocks
constexpr int kTW = 16;                // tile cols (input grid): one m16 fragment
constexpr int kHW = kTW + 2;           // halo tile cols

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// K1 (Cin >= 32), K2 and K3: implicit GEMM on the tensor cores
// ---------------------------------------------------------------------------

// What an instantiation of the body computes (its KIND)
constexpr int kConv = 0;  // K1: 3x3 conv of one or two inputs (x, skip)
constexpr int kUp = 1;    // K2: Up2's four parity convs of one input tile
constexpr int kUpDx = 2;  // K3: Up2's adjoint; its four sources are g's parity sub-grids

// A group of WG = 16 / MF warps computes one tile; each warp MF rows of 16
// pixels (m16 fragments) x 32 output channels. MF = 2 and 4 give the same
// tile, so the partials do not depend on it. K3's "input" is the cotangent
// (CIN = its channels) and its "output" dx (COUT = Up2's input channels).
template <int COUT, int CIN, int KIND, int MF = 2>
struct Cfg {
  static constexpr bool UP = KIND == kUp, DX = KIND == kUpDx;
  static constexpr int WG = 16 / MF;                    // warps of a group
  static constexpr int GT = 32 * WG;                    // threads of a group
  static constexpr int NWN = COUT / 32;                 // warps along Cout
  static constexpr int NPAR = UP ? 4 : 1;               // output parities of a tile
  static constexpr int NWM = WG / (NWN * NPAR);         // warps along pixel rows
  static constexpr int TH = MF * NWM;                   // tile rows (input grid)
  static constexpr int NT = (UP || DX) ? 16 : 9;        // taps of one weight set
  static constexpr int TPW = (UP || DX) ? 4 : 9;        // taps one warp applies per source
  static constexpr int CS = CIN + 8;                    // halo pixel stride (elements)
  static constexpr int WS = COUT + 8;                   // staged output row stride
  // weight rows: K1 / K2 [tap][CIN][COUT] (ldmatrix.trans); K3 reads K2's
  // taps as they are, [tap][COUT][CIN], the reduction axis contiguous (plain
  // ldmatrix), so no transposed copy is made
  static constexpr int WROWS = DX ? COUT : CIN;
  static constexpr int WLEN = DX ? CIN : COUT;          // elements of a weight row
  static constexpr int WRS = WLEN + 8;                  // padded weight row stride
  static constexpr int HALO = (TH + 2) * kHW;           // halo pixels
  static constexpr int OUT_PX = TH * kTW * NPAR;        // output pixels of a tile
  static constexpr int STAGE = (HALO * CS > OUT_PX * WS) ? HALO * CS : OUT_PX * WS;
  static constexpr int WELEMS = NT * WROWS * WRS;       // one weight set
  static constexpr int NRED = NPAR * NWM;               // stat rows per channel
  static_assert(NWM >= 1 && NWN * NPAR * NWM == WG, "warps must tile the group");
  static_assert(CIN % 16 == 0 && COUT % 32 == 0, "mma tiling");

  // a group's ring and stat rows; the weights are shared by the groups
  static constexpr size_t GROUP_BYTES = sizeof(bf16) * 2 * STAGE + sizeof(float) * NRED * 2 * COUT;

  // nw weight sets (K1: one per input; K2, K3: one)
  static constexpr size_t smem_bytes(int nw, int ngroups) {
    return sizeof(bf16) * (size_t)nw * WELEMS + ngroups * GROUP_BYTES;
  }
};

struct MmaParams {
  const bf16* src[2];  // K1 x and optional skip [B,H,W,CIN]; K2 x; K3 g [B,2H,2W,CIN]
  const bf16* w[2];    // K1 [9,CIN,COUT] per input; K2 [16 parity taps,CIN,COUT]; K3 [16,COUT,CIN]
  int nsrc;            // stages per tile: K1 its inputs (1 or 2), K2 1, K3 4 parities
  bf16* out;           // K1, K3 [B,H,W,COUT]; K2 [B,2H,2W,COUT]
  float* part;         // [B,tiles,2,COUT] stat partials, or null
  int B, H, W;         // input resolution (K3: dx's)
};

// the warps of one group (named barrier 1 + group)
template <int THREADS>
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + group), "n"(THREADS) : "memory");
}

// NG groups share one staged copy of the weights; each group runs its own
// two-stage ring over its own items, so one group's epilogue overlaps the
// others' MMAs.
template <int COUT, int CIN, int KIND, int NG, int MF>
__global__ void __launch_bounds__(Cfg<COUT, CIN, KIND, MF>::GT * NG) tapmma_kernel(const MmaParams p) {
  using C = Cfg<COUT, CIN, KIND, MF>;
  constexpr int GT = C::GT;
  constexpr bool UP = C::UP, DX = C::DX;
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = threadIdx.x / GT;
  const int nw = DX ? 1 : p.nsrc;                            // weight sets
  bf16* sW = reinterpret_cast<bf16*>(smem);                  // [nw][NT*WROWS][WRS]
  bf16* sBuf = reinterpret_cast<bf16*>(                      // this group's [2][STAGE]
      smem + sizeof(bf16) * (size_t)nw * C::WELEMS + group * C::GROUP_BYTES);
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
  for (int s = 0; s < nw; ++s) {
    const bf16* w = s ? p.w[1] : p.w[0];
    for (int e = threadIdx.x; e < C::NT * C::WROWS * (C::WLEN / 8); e += GT * NG) {
      const int row = e / (C::WLEN / 8), c8 = e % (C::WLEN / 8);
      tc::cp_async16(tc::smem_addr(sW + (size_t)s * C::WELEMS + row * C::WRS + c8 * 8),
                     w + (size_t)row * C::WLEN + c8 * 8, 16);
    }
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();  // every group sees every thread's weight copies

  // K3's stages of one tile are g's four parity sub-grids, back to back:
  // parities (a, 0) and (a, 1) read the two 64-byte halves of the same
  // 128-byte lines (Cin 32), so the second is served by L2 and every byte
  // of g comes from HBM once per tile
  auto load_stage = [&](int k, bf16* buf) {
    const int item = g0 + (k / p.nsrc) * ngrid, s = k % p.nsrc;
    const bf16* src = (!DX && s) ? p.src[1] : p.src[0];
    const int b = item / tiles, t = item % tiles;
    const int ty0 = (t / tiles_x) * C::TH, tx0 = (t % tiles_x) * kTW;
    for (int e = tid; e < C::HALO * (CIN / 8); e += GT) {
      const int hp = e / (CIN / 8), c8 = e % (CIN / 8);
      const int y = ty0 - 1 + hp / kHW, x = tx0 - 1 + hp % kHW;
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
      const bf16* g = src;
      if (in) {
        const size_t pix = DX ? ((size_t)b * 2 * H + 2 * y + (s >> 1)) * (2 * W) + 2 * x + (s & 1)
                              : ((size_t)b * H + y) * W + x;
        g = src + pix * CIN + c8 * 8;
      }
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
    const bf16* sWs = sW + (DX ? 0 : (size_t)s * C::WELEMS);
#pragma unroll
    for (int i = 0; i < C::TPW; ++i) {
      // halo offset of this tap and its weight row block. K3: tap (r, c) of
      // parity (a, b) reads input offset (r + a - 1, c + b - 1), so its
      // adjoint gathers the parity's sub-grid at the negated offset
      const int hy = UP ? (i >> 1) + pa : DX ? 2 - (i >> 1) - (s >> 1) : i / 3;
      const int hx = UP ? (i & 1) + pb : DX ? 2 - (i & 1) - (s & 1) : i % 3;
      const int wt = UP ? par * 4 + i : DX ? s * 4 + i : i;
#pragma unroll
      for (int kc = 0; kc < CIN / 16; ++kc) {
        unsigned a[MF][4], bq[2][4];
#pragma unroll
        for (int f = 0; f < MF; ++f)
          tc::ldsm_x4(tc::smem_addr(buf + ((MF * wm + f + hy) * kHW + lr + 8 * (lj & 1) + hx) * C::CS +
                                    kc * 16 + 8 * (lj >> 1)),
                      a[f]);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          if (DX)  // rows: output channels, k contiguous
            tc::ldsm_x4(tc::smem_addr(sWs + (wt * COUT + co0 + 16 * nn + lr + 8 * (lj >> 1)) * C::WRS +
                                      kc * 16 + 8 * (lj & 1)),
                        bq[nn]);
          else
            tc::ldsm_x4_trans(tc::smem_addr(sWs + (wt * CIN + kc * 16 + lr + 8 * (lj & 1)) * C::WRS +
                                            co0 + 16 * nn + 8 * (lj >> 1)),
                              bq[nn]);
        }
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

// K1 tile rows at a Cout (K1's MMA and Cin = 1 kernels and K3 share them), K2's
template <bool UP>
int tile_rows(int cout) {
  return UP ? (cout == 32 ? Cfg<32, 64, kUp>::TH : Cfg<64, 64, kUp>::TH)
            : (cout == 32 ? Cfg<32, 32, kConv>::TH : Cfg<64, 32, kConv>::TH);
}

int num_tiles(bool up, int H, int W, int cout) {
  const int th = up ? tile_rows<true>(cout) : tile_rows<false>(cout);
  return ((H + th - 1) / th) * ((W + kTW - 1) / kTW);
}

template <int COUT, int CIN, int KIND, int NG, int MF>
int launch_mma_t(const MmaParams& p, int nw, int nitems, cudaStream_t st) {
  using C = Cfg<COUT, CIN, KIND, MF>;
  auto kern = tapmma_kernel<COUT, CIN, KIND, NG, MF>;
  const size_t smem = C::smem_bytes(nw, NG);
  int grid = 0;
  const int rc = persistent_grid(kern, C::GT * NG, smem, nitems, NG, &grid);
  if (rc != 0) return rc;
  kern<<<grid, C::GT * NG, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// K1 and K3: the first that fits beside the staged weights of three or two
// groups of 4 warps with 64-pixel warp tiles (a quarter fewer ldmatrix per
// MMA than 32-pixel tiles), else one group of 8 warps with 32-pixel tiles
// (the skip conv at 64 + 64 channels, K1 64 -> 32, K3 from 64 cotangent
// channels to 32). K2: two groups of 8 warps with 32-pixel tiles where they
// fit, else one.
template <int COUT, int CIN, int KIND>
int launch_mma(const MmaParams& p, cudaStream_t st) {
  using C2 = Cfg<COUT, CIN, KIND, 2>;
  Card c;
  const int rc = card(&c);
  if (rc != 0) return rc;
  const int nitems = p.B * num_tiles(KIND == kUp, p.H, p.W, COUT);
  const int nw = KIND == kUpDx ? 1 : p.nsrc;
  const size_t optin = (size_t)c.smem_optin;
  if constexpr (KIND != kUp) {
    using C4 = Cfg<COUT, CIN, KIND, 4>;
    // three groups are compiled only where they can fit on a Hopper card
    if constexpr (C4::smem_bytes(1, 3) <= kSmemOptinHopper) {
      if (C4::smem_bytes(nw, 3) <= optin) return launch_mma_t<COUT, CIN, KIND, 3, 4>(p, nw, nitems, st);
    }
    if constexpr (C4::smem_bytes(1, 2) <= kSmemOptinHopper) {
      if (C4::smem_bytes(nw, 2) <= optin) return launch_mma_t<COUT, CIN, KIND, 2, 4>(p, nw, nitems, st);
    }
  } else {
    if (C2::smem_bytes(nw, 2) <= optin) return launch_mma_t<COUT, CIN, KIND, 2, 2>(p, nw, nitems, st);
  }
  return launch_mma_t<COUT, CIN, KIND, 1, 2>(p, nw, nitems, st);
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
  if (cout == 32) return cin == 32 ? launch_mma<32, 32, kConv>(p, st) : launch_mma<32, 64, kConv>(p, st);
  return cin == 32 ? launch_mma<64, 32, kConv>(p, st) : launch_mma<64, 64, kConv>(p, st);
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
  return cout == 32 ? launch_mma<32, 64, kUp>(p, st) : launch_mma<64, 64, kUp>(p, st);
}

// K3. g [B,2H,2W,cg], taps [4 parities,4 taps,cin,cg] (K2's taps as they
// are); dx [B,H,W,cin]. Takes cg and cin in {32, 64}.
int upconv3x3_dx(const void* g, const void* taps, void* dx, int B, int H, int W, int cg,
                 int cin, void* stream) {
  if (!valid(B, H, W, cin) || (cg != 32 && cg != 64)) return (int)cudaErrorInvalidValue;
  MmaParams p{};
  p.src[0] = static_cast<const bf16*>(g);
  p.w[0] = static_cast<const bf16*>(taps);
  p.nsrc = 4;
  p.out = static_cast<bf16*>(dx);
  p.B = B;
  p.H = H;
  p.W = W;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (cin == 32) return cg == 32 ? launch_mma<32, 32, kUpDx>(p, st) : launch_mma<32, 64, kUpDx>(p, st);
  return cg == 32 ? launch_mma<64, 32, kUpDx>(p, st) : launch_mma<64, 64, kUpDx>(p, st);
}

}  // extern "C"
