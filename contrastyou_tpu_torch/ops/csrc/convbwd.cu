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
// What bounds them on the H100: dk costs 2*B*H*W*T*Cin*Cout FLOP (C2 twice
// that) against reading x and g once. At the main-path widths that is
// 100-300 FLOP per byte, at or below the bf16 ridge (~295), so the bytes are
// the bound and the products have to hide under the copies. The products run
// on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate) fed by
// ldmatrix from shared memory, pixel rows padded by 16 bytes so ldmatrix rows
// hit distinct banks. Blocks are persistent: each walks a fixed strided set
// of tiles and keeps its dk accumulators in registers across them, writes one
// f32 partial, and sum_partials adds the partials in a fixed order: no
// atomics, and the result is the same on every run. The TPU kernel's
// per-batch dk partials (convblock.py:736-737) become per-block partials.
//
// C1, Cin 32 / 64 on the 3x3 taps and 64 on Up2's (dw_mma_kernel), in the
// q-form dk[t,i,o] = sum_p x[p,i] * g[p - off_t, o]: M is Cin (x^T from an
// unshifted 8x16-pixel x tile, read with ldmatrix.trans), N 32 output
// channels, K the pixels of one tile row;
// operand B is a shifted view of the cotangent tile with a one-pixel halo
// (Up2: one halo tile per parity sub-grid). One block owns all of Cin and a
// 32-channel slice of Cout (all of it on the path, where Cout is 32), so the
// x tile and the g halo are each read once per tile; dk of the block (Up2 at
// Cin 64: 16 x 64 x 32 f32) lives in registers, one or two taps per warp
// (9 warps for the 3x3 taps, 8 for Up2's 16) x all of Cin x 32 channels.
// An x^T fragment serves every tap and Cout tile of its warp and a g
// fragment every Cin tile: per tile row a warp issues MT + 2 * TPW ldmatrix
// for 4 * MT * TPW mma (Up2 at Cin 64: 8 for 32). A cp.async two-stage ring
// loads the next tile (x, then the four parity halos, no barrier between
// them) while this one's products run.
//
// C1, Cin 1 (dw1ch_kernel, Conv1.conv0): the taps go on M (A[t][p] =
// x[p + off_t], 9 of 16 rows real, built from a bf16 plane of the x halo
// with 16-bit shared loads), N is Cout, K the pixels: no 16-channel
// zero-padded slice. g arrives through the cp.async ring, x (2 bytes a
// pixel, not 16-byte aligned at a halo) through registers loaded a tile
// ahead. The warps' dk (9 x Cout) are summed in shared memory in warp order.
//
// C2 (convbwd_kernel<Cin, Cout>, Cin and Cout in {32, 64}) joins K1's dx and
// C1's dk over one staged tile. A block of 8 warps owns all of Cin and all of
// Cout: per tile of 8 (32/64: 16) rows x 16 pixels it reads the x tile and
// the cotangent halo from memory once, through a cp.async two-stage ring
// that zero-fills the image border, and it stages the weights [9][Cin][Cout]
// once (82.9 KB at 64/64; 190 KB of shared memory in all). Each tile runs two
// products on the tensor cores:
// - dx, K1's implicit GEMM on the flipped taps: M the 16 pixels of a tile
//   row, N 16 channels of Cin per warp, K the 9 taps x Cout; A a shifted
//   ldmatrix view of the g halo, B the staged weights (plain ldmatrix: w[t]
//   is [i][o], K contiguous). A halo row serves three tile rows (one per
//   ky), so a warp of RW rows loads RW + 2 A fragments per (kx, 16 o), not
//   3 RW. One bf16 rounding, staged in shared memory, 16-byte row stores.
// - dk, C1's q-form: M Cin (x^T by ldmatrix.trans), N 16 output channels per
//   warp, K the pixels. The warp walks the halo rows: one g fragment per kx
//   serves three tile rows and every Cin tile of the warp, an x^T fragment
//   lives for three halo rows; MW + 3 ldmatrix feed up to 18 MW mma.
// Registers bound the design: dk's 9 x Cin x Cout f32 sums stay in registers
// across the block's tiles, 144 a thread at 64/64 (ptxas: 244 registers, no
// spill), beside dx's sums for one tile. With 8 warps on an SM the mma.sync
// latency is what holds it (16-warp blocks at 64/64 spill at 128 registers
// and ran 1.4x slower); at 32/32 the dx and dk roles go to separate warps so
// two blocks fit an SM (128 registers, no spill), which made those convs
// 1.2x faster than one block of 8 warps doing both (A/B runs, PERF.md §6).

// Every entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not
// take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tc::ldsm_x4;
using tc::ldsm_x4_trans;
using tc::mma_bf16;
using tc::smem_addr;

constexpr int kTH = 8;                   // tile rows
constexpr int kTW = 16;                  // tile cols: one mma K step (dk) / M tile (dx)
constexpr int kTile = kTH * kTW;
constexpr int kHW = kTW + 2;             // halo tile cols
constexpr int kHalo = (kTH + 2) * kHW;   // halo tile pixels
constexpr int kThreads = 256;

struct Params {
  const bf16* x;   // [B,H,W,cin]
  const bf16* g;   // [B,H,W,cout] (3x3, fused) or [B,2H,2W,cout] (Up2)
  const bf16* w;   // [9,cin,cout] (fused)
  bf16* dx;        // [B,H,W,cin] (fused)
  float* part;     // [nb, T, cin, cout] per-block partials
  int B, H, W;     // the x grid (Up2: input resolution)
  int cin, cout;
  int nb, nslice;  // blocks per channel slice, channel slices
};

// Tap t -> (dy, dx). 3x3: HWIO order, t = 3*ky + kx at offset (ky-1, kx-1).
// Up2: t = 4*parity + tap, parity (a, b) = divmod(parity, 2), tap (r, c) =
// divmod(tap, 2), offset (r + a - 1, c + b - 1).
template <bool UP>
__device__ __forceinline__ void tap_offset(int t, int& dy, int& dx) {
  if (UP) {
    const int par = t >> 2, tt = t & 3;
    dy = (tt >> 1) + (par >> 1) - 1;
    dx = (tt & 1) + (par & 1) - 1;
  } else {
    dy = t / 3 - 1;
    dx = t % 3 - 1;
  }
}

// ---------------------------------------------------------------------------
// C1 at Cin 32 / 64 (Up2: 64)
// ---------------------------------------------------------------------------

constexpr int kCo = 32;          // output channels of one C1 block (its slice of Cout)
constexpr int kGS = kCo + 8;     // padded pixel stride of a C1 cotangent tile

template <int CIN, bool UP>
struct DwCfg {
  static constexpr int T = UP ? 16 : 9;                 // taps
  static constexpr int WARPS = UP ? 8 : 9;
  static constexpr int TPW = T / WARPS;                 // taps of one warp
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MT = CIN / 16;                   // m16 tiles of Cin
  static constexpr int XS = CIN + 8;                    // padded pixel stride of the x tile
  static constexpr int NPAR = UP ? 4 : 1;               // cotangent halo tiles of a tile
  static constexpr int STAGE = kTile * XS + NPAR * kHalo * kGS;  // elements
  static constexpr size_t SMEM = sizeof(bf16) * 2 * STAGE;
  static_assert(TPW * WARPS == T && CIN % 16 == 0, "warps must tile the taps");
};

template <int CIN, bool UP>
__global__ void __launch_bounds__(DwCfg<CIN, UP>::THREADS) dw_mma_kernel(const Params p) {
  using C = DwCfg<CIN, UP>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sbuf = reinterpret_cast<bf16*>(smem);  // [2][STAGE]: x tile [kTile][XS], halos [NPAR][kHalo][kGS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;      // mma fragment row / column pair
  const int lj = lane >> 3, lr = lane & 7;      // ldmatrix matrix / row of this lane
  const int slice = blockIdx.x % p.nslice, blk = blockIdx.x / p.nslice;
  const int co0 = slice * kCo;
  const int H = p.H, W = p.W, cout = p.cout;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int tiles_img = ((H + kTH - 1) / kTH) * tiles_x;
  const int ntiles = p.B * tiles_img;
  const int nmine = blk < ntiles ? (ntiles - blk + p.nb - 1) / p.nb : 0;
  const int sub = UP ? 2 : 1;                   // Up2: g holds the 4 parity sub-grids
  const int Hg = H * sub, Wg = W * sub;

  auto load = [&](int k, bf16* st) {
    const int tile = blk + k * p.nb;
    const int b = tile / tiles_img, r = tile % tiles_img;
    const int ty0 = (r / tiles_x) * kTH, tx0 = (r % tiles_x) * kTW;
    for (int e = tid; e < kTile * (CIN / 8); e += kThreads) {
      const int pix = e / (CIN / 8), c8 = e % (CIN / 8);
      const int y = ty0 + pix / kTW, x = tx0 + pix % kTW;
      const bool in = y < H && x < W;
      const bf16* src = in ? p.x + (((size_t)b * H + y) * W + x) * CIN + c8 * 8 : p.x;
      tc::cp_async16(smem_addr(st + pix * C::XS + c8 * 8), src, in ? 16 : 0);
    }
    bf16* sg = st + kTile * C::XS;
    for (int e = tid; e < C::NPAR * kHalo * (kCo / 8); e += kThreads) {
      const int par = e / (kHalo * (kCo / 8)), hp = (e / (kCo / 8)) % kHalo, o8 = e % (kCo / 8);
      const int y = ty0 - 1 + hp / kHW, x = tx0 - 1 + hp % kHW;
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
      const bf16* src = p.g;
      if (in)
        src += (((size_t)b * Hg + y * sub + (par >> 1)) * Wg + x * sub + (par & 1)) * cout + co0 +
               o8 * 8;
      tc::cp_async16(smem_addr(sg + (par * kHalo + hp) * kGS + o8 * 8), src, in ? 16 : 0);
    }
  };

  float acc[C::TPW][C::MT][4][4];
#pragma unroll
  for (int j = 0; j < C::TPW; ++j)
#pragma unroll
    for (int m = 0; m < C::MT; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][m][n][e] = 0.f;

  if (nmine > 0) load(0, sbuf);
  tc::cp_async_commit();
  for (int k = 0; k < nmine; ++k) {
    const bf16* st = sbuf + (k & 1) * C::STAGE;
    if (k + 1 < nmine) load(k + 1, sbuf + ((k + 1) & 1) * C::STAGE);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();  // tile k visible to every thread
    const bf16* sg = st + kTile * C::XS;

#pragma unroll 1
    for (int ks = 0; ks < kTH; ++ks) {
      // A = x^T [i][pixel] of tile row ks, one fragment per m16 tile of Cin
      unsigned a[C::MT][4];
#pragma unroll
      for (int m = 0; m < C::MT; ++m)
        ldsm_x4_trans(smem_addr(st + (ks * kTW + lr + 8 * (lj >> 1)) * C::XS + m * 16 + 8 * (lj & 1)),
                      a[m]);
#pragma unroll
      for (int j = 0; j < C::TPW; ++j) {
        const int t = warp * C::TPW + j;
        int dy, dx;
        tap_offset<UP>(t, dy, dx);
        // B = the cotangent [pixel][o] shifted by -off_t (Up2: on t's parity)
        const bf16* row = sg + ((UP ? (t >> 2) * kHalo : 0) + (ks + 1 - dy) * kHW + lr +
                                8 * (lj & 1) + 1 - dx) * kGS + 8 * (lj >> 1);
        unsigned bq[2][4];
        ldsm_x4_trans(smem_addr(row), bq[0]);
        ldsm_x4_trans(smem_addr(row + 16), bq[1]);
#pragma unroll
        for (int m = 0; m < C::MT; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_bf16(acc[j][m][n], a[m], bq[n >> 1][2 * (n & 1)], bq[n >> 1][2 * (n & 1) + 1]);
      }
    }
    __syncthreads();  // the slot of tile k is free for tile k + 2
  }
  tc::cp_async_wait<0>();

  // this block's partial: acc[j][m][n] is dk[t][16m + gq (+8)][co0 + 8n + 2tq (+1)]
  float* out = p.part + (size_t)blk * C::T * CIN * cout;
#pragma unroll
  for (int j = 0; j < C::TPW; ++j) {
    const int t = warp * C::TPW + j;
#pragma unroll
    for (int m = 0; m < C::MT; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(out + ((size_t)t * CIN + 16 * m + gq + 8 * h) * cout + co0 +
                                     8 * n + 2 * tq) =
              make_float2(acc[j][m][n][2 * h], acc[j][m][n][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// C1 at Cin 1: the 9 taps on the rows of the product
// ---------------------------------------------------------------------------

constexpr int kTH1 = 16;                 // tile rows (two per warp)
constexpr int kXH1 = (kTH1 + 2) * kHW;   // x halo pixels

template <int COUT>
struct Dw1Cfg {
  static constexpr int GS = COUT + 8;    // padded pixel stride of the g tile
  static constexpr int GSTAGE = kTH1 * kTW * GS;
  static constexpr int XSTAGE = (kXH1 + 7) / 8 * 8;
  static constexpr size_t SMEM = sizeof(bf16) * 2 * (GSTAGE + XSTAGE);
  static_assert(sizeof(float) * 8 * 9 * COUT <= sizeof(bf16) * 2 * GSTAGE, "reduction fits");
};

template <int COUT>
__global__ void __launch_bounds__(kThreads) dw1ch_kernel(const Params p) {
  using C = Dw1Cfg<COUT>;
  constexpr int NT = COUT / 8;                  // n8 tiles
  constexpr int XPT = (kXH1 + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sG = reinterpret_cast<bf16*>(smem);                                   // [2][GSTAGE]
  unsigned short* sX = reinterpret_cast<unsigned short*>(sG + 2 * C::GSTAGE);  // [2][XSTAGE]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int lj = lane >> 3, lr = lane & 7;
  const int blk = blockIdx.x;
  const int H = p.H, W = p.W;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int tiles_img = ((H + kTH1 - 1) / kTH1) * tiles_x;
  const int ntiles = p.B * tiles_img;
  const int nmine = blk < ntiles ? (ntiles - blk + p.nb - 1) / p.nb : 0;
  const unsigned short* xg = reinterpret_cast<const unsigned short*>(p.x);

  // A rows: tap gq (a0, a2) and, in the lanes of row 0, tap 8 (a1, a3), as
  // offsets into the x halo plane from a tile row's first pixel
  const int off_lo = (gq / 3) * kHW + gq % 3 + 2 * tq;
  const int off_hi = 2 * kHW + 2 + 2 * tq;

  auto tile_origin = [&](int k, int& b, int& ty0, int& tx0) {
    const int tile = blk + k * p.nb;
    b = tile / tiles_img;
    const int r = tile % tiles_img;
    ty0 = (r / tiles_x) * kTH1;
    tx0 = (r % tiles_x) * kTW;
  };
  auto load_g = [&](int k, bf16* st) {
    int b, ty0, tx0;
    tile_origin(k, b, ty0, tx0);
    for (int e = tid; e < kTH1 * kTW * NT; e += kThreads) {
      const int pix = e / NT, o8 = e % NT;
      const int y = ty0 + pix / kTW, x = tx0 + pix % kTW;
      const bool in = y < H && x < W;
      const bf16* src = in ? p.g + (((size_t)b * H + y) * W + x) * COUT + o8 * 8 : p.g;
      tc::cp_async16(smem_addr(st + pix * C::GS + o8 * 8), src, in ? 16 : 0);
    }
  };
  unsigned short xr[XPT];
  auto load_x = [&](int k) {
    int b, ty0, tx0;
    tile_origin(k, b, ty0, tx0);
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int e = tid + j * kThreads;
      const int y = ty0 - 1 + e / kHW, x = tx0 - 1 + e % kHW;
      xr[j] = (e < kXH1 && y >= 0 && y < H && x >= 0 && x < W) ? xg[((size_t)b * H + y) * W + x]
                                                                : (unsigned short)0;
    }
  };
  auto store_x = [&](unsigned short* dst) {
#pragma unroll
    for (int j = 0; j < XPT; ++j)
      if (tid + j * kThreads < kXH1) dst[tid + j * kThreads] = xr[j];
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (nmine > 0) {
    load_g(0, sG);
    load_x(0);
    store_x(sX);
  }
  tc::cp_async_commit();
  for (int k = 0; k < nmine; ++k) {
    const bf16* sg = sG + (k & 1) * C::GSTAGE;
    const unsigned short* sx = sX + (k & 1) * C::XSTAGE;
    if (k + 1 < nmine) {
      load_g(k + 1, sG + ((k + 1) & 1) * C::GSTAGE);
      load_x(k + 1);  // in flight through this tile's products
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();  // tile k (g and x) visible to every thread

#pragma unroll
    for (int rr = 0; rr < kTH1 / 8; ++rr) {
      const int ks = warp * (kTH1 / 8) + rr;
      const unsigned short* xs = sx + ks * kHW;
      unsigned a[4];
      a[0] = xs[off_lo] | ((unsigned)xs[off_lo + 1] << 16);
      a[2] = xs[off_lo + 8] | ((unsigned)xs[off_lo + 9] << 16);
      a[1] = gq == 0 ? xs[off_hi] | ((unsigned)xs[off_hi + 1] << 16) : 0u;
      a[3] = gq == 0 ? xs[off_hi + 8] | ((unsigned)xs[off_hi + 9] << 16) : 0u;
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        unsigned bq[4];
        ldsm_x4_trans(smem_addr(sg + (ks * kTW + lr + 8 * (lj & 1)) * C::GS + 16 * nn + 8 * (lj >> 1)),
                      bq);
        mma_bf16(acc[2 * nn], a, bq[0], bq[1]);
        mma_bf16(acc[2 * nn + 1], a, bq[2], bq[3]);
      }
    }
    if (k + 1 < nmine) store_x(sX + ((k + 1) & 1) * C::XSTAGE);
    __syncthreads();  // tile k's slots are free; tile k + 1's x is staged
  }
  tc::cp_async_wait<0>();

  // the warps' dk rows (taps 0-8) summed in warp order into one partial
  float* red = reinterpret_cast<float*>(smem);  // [8 warps][9][COUT], over the idle ring
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float* r0 = red + (warp * 9 + gq) * COUT + 8 * n + 2 * tq;
    r0[0] = acc[n][0];
    r0[1] = acc[n][1];
    if (gq == 0) {
      r0[8 * COUT] = acc[n][2];
      r0[8 * COUT + 1] = acc[n][3];
    }
  }
  __syncthreads();
  for (int e = tid; e < 9 * COUT; e += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) v += red[w * 9 * COUT + e];
    p.part[(size_t)blk * 9 * COUT + e] = v;
  }
}

// ---------------------------------------------------------------------------
// C2: dx and dk of a 3x3 conv from one load of each x tile and g halo
// ---------------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;

// Warp roles of a C2 block (8 warps) at (CIN, COUT), each in {32, 64}.
// Without SPEC every warp runs dx and then dk on each tile. At 32/32 (SPEC)
// warps 0-3 run dx and warps 4-7 dk on the same staged tile, each role in its
// own loop (the barriers match one for one), so a warp holds only its own
// role's sums: 128 registers, two blocks per SM. 32/64 takes 16-row tiles.
// dx: warp = (RW tile rows, 16 input channels). dk: warp = (MW m16 tiles of
// Cin, 16 output channels), all 9 taps over all TH tile rows.
template <int CIN, int COUT>
struct FusedCfg {
  static constexpr bool SPEC = CIN == 32 && COUT == 32; // dx and dk on separate warps
  static constexpr int TH = CIN == 32 && COUT == 64 ? 16 : 8;  // tile rows
  static constexpr int TILE = TH * kTW, HALO = (TH + 2) * kHW;
  static constexpr int NDX = SPEC ? kWarps / 2 : kWarps;  // warps running dx
  static constexpr int NDK = SPEC ? kWarps / 2 : kWarps;  // warps running dk
  static constexpr int MT = CIN / 16, N16 = COUT / 16;
  static constexpr int MW = MT * N16 / NDK;             // m16 tiles of Cin of a dk warp
  static constexpr int RW = TH * MT / NDX;              // tile rows of a dx warp
  static constexpr int NGR = TH / RW;                   // dx warps along the rows
  static constexpr int XS = CIN + 8, GS = COUT + 8;     // padded pixel strides (x / dx, g)
  static constexpr int WS = COUT + 8;                   // padded weight row stride
  static constexpr int STAGE = TILE * XS + HALO * GS;   // x tile + g halo (elements)
  static constexpr int WELEMS = 9 * CIN * WS;
  static constexpr size_t SMEM = sizeof(bf16) * (2 * STAGE + WELEMS + TILE * XS);
  static constexpr int MINB = SPEC ? 2 : 1;             // blocks per SM
  static_assert((MT / MW) * N16 == NDK && NGR * MT == NDX, "warps must tile the block");
};

// dx of one tile by dx warp wd: dx[r][i] = sum_{ky,kx,o} g[halo row r + 2 -
// ky, col + 2 - kx][o] * w[3ky+kx][i][o]. M the 16 pixels of a tile row, N 16
// channels of Cin, K the taps x Cout. A halo row serves tile rows h - 2 .. h
// (ky = 0 .. 2), so a warp loads RW + 2 A fragments, not 3 RW, per (kx, 16
// output channels). One rounding to bf16, staged in sO, then 16-byte rows out
// by the dx warps.
template <int CIN, int COUT>
__device__ __forceinline__ void fused_dx_tile(const Params& p, const bf16* sg, const bf16* sW, bf16* sO,
                                              int wd, int lane, int b, int ty0, int tx0) {
  using C = FusedCfg<CIN, COUT>;
  constexpr int RW = C::RW;
  const int gq = lane >> 2, tq = lane & 3, lj = lane >> 3, lr = lane & 7;
  const int r0 = (wd % C::NGR) * RW, i0 = (wd / C::NGR) * 16;
  float acc[RW][2][4];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][n][e] = 0.f;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
    for (int ok = 0; ok < COUT / 16; ++ok) {
      unsigned bw[3][4];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
        ldsm_x4(smem_addr(sW + ((ky * 3 + kx) * CIN + i0 + lr + 8 * (lj >> 1)) * C::WS + ok * 16 +
                          8 * (lj & 1)),
                bw[ky]);
#pragma unroll
      for (int hh = 0; hh < RW + 2; ++hh) {
        unsigned a[4];
        ldsm_x4(smem_addr(sg + ((r0 + hh) * kHW + lr + 8 * (lj & 1) + 2 - kx) * C::GS + ok * 16 +
                          8 * (lj >> 1)),
                a);
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const int rr = hh + ky - 2;
          if (rr >= 0 && rr < RW) {
            mma_bf16(acc[rr][0], a, bw[ky][0], bw[ky][1]);
            mma_bf16(acc[rr][1], a, bw[ky][2], bw[ky][3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(sO + ((r0 + r) * kTW + gq + 8 * h) * C::XS + i0 + 8 * n + 2 * tq) =
            __floats2bfloat162_rn(acc[r][n][2 * h], acc[r][n][2 * h + 1]);
  // the dx warps' named barrier: the dx tile is staged
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * C::NDX) : "memory");
  for (int e = wd * 32 + lane; e < C::TILE * (CIN / 8); e += 32 * C::NDX) {
    const int pix = e / (CIN / 8), c8 = e % (CIN / 8);
    const int y = ty0 + pix / kTW, x = tx0 + pix % kTW;
    if (y < p.H && x < p.W)
      *reinterpret_cast<uint4*>(p.dx + (((size_t)b * p.H + y) * p.W + x) * CIN + c8 * 8) =
          *reinterpret_cast<const uint4*>(sO + pix * C::XS + c8 * 8);
  }
}

// dk of one tile by dk warp wk, added to its sums: dk[3ky+kx][i][o] +=
// sum_p x[p][i] * g[halo row(p) + 2 - ky, col(p) + 2 - kx][o]. M Cin (x^T by
// ldmatrix.trans), N 16 output channels, K the 16 pixels of a tile row.
// Walking the halo rows h, one B fragment per kx serves the three tile rows h
// - 2 .. h (ky = 0 .. 2) and every Cin tile of the warp, and an x^T fragment
// lives for three halo rows: per halo row MW + 3 ldmatrix feed up to 18 MW mma.
template <int CIN, int COUT>
__device__ __forceinline__ void fused_dk_tile(const bf16* st, const bf16* sg,
                                              float (&dk)[9][FusedCfg<CIN, COUT>::MW][2][4], int wk,
                                              int lane) {
  using C = FusedCfg<CIN, COUT>;
  constexpr int TH = C::TH, MW = C::MW;
  const int lj = lane >> 3, lr = lane & 7;
  const int m0 = (wk % (C::MT / MW)) * MW, nn = wk / (C::MT / MW);
  unsigned a[TH][MW][4];
#pragma unroll
  for (int hh = 0; hh < TH + 2; ++hh) {
    if (hh < TH) {
#pragma unroll
      for (int m = 0; m < MW; ++m)
        ldsm_x4_trans(smem_addr(st + (hh * kTW + lr + 8 * (lj >> 1)) * C::XS + (m0 + m) * 16 + 8 * (lj & 1)),
                      a[hh][m]);
    }
    unsigned bq[3][4];
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
      ldsm_x4_trans(smem_addr(sg + (hh * kHW + lr + 8 * (lj & 1) + 2 - kx) * C::GS + nn * 16 + 8 * (lj >> 1)),
                    bq[kx]);
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int rr = hh + ky - 2;
      if (rr >= 0 && rr < TH) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int m = 0; m < MW; ++m) {
            mma_bf16(dk[ky * 3 + kx][m][0], a[rr][m], bq[kx][0], bq[kx][1]);
            mma_bf16(dk[ky * 3 + kx][m][1], a[rr][m], bq[kx][2], bq[kx][3]);
          }
      }
    }
  }
}

template <int CIN, int COUT>
__global__ void __launch_bounds__(kThreads, FusedCfg<CIN, COUT>::MINB) convbwd_kernel(const Params p) {
  using C = FusedCfg<CIN, COUT>;
  constexpr int MW = C::MW;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sbuf = reinterpret_cast<bf16*>(smem);  // [2][STAGE]: x tile [TILE][XS], g halo [HALO][GS]
  bf16* sW = sbuf + 2 * C::STAGE;              // [9][CIN][WS]: w[t][i][o]
  bf16* sO = sW + C::WELEMS;                   // the rounded dx tile [TILE][XS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int blk = blockIdx.x;
  const int H = p.H, W = p.W;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int tiles_img = ((H + C::TH - 1) / C::TH) * tiles_x;
  const int ntiles = p.B * tiles_img;
  const int nmine = blk < ntiles ? (ntiles - blk + p.nb - 1) / p.nb : 0;
  const int wk = C::SPEC ? warp - C::NDX : warp;  // dk warp index

  // the weights once per block, in the same cp.async group as the first tile
  for (int e = tid; e < 9 * CIN * (COUT / 8); e += kThreads) {
    const int row = e / (COUT / 8), o8 = e % (COUT / 8);
    tc::cp_async16(smem_addr(sW + row * C::WS + o8 * 8), p.w + (size_t)row * COUT + o8 * 8, 16);
  }
  auto origin = [&](int k, int& b, int& ty0, int& tx0) {
    const int tile = blk + k * p.nb;
    b = tile / tiles_img;
    const int r = tile % tiles_img;
    ty0 = (r / tiles_x) * C::TH;
    tx0 = (r % tiles_x) * kTW;
  };
  auto load = [&](int k, bf16* st) {
    int b, ty0, tx0;
    origin(k, b, ty0, tx0);
    for (int e = tid; e < C::TILE * (CIN / 8); e += kThreads) {
      const int pix = e / (CIN / 8), c8 = e % (CIN / 8);
      const int y = ty0 + pix / kTW, x = tx0 + pix % kTW;
      const bool in = y < H && x < W;
      const bf16* src = in ? p.x + (((size_t)b * H + y) * W + x) * CIN + c8 * 8 : p.x;
      tc::cp_async16(smem_addr(st + pix * C::XS + c8 * 8), src, in ? 16 : 0);
    }
    bf16* sg = st + C::TILE * C::XS;
    for (int e = tid; e < C::HALO * (COUT / 8); e += kThreads) {
      const int hp = e / (COUT / 8), o8 = e % (COUT / 8);
      const int y = ty0 - 1 + hp / kHW, x = tx0 - 1 + hp % kHW;
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
      const bf16* src = in ? p.g + (((size_t)b * H + y) * W + x) * COUT + o8 * 8 : p.g;
      tc::cp_async16(smem_addr(sg + hp * C::GS + o8 * 8), src, in ? 16 : 0);
    }
  };

  // the block's tiles through the two-stage ring; tile_fn(k, x tile, g halo)
  auto walk = [&](auto&& tile_fn) {
    if (nmine > 0) load(0, sbuf);
    tc::cp_async_commit();
    for (int k = 0; k < nmine; ++k) {
      const bf16* st = sbuf + (k & 1) * C::STAGE;
      if (k + 1 < nmine) load(k + 1, sbuf + ((k + 1) & 1) * C::STAGE);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
      __syncthreads();  // tile k (and the weights) visible to every thread
      tile_fn(k, st, st + C::TILE * C::XS);
      __syncthreads();  // slot k is free for tile k + 2, sO for tile k + 1
    }
    tc::cp_async_wait<0>();
  };
  auto dx_tile = [&](int k, const bf16* sg) {
    int b, ty0, tx0;
    origin(k, b, ty0, tx0);
    fused_dx_tile<CIN, COUT>(p, sg, sW, sO, warp, lane, b, ty0, tx0);
  };
  // dk[t][m][n]: tap t = 3 ky + kx, rows 16 (m0 + m) + gq (+8), columns
  // 16 nn + 8 n + 2 tq (+1); in registers across the block's tiles, then
  // this block's partial [9][CIN][COUT]
  auto run_dk = [&](auto with_dx) {  // with_dx: std::true_type / std::false_type
    float dk[9][MW][2][4];
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dk[t][m][n][e] = 0.f;
    walk([&](int k, const bf16* st, const bf16* sg) {
      if constexpr (decltype(with_dx)::value) dx_tile(k, sg);
      fused_dk_tile<CIN, COUT>(st, sg, dk, wk, lane);
    });
    const int gq = lane >> 2, tq = lane & 3;
    const int m0 = (wk % (C::MT / MW)) * MW, nn = wk / (C::MT / MW);
    float* out = p.part + (size_t)blk * 9 * CIN * COUT;
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(out + ((size_t)t * CIN + 16 * (m0 + m) + gq + 8 * h) * COUT +
                                       16 * nn + 8 * n + 2 * tq) =
                make_float2(dk[t][m][n][2 * h], dk[t][m][n][2 * h + 1]);
  };

  // SPEC: each role walks the tiles in its own loop (the barriers match one
  // for one), so a dx warp holds no dk sums
  if (!C::SPEC)
    run_dk(std::true_type{});
  else if (warp < C::NDX)
    walk([&](int k, const bf16*, const bf16* sg) { dx_tile(k, sg); });
  else
    run_dk(std::false_type{});
}

// ---------------------------------------------------------------------------
// fixed-order sum of the partials, planning and launches
// ---------------------------------------------------------------------------

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

enum Mode { kDw3x3 = 0, kDwUp2 = 1, kFused = 2 };

// One kernel launch: the function, its block size and shared memory, the
// tiles it walks and the channel slices that split each tile.
struct Launch {
  const void* fn;
  int threads;
  size_t smem;
  int ntiles, nslice;
};

template <typename Kern>
Launch make_launch(Kern kern, int threads, size_t smem, int ntiles, int nslice) {
  return Launch{reinterpret_cast<const void*>(kern), threads, smem, ntiles, nslice};
}

int tiles(int B, int H, int W, int th) { return B * ((H + th - 1) / th) * ((W + kTW - 1) / kTW); }

template <int CIN, int COUT>
Launch fused_launch(int B, int H, int W) {
  using C = FusedCfg<CIN, COUT>;
  return make_launch(convbwd_kernel<CIN, COUT>, kThreads, C::SMEM, tiles(B, H, W, C::TH), 1);
}

// The kernel of a (mode, shape), or fn = nullptr for a shape no kernel takes:
// C1 at Cin 1 (3x3 only), 32 or 64; C2 at Cin 32 or 64; Cout 32, 64.
Launch select(int mode, int B, int H, int W, int cin, int cout) {
  Launch none{nullptr, 0, 0, 0, 0};
  if (B <= 0 || H <= 0 || W <= 0 || (cout != 32 && cout != 64)) return none;
  const int nt = tiles(B, H, W, kTH);
  if (mode == kFused) {
    if (cin == 32) return cout == 32 ? fused_launch<32, 32>(B, H, W) : fused_launch<32, 64>(B, H, W);
    if (cin == 64) return cout == 32 ? fused_launch<64, 32>(B, H, W) : fused_launch<64, 64>(B, H, W);
    return none;
  }
  const int ns = cout / kCo;
  if (mode == kDw3x3 && cin == 1) {
    const int nt1 = tiles(B, H, W, kTH1);
    return cout == 32 ? make_launch(dw1ch_kernel<32>, kThreads, Dw1Cfg<32>::SMEM, nt1, 1)
                      : make_launch(dw1ch_kernel<64>, kThreads, Dw1Cfg<64>::SMEM, nt1, 1);
  }
  if (mode == kDw3x3) {
    if (cin == 32) return make_launch(dw_mma_kernel<32, false>, DwCfg<32, false>::THREADS,
                                      DwCfg<32, false>::SMEM, nt, ns);
    if (cin == 64) return make_launch(dw_mma_kernel<64, false>, DwCfg<64, false>::THREADS,
                                      DwCfg<64, false>::SMEM, nt, ns);
  } else if (mode == kDwUp2) {
    if (cin == 64) return make_launch(dw_mma_kernel<64, true>, DwCfg<64, true>::THREADS,
                                      DwCfg<64, true>::SMEM, nt, ns);
  }
  return none;
}

// Blocks per channel slice of a persistent grid: as many as fit on the card
// at once, split over the slices, at most one per tile.
int plan(const Launch& l, int* nb) {
  cudaError_t err = cudaFuncSetAttribute(l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, l.fn, l.threads, l.smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int n = sms * per_sm / l.nslice;
  if (n < 1) n = 1;
  *nb = n < l.ntiles ? n : l.ntiles;
  return 0;
}

int run(int mode, Params p, float* dk, void* stream) {
  const Launch l = select(mode, p.B, p.H, p.W, p.cin, p.cout);
  if (l.fn == nullptr) return (int)cudaErrorInvalidValue;
  int nb = 0;
  const int rc = plan(l, &nb);
  if (rc != 0) return rc;
  p.nb = nb;
  p.nslice = l.nslice;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchKernel(l.fn, dim3(nb * l.nslice), dim3(l.threads), args, l.smem,
                                     reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  const int n = (mode == kDwUp2 ? 16 : 9) * p.cin * p.cout;
  sum_partials<<<(n + 31) / 32, 32 * kSumWarps, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      p.part, dk, nb, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* convbwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Partials, i.e. the leading dimension of the buffer [nb, T, cin, cout] the
// caller passes (mode 0: C1 3x3, 1: C1 Up2, 2: C2). Returns nb, or minus a
// CUDA error code.
int convbwd_num_partials(int mode, int B, int H, int W, int cin, int cout) {
  const Launch l = select(mode, B, H, W, cin, cout);
  if (l.fn == nullptr) return -(int)cudaErrorInvalidValue;
  int nb = 0;
  const int rc = plan(l, &nb);
  return rc != 0 ? -rc : nb;
}

// C1. x [B,H,W,cin]; g [B,H,W,cout] (up2 = 0) or [B,2H,2W,cout] (up2 = 1);
// part [nb,T,cin,cout] f32 scratch; dk [T,cin,cout] f32 with T = 9 or 16.
// Takes cin 1, 32 or 64 on the 3x3 taps, 64 on the Up2 taps (K2's input
// width), and cout 32 or 64.
int conv_dw_taps(const void* x, const void* g, int up2, void* part, void* dk, int B, int H,
                 int W, int cin, int cout, void* stream) {
  Params p{};
  p.x = static_cast<const bf16*>(x);
  p.g = static_cast<const bf16*>(g);
  p.part = static_cast<float*>(part);
  p.B = B;
  p.H = H;
  p.W = W;
  p.cin = cin;
  p.cout = cout;
  return run(up2 ? kDwUp2 : kDw3x3, p, static_cast<float*>(dk), stream);
}

// C2. x [B,H,W,cin], w [3,3,cin,cout] (HWIO), g [B,H,W,cout]; dx [B,H,W,cin];
// part [nb,9,cin,cout] f32 scratch; dk [3,3,cin,cout] f32. Takes cin and
// cout in {32, 64}.
int conv3x3_bwd_fused(const void* x, const void* w, const void* g, void* dx, void* part,
                      void* dk, int B, int H, int W, int cin, int cout, void* stream) {
  Params p{};
  p.x = static_cast<const bf16*>(x);
  p.g = static_cast<const bf16*>(g);
  p.w = static_cast<const bf16*>(w);
  p.dx = static_cast<bf16*>(dx);
  p.part = static_cast<float*>(part);
  p.B = B;
  p.H = H;
  p.W = W;
  p.cin = cin;
  p.cout = cout;
  return run(kFused, p, static_cast<float*>(dk), stream);
}

}  // extern "C"
