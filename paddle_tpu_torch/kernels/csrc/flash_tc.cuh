// The bf16 flash forward (kernel 4), dq (kernel 5) and dk/dv (kernel 6)
// on Hopper's tensor cores: wgmma m64n64k16 bf16 -> f32, operands brought
// in by TMA into a ring of three stages (two at head dims above 128, for
// shared memory), 128-byte swizzled (hopper.cuh). The design note is the
// header of flash_attention.cu.

#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

namespace ptt {
namespace flash {
namespace tc {

using namespace ptt::hopper;

constexpr int kTcThreads = 256;  // two warpgroups
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// atoms of 64 columns a head dim takes in shared memory: 1, 2 or 4
inline int atoms_of(int head_dim) {
  return head_dim <= 64 ? 1 : head_dim <= 128 ? 2 : 4;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The warpgroup's accumulator element idx of a m64n64 tile sits at row
// 16 * warp + lane / 4 + 8 * acc_half(idx) and column
// 8 * (idx / 4) + 2 * (lane % 4) + (idx % 2).
__device__ __forceinline__ int acc_half(int idx) { return (idx >> 1) & 1; }
__device__ __forceinline__ int acc_col(int idx, int lane) {
  return 8 * (idx >> 2) + 2 * (lane & 3) + (idx & 1);
}

// The A fragments of m64n64k16 for k steps 0..3 from a 64 x 64
// accumulator: k step kk takes columns 16 kk .. 16 kk + 15, which are the
// accumulator's n8 blocks 2 kk and 2 kk + 1. Rounded to bf16 (RNE).
__device__ __forceinline__ void to_a_frags(const float (&x)[32],
                                           uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      f[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ void fence_frags(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(f[kk][r])::"memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// acc = A B over the head dim: A rows at a_base, B rows at b_base, both
// K-major atoms (a_atom, b_atom bytes apart); NA * 4 k steps of 16.
template <int NA>
__device__ __forceinline__ void qk_product(float (&acc)[32], uint32_t a_base,
                                           uint32_t a_atom, uint32_t b_base,
                                           uint32_t b_atom) {
#pragma unroll
  for (int ks = 0; ks < 4 * NA; ++ks) {
    const uint32_t off = (ks % 4) * 32;  // 16 bf16 along the 128-byte row
    wgmma_ss(acc, desc(a_base + (ks / 4) * a_atom + off, 16),
             desc(b_base + (ks / 4) * b_atom + off, 16), ks > 0);
  }
}

// -- kernel 4: forward -------------------------------------------------------

template <int NA>
struct Fwd {
  static constexpr int BQ = 128, BK = 64;
  static constexpr int kStages = NA == 4 ? 2 : 3;  // K/V stages (smem)
  static constexpr int kQBytes = NA * BQ * kRowBytes;
  static constexpr int kKBytes = NA * BK * kRowBytes;  // K, and V after it
  static constexpr int kStageBytes = 2 * kKBytes;
  static constexpr size_t kSmem =
      1024 + kQBytes + kStages * kStageBytes + 8 * (1 + kStages);
};

// K and V of the 64 keys at k0 into a stage (kernels 4 and 5)
template <int NA>
__device__ __forceinline__ void issue_kv(uint8_t* stage, uint64_t* bar,
                                         const CUtensorMap* mk,
                                         const CUtensorMap* mv, int k0, int h,
                                         int b) {
  using C = Fwd<NA>;
  mbar_expect_tx(bar, C::kStageBytes);
#pragma unroll
  for (int at = 0; at < NA; ++at) {
    tma_load(stage + at * C::BK * kRowBytes, mk, bar, at * kAtomCols, h, k0,
             b);
    tma_load(stage + C::kKBytes + at * C::BK * kRowBytes, mv, bar,
             at * kAtomCols, h, k0, b);
  }
}

// One CTA per (b * H + h, q tile of 128 rows); warpgroup wg owns rows
// 64 wg .. 64 wg + 63. Scores and softmax in the log2 domain. At D <= 64
// two CTAs share an SM (128 registers a thread), so one CTA's softmax
// overlaps the other's products.
template <int NA>
__global__ void __launch_bounds__(kTcThreads, NA == 1 ? 2 : 1)
    fwd_tc_kernel(const Args a, const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv) {
  using C = Fwd<NA>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  uint8_t* sstage = sq + C::kQBytes;
  uint64_t* qbar =
      reinterpret_cast<uint64_t*>(sstage + C::kStages * C::kStageBytes);
  uint64_t* full = qbar + 1;

  const int H = a.heads, bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;  // longest first
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int qw0 = q0 + 64 * wg;
  const int r0 = qw0 + 16 * ((tid % 128) / 32) + lane / 4;  // and r0 + 8

  int k_end = a.limit;
  if (a.causal) k_end = min(k_end, min(q0 + C::BQ, a.t_q));
  const int n_tiles = k_end > 0 ? (k_end + C::BK - 1) / C::BK : 0;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < C::kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, C::kQBytes);
    for (int at = 0; at < NA; ++at)
      for (int r = 0; r < C::BQ; r += kBoxRows)
        tma_load(sq + (at * C::BQ + r) * kRowBytes, &mq, qbar,
                 at * kAtomCols, h, q0 + r, b);
    for (int i = 0; i < C::kStages - 1 && i < n_tiles; ++i)
      issue_kv<NA>(sstage + i * C::kStageBytes, &full[i], &mk, &mv,
                   i * C::BK, h, b);
  }

  const Mask mask{a.t_q, a.limit, a.causal != 0};
  const Dropout drop(a, bh);
  const bool segs = a.q_seg != nullptr;
  int qs[2] = {0, 0};
  if (segs)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      qs[hh] = r < a.t_q ? a.q_seg[(size_t)b * a.t_q + r] : 0;
    }
  const float sl2 = a.scale * kLog2e;
  float o[NA][32];
#pragma unroll
  for (int at = 0; at < NA; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[at][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t q_base = smem_u32(sq) + wg * 64 * kRowBytes;
  mbar_wait(qbar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * C::BK;
    // segments: does this thread's 2 x 16 share of the tile see a pair?
    int ks[16];
    bool any = true;
    if (segs) {
      any = false;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int c = k0 + acc_col(4 * (e / 2) + (e % 2), lane);
        ks[e] = c < a.t_k ? a.kv_seg[(size_t)b * a.t_k + c] : 0;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          any |= mask(r0 + 8 * hh, c, qs[hh], ks[e]);
      }
    }
    // every thread is done with tile i - 1, so its stage may be refilled
    any = __syncthreads_or(any) != 0;
    if (tid == 0 && i + C::kStages - 1 < n_tiles) {
      const int n = i + C::kStages - 1;
      issue_kv<NA>(sstage + (n % C::kStages) * C::kStageBytes,
                   &full[n % C::kStages], &mk, &mv, n * C::BK, h, b);
    }
    mbar_wait(&full[i % C::kStages], (i / C::kStages) & 1);
    // causal: a warpgroup whose rows all precede the tile sees none of it
    if (!any || (a.causal && k0 > qw0 + 63)) continue;

    uint8_t* sk = sstage + (i % C::kStages) * C::kStageBytes;
    const uint32_t sv = smem_u32(sk + C::kKBytes);
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    fence_acc(s);
    wgmma_fence();
    qk_product<NA>(s, q_base, C::BQ * kRowBytes, smem_u32(sk),
                   C::BK * kRowBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(s);

    const bool edge = segs || k0 + C::BK > a.limit ||
                      (a.causal && k0 + C::BK - 1 > qw0);
    // scores in log2 units, s * scale * log2(e): an edge tile scales and
    // masks them here; an inner tile folds the scale into the FFMA of the
    // exponent (the product rounds monotonically, so the row max is the
    // scaled max of the raw scores)
    float mx[2] = {kNegInf, kNegInf};
    if (edge) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hh = acc_half(e);
        float x = s[e] * sl2;
        if (!mask(r0 + 8 * hh, k0 + acc_col(e, lane), qs[hh],
                  segs ? ks[2 * (e / 4) + (e % 2)] : 0))
          x = kNegInf;
        s[e] = x;
        mx[hh] = fmaxf(mx[hh], x);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        mx[acc_half(e)] = fmaxf(mx[acc_half(e)], s[e]);
      mx[0] *= sl2;
      mx[1] *= sl2;
    }
    const float fold = edge ? 1.f : sl2;
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m[hh], quad_max(mx[hh]));
      alpha[hh] = exp2_approx(m[hh] - m_new);
      m[hh] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hh = acc_half(e);
      float p = exp2_approx(fmaf(s[e], fold, -m[hh]));
      sum[hh] += p;
      if (a.dropout)
        p = drop.keep(r0 + 8 * hh, k0 + acc_col(e, lane)) ? p * a.drop_scale
                                                          : 0.f;
      s[e] = p;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      l[hh] = alpha[hh] * l[hh] + quad_sum(sum[hh]);
#pragma unroll
    for (int at = 0; at < NA; ++at)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[at][e] *= alpha[acc_half(e)];
    uint32_t pa[4][4];
    to_a_frags(s, pa);

    fence_frags(pa);
#pragma unroll
    for (int at = 0; at < NA; ++at) fence_acc(o[at]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int at = 0; at < NA; ++at)
        wgmma_rs(o[at], pa[kk],
                 desc(sv + at * C::BK * kRowBytes + kk * 16 * kRowBytes,
                      C::BK * kRowBytes));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int at = 0; at < NA; ++at) fence_acc(o[at]);
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out0);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= a.t_q) continue;
    const float lf = fmaxf(l[hh], kLFloor);
    __nv_bfloat16* orow = out + row_offset(b, r, a.t_q, h, H, a.head_dim);
#pragma unroll
    for (int at = 0; at < NA; ++at)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = at * kAtomCols + acc_col(4 * j, lane);
        if (d < a.head_dim)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
              o[at][4 * j + 2 * hh] / lf, o[at][4 * j + 2 * hh + 1] / lf);
      }
    if ((lane & 3) == 0)
      a.lse_out[(size_t)bh * a.t_q + r] = m[hh] * kLn2 + logf(lf);
  }
}

// -- kernel 5: dq ------------------------------------------------------------

// NA = 1, 2: two warpgroups of 64 query rows each (BQ 128), each with
// the whole dq of its rows. NA = 4: one q tile of 64 rows; the two
// warpgroups split dq's head dim (each owns 2 atoms, 64 registers) and
// both compute the whole s and dp, as kernel 6 splits dk and dv.
template <int NA>
struct Dq {
  static constexpr int NRG = NA == 4 ? 1 : 2;  // row groups of 64
  static constexpr int NSPLIT = 2 / NRG;       // head-dim splits
  static constexpr int APW = NA / NSPLIT;      // atoms per warpgroup
  static constexpr int BQ = 64 * NRG, BK = 64;
  static constexpr int kStages = NA == 4 ? 2 : 3;  // K/V stages (smem)
  static constexpr int kQBytes = NA * BQ * kRowBytes;  // Q, and dO after it
  static constexpr int kKBytes = NA * BK * kRowBytes;  // K, and V after it
  static constexpr int kStageBytes = 2 * kKBytes;
  // Q, dO, the K/V ring, then lse * log2(e) and delta of the BQ rows
  static constexpr size_t kSmem = 1024 + 2 * kQBytes +
                                  kStages * kStageBytes + 8 * BQ +
                                  8 * (1 + kStages);
  static_assert(kStageBytes == Fwd<NA>::kStageBytes, "issue_kv's stage");
};

// One CTA per (b * H + h, q tile); causal q tiles run longest first.
// s = Q K^T and dp = dO V^T from shared memory; ds = p (dp - delta)
// leaves the accumulators as the register A operand of dq += ds K, K
// read MN-major from the same staged tile (the forward's P V with K in
// V's place), so ds never touches shared memory. Each CTA owns its dq
// rows and loops over k tiles in order: no atomics, the same bytes
// every launch.
template <int NA>
__global__ void __launch_bounds__(kTcThreads, 1)
    dq_tc_kernel(const Args a, const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mdo) {
  using C = Dq<NA>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  uint8_t* sdo = sq + C::kQBytes;
  uint8_t* sstage = sdo + C::kQBytes;
  float* row_lse2 =
      reinterpret_cast<float*>(sstage + C::kStages * C::kStageBytes);
  float* row_delta = row_lse2 + C::BQ;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(row_delta + C::BQ);
  uint64_t* full = qbar + 1;

  const int H = a.heads, bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;  // longest first
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int rg = wg % C::NRG, split = wg / C::NRG;
  const int qw0 = q0 + 64 * rg;
  const int lr0 = 64 * rg + 16 * ((tid % 128) / 32) + lane / 4;  // and +8
  const int r0 = q0 + lr0;

  int k_end = a.limit;
  if (a.causal) k_end = min(k_end, min(q0 + C::BQ, a.t_q));
  const int n_tiles = k_end > 0 ? (k_end + C::BK - 1) / C::BK : 0;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < C::kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, 2 * C::kQBytes);
    for (int at = 0; at < NA; ++at)
      for (int r = 0; r < C::BQ; r += kBoxRows) {
        tma_load(sq + (at * C::BQ + r) * kRowBytes, &mq, qbar,
                 at * kAtomCols, h, q0 + r, b);
        tma_load(sdo + (at * C::BQ + r) * kRowBytes, &mdo, qbar,
                 at * kAtomCols, h, q0 + r, b);
      }
    for (int i = 0; i < C::kStages - 1 && i < n_tiles; ++i)
      issue_kv<NA>(sstage + i * C::kStageBytes, &full[i], &mk, &mv,
                   i * C::BK, h, b);
  }
  // lse * log2(e) and delta of the CTA's rows, a quad of threads per row
  // (kernel 6's order, dkv_stage_rows), while the copies land
  for (int row = tid / 4; row < C::BQ; row += kTcThreads / 4) {
    const int q = q0 + row;
    const bool valid = q < a.t_q;
    const size_t off = row_offset(b, valid ? q : 0, a.t_q, h, H, a.head_dim);
    const float dl = quad_delta(static_cast<const __nv_bfloat16*>(a.o) + off,
                                static_cast<const __nv_bfloat16*>(a.dout) + off,
                                a.head_dim, valid);
    if ((tid & 3) == 0) {
      row_lse2[row] = valid ? a.lse[(size_t)bh * a.t_q + q] * kLog2e : 0.f;
      row_delta[row] = dl;
    }
  }
  __syncthreads();
  const float lse2[2] = {row_lse2[lr0], row_lse2[lr0 + 8]};
  const float delta[2] = {row_delta[lr0], row_delta[lr0 + 8]};

  const Mask mask{a.t_q, a.limit, a.causal != 0};
  const Dropout drop(a, bh);
  const bool segs = a.q_seg != nullptr;
  int qs[2] = {0, 0};
  if (segs)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      qs[hh] = r < a.t_q ? a.q_seg[(size_t)b * a.t_q + r] : 0;
    }
  const float sl2 = a.scale * kLog2e;
  float dq[C::APW][32];
#pragma unroll
  for (int at = 0; at < C::APW; ++at)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[at][e] = 0.f;
  const uint32_t q_base = smem_u32(sq) + rg * 64 * kRowBytes;
  const uint32_t do_base = smem_u32(sdo) + rg * 64 * kRowBytes;
  mbar_wait(qbar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * C::BK;
    int ks[16];
    bool any = true;
    if (segs) {
      any = false;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int c = k0 + acc_col(4 * (e / 2) + (e % 2), lane);
        ks[e] = c < a.t_k ? a.kv_seg[(size_t)b * a.t_k + c] : 0;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          any |= mask(r0 + 8 * hh, c, qs[hh], ks[e]);
      }
    }
    // every thread is done with tile i - 1, so its stage may be refilled
    any = __syncthreads_or(any) != 0;
    if (tid == 0 && i + C::kStages - 1 < n_tiles) {
      const int n = i + C::kStages - 1;
      issue_kv<NA>(sstage + (n % C::kStages) * C::kStageBytes,
                   &full[n % C::kStages], &mk, &mv, n * C::BK, h, b);
    }
    mbar_wait(&full[i % C::kStages], (i / C::kStages) & 1);
    // causal: a warpgroup whose rows all precede the tile sees none of it
    if (!any || (a.causal && k0 > qw0 + 63)) continue;

    uint8_t* sk = sstage + (i % C::kStages) * C::kStageBytes;
    const uint32_t sku = smem_u32(sk), sv = sku + C::kKBytes;
    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] = 0.f;
      dp[e] = 0.f;
    }
    fence_acc(s);
    fence_acc(dp);
    wgmma_fence();
    qk_product<NA>(s, q_base, C::BQ * kRowBytes, sku, C::BK * kRowBytes);
    qk_product<NA>(dp, do_base, C::BQ * kRowBytes, sv, C::BK * kRowBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(s);
    fence_acc(dp);

    const bool edge = segs || k0 + C::BK > a.limit ||
                      (a.causal && k0 + C::BK - 1 > qw0);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hh = acc_half(e), kpos = k0 + acc_col(e, lane);
      const int qpos = r0 + 8 * hh;
      // a masked score (-1e30) gives p = 0 exactly; select it
      float p = exp2_approx(fmaf(s[e], sl2, -lse2[hh]));
      if (edge &&
          !mask(qpos, kpos, qs[hh], segs ? ks[2 * (e / 4) + (e % 2)] : 0))
        p = 0.f;
      float dpv = dp[e];
      if (a.dropout) dpv = drop.keep(qpos, kpos) ? dpv * a.drop_scale : 0.f;
      s[e] = p * (dpv - delta[hh]);
    }
    uint32_t dsa[4][4];
    to_a_frags(s, dsa);

    fence_frags(dsa);
#pragma unroll
    for (int at = 0; at < C::APW; ++at) fence_acc(dq[at]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int at = 0; at < C::APW; ++at)
        wgmma_rs(dq[at], dsa[kk],
                 desc(sku + (split * C::APW + at) * C::BK * kRowBytes +
                          kk * 16 * kRowBytes,
                      C::BK * kRowBytes));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int at = 0; at < C::APW; ++at) fence_acc(dq[at]);
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out0);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= a.t_q) continue;
    __nv_bfloat16* row = out + row_offset(b, r, a.t_q, h, H, a.head_dim);
#pragma unroll
    for (int at = 0; at < C::APW; ++at)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = (split * C::APW + at) * kAtomCols + acc_col(4 * j, lane);
        if (d >= a.head_dim) continue;
        const int e = 4 * j + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(row + d) =
            __floats2bfloat162_rn(a.scale * dq[at][e], a.scale * dq[at][e + 1]);
      }
  }
}

// -- kernel 6: dk and dv -----------------------------------------------------

// NA = 1: two warpgroups of 64 keys each (BK 128). NA = 2, 4: one k tile
// of 64 keys; the two warpgroups split the head dim of dk and dv (each
// owns NA / 2 atoms) and both compute the whole s and dp.
template <int NA>
struct Dkv {
  static constexpr int NKG = NA == 1 ? 2 : 1;  // key groups of 64
  static constexpr int NSPLIT = 2 / NKG;       // head-dim splits
  static constexpr int APW = NA / NSPLIT;      // atoms per warpgroup
  static constexpr int BK = 64 * NKG, BQ = 64;
  static constexpr int kStages = NA == 4 ? 2 : 3;  // Q/dO stages (smem)
  static constexpr int kKBytes = NA * BK * kRowBytes;  // K, and V after it
  static constexpr int kQBytes = NA * BQ * kRowBytes;  // Q, and dO after it
  // Q, dO, then lse * log2(e) and delta of the tile's BQ rows (f32)
  static constexpr int kStageBytes = 2 * kQBytes + 1024;
  static constexpr size_t kSmem =
      1024 + 2 * kKBytes + kStages * kStageBytes + 8 * (1 + kStages);
  static_assert(kTcThreads / 4 == BQ, "one quad of threads per q row");
};

template <int NA>
__device__ __forceinline__ void dkv_issue_qdo(uint8_t* stage, uint64_t* bar,
                                              const CUtensorMap* mq,
                                              const CUtensorMap* mdo, int q0,
                                              int h, int b) {
  using C = Dkv<NA>;
  mbar_expect_tx(bar, 2 * C::kQBytes);
#pragma unroll
  for (int at = 0; at < NA; ++at) {
    tma_load(stage + at * C::BQ * kRowBytes, mq, bar, at * kAtomCols, h, q0,
             b);
    tma_load(stage + C::kQBytes + at * C::BQ * kRowBytes, mdo, bar,
             at * kAtomCols, h, q0, b);
  }
}

// lse * log2(e) and delta of rows q0 .. q0 + BQ - 1 into the stage (a
// quad of threads per row; 0 past Tq).
template <int NA>
__device__ __forceinline__ void dkv_stage_rows(const Args& a, uint8_t* stage,
                                               int b, int h, int bh, int q0) {
  using C = Dkv<NA>;
  float* lse2 = reinterpret_cast<float*>(stage + 2 * C::kQBytes);
  float* delta = lse2 + C::BQ;
  const int row = threadIdx.x / 4, q = q0 + row;
  const bool valid = q < a.t_q;
  const size_t off =
      row_offset(b, valid ? q : 0, a.t_q, h, a.heads, a.head_dim);
  const float dl = quad_delta(static_cast<const __nv_bfloat16*>(a.o) + off,
                              static_cast<const __nv_bfloat16*>(a.dout) + off,
                              a.head_dim, valid);
  if ((threadIdx.x & 3) == 0) {
    lse2[row] = valid ? a.lse[(size_t)bh * a.t_q + q] * kLog2e : 0.f;
    delta[row] = dl;
  }
}

// One CTA per (b * H + h, k tile). The products are taken transposed,
// s^T = K Q^T and dp^T = V dO^T, so that g^T and ds^T come out of the
// accumulators as the register A operand of dV += g^T dO and
// dK += ds^T Q.
template <int NA>
__global__ void __launch_bounds__(kTcThreads, 1)
    dkv_tc_kernel(const Args a, const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const __grid_constant__ CUtensorMap mdo) {
  using C = Dkv<NA>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* skv = align1024(smem_raw);
  uint8_t* sstage = skv + 2 * C::kKBytes;
  uint64_t* kvbar =
      reinterpret_cast<uint64_t*>(sstage + C::kStages * C::kStageBytes);
  uint64_t* full = kvbar + 1;

  const int H = a.heads, bh = blockIdx.x, b = bh / H, h = bh % H;
  // causal: the k tile at 0 sees the most q tiles, and runs first
  const int k0 = blockIdx.y * C::BK;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int kg = wg % C::NKG, split = wg / C::NKG;
  const int kw0 = k0 + 64 * kg;
  const int r0 = kw0 + 16 * ((tid % 128) / 32) + lane / 4;  // and r0 + 8

  const int q_begin = a.causal ? k0 : 0;
  const int q_end = k0 < a.limit ? a.t_q : 0;
  const int n_tiles =
      q_end > q_begin ? (q_end - q_begin + C::BQ - 1) / C::BQ : 0;

  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < C::kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kvbar, 2 * C::kKBytes);
    for (int at = 0; at < NA; ++at)
      for (int r = 0; r < C::BK; r += kBoxRows) {
        tma_load(skv + (at * C::BK + r) * kRowBytes, &mk, kvbar,
                 at * kAtomCols, h, k0 + r, b);
        tma_load(skv + C::kKBytes + (at * C::BK + r) * kRowBytes, &mv, kvbar,
                 at * kAtomCols, h, k0 + r, b);
      }
    for (int i = 0; i < C::kStages - 1 && i < n_tiles; ++i)
      dkv_issue_qdo<NA>(sstage + i * C::kStageBytes, &full[i], &mq, &mdo,
                        q_begin + i * C::BQ, h, b);
  }
  for (int i = 0; i < C::kStages - 1 && i < n_tiles; ++i)
    dkv_stage_rows<NA>(a, sstage + i * C::kStageBytes, b, h, bh,
                       q_begin + i * C::BQ);

  const Mask mask{a.t_q, a.limit, a.causal != 0};
  const Dropout drop(a, bh);
  const bool segs = a.q_seg != nullptr;
  int kseg[2] = {0, 0};
  if (segs)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      kseg[hh] = r < a.t_k ? a.kv_seg[(size_t)b * a.t_k + r] : 0;
    }
  const float sl2 = a.scale * kLog2e;
  float dk[C::APW][32], dv[C::APW][32];
#pragma unroll
  for (int at = 0; at < C::APW; ++at)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      dk[at][e] = 0.f;
      dv[at][e] = 0.f;
    }
  const uint32_t k_base = smem_u32(skv) + kg * 64 * kRowBytes;
  const uint32_t v_base = k_base + C::kKBytes;
  mbar_wait(kvbar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = q_begin + i * C::BQ;
    int qs[16];
    bool any = true;
    if (segs) {
      any = false;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int c = q0 + acc_col(4 * (e / 2) + (e % 2), lane);
        qs[e] = c < a.t_q ? a.q_seg[(size_t)b * a.t_q + c] : 0;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          any |= mask(c, r0 + 8 * hh, qs[e], kseg[hh]);
      }
    }
    any = __syncthreads_or(any) != 0;
    // the tile kStages - 1 ahead: its copy now, its lse and delta while
    // this tile's products run
    const int n = i + C::kStages - 1;
    uint8_t* next = sstage + (n % C::kStages) * C::kStageBytes;
    if (tid == 0 && n < n_tiles)
      dkv_issue_qdo<NA>(next, &full[n % C::kStages], &mq, &mdo,
                        q_begin + n * C::BQ, h, b);
    mbar_wait(&full[i % C::kStages], (i / C::kStages) & 1);
    // causal: a warpgroup whose keys all follow the tile's rows
    if (!any || (a.causal && q0 + C::BQ - 1 < kw0)) {
      if (n < n_tiles)
        dkv_stage_rows<NA>(a, next, b, h, bh, q_begin + n * C::BQ);
      continue;
    }

    uint8_t* st = sstage + (i % C::kStages) * C::kStageBytes;
    const uint32_t sq = smem_u32(st), sdo = sq + C::kQBytes;
    const float* lse2 = reinterpret_cast<const float*>(st + 2 * C::kQBytes);
    const float* delta = lse2 + C::BQ;
    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] = 0.f;
      dp[e] = 0.f;
    }
    fence_acc(s);
    fence_acc(dp);
    wgmma_fence();
    qk_product<NA>(s, k_base, C::BK * kRowBytes, sq, C::BQ * kRowBytes);
    qk_product<NA>(dp, v_base, C::BK * kRowBytes, sdo, C::BQ * kRowBytes);
    wgmma_commit();
    if (n < n_tiles)
      dkv_stage_rows<NA>(a, next, b, h, bh, q_begin + n * C::BQ);
    wgmma_wait_all();
    fence_acc(s);
    fence_acc(dp);

    const bool edge = segs || kw0 + 64 > a.limit || q0 + C::BQ > a.t_q ||
                      (a.causal && q0 < kw0 + 63);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hh = acc_half(e), cl = acc_col(e, lane);
      const int kpos = r0 + 8 * hh, qpos = q0 + cl;
      // a masked score (-1e30) gives p = 0 exactly; select it
      float p = exp2_approx(fmaf(s[e], sl2, -lse2[cl]));
      if (edge &&
          !mask(qpos, kpos, segs ? qs[2 * (e / 4) + (e % 2)] : 0, kseg[hh]))
        p = 0.f;
      float g = p, dpv = dp[e];
      if (a.dropout) {
        const bool keep = drop.keep(qpos, kpos);
        g = keep ? p * a.drop_scale : 0.f;
        dpv = keep ? dpv * a.drop_scale : 0.f;
      }
      s[e] = g;
      dp[e] = p * (dpv - delta[cl]);
    }
    uint32_t ga[4][4], dsa[4][4];
    to_a_frags(s, ga);
    to_a_frags(dp, dsa);

    fence_frags(ga);
    fence_frags(dsa);
#pragma unroll
    for (int at = 0; at < C::APW; ++at) {
      fence_acc(dk[at]);
      fence_acc(dv[at]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int at = 0; at < C::APW; ++at) {
        const uint32_t off =
            (split * C::APW + at) * C::BQ * kRowBytes + kk * 16 * kRowBytes;
        wgmma_rs(dv[at], ga[kk], desc(sdo + off, C::BQ * kRowBytes));
        wgmma_rs(dk[at], dsa[kk], desc(sq + off, C::BQ * kRowBytes));
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int at = 0; at < C::APW; ++at) {
      fence_acc(dk[at]);
      fence_acc(dv[at]);
    }
  }

  __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(a.out0);
  __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(a.out1);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= a.t_k) continue;
    const size_t off = row_offset(b, r, a.t_k, h, H, a.head_dim);
#pragma unroll
    for (int at = 0; at < C::APW; ++at)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = (split * C::APW + at) * kAtomCols + acc_col(4 * j, lane);
        if (d >= a.head_dim) continue;
        const int e = 4 * j + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(dk_out + off + d) =
            __floats2bfloat162_rn(a.scale * dk[at][e], a.scale * dk[at][e + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv_out + off + d) =
            __floats2bfloat162_rn(dv[at][e], dv[at][e + 1]);
      }
  }
}

// -- launch -------------------------------------------------------------------

template <int NA>
size_t smem_of(int which) {
  return which == kFwd  ? Fwd<NA>::kSmem
         : which == kDq ? Dq<NA>::kSmem
                        : Dkv<NA>::kSmem;
}

inline size_t smem(int which, int head_dim) {
  switch (atoms_of(head_dim)) {
    case 1: return smem_of<1>(which);
    case 2: return smem_of<2>(which);
    default: return smem_of<4>(which);
  }
}

template <typename Kernel, typename... Maps>
int launch_tc(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
              const Args& a, const Maps&... maps) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kTcThreads, smem, stream>>>(a, maps...);
  return (int)cudaGetLastError();
}

// The tensor maps of q, k, v and (backward) dO; returns 0 or an error.
inline int make_maps(const Args& a, int batch, bool with_do, CUtensorMap* mq,
                     CUtensorMap* mk, CUtensorMap* mv, CUtensorMap* mdo) {
  int rc = make_map(mq, a.q, batch, a.t_q, a.heads, a.head_dim);
  if (rc == 0) rc = make_map(mk, a.k, batch, a.t_k, a.heads, a.head_dim);
  if (rc == 0) rc = make_map(mv, a.v, batch, a.t_k, a.heads, a.head_dim);
  if (rc == 0 && with_do)
    rc = make_map(mdo, a.dout, batch, a.t_q, a.heads, a.head_dim);
  return rc;
}

template <int NA>
int launch_na(int which, const Args& a, int batch, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  const int rc = make_maps(a, batch, which != kFwd, &mq, &mk, &mv, &mdo);
  if (rc != 0) return rc;
  const size_t smem = smem_of<NA>(which);
  const int bh = batch * a.heads;
  if (which == kFwd)
    return launch_tc(fwd_tc_kernel<NA>,
                     dim3(bh, (a.t_q + Fwd<NA>::BQ - 1) / Fwd<NA>::BQ), smem,
                     stream, a, mq, mk, mv);
  if (which == kDq)
    return launch_tc(dq_tc_kernel<NA>,
                     dim3(bh, (a.t_q + Dq<NA>::BQ - 1) / Dq<NA>::BQ), smem,
                     stream, a, mq, mk, mv, mdo);
  return launch_tc(dkv_tc_kernel<NA>,
                   dim3(bh, (a.t_k + Dkv<NA>::BK - 1) / Dkv<NA>::BK), smem,
                   stream, a, mq, mk, mv, mdo);
}

// kernel 4, 5 or 6 (which: kFwd, kDq, kDkv), bf16
inline int launch(int which, const Args& a, int batch, cudaStream_t stream) {
  switch (atoms_of(a.head_dim)) {
    case 1: return launch_na<1>(which, a, batch, stream);
    case 2: return launch_na<2>(which, a, batch, stream);
    default: return launch_na<4>(which, a, batch, stream);
  }
}

}  // namespace tc
}  // namespace flash
}  // namespace ptt
