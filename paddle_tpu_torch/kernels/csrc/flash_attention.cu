// Flash attention for NVIDIA Hopper (sm_90a): forward, dq and dk/dv.
//
// Replaces the three TPU kernels of paddle_tpu/kernels/flash.py:
// - ptt_flash_fwd: `_fwd_kernel` (:202, launched by `_fwd` :299) —
//   online softmax over k tiles, returns o and the log-sum-exp lse;
// - ptt_flash_dq: `_dq_kernel` (:363, launched by `_bwd_impl` :486) —
//   dq from p = exp(s - lse) recomputed per tile;
// - ptt_flash_dkv: `_dkv_kernel` (:419, :532) — dk and dv, Q and dO
//   streaming past each k tile.
// Contract (flash_attention's, with equal head counts):
//   q, o, dO     [B, Tq, H, D]   f32 or bf16, one dtype for all operands
//   k, v         [B, Tk, H, D]
//   lse          [B, H, Tq] f32
//   q_seg/kv_seg [B, Tq] / [B, Tk] int32, or null
//   seed         [1] int32 (dropout only)
// A pair (q, k) is visible iff q < Tq, k < min(Tk, kv_len), k <= q when
// causal, and the segment ids are equal (flash_common.cuh `Mask`).
//
// What bounds them on the H100: operations. Per visible (q, k) pair and
// head the forward does 4*D FLOPs (q.k, p.v), dq 6*D and dk/dv 8*D, over
// operands read about once: at the training shape (bf16, T 2048, D 64,
// causal) the forward does 17.2 GFLOP over 10 MB, ~500 FLOPs per byte,
// above the card's ridge of ~295 for bf16. So the products must run on
// the tensor cores, and what is not a product (the exponential, the
// mask, the row reductions) must stay small beside them.
//
// Two designs, chosen by dtype in `launch` (a dispatch by type; a bf16
// launch that fails returns its error, nothing falls back):
// - bf16, all three (flash_tc.cuh, hopper.cuh): tensor cores.
//   `wgmma.mma_async` m64n64k16 bf16 -> f32 takes every product; TMA
//   brings K/V (forward, dq) or Q/dO (dk/dv) tiles into a ring of two or
//   three stages, 128-byte swizzled, bf16 (head dims padded with zeros
//   to 64, 128 or 256 in shared memory), so the next tile's copy
//   overlaps this tile's products; one barrier per tile frees a stage.
//   Forward: one CTA per (b * H + h, 128 query rows), two warpgroups of
//   64 rows; S = Q K^T from shared memory, the online softmax on the
//   accumulator fragments (row max and sum over the four threads of a
//   row), P rounded to bf16 in registers as the A operand of O += P V,
//   V read MN-major. dq: the same tiling with Q and dO resident; s and
//   dp = dO V^T from shared memory, ds rounded to bf16 in registers as
//   the A operand of dq += ds K, K read MN-major (at D 256 one 64-row
//   tile, its dq split over the two warpgroups by head dim). dk/dv: one
//   CTA per (b * H + h, k tile); the products are transposed,
//   s^T = K Q^T and dp^T = V dO^T, so g^T and ds^T leave the
//   accumulators as the register A operand of dV += g^T dO and
//   dK += ds^T Q; lse and delta of each q tile are staged beside it.
//   Causal q tiles of the forward and dq run longest first (the tile
//   index is reversed from blockIdx); dk/dv's k tile 0, its longest,
//   already runs first. The exponential is exp2 of log2(e)-prescaled
//   scores by ex2.approx: its ~2 ulp f32 error is far inside the bf16
//   bar, and one full-precision expf per visible pair would cost tens
//   of us, a large share of the whole forward at tensor-core rate. lse
//   stays the natural log: lse = m * ln 2 + log(l).
// - f32, all three: SIMT, one CTA of 256 threads per tile (64 x 64
//   tiles for D <= 128, 32 x 32 above), tiles staged as f32 in shared
//   memory, every product an f32 FMA on the CUDA cores. f32 stays there
//   because the tensor cores would compute it in TF32 (about 3 decimal
//   digits), and the f32 path is held to float32: 2e-6 for o and lse,
//   2e-5 for gradients, and the train_vs_plain step.
// Both designs loop inside the CTA over the tiles that can hold a
// visible pair (causal and kv_len bound the loop; a tile whose pairs are
// all masked, e.g. across segments, is skipped after one
// __syncthreads_or). No atomics and no split across CTAs: dq and dk/dv
// stay two kernels, so a launch gives the same bytes every time.
//
// Rounding points are the Pallas kernels': p rounded to the operand
// dtype before P.V (:255) while l sums the unrounded p (:249); ds and
// the dropped p (g) rounded before their products (:411, :463, :477);
// dq, dk, dv accumulate in f32 and are rounded once; masking by select
// to -1e30. Dropout: l sums the UNdropped p; only the accumulator sees
// keep * p * f32(1 / (1 - r)); kernels 5 and 6 drop dp (and kernel 6
// g) with the same keep bit (:247-253, :402-405, :457-463, :470-471),
// evaluated per element from its global (q, k). delta = sum(dO * o) has
// one summation order for kernels 5 and 6 (`quad_delta`). The SIMT
// kernels use expf/logf, never the fast intrinsics, and no fast-math
// flags.

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

using namespace ptt;
using namespace ptt::flash;

template <int BQ, int BK>
struct Tiles {
  static constexpr int RQ = BQ / 16;  // score rows per thread
  static constexpr int RK = BK / 16;  // score columns per thread
};

// -- kernel 4: forward --------------------------------------------------

__host__ __device__ inline size_t fwd_smem_floats(int BQ, int BK, int D) {
  const size_t ld = D + 1;
  return BQ * ld + 2 * BK * ld + (size_t)BQ * (BK + 1) + BQ + BK;
}

template <typename T, int BQ, int BK, int NJ>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const Args a) {
  constexpr int RQ = Tiles<BQ, BK>::RQ;
  constexpr int RK = Tiles<BQ, BK>::RK;
  const int D = a.head_dim, H = a.heads, ld = D + 1, lp = BK + 1;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  extern __shared__ float smem[];
  float* sq = smem;               // [BQ][ld]
  float* sk = sq + BQ * ld;       // [BK][ld]
  float* sv = sk + BK * ld;       // [BK][ld]
  float* sp = sv + BK * ld;       // [BQ][lp] p in the operand dtype
  int* qseg = reinterpret_cast<int*>(sp + BQ * lp);  // [BQ]
  int* kseg = qseg + BQ;                             // [BK]

  const Mask mask{a.t_q, a.limit, a.causal != 0};
  const Dropout drop(a, bh);
  load_tile<T, BQ>(static_cast<const T*>(a.q), sq, ld, b, h, q0, a.t_q, H, D);
  load_segs<BQ>(a.q_seg, qseg, b, q0, a.t_q);

  float acc[RQ][NJ];
  float m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) acc[i][jd] = 0.f;
  }

  int k_end = a.limit;
  if (a.causal) k_end = min(k_end, min(q0 + BQ, a.t_q));
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_segs<BK>(a.kv_seg, kseg, b, k0, a.t_k);
    __syncthreads();
    if (!tile_visible<RQ, RK>(mask, q0, k0, qseg, kseg)) continue;
    load_tile<T, BK>(static_cast<const T*>(a.k), sk, ld, b, h, k0, a.t_k, H,
                     D);
    load_tile<T, BK>(static_cast<const T*>(a.v), sv, ld, b, h, k0, a.t_k, H,
                     D);
    __syncthreads();

    float s[RQ][RK];
    dot_tile<RQ, RK>(sq, sk, ld, D, s);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int c = tx + 16 * j;
        s[i][j] = mask(q0 + r, k0 + c, qseg[r], kseg[c]) ? s[i][j] * a.scale
                                                         : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int c = tx + 16 * j;
        float p = expf(s[i][j] - m_new);
        sum += p;
        if (a.dropout)
          p = drop.keep(q0 + r, k0 + c) ? p * a.drop_scale : 0.f;
        sp[r * lp + c] = Traits<T>::round(p);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < NJ; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = sp[(ty + 16 * i) * lp + c];
#pragma unroll
        for (int jd = 0; jd < NJ; ++jd) {
          const int d = tx + 16 * jd;
          if (d < D) acc[i][jd] = fmaf(p, sv[c * ld + d], acc[i][jd]);
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out0);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.t_q) continue;
    const float lf = fmaxf(l[i], kLFloor);
    T* orow = out + row_offset(b, r, a.t_q, h, H, D);
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) {
      const int d = tx + 16 * jd;
      if (d < D) orow[d] = Traits<T>::store(acc[i][jd] / lf);
    }
    if (tx == 0) a.lse_out[(size_t)bh * a.t_q + r] = m[i] + logf(lf);
  }
}

// -- kernel 5: dq -------------------------------------------------------

__host__ __device__ inline size_t dq_smem_floats(int BQ, int BK, int D) {
  const size_t ld = D + 1;
  return 2 * BQ * ld + 2 * BK * ld + (size_t)BQ * (BK + 1) + BQ + BK;
}

template <typename T, int BQ, int BK, int NJ>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  constexpr int RQ = Tiles<BQ, BK>::RQ;
  constexpr int RK = Tiles<BQ, BK>::RK;
  const int D = a.head_dim, H = a.heads, ld = D + 1, lp = BK + 1;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  extern __shared__ float smem[];
  float* sq = smem;               // [BQ][ld]
  float* sdo = sq + BQ * ld;      // [BQ][ld]
  float* sk = sdo + BQ * ld;      // [BK][ld]
  float* sv = sk + BK * ld;       // [BK][ld]
  float* sds = sv + BK * ld;      // [BQ][lp] ds in the operand dtype
  int* qseg = reinterpret_cast<int*>(sds + BQ * lp);
  int* kseg = qseg + BQ;

  const Mask mask{a.t_q, a.limit, a.causal != 0};
  const Dropout drop(a, bh);
  load_tile<T, BQ>(static_cast<const T*>(a.q), sq, ld, b, h, q0, a.t_q, H, D);
  load_tile<T, BQ>(static_cast<const T*>(a.dout), sdo, ld, b, h, q0, a.t_q,
                   H, D);
  load_segs<BQ>(a.q_seg, qseg, b, q0, a.t_q);
  __syncthreads();

  float lse[RQ], delta[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + 16 * i;
    lse[i] = r < a.t_q ? a.lse[(size_t)bh * a.t_q + r] : 0.f;
  }
  row_delta<T, RQ>(a, b, h, q0, delta);

  float dq[RQ][NJ];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) dq[i][jd] = 0.f;

  int k_end = a.limit;
  if (a.causal) k_end = min(k_end, min(q0 + BQ, a.t_q));
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_segs<BK>(a.kv_seg, kseg, b, k0, a.t_k);
    __syncthreads();
    if (!tile_visible<RQ, RK>(mask, q0, k0, qseg, kseg)) continue;
    load_tile<T, BK>(static_cast<const T*>(a.k), sk, ld, b, h, k0, a.t_k, H,
                     D);
    load_tile<T, BK>(static_cast<const T*>(a.v), sv, ld, b, h, k0, a.t_k, H,
                     D);
    __syncthreads();

    float s[RQ][RK], dp[RQ][RK];
    dot_tile<RQ, RK>(sq, sk, ld, D, s);
    dot_tile<RQ, RK>(sdo, sv, ld, D, dp);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int c = tx + 16 * j;
        const float sc = mask(q0 + r, k0 + c, qseg[r], kseg[c])
                             ? s[i][j] * a.scale
                             : kNegInf;
        const float p = expf(sc - lse[i]);
        float dpv = dp[i][j];
        if (a.dropout)
          dpv = drop.keep(q0 + r, k0 + c) ? dpv * a.drop_scale : 0.f;
        sds[r * lp + c] = Traits<T>::round(p * (dpv - delta[i]));
      }
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float ds = sds[(ty + 16 * i) * lp + c];
#pragma unroll
        for (int jd = 0; jd < NJ; ++jd) {
          const int d = tx + 16 * jd;
          if (d < D) dq[i][jd] = fmaf(ds, sk[c * ld + d], dq[i][jd]);
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out0);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.t_q) continue;
    T* row = out + row_offset(b, r, a.t_q, h, H, D);
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) {
      const int d = tx + 16 * jd;
      if (d < D) row[d] = Traits<T>::store(a.scale * dq[i][jd]);
    }
  }
}

// -- kernel 6: dk and dv --------------------------------------------------

__host__ __device__ inline size_t dkv_smem_floats(int BQ, int BK, int D) {
  const size_t ld = D + 1;
  return 2 * BK * ld + 2 * BQ * ld + 2 * (size_t)BQ * (BK + 1) + BQ + BK;
}

template <typename T, int BQ, int BK, int NJ>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Args a) {
  constexpr int RQ = Tiles<BQ, BK>::RQ;
  constexpr int RK = Tiles<BQ, BK>::RK;
  const int D = a.head_dim, H = a.heads, ld = D + 1, lp = BK + 1;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  extern __shared__ float smem[];
  float* sk = smem;               // [BK][ld]
  float* sv = sk + BK * ld;       // [BK][ld]
  float* sq = sv + BK * ld;       // [BQ][ld]
  float* sdo = sq + BQ * ld;      // [BQ][ld]
  float* sg = sdo + BQ * ld;      // [BQ][lp] dropped p, operand dtype
  float* sds = sg + BQ * lp;      // [BQ][lp] ds, operand dtype
  int* qseg = reinterpret_cast<int*>(sds + BQ * lp);
  int* kseg = qseg + BQ;

  const Mask mask{a.t_q, a.limit, a.causal != 0};
  const Dropout drop(a, bh);
  load_tile<T, BK>(static_cast<const T*>(a.k), sk, ld, b, h, k0, a.t_k, H, D);
  load_tile<T, BK>(static_cast<const T*>(a.v), sv, ld, b, h, k0, a.t_k, H, D);
  load_segs<BK>(a.kv_seg, kseg, b, k0, a.t_k);

  // accumulators: rows ty + 16 i of the k tile, columns tx + 16 jd
  float dk[RK][NJ], dv[RK][NJ];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) {
      dk[i][jd] = 0.f;
      dv[i][jd] = 0.f;
    }

  // rows before the tile's first key see none of it when causal
  const int q_begin = a.causal ? (k0 / BQ) * BQ : 0;
  const int q_end = k0 < a.limit ? a.t_q : 0;
  for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
    __syncthreads();
    load_segs<BQ>(a.q_seg, qseg, b, q0, a.t_q);
    __syncthreads();
    if (!tile_visible<RQ, RK>(mask, q0, k0, qseg, kseg)) continue;
    load_tile<T, BQ>(static_cast<const T*>(a.q), sq, ld, b, h, q0, a.t_q, H,
                     D);
    load_tile<T, BQ>(static_cast<const T*>(a.dout), sdo, ld, b, h, q0, a.t_q,
                     H, D);
    __syncthreads();

    float lse[RQ], delta[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = q0 + ty + 16 * i;
      lse[i] = r < a.t_q ? a.lse[(size_t)bh * a.t_q + r] : 0.f;
    }
    row_delta<T, RQ>(a, b, h, q0, delta);
    float s[RQ][RK], dp[RQ][RK];
    dot_tile<RQ, RK>(sq, sk, ld, D, s);
    dot_tile<RQ, RK>(sdo, sv, ld, D, dp);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int c = tx + 16 * j;
        const float sc = mask(q0 + r, k0 + c, qseg[r], kseg[c])
                             ? s[i][j] * a.scale
                             : kNegInf;
        const float p = expf(sc - lse[i]);
        float g = p;
        float dpv = dp[i][j];
        if (a.dropout) {
          const bool keep = drop.keep(q0 + r, k0 + c);
          g = keep ? p * a.drop_scale : 0.f;
          dpv = keep ? dpv * a.drop_scale : 0.f;
        }
        sg[r * lp + c] = Traits<T>::round(g);
        sds[r * lp + c] = Traits<T>::round(p * (dpv - delta[i]));
      }
    }
    __syncthreads();

    for (int r = 0; r < BQ; ++r) {
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int c = ty + 16 * i;
        const float g = sg[r * lp + c];
        const float ds = sds[r * lp + c];
#pragma unroll
        for (int jd = 0; jd < NJ; ++jd) {
          const int d = tx + 16 * jd;
          if (d < D) {
            dv[i][jd] = fmaf(g, sdo[r * ld + d], dv[i][jd]);
            dk[i][jd] = fmaf(ds, sq[r * ld + d], dk[i][jd]);
          }
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(a.out0);
  T* dv_out = static_cast<T*>(a.out1);
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= a.t_k) continue;
    const size_t off = row_offset(b, c, a.t_k, h, H, D);
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) {
      const int d = tx + 16 * jd;
      if (d < D) {
        dk_out[off + d] = Traits<T>::store(a.scale * dk[i][jd]);
        dv_out[off + d] = Traits<T>::store(dv[i][jd]);
      }
    }
  }
}

// -- launch -------------------------------------------------------------

// NJ = ceil(D_max / 16) columns per thread, by head dim; the tile edge by
// NJ: 64 x 64 tiles for D <= 128, 32 x 32 above (the shared memory of
// kernel 6). The launch's template arguments and its dynamic shared memory
// both come from these two.
inline int nj_of(int head_dim) {
  return head_dim <= 64 ? 4 : head_dim <= 128 ? 8 : 16;
}
constexpr int tile_for(int nj) { return nj <= 8 ? 64 : 32; }

inline size_t smem_bytes(int which, int head_dim) {
  const int t = tile_for(nj_of(head_dim));
  const size_t f = which == kFwd  ? fwd_smem_floats(t, t, head_dim)
                   : which == kDq ? dq_smem_floats(t, t, head_dim)
                                  : dkv_smem_floats(t, t, head_dim);
  return f * sizeof(float);
}

template <typename Kernel>
int launch_kernel(Kernel kernel, dim3 grid, size_t smem, const Args& a,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// f32 only: bf16 is tc::launch's
template <int NJ>
int launch_f32(int which, const Args& a, int batch, cudaStream_t stream) {
  constexpr int BQ = tile_for(NJ), BK = tile_for(NJ);
  const size_t smem = smem_bytes(which, a.head_dim);
  const int bh = batch * a.heads;
  if (which == kFwd)
    return launch_kernel(fwd_kernel<float, BQ, BK, NJ>,
                         dim3((a.t_q + BQ - 1) / BQ, bh), smem, a, stream);
  if (which == kDkv)
    return launch_kernel(dkv_kernel<float, BQ, BK, NJ>,
                         dim3((a.t_k + BK - 1) / BK, bh), smem, a, stream);
  return launch_kernel(dq_kernel<float, BQ, BK, NJ>,
                       dim3((a.t_q + BQ - 1) / BQ, bh), smem, a, stream);
}

int launch(int which, Args a, int batch, int kv_len, int dtype,
           void* stream) {
  if (batch <= 0 || a.heads <= 0 || a.t_q <= 0 || a.t_k <= 0 ||
      a.head_dim <= 0 || a.head_dim % 8 != 0 || a.head_dim > 256 ||
      batch * a.heads > 65535)
    return (int)cudaErrorInvalidValue;
  // kv_len < 0: none given
  a.limit = (kv_len < 0 || kv_len > a.t_k) ? a.t_k : kv_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // bf16 on the tensor cores, f32 on the CUDA cores
  if (dtype == 1) return tc::launch(which, a, batch, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (nj_of(a.head_dim)) {
    case 4: return launch_f32<4>(which, a, batch, s);
    case 8: return launch_f32<8>(which, a, batch, s);
    default: return launch_f32<16>(which, a, batch, s);
  }
}

Args make_args(const void* q, const void* k, const void* v, const int* q_seg,
               const int* kv_seg, const int* seed, int heads, int t_q,
               int t_k, int head_dim, int causal, float scale,
               unsigned int threshold, float drop_scale, int dropout) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_seg = q_seg;
  a.kv_seg = kv_seg;
  a.seed = seed;
  a.heads = heads;
  a.t_q = t_q;
  a.t_k = t_k;
  a.head_dim = head_dim;
  a.causal = causal;
  a.dropout = dropout;
  a.scale = scale;
  a.threshold = threshold;
  a.drop_scale = drop_scale;
  return a;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA, bytes: which 0 = forward, 1 = dq,
// 2 = dk/dv.
size_t ptt_flash_smem_bytes(int which, int head_dim) {
  return smem_bytes(which, head_dim);
}

// The same for the bf16 tensor-core kernels.
size_t ptt_flash_tc_smem_bytes(int which, int head_dim) {
  return tc::smem(which, head_dim);
}

// All three: dtype 0 = float32, 1 = bfloat16; kv_len < 0 for none;
// dropout != 0 reads seed[0]. Return the cudaError_t of the launch (0 on
// success). They launch on `stream`, do not synchronise, allocate nothing.
int ptt_flash_fwd(const void* q, const void* k, const void* v,
                  const int* q_seg, const int* kv_seg, const int* seed,
                  void* out, float* lse, int batch, int heads, int t_q,
                  int t_k, int head_dim, int kv_len, int causal, float scale,
                  unsigned int threshold, float drop_scale, int dropout,
                  int dtype, void* stream) {
  Args a = make_args(q, k, v, q_seg, kv_seg, seed, heads, t_q, t_k, head_dim,
                     causal, scale, threshold, drop_scale, dropout);
  a.out0 = out;
  a.lse_out = lse;
  return launch(kFwd, a, batch, kv_len, dtype, stream);
}

int ptt_flash_dq(const void* q, const void* k, const void* v, const void* o,
                 const float* lse, const void* dout, const int* q_seg,
                 const int* kv_seg, const int* seed, void* dq, int batch,
                 int heads, int t_q, int t_k, int head_dim, int kv_len,
                 int causal, float scale, unsigned int threshold,
                 float drop_scale, int dropout, int dtype, void* stream) {
  Args a = make_args(q, k, v, q_seg, kv_seg, seed, heads, t_q, t_k, head_dim,
                     causal, scale, threshold, drop_scale, dropout);
  a.o = o;
  a.lse = lse;
  a.dout = dout;
  a.out0 = dq;
  return launch(kDq, a, batch, kv_len, dtype, stream);
}

int ptt_flash_dkv(const void* q, const void* k, const void* v, const void* o,
                  const float* lse, const void* dout, const int* q_seg,
                  const int* kv_seg, const int* seed, void* dk, void* dv,
                  int batch, int heads, int t_q, int t_k, int head_dim,
                  int kv_len, int causal, float scale, unsigned int threshold,
                  float drop_scale, int dropout, int dtype, void* stream) {
  Args a = make_args(q, k, v, q_seg, kv_seg, seed, heads, t_q, t_k, head_dim,
                     causal, scale, threshold, drop_scale, dropout);
  a.o = o;
  a.lse = lse;
  a.dout = dout;
  a.out0 = dk;
  a.out1 = dv;
  return launch(kDkv, a, batch, kv_len, dtype, stream);
}

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
