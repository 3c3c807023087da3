// Shared pieces of the port's flash-attention kernels for NVIDIA Hopper
// (sm_90a): the forward (kernel 4), dq (kernel 5) and dk/dv (kernel 6) of
// flash_attention.cu.
//
// Operands keep the port's public layout [B, T, H, D] and are read in
// place; the head index of the dropout hash is the flattened b * H + h of
// the TPU kernels' [BH, T, D] layout (paddle_tpu/kernels/flash.py:666).
//
// Every CTA runs 256 threads as a 16 x 16 grid (tx, ty). A thread owns
// the rows ty + 16 i of a tile and, for scores, the columns tx + 16 j; the
// 16 threads of one row sit in one half-warp, so row reductions are four
// xor-shuffles and every lane ends with the same bits.
//
// What the three kernels share, so that they agree on every (q, k) pair:
// - `Mask`: the pair is visible iff q < Tq, k < min(Tk, kv_len),
//   k <= q when causal, and q_seg == kv_seg (flash.py _block_mask :156).
//   A tile with no visible pair is skipped (flash.py _contributes :184):
//   that never changes a row that has a visible key, because the online
//   softmax's alpha = 0 wipes any masked entries seen before its first
//   visible one.
// - `Dropout`: the murmur3-finalizer hash of (seed, b * H + h, q, k)
//   (flash.py _mix32/_dropout_keep :134-153), bit for bit, with the
//   threshold uint32(rate * 2^32) computed on the host.
// - `quad_delta`: sum over d of dO * O in f32 for each query row, one
//   summation order, so kernels 5 and 6 use the same number.
// Scores are f32 and masked by SELECT to -1e30 (flash.py:59).

#pragma once

#include "dtype.cuh"

namespace ptt {
namespace flash {

constexpr int kThreads = 256;

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };
constexpr float kNegInf = -1e30f;
constexpr float kLFloor = 1e-30f;

struct Args {
  const void* q;        // [B, Tq, H, D]
  const void* k;        // [B, Tk, H, D]
  const void* v;        // [B, Tk, H, D]
  const void* o;        // [B, Tq, H, D]   (kernels 5, 6)
  const float* lse;     // [B, H, Tq] f32  (out of kernel 4, in of 5, 6)
  const void* dout;     // [B, Tq, H, D]   (kernels 5, 6)
  const int* q_seg;     // [B, Tq] int32 or null
  const int* kv_seg;    // [B, Tk] int32 or null
  const int* seed;      // [1] int32, read when dropout is on
  void* out0;           // o (4), dq (5), dk (6)
  void* out1;           // dv (6)
  float* lse_out;       // lse (4)
  int heads, t_q, t_k, head_dim;
  int limit;            // min(Tk, kv_len)
  int causal, dropout;
  float scale;
  uint32_t threshold;   // uint32(rate * 2^32)
  float drop_scale;     // f32(1 / (1 - rate))
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

struct Dropout {
  uint32_t key;
  uint32_t threshold;

  __device__ Dropout(const Args& a, int bh)
      : key(a.dropout ? mix32((uint32_t)a.seed[0] + (uint32_t)bh * 0xC2B2AE3Du)
                      : 0u),
        threshold(a.threshold) {}

  __device__ __forceinline__ bool keep(int qpos, int kpos) const {
    const uint32_t u = mix32(
        ((uint32_t)qpos * 0x9E3779B1u + (uint32_t)kpos * 0x85EBCA77u) ^ key);
    return u >= threshold;
  }
};

struct Mask {
  int t_q, limit;
  bool causal;

  __device__ __forceinline__ bool operator()(int qpos, int kpos, int qseg,
                                             int kseg) const {
    return qpos < t_q && kpos < limit && (!causal || kpos <= qpos) &&
           qseg == kseg;
  }
};

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Offset of row t, head h, column 0 of a [B, T, H, D] tensor.
__device__ __forceinline__ size_t row_offset(int b, int t, int T, int h,
                                             int H, int D) {
  return (((size_t)b * T + t) * H + h) * D;
}

// Rows [row0, row0 + ROWS) of x at (b, h) into dst[ROWS][ld] as f32 with
// 16-byte loads; rows at or past T are zero.
template <typename T, int ROWS>
__device__ __forceinline__ void load_tile(const T* x, float* dst, int ld,
                                          int b, int h, int row0, int rows_t,
                                          int H, int D) {
  constexpr int kVec = Traits<T>::kVec;
  const int dvecs = D / kVec;
  for (int idx = threadIdx.x; idx < ROWS * dvecs; idx += kThreads) {
    const int r = idx / dvecs;
    const int c = (idx % dvecs) * kVec;
    float tmp[kVec];
    if (row0 + r < rows_t) {
      Traits<T>::load(x + row_offset(b, row0 + r, rows_t, h, H, D) + c, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[r * ld + c + e] = tmp[e];
  }
}

// Segment ids of rows [row0, row0 + ROWS) of batch b (0 without ids).
template <int ROWS>
__device__ __forceinline__ void load_segs(const int* seg, int* dst, int b,
                                          int row0, int rows_t) {
  for (int r = threadIdx.x; r < ROWS; r += kThreads)
    dst[r] = (seg != nullptr && row0 + r < rows_t)
                 ? seg[(size_t)b * rows_t + row0 + r]
                 : 0;
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over smem tiles of
// leading dimension ld.
template <int RQ, int RK>
__device__ __forceinline__ void dot_tile(const float* a, const float* b,
                                         int ld, int D, float (&s)[RQ][RK]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float bv[RK];
#pragma unroll
    for (int j = 0; j < RK; ++j) bv[j] = b[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float av = a[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = fmaf(av, bv[j], s[i][j]);
    }
  }
}

// Is any pair of this thread's score micro-tile visible? Call with every
// thread of the CTA; the result is the CTA's (__syncthreads_or).
template <int RQ, int RK>
__device__ __forceinline__ bool tile_visible(const Mask& mask, int q0, int k0,
                                             const int* qseg,
                                             const int* kseg) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  bool any = false;
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j)
      any |= mask(q0 + ty + 16 * i, k0 + tx + 16 * j, qseg[ty + 16 * i],
                  kseg[tx + 16 * j]);
  return __syncthreads_or(any) != 0;
}

// delta = sum over d of dO[d] * O[d] in f32 for one query row, by the
// four consecutive lanes of a quad: lane j = lane & 3 sums the 8-column
// chunks j, j + 4, j + 8, ... in column order with fmaf, then the quad
// adds (s0 + s1) + (s2 + s3), so every lane ends with the same bits. The
// one summation order of delta: kernels 5 and 6 (SIMT and tensor-core)
// all take it from here. Call with whole warps; `valid` false gives 0
// and reads nothing.
template <typename T>
__device__ __forceinline__ float quad_delta(const T* o_row, const T* do_row,
                                            int D, bool valid) {
  constexpr int kVec = Traits<T>::kVec;
  float acc = 0.f;
  if (valid) {
    for (int c = (threadIdx.x & 3) * 8; c < D; c += 32) {
#pragma unroll
      for (int v = 0; v < 8; v += kVec) {
        float x[kVec], y[kVec];
        Traits<T>::load(do_row + c + v, x);
        Traits<T>::load(o_row + c + v, y);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc = fmaf(x[e], y[e], acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// delta of the rows q0 + ty + 16 i (the SIMT kernels' rows); 0 past Tq.
template <typename T, int RQ>
__device__ __forceinline__ void row_delta(const Args& a, int b, int h, int q0,
                                          float (&delta)[RQ]) {
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + 16 * i;
    const bool valid = r < a.t_q;
    const size_t off =
        row_offset(b, valid ? r : 0, a.t_q, h, a.heads, a.head_dim);
    delta[i] = quad_delta(static_cast<const T*>(a.o) + off,
                          static_cast<const T*>(a.dout) + off, a.head_dim,
                          valid);
  }
}

}  // namespace flash
}  // namespace ptt
