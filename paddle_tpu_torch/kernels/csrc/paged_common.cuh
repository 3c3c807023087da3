// Shared pieces of the port's paged-attention kernels for NVIDIA Hopper
// (sm_90a): ragged_paged_attention.cu (the serve step's fp and mixed
// kernels) and paged_attention.cu (single-token decode).
//
// One CTA holds a set of query rows in shared memory and walks K/V
// blocks of one kv head in a loop. For each block it stages K and V into
// shared memory as f32 (stage_block) and runs the online-softmax update
// (block_update). Both kernels use these same two functions, so every
// kernel does the same arithmetic on the same staged values. That is
// what makes the mixed kernel's direct int8 read bit-equal to the fp
// kernel over pools into which the same blocks were promoted with
// dequantize_block.
//
// Numerics follow the TPU kernels (paddle_tpu/kernels/paged_attention.py
// _paged_kernel :173, _ragged_tile_update :387): f32 scores, mask by
// SELECT to -1e9 (masked lanes underflow to exact zeros), f32 online
// softmax with expf (never __expf), p rounded to the pool dtype before
// P.V while l sums the unrounded p, output acc / max(l, 1e-30). No
// fast-math flags.

#pragma once

#include "dtype.cuh"

namespace ptt {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e9f;
constexpr float kLFloor = 1e-30f;
// f32(1/127) rounded once, as RQMAX in quant/int8_compute.py: dequant is
// (int8 -> f32) * (scale * kRqmax), never a division by 127
constexpr float kRqmax = 0x1.020408p-7f;

// kVec int8 values (one load of 4 or 8 bytes) as exact floats
template <int N>
__device__ __forceinline__ void load_int8(const int8_t* src, float* dst) {
#pragma unroll
  for (int h = 0; h < N; h += 4) {
    const char4 v = *reinterpret_cast<const char4*>(src + h);
    dst[h] = __int2float_rn(v.x);
    dst[h + 1] = __int2float_rn(v.y);
    dst[h + 2] = __int2float_rn(v.z);
    dst[h + 3] = __int2float_rn(v.w);
  }
}

// Shared memory, in floats: q [rows][D+1], k [BS][D+1], v [BS][D],
// scores [rows][BS], acc [rows][D], m/l/alpha [rows]. The +1 pads the
// rows the score loop reads down a column, to spread them over banks.
__host__ __device__ inline size_t smem_floats(int rows, int head_dim,
                                              int block_size) {
  const size_t dp = head_dim + 1;
  return rows * dp + block_size * dp + (size_t)block_size * head_dim +
         (size_t)rows * block_size + (size_t)rows * head_dim + 3 * rows;
}

struct Smem {
  float* q;      // [rows][D+1]
  float* k;      // [BS][D+1]
  float* v;      // [BS][D]
  float* s;      // [rows][BS]
  float* acc;    // [rows][D]
  float* m;      // [rows]
  float* l;      // [rows]
  float* alpha;  // [rows]

  __device__ Smem(float* base, int rows, int D, int BS) {
    q = base;
    k = q + rows * (D + 1);
    v = k + BS * (D + 1);
    s = v + BS * D;
    acc = s + rows * BS;
    m = acc + rows * D;
    l = m + rows;
    alpha = l + rows;
  }
};

// Query row r = i * groups + g is query token `token0 + i`, head
// kvh * groups + g of q [.., H, D]; zero the accumulator and m/l.
template <typename T>
__device__ __forceinline__ void load_queries(const T* q, const Smem& sm,
                                             int token0, int rows,
                                             int groups, int num_heads,
                                             int kvh, int D) {
  constexpr int kVec = Traits<T>::kVec;
  const int dvecs = D / kVec;
  const int DP = D + 1;
  for (int idx = threadIdx.x; idx < rows * dvecs; idx += kThreads) {
    const int r = idx / dvecs;
    const int c = (idx % dvecs) * kVec;
    const size_t off =
        ((size_t)(token0 + r / groups) * num_heads + kvh * groups +
         r % groups) * D + c;
    float tmp[kVec];
    Traits<T>::load(q + off, tmp);
#pragma unroll
    for (int e = 0; e < kVec; ++e) sm.q[r * DP + c + e] = tmp[e];
  }
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads)
    sm.acc[idx] = 0.f;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
  }
}

// Stage K/V block `entry` of kv head `kvh` into shared memory as f32.
// entry >= 0: fp block `entry` of k/v_pool. With kMixed, entry < 0 is
// int8 slot -entry-1, dequantized while staging as dequantize_block
// does — (int8 -> f32) * (scale * kRqmax), both products rounded on
// their own (__fmul_rn: nvcc's default --fmad=true must not contract them
// into anything), then rounded to the pool dtype. Without kMixed the int8
// branch is compiled away and the int8 pointers are unused.
template <typename T, bool kMixed>
__device__ __forceinline__ void stage_block(
    const T* k_pool, const T* v_pool, const int8_t* kq_pool,
    const int8_t* vq_pool, const float* k_scales, const float* v_scales,
    int entry, const Smem& sm, int num_kv_heads, int kvh, int D, int BS) {
  constexpr int kVec = Traits<T>::kVec;
  const int dvecs = D / kVec;
  const int DP = D + 1;
  if (kMixed && entry < 0) {
    const size_t slot = (size_t)(-entry - 1);
    const float kf = __fmul_rn(k_scales[slot], kRqmax);
    const float vf = __fmul_rn(v_scales[slot], kRqmax);
    for (int idx = threadIdx.x; idx < BS * dvecs; idx += kThreads) {
      const int s = idx / dvecs;
      const int c = (idx % dvecs) * kVec;
      const size_t off = ((slot * BS + s) * num_kv_heads + kvh) * D + c;
      float tk[kVec];
      float tv[kVec];
      load_int8<kVec>(kq_pool + off, tk);
      load_int8<kVec>(vq_pool + off, tv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        sm.k[s * DP + c + e] = Traits<T>::round(__fmul_rn(tk[e], kf));
        sm.v[s * D + c + e] = Traits<T>::round(__fmul_rn(tv[e], vf));
      }
    }
    return;
  }
  const size_t blk = (size_t)entry;
  for (int idx = threadIdx.x; idx < BS * dvecs; idx += kThreads) {
    const int s = idx / dvecs;
    const int c = (idx % dvecs) * kVec;
    const size_t off = ((blk * BS + s) * num_kv_heads + kvh) * D + c;
    float tk[kVec];
    float tv[kVec];
    Traits<T>::load(k_pool + off, tk);
    Traits<T>::load(v_pool + off, tv);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      sm.k[s * DP + c + e] = tk[e];
      sm.v[s * D + c + e] = tv[e];
    }
  }
}

// Online-softmax update of every query row against the staged block j.
// Row r sits at absolute position q0 + r / groups and sees kv position
// p = j * BS + c iff p <= q_pos and p < ctx. Call between barriers: it
// reads the staged block and ends with the accumulator updated.
template <typename T>
__device__ __forceinline__ void block_update(const Smem& sm, int rows,
                                             int groups, int D, int BS,
                                             int j, int q0, int ctx,
                                             float scale) {
  const int DP = D + 1;
  // scores: s = (q . k) * scale, masked by SELECT
  for (int idx = threadIdx.x; idx < rows * BS; idx += kThreads) {
    const int r = idx / BS;
    const int c = idx % BS;
    const float* qr = sm.q + r * DP;
    const float* kc = sm.k + c * DP;
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kc[d], dot);
    const int qpos = q0 + r / groups;
    const int kpos = j * BS + c;
    sm.s[idx] = (kpos <= qpos && kpos < ctx) ? dot * scale : kNegInf;
  }
  __syncthreads();

  // online softmax in f32, one thread per row
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    float* sr = sm.s + r * BS;
    float mx = sr[0];
    for (int c = 1; c < BS; ++c) mx = fmaxf(mx, sr[c]);
    const float m_prev = sm.m[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int c = 0; c < BS; ++c) {
      const float p = expf(sr[c] - m_new);
      sum += p;
      sr[c] = Traits<T>::round(p);  // p in the pool dtype for P.V
    }
    const float alpha = expf(m_prev - m_new);
    sm.l[r] = alpha * sm.l[r] + sum;
    sm.m[r] = m_new;
    sm.alpha[r] = alpha;
  }
  __syncthreads();

  // acc = alpha * acc + P . V
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    const float* pr = sm.s + r * BS;
    float pv = 0.f;
    for (int c = 0; c < BS; ++c) pv = fmaf(pr[c], sm.v[c * D + d], pv);
    sm.acc[idx] = sm.alpha[r] * sm.acc[idx] + pv;
  }
}

// out [.., H, D] for every query row: acc / max(l, 1e-30) in T
template <typename T>
__device__ __forceinline__ void store_rows(T* out, const Smem& sm,
                                           int token0, int rows,
                                           int groups, int num_heads,
                                           int kvh, int D) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    const size_t off =
        ((size_t)(token0 + r / groups) * num_heads + kvh * groups +
         r % groups) * D + d;
    out[off] = Traits<T>::store(sm.acc[idx] / fmaxf(sm.l[r], kLFloor));
  }
}

}  // namespace ptt
