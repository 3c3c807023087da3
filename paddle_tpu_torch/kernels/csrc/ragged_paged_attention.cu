// Ragged paged attention for NVIDIA Hopper (sm_90a): ONE launch serves a
// serve step's mixed batch of decode rows and prefill chunks.
//
// Replaces the TPU kernel `_ragged_kernel` in
// paddle_tpu/kernels/paged_attention.py:428 (launched by
// `_ragged_kernel_call`, :597). Contract (the same as that kernel's):
//   q            [T, H, D]          flat-packed queries, T = NT * tile_q
//   k/v_pool     [NB, BS, Hkv, D]   block pools (f32 or bf16, q's dtype)
//   block_tables [R, MB] int32      per-row pool block ids
//   context_lens [R] int32          per-row chunk-end position
//   q_starts     [R] int32          per-row first query position
//   tile_rows    [NT] int32         row of each query tile
//   tile_offs    [NT] int32         tile's token offset inside its row
//   out          [T, H, D]          q's dtype
// Query i of tile t sits at absolute position
// q_starts[row] + tile_offs[t] + i and attends kv position p of its row
// iff p <= q_pos and p < ctx. Pad tiles point at a null row (ctx 1, all
// table entries scratch block 0), so every softmax row has kv position 0
// visible and is never empty.
//
// What bounds it on the H100: bytes. Each step reads the K/V blocks its
// rows need plus q and out, and does ~4*D FLOPs per (query, visible kv)
// pair — far below the 295 FLOP/byte ridge of the card in bf16.
//
// Design (simple and right first; speed is later work):
// - One CTA per (query tile, kv head). It holds the tile's tile_q * G
//   query rows (G = H / Hkv) in shared memory, and loads its own
//   metadata — the TPU's scalar prefetch becomes plain loads.
// - A loop inside the CTA replaces the TPU's sequential kv grid axis. It
//   walks only blocks j with j*BS < ctx and j*BS <= q0 + tile_q - 1 (the
//   skip of paged_attention.py:449), so a ragged batch reads
//   ~sum(ceil(ctx_i / BS)) blocks, not R * MB.
// - Each K/V block of this kv head goes to shared memory as f32 with
//   16-byte loads; scores, the mask, and the online softmax run in f32.
//   The mask is a SELECT to -1e9, never a multiply, so masked lanes
//   underflow to exact zeros; that and the kv loop staying inside one
//   CTA (no split across CTAs, no atomics) keep a row's output
//   independent of its neighbours: a request's tokens are the same
//   batched or alone.
// - p is rounded to the pool dtype before P.V (the TPU kernel's
//   pg.astype(v.dtype), paged_attention.py:419); l sums the unrounded p;
//   the output is acc / max(l, 1e-30) in q's dtype. expf, never __expf,
//   and no fast-math flags.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e9f;
constexpr float kLFloor = 1e-30f;

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  __device__ static __forceinline__ void load(const float* src, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __device__ static __forceinline__ float round(float x) { return x; }
  __device__ static __forceinline__ float store(float x) { return x; }
};

template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static __forceinline__ void load(const __nv_bfloat16* src,
                                              float* dst) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
  // round-to-nearest-even, as XLA's astype(bfloat16)
  __device__ static __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  __device__ static __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
};

// Shared memory, in floats: q [rows][D+1], k [BS][D+1], v [BS][D],
// scores [rows][BS], acc [rows][D], m/l/alpha [rows]. The +1 pads the
// rows the score loop reads down a column, to spread them over banks.
__host__ __device__ inline size_t smem_floats(int rows, int head_dim,
                                              int block_size) {
  const size_t dp = head_dim + 1;
  return rows * dp + block_size * dp + (size_t)block_size * head_dim +
         (size_t)rows * block_size + (size_t)rows * head_dim + 3 * rows;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, const int* __restrict__ q_starts,
    const int* __restrict__ tile_rows, const int* __restrict__ tile_offs,
    T* __restrict__ out, int tile_q, int num_heads, int num_kv_heads,
    int head_dim, int block_size, int max_blocks, float scale) {
  const int tile = blockIdx.x;
  const int kvh = blockIdx.y;
  const int groups = num_heads / num_kv_heads;
  const int rows = tile_q * groups;  // row r = i * groups + g
  const int D = head_dim;
  const int DP = head_dim + 1;
  const int BS = block_size;
  constexpr int kVec = Traits<T>::kVec;
  const int dvecs = D / kVec;

  extern __shared__ float smem[];
  float* sq = smem;                  // [rows][DP]
  float* sk = sq + rows * DP;        // [BS][DP]
  float* sv = sk + BS * DP;          // [BS][D]
  float* ss = sv + BS * D;           // [rows][BS]
  float* sacc = ss + rows * BS;      // [rows][D]
  float* sm = sacc + rows * D;       // [rows]
  float* sl = sm + rows;             // [rows]
  float* salpha = sl + rows;         // [rows]

  const int row = tile_rows[tile];
  const int ctx = context_lens[row];
  const int q0 = q_starts[row] + tile_offs[tile];
  const int* table = block_tables + (size_t)row * max_blocks;

  // the tile's queries of this kv head's group: token tile*tile_q + i,
  // head kvh*groups + g
  for (int idx = threadIdx.x; idx < rows * dvecs; idx += kThreads) {
    const int r = idx / dvecs;
    const int c = (idx % dvecs) * kVec;
    const int i = r / groups;
    const int g = r % groups;
    const size_t off =
        ((size_t)(tile * tile_q + i) * num_heads + kvh * groups + g) * D + c;
    float tmp[kVec];
    Traits<T>::load(q + off, tmp);
#pragma unroll
    for (int e = 0; e < kVec; ++e) sq[r * DP + c + e] = tmp[e];
  }
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) sacc[idx] = 0.f;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    sm[r] = kNegInf;
    sl[r] = 0.f;
  }

  // skip blocks past the row's context or wholly in the causal future of
  // the tile's last query (position q0 + tile_q - 1)
  int nblk = (ctx + BS - 1) / BS;
  const int causal_end = (q0 + tile_q - 1) / BS + 1;
  if (causal_end < nblk) nblk = causal_end;
  if (max_blocks < nblk) nblk = max_blocks;

  for (int j = 0; j < nblk; ++j) {
    const size_t blk = (size_t)table[j];
    __syncthreads();  // the previous block's readers of sk/sv/ss are done
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
        sk[s * DP + c + e] = tk[e];
        sv[s * D + c + e] = tv[e];
      }
    }
    __syncthreads();

    // scores: s = (q . k) * scale, masked by SELECT
    for (int idx = threadIdx.x; idx < rows * BS; idx += kThreads) {
      const int r = idx / BS;
      const int c = idx % BS;
      const float* qr = sq + r * DP;
      const float* kc = sk + c * DP;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kc[d], dot);
      const int qpos = q0 + r / groups;
      const int kpos = j * BS + c;
      ss[idx] = (kpos <= qpos && kpos < ctx) ? dot * scale : kNegInf;
    }
    __syncthreads();

    // online softmax in f32, one thread per row
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      float* sr = ss + r * BS;
      float mx = sr[0];
      for (int c = 1; c < BS; ++c) mx = fmaxf(mx, sr[c]);
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = 0; c < BS; ++c) {
        const float p = expf(sr[c] - m_new);
        sum += p;
        sr[c] = Traits<T>::round(p);  // p in the pool dtype for P.V
      }
      const float alpha = expf(m_prev - m_new);
      sl[r] = alpha * sl[r] + sum;
      sm[r] = m_new;
      salpha[r] = alpha;
    }
    __syncthreads();

    // acc = alpha * acc + P . V
    for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
      const int r = idx / D;
      const int d = idx % D;
      const float* pr = ss + r * BS;
      float pv = 0.f;
      for (int c = 0; c < BS; ++c) pv = fmaf(pr[c], sv[c * D + d], pv);
      sacc[idx] = salpha[r] * sacc[idx] + pv;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    const int i = r / groups;
    const int g = r % groups;
    const size_t off =
        ((size_t)(tile * tile_q + i) * num_heads + kvh * groups + g) * D + d;
    out[off] = Traits<T>::store(sacc[idx] / fmaxf(sl[r], kLFloor));
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* block_tables, const int* context_lens,
           const int* q_starts, const int* tile_rows, const int* tile_offs,
           void* out, int num_tiles, int tile_q, int num_heads,
           int num_kv_heads, int head_dim, int block_size, int max_blocks,
           float scale, cudaStream_t stream) {
  const int rows = tile_q * (num_heads / num_kv_heads);
  const size_t smem = smem_floats(rows, head_dim, block_size) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_paged_attention_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(num_tiles, num_kv_heads);
  ragged_paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), block_tables, context_lens, q_starts,
      tile_rows, tile_offs, static_cast<T*>(out), tile_q, num_heads,
      num_kv_heads, head_dim, block_size, max_blocks, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs, in bytes (the wrapper checks it
// against the card's 227 KB before launching).
size_t ptt_ragged_paged_attention_smem_bytes(int tile_q, int groups,
                                             int head_dim, int block_size) {
  return smem_floats(tile_q * groups, head_dim, block_size) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 on success). Launches on `stream`, does not synchronise, allocates
// nothing.
int ptt_ragged_paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const int* block_tables,
                               const int* context_lens, const int* q_starts,
                               const int* tile_rows, const int* tile_offs,
                               void* out, int num_tiles, int tile_q,
                               int num_heads, int num_kv_heads, int head_dim,
                               int block_size, int max_blocks, float scale,
                               int dtype, void* stream) {
  if (num_tiles <= 0 || tile_q <= 0 || num_kv_heads <= 0 ||
      num_heads % num_kv_heads != 0 || head_dim % 8 != 0 || head_dim <= 0 ||
      head_dim > 256 || block_size <= 0 || max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, block_tables, context_lens,
                         q_starts, tile_rows, tile_offs, out, num_tiles,
                         tile_q, num_heads, num_kv_heads, head_dim,
                         block_size, max_blocks, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, block_tables,
                                 context_lens, q_starts, tile_rows, tile_offs,
                                 out, num_tiles, tile_q, num_heads,
                                 num_kv_heads, head_dim, block_size,
                                 max_blocks, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
