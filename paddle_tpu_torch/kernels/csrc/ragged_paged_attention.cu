// Ragged paged attention for NVIDIA Hopper (sm_90a): ONE launch serves a
// serve step's mixed batch of decode rows and prefill chunks.
//
// Two entry points over one kernel template, instantiated twice:
// - ptt_ragged_paged_attention replaces the TPU kernel `_ragged_kernel`
//   in paddle_tpu/kernels/paged_attention.py:428 (launched by
//   `_ragged_kernel_call`, :597);
// - ptt_ragged_paged_attention_mixed replaces `_ragged_kernel_mixed`
//   (:462, the same call site with int8 pools): the block table is
//   bias-encoded, id >= 0 an fp block, id < 0 int8 slot -id-1 of
//   kq/vq_pool [NQ, BS, Hkv, D] with per-slot f32 scales k/v_scales [NQ].
//   The CTA dequantizes an int8 block while staging it into shared
//   memory and then runs the same update as for an fp block
//   (paged_common.cuh), so a direct read is bit-equal to the fp entry
//   point over pools into which those blocks were promoted with
//   dequantize_block.
// Contract (the same as the TPU kernels'):
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
// pair — far below the 295 FLOP/byte ridge of the card in bf16. An int8
// block is half the bytes of a bf16 one (plus 4 bytes of scale), so the
// mixed kernel's bound falls with the share of int8-resident blocks.
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
// - An int8 block costs its CTA one scale load and product per block and
//   one rounded product per element while staging. The fp entry point is
//   the kMixed = false instantiation, with the int8 branch compiled away,
//   so its code is the fp kernel's alone.

#include "paged_common.cuh"

namespace {

using namespace ptt;

template <typename T, bool kMixed>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int8_t* __restrict__ kq_pool,
    const int8_t* __restrict__ vq_pool, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, const int* __restrict__ q_starts,
    const int* __restrict__ tile_rows, const int* __restrict__ tile_offs,
    T* __restrict__ out, int tile_q, int num_heads, int num_kv_heads,
    int head_dim, int block_size, int max_blocks, float scale) {
  const int tile = blockIdx.x;
  const int kvh = blockIdx.y;
  const int groups = num_heads / num_kv_heads;
  const int rows = tile_q * groups;  // row r = i * groups + g
  const int D = head_dim;
  const int BS = block_size;

  extern __shared__ float smem[];
  const Smem sm(smem, rows, D, BS);

  const int row = tile_rows[tile];
  const int ctx = context_lens[row];
  const int q0 = q_starts[row] + tile_offs[tile];
  const int* table = block_tables + (size_t)row * max_blocks;

  load_queries<T>(q, sm, tile * tile_q, rows, groups, num_heads, kvh, D);

  // skip blocks past the row's context or wholly in the causal future of
  // the tile's last query (position q0 + tile_q - 1)
  int nblk = (ctx + BS - 1) / BS;
  const int causal_end = (q0 + tile_q - 1) / BS + 1;
  if (causal_end < nblk) nblk = causal_end;
  if (max_blocks < nblk) nblk = max_blocks;

  for (int j = 0; j < nblk; ++j) {
    __syncthreads();  // the previous block's readers of k/v/s are done
    stage_block<T, kMixed>(k_pool, v_pool, kq_pool, vq_pool, k_scales,
                           v_scales, table[j], sm, num_kv_heads, kvh, D, BS);
    __syncthreads();
    block_update<T>(sm, rows, groups, D, BS, j, q0, ctx, scale);
  }
  __syncthreads();
  store_rows<T>(out, sm, tile * tile_q, rows, groups, num_heads, kvh, D);
}

template <typename T, bool kMixed>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int8_t* kq_pool, const int8_t* vq_pool,
           const float* k_scales, const float* v_scales,
           const int* block_tables, const int* context_lens,
           const int* q_starts, const int* tile_rows, const int* tile_offs,
           void* out, int num_tiles, int tile_q, int num_heads,
           int num_kv_heads, int head_dim, int block_size, int max_blocks,
           float scale, cudaStream_t stream) {
  const int rows = tile_q * (num_heads / num_kv_heads);
  const size_t smem = smem_floats(rows, head_dim, block_size) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_paged_attention_kernel<T, kMixed>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(num_tiles, num_kv_heads);
  ragged_paged_attention_kernel<T, kMixed><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), kq_pool, vq_pool, k_scales, v_scales,
      block_tables, context_lens, q_starts, tile_rows, tile_offs,
      static_cast<T*>(out), tile_q, num_heads, num_kv_heads, head_dim,
      block_size, max_blocks, scale);
  return (int)cudaGetLastError();
}

template <bool kMixed>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const int8_t* kq_pool, const int8_t* vq_pool,
             const float* k_scales, const float* v_scales,
             const int* block_tables, const int* context_lens,
             const int* q_starts, const int* tile_rows, const int* tile_offs,
             void* out, int num_tiles, int tile_q, int num_heads,
             int num_kv_heads, int head_dim, int block_size, int max_blocks,
             float scale, int dtype, void* stream) {
  if (num_tiles <= 0 || tile_q <= 0 || num_kv_heads <= 0 ||
      num_heads % num_kv_heads != 0 || head_dim % 8 != 0 || head_dim <= 0 ||
      head_dim > 256 || block_size <= 0 || max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, kMixed>(q, k_pool, v_pool, kq_pool, vq_pool,
                                 k_scales, v_scales, block_tables,
                                 context_lens, q_starts, tile_rows, tile_offs,
                                 out, num_tiles, tile_q, num_heads,
                                 num_kv_heads, head_dim, block_size,
                                 max_blocks, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, kMixed>(
        q, k_pool, v_pool, kq_pool, vq_pool, k_scales, v_scales,
        block_tables, context_lens, q_starts, tile_rows, tile_offs, out,
        num_tiles, tile_q, num_heads, num_kv_heads, head_dim, block_size,
        max_blocks, scale, s);
  return (int)cudaErrorInvalidValue;
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
  return dispatch<false>(q, k_pool, v_pool, nullptr, nullptr, nullptr,
                         nullptr, block_tables, context_lens, q_starts,
                         tile_rows, tile_offs, out, num_tiles, tile_q,
                         num_heads, num_kv_heads, head_dim, block_size,
                         max_blocks, scale, dtype, stream);
}

// The mixed kernel: as above, with int8 pools kq/vq [NQ, BS, Hkv, D] and
// per-slot scales k/v_scales [NQ] f32 behind a bias-encoded table.
int ptt_ragged_paged_attention_mixed(
    const void* q, const void* k_pool, const void* v_pool,
    const void* kq_pool, const void* vq_pool, const float* k_scales,
    const float* v_scales, const int* block_tables, const int* context_lens,
    const int* q_starts, const int* tile_rows, const int* tile_offs,
    void* out, int num_tiles, int tile_q, int num_heads, int num_kv_heads,
    int head_dim, int block_size, int max_blocks, float scale, int dtype,
    void* stream) {
  if (kq_pool == nullptr || vq_pool == nullptr || k_scales == nullptr ||
      v_scales == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch<true>(q, k_pool, v_pool,
                        static_cast<const int8_t*>(kq_pool),
                        static_cast<const int8_t*>(vq_pool), k_scales,
                        v_scales, block_tables, context_lens, q_starts,
                        tile_rows, tile_offs, out, num_tiles, tile_q,
                        num_heads, num_kv_heads, head_dim, block_size,
                        max_blocks, scale, dtype, stream);
}

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
