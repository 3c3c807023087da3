// Paged attention for NVIDIA Hopper (sm_90a): ONE ragged call serves a
// serve step's mixed batch of decode rows and prefill chunks, and one
// decode call serves the split path's decode step.
//
// Three entry points over one kernel template (ragged_tc.cuh), instantiated
// for each tier:
// - ptt_ragged_paged_attention replaces the TPU kernel `_ragged_kernel`
//   in paddle_tpu/kernels/paged_attention.py:428 (launched by
//   `_ragged_kernel_call`, :597);
// - ptt_ragged_paged_attention_mixed replaces `_ragged_kernel_mixed`
//   (:462, the same call site with int8 pools): the block table is
//   bias-encoded, id >= 0 an fp block, id < 0 int8 slot -id-1 of
//   kq/vq_pool [NQ, BS, Hkv, D] with per-slot f32 scales k/v_scales [NQ].
//   An int8 block is dequantized while it is staged into shared memory
//   and then goes through the same code as an fp block, so a direct read
//   is bit-equal to the fp entry point over pools into which those blocks
//   were promoted with dequantize_block;
// - ptt_paged_attention replaces `_paged_kernel` (:173, launched by
//   `_paged_kernel_call`, :230): single-token decode through the fp
//   instantiations over ragged_tc.cuh's decode packing (below).
// Contract (the same as the TPU kernels'):
//   q            [T, H, D]          flat-packed queries, T = NT * tile_q
//   k/v_pool     [NB, BS, Hkv, D]   block pools (f32 or bf16, q's dtype)
//   block_tables [R, MB] int32      per-row pool block ids
//   context_lens [R] int32          per-row chunk-end position
//   q_starts     [R] int32          per-row first query position
//   tile_rows    [NT] int32         row of each query tile
//   tile_offs    [NT] int32         tile's token offset inside its row
//   out          [T, H, D]          q's dtype
//   ws           [NT, Hkv, num_splits, tile_q * H / Hkv, D + 2] f32
//                                   the splits' partials (the wrapper's
//                                   torch.empty; unused with one split)
// Query i of tile t sits at absolute position
// q_starts[row] + tile_offs[t] + i and attends kv position p of its row
// iff p <= q_pos and p < ctx. Pad tiles point at a null row (ctx 1, all
// table entries scratch block 0), so every softmax row has kv position 0
// visible and is never empty.
//
// The decode contract (the same as `_paged_kernel`'s):
//   q            [B, H, D]          one query token per sequence
//   k/v_pool     [NB, BS, Hkv, D]   block pools (f32 or bf16, q's dtype)
//   block_tables [B, MB] int32      per-sequence pool block ids
//   context_lens [B] int32          tokens visible to the row (this one
//                                   included); 0 gives a row of zeros
//   out          [B, H, D]          q's dtype
//   ws           [B, Hkv, num_splits, H / Hkv, D + 2] f32, as above
// Sequence b is decode tile b: tile_q 1, its G = H / Hkv query heads of a
// kv head as the tile's rows, its query at position context_lens[b] - 1.
// The ragged mask is then the decode mask p < ctx, over the same kv
// schedule as kernel 1, so a decode row's bits are kernel 1's for the
// same row packed as a ragged decode row.
//
// The kv schedule — C positions an iteration (`chunk`), S a split
// (`split`) — comes from the wrapper (paged_attention.ragged_schedule),
// which sizes the workspace from it; ragged_tc.cuh describes the design,
// what bounds it, and what it keeps exactly as the Pallas kernel.

#include "ragged_tc.cuh"

namespace {

using ptt::rtc::Params;

template <typename T, bool kMixed, int kD>
int launch(Params p, cudaStream_t stream) {
  const int warp_rows = sizeof(T) == 2 ? 16 : 8;
  const int rows = p.tile_q * (p.num_heads / p.num_kv_heads);
  p.row_groups = (rows + warp_rows - 1) / warp_rows;
  const size_t smem = ptt::rtc::smem_bytes(p.head_dim, sizeof(T), p.chunk,
                                           p.split, p.block_size, warp_rows);
  const int threads = p.chunk / ptt::rtc::kLanes * 32;
  auto* kernel = ptt::rtc::split_kernel<T, kMixed, kD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.num_tiles * p.row_groups * p.num_splits, p.num_kv_heads);
  kernel<<<grid, threads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.num_splits == 1) return (int)err;
  ptt::rtc::combine_kernel<T>
      <<<dim3(p.num_tiles, p.num_kv_heads), ptt::rtc::kCombineThreads, 0,
         stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool kMixed>
int by_head_dim(const Params& p, cudaStream_t s) {
  if (p.head_dim <= 64) return launch<T, kMixed, 64>(p, s);
  if (p.head_dim <= 128) return launch<T, kMixed, 128>(p, s);
  return launch<T, kMixed, 256>(p, s);
}

template <bool kMixed>
int dispatch(Params p, int dtype, void* stream) {
  using ptt::rtc::kLanes;
  if (p.num_tiles <= 0 || p.tile_q <= 0 || p.num_kv_heads <= 0 ||
      p.num_heads % p.num_kv_heads != 0 || p.head_dim % 8 != 0 ||
      p.head_dim <= 0 || p.head_dim > 256 || p.block_size <= 0 ||
      p.max_blocks <= 0 || p.chunk <= 0 || p.chunk % kLanes != 0 ||
      p.chunk / kLanes * 32 > ptt::rtc::kMaxThreads || p.split <= 0 ||
      p.split % p.chunk != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  p.num_splits =
      (int)(((long long)p.max_blocks * p.block_size + p.split - 1) / p.split);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_head_dim<float, kMixed>(p, s);
  return by_head_dim<__nv_bfloat16, kMixed>(p, s);
}

Params make_params(const void* q, const void* k_pool, const void* v_pool,
                   const int* block_tables, const int* context_lens,
                   const int* q_starts, const int* tile_rows,
                   const int* tile_offs, void* out, float* ws, int num_tiles,
                   int tile_q, int num_heads, int num_kv_heads, int head_dim,
                   int block_size, int max_blocks, int chunk, int split,
                   float scale) {
  Params p{};
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.block_tables = block_tables;
  p.context_lens = context_lens;
  p.q_starts = q_starts;
  p.tile_rows = tile_rows;
  p.tile_offs = tile_offs;
  p.out = out;
  p.ws = ws;
  p.num_tiles = num_tiles;
  p.tile_q = tile_q;
  p.num_heads = num_heads;
  p.num_kv_heads = num_kv_heads;
  p.head_dim = head_dim;
  p.block_size = block_size;
  p.max_blocks = max_blocks;
  p.chunk = chunk;
  p.split = split;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one split-kernel CTA, in bytes: elem_bytes 4
// (f32, 8 query rows a CTA) or 2 (bf16, 16 rows), `chunk` kv positions an
// iteration, `split` a CTA, blocks of block_size positions.
size_t ptt_ragged_paged_attention_smem_bytes(int head_dim, int elem_bytes,
                                             int chunk, int split,
                                             int block_size) {
  return ptt::rtc::smem_bytes(head_dim, elem_bytes, chunk, split, block_size,
                              elem_bytes == 2 ? 16 : 8);
}

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launches (0 on success). Launches on `stream`, does not synchronise,
// allocates nothing.
int ptt_ragged_paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const int* block_tables,
                               const int* context_lens, const int* q_starts,
                               const int* tile_rows, const int* tile_offs,
                               void* out, void* ws, int num_tiles,
                               int tile_q, int num_heads, int num_kv_heads,
                               int head_dim, int block_size, int max_blocks,
                               int chunk, int split, float scale, int dtype,
                               void* stream) {
  const Params p = make_params(
      q, k_pool, v_pool, block_tables, context_lens, q_starts, tile_rows,
      tile_offs, out, static_cast<float*>(ws), num_tiles, tile_q, num_heads,
      num_kv_heads, head_dim, block_size, max_blocks, chunk, split, scale);
  return dispatch<false>(p, dtype, stream);
}

// The mixed kernel: as above, with int8 pools kq/vq [NQ, BS, Hkv, D] and
// per-slot scales k/v_scales [NQ] f32 behind a bias-encoded table.
int ptt_ragged_paged_attention_mixed(
    const void* q, const void* k_pool, const void* v_pool,
    const void* kq_pool, const void* vq_pool, const float* k_scales,
    const float* v_scales, const int* block_tables, const int* context_lens,
    const int* q_starts, const int* tile_rows, const int* tile_offs,
    void* out, void* ws, int num_tiles, int tile_q, int num_heads,
    int num_kv_heads, int head_dim, int block_size, int max_blocks,
    int chunk, int split, float scale, int dtype, void* stream) {
  if (kq_pool == nullptr || vq_pool == nullptr || k_scales == nullptr ||
      v_scales == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p = make_params(
      q, k_pool, v_pool, block_tables, context_lens, q_starts, tile_rows,
      tile_offs, out, static_cast<float*>(ws), num_tiles, tile_q, num_heads,
      num_kv_heads, head_dim, block_size, max_blocks, chunk, split, scale);
  p.kq_pool = static_cast<const int8_t*>(kq_pool);
  p.vq_pool = static_cast<const int8_t*>(vq_pool);
  p.k_scales = k_scales;
  p.v_scales = v_scales;
  return dispatch<true>(p, dtype, stream);
}

// Kernel 3: single-token decode over the decode packing (q_starts,
// tile_rows and tile_offs absent), through kernel 1's instantiations.
// The workspace and the schedule come from the wrapper, as for the
// ragged entry points.
int ptt_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                        const int* block_tables, const int* context_lens,
                        void* out, void* ws, int batch, int num_heads,
                        int num_kv_heads, int head_dim, int block_size,
                        int max_blocks, int chunk, int split, float scale,
                        int dtype, void* stream) {
  const Params p = make_params(
      q, k_pool, v_pool, block_tables, context_lens, nullptr, nullptr,
      nullptr, out, static_cast<float*>(ws), batch, 1, num_heads,
      num_kv_heads, head_dim, block_size, max_blocks, chunk, split, scale);
  return dispatch<false>(p, dtype, stream);
}

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
