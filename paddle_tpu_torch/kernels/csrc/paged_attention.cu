// Paged single-token decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel` in
// paddle_tpu/kernels/paged_attention.py:173 (launched by
// `_paged_kernel_call`, :230, for `paged_attention`, :273): the decode
// step of the split prefill/decode path (CausalLM.decode_step_paged).
// Contract (the same as that kernel's):
//   q            [B, H, D]          one query token per sequence
//   k/v_pool     [NB, BS, Hkv, D]   block pools (f32 or bf16, q's dtype)
//   block_tables [B, MB] int32      per-sequence pool block ids
//   context_lens [B] int32          tokens visible to the row (this one
//                                   included)
//   out          [B, H, D]          q's dtype
// Row b's heads attend kv positions p < context_lens[b]; GQA groups
// G = H / Hkv query heads onto each kv head.
//
// What bounds it on the H100: bytes. A decode row reads every K/V block
// up to its context once and does 4*D FLOPs per (head, kv position):
// about G FLOPs per byte of K/V in bf16, far below the card's 295
// FLOP/byte ridge.
//
// Design (simple and right first; speed is later work):
// - One CTA per (sequence, kv head), holding the G query heads of its
//   group in shared memory, so each K/V block of that kv head is read
//   from device memory once for the whole group.
// - The TPU's sequential kv grid axis becomes a loop inside the CTA over
//   blocks j < ceil(ctx / BS) (its skip past context_len): no split-K and
//   no atomics, so a row's result does not depend on its batch.
// - Staging and the online-softmax update are paged_common.cuh's, shared
//   with the ragged kernels: f32 scores and softmax, mask by select, p
//   rounded to the pool dtype before P.V, output acc / max(l, 1e-30).
//   With the row's query at position ctx - 1 the ragged mask
//   (p <= q_pos and p < ctx) is the decode mask p < ctx.

#include "paged_common.cuh"

namespace {

using namespace ptt;

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, T* __restrict__ out,
    int num_heads, int num_kv_heads, int head_dim, int block_size,
    int max_blocks, float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int groups = num_heads / num_kv_heads;  // rows: one query per head
  const int D = head_dim;
  const int BS = block_size;

  extern __shared__ float smem[];
  const Smem sm(smem, groups, D, BS);

  const int ctx = context_lens[b];
  const int* table = block_tables + (size_t)b * max_blocks;

  load_queries<T>(q, sm, b, groups, groups, num_heads, kvh, D);

  int nblk = (ctx + BS - 1) / BS;
  if (max_blocks < nblk) nblk = max_blocks;
  for (int j = 0; j < nblk; ++j) {
    __syncthreads();  // the previous block's readers of k/v/s are done
    stage_block<T, false>(k_pool, v_pool, nullptr, nullptr, nullptr,
                          nullptr, table[j], sm, num_kv_heads, kvh, D, BS);
    __syncthreads();
    block_update<T>(sm, groups, groups, D, BS, j, ctx - 1, ctx, scale);
  }
  __syncthreads();
  store_rows<T>(out, sm, b, groups, groups, num_heads, kvh, D);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* block_tables, const int* context_lens, void* out,
           int batch, int num_heads, int num_kv_heads, int head_dim,
           int block_size, int max_blocks, float scale,
           cudaStream_t stream) {
  const int groups = num_heads / num_kv_heads;
  const size_t smem =
      smem_floats(groups, head_dim, block_size) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch, num_kv_heads);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), block_tables, context_lens,
      static_cast<T*>(out), num_heads, num_kv_heads, head_dim, block_size,
      max_blocks, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs, in bytes: tile_q is 1 here (one
// query per head); the argument keeps the ragged kernel's signature.
size_t ptt_paged_attention_smem_bytes(int tile_q, int groups, int head_dim,
                                      int block_size) {
  return smem_floats(tile_q * groups, head_dim, block_size) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 on success). Launches on `stream`, does not synchronise, allocates
// nothing.
int ptt_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                        const int* block_tables, const int* context_lens,
                        void* out, int batch, int num_heads, int num_kv_heads,
                        int head_dim, int block_size, int max_blocks,
                        float scale, int dtype, void* stream) {
  if (batch <= 0 || num_kv_heads <= 0 || num_heads % num_kv_heads != 0 ||
      head_dim % 8 != 0 || head_dim <= 0 || head_dim > 256 ||
      block_size <= 0 || max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, block_tables, context_lens, out,
                         batch, num_heads, num_kv_heads, head_dim,
                         block_size, max_blocks, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, block_tables,
                                 context_lens, out, batch, num_heads,
                                 num_kv_heads, head_dim, block_size,
                                 max_blocks, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
