// Ragged paged attention on Hopper (sm_90a): the kv axis split at fixed
// positions, a K/V ring filled by cp.async (two stages in bf16, one in
// f32), bf16 products on the tensor cores (mma.sync m16n8k16) and f32
// products register-tiled on the CUDA cores. Used by
// ragged_paged_attention.cu for all three paged kernels: the ragged fp
// and mixed kernels (1 and 2) and the single-token decode kernel (3).
//
// Two packings of the query tiles (tile_origin):
// - ragged (q_starts given): tile t is tile_q queries of row
//   tile_rows[t], the first at position q_starts[row] + tile_offs[t];
// - decode (q_starts == nullptr): tile t is sequence t, tile_q is 1, and
//   its one query sits at position context_lens[t] - 1. Its rows are the
//   G query heads of a kv head, and it reads the blocks j * BS < ctx (up
//   to the table's MB), the Pallas decode kernel's set
//   (paged_attention.py:190). A sequence at ctx 0 reads no block and
//   gets that kernel's acc / max(l, 1e-30) = 0.
//
// Two kernels a call:
// - split_kernel, grid (query tile x row group x split, kv head): the CTA
//   walks the kv positions [s*S, (s+1)*S) of its tile's row in chunks of
//   C positions. Each of its warps holds the CTA's 8 (f32) or 16 (bf16)
//   query rows against kLanes = 16 positions of every chunk, and keeps an
//   f32 online softmax over them in registers (a row's values shared
//   across a quad of threads by shuffles). After the walk the CTA merges
//   its warps in ascending order; a tile whose positions all lie in split
//   0 writes its output, any other writes the split's partial (m, l, acc,
//   f32) to a workspace. A CTA stages its split's table entries (and their
//   int8 scales) in shared memory first, so no copy waits on a table
//   load; a CTA past its tile's last block returns at once.
// - combine_kernel, grid (query tile, kv head): merges the partials of a
//   tile's splits in ascending order and writes the output.
//
// What stays exactly as the Pallas kernels (paddle_tpu/kernels/
// paged_attention.py _paged_kernel :173, _ragged_tile_update :387,
// _ragged_kernel :428, _ragged_kernel_mixed :462) have it:
// 1. Numerics: f32 scores; the mask is a SELECT to -1e9; an f32 online
//    softmax with expf (never __expf); p rounded to the pool dtype before
//    P.V while l sums the unrounded p; the output acc / max(l, 1e-30) in
//    q's dtype. No fast-math flags.
// 2. Which blocks are read: exactly the Pallas kernel's, j*BS < ctx and
//    j*BS <= q0 + tile_q - 1 and j < MB, whole. A read block's lanes past
//    ctx keep the pool's bytes (a stale NaN there poisons the row, as on
//    the TPU); the lanes of a chunk past the last block read are
//    zero-filled in shared memory and masked. One CTA serves one query
//    tile, so each tile reads its own block set and no other.
// 3. Position invariance: a query's output bits depend only on its
//    absolute position, its row's ctx and its row's K/V; not on its tile
//    offset, its chunk's length, its neighbours, T, NT or the packing (a
//    decode tile gives a ragged decode row's bits). The kv grid (C
//    positions a chunk, S a split, 16 lanes a warp) is anchored at
//    position 0 of every row and depends on the dtype and D only. Position
//    0 is visible to every query, so a warp, a split and the whole walk
//    each see a visible lane before any fully masked one; a fully masked
//    chunk then leaves a warp's state unchanged bit for bit (p = 0,
//    alpha = 1), and a warp or split that saw no visible lane (m = -1e9)
//    enters its merge with weight expf(-1e9 - m) = 0 exactly. The merges
//    run in ascending order and start from the first term times its
//    weight, so one split through the combine gives the bits of the
//    direct write. No atomics: the same call twice gives the same bits.
// 4. Kernel 2 is byte-equal to promote-then-kernel-1: an int8 block is
//    dequantized while staging, (int8 -> f32) * (scale * kRqmax) with
//    each product rounded on its own (__fmul_rn), then rounded to the
//    pool dtype, into the same stage layout; from there the code and the
//    schedule are the same whatever tier a block is in. The fp
//    instantiation has no int8 branch.
//
// What bounds it on the H100: bytes (K/V blocks, about 4*D FLOPs per
// query and visible position, far below the card's 295 FLOP/byte ridge
// in bf16). bf16 meets that bound only on the tensor cores: at the f32
// CUDA-core rate its FLOPs would take longer than its bytes. The rows of
// a CTA (tile_q * G, 8 at the LM shape) are few, which mma.sync's 16-row
// tile serves; wgmma's 64-row tile would mostly multiply padding. f32
// stays on the CUDA cores (TF32 would lose the f32 parity). The split
// caps a CTA's serial walk at S / C chunks whatever the context. On the
// card the kernels are bound by latency and by how many CTAs share an SM
// more than by bytes: a second ring stage pays in bf16 and costs in f32
// (twice the bytes a stage), and sharing one tile's staged K/V with the
// next tile of its row (fewer L2 reads) cost more in registers and
// occupancy than it saved (PERF.md, Findings). C = 64 (32 for f32 above
// head dim 128) keeps D 256 within the card's 227 KB.

#pragma once

#include "dtype.cuh"
#include "hopper.cuh"

namespace ptt {

constexpr float kNegInf = -1e9f;
constexpr float kLFloor = 1e-30f;
// f32(1/127) rounded once, as RQMAX in quant/int8_compute.py: dequant is
// (int8 -> f32) * (scale * kRqmax), never a division by 127
constexpr float kRqmax = 0x1.020408p-7f;

// N int8 values (one load of 4 or 8 bytes) as exact floats
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

namespace rtc {

constexpr int kLanes = 16;  // kv positions a warp takes of each chunk
constexpr int kMaxThreads = 128;
constexpr int kCombineThreads = 128;

// K/V ring depth by element bytes: bf16 overlaps a chunk's copies with
// the previous chunk's products; f32 (twice the bytes a stage) gains more
// from the CTAs a single stage lets share an SM
__host__ __device__ constexpr int stages_of(int elem_bytes) {
  return elem_bytes == 2 ? 2 : 1;
}

// table entries a split's positions span at most
__host__ __device__ inline int split_blocks(int split, int block_size) {
  return (split - 1) / block_size + 2;
}

// Elements of one staged row (K, V or q): the head dim, padded in bf16 to
// the mma's k16 (zeros), plus 16 bytes so that the 8 rows an ldmatrix or
// a quarter-warp reads fall on distinct banks.
__host__ __device__ inline int pitch(int head_dim, int elem_bytes) {
  const int dk = elem_bytes == 2 ? (head_dim + 15) / 16 * 16 : head_dim;
  return dk + 16 / elem_bytes;
}

// Dynamic shared memory of split_kernel: the K/V ring, the CTA's
// `rows` (16 in bf16, 8 in f32) q rows and the split's table entries with
// their int8 scales while the CTA walks; then, reusing it, the warps'
// states of those rows and each row's max and l.
__host__ __device__ inline size_t smem_bytes(int head_dim, int elem_bytes,
                                             int chunk, int split,
                                             int block_size, int rows) {
  const size_t p = pitch(head_dim, elem_bytes);
  const size_t walk =
      ((size_t)stages_of(elem_bytes) * 2 * chunk + rows) * p * elem_bytes +
      3 * (((size_t)split_blocks(split, block_size) + 3) / 4 * 16);
  const size_t merge = ((size_t)(chunk / kLanes) * (head_dim + 2) + 2) *
                       rows * sizeof(float);
  return walk > merge ? walk : merge;
}

struct Params {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int8_t* kq_pool;
  const int8_t* vq_pool;
  const float* k_scales;
  const float* v_scales;
  const int* block_tables;
  const int* context_lens;
  const int* q_starts;   // nullptr: the decode packing (tile_origin)
  const int* tile_rows;
  const int* tile_offs;
  void* out;
  float* ws;  // [NT, Hkv, num_splits, tile_q * G, D + 2] f32 partials
  int num_tiles, tile_q, num_heads, num_kv_heads, head_dim, block_size,
      max_blocks;
  int chunk;       // C: kv positions an iteration
  int split;       // S: kv positions a split (a multiple of C)
  int num_splits;  // ceil(max_blocks * BS / S)
  int row_groups;  // CTAs along one query tile's rows (its row tiles)
  float scale;
};

// Where a query tile comes from: its metadata row, the position of its
// first query and its row's context. Both kernels read a tile's origin
// here, so they cannot disagree on it. Only the fp instantiations serve
// the decode packing (kDecode); in the mixed one the branch compiles away.
struct TileOrigin {
  int row, q0, ctx;
};
template <bool kDecode>
__device__ __forceinline__ TileOrigin tile_origin(const Params& p,
                                                  int tile) {
  if (kDecode && p.q_starts == nullptr) {  // tile t is sequence t
    const int ctx = p.context_lens[tile];
    return {tile, ctx - 1, ctx};
  }
  const int row = p.tile_rows[tile];
  return {row, p.q_starts[row] + p.tile_offs[tile], p.context_lens[row]};
}

// blocks a tile reads: those before its row's context and not wholly in
// the causal future of its last query (paged_attention.py:449), and no
// more than its table holds (a decode row at ctx 0 reads none)
__device__ __forceinline__ int blocks_read(const Params& p, int ctx,
                                           int q0) {
  int n = (ctx + p.block_size - 1) / p.block_size;
  const int causal_end = (q0 + p.tile_q - 1) / p.block_size + 1;
  if (causal_end < n) n = causal_end;
  return n < p.max_blocks ? n : p.max_blocks;
}

// offset in q and out [T, H, D] of row r (= i * G + g) of a query tile
__device__ __forceinline__ size_t row_offset(const Params& p, int tile,
                                             int r, int kvh, int G) {
  return ((size_t)(tile * p.tile_q + r / G) * p.num_heads + kvh * G +
          r % G) * p.head_dim;
}

// -- device building blocks -------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(hopper::smem_u32(p))
      : "memory");
}

// d += a b: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void zero16(void* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// 16 bytes of T from kVec floats, each rounded to T (round-to-nearest-
// even, as Traits<T>::round)
__device__ __forceinline__ void store16(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* v) {
  uint4 w;
  w.x = hopper::pack_bf16(v[0], v[1]);
  w.y = hopper::pack_bf16(v[2], v[3]);
  w.z = hopper::pack_bf16(v[4], v[5]);
  w.w = hopper::pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(dst) = w;
}

// -- the split kernel -------------------------------------------------------

// CTA (query tile x row group x split, kv head): kWarpRows query rows of
// one tile against the kv positions [s*S, (s+1)*S) of its row, one warp
// for each 16 lanes of a chunk.
template <typename T, bool kMixed, int kD>
__global__ void __launch_bounds__(kMaxThreads) split_kernel(const Params p) {
  constexpr bool kTc = sizeof(T) == 2;
  // rows a thread holds: g and g + 8 of a 16-row mma tile in bf16, g of
  // an 8-row tile in f32
  constexpr int kR = kTc ? 2 : 1;
  constexpr int kWarpRows = 8 * kR;
  constexpr int kVec = 16 / sizeof(T);
  // accumulator columns: bf16 n8 tiles of the mma layout (col n*8+2c4+e);
  // f32 16-column groups, 4 contiguous columns a thread (col n*16+4c4+e)
  constexpr int kN = kTc ? kD / 8 : kD / 16;
  constexpr int kE = kTc ? 2 : 4;
  constexpr int kStages = stages_of(sizeof(T));

  const int D = p.head_dim;
  const int BS = p.block_size;
  const int G = p.num_heads / p.num_kv_heads;
  const int R = p.tile_q * G;  // tile row r = i * G + g
  // blockIdx.x = (tile * row tiles + row tile) * num_splits + split: a
  // tile's splits are neighbours in launch order
  const int split = blockIdx.x % p.num_splits;
  const int tile = blockIdx.x / p.num_splits / p.row_groups;
  const int r0 = blockIdx.x / p.num_splits % p.row_groups * kWarpRows;
  const int kvh = blockIdx.y;
  const int pos0 = split * p.split;

  const TileOrigin o = tile_origin<!kMixed>(p, tile);
  const int q0 = o.q0;
  const int ctx = o.ctx;
  const int* table = p.block_tables + (size_t)o.row * p.max_blocks;
  const int nblk = blocks_read(p, ctx, q0);
  const int end = nblk * BS;  // positions from here on are zero-filled
  // split 0 always runs: a tile that reads no block (a decode row at ctx
  // 0; a ragged tile always reads position 0) walks no chunk and writes
  // acc / max(l, 1e-30) = 0, the Pallas decode kernel's output
  if (pos0 >= max(end, 1)) return;
  const int nsplit = (end + p.split - 1) / p.split;
  const int span = (end - pos0 < p.split ? end - pos0 : p.split);
  const int nchunk = (span + p.chunk - 1) / p.chunk;

  const int P = pitch(D, sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int stage_elems = 2 * p.chunk * P;  // K rows, then V rows
  T* sq = ring + (size_t)kStages * stage_elems;
  int* stab = reinterpret_cast<int*>(sq + (size_t)kWarpRows * P);
  // entries, rounded to 16 bytes
  const int tab_room = (split_blocks(p.split, BS) + 3) / 4 * 4;
  float* skf = reinterpret_cast<float*>(stab + tab_room);  // k scale*RQMAX
  float* svf = skf + tab_room;                             // v scale*RQMAX
  const T* q = static_cast<const T*>(p.q);
  const int vecs = D / kVec;

  // q rows (zeros past the tile's rows), the split's table entries, and
  // the zero columns that pad a bf16 row of K or q to the mma's k16
  // (cp.async writes the first D only)
  for (int idx = threadIdx.x; idx < kWarpRows * vecs; idx += blockDim.x) {
    const int lr = idx / vecs;
    const int c = (idx - lr * vecs) * kVec;
    const int r = r0 + lr;
    T* dst = sq + lr * P + c;
    if (r < R) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(
          q + row_offset(p, tile, r, kvh, G) + c);
    } else {
      zero16(dst);
    }
  }
  const int jb0 = pos0 / BS;
  const int jb_end = (pos0 + span - 1) / BS + 1;
  for (int i = threadIdx.x; i < jb_end - jb0; i += blockDim.x) {
    const int e = table[jb0 + i];
    stab[i] = e;
    if (kMixed && e < 0) {
      skf[i] = __fmul_rn(p.k_scales[-e - 1], kRqmax);
      svf[i] = __fmul_rn(p.v_scales[-e - 1], kRqmax);
    }
  }
  if (kTc && D % 16 != 0) {
    const int staged_rows = kStages * 2 * p.chunk + kWarpRows;
    for (int r = threadIdx.x; r < staged_rows; r += blockDim.x)
      zero16(ring + (size_t)r * P + D);
  }

  // This thread's copies of a chunk: column `col`, lanes lane_a + k *
  // lane_step. A power-of-two block size divides by a shift.
  const int lane_step = blockDim.x / vecs;
  const bool copier = (int)threadIdx.x < lane_step * vecs;
  const int lane_a = threadIdx.x / vecs;
  const int col = (threadIdx.x - lane_a * vecs) * kVec;
  const int bs_shift = (BS & (BS - 1)) == 0 ? __ffs(BS) - 1 : -1;
  const size_t row_stride = (size_t)p.num_kv_heads * D;
  const size_t col_off = (size_t)kvh * D + col;
  const T* k_src = static_cast<const T*>(p.k_pool) + col_off;
  const T* v_src = static_cast<const T*>(p.v_pool) + col_off;
  __syncthreads();

  // chunk c of this split into ring stage c % kStages; an int8 block is
  // dequantized on the way, as dequantize_block: (int8 -> f32) *
  // (scale * kRqmax), each product rounded on its own, then rounded to
  // the pool dtype
  auto stage = [&](int c) {
    if (!copier) return;
    T* sk = ring + (size_t)(c % kStages) * stage_elems + col;
    T* sv = sk + p.chunk * P;
    const int cpos = pos0 + c * p.chunk;
    for (int lane = lane_a; lane < p.chunk; lane += lane_step) {
      T* dk = sk + lane * P;
      T* dv = sv + lane * P;
      const int pos = cpos + lane;
      const int j = bs_shift >= 0 ? pos >> bs_shift : pos / BS;
      if (j >= nblk) {
        zero16(dk);
        zero16(dv);
        continue;
      }
      const int e = stab[j - jb0];
      const int slot_pos = pos - j * BS;
      if constexpr (kMixed) {
        if (e < 0) {
          const size_t off =
              ((size_t)(-e - 1) * BS + slot_pos) * row_stride + col_off;
          const float kf = skf[j - jb0];
          const float vf = svf[j - jb0];
          float tk[kVec];
          float tv[kVec];
          load_int8<kVec>(p.kq_pool + off, tk);
          load_int8<kVec>(p.vq_pool + off, tv);
#pragma unroll
          for (int x = 0; x < kVec; ++x) {
            tk[x] = __fmul_rn(tk[x], kf);
            tv[x] = __fmul_rn(tv[x], vf);
          }
          store16(dk, tk);
          store16(dv, tv);
          continue;
        }
      }
      const size_t off = ((size_t)e * BS + slot_pos) * row_stride;
      cp_async16(dk, k_src + off);
      cp_async16(dv, v_src + off);
    }
  };

  const int warp = threadIdx.x / 32;
  const int lane_id = threadIdx.x % 32;
  const int g = lane_id / 4;
  const int c4 = lane_id % 4;
  const int lane0 = warp * kLanes;  // this warp's lanes of every chunk
  // rows g and (bf16) g + 8 of this CTA; `upper`: whether rows 8-15 of a
  // bf16 tile hold a query row (if not, their p is 0). A row sees kv
  // position kpos iff kpos <= lim: its position, below ctx, and below
  // `end` (a context past the table's last block sees the table's
  // positions, not the zero-filled lanes after them)
  const bool upper = kR == 2 && r0 + 8 < R;
  int lim[kR];
#pragma unroll
  for (int rr = 0; rr < kR; ++rr) {
    const int qpos = q0 + (r0 + g + 8 * rr) / G;
    lim[rr] = min(qpos, min(ctx, end) - 1);
  }
  float m[kR];
  float l[kR];
  float acc[kN][kR * kE];  // [n][rr * kE + e]: row g + 8 rr
#pragma unroll
  for (int rr = 0; rr < kR; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int x = 0; x < kR * kE; ++x) acc[n][x] = 0.f;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nchunk) stage(c);
    cp_async_commit();
  }
  for (int c = 0; c < nchunk; ++c) {
    if (c + kStages - 1 < nchunk) stage(c + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // chunk c staged by every thread

    const T* sk = ring + (size_t)(c % kStages) * stage_elems;
    const T* sv = sk + p.chunk * P;
    // scores s[n][rr * 2 + e]: row g + 8 rr, lane lane0 + n*8 + 2c4 + e
    float s[2][2 * kR];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int x = 0; x < 2 * kR; ++x) s[n][x] = 0.f;
    if constexpr (kTc) {
      const T* qa = sq + ((lane_id & 7) + ((lane_id >> 3) & 1) * 8) * P +
                    (lane_id >> 4) * 8;
      const T* kb = sk + (lane0 + (lane_id & 7) + (lane_id >> 4) * 8) * P +
                    ((lane_id >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        if (kk * 16 < D) {
          uint32_t a[4];
          uint32_t b[4];
          ldsm_x4(a, qa + kk * 16);
          ldsm_x4(b, kb + kk * 16);
          mma_bf16(s[0], a, b[0], b[1]);
          mma_bf16(s[1], a, b[2], b[3]);
        }
      }
    } else {
      const float* qr = reinterpret_cast<const float*>(sq) + g * P;
      const float* kr = reinterpret_cast<const float*>(sk) +
                        (lane0 + 2 * c4) * P;
#pragma unroll
      for (int d = 0; d < kD; d += 4) {
        if (d < D) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + d);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float4 kv =
                  *reinterpret_cast<const float4*>(kr + (n * 8 + e) * P + d);
              float t = s[n][e];
              t = fmaf(qv.x, kv.x, t);
              t = fmaf(qv.y, kv.y, t);
              t = fmaf(qv.z, kv.z, t);
              t = fmaf(qv.w, kv.w, t);
              s[n][e] = t;
            }
        }
      }
    }

    // mask by SELECT, then the online softmax of each row over this
    // warp's 16 lanes (a quad of threads holds a row)
    const int kpos0 = pos0 + c * p.chunk + lane0 + 2 * c4;
    float alpha[kR];
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      if (rr == 1 && !upper) {
#pragma unroll
        for (int n = 0; n < 2; ++n) s[n][2] = s[n][3] = 0.f;
        alpha[rr] = 1.f;
        continue;
      }
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][rr * 2 + e];
          x = kpos0 + n * 8 + e <= lim[rr] ? x * p.scale : kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][rr * 2 + e];
          x = expf(x - m_new);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      alpha[rr] = expf(m[rr] - m_new);
      l[rr] = alpha[rr] * l[rr] + sum;
      m[rr] = m_new;
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[n][rr * kE + e] *= alpha[rr];
    }

    // acc += P.V over this warp's lanes, p in the pool dtype
    if constexpr (kTc) {
      uint32_t pa[4];
      pa[0] = hopper::pack_bf16(s[0][0], s[0][1]);
      pa[1] = hopper::pack_bf16(s[0][2], s[0][3]);
      pa[2] = hopper::pack_bf16(s[1][0], s[1][1]);
      pa[3] = hopper::pack_bf16(s[1][2], s[1][3]);
      const T* vb = sv + (lane0 + (lane_id & 15)) * P;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        if (n * 8 < D) {
          uint32_t b[2];
          ldsm_x2_trans(b, vb + n * 8);
          mma_bf16(acc[n], pa, b[0], b[1]);
        }
      }
    } else {
      const float* vr = reinterpret_cast<const float*>(sv) + lane0 * P +
                        4 * c4;
#pragma unroll
      for (int t = 0; t < kLanes; ++t) {
        // lane t of the warp's 16 is held by quad member (t % 8) / 2
        const float pt = __shfl_sync(0xffffffffu, s[t / 8][t % 2],
                                     (lane_id & ~3) | ((t % 8) / 2));
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          if (n * 16 + 4 * c4 < D) {
            const float4 v4 =
                *reinterpret_cast<const float4*>(vr + t * P + n * 16);
            acc[n][0] = fmaf(pt, v4.x, acc[n][0]);
            acc[n][1] = fmaf(pt, v4.y, acc[n][1]);
            acc[n][2] = fmaf(pt, v4.z, acc[n][2]);
            acc[n][3] = fmaf(pt, v4.w, acc[n][3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  // merge the warps along kv in ascending order: each row's max and its
  // warps' weights once, then every element
  const int wkv_n = p.chunk / kLanes;
  float* mg_acc = reinterpret_cast<float*>(smem_raw);  // [wkv][row][D]
  float* mg_w = mg_acc + (size_t)wkv_n * kWarpRows * D;  // [wkv][row]
  float* mg_l = mg_w + wkv_n * kWarpRows;                // [wkv][row]
  float* mg_m = mg_l + wkv_n * kWarpRows;                // [row] merged m
  float* mg_sl = mg_m + kWarpRows;                       // [row] merged l
#pragma unroll
  for (int rr = 0; rr < kR; ++rr) {
    const int lr = g + 8 * rr;
    float* dst = mg_acc + ((size_t)warp * kWarpRows + lr) * D;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int d = kTc ? n * 8 + 2 * c4 : n * 16 + 4 * c4;
      if (d < D) {
#pragma unroll
        for (int e = 0; e < kE; ++e) dst[d + e] = acc[n][rr * kE + e];
      }
    }
    if (c4 == 0) {
      mg_w[warp * kWarpRows + lr] = m[rr];
      mg_l[warp * kWarpRows + lr] = l[rr];
    }
  }
  __syncthreads();
  const int rows_here = R - r0 < kWarpRows ? R - r0 : kWarpRows;
  if ((int)threadIdx.x < rows_here) {
    const int lr = threadIdx.x;
    float mx = mg_w[lr];
    for (int w = 1; w < wkv_n; ++w)
      mx = fmaxf(mx, mg_w[w * kWarpRows + lr]);
    float sl = 0.f;
    for (int w = 0; w < wkv_n; ++w) {
      const float wt = expf(mg_w[w * kWarpRows + lr] - mx);
      sl = w == 0 ? wt * mg_l[lr] : sl + wt * mg_l[w * kWarpRows + lr];
      mg_w[w * kWarpRows + lr] = wt;
    }
    mg_m[lr] = mx;
    mg_sl[lr] = sl;
  }
  __syncthreads();
  // a warp a row, its lanes along the head dim; a tile whose positions
  // all lie in split 0 writes its output, any other the split's partial
  T* out = static_cast<T*>(p.out);
  const bool direct = nsplit <= 1;
  for (int lr = warp; lr < rows_here; lr += blockDim.x / 32) {
    const int r = r0 + lr;
    const size_t orow = row_offset(p, tile, r, kvh, G);
    float* wsr = direct ? nullptr
                        : p.ws + ((((size_t)tile * p.num_kv_heads + kvh) *
                                       p.num_splits + split) * R + r) *
                                     (D + 2);
    for (int d = lane_id; d < D; d += 32) {
      float a = mg_w[lr] * mg_acc[(size_t)lr * D + d];
      for (int w = 1; w < wkv_n; ++w)
        a += mg_w[w * kWarpRows + lr] *
             mg_acc[((size_t)w * kWarpRows + lr) * D + d];
      if (direct)
        out[orow + d] = Traits<T>::store(a / fmaxf(mg_sl[lr], kLFloor));
      else
        wsr[d] = a;
    }
    if (!direct && lane_id == 0) {
      wsr[D] = mg_m[lr];
      wsr[D + 1] = mg_sl[lr];
    }
  }
}

// -- the combine kernel -----------------------------------------------------

// Merges the partials of a tile's splits in ascending order; tiles whose
// positions all lie in split 0 were written by split_kernel. A thread an
// element: its loads of every split's m, l and acc are independent, and
// the merge runs online, a = a * expf(m - m') + acc_s * expf(m_s - m'),
// from split 0's own a, l and m. A split that saw no visible position
// (m_s = -1e9) leaves the bits alone, so one split through here gives the
// bits of the direct write.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    combine_kernel(const Params p) {
  const int tile = blockIdx.x;
  const int kvh = blockIdx.y;
  const TileOrigin o = tile_origin<true>(p, tile);
  const int end = blocks_read(p, o.ctx, o.q0) * p.block_size;
  const int nsplit = (end + p.split - 1) / p.split;
  if (nsplit <= 1) return;
  const int D = p.head_dim;
  const int G = p.num_heads / p.num_kv_heads;
  const int R = p.tile_q * G;
  const size_t stride = (size_t)R * (D + 2);  // one split's partials
  const float* ws = p.ws + ((size_t)tile * p.num_kv_heads + kvh) *
                               p.num_splits * stride;
  T* out = static_cast<T*>(p.out);
  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    const float* w = ws + (size_t)r * (D + 2);
    float mx = w[D];
    float sl = w[D + 1];
    float a = w[d];
#pragma unroll 4
    for (int s = 1; s < nsplit; ++s) {
      const float* ws_s = w + s * stride;
      const float m_s = ws_s[D];
      const float m_new = fmaxf(mx, m_s);
      const float old = expf(mx - m_new);
      const float wt = expf(m_s - m_new);
      a = a * old + ws_s[d] * wt;
      sl = sl * old + ws_s[D + 1] * wt;
      mx = m_new;
    }
    out[row_offset(p, tile, r, kvh, G) + d] =
        Traits<T>::store(a / fmaxf(sl, kLFloor));
  }
}

}  // namespace rtc
}  // namespace ptt
