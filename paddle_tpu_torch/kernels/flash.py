"""Flash attention of the port, forward and backward (port of
paddle_tpu/kernels/flash.py).

Layout: q [B, Tq, H, D], k/v [B, Tk, H, D] with equal head counts
(`attention.mha` repeats GQA's k/v heads first), the JAX package's
public layout; the kernels read it in place. The log-sum-exp residual is
lse [B, H, Tq] float32, which is JAX's [BH, T] (there lane-broadcast to
128) with bh = b * H + h.

Masking, all without a dense [Tq, Tk] tensor on the kernel path: a pair
(q, k) is visible iff k <= q when `causal`, k < `kv_len` when given, and
the segment ids are equal when `segment_ids` is given (a [B, T] tensor
for self-attention or a (q_seg [B, Tq], kv_seg [B, Tk]) pair). Masked
scores are SELECTED to -1e30. A row with no visible key yields finite
garbage (flash.py:596). Attention dropout is the JAX kernels' stateless
hash of (seed, b * H + h, q, k) (`dropout_keep`), so the forward and
both backward kernels drop the same pairs.

Three kernels, each with two implementations of one contract:

- a plain PyTorch version (`flash_fwd_reference`, `flash_dq_reference`,
  `flash_dkv_reference`), dense and in float32, taking the kernel's own
  inputs (for dq and dk/dv: o, lse and dO too), so each kernel is held
  alone. The CPU tests use them, and the dispatchers run them for
  tensors that lie on the CPU;
- a hand-written CUDA kernel in kernels/csrc/flash_attention.cu. For
  CUDA tensors `flash_fwd` / `flash_dq` / `flash_dkv` launch it or
  raise; they never fall back:
  - `ptt_flash_fwd` replaces `_fwd_kernel` (flash.py:202),
  - `ptt_flash_dq` replaces `_dq_kernel` (:363),
  - `ptt_flash_dkv` replaces `_dkv_kernel` (:419).
  In bf16 all three run on the tensor cores (`wgmma` + TMA,
  kernels/csrc/flash_tc.cuh); in f32 on the CUDA cores.

`flash_fwd_op` is `flash_fwd` registered as the operator
`paddle_tpu_torch::flash_fwd` (with a fake for tracing), so that
`torch.export` records kernel 4 in an exported program
(io/inference.py). `FlashCore` (for `_flash_core`, :551-578) is the
autograd Function: its forward launches kernel 4 through the operator
and saves lse, its backward kernels 5 and 6. `flash_attention` is the
wrapper. Unlike the JAX wrapper it does not pad T to a block multiple:
the kernels bound-check their tails.

`flash_dq_op` and `flash_dkv_op` register kernels 5 and 6 the same way
(`paddle_tpu_torch::flash_dq`, `::flash_dkv`), and `FlashCore`'s
backward calls them, so that a `torch.profiler` trace links each kernel
to an operator of its own (profiler/device_trace.py groups kernels by
the op that launched them) and not to the autograd node that runs both.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.kernels import build

NEG_INF = -1e30
LSE_FLOOR = 1e-30

_KERNEL = "flash_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF


# -- segment ids and the dropout hash -------------------------------------

def normalize_segment_ids(segment_ids, b: int, t_q: int, t_k: int):
    """A [B, T] tensor (self-attention: ids shared by q and kv) or a
    (q_seg [B, Tq], kv_seg [B, Tk]) pair -> (q_seg, kv_seg) int32,
    shape-checked (flash.py:72)."""
    if isinstance(segment_ids, (tuple, list)):
        q_seg, kv_seg = segment_ids
    else:
        q_seg = kv_seg = segment_ids
    q_seg = torch.as_tensor(q_seg).to(torch.int32)
    kv_seg = torch.as_tensor(kv_seg).to(torch.int32)
    if q_seg.shape != (b, t_q) or kv_seg.shape != (b, t_k):
        raise ValueError(
            f"segment_ids shapes {tuple(q_seg.shape)}/{tuple(kv_seg.shape)} "
            f"do not match q [{b},{t_q}] / kv [{b},{t_k}]")
    return q_seg, kv_seg


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, in two 16-bit
    halves of c so no product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 finalizer on uint32 values held in int64 (flash.py
    _mix32 :134)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_threshold(rate: float) -> int:
    """uint32(rate * 2^32), as flash.py:153 computes it on the host: the
    double product truncated toward zero."""
    return int(rate * 4294967296.0)


def dropout_scale(rate: float) -> float:
    """The keep multiplier 1 / (1 - rate), rounded once to float32."""
    return float(np.float32(1.0 / (1.0 - rate)))


def dropout_keep(seed, bh, q_pos, k_pos, rate: float) -> torch.Tensor:
    """The keep bit of pairs (q_pos, k_pos) of head bh = b * H + h under
    `seed`, bit for bit flash.py's _dropout_keep (:143): int64 tensors
    (broadcast together) whose low 32 bits are the uint32 operands."""
    seed = torch.as_tensor(seed, dtype=torch.int64) & _M32
    bh = torch.as_tensor(bh, dtype=torch.int64) & _M32
    key = mix32((seed + _mul32(bh, 0xC2B2AE3D)) & _M32)
    u = mix32(((_mul32(torch.as_tensor(q_pos, dtype=torch.int64) & _M32,
                       0x9E3779B1)
                + _mul32(torch.as_tensor(k_pos, dtype=torch.int64) & _M32,
                         0x85EBCA77)) & _M32) ^ key)
    return u >= dropout_threshold(rate)


def draw_seed(generator: torch.Generator) -> torch.Tensor:
    """The dropout seed: one int32 in [0, 2^31 - 1) drawn from the
    caller's generator, as flash.py:628 draws it from the rng; a [1]
    tensor on the generator's device (the kernels read it there, so no
    host sync)."""
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=generator.device, dtype=torch.int32)


# -- plain versions -------------------------------------------------------

def visible_pairs(b: int, t_q: int, t_k: int, causal: bool,
                  kv_len: Optional[int], q_seg=None, kv_seg=None,
                  device=None) -> torch.Tensor:
    """[1|B, 1, Tq, Tk] bool: which (q, k) pairs the mask leaves visible."""
    qpos = torch.arange(t_q, device=device)[:, None]
    kpos = torch.arange(t_k, device=device)[None, :]
    vis = torch.ones(t_q, t_k, dtype=torch.bool, device=device)
    if causal:
        vis = vis & (kpos <= qpos)
    if kv_len is not None:
        vis = vis & (kpos < kv_len)
    vis = vis[None, None]
    if q_seg is not None:
        vis = vis & (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
    return vis


def _keep_mask(seed, b: int, h: int, t_q: int, t_k: int, rate: float,
               device) -> torch.Tensor:
    """[B, H, Tq, Tk] keep bits of every pair."""
    bh = torch.arange(b * h, device=device).reshape(b, h, 1, 1)
    return dropout_keep(seed.reshape(()).long(), bh,
                        torch.arange(t_q, device=device)[:, None],
                        torch.arange(t_k, device=device)[None, :], rate)


def _bhtd(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] -> float32 [B, H, T, D]."""
    return x.float().transpose(1, 2)


def _scores(q, k, scale, vis):
    s = torch.matmul(_bhtd(q), _bhtd(k).transpose(-1, -2)) * scale
    return torch.where(vis, s, NEG_INF)


def flash_fwd_reference(q, k, v, q_seg=None, kv_seg=None, seed=None, *,
                        scale: float, causal: bool = False,
                        kv_len: Optional[int] = None,
                        dropout_rate: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain kernel 4: (o [B, Tq, H, D] in q's dtype, lse [B, H, Tq] f32).
    The denominator l sums the undropped p; p (dropped, scaled) is
    rounded to v's dtype before P.V; o = acc / max(l, 1e-30) and
    lse = m + log(max(l, 1e-30))."""
    b, t_q, h, _ = q.shape
    t_k = k.shape[1]
    vis = visible_pairs(b, t_q, t_k, causal, kv_len, q_seg, kv_seg, q.device)
    s = _scores(q, k, scale, vis)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    lf = p.sum(-1, keepdim=True).clamp_min(LSE_FLOOR)
    if dropout_rate > 0.0:
        keep = _keep_mask(seed, b, h, t_q, t_k, dropout_rate, q.device)
        p = torch.where(keep, p * dropout_scale(dropout_rate), 0.0)
    o = torch.matmul(p.to(v.dtype).float(), _bhtd(v)) / lf
    lse = (m + torch.log(lf))[..., 0]
    return o.transpose(1, 2).to(q.dtype).contiguous(), lse.contiguous()


def _bwd_common(q, k, v, o, lse, do, q_seg, kv_seg, seed, scale, causal,
                kv_len, dropout_rate):
    """p, the keep bits (or None), dp and delta of the backward kernels."""
    b, t_q, h, _ = q.shape
    t_k = k.shape[1]
    vis = visible_pairs(b, t_q, t_k, causal, kv_len, q_seg, kv_seg, q.device)
    p = torch.exp(_scores(q, k, scale, vis) - lse[..., None])
    dp = torch.matmul(_bhtd(do), _bhtd(v).transpose(-1, -2))
    keep = None
    if dropout_rate > 0.0:
        keep = _keep_mask(seed, b, h, t_q, t_k, dropout_rate, q.device)
        dp = torch.where(keep, dp * dropout_scale(dropout_rate), 0.0)
    delta = (_bhtd(do) * _bhtd(o)).sum(-1, keepdim=True)
    return p, keep, p * (dp - delta)


def flash_dq_reference(q, k, v, o, lse, do, q_seg=None, kv_seg=None,
                       seed=None, *, scale: float, causal: bool = False,
                       kv_len: Optional[int] = None,
                       dropout_rate: float = 0.0) -> torch.Tensor:
    """Plain kernel 5: dq = scale * ds @ k, ds = p * (dp - delta) rounded
    to k's dtype, p = exp(s - lse), dp dropped with the forward's keep
    bits, delta = sum(dO * o). Returns dq [B, Tq, H, D] in q's dtype."""
    _, _, ds = _bwd_common(q, k, v, o, lse, do, q_seg, kv_seg, seed, scale,
                           causal, kv_len, dropout_rate)
    dq = scale * torch.matmul(ds.to(k.dtype).float(), _bhtd(k))
    return dq.transpose(1, 2).to(q.dtype).contiguous()


def flash_dkv_reference(q, k, v, o, lse, do, q_seg=None, kv_seg=None,
                        seed=None, *, scale: float, causal: bool = False,
                        kv_len: Optional[int] = None,
                        dropout_rate: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain kernel 6: dv = g^T @ dO with g the dropped p rounded to dO's
    dtype, dk = scale * ds^T @ q with ds rounded to q's dtype. Returns
    (dk, dv) [B, Tk, H, D] in k's and v's dtype."""
    p, keep, ds = _bwd_common(q, k, v, o, lse, do, q_seg, kv_seg, seed,
                              scale, causal, kv_len, dropout_rate)
    g = p if keep is None else torch.where(
        keep, p * dropout_scale(dropout_rate), 0.0)
    dv = torch.matmul(g.to(do.dtype).float().transpose(-1, -2), _bhtd(do))
    dk = scale * torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                              _bhtd(q))
    return (dk.transpose(1, 2).to(k.dtype).contiguous(),
            dv.transpose(1, 2).to(v.dtype).contiguous())


# -- CUDA launches ----------------------------------------------------------

_TYPED = False


def _library() -> ctypes.CDLL:
    """The built flash library, its entry points typed."""
    global _TYPED
    lib = build.load(_KERNEL)
    if not _TYPED:
        p, i, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_uint)
        tail = [i] * 7 + [f, u, f, i, i, p]
        lib.ptt_flash_fwd.argtypes = [p] * 8 + tail
        lib.ptt_flash_dq.argtypes = [p] * 10 + tail
        lib.ptt_flash_dkv.argtypes = [p] * 11 + tail
        for fn in (lib.ptt_flash_fwd, lib.ptt_flash_dq, lib.ptt_flash_dkv):
            fn.restype = ctypes.c_int
        lib.ptt_flash_smem_bytes.argtypes = [i, i]
        lib.ptt_flash_smem_bytes.restype = ctypes.c_size_t
        lib.ptt_flash_tc_smem_bytes.argtypes = [i, i]
        lib.ptt_flash_tc_smem_bytes.restype = ctypes.c_size_t
        lib.ptt_cuda_error_string.argtypes = [i]
        lib.ptt_cuda_error_string.restype = ctypes.c_char_p
        _TYPED = True
    return lib


def shared_memory_bytes(which: str, head_dim: int,
                        dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory one CTA of kernel `which` ("fwd", "dq",
    "dkv") takes at this head dim in `dtype` (the kernel's own count:
    the bf16 kernels are the tensor-core ones)."""
    lib = _library()
    fn = (lib.ptt_flash_tc_smem_bytes if dtype == torch.bfloat16
          else lib.ptt_flash_smem_bytes)
    return int(fn(("fwd", "dq", "dkv").index(which), head_dim))


def _check_launch(floats, lse, q_seg, kv_seg, seed) -> None:
    """What the CUDA entry points need: one device; contiguous; q/k/v
    (and o, dO) of one dtype, f32 or bf16, 16-byte aligned; D a multiple
    of 8 up to 256; int32 segment ids and seed; float32 lse."""
    q = floats[0]
    d = q.shape[-1]
    ints = [x for x in (q_seg, kv_seg, seed) if x is not None]
    extra = [lse] if lse is not None else []
    for x in list(floats) + ints + extra:
        if x.device != q.device:
            raise ValueError(f"operands on {x.device} and {q.device}")
        if not x.is_contiguous():
            raise ValueError("flash kernels need contiguous operands")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if any(x.dtype != q.dtype for x in floats):
        raise TypeError("q, k, v, o and dO must share one dtype")
    if any(x.dtype != torch.int32 for x in ints):
        raise TypeError("segment ids and the seed must be int32")
    if lse is not None and lse.dtype != torch.float32:
        raise TypeError("lse must be float32")
    if d % 8 or d > 256:
        raise ValueError(f"head dim {d} must be a multiple of 8, <= 256")
    if any(x.data_ptr() % 16 for x in floats):
        raise ValueError("q, k, v, o and dO must be 16-byte aligned")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _tail(q, k, scale, causal, kv_len, dropout_rate):
    b, t_q, h, d = q.shape
    drop = dropout_rate > 0.0
    return (b, h, t_q, k.shape[1], d, -1 if kv_len is None else int(kv_len),
            int(causal), float(scale),
            dropout_threshold(dropout_rate) if drop else 0,
            dropout_scale(dropout_rate) if drop else 1.0, int(drop),
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device)
            .cuda_stream)


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.ptt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {rc} ({msg})")


def _check_shapes(q, k, v, extra=()) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B, Tq, H, D] and k/v [B, Tk, H, D]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch, heads or head dim")
    if any(x.shape != q.shape for x in extra):
        raise ValueError("o and dO must have q's shape")


def _device_of(q, name: str) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} for device {q.device}")
    return q.device.type


def flash_fwd(q, k, v, q_seg=None, kv_seg=None, seed=None, *, scale: float,
              causal: bool = False, kv_len: Optional[int] = None,
              dropout_rate: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 4: (o, lse). Plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (launched or raised)."""
    _check_shapes(q, k, v)
    kw = dict(scale=scale, causal=causal, kv_len=kv_len,
              dropout_rate=dropout_rate)
    if _device_of(q, "flash_fwd") == "cpu":
        return flash_fwd_reference(q, k, v, q_seg, kv_seg, seed, **kw)
    _check_launch((q, k, v), None, q_seg, kv_seg, seed)
    lib = _library()
    b, t_q, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.ptt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_seg),
            _ptr(kv_seg), _ptr(seed), out.data_ptr(), lse.data_ptr(),
            *_tail(q, k, scale, causal, kv_len, dropout_rate))
    _raise_on(lib, rc, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def flash_dq(q, k, v, o, lse, do, q_seg=None, kv_seg=None, seed=None, *,
             scale: float, causal: bool = False,
             kv_len: Optional[int] = None,
             dropout_rate: float = 0.0) -> torch.Tensor:
    """Kernel 5: dq. Dispatch by device as `flash_fwd`."""
    _check_shapes(q, k, v, (o, do))
    kw = dict(scale=scale, causal=causal, kv_len=kv_len,
              dropout_rate=dropout_rate)
    if _device_of(q, "flash_dq") == "cpu":
        return flash_dq_reference(q, k, v, o, lse, do, q_seg, kv_seg, seed,
                                  **kw)
    _check_launch((q, k, v, o, do), lse, q_seg, kv_seg, seed)
    lib = _library()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.ptt_flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
            _ptr(seed), dq.data_ptr(),
            *_tail(q, k, scale, causal, kv_len, dropout_rate))
    _raise_on(lib, rc, "flash_dq")
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, o, lse, do, q_seg=None, kv_seg=None, seed=None, *,
              scale: float, causal: bool = False,
              kv_len: Optional[int] = None,
              dropout_rate: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 6: (dk, dv). Dispatch by device as `flash_fwd`."""
    _check_shapes(q, k, v, (o, do))
    kw = dict(scale=scale, causal=causal, kv_len=kv_len,
              dropout_rate=dropout_rate)
    if _device_of(q, "flash_dkv") == "cpu":
        return flash_dkv_reference(q, k, v, o, lse, do, q_seg, kv_seg, seed,
                                   **kw)
    _check_launch((q, k, v, o, do), lse, q_seg, kv_seg, seed)
    lib = _library()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = lib.ptt_flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
            _ptr(seed), dk.data_ptr(), dv.data_ptr(),
            *_tail(q, k, scale, causal, kv_len, dropout_rate))
    _raise_on(lib, rc, "flash_dkv")
    flash_dkv.launches += 1
    return dk, dv


# kernel launches since the last reset (set to 0 to reset); the plain
# versions on CPU tensors count in none of them
flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


# -- the forward as an operator, autograd and the wrapper -------------------

@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_seg: Optional[torch.Tensor], kv_seg: Optional[torch.Tensor],
                 seed: Optional[torch.Tensor], scale: float, causal: bool,
                 kv_len: Optional[int], dropout_rate: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flash_fwd` as the operator `paddle_tpu_torch::flash_fwd`, so that
    `torch.export` records the call (a ctypes launch cannot be traced on
    fake tensors) and an exported program launches kernel 4 when it runs
    on the card. `flash_fwd` is looked up in this module at call time."""
    return flash_fwd(q, k, v, q_seg, kv_seg, seed, scale=scale,
                     causal=causal, kv_len=kv_len, dropout_rate=dropout_rate)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, q_seg, kv_seg, seed, scale, causal, kv_len,
                    dropout_rate):
    b, t_q, h, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((b, h, t_q), dtype=torch.float32))


@torch.library.custom_op("paddle_tpu_torch::flash_dq", mutates_args=())
def flash_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                q_seg: Optional[torch.Tensor], kv_seg: Optional[torch.Tensor],
                seed: Optional[torch.Tensor], scale: float, causal: bool,
                kv_len: Optional[int], dropout_rate: float) -> torch.Tensor:
    """`flash_dq` as the operator `paddle_tpu_torch::flash_dq`;
    `flash_dq` is looked up in this module at call time."""
    return flash_dq(q, k, v, o, lse, do, q_seg, kv_seg, seed, scale=scale,
                    causal=causal, kv_len=kv_len, dropout_rate=dropout_rate)


@flash_dq_op.register_fake
def _flash_dq_fake(q, k, v, o, lse, do, q_seg, kv_seg, seed, scale, causal,
                   kv_len, dropout_rate):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@torch.library.custom_op("paddle_tpu_torch::flash_dkv", mutates_args=())
def flash_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                 q_seg: Optional[torch.Tensor],
                 kv_seg: Optional[torch.Tensor],
                 seed: Optional[torch.Tensor], scale: float, causal: bool,
                 kv_len: Optional[int], dropout_rate: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flash_dkv` as the operator `paddle_tpu_torch::flash_dkv`;
    `flash_dkv` is looked up in this module at call time."""
    return flash_dkv(q, k, v, o, lse, do, q_seg, kv_seg, seed, scale=scale,
                     causal=causal, kv_len=kv_len, dropout_rate=dropout_rate)


@flash_dkv_op.register_fake
def _flash_dkv_fake(q, k, v, o, lse, do, q_seg, kv_seg, seed, scale, causal,
                    kv_len, dropout_rate):
    return (torch.empty_like(k, memory_format=torch.contiguous_format),
            torch.empty_like(v, memory_format=torch.contiguous_format))


class FlashCore(torch.autograd.Function):
    """`_flash_core` (flash.py:551-578): the forward runs kernel 4
    (through `flash_fwd_op`) and saves lse; the backward runs kernels 5
    and 6 (through `flash_dq_op` and `flash_dkv_op`). The kernels are
    looked up in this module at call time."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, seed, scale, causal, kv_len,
                dropout_rate):
        cfg = dict(scale=scale, causal=causal, kv_len=kv_len,
                   dropout_rate=dropout_rate)
        o, lse = flash_fwd_op(q, k, v, q_seg, kv_seg, seed, scale, causal,
                              kv_len, dropout_rate)
        ctx.save_for_backward(q, k, v, o, lse, q_seg, kv_seg, seed)
        ctx.cfg = cfg
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_seg, kv_seg, seed = ctx.saved_tensors
        do = do.contiguous()
        cfg = ctx.cfg
        args = (q, k, v, o, lse, do, q_seg, kv_seg, seed, cfg["scale"],
                cfg["causal"], cfg["kv_len"], cfg["dropout_rate"])
        dq = flash_dq_op(*args)
        dk, dv = flash_dkv_op(*args)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q, k, v, scale: Optional[float] = None,
                    causal: bool = False, kv_len: Optional[int] = None,
                    segment_ids=None, dropout_rate: float = 0.0,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """q [B, Tq, H, D]; k/v [B, Tk, H, D] -> [B, Tq, H, D].
    Differentiable (`FlashCore`).

    segment_ids: a [B, T] tensor or a (q_seg, kv_seg) pair; tokens attend
    only where ids are equal. dropout_rate: in-kernel attention dropout,
    seeded by an int32 drawn from `generator`; with no generator it runs
    without dropout (flash.py:623-626). Every real token must see at
    least one key (causal self-attention always does): a row with none
    is finite garbage."""
    if dropout_rate >= 1.0:
        raise ValueError("dropout_rate must be < 1.0")
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    if k.shape[2] != h:
        raise ValueError(f"flash_attention takes equal head counts; got q "
                         f"{h}, k/v {k.shape[2]} (mha repeats kv heads)")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    q_seg = kv_seg = None
    if segment_ids is not None:
        q_seg, kv_seg = (s.to(q.device).contiguous() for s in
                         normalize_segment_ids(segment_ids, b, t_q, t_k))
    seed = None
    if dropout_rate > 0.0:
        if generator is None:
            dropout_rate = 0.0
        else:
            seed = draw_seed(generator).to(q.device)
    return FlashCore.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                           q_seg, kv_seg, seed, float(scale), bool(causal),
                           kv_len, float(dropout_rate))
