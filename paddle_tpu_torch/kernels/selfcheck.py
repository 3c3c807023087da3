"""On-card flash-attention correctness gate (port of
paddle_tpu/kernels/selfcheck.py).

The CPU tests hold the flash kernels' plain versions; only a run on the
card launches the CUDA kernels. `flash_selfcheck()` runs the flash path
and the plain reference on the same batch — forward AND backward —
asserts the dispatch gate took the flash branch, compares numerics,
checks the segment-id masking and the in-kernel dropout, and on the
card asserts that kernels 4, 5 and 6 launched as often as the checks
call them (`EXPECTED_LAUNCHES`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.kernels import attention as A
from paddle_tpu_torch.kernels import flash as flash_mod

#: kernel launches one flash_selfcheck makes on the card: the forward
#: (1), the forward and backward under autograd (1 + dq + dk/dv), the
#: segment-id forward (1) and the two dropout forwards (2)
EXPECTED_LAUNCHES = {"flash_fwd": 5, "flash_dq": 1, "flash_dkv": 1}


def _launch_counts() -> Dict[str, int]:
    return {"flash_fwd": flash_mod.flash_fwd.launches,
            "flash_dq": flash_mod.flash_dq.launches,
            "flash_dkv": flash_mod.flash_dkv.launches}


def flash_selfcheck(batch: int = 2, heads: int = 4, seq: int = 1024,
                    head_dim: int = 64, causal: bool = True,
                    dtype: torch.dtype = torch.bfloat16, atol: float = 5e-2,
                    device: DeviceLike = None) -> Dict:
    """Compare flash vs reference attention fwd+bwd on one batch on
    `device` (default the card).

    Returns {"flash_check": "ok", "flash_max_rel_err": ...,
    "flash_seg_rel_err": ..., "flash_platform": device type} or raises
    AssertionError. Tolerance is bf16-scale: both paths use fp32
    softmax/accumulation, so outputs agree to bf16 rounding.
    """
    dev = resolve_device(device)
    rs = np.random.RandomState(0)

    def draw():
        x = torch.from_numpy(rs.randn(batch, seq, heads, head_dim))
        return x.to(device=dev, dtype=dtype) * 0.3

    q, k, v = draw(), draw(), draw()
    before = _launch_counts()

    # 1. the dispatch gate must choose flash for this shape on this device
    taken = {"flash": False}
    orig = flash_mod.flash_attention

    def spy(*args, **kw):
        taken["flash"] = True
        return orig(*args, **kw)

    def loss_flash(q, k, v):
        return torch.sum(A.mha(q, k, v, causal=causal).float() ** 2)

    flash_mod.flash_attention = spy
    try:
        with torch.no_grad():
            f_out = A.mha(q, k, v, causal=causal)
        f_grads = _grads(loss_flash, q, k, v)
    finally:
        flash_mod.flash_attention = orig
    assert taken["flash"], (
        "flash_selfcheck: dispatch gate did NOT take the flash path "
        f"(device={dev}, would_use_flash="
        f"{A.would_use_flash(q, k)})")

    # 2. reference path on the same batch
    mask = _causal_mask(seq, dev) if causal else None

    def loss_ref(q, k, v):
        return torch.sum(A.reference_attention(q, k, v, mask=mask)
                         .float() ** 2)

    with torch.no_grad():
        r_out = A.reference_attention(q, k, v, mask=mask)
    r_grads = _grads(loss_ref, q, k, v)

    max_rel = 0.0
    for a, b in zip((f_out, *f_grads), (r_out, *r_grads)):
        a, b = a.float(), b.float()
        scale = float(b.abs().max()) + 1e-6
        max_rel = max(max_rel, float((a - b).abs().max()) / scale)
    assert max_rel < atol, (
        f"flash_selfcheck: flash vs reference mismatch: max relative "
        f"error {max_rel:.4f} (tol {atol})")

    # 3. segment-id (packed-batch) masking: block-sparse skipping must
    # not change values vs the dense masked reference
    segs = np.zeros((batch, seq), np.int32)
    segs[:, seq // 3:] = 1
    segs[:, 2 * seq // 3:] = 2
    segs_t = torch.from_numpy(segs).to(dev)
    with torch.no_grad():
        s_out = A.mha(q, k, v, causal=causal, segment_ids=segs_t)
        smask = segs_t[:, None, :, None] == segs_t[:, None, None, :]
        if causal:
            smask = smask & mask
        s_ref = A.reference_attention(q, k, v, mask=smask)
    seg_err = float((s_out.float() - s_ref.float()).abs().max()) / (
        float(s_ref.float().abs().max()) + 1e-6)
    assert seg_err < atol, (
        f"flash_selfcheck: segment-id path mismatch: {seg_err:.4f}")

    # 4. in-kernel dropout: deterministic per seed, and a rate of 0.5
    # changes the output
    def dropped():
        gen = torch.Generator(device=dev).manual_seed(3)
        with torch.no_grad():
            return A.mha(q, k, v, causal=causal, dropout_rate=0.5,
                         generator=gen)

    d1, d2 = dropped(), dropped()
    drop_det = float((d1.float() - d2.float()).abs().max())
    assert drop_det == 0.0, (
        f"flash_selfcheck: dropout not deterministic per seed: {drop_det}")
    assert not np.allclose(d1.float().cpu().numpy(),
                           f_out.float().cpu().numpy()), (
        "flash_selfcheck: dropout_rate=0.5 did not change the output "
        "(in-kernel dropout is not being applied)")

    if dev.type == "cuda":
        after = _launch_counts()
        moved = {n: after[n] - before[n] for n in after}
        assert moved == EXPECTED_LAUNCHES, (
            f"flash_selfcheck: kernel launches {moved} != "
            f"{EXPECTED_LAUNCHES}")

    return {"flash_check": "ok", "flash_max_rel_err": round(max_rel, 5),
            "flash_seg_rel_err": round(seg_err, 5),
            "flash_platform": dev.type}


def _grads(loss_fn, q, k, v):
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    return torch.autograd.grad(loss_fn(*leaves), leaves)


def _causal_mask(t: int, device: torch.device) -> torch.Tensor:
    pos = torch.arange(t, device=device)
    return (pos[None, :] <= pos[:, None])[None, None]
