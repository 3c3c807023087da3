"""flash_selfcheck of the port against the JAX package's
(tests/test_flash_selfcheck.py on the port).

On the CPU the dispatch gate is forced (`would_use_flash`, as JAX's test
forces `_on_tpu`), so the flash path runs the kernels' plain versions
and the check logic itself is validated without a card; the card run is
chip_smoke.py's `selfcheck` phase. JAX's check runs at its own test's
shape in interpret mode, and both packages must agree on the result's
keys and pass the same bar.
"""

import pytest
import torch

from paddle_tpu_torch.kernels import attention as A
from paddle_tpu_torch.kernels import flash
from paddle_tpu_torch.kernels.selfcheck import (EXPECTED_LAUNCHES,
                                                flash_selfcheck)

# JAX's test shape (tests/test_flash_selfcheck.py)
SHAPE = dict(batch=1, heads=2, seq=512, head_dim=32)


@pytest.fixture(scope="module")
def jax_result():
    import jax.numpy as jnp
    from paddle_tpu.kernels import attention as JA
    from paddle_tpu.kernels.selfcheck import flash_selfcheck as jax_check
    mp = pytest.MonkeyPatch()
    mp.setattr(JA, "_on_tpu", lambda: True)
    try:
        return jax_check(**SHAPE, dtype=jnp.float32, atol=1e-3)
    finally:
        mp.undo()


def test_flash_selfcheck_on_cpu(monkeypatch):
    monkeypatch.setattr(A, "would_use_flash", lambda *a, **k: True)
    out = flash_selfcheck(**SHAPE, dtype=torch.float32, atol=1e-3,
                          device="cpu")
    assert out["flash_check"] == "ok"
    assert out["flash_max_rel_err"] < 1e-3


def test_flash_selfcheck_detects_gate_not_taken(monkeypatch):
    monkeypatch.setattr(A, "would_use_flash", lambda *a, **k: False)
    with pytest.raises(AssertionError, match="did NOT take the flash path"):
        flash_selfcheck(**SHAPE, device="cpu")


def test_result_keys_and_bar_are_jaxs(monkeypatch, jax_result):
    monkeypatch.setattr(A, "would_use_flash", lambda *a, **k: True)
    out = flash_selfcheck(**SHAPE, dtype=torch.float32, atol=1e-3,
                          device="cpu")
    assert set(out) == set(jax_result)
    assert out["flash_check"] == jax_result["flash_check"] == "ok"
    assert out["flash_platform"] == jax_result["flash_platform"] == "cpu"
    for key in ("flash_max_rel_err", "flash_seg_rel_err"):
        assert out[key] < 1e-3 and jax_result[key] < 1e-3, (out, jax_result)


def test_expected_launches_are_the_flash_calls_it_makes(monkeypatch):
    """EXPECTED_LAUNCHES (what the card run asserts) is the number of
    calls of each kernel's dispatcher the checks make, counted here on
    the plain versions."""
    monkeypatch.setattr(A, "would_use_flash", lambda *a, **k: True)
    calls = dict.fromkeys(EXPECTED_LAUNCHES, 0)
    for name in calls:
        orig = getattr(flash, name)

        def counted(*args, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*args, **kw)
        counted.launches = 0      # the card's counter, read on the card
        monkeypatch.setattr(flash, name, counted)
    flash_selfcheck(batch=1, heads=2, seq=128, head_dim=32,
                    dtype=torch.float32, atol=1e-3, device="cpu")
    assert calls == EXPECTED_LAUNCHES


def test_default_device_is_the_card():
    # no card where these tests run, and no fallback to the CPU
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        flash_selfcheck(**SHAPE)
