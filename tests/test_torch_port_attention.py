"""Port parity: attention and the flash-attention forward (ray_tpu_torch.ops).

The same numpy inputs go through the JAX function and its port, in f32. The
JAX results are computed once for the module, in two jitted calls: the three
cases of the Pallas forward kernel B1a in interpret mode (as
tests/test_flash_attention.py runs it on the CPU), and the rest through the
plain jnp functions. On the CPU the port's flash wrapper takes its plain version,
which is what the kernel is held to on the card.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.ops.attention  # noqa: F401  (the package re-exports a function of that name)
import ray_tpu.ops.flash_attention  # noqa: F401
from ray_tpu_torch.ops import attention as pt_attn
from ray_tpu_torch.ops import flash_attention as pt_flash

from _torch_port_util import one_torch_thread  # noqa: F401

jax_attn = sys.modules["ray_tpu.ops.attention"]
jax_flash = sys.modules["ray_tpu.ops.flash_attention"]

FLASH_TOL = 2e-3  # the forward bound of tests/test_flash_attention.py:21 (blockwise sums)
ATTN_TOL = 1e-5  # the same f32 softmax on both sides; only the summation order differs

# Pallas B1a cases: GQA 4/2, S=64 in 32-row tiles (so causal skips a tile)
PALLAS_CASES = {"causal": dict(causal=True, seg=False),
                "full": dict(causal=False, seg=False),
                "segments": dict(causal=True, seg=True)}
PALLAS_SHAPE = dict(b=1, s=64, h=4, hkv=2, d=64)
# lengths that are no tile multiple, held against the plain jnp reference
RAGGED_CASES = {"s37-causal": (2, 37, 8, 2, True), "s100-full": (1, 100, 8, 2, False),
                "s16-causal": (1, 16, 4, 2, True), "s5-mha": (1, 5, 2, 2, True)}
# masking surface of attention_reference / attention_chunked: Sq=6 over Skv=16,
# the last 6 kv slots in segment 1, so with q_offset=8 some rows see nothing
MASK_CASES = {
    "causal": dict(causal=True),
    "offset-validlen": dict(causal=True, q_offset=3, kv_valid_len=12),
    "full-validlen": dict(causal=False, kv_valid_len=9),
    "offset-segments": dict(causal=True, q_offset=8, segments=True),
    "all-masked": dict(causal=True, kv_valid_len=0),
}


def _qkv(seed, b, sq, skv, h, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    return q, k, v


def _pallas_inputs():
    p = PALLAS_SHAPE
    q, k, v = _qkv(0, p["b"], p["s"], p["s"], p["h"], p["hkv"], p["d"])
    seg = np.concatenate([np.zeros((1, 24), np.int32), np.ones((1, 40), np.int32)], 1)
    return q, k, v, seg


def _mask_inputs():
    q, k, v = _qkv(3, 2, 6, 16, 4, 2, 16)
    seg = np.concatenate([np.zeros((2, 10), np.int32), np.ones((2, 6), np.int32)], 1)
    return q, k, v, seg


def _ragged_inputs(name):
    b, s, h, hkv, _ = RAGGED_CASES[name]
    return _qkv(1, b, s, s, h, hkv, 64)


@pytest.fixture(scope="module")
def jax_pallas():
    """B1a's three cases in Pallas interpret mode, from one jitted call."""
    def run():
        out = {}
        q, k, v, seg = (jnp.asarray(x) for x in _pallas_inputs())
        bhsd = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
        for name, c in PALLAS_CASES.items():
            seg_q = seg_kv = None
            if c["seg"]:
                seg_q = seg_kv = jnp.broadcast_to(seg[:, :, None], (*seg.shape, 128))
            o, lse = jax_flash._fwd(bhsd(q), bhsd(k), bhsd(v), seg_q, seg_kv,
                                    PALLAS_SHAPE["d"] ** -0.5, c["causal"], 32, 32)
            out[name] = (bhsd(o), lse)
        return out

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)())


@pytest.fixture(scope="module")
def jax_out():
    """The plain jnp results of this module, from one jitted call."""
    def run():
        out = {}
        for name, case in RAGGED_CASES.items():
            q, k, v = (jnp.asarray(x) for x in _ragged_inputs(name))
            out["ragged", name] = jax_attn.attention_reference(q, k, v, causal=case[4])
        q, k, v, seg = (jnp.asarray(x) for x in _mask_inputs())
        for name, kw in MASK_CASES.items():
            kw = dict(kw)
            segs = seg if kw.pop("segments", False) else None
            out["reference", name] = jax_attn.attention_reference(
                q, k, v, segment_ids=segs, **kw)
            out["chunked", name] = jax_attn.attention_chunked(
                q, k, v, segment_ids=segs, block_kv=8, **kw)  # 2 blocks, ragged
        return out

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)())


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_flash_reference_matches_jax_fwd_kernel(jax_pallas, case):
    q, k, v, seg = _pallas_inputs()
    want_o, want_lse = jax_pallas[case]
    got_o, got_lse = pt_flash.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=PALLAS_CASES[case]["causal"],
        segment_ids=torch.from_numpy(seg) if PALLAS_CASES[case]["seg"] else None)
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=FLASH_TOL, atol=FLASH_TOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=FLASH_TOL, atol=FLASH_TOL)


@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_flash_reference_ragged_matches_jax_attention(jax_out, case):
    """Lengths that are no tile multiple (the kernel masks its ragged edge)."""
    b, s, h, _, causal = RAGGED_CASES[case]
    q, k, v = (torch.from_numpy(x) for x in _ragged_inputs(case))
    got, lse = pt_flash.flash_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), jax_out["ragged", case], rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    assert torch.isfinite(lse).all()


def test_flash_cpu_wrapper_takes_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 1, 16, 16, 4, 2, 64))
    pt_flash.reset_launch_count()
    o, lse = pt_flash.flash_attention(q, k, v, causal=True)
    ro, rlse = pt_flash.flash_attention_reference(q, k, v, causal=True)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert pt_flash.launch_count() == 0


def test_flash_reference_empty_rows_give_zero():
    """Rows with no valid key give O = 0 and LSE_EMPTY. Query row i sits at
    absolute position i and takes the segment of kv slot Skv - Sq + i, so with
    Sq=2 over Skv=4 and segments [1, 1, 0, 0] both rows see only segment-1 keys."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 1, 2, 4, 2, 1, 64))
    seg = torch.tensor([[1, 1, 0, 0]], dtype=torch.int32)
    o, lse = pt_flash.flash_attention_reference(q, k, v, causal=True, segment_ids=seg)
    assert not o.abs().any()
    assert (lse == pt_flash.LSE_EMPTY).all()
    o, lse = pt_flash.flash_attention_reference(q, k, v, causal=True)
    assert o.abs().amax() > 0 and (lse > pt_flash.LSE_EMPTY).all()


@pytest.mark.parametrize("fn", ["reference", "chunked"])
@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_attention_paths_match_jax(jax_out, fn, case):
    q, k, v, seg = (torch.from_numpy(x) for x in _mask_inputs())
    kw = dict(MASK_CASES[case])
    segs = seg if kw.pop("segments", False) else None
    if fn == "chunked":
        got = pt_attn.attention_chunked(q, k, v, segment_ids=segs, block_kv=8, **kw)
    else:
        got = pt_attn.attention_reference(q, k, v, segment_ids=segs, **kw)
    np.testing.assert_allclose(got.numpy(), jax_out[fn, case], rtol=ATTN_TOL, atol=ATTN_TOL)
    if case == "all-masked":
        assert not got.abs().any()  # fully masked rows give 0


def test_gqa_maps_q_head_to_kv_head_by_floor_division():
    """q head i reads kv head i // n_rep: zero one kv head's values and only
    its n_rep q heads go to zero."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 1, 8, 8, 8, 2, 16))
    v[:, :, 1] = 0.0
    for out in (pt_attn.attention_reference(q, k, v, causal=False),
                pt_flash.flash_attention_reference(q, k, v, causal=False)[0]):
        assert out[:, :, 4:].abs().max() == 0
        assert (out[:, :, :4].abs().amax(dim=(0, 1, 3)) > 0).all()


@pytest.mark.parametrize("on_cuda,sq,skv,causal,q_offset,kv_valid_len,want", [
    (True, 128, 128, True, 0, 128, "flash"),  # prefill over a fresh cache
    (True, 128, 128, True, None, None, "flash"),  # training shape
    (True, 64, 128, False, None, None, "flash"),  # full attention, no offsets
    (True, 1, 1024, True, 100, 101, "reference"),  # decode-shaped
    (True, 128, 1024, True, 0, 128, "reference"),  # offset cache window
    (True, 128, 128, True, 0, 100, "reference"),  # partly valid window
    (False, 128, 128, True, 0, 128, "reference"),  # the CPU never takes flash
    (False, 2048, 2048, True, None, None, "chunked"),
])
def test_auto_dispatch_rule(on_cuda, sq, skv, causal, q_offset, kv_valid_len, want):
    assert pt_attn.choose_impl(on_cuda, sq, skv, causal=causal, q_offset=q_offset,
                               kv_valid_len=kv_valid_len) == want


def test_auto_dispatch_on_cpu_is_the_reference():
    q, k, v = (torch.from_numpy(x) for x in _qkv(7, 1, 12, 12, 4, 2, 64))
    pt_flash.reset_launch_count()
    got = pt_attn.attention(q, k, v, causal=True, q_offset=0, kv_valid_len=12)
    assert torch.equal(got, pt_attn.attention_reference(q, k, v, causal=True, q_offset=0,
                                                        kv_valid_len=12))
    assert pt_flash.launch_count() == 0
    with pytest.raises(ValueError, match="unknown attention impl"):
        pt_attn.attention(q, k, v, impl="pallas")


def _inputs(kind="ok"):
    """Flash inputs, valid or broken in one way."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 8, 8, 4, 2, 64))
    if kind == "head_dim":
        q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 8, 8, 4, 2, 32))
    elif kind == "dtypes":
        q, k, v = q.double(), k.double(), v.double()
    elif kind == "contiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif kind == "n_kv_heads":
        q = torch.cat([q, q[:, :, :1]], dim=2)  # 5 heads over 2 kv heads
    return q, k, v


@pytest.mark.parametrize("kind", ["head_dim", "dtypes", "contiguous", "n_kv_heads"])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(kind):
    with pytest.raises(ValueError, match=kind):
        pt_flash._check(*_inputs(kind), None)


def test_flash_wrapper_refuses_other_devices():
    q, k, v = (x.to("meta") for x in _inputs())
    with pytest.raises(ValueError, match="unsupported device"):
        pt_flash.flash_attention(q, k, v)
