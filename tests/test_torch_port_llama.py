"""Port parity: model configs, the weight bridge and the Llama forward
(ray_tpu_torch.models) against the JAX package, in f32 on test-tiny.

The weights are a numpy tree in the JAX package's layout, drawn from a numpy
seed with the scale rules of ray_tpu/models/llama.py:65-110, and bridged into
the port. The JAX results are computed once for the module, in one jitted call.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import config as jax_config
from ray_tpu.models import llama as jax_llama
from ray_tpu_torch.models import bridge
from ray_tpu_torch.models import config as pt_config
from ray_tpu_torch.models import llama as pt_llama

from _torch_port_util import init_scale, numpy_params, one_torch_thread  # noqa: F401

LOGITS_TOL = 1e-4  # f32 on both sides; matmul summation orders differ
CFG = jax_config.get_config("test-tiny")
PT_CFG = pt_config.get_config("test-tiny")


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (b, s)).astype(np.int32)


SEGMENTS = np.repeat(np.asarray([[0] * 5 + [1] * 7]), 2, axis=0).astype(np.int32)


@pytest.fixture(scope="module")
def jax_params():
    return numpy_params(CFG)


@pytest.fixture(scope="module")
def jax_out(jax_params):
    """Every JAX result of this module, from one jitted call."""
    x = np.random.default_rng(5).standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = np.asarray([[0, 2, 4, 6, 8, 10], [3, 4, 5, 9, 20, 31]], np.int32)

    def run(p):
        out = {"rms_norm": jax_llama.rms_norm(jnp.asarray(x[:, :, 0]), p["final_norm"][:16],
                                              CFG.norm_eps),
               "rope": jax_llama.rope(jnp.asarray(x), jnp.asarray(pos), CFG.rope_theta)}
        out["forward"], _ = jax_llama.forward(p, jnp.asarray(_tokens(0, 2, 12)), CFG)
        out["segments"], _ = jax_llama.forward(p, jnp.asarray(_tokens(0, 2, 12)), CFG,
                                               segment_ids=jnp.asarray(SEGMENTS))
        cache = jax_llama.init_kv_cache(CFG, batch=2, max_len=16)
        tokens = jnp.asarray(_tokens(1, 2, 8))
        for lo, hi in ((0, 5), (5, 8)):
            out[f"cached{hi}"], cache = jax_llama.forward(p, tokens[:, lo:hi], CFG, cache=cache)
            out[f"k{hi}"], out[f"v{hi}"] = cache.k, cache.v
        return out

    out = jax.tree_util.tree_map(np.asarray, jax.jit(run)(jax_params))
    out["inputs"] = (x, pos)
    return out


@pytest.mark.parametrize("name", sorted(jax_config._REGISTRY))
def test_registry_entry_matches_jax_package(name):
    jcfg, pcfg = jax_config.get_config(name), pt_config.get_config(name)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert pcfg.head_dim == jcfg.head_dim and pcfg.n_params == jcfg.n_params
    assert pcfg.activation_dtype == {"float32": torch.float32,
                                     "bfloat16": torch.bfloat16}[jcfg.dtype]


def test_registry_has_every_jax_config():
    assert set(pt_config._REGISTRY) == set(jax_config._REGISTRY)
    with pytest.raises(ValueError, match="unknown dtype"):
        pt_config.torch_dtype("int4")


def test_bridge_round_trips_bit_exactly(jax_params):
    params = bridge.params_from_jax(jax_params, PT_CFG, device="cpu")
    assert params["layers"]["wq"].shape == (2, 64, 4, 16)  # [L, d, H, hd], no transpose
    assert params["layers"]["wo"].shape == (2, 4, 16, 64)  # [L, H, hd, d]
    back = bridge.params_to_numpy(params)
    flat_in = jax.tree_util.tree_leaves_with_path(jax_params)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        assert flat_out[path].dtype == leaf.dtype
        np.testing.assert_array_equal(flat_out[path], leaf)


def test_bridge_stores_in_the_asked_dtype(jax_params):
    params = bridge.params_from_jax(jax_params, PT_CFG, device="cpu", dtype=torch.bfloat16)
    wq = params["layers"]["wq"]
    assert wq.dtype == torch.bfloat16
    assert torch.equal(wq, torch.from_numpy(jax_params["layers"]["wq"]).bfloat16())


def test_bridge_stacks_per_layer_lists():
    """A JAX tree built with scan_layers=False (a list of layer dicts) lands on
    the port's stacked [L, ...] layout, leaf for leaf."""
    tree = numpy_params(dataclasses.replace(CFG, scan_layers=False), seed=1)
    assert isinstance(tree["layers"], list) and len(tree["layers"]) == CFG.n_layers
    params = bridge.params_from_jax(tree, PT_CFG, device="cpu")
    for name, w in params["layers"].items():
        np.testing.assert_array_equal(
            w.numpy(), np.stack([lyr[name] for lyr in tree["layers"]]))


@pytest.mark.parametrize("fault,match", [("swapped", "layers/wo"),
                                         ("missing", "layer keys"),
                                         ("extra", "top-level keys")])
def test_bridge_checks_every_leaf(jax_params, fault, match):
    bad = dict(jax_params, layers=dict(jax_params["layers"]))
    if fault == "swapped":
        bad["layers"]["wo"] = np.swapaxes(bad["layers"]["wo"], 1, 3)
    elif fault == "missing":
        del bad["layers"]["w_up"]
    else:
        bad["router"] = np.zeros((64, 4), np.float32)
    with pytest.raises(ValueError, match=match):
        bridge.params_from_jax(bad, PT_CFG, device="cpu")


def test_init_keeps_shapes_and_scale_rules():
    want = jax.eval_shape(lambda: jax_llama.init(jax.random.PRNGKey(0), CFG))
    ours = bridge.params_to_numpy(pt_llama.init(PT_CFG, seed=0, device="cpu"))
    got = dict(jax.tree_util.tree_leaves_with_path(ours))
    assert len(got) == len(jax.tree_util.tree_leaves(want))
    for path, sd in jax.tree_util.tree_leaves_with_path(want):
        leaf, scale = got[path], init_scale(path[-1].key, CFG)
        assert leaf.shape == sd.shape and leaf.dtype == np.float32, path
        if scale == 0.0:  # norm scales
            assert np.all(leaf == 1.0), path
        else:  # same rule, other random numbers: per-tensor std within 10%
            assert abs(leaf.std() / scale - 1.0) < 0.1, (path, leaf.std(), scale)


def test_init_is_seeded_and_stores_in_dtype():
    a = pt_llama.init(PT_CFG, seed=3, device="cpu")
    b = pt_llama.init(PT_CFG, seed=3, device="cpu", dtype=torch.bfloat16)
    c = pt_llama.init(PT_CFG, seed=4, device="cpu")
    assert torch.equal(a["embed"].bfloat16(), b["embed"]) and b["embed"].dtype == torch.bfloat16
    assert not torch.equal(a["embed"], c["embed"])


def test_rms_norm_matches_jax(jax_out, jax_params):
    x, _ = jax_out["inputs"]
    got = pt_llama.rms_norm(torch.from_numpy(x[:, :, 0]),
                            torch.from_numpy(jax_params["final_norm"][:16]), CFG.norm_eps)
    np.testing.assert_allclose(got.numpy(), jax_out["rms_norm"], rtol=1e-6, atol=1e-6)


def test_rope_matches_jax_at_uneven_positions(jax_out):
    """Non-uniform positions: a constant offset would not show in attention."""
    x, pos = jax_out["inputs"]
    got = pt_llama.rope(torch.from_numpy(x), torch.from_numpy(pos), CFG.rope_theta)
    np.testing.assert_allclose(got.numpy(), jax_out["rope"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["forward", "segments"])
def test_forward_without_cache_matches_jax(jax_out, jax_params, case):
    params = bridge.params_from_jax(jax_params, PT_CFG, device="cpu")
    seg = torch.from_numpy(SEGMENTS) if case == "segments" else None
    got, cache = pt_llama.forward(params, torch.from_numpy(_tokens(0, 2, 12)).long(), PT_CFG,
                                  segment_ids=seg)
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_out[case], rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_forward_with_cache_matches_jax(jax_out, jax_params):
    """Prefill 5 tokens into an empty cache, then 3 more at offset 5: logits
    and the cache contents agree with JAX at every step."""
    tokens = torch.from_numpy(_tokens(1, 2, 8)).long()
    params = bridge.params_from_jax(jax_params, PT_CFG, device="cpu")
    cache = pt_llama.init_kv_cache(PT_CFG, batch=2, max_len=16, device="cpu")
    for lo, hi in ((0, 5), (5, 8)):
        got, cache = pt_llama.forward(params, tokens[:, lo:hi], PT_CFG, cache=cache)
        np.testing.assert_allclose(got.numpy(), jax_out[f"cached{hi}"], rtol=LOGITS_TOL,
                                   atol=LOGITS_TOL)
        assert cache.length == hi
        for name in ("k", "v"):
            np.testing.assert_allclose(getattr(cache, name).numpy(), jax_out[f"{name}{hi}"],
                                       rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_embed_lookup_clamps_ids_as_jax_gather_does():
    """Out-of-vocabulary ids read the rows JAX's jitted gather reads: a
    negative id wraps once, then the id is clamped to [0, V - 1]."""
    v = CFG.vocab_size
    table = np.random.default_rng(2).standard_normal((v, 8)).astype(np.float32)
    ids = np.asarray([0, v - 1, v, 10**6, -1, -v, -v - 1, -10**6], np.int32)
    want = np.asarray(jax.jit(lambda t, i: t[i])(table, ids))
    got = pt_llama._embed_lookup(torch.from_numpy(table), torch.from_numpy(ids).long(),
                                 torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("what,item", [("moe", "A3"), ("ring", "A6"), ("pipeline", "A6"),
                                       ("remat-dots", "A1b")])
def test_branches_outside_the_slice_raise(what, item):
    tokens = torch.zeros((1, 4), dtype=torch.long)
    if what == "moe":  # A3b is ported: the MoE branch runs, its aux loss engaged
        cfg = pt_config.get_config("moe-tiny")
        loss, metrics = pt_llama.loss_fn(pt_llama.init(cfg, device="cpu"),
                                         {"tokens": tokens}, cfg)
        assert torch.isfinite(loss) and metrics["moe_aux_loss"].item() > 0.0
        assert loss.item() == pytest.approx(
            (metrics["ce_loss"] + metrics["moe_aux_loss"]).item(), abs=1e-6)
        return
    params = pt_llama.init(PT_CFG, device="cpu")
    if what == "remat-dots":  # A1b is ported: the branch runs and gives full's loss
        losses = [pt_llama.loss_fn(params, {"tokens": tokens},
                                   dataclasses.replace(PT_CFG, remat_policy=p))[0].item()
                  for p in ("dots", "full")]
        assert losses[0] == losses[1]
        return
    cfg = (dataclasses.replace(PT_CFG, attention_impl="ring") if what == "ring"
           else dataclasses.replace(PT_CFG, pipeline_stages=2))
    with pytest.raises(NotImplementedError, match=item):
        pt_llama.forward(params, tokens, cfg)
