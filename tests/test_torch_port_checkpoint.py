"""Port parity: HF safetensors checkpoints (ray_tpu_torch/models/checkpoint.py
and models/safetensors.py) against the JAX package's checkpoint module and
the safetensors and transformers packages, on test-tiny and moe-tiny.

The port reads and writes the format itself; only these tests use the
safetensors and transformers packages, skipped where they are missing. The
JAX trees are numpy (tests/_torch_port_util.py) and bridged into the port;
each JAX jit runs once for the module.
"""
import dataclasses
import json
import os
import struct
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import config as jax_llm_config
from ray_tpu.models import checkpoint as jax_ckpt
from ray_tpu.models import config as jax_config
from ray_tpu.ops import quant as jax_quant
from ray_tpu.train import step as jax_step
from ray_tpu_torch.llm import LLMConfig, SamplingParams, TorchLLMEngine
from ray_tpu_torch.models import bridge
from ray_tpu_torch.models import checkpoint as pt_ckpt
from ray_tpu_torch.models import config as pt_config
from ray_tpu_torch.models import llama as pt_llama
from ray_tpu_torch.models import safetensors as pt_st
from ray_tpu_torch.ops import quant as pt_quant
from ray_tpu_torch.train import step as pt_step

import chip_smoke
from _torch_port_util import numpy_params, one_torch_thread  # noqa: F401

LOSS_TOL = 1e-5  # f32 on both sides; matmul summation orders differ
HF_LOGIT_TOL = 1e-4  # f32 logits against transformers'
# name -> (registry name, overrides); the same architecture in both packages
CASES = {"dense-untied": ("test-tiny", {}),
         "dense-tied": ("test-tiny", {"tie_embeddings": True}),
         "moe": ("moe-tiny", {})}
FORMAT_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
                 "I8": torch.int8}


def _configs(case):
    name, kw = CASES[case]
    return jax_config.get_config(name, **kw), pt_config.get_config(name, **kw)


@pytest.fixture(scope="module")
def trees():
    """case -> (JAX config, port config, numpy tree in the JAX layout)."""
    out = {}
    for i, case in enumerate(CASES):
        jcfg, pcfg = _configs(case)
        out[case] = (jcfg, pcfg, numpy_params(jcfg, seed=30 + i))
    return out


def _assert_params_equal(got, want):
    """Two port parameter dicts, leaf by leaf, bit for bit (QTensors too)."""
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    pairs = [(k, got[k], want[k]) for k in got if k != "layers"]
    pairs += [(f"layers/{k}", got["layers"][k], want["layers"][k]) for k in got["layers"]]
    for name, a, b in pairs:
        if isinstance(b, pt_quant.QTensor):
            assert isinstance(a, pt_quant.QTensor), name
            assert torch.equal(a.q, b.q) and torch.equal(a.s, b.s), name
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), name


def _assert_trees_equal(got, want):
    """A JAX tree against a numpy tree of the same structure, bit for bit."""
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)), got, want)


def _format_tensors(dtype):
    """Seeded tensors of every rank the writer meets, one a transposed view."""
    gen = torch.Generator().manual_seed(4)
    if dtype == torch.int8:
        def make(*shape):
            return torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8)
    else:
        def make(*shape):
            return torch.randn(shape, generator=gen).to(dtype)
    return {"matrix": make(3, 5), "transposed": make(4, 6).T, "vector": make(7),
            "scalar": make()}


# ---------------------------------------------------------------------- format

@pytest.mark.parametrize("code", list(FORMAT_DTYPES))
def test_port_file_opens_under_safetensors(tmp_path, code):
    safetensors = pytest.importorskip("safetensors")
    tensors = _format_tensors(FORMAT_DTYPES[code])
    path = str(tmp_path / "port.safetensors")
    pt_st.save_file(tensors, path, metadata={"format": "pt", "note": code})
    with safetensors.safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt", "note": code}
        assert sorted(f.keys()) == sorted(tensors)
        for name, t in tensors.items():
            got = f.get_tensor(name)
            assert got.dtype == t.dtype and torch.equal(got, t), name


@pytest.mark.parametrize("code", list(FORMAT_DTYPES))
def test_safetensors_file_opens_under_the_port_reader(tmp_path, code):
    st_torch = pytest.importorskip("safetensors.torch")
    tensors = {k: v.contiguous() for k, v in _format_tensors(FORMAT_DTYPES[code]).items()}
    path = str(tmp_path / "lib.safetensors")
    st_torch.save_file(tensors, path, metadata={"format": "pt"})
    f = pt_st.SafeFile(path)
    assert f.metadata == {"format": "pt"} and sorted(f.keys()) == sorted(tensors)
    for name, t in tensors.items():
        got = f.get(name)
        assert got.dtype == t.dtype and torch.equal(got, t), name


def test_unknown_dtype_raises_naming_it(tmp_path):
    st_torch = pytest.importorskip("safetensors.torch")
    with pytest.raises(ValueError, match="float64"):
        pt_st.save_file({"x": torch.zeros(2, dtype=torch.float64)}, str(tmp_path / "a"))
    path = str(tmp_path / "f64.safetensors")
    st_torch.save_file({"x": torch.zeros(2, dtype=torch.float64),
                        "y": torch.ones(2)}, path)
    f = pt_st.SafeFile(path)
    assert torch.equal(f.get("y"), torch.ones(2))  # the file opens; F64 is refused on read
    with pytest.raises(ValueError, match="'F64'"):
        f.get("x")


def test_header_is_padded_and_offsets_run_contiguously(tmp_path):
    """What the safetensors package accepts: a header padded to 8 bytes,
    offsets contiguous from 0 to the end of the file; larger elements first,
    so every tensor is aligned to its element size."""
    tensors = {"b": torch.ones(3, dtype=torch.bfloat16), "i": torch.ones(5, dtype=torch.int8),
               "f": torch.ones(3, 3), "h": torch.ones(1, dtype=torch.float16)}
    path = str(tmp_path / "mixed.safetensors")
    pt_st.save_file(tensors, path)
    with open(path, "rb") as f:
        raw = f.read()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    assert n % 8 == 0 and raw[8 + n - 1:8 + n] in (b" ", b"}")
    spans = sorted((v["data_offsets"], k) for k, v in header.items())
    end = 0
    for (begin, stop), name in spans:
        assert begin == end and begin % tensors[name].element_size() == 0, name
        end = stop
    assert 8 + n + end == len(raw)
    assert [name for _, name in spans] == ["f", "b", "h", "i"]


# -------------------------------------------------- the port's files and JAX's

@pytest.mark.parametrize("case", list(CASES))
def test_port_checkpoint_loads_under_jax_bit_equal(tmp_path, trees, case):
    jcfg, pcfg, tree = trees[case]
    pt_ckpt.save_llama_params(bridge.params_from_jax(tree, pcfg, device="cpu"), pcfg,
                              str(tmp_path))
    loaded = jax_ckpt.load_llama_params(str(tmp_path), param_dtype=jnp.float32)
    _assert_trees_equal(loaded, tree)
    with open(tmp_path / "config.json") as f:
        assert json.load(f) == jax_ckpt.config_to_hf(jcfg)


@pytest.mark.parametrize("case", list(CASES))
def test_jax_checkpoint_loads_under_the_port_bit_equal(tmp_path, trees, case):
    jcfg, pcfg, tree = trees[case]
    jax_ckpt.save_llama_params(tree, jcfg, str(tmp_path))
    got = pt_ckpt.load_llama_params(str(tmp_path), device="cpu", dtype=torch.float32)
    _assert_params_equal(got, bridge.params_from_jax(tree, pcfg, device="cpu"))


@pytest.mark.parametrize("layout", ["index", "bare"])
def test_sharded_checkpoint_loads(tmp_path, trees, layout):
    """One file split in two, with model.safetensors.index.json or without
    (every .safetensors file of the directory), as
    tests/test_checkpoint_io.py::test_sharded_index_file splits it."""
    jcfg, pcfg, tree = trees["dense-untied"]
    one, dst = str(tmp_path / "one"), str(tmp_path / "split")
    pt_ckpt.save_llama_params(bridge.params_from_jax(tree, pcfg, device="cpu"), pcfg, one)
    os.makedirs(dst)
    src = pt_st.SafeFile(os.path.join(one, "model.safetensors"))
    keys = sorted(src.keys())
    weight_map = {}
    for n, part in enumerate((keys[:len(keys) // 2], keys[len(keys) // 2:]), start=1):
        fname = f"model-{n:05d}-of-00002.safetensors"
        pt_st.save_file({k: src.get(k) for k in part}, os.path.join(dst, fname))
        weight_map.update({k: fname for k in part})
    if layout == "index":
        with open(os.path.join(dst, "model.safetensors.index.json"), "w") as f:
            json.dump({"weight_map": weight_map}, f)
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(pt_ckpt.config_to_hf(pcfg), f)
    got = pt_ckpt.load_llama_params(dst, device="cpu", dtype=torch.float32)
    _assert_params_equal(got, bridge.params_from_jax(tree, pcfg, device="cpu"))
    _assert_trees_equal(jax_ckpt.load_llama_params(dst, param_dtype=jnp.float32), tree)


@pytest.mark.parametrize("case", ["dense-untied", "moe"])
def test_bf16_release_layout_loads_bit_equal(tmp_path, trees, case):
    """chip_smoke.py's release layout (bf16 shards and an index, as HF's
    Llama-3 release lays them out) loads back bit for bit in bf16, and into
    int8 as load-then-quantize gives it."""
    _, pcfg, tree = trees[case]
    params = bridge.params_from_jax(tree, pcfg, device="cpu", dtype=torch.bfloat16)
    nbytes = chip_smoke.release_layout(torch, params, pcfg, str(tmp_path), shards=3)
    assert nbytes == sum(t.nelement() * 2 for t in pt_llama.tree_leaves(params))
    with open(tmp_path / "model.safetensors.index.json") as f:
        files = set(json.load(f)["weight_map"].values())
    assert files == {f"model-{n:05d}-of-00003.safetensors" for n in (1, 2, 3)}
    got = pt_ckpt.load_llama_params(str(tmp_path), device="cpu", dtype=torch.bfloat16)
    _assert_params_equal(got, params)
    q = pt_ckpt.load_llama_params(str(tmp_path), device="cpu", dtype=torch.bfloat16,
                                  quantize_int8=True)
    _assert_params_equal(q, pt_quant.quantize_llama_params(params))


def test_the_loader_reads_each_tensor_once_in_pieces(tmp_path, trees, monkeypatch):
    """Every tensor of the file is read once, as it lies: an expert stack
    one expert at a time, never a stacked leaf."""
    _, pcfg, tree = trees["moe"]
    pt_ckpt.save_llama_params(bridge.params_from_jax(tree, pcfg, device="cpu"), pcfg,
                              str(tmp_path))
    seen = []
    get = pt_st.SafeFile.get

    def spy(self, name):
        t = get(self, name)
        seen.append((name, tuple(t.shape)))
        return t

    monkeypatch.setattr(pt_st.SafeFile, "get", spy)
    pt_ckpt.load_llama_params(str(tmp_path), device="cpu", dtype=torch.float32)
    names = [n for n, _ in seen]
    assert sorted(names) == sorted(pt_st.SafeFile(str(tmp_path / "model.safetensors")).keys())
    assert len(set(names)) == len(names)
    f, d = pcfg.d_ff, pcfg.d_model
    assert dict(seen)["model.layers.1.block_sparse_moe.experts.3.w2.weight"] == (d, f)


def test_a_switch_gated_moe_export_warns(tmp_path, trees):
    _, pcfg, tree = trees["moe"]
    cfg = dataclasses.replace(pcfg, moe_top_k=1, moe_top1_renorm=False)
    params = bridge.params_from_jax(tree, pcfg, device="cpu")
    with pytest.warns(UserWarning, match="Switch-gated"):
        pt_ckpt.save_llama_params(params, cfg, str(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pt_ckpt.save_llama_params(params, pcfg, str(tmp_path / "top2"))


# ---------------------------------------------------------------------- config

_LLAMA3 = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
           "_name_or_path": "meta-llama/Meta-Llama-3-8B", "vocab_size": 128256,
           "hidden_size": 4096, "num_hidden_layers": 32, "num_attention_heads": 32,
           "num_key_value_heads": 8, "intermediate_size": 14336,
           "max_position_embeddings": 8192, "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
           "tie_word_embeddings": False, "torch_dtype": "bfloat16"}
_LLAMA2 = {"model_type": "llama", "vocab_size": 32000, "hidden_size": 4096,
           "num_hidden_layers": 32, "num_attention_heads": 32, "intermediate_size": 11008}
_MIXTRAL = {"architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
            "vocab_size": 32000, "hidden_size": 4096, "num_hidden_layers": 32,
            "num_attention_heads": 32, "num_key_value_heads": 8, "intermediate_size": 14336,
            "max_position_embeddings": 32768, "rope_theta": 1e6, "rms_norm_eps": 1e-5,
            "num_local_experts": 8, "num_experts_per_tok": 2}
HF_CONFIGS = {
    "llama3": (_LLAMA3, {}),
    "llama2-without-rope-theta": (_LLAMA2, {}),
    "mixtral-without-extension-keys": (_MIXTRAL, {}),
    "overrides": (_LLAMA3, {"dtype": "float32", "remat": False, "n_layers": 2}),
}


def _write_config(path, hf):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    return str(path)


@pytest.mark.parametrize("case", list(HF_CONFIGS))
def test_config_from_hf_matches_jax(tmp_path, case):
    hf, overrides = HF_CONFIGS[case]
    src = _write_config(tmp_path / "ckpt", hf)
    got = dataclasses.asdict(pt_ckpt.config_from_hf(src, **overrides))
    assert got == dataclasses.asdict(jax_ckpt.config_from_hf(src, **overrides))
    if case == "llama2-without-rope-theta":
        assert (got["rope_theta"], got["norm_eps"], got["max_seq_len"]) == (10000.0, 1e-6, 2048)
    if case.startswith("mixtral"):
        assert got["moe_capacity_factor"] == 4.0 and got["moe_top1_renorm"] is True


def test_a_non_mixtral_moe_checkpoint_raises_as_jax_does(tmp_path):
    src = _write_config(tmp_path, dict(_MIXTRAL, model_type="phimoe"))
    with pytest.raises(ValueError) as jax_err:
        jax_ckpt.config_from_hf(src)
    with pytest.raises(ValueError) as pt_err:
        pt_ckpt.config_from_hf(src)
    assert str(pt_err.value) == str(jax_err.value)


@pytest.mark.parametrize("name", ["test-tiny", "moe-tiny", "llama3-8b", "mixtral-8x7b"])
def test_config_to_hf_matches_jax(name):
    assert pt_ckpt.config_to_hf(pt_config.get_config(name)) == \
        jax_ckpt.config_to_hf(jax_config.get_config(name))


@pytest.mark.parametrize("kind", ["checkpoint", "file", "missing", "not-a-str"])
def test_looks_like_checkpoint_dir_as_jax(tmp_path, kind):
    path = {"checkpoint": _write_config(tmp_path / "c", _LLAMA2),
            "file": str(tmp_path / "c" / "config.json"),
            "missing": str(tmp_path / "nowhere"), "not-a-str": tmp_path}[kind]
    assert pt_ckpt.looks_like_checkpoint_dir(path) == jax_ckpt.looks_like_checkpoint_dir(path)
    assert pt_ckpt.looks_like_checkpoint_dir(path) == (kind == "checkpoint")


# ---------------------------------------------------------------- transformers

def _hf_model(tr, case):
    """A tiny transformers model, as tests/test_checkpoint_io.py:69,212 build them."""
    common = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, intermediate_size=48, max_position_embeddings=128,
                  rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
                  attn_implementation="eager")
    torch.manual_seed(0)
    if case.startswith("mixtral"):
        top_k = int(case[-1])
        return tr.MixtralForCausalLM(tr.MixtralConfig(
            num_local_experts=4, num_experts_per_tok=top_k, sliding_window=None,
            **common)).eval()
    return tr.LlamaForCausalLM(tr.LlamaConfig(**common)).eval()


@pytest.mark.parametrize("case", ["llama-f32", "llama-bf16", "mixtral-top1", "mixtral-top2"])
def test_transformers_checkpoint_gives_transformers_logits(tmp_path, monkeypatch, case):
    """save_pretrained directories of the real transformers models load into
    the port and reproduce their logits in f32: the cross-check of the q/k
    layout and the expert mapping. The bf16 case stores BF16 tensors, which
    the JAX loader cannot read; its reference is the same model in f32 on
    the bf16-rounded weights."""
    monkeypatch.setenv("USE_TF", "0")  # a first import here skips TensorFlow's
    tr = pytest.importorskip("transformers")
    model = _hf_model(tr, case)
    if case.endswith("bf16"):
        model = model.to(torch.bfloat16)
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    model = model.float()
    cfg = pt_ckpt.config_from_hf(str(tmp_path), remat=False, dtype="float32")
    if case.startswith("mixtral"):
        assert cfg.moe_top1_renorm and cfg.moe_capacity_factor == 4.0 / cfg.moe_top_k
    params = pt_ckpt.load_llama_params(str(tmp_path), cfg, device="cpu", dtype=torch.float32)
    ids = torch.tensor([[1, 7, 23, 40, 5, 61]])
    with torch.no_grad():
        ref = model(ids).logits
        got, _ = pt_llama.forward(params, ids, cfg)
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= HF_LOGIT_TOL


# --------------------------------------------------------- serving and training

@pytest.mark.parametrize("tokenizer,ships", [("byte", False), ("byte", True),
                                             ("hf:elsewhere", True)])
def test_a_checkpoint_dir_resolves_as_jax_resolves_it(tmp_path, trees, tokenizer, ships):
    jcfg, pcfg, tree = trees["dense-untied"]
    src = str(tmp_path)
    pt_ckpt.save_llama_params(bridge.params_from_jax(tree, pcfg, device="cpu"), pcfg, src)
    if ships:
        with open(os.path.join(src, "tokenizer_config.json"), "w") as f:
            json.dump({}, f)
    kw = dict(model_source=src, tokenizer=tokenizer, engine_kwargs={"dtype": "float32"})
    ours, theirs = LLMConfig(**kw), jax_llm_config.LLMConfig(**kw)
    assert ours.resolve_tokenizer_name() == theirs.resolve_tokenizer_name()
    assert ours.resolve_tokenizer_name() == (f"hf:{src}" if ships and tokenizer == "byte"
                                             else tokenizer)
    got = ours.resolve_model_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(theirs.resolve_model_config())
    assert got.dtype == "float32" and got.name == os.path.basename(src)


def _greedy_ids(eng, prompts, n=6):
    try:
        return [eng.generate_sync(p, SamplingParams(max_tokens=n, temperature=0.0,
                                                    stop_token_ids=[-1])).token_ids
                for p in prompts]
    finally:
        eng.shutdown()


def test_an_engine_serves_a_checkpoint_dir_as_its_weights(tmp_path, trees):
    """The same greedy ids from a checkpoint directory as from an engine
    given the parameters, and the same weights. config.json carries no
    activation dtype (HF's torch_dtype is the weights'), so engine_kwargs
    sets test-tiny's f32."""
    _, pcfg, tree = trees["dense-untied"]
    params = bridge.params_from_jax(tree, pcfg, device="cpu")
    pt_ckpt.save_llama_params(params, pcfg, str(tmp_path))
    common = dict(dtype="float32", max_num_seqs=2, max_model_len=64)
    from_dir = TorchLLMEngine(LLMConfig(model_source=str(tmp_path), **common,
                                        engine_kwargs={"dtype": "float32"}), device="cpu")
    given = TorchLLMEngine(LLMConfig(model_source=pcfg, **common), params=params,
                           device="cpu")
    prompts = [[1, 9, 33, 200], [1, 5, 6, 7, 8, 9, 10]]
    got = _greedy_ids(from_dir, prompts)
    assert got == _greedy_ids(given, prompts) and all(len(ids) == 6 for ids in got)
    _assert_params_equal(from_dir.params, given.params)


@pytest.mark.parametrize("case", ["dense-untied", "moe"])
def test_an_int8_start_from_a_checkpoint_is_load_then_quantize(tmp_path, trees, case):
    """The engine quantizes each piece as it reads it: bit for bit the port's
    quantize_llama_params of the bf16 load, and the JAX engine's start (its
    load, then its jitted quantize_llama_params) through the bridge."""
    _, pcfg, tree = trees[case]
    src = str(tmp_path)
    pt_ckpt.save_llama_params(bridge.params_from_jax(tree, pcfg, device="cpu"), pcfg, src)
    eng = TorchLLMEngine(LLMConfig(model_source=src, quantization="int8"), device="cpu")
    eng.start()
    want = pt_quant.quantize_llama_params(
        pt_ckpt.load_llama_params(src, device="cpu", dtype=torch.bfloat16))
    _assert_params_equal(eng.params, want)
    jax_q = jax.jit(jax_quant.quantize_llama_params)(
        jax_ckpt.load_llama_params(src, param_dtype=jnp.bfloat16))
    _assert_params_equal(eng.params, bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_q), eng.model_config, device="cpu",
        dtype=torch.bfloat16))


def test_an_unknown_quantization_raises_before_any_weight_is_read(tmp_path, trees):
    """A config changed after its checks still raises at start, before the
    checkpoint (here a file that is no safetensors) is read."""
    _, pcfg, _ = trees["dense-untied"]
    src = _write_config(tmp_path, pt_ckpt.config_to_hf(pcfg))
    with open(os.path.join(src, "model.safetensors"), "wb") as f:
        f.write(b"not a checkpoint")
    cfg = LLMConfig(model_source=src)
    cfg.quantization = "int4"
    with pytest.raises(ValueError, match="unknown quantization 'int4'"):
        TorchLLMEngine(cfg, device="cpu").start()


@pytest.fixture(scope="module")
def jax_warm_start(tmp_path_factory, trees):
    """The JAX package's init_state(checkpoint_dir=...) parameters and its
    first step's loss, on a checkpoint the port wrote."""
    jcfg, pcfg, tree = trees["dense-untied"]
    src = str(tmp_path_factory.mktemp("warm"))
    pt_ckpt.save_llama_params(bridge.params_from_jax(tree, pcfg, device="cpu"), pcfg, src)
    tx = jax_step.make_optimizer(warmup_steps=2, total_steps=10)
    state = jax_step.init_state(jax.random.PRNGKey(0), jcfg, tx, checkpoint_dir=src)
    step = jax_step.make_train_step(jcfg, tx, donate=False)
    _, metrics = step(state, {"tokens": jnp.asarray(_tokens(jcfg))})
    return src, jax.tree_util.tree_map(np.asarray, state.params), float(metrics["loss"])


def _tokens(cfg):
    return np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)


def test_init_state_warm_starts_as_jax_does(jax_warm_start, trees):
    src, jax_params, jax_loss = jax_warm_start
    _, pcfg, _ = trees["dense-untied"]
    tx = pt_step.make_optimizer(warmup_steps=2, total_steps=10)
    state = pt_step.init_state(pcfg, tx, device="cpu", checkpoint_dir=src)
    leaves = pt_llama.tree_leaves(state.params)
    assert all(p.requires_grad and p.dtype == torch.float32 for p in leaves)
    _assert_trees_equal(jax_params, bridge.params_to_numpy(state.params))
    step = pt_step.make_train_step(pcfg, tx, device="cpu")
    _, metrics = step(state, {"tokens": torch.from_numpy(_tokens(pcfg)).long()})
    assert abs(metrics["loss"].item() - jax_loss) <= LOSS_TOL * abs(jax_loss)
