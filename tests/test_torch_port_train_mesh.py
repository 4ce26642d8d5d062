"""Port parity: training on a device mesh (ray_tpu_torch/train/step.py with
mesh=, the differentiable collectives of parallel/sharding.py, the fsdp
gathers and the vocab-parallel loss of models/llama.py, the sharded global
norm of train/optim.py) against the JAX package's GSPMD-sharded step, in
f32 on test-tiny, whose heads, kv heads, mlp, vocab and embed divide by 2.

The JAX side runs on 4 of the 8 host CPU devices that tests/conftest.py
forces: ``init_state(mesh=)`` (its parameters replaced by the sharded numpy
tree both sides start from) and ``make_train_step(donate=False)`` under
``use_mesh``, once per mesh for the module. The port side is one pool of 4
spawned gloo CPU ranks (tests/_torch_tp_ranks.py), each on one torch
thread, laying each mesh over the same ranks. Every rank passes the global
batch; its loss_mask gives the ranks unequal token counts. A rank's shard
is held against JAX's shard on the device at the same mesh coordinates
(the index JAX's own sharding gives), so neither side's slicing checks
itself. Every wait is bounded (the groups' 60 s timeout, the pool's
queue reads and joins).
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_ranks as ranks_mod
from ray_tpu.models import config as jax_config
from ray_tpu.models import llama as jax_llama
from ray_tpu.parallel import mesh as jax_mesh_mod
from ray_tpu.parallel import sharding as jax_sharding
from ray_tpu.train import step as jax_step
from ray_tpu_torch.models import bridge, checkpoint
from ray_tpu_torch.models import config as pt_config
from ray_tpu_torch.models import llama as pt_llama
from ray_tpu_torch.parallel import AXIS_ORDER, MeshSpec
from ray_tpu_torch.train import step as pt_step

from _torch_port_util import numpy_params, one_torch_thread  # noqa: F401

# f32 on both sides, the sums (GSPMD's partial sums, the port's gloo
# reductions) in other orders: the one-rank training test's tolerances
LOSS_TOL = 1e-5
MOMENT_TOL = 1e-5  # mu ~ grads (|g| up to ~1), nu ~ grads^2
OPT = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)  # step 2 at the peak lr
# params after the steps: 1e-5 as in the one-rank test, plus 5 % of lr,
# since Adam divides each gradient element by its own RMS: an element whose
# gradient is near f32's noise floor (the row with one masked token leaves
# many near 0) moves by a fraction of lr that the reduction order sets
# (seen: 2.1 % of lr, in 1 element of 8192). A wrong slice moves a param by
# its own size (~0.1), a wrong gradient by ~lr; the moments are held at 1e-5.
PARAM_TOL = 1e-5
PARAM_ATOL = PARAM_TOL + 0.05 * OPT["learning_rate"]
N_RANKS = 4
MESHES = {"dp2xfsdp2": MeshSpec(dp=2, fsdp=2), "fsdp2xtp2": MeshSpec(fsdp=2, tp=2),
          "dp2xtp2": MeshSpec(dp=2, tp=2)}
CFG = jax_config.get_config("test-tiny", attention_impl="reference")
PT_KW = dict(name="test-tiny", attention_impl="flash")
PT_CFG = pt_config.get_config(**PT_KW)
N_STEPS = 2


def _batch():
    """4 rows of 33 tokens, one segment boundary, and a loss_mask whose
    density differs by row (all, ~70 %, ~30 %, one token), so every split
    of the batch gives the ranks unequal counts."""
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, CFG.vocab_size, (4, 33)).astype(np.int32)
    mask = np.stack([np.ones(33), rng.random(33) < 0.7, rng.random(33) < 0.3,
                     np.eye(33)[5]]).astype(np.int32)
    seg = np.repeat(np.asarray([[0] * 12 + [1] * 21]), 4, axis=0).astype(np.int32)
    return {"tokens": tokens, "loss_mask": mask, "segment_ids": seg}


@pytest.fixture(scope="module")
def np_params():
    return numpy_params(CFG, seed=2)


@pytest.fixture(scope="module")
def ranks():
    r = ranks_mod.Ranks(N_RANKS, MESHES["dp2xfsdp2"])
    yield r
    r.close()


def _jax_mesh(spec):
    return jax_mesh_mod.build_mesh(jax_mesh_mod.MeshSpec(**dataclasses.asdict(spec)),
                                   jax.devices()[:N_RANKS])


class _Lazy(dict):
    """A module-scoped cache: each mesh's results made on first use."""

    def __init__(self, make):
        super().__init__()
        self.make = make

    def __missing__(self, key):
        self[key] = self.make(key)
        return self[key]


@pytest.fixture(scope="module")
def jax_runs(np_params):
    """Per mesh: JAX's init_state(mesh=) with the sharded numpy params,
    then N_STEPS of its jitted step -> (mesh, the sharded inputs, numpy
    params / metrics per step, the optax state after the last)."""

    def run(name):
        mesh = _jax_mesh(MESHES[name])
        tx = jax_step.make_optimizer(**OPT)
        sharded = jax_sharding.shard_pytree(np_params, jax_llama.param_axes(CFG), mesh,
                                            jax_sharding.TRAIN_RULES)
        state = jax_step.init_state(jax.random.PRNGKey(0), CFG, tx, mesh=mesh)
        state = state._replace(params=sharded)
        step = jax_step.make_train_step(CFG, tx, donate=False)
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        params, metrics = [], []
        with jax_mesh_mod.use_mesh(mesh):
            for _ in range(N_STEPS):
                state, m = step(state, batch)
                params.append(jax.tree_util.tree_map(np.asarray, state.params))
                metrics.append({k: float(v) for k, v in m.items()})
        adam = state.opt_state[1][0]
        opt = {"count": int(adam.count), "mu": jax.tree_util.tree_map(np.asarray, adam.mu),
               "nu": jax.tree_util.tree_map(np.asarray, adam.nu)}
        return dict(mesh=mesh, sharded=sharded, params=params, metrics=metrics, opt=opt)

    return _Lazy(run)


@pytest.fixture(scope="module")
def port_runs(ranks, np_params):
    """Per mesh: every rank's train_steps result, by rank."""
    return _Lazy(lambda name: ranks.run(ranks_mod.train_steps, MESHES[name], np_params,
                                        PT_KW, _batch(), OPT, N_STEPS))


@pytest.fixture(scope="module")
def one_rank(np_params):
    """The port's one-rank step (mesh=None) on the whole params and batch."""
    tx = pt_step.make_optimizer(**OPT)
    params = bridge.params_from_jax(np_params, PT_CFG, device="cpu")
    for p in pt_llama.tree_leaves(params):
        p.requires_grad_(True)
    state = pt_step.TrainState(0, params, tx.init(pt_llama.tree_leaves(params)))
    step = pt_step.make_train_step(PT_CFG, tx, device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in _batch().items()}
    metrics, out = [], []
    for _ in range(N_STEPS):
        state, m = step(state, batch)
        metrics.append({k: v.item() for k, v in m.items()})
        out.append(copy.deepcopy(bridge.params_to_numpy(state.params)))  # not views
    return dict(metrics=metrics, params=out)


def _flat(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _jax_shard(jax_leaf_in, whole, mesh, coord):
    """JAX's shard of `whole` (a numpy copy of an output leaf) on the device
    at `coord`, by the input leaf's sharding."""
    device = mesh.devices[coord]
    return whole[jax_leaf_in.sharding.devices_indices_map(whole.shape)[device]]


def _assert_shards(got_tree, want_tree, sharded_in, mesh, coord, tol, what, atol=None):
    got, want, ins = _flat(got_tree), _flat(want_tree), _flat(sharded_in)
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path], _jax_shard(ins[path], leaf, mesh, coord),
                                   rtol=tol, atol=tol if atol is None else atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)} at {coord}")


def _coords(runs):
    return {r["coord"] for r in runs}


@pytest.mark.parametrize("name", list(MESHES))
def test_metrics_match_jax(name, jax_runs, port_runs):
    """loss, ce_loss, tokens and grad_norm of each step on every rank
    against JAX's sharded step: the global token mean and the global norm
    over the shards."""
    want = jax_runs[name]["metrics"]
    for run in port_runs[name]:
        for i, (got, w) in enumerate(zip(run["metrics"], want)):
            for key in ("loss", "ce_loss", "tokens", "grad_norm", "moe_aux_loss"):
                np.testing.assert_allclose(got[key], w[key], rtol=LOSS_TOL, atol=LOSS_TOL,
                                           err_msg=f"{name} step {i + 1} {key}")


@pytest.mark.parametrize("name", list(MESHES))
def test_param_shards_match_jax(name, jax_runs, port_runs):
    """Each rank's shard of every parameter after each step against the
    slice of JAX's array on the device at the same coordinates."""
    j = jax_runs[name]
    assert len(_coords(port_runs[name])) == N_RANKS
    for run in port_runs[name]:
        for i in range(N_STEPS):
            _assert_shards(run["params"][i], j["params"][i], j["sharded"], j["mesh"],
                           run["coord"], PARAM_TOL, f"{name} step {i + 1} param", PARAM_ATOL)


@pytest.mark.parametrize("name", list(MESHES))
def test_moment_shards_match_jax(name, jax_runs, port_runs):
    """AdamW's count and each rank's shard of mu and nu after the last step
    (the moments take the parameters' shardings: ZeRO over fsdp)."""
    j = jax_runs[name]
    for run in port_runs[name]:
        assert run["opt"]["count"] == j["opt"]["count"] == N_STEPS
        for key in ("mu", "nu"):
            _assert_shards(run["opt"][key], j["opt"][key], j["sharded"], j["mesh"],
                           run["coord"], MOMENT_TOL, f"{name} {key}")


@pytest.mark.parametrize("name", list(MESHES))
def test_ranks_metrics_bit_equal(name, port_runs):
    """Every rank reports the same metrics, bit for bit."""
    runs = port_runs[name]
    assert all(r["metrics"] == runs[0]["metrics"] for r in runs)


@pytest.mark.parametrize("name", list(MESHES))
def test_unequal_token_counts_give_the_global_mean(name, port_runs, one_rank):
    """The ranks' own rows hold unequal loss_mask counts, `tokens` is their
    sum, and the loss is the one-rank loss over the whole batch (a mean of
    the ranks' means would not be)."""
    runs = port_runs[name]
    own = [r["own_tokens"] for r in runs]
    assert len(set(own)) > 1, own
    spec = MESHES[name]
    replicas = N_RANKS // (spec.dp * spec.fsdp)  # ranks that hold the same rows
    total = sum(_batch()["loss_mask"][:, 1:].sum(axis=1))
    assert sum(own) == replicas * total
    for r in runs:
        assert r["metrics"][0]["tokens"] == total
        np.testing.assert_allclose(r["metrics"][0]["ce_loss"], one_rank["metrics"][0]["ce_loss"],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_step_equals_one_rank_step(name, port_runs, one_rank, jax_runs):
    """The port's one-rank step on the whole params (mesh=None) and the mesh
    step: the same metrics each step, and each rank's shards the slices of
    the one-rank params."""
    j = jax_runs[name]
    for run in port_runs[name]:
        for i in range(N_STEPS):
            for key, val in one_rank["metrics"][i].items():
                np.testing.assert_allclose(run["metrics"][i][key], val, rtol=LOSS_TOL,
                                           atol=LOSS_TOL, err_msg=f"{name} step {i + 1} {key}")
            _assert_shards(run["params"][i], one_rank["params"][i], j["sharded"], j["mesh"],
                           run["coord"], PARAM_TOL, f"{name} step {i + 1} one-rank param",
                           PARAM_ATOL)


@pytest.fixture(scope="module")
def checkpoint_src(tmp_path_factory):
    """test-tiny written as an HF-layout checkpoint (the port's writer)."""
    d = str(tmp_path_factory.mktemp("train_mesh_ckpt"))
    checkpoint.save_llama_params(pt_llama.init(PT_CFG, seed=9, device="cpu"), PT_CFG, d)
    return d


@pytest.mark.parametrize("name", list(MESHES))
def test_init_and_load_give_the_shards_of_the_whole(name, ranks, checkpoint_src):
    """llama.init(mesh=, rules=TRAIN_RULES), init_state(mesh=), and
    load_llama_params(mesh=, rules=TRAIN_RULES) / init_state(checkpoint_dir=,
    mesh=): bit for bit the TRAIN_RULES shard of the whole init or load; the
    moments are zeros of each shard's shape."""
    for got, moments in ranks.run(ranks_mod.init_shards, MESHES[name], "test-tiny",
                                  checkpoint_src):
        for what, (mine, whole) in got.items():
            a, b = _flat(mine), _flat(whole)
            assert a.keys() == b.keys()
            for path in b:
                np.testing.assert_array_equal(a[path], b[path], err_msg=f"{what} {path}")
        for mu_shape, nu_shape, p_shape, mu_sum, nu_sum in moments:
            assert mu_shape == nu_shape == p_shape and mu_sum == nu_sum == 0.0


@pytest.mark.parametrize("what,item", [("moe", "A6"), ("sync", "A8"), ("sp", "A6"),
                                       ("pp", "A6")])
def test_training_mesh_refusals_name_their_item(what, item, ranks):
    """A MoE model, sync=, and sp or pp of more than one rank on a training
    mesh raise NotImplementedError naming their ROADMAP item, from both
    init_state and make_train_step."""
    words = {"moe": "mixture-of-experts", "sync": "grad-sync", "sp": "sequence",
             "pp": "pipeline"}[what]
    for got in ranks.run(ranks_mod.refusal, what):
        assert all(msg is not None and f"ROADMAP {item}" in msg and words in msg
                   for msg in got), got


@pytest.mark.parametrize("name", ["all_reduce", "copy_to", "all_gather", "gather_shard"])
def test_collective_forward_and_backward(name, ranks):
    """Each collective over "tp" of MeshSpec(dp=2, tp=2), on inputs x + i (i
    the rank's tp index), under a loss Σ out·(i + 1): all_reduce (g) sums
    forward and passes the gradient through; copy_to (f) passes forward and
    sums the gradient; all_gather joins forward and keeps the rank's slice
    of the gradient; gather_shard joins forward and keeps the rank's slice
    of the gradient summed over the ranks (a reduce-scatter)."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    n = 2
    for coord, out, grad in ranks.run(ranks_mod.collective_grads, MeshSpec(dp=2, tp=2), "tp",
                                      name, x):
        i = coord[AXIS_ORDER.index("tp")]
        if name == "all_reduce":
            want_out, want_grad = sum(x + k for k in range(n)), np.full_like(x, i + 1)
        elif name == "copy_to":
            want_out, want_grad = x + i, np.full_like(x, sum(k + 1 for k in range(n)))
        elif name == "all_gather":
            want_out, want_grad = np.concatenate([x + k for k in range(n)], 1), np.full_like(
                x, i + 1)
        else:
            want_out = np.concatenate([x + k for k in range(n)], 1)
            want_grad = np.full_like(x, sum(k + 1 for k in range(n)))
        np.testing.assert_array_equal(out, want_out)
        np.testing.assert_array_equal(grad, want_grad)


def test_global_norm_counts_each_element_once(ranks):
    """optim.global_norm on dp2 x tp2 shards of a tp-cut leaf and a leaf
    replicated over tp and dp (a norm's scale) equals the norm of the whole
    leaves: the replicated one is counted once, not tp times."""
    rng = np.random.default_rng(3)
    leaves = [rng.standard_normal((4, 6)).astype(np.float32),
              rng.standard_normal((8,)).astype(np.float32)]
    axes = [("embed", "mlp"), ("embed",)]
    want = float(np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in leaves)))
    got = ranks.run(ranks_mod.global_norm_of, MeshSpec(dp=2, tp=2), leaves, axes)
    np.testing.assert_allclose(got, [want] * N_RANKS, rtol=1e-6)
