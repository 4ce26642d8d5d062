"""Port parity: gradient sync on a training mesh (ray_tpu_torch/train/
grad_sync.py through make_train_step(sync=) / init_state(sync=)) against
the JAX package's grad_sync.py, in f32 on test-tiny.

The JAX side runs in a thread of its own while the port's ranks work (its
compiles are most of this file's time), on 4 of the 8 host CPU devices that
tests/conftest.py forces: per mesh, ``init_state(mesh=, sync=)`` (its
parameters replaced by the sharded numpy tree both sides start from) and one
``make_train_step(donate=False, sync=)`` step under ``use_mesh`` with the
bucketed sync and the sharded update together (JAX's parameters are bit-equal
with and without the sharded update, so the one compile holds both). The
port side is one pool of 4 spawned gloo CPU ranks (tests/_torch_tp_ranks.py),
each on one torch thread, laying each mesh over the same ranks. Every rank
passes the global batch, whose loss_mask gives the dp replicas unequal token
counts, so the bucketed sync's equal weighting of the replicas shows. A
rank's shard (or moment slice) is held against JAX's on the device at the
same mesh coordinates. Every wait is bounded (the groups' 60 s timeout, the
pool's queue reads and joins, the JAX thread's join).
"""
import dataclasses
import threading
from unittest import mock

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
from ray_tpu.train import grad_sync as jax_gs
from ray_tpu.train import step as jax_step
from ray_tpu_torch.models import bridge
from ray_tpu_torch.models import config as pt_config
from ray_tpu_torch.models import llama as pt_llama
from ray_tpu_torch.parallel import TRAIN_RULES, MeshSpec
from ray_tpu_torch.train import grad_sync as pt_gs
from ray_tpu_torch.train import step as pt_step

from _torch_port_util import numpy_params, one_torch_thread  # noqa: F401

# test_torch_port_train_mesh.py's tolerances: f32 on both sides, the sums
# (GSPMD's, the port's gloo reductions) in other orders
LOSS_TOL = 1e-5
MOMENT_TOL = 1e-5
PARAM_TOL = 1e-5
OPT = dict(learning_rate=3e-3, warmup_steps=0, total_steps=10)  # step 1 at the peak lr
PARAM_ATOL = PARAM_TOL + 0.05 * OPT["learning_rate"]
N_RANKS = 4
N_STEPS = 2  # the port's steps; JAX takes the first (one compile per mesh)
MESHES = {"dp2xfsdp2": MeshSpec(dp=2, fsdp=2), "dp2xtp2": MeshSpec(dp=2, tp=2),
          "dp4": MeshSpec(dp=4)}
DP2 = ["dp2xfsdp2", "dp2xtp2"]
CFG = jax_config.get_config("test-tiny", attention_impl="reference")
PT_KW = dict(name="test-tiny", attention_impl="flash")
PT_CFG = pt_config.get_config(**PT_KW)
SMALL = 64 << 10  # 64 KiB buckets: 8 on test-tiny
JAX_SYNC = dict(mode="bucketed", sharded_update=True)
RUNS = {  # the port's configs, each from the same bridged state
    "plain": {},
    "bucketed": dict(mode="bucketed", bucket_bytes=SMALL),
    "one_bucket": dict(mode="bucketed"),
    "sharded": dict(mode="bucketed", bucket_bytes=SMALL, sharded_update=True),
    "sharded_alone": dict(sharded_update=True),
    "int8": dict(mode="bucketed", bucket_bytes=SMALL, compression="int8"),
    "int8_sharded": dict(mode="bucketed", bucket_bytes=SMALL, compression="int8",
                         sharded_update=True),
    "int8_stochastic": dict(mode="bucketed", bucket_bytes=SMALL, compression="int8",
                            stochastic_rounding=True),
}
QBLOCK = 256


def _batch():
    """4 rows of 33 tokens, one segment boundary, and a loss_mask whose
    density differs by row (all, ~70 %, ~30 %, one token): every split of
    the batch gives the replicas unequal counts."""
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, CFG.vocab_size, (4, 33)).astype(np.int32)
    mask = np.stack([np.ones(33), rng.random(33) < 0.7, rng.random(33) < 0.3,
                     np.eye(33)[5]]).astype(np.int32)
    seg = np.repeat(np.asarray([[0] * 12 + [1] * 21]), 4, axis=0).astype(np.int32)
    return {"tokens": tokens, "loss_mask": mask, "segment_ids": seg}


def _contributions():
    """Two ranks' contributions to one int8 reduction: 3 x 700 elements, so
    the last of each leaf's blocks of QBLOCK is padded."""
    rng = np.random.default_rng(5)
    return [(rng.standard_normal((3, 700)) * s).astype(np.float32) for s in (1.0, 0.01)]


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


def _jax_run(name, np_params):
    """JAX's bucketed, sharded-update step on one mesh -> its sharded
    inputs, params and metrics after the step, Adam's moments (arrays, with
    their shardings), the update specs and the per-shard optimizer bytes
    (and those of its scalar count leaves)."""
    mesh = _jax_mesh(MESHES[name])
    tx = jax_step.make_optimizer(**OPT)
    sync = jax_gs.GradSyncConfig(**JAX_SYNC)
    sharded = jax_sharding.shard_pytree(np_params, jax_llama.param_axes(CFG), mesh,
                                        jax_sharding.TRAIN_RULES)
    # init_state's own eager llama.init (6 s of op compiles here) draws the
    # parameters the test replaces: it is handed the numpy tree instead
    with mock.patch.object(jax_llama, "init", lambda rng, cfg: np_params):
        state = jax_step.init_state(jax.random.PRNGKey(0), CFG, tx, mesh=mesh, sync=sync)
    state = state._replace(params=sharded)
    step = jax_step.make_train_step(CFG, tx, donate=False, sync=sync)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    with jax_mesh_mod.use_mesh(mesh):
        new, m = step(state, batch)
    adam = new.opt_state[1][0]
    structs = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=x.sharding), sharded)
    abstract = jax_gs.abstract_sharded_opt_state(tx, structs, mesh, sync.update_axes)
    scalars = [x for x in jax.tree_util.tree_leaves(abstract) if x.shape == ()]
    return dict(mesh=mesh, sharded=sharded,
                params=jax.tree_util.tree_map(np.asarray, new.params),
                metrics={k: float(v) for k, v in m.items()}, mu=adam.mu, nu=adam.nu,
                specs=jax_gs.build_update_specs(sharded, mesh, sync.update_axes),
                opt_bytes=jax_gs.opt_state_bytes_per_shard(abstract),
                scalar_bytes=jax_gs.opt_state_bytes_per_shard(scalars))


def _jax_quantized_pmean(xs):
    """JAX's _quantized_pmean (round-nearest) of xs[i] on rank i of a dp-2
    mesh, in a test-side shard_map (check_vma off) -> each rank's result."""
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    sync = jax_gs.GradSyncConfig(mode="bucketed", compression="int8",
                                 quant_block_elems=QBLOCK)
    fn = jax.jit(jax.shard_map(lambda x: jax_gs._quantized_pmean(x[0], "dp", sync, None)[None],
                               mesh=mesh, in_specs=P("dp"), out_specs=P("dp"),
                               check_vma=False))
    return np.asarray(fn(jnp.asarray(np.stack(xs))))


@pytest.fixture(scope="module")
def jax_side(np_params):
    """JAX's references, computed in a thread of their own while the port's
    ranks run -> a function that joins it (within 120 s) and returns them."""
    box = {}

    def work():
        try:
            out = {name: _jax_run(name, np_params) for name in MESHES}
            out["qmean"] = _jax_quantized_pmean(_contributions())
            box["out"] = out
        except BaseException as e:  # re-raised where the references are read
            box["err"] = e

    thread = threading.Thread(target=work, name="jax-grad-sync", daemon=True)
    thread.start()

    def join():
        thread.join(120)
        if "err" in box:
            raise box["err"]
        assert "out" in box, "JAX's references took more than 120 s"
        return box["out"]

    yield join
    thread.join(120)


class _Lazy(dict):
    """A module-scoped cache: each key's value made on first use."""

    def __init__(self, make):
        super().__init__()
        self.make = make

    def __missing__(self, key):
        self[key] = self.make(key)
        return self[key]


@pytest.fixture(scope="module")
def port_runs(ranks, np_params, jax_side):
    """Per mesh: every rank's grad_sync_runs result over RUNS, by rank."""
    return _Lazy(lambda name: ranks.run(ranks_mod.grad_sync_runs, MESHES[name], np_params,
                                        PT_KW, _batch(), OPT, N_STEPS, RUNS))


@pytest.fixture(scope="module")
def port_grads(ranks, np_params, jax_side):
    """Per mesh: every rank's reduced gradients, f32 and int8, at count 0."""
    runs = {"f32": dict(mode="bucketed", bucket_bytes=SMALL),
            "int8": dict(mode="bucketed", bucket_bytes=SMALL, compression="int8")}
    return _Lazy(lambda name: ranks.run(ranks_mod.synced_grads, MESHES[name], np_params,
                                        PT_KW, _batch(), runs))


def _flat(tree):
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _name(path):
    """JAX's key path of a parameter leaf -> the port's leaf name."""
    return "/".join(str(k.key) for k in path)


def _jax_names(tree):
    return [_name(p) for p, _ in jax.tree_util.tree_leaves_with_path(tree)]


def _shard_at(leaf_in, whole, mesh, coord):
    """The slice of `whole` on the device at `coord`, by leaf_in's sharding."""
    return whole[leaf_in.sharding.devices_indices_map(whole.shape)[mesh.devices[coord]]]


def _assert_shards(got_tree, want_tree, shardings_of, mesh, coord, tol, what, atol=None):
    got, want, ins = _flat(got_tree), _flat(want_tree), _flat(shardings_of)
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path], _shard_at(ins[path], np.asarray(leaf), mesh, coord),
                                   rtol=tol, atol=tol if atol is None else atol,
                                   err_msg=f"{what} {path} at {coord}")


def _max_diff(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    return max(float(np.abs(np.asarray(fa[k]) - np.asarray(fb[k])).max()) for k in fa)


# -- the config -------------------------------------------------------------------------

CONFIGS = [{}, {"mode": "monolithic"}, {"mode": "bucketed", "compression": ""},
           {"mode": "bucketed", "compression": "int8", "stochastic_rounding": True,
            "quant_block_elems": 512, "min_quant_elems": 8},
           {"sharded_update": True, "update_axes": ["dp"], "axis": "dp"},
           {"telemetry": True, "bucket_bytes": 1 << 20}]


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(kw) or "default")
def test_config_matches_jax_field_for_field(kw):
    """Defaults, the "monolithic" alias, "" compression and a list of
    update axes normalise as JAX's GradSyncConfig does; is_default agrees."""
    got, want = pt_gs.GradSyncConfig(**kw), jax_gs.GradSyncConfig(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.is_default == want.is_default


@pytest.mark.parametrize("kw", [{"mode": "ring"}, {"mode": "bucketed", "compression": "fp8"},
                                {"compression": "int8"}], ids=["mode", "codec", "gspmd-int8"])
def test_config_errors_match_jax(kw):
    """An unknown mode or codec, and compression without mode="bucketed",
    raise JAX's ValueError."""
    with pytest.raises(ValueError) as want:
        jax_gs.GradSyncConfig(**kw)
    with pytest.raises(ValueError, match=str(want.value).split(" (")[0]):
        pt_gs.GradSyncConfig(**kw)


def test_env_round_trip_matches_jax(monkeypatch):
    """to_env gives JAX's names and values; from_env of them gives the config
    back on both sides, and the defaults with the names unset."""
    cfg = dict(CONFIGS[3], bucket_bytes=12345, sharded_update=True, update_axes=("dp",))
    env = pt_gs.GradSyncConfig(**cfg).to_env()
    assert env == jax_gs.GradSyncConfig(**cfg).to_env()
    for name in env:
        monkeypatch.delenv(name, raising=False)
    assert pt_gs.GradSyncConfig.from_env() == pt_gs.GradSyncConfig()
    for name, val in env.items():
        monkeypatch.setenv(name, val)
    assert pt_gs.GradSyncConfig.from_env() == pt_gs.GradSyncConfig(**cfg)
    assert dataclasses.asdict(jax_gs.GradSyncConfig.from_env()) == dataclasses.asdict(
        pt_gs.GradSyncConfig.from_env())


def test_sync_none_reads_the_environment(monkeypatch):
    """make_train_step(sync=None) reads GradSyncConfig.from_env(), as JAX's
    does: a bucketed mode from the environment reaches the step, and
    telemetry from it refuses naming A11."""
    tx = pt_step.make_optimizer()
    monkeypatch.setenv("RAY_TPU_TRAIN_GRAD_SYNC_MODE", "bucketed")
    assert pt_step.make_train_step(PT_CFG, tx, device="cpu").sync.mode == "bucketed"
    monkeypatch.setenv("RAY_TPU_TRAIN_GRAD_SYNC_TELEMETRY", "1")
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        pt_step.make_train_step(PT_CFG, tx, device="cpu")


# -- buckets and payload ----------------------------------------------------------------

def test_leaf_order_is_jax_tree_order(np_params):
    """The port's leaf order (llama.tree_leaves) names JAX's tree-flatten
    order of the same parameter dict, leaf for leaf."""
    assert pt_gs.leaf_names(PT_CFG) == _jax_names(np_params)
    assert [tuple(x.shape) for x in pt_gs.global_leaves(PT_CFG)] == [
        x.shape for x in jax.tree_util.tree_leaves(np_params)]


@pytest.mark.parametrize("nbytes", [1, SMALL, 4 << 20])
def test_buckets_match_jax(nbytes, np_params):
    """partition_buckets over the global shapes gives JAX's buckets of the
    same tree, by leaf name."""
    names = _jax_names(np_params)
    want = [[names[i] for i in b] for b in jax_gs.partition_buckets(np_params, nbytes)]
    got_names = pt_gs.leaf_names(PT_CFG)
    got = [[got_names[i] for i in b]
           for b in pt_gs.partition_buckets(pt_gs.global_leaves(PT_CFG), nbytes)]
    assert got == want


@pytest.mark.parametrize("compression", [None, "int8"])
def test_payload_bytes_match_jax(compression, np_params):
    """sync_payload_bytes equals JAX's for the same tree and config."""
    kw = dict(mode="bucketed", compression=compression)
    assert pt_gs.sync_payload_bytes(pt_gs.global_leaves(PT_CFG), pt_gs.GradSyncConfig(**kw)) \
        == jax_gs.sync_payload_bytes(np_params, jax_gs.GradSyncConfig(**kw))


# -- the bucketed f32 step --------------------------------------------------------------

@pytest.mark.parametrize("name", list(MESHES))
def test_step_buckets_name_jax_leaves(name, port_runs, np_params):
    """step.buckets names the leaves JAX's partition of the global grads
    names, whatever the rank's shards are."""
    names = _jax_names(np_params)
    want = [[names[i] for i in b] for b in jax_gs.partition_buckets(np_params, SMALL)]
    for run in port_runs[name]:
        assert run["bucketed"]["buckets"] == want


@pytest.fixture(scope="module")
def replica_means(np_params):
    """Per dp size: the mean of the replicas' own token means, and the norm
    of the mean of their gradients, from the port's one-rank loss_fn on each
    replica's rows of the batch."""

    def make(dp):
        batch = {k: torch.from_numpy(v).long() for k, v in _batch().items()}
        params = bridge.params_from_jax(np_params, PT_CFG, device="cpu")
        leaves = [p.requires_grad_(True) for p in pt_llama.tree_leaves(params)]
        rows = 4 // dp
        means, grads = [], []
        for r in range(dp):
            loss = pt_llama.loss_fn(params, {k: v[r * rows:(r + 1) * rows]
                                             for k, v in batch.items()}, PT_CFG)[0]
            means.append(loss.item())
            grads.append(torch.autograd.grad(loss, leaves))
        norm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(sum(gs) / dp) for gs in zip(*grads)])))
        return float(np.mean(means)), norm

    return _Lazy(make)


@pytest.mark.parametrize("name", list(MESHES))
def test_replicas_weigh_equally(name, port_runs, replica_means):
    """With a ragged loss_mask the bucketed loss is the mean of the dp
    replicas' own token means and grad_norm the norm of the mean of their
    gradients (the port's one-rank loss_fn on each replica's rows), not the
    plain step's global token mean; tokens is the sum."""
    mean, norm = replica_means[MESHES[name].dp]
    total = int(_batch()["loss_mask"][:, 1:].sum())
    for run in port_runs[name]:
        got, plain = run["bucketed"]["metrics"][0], run["plain"]["metrics"][0]
        assert got["tokens"] == plain["tokens"] == total
        np.testing.assert_allclose(got["loss"], mean, rtol=LOSS_TOL, atol=LOSS_TOL)
        np.testing.assert_allclose(got["grad_norm"], norm, rtol=LOSS_TOL, atol=LOSS_TOL)
        assert abs(got["loss"] - plain["loss"]) > 100 * LOSS_TOL  # the weighting shows


@pytest.mark.parametrize("name", list(MESHES))
def test_ranks_metrics_bit_equal(name, port_runs):
    """Every rank reports the same metrics, bit for bit, in every mode."""
    runs = port_runs[name]
    for mode in RUNS:
        assert all(r[mode]["metrics"] == runs[0][mode]["metrics"] for r in runs), mode


@pytest.mark.parametrize("name", DP2)
def test_bucket_boundaries_do_not_change_the_step(name, port_runs):
    """64 KiB buckets (8) and 4 MiB (1) give bit-equal parameters and
    moments at dp 2, where each element's reduction is one a + b."""
    for run in port_runs[name]:
        a, b = run["bucketed"], run["one_bucket"]
        assert len(a["buckets"]) == 8 and len(b["buckets"]) == 1
        for i in range(N_STEPS):
            assert _max_diff(a["params"][i], b["params"][i]) == 0.0
            assert _max_diff(a["opt"][i]["mu"], b["opt"][i]["mu"]) == 0.0
            assert a["metrics"][i] == b["metrics"][i]


@pytest.mark.parametrize("name", list(MESHES))
def test_reductions_launched_during_the_backward(name, port_runs):
    """The 8-bucket step launched its first reduction before the backward's
    last gradient (overlap_report not sunk to the end), one per bucket; the
    one-bucket step's only reduction comes after it."""
    for run in port_runs[name]:
        rep = run["bucketed"]["report"]
        assert rep["n_reductions"] == 8 and not rep["all_sunk_to_end"], rep
        assert rep["first_reduction_pos"] < rep["last_compute_pos"]
        assert min(rep["launch_s"]) < 0.0
        assert run["one_bucket"]["report"]["all_sunk_to_end"]


# -- the sharded update -----------------------------------------------------------------

@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_update_bit_equal_to_the_unsharded_step(name, port_runs):
    """The sharded update gives the parameters of the replicated one, bit
    for bit, over the bucketed f32 sync, the plain sync and the int8 sync."""
    for run in port_runs[name]:
        for sharded, whole in (("sharded", "bucketed"), ("sharded_alone", "plain"),
                               ("int8_sharded", "int8")):
            for i in range(N_STEPS):
                assert _max_diff(run[sharded]["params"][i], run[whole]["params"][i]) == 0.0, (
                    sharded, i)
                assert run[sharded]["metrics"][i] == run[whole]["metrics"][i]


# -- the int8 reduction -----------------------------------------------------------------

def _block_bound(scales, n, block, div):
    """Per element: the mean over ranks of amax_block / div (amax = 127 x
    the block's scale), for a leaf of n elements."""
    amax = np.asarray(scales, np.float64) * 127.0  # [W, nblocks]
    per_block = (amax / div).mean(axis=0)
    return np.repeat(per_block, block)[:n]


def test_stochastic_rounding_bound_and_unbiased(ranks):
    """Stochastic rounding's reduced values lie within the mean over ranks
    of amax_block/127, and over 64 seeds their mean converges to the exact
    mean (tests/test_grad_sync.py's unbiasedness check, on the reduction)."""
    xs = _contributions()
    seeds = list(range(64))
    exact = (xs[0].astype(np.float64) + xs[1]) / 2
    for coord, near, sr in ranks.run(ranks_mod.quantized_means, MESHES["dp2xfsdp2"], xs,
                                     dict(quant_block_elems=QBLOCK), seeds):
        flats = [x.reshape(-1) for x in xs]
        nb = -(-flats[0].size // QBLOCK)
        pads = [np.pad(f, (0, nb * QBLOCK - f.size)).reshape(nb, QBLOCK) for f in flats]
        scales = [np.abs(p).max(axis=1) / 127.0 for p in pads]
        bound = _block_bound(scales, flats[0].size, QBLOCK, 127) * (1 + 1e-4)
        assert np.all(np.abs(sr.reshape(len(seeds), -1) - exact.reshape(-1)) <= bound)
        assert not np.array_equal(sr[0], sr[1])
        # unbiased: the mean over seeds sits far closer to the exact mean
        # than round-nearest's error, element by element on average
        err_sr = np.abs(sr.mean(axis=0) - exact).mean()
        err_near_bound = bound.mean()
        assert err_sr < 0.2 * err_near_bound, (err_sr, err_near_bound)
    x = np.full((512,), 0.3, np.float32)
    for _, _, sr in ranks.run(ranks_mod.quantized_means, MESHES["dp2xfsdp2"], [x, x],
                              dict(quant_block_elems=128), seeds):
        assert abs(float(sr.mean()) - 0.3) < 2e-3


@pytest.mark.parametrize("name", list(MESHES))
def test_int8_gradients_within_the_contract(name, port_grads):
    """The int8 step's reduced gradient of every quantized leaf against the
    f32 step's: per element within the mean over dp ranks of amax_block/254
    (the block scales the ranks gathered); the leaves left in f32 agree."""
    spec = MESHES[name]
    for run in port_grads[name]:
        names, f32, _ = run["f32"]
        _, int8, scales = run["int8"]
        assert scales, "no leaf was quantized"
        for leaf, a, b in zip(names, f32, int8):
            if leaf not in scales:
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7, err_msg=leaf)
                continue
            assert scales[leaf].shape[0] == spec.dp
            bound = _block_bound(scales[leaf], a.size, 1024, 254)
            slack = 1e-6 * float(np.abs(a).max())  # f32 rounding of the sums
            err = np.abs(b.astype(np.float64) - a).reshape(-1)
            assert np.all(err <= bound + slack), (leaf, float((err - bound).max()))
            assert err.max() > 0.0  # the int8 path ran


@pytest.mark.parametrize("name", list(MESHES))
def test_int8_steps_train(name, port_runs):
    """The int8 step, round-nearest and stochastic, alone and with the
    sharded update: finite losses, the first step's loss the f32 step's
    (computed before the sync), and the parameters within 2.5 x the steps'
    learning rates of the f32 step's (chip_smoke's phase F slack)."""
    sched = pt_step.make_optimizer(**OPT).learning_rate
    slack = 2.5 * sum(sched(i) for i in range(N_STEPS))
    for run in port_runs[name]:
        ref = run["bucketed"]
        for mode in ("int8", "int8_sharded", "int8_stochastic"):
            got = run[mode]
            assert all(np.isfinite(m["loss"]) for m in got["metrics"])
            assert got["metrics"][0]["loss"] == ref["metrics"][0]["loss"]
            assert 0.0 < _max_diff(got["params"][-1], ref["params"][-1]) <= slack, mode


# -- what refuses -----------------------------------------------------------------------

def test_telemetry_refuses_naming_a11():
    """GradSyncConfig(telemetry=True), JAX's InstrumentedGradSyncStep,
    raises naming ROADMAP A11 from both entry points."""
    sync = pt_gs.GradSyncConfig(mode="bucketed", telemetry=True)
    tx = pt_step.make_optimizer()
    for call in (pt_step.init_state, pt_step.make_train_step):
        with pytest.raises(NotImplementedError, match="ROADMAP A11"):
            call(PT_CFG, tx, device="cpu", sync=sync)


@pytest.mark.parametrize("what", ["moe", "sp", "pp"])
def test_sync_on_a_mesh_it_does_not_run_refuses_naming_a6(what, ranks):
    """sync= with a MoE model, or on a mesh with sp or pp, raises
    NotImplementedError naming A6 from init_state and make_train_step."""
    spec = {"moe": MeshSpec(dp=2, fsdp=2), "sp": MeshSpec(dp=2, sp=2),
            "pp": MeshSpec(pp=2, dp=2)}[what]
    name = "moe-tiny" if what == "moe" else "test-tiny"
    for got in ranks.run(ranks_mod.sync_refusal, spec, name, dict(mode="bucketed")):
        for kind, msg in got:
            assert kind == "NotImplementedError" and "grad sync" in msg and "ROADMAP A6" in msg


def test_ring_attention_refuses_with_jax_value_error(ranks):
    """The bucketed sync with ring attention raises JAX's ValueError from
    make_train_step (JAX's _check_model_compat); init_state builds."""
    with pytest.raises(ValueError) as want:
        jax_gs._check_model_compat(jax_config.get_config("test-tiny", attention_impl="ring"))
    for init, step in ranks.run(ranks_mod.sync_refusal, MESHES["dp2xfsdp2"], "test-tiny",
                                dict(mode="bucketed"), dict(attention_impl="ring")):
        assert init is None
        assert step == ("ValueError", str(want.value))


def test_sync_takes_only_a_config():
    """sync= other than a GradSyncConfig or None raises TypeError."""
    with pytest.raises(TypeError, match="GradSyncConfig"):
        pt_step.make_train_step(PT_CFG, pt_step.make_optimizer(), device="cpu", sync="x")


def test_a_state_laid_out_for_another_sync_refuses():
    """init_state without the sharded update feeds a sharded step (the
    moments are sliced on the first step, as JAX re-lays them out); the
    state of a sharded init_state fed to a replicated step raises. On no
    mesh the sharded update changes nothing."""
    tx = pt_step.make_optimizer()
    sync = pt_gs.GradSyncConfig(sharded_update=True)
    state = pt_step.init_state(PT_CFG, tx, device="cpu", sync=sync)
    assert [m.shape for m in state.opt_state.mu] == [
        p.shape for p in pt_llama.tree_leaves(state.params)]
    batch = {k: torch.from_numpy(v).long() for k, v in _batch().items()}
    a, ma = pt_step.make_train_step(PT_CFG, tx, donate=False, device="cpu", sync=sync)(
        state, batch)
    b, mb = pt_step.make_train_step(PT_CFG, tx, donate=False, device="cpu")(state, batch)
    assert {k: v.item() for k, v in ma.items()} == {k: v.item() for k, v in mb.items()}
    assert all(torch.equal(x, y) for x, y in zip(pt_llama.tree_leaves(a.params),
                                                 pt_llama.tree_leaves(b.params)))
    bad = state._replace(opt_state=state.opt_state._replace(
        mu=[m[:1] for m in state.opt_state.mu]))
    with pytest.raises(ValueError, match="sharded_update"):
        pt_step.make_train_step(PT_CFG, tx, device="cpu")(bad, batch)


# -- against JAX's steps (last: its thread ran while the tests above did) -----------

@pytest.mark.parametrize("name", list(MESHES))
def test_bucketed_step_matches_jax(name, jax_side, port_runs):
    """The port's bucketed step (8 buckets) against JAX's bucketed step:
    loss, ce_loss, tokens and grad_norm on every rank, and each rank's shard
    of every parameter after the step at its mesh coordinates.

    JAX's grad_norm is held divided by the dp size. Under this jax, the
    gradients leave JAX's dp-manual shard_map summed over dp, not averaged
    (the transpose of the replicated parameters' implicit broadcast adds a
    psum before its pmean): its norm is dp x the norm of the replicas' mean
    gradient that its docstring defines and the port takes (the test below
    holds the port to that mean). The clip binds at these norms, and a
    power-of-2 scale before it leaves the update bit for bit, so JAX's
    parameters and moments are the mean's."""
    j = jax_side()[name]
    dp = MESHES[name].dp
    for run in port_runs[name]:
        got = run["bucketed"]
        for key, want in j["metrics"].items():
            want = want / dp if key == "grad_norm" else want
            np.testing.assert_allclose(got["metrics"][0][key], want, rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=f"{name} {key}")
        _assert_shards(got["params"][0], j["params"], j["sharded"], j["mesh"], run["coord"],
                       PARAM_TOL, f"{name} param", PARAM_ATOL)


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_moments_match_jax(name, jax_side, port_runs):
    """Each rank's slice of mu and nu after the step against JAX's moment
    shard at the same mesh coordinates (JAX's moments carry dp in their
    spec)."""
    j = jax_side()[name]
    for run in port_runs[name]:
        opt = run["sharded"]["opt"][0]
        for key in ("mu", "nu"):
            _assert_shards(opt[key], j[key], j[key], j["mesh"], run["coord"], MOMENT_TOL,
                           f"{name} {key}")


@pytest.mark.parametrize("name", list(MESHES))
def test_update_dims_match_build_update_specs(name, jax_side, port_runs):
    """update_dims on the rank gives JAX's build_update_specs: each leaf's
    spec by TRAIN_RULES with the added axes on the same dim."""
    j = jax_side()[name]
    want = [tuple(pt_gs._names(e) for e in spec)
            for spec in jax.tree_util.tree_leaves(j["specs"],
                                                  is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    axes = pt_llama.tree_leaves(pt_llama.param_axes(PT_CFG))
    for run in port_runs[name]:
        got = []
        for leaf_axes, d in zip(axes, run["sharded"]["dims"]):
            entries = [pt_gs._names(e) for e in TRAIN_RULES.spec(leaf_axes)]
            if d is not None:
                entries[d.dim] = entries[d.dim] + d.axes
            got.append(tuple(entries))
        assert got == want
        assert any(d is not None for d in run["sharded"]["dims"])


@pytest.mark.parametrize("name", list(MESHES))
def test_optimizer_bytes_match_jax(name, jax_side, port_runs):
    """The rank's optimizer bytes under the sharded update equal JAX's
    opt_state_bytes_per_shard of the abstract sharded state (less optax's
    two int32 counts, which the port keeps on the host), and cut the plain
    step's by the dp size."""
    j = jax_side()[name]
    for run in port_runs[name]:
        assert run["sharded"]["opt_bytes"] == j["opt_bytes"] - j["scalar_bytes"]
        assert run["sharded"]["opt_bytes"] * MESHES[name].dp == run["bucketed"]["opt_bytes"]


def test_quantized_mean_matches_jax_bit_for_bit(ranks, jax_side):
    """quantized_mean over dp 2 (round-nearest) equals JAX's _quantized_pmean
    in a test-side shard_map, bit for bit, on every rank."""
    xs = _contributions()
    got = ranks.run(ranks_mod.quantized_means, MESHES["dp2xfsdp2"], xs,
                    dict(quant_block_elems=QBLOCK), [])
    want = jax_side()["qmean"]
    for coord, near, _ in got:
        np.testing.assert_array_equal(near, want[coord[1]])
    np.testing.assert_array_equal(want[0], want[1])
