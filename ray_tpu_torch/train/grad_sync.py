"""Gradient synchronization for data-parallel training (port of
ray_tpu/train/grad_sync.py).

``make_train_step(sync=GradSyncConfig(...), mesh=)`` makes the dp gradient
reduction an explicit stage, with the JAX module's three composable pieces:

1. **Bucketed reduction** (``mode="bucketed"``). The gradients are split
   into buckets of at most ``bucket_bytes`` (``partition_buckets`` over the
   leaves' GLOBAL shapes in the JAX tree order, so a bucket names the same
   leaves as JAX's whatever a rank's shards are). Each parameter's tensor
   hook marks its gradient ready during the backward; when a bucket's last
   leaf is ready, the hook launches that bucket's reduction over dp
   (``async_op=True``), so the buckets the backward finishes first are
   reduced while it computes the rest. The step waits on every bucket
   before the update. As in JAX's dp-manual shard_map, each dp replica
   takes its own token mean (``loss_fn(manual=("dp",))``) and the
   gradients, the loss and the aux values are averaged over dp: with a
   ragged ``loss_mask`` the replicas weigh equally, not per token, and
   ``metrics["tokens"]`` is the replicas' mean count times dp. fsdp and tp
   inside a replica are ``loss_fn(mesh=)``'s, as without ``sync=``.

2. **int8 block-quantized reduction** (``compression="int8"``). Each rank
   quantizes its contribution (``ops/quant.quantize_blockwise``: blocks of
   ``quant_block_elems`` over the rank's flattened shard), the int8 payload
   and the f32 block scales are all-gathered over dp, dequantized and summed
   in f32 in rank order, then divided by the dp size. Per element the error
   is at most the mean over the ranks of amax_block/254 (round-nearest) or
   amax_block/127 (``stochastic_rounding``). Leaves of fewer than
   ``min_quant_elems`` elements (globally) stay f32. Stochastic rounding
   draws from a ``torch.Generator`` seeded from 0xE0A, the update count, the
   leaf and the rank, so a step is reproducible; the draws are not
   jax.random's.

3. **Sharded optimizer update** (``sharded_update=True``, ZeRO's weight-update
   sharding). ``update_dims`` gives each leaf the dim and the mesh axes that
   JAX's ``build_update_specs`` adds to its spec (the ``update_axes`` of more
   than one rank that do not cut it yet, on the dim with the largest evenly
   divisible local extent). ``init_state(sync=)`` lays the AdamW moments out
   as the rank's slice of its shard from the start. The step takes the
   global norm from the whole reduced gradients (JAX's ``:499``), updates
   the rank's slice of each parameter with its slice of the gradient and its
   moments, and all-gathers the parameters back to their compute shards.
   The slice is taken after an all-reduce on every backend, since the norm
   needs the whole gradient; a reduce-scatter over NCCL is not used.

Reductions run on the mesh's process groups: over gloo (CPU ranks, or ranks
sharing a card, staged through the host) in gloo's own threads, so the
backward goes on while a bucket is reduced. ``overlap_report`` reads a
step's launch record where JAX reads its HLO.

A default config gives the plain mesh step: the global token mean, one
all-reduce per leaf after the backward, the AdamW update on the local
shards. ``telemetry=True`` (JAX's InstrumentedGradSyncStep) raises naming
ROADMAP A11; ``sync=`` with a MoE model, or sp or pp on the mesh, raises
naming A6.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.config import ModelConfig
from ray_tpu_torch.ops.quant import quantize_blockwise
from ray_tpu_torch.parallel.mesh import axis_index, axis_size
from ray_tpu_torch.parallel.sharding import (TRAIN_RULES, AxisRules, all_gather, all_reduce,
                                             cut_axes)

from . import optim

DEFAULT_BUCKET_BYTES = 4 << 20  # 4 MiB: ~8 buckets on a 500M-param f32 tree
SEED = 0xE0A  # the stochastic rounding's root seed (JAX's PRNGKey(0xE0A))

_TRUE = ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class GradSyncConfig:
    """Gradient-sync strategy for ``make_train_step`` (env-overridable, as in
    the JAX package: ``to_env`` / ``from_env`` over the same names).

    mode: "gspmd" (default; the plain sync, alias "monolithic") or
        "bucketed" (per-bucket reductions launched during the backward).
    bucket_bytes: max payload per bucket (RAY_TPU_TRAIN_BUCKET_BYTES).
    compression: None (f32) or "int8" (block-quantized; see the module
        docstring for the tolerance contract).
    stochastic_rounding: unbiased quantizer (int8 only).
    quant_block_elems: elements per int8 scale block.
    min_quant_elems: leaves smaller than this stay f32 even under int8.
    sharded_update: ZeRO-style cross-replica sharded optimizer update.
    update_axes: mesh axes the update shards over (on top of each param's own
        sharding); axes of one rank are ignored.
    axis: the mesh axis the gradients are reduced over.
    telemetry: JAX's per-phase timing mode (ROADMAP A11: raises here).
    """

    mode: str = "gspmd"
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    compression: Optional[str] = None
    stochastic_rounding: bool = False
    quant_block_elems: int = 1024
    min_quant_elems: int = 256
    sharded_update: bool = False
    update_axes: Tuple[str, ...] = ("dp", "fsdp")
    axis: str = "dp"
    telemetry: bool = False

    def __post_init__(self):
        mode = {"monolithic": "gspmd"}.get(self.mode, self.mode)
        if mode not in ("gspmd", "bucketed"):
            raise ValueError(f"unknown grad-sync mode {self.mode!r}")
        object.__setattr__(self, "mode", mode)
        if self.compression not in (None, "", "int8"):
            raise ValueError(f"unknown grad compression {self.compression!r}")
        if not self.compression:
            object.__setattr__(self, "compression", None)
        if self.compression and mode != "bucketed":
            # silently running the stock uncompressed step while the user
            # believes int8 is on would be the worst failure mode
            raise ValueError(
                "compression requires mode='bucketed' (the gspmd/monolithic "
                "sync is implicit — there is no stage to compress)")
        if isinstance(self.update_axes, list):
            object.__setattr__(self, "update_axes", tuple(self.update_axes))

    @property
    def is_default(self) -> bool:
        """True when the config changes nothing vs the plain step."""
        return (self.mode == "gspmd" and not self.sharded_update
                and not self.telemetry)

    @staticmethod
    def from_env() -> "GradSyncConfig":
        axes = os.environ.get("RAY_TPU_TRAIN_UPDATE_AXES", "") or "dp,fsdp"
        return GradSyncConfig(
            mode=os.environ.get("RAY_TPU_TRAIN_GRAD_SYNC_MODE", "gspmd") or "gspmd",
            bucket_bytes=_env_int("RAY_TPU_TRAIN_BUCKET_BYTES", DEFAULT_BUCKET_BYTES),
            compression=os.environ.get("RAY_TPU_TRAIN_GRAD_COMPRESSION", "") or None,
            stochastic_rounding=os.environ.get(
                "RAY_TPU_TRAIN_GRAD_STOCHASTIC_ROUNDING", "").lower() in _TRUE,
            quant_block_elems=_env_int("RAY_TPU_TRAIN_QUANT_BLOCK_ELEMS", 1024),
            min_quant_elems=_env_int("RAY_TPU_TRAIN_MIN_QUANT_ELEMS", 256),
            sharded_update=os.environ.get(
                "RAY_TPU_TRAIN_SHARDED_UPDATE", "").lower() in _TRUE,
            update_axes=tuple(a for a in axes.split(",") if a),
            axis=os.environ.get("RAY_TPU_TRAIN_GRAD_SYNC_AXIS", "") or "dp",
            telemetry=os.environ.get(
                "RAY_TPU_TRAIN_GRAD_SYNC_TELEMETRY", "").lower() in _TRUE,
        )

    def to_env(self) -> Dict[str, str]:
        """Env representation (inverse of from_env) for worker propagation."""
        return {
            "RAY_TPU_TRAIN_GRAD_SYNC_MODE": self.mode,
            "RAY_TPU_TRAIN_BUCKET_BYTES": str(self.bucket_bytes),
            "RAY_TPU_TRAIN_GRAD_COMPRESSION": self.compression or "",
            "RAY_TPU_TRAIN_GRAD_STOCHASTIC_ROUNDING":
                "1" if self.stochastic_rounding else "",
            "RAY_TPU_TRAIN_QUANT_BLOCK_ELEMS": str(self.quant_block_elems),
            "RAY_TPU_TRAIN_MIN_QUANT_ELEMS": str(self.min_quant_elems),
            "RAY_TPU_TRAIN_SHARDED_UPDATE": "1" if self.sharded_update else "",
            "RAY_TPU_TRAIN_UPDATE_AXES": ",".join(self.update_axes),
            "RAY_TPU_TRAIN_GRAD_SYNC_AXIS": self.axis,
            "RAY_TPU_TRAIN_GRAD_SYNC_TELEMETRY": "1" if self.telemetry else "",
        }


def resolve(sync: Any) -> GradSyncConfig:
    """`sync=` as the train entry points take it: None reads
    GradSyncConfig.from_env() (as JAX's make_train_step does); anything else
    must be a GradSyncConfig."""
    if sync is None:
        return GradSyncConfig.from_env()
    if not isinstance(sync, GradSyncConfig):
        raise TypeError(f"sync= takes a GradSyncConfig or None, got {type(sync).__name__}")
    return sync


def check_supported(cfg: ModelConfig, mesh, sync: GradSyncConfig) -> None:
    """Refuse what the port's grad sync does not run yet, naming its ROADMAP
    item: telemetry (A11), and a non-default sync with a MoE model or sp or
    pp on the mesh (A6)."""
    if sync.telemetry:
        raise NotImplementedError(
            "grad-sync telemetry (GradSyncConfig(telemetry=True): train.step_phase spans "
            "and the train_grad_sync_seconds histogram): ROADMAP A11")
    if sync.is_default or mesh is None:
        return
    if cfg.n_experts > 0:
        raise NotImplementedError("grad sync (sync=...) with a mixture-of-experts model on "
                                  "a training mesh (expert parallelism, ep): ROADMAP A6")
    for axis in ("sp", "pp"):
        if axis_size(mesh, axis) > 1:
            raise NotImplementedError(f"grad sync (sync=...) on a mesh with {axis} = "
                                      f"{axis_size(mesh, axis)}: ROADMAP A6")


def check_model_compat(cfg: ModelConfig) -> None:
    """JAX's _check_model_compat: what the bucketed sync does not compose with."""
    if getattr(cfg, "pipeline_stages", 1) > 1:
        raise ValueError(
            "bucketed grad sync opens its own dp-manual shard_map and does "
            "not compose with pipeline_stages > 1 (nested shard_map)")
    if getattr(cfg, "attention_impl", "auto") in ("ring", "ulysses"):
        raise ValueError(
            "bucketed grad sync does not compose with ring/ulysses attention "
            "(nested shard_map); use mode='gspmd'")


# ---------------------------------------------------------------- bucketing

def _numel(leaf) -> int:
    return math.prod(tuple(leaf.shape) or (1,))


def global_leaves(cfg: ModelConfig, dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """The parameters' GLOBAL shapes as meta tensors of `dtype`, in the
    optimizer's leaf order (llama.tree_leaves: sorted keys, JAX's
    tree-flatten order of the same dict)."""
    shapes = llama.tree_leaves(llama.param_shapes(cfg))
    return [torch.empty(s, dtype=dtype, device="meta") for s in shapes]


def leaf_names(cfg: ModelConfig) -> List[str]:
    """"embed", "layers/wq", ... in the optimizer's leaf order."""
    shapes = llama.param_shapes(cfg)
    named = {k: ({s: f"{k}/{s}" for s in v} if isinstance(v, dict) else k)
             for k, v in shapes.items()}
    return llama.tree_leaves(named)


def partition_buckets(leaves: Sequence[torch.Tensor], bucket_bytes: int) -> List[List[int]]:
    """Partition leaves into size-bounded buckets: lists of leaf indices in
    order. A leaf larger than `bucket_bytes` gets its own bucket; every leaf
    lands in exactly one. Works on any tensors, meta ones included (JAX's
    rule, line for line)."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, leaf in enumerate(leaves):
        nbytes = _numel(leaf) * leaf.dtype.itemsize
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        if cur_bytes >= bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)
    return buckets


def sync_payload_bytes(leaves: Sequence[torch.Tensor], sync: GradSyncConfig) -> Dict[str, int]:
    """Analytic per-rank payload bytes one sync moves, f32 vs the configured
    compression (JAX's accounting)."""
    f32 = 0
    compressed = 0
    for leaf in leaves:
        n = _numel(leaf)
        f32 += 4 * n
        if sync.compression == "int8" and n >= sync.min_quant_elems:
            compressed += n + 4 * (-(-n // sync.quant_block_elems))
        else:
            compressed += 4 * n
    return {"f32_bytes": f32, "compressed_bytes": compressed}


# -------------------------------------------------------- the int8 reduction

def rounding_generator(count: int, leaf: int, rank: int,
                       device: torch.device) -> torch.Generator:
    """The stochastic rounding's generator for one (update count, leaf,
    rank): every rank's draws differ, and a step is reproducible."""
    gen = torch.Generator(device=device)
    gen.manual_seed((((SEED * 1_000_003 + count) * 1_000_003 + leaf) * 1_000_003 + rank)
                    % (1 << 63))
    return gen


def _dequant_mean(qs: Sequence[torch.Tensor], scales: Sequence[torch.Tensor],
                  n: int) -> torch.Tensor:
    """Σ_w q_w · s_w in f32, in rank order, over the first n elements, / W.
    XLA's sum contracts each acc + q·s into one fused multiply-add; here
    q·s is exact in f64 (an int8 times an f32) and the f64 sum is rounded
    once to f32, as the FMA rounds."""
    total = None
    for q, s in zip(qs, scales):
        part = q.double() * s.double()
        total = (part if total is None else total.double() + part).float()
    return total.reshape(-1)[:n] / len(qs)


def _gather(x: torch.Tensor, mesh, axis: str, async_op: bool = False):
    """x of every rank of the axis, in rank order (and the work when async)."""
    if axis_size(mesh, axis) == 1:
        return [x], None
    out = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    work = dist.all_gather(out, x, group=mesh.get_group(axis), async_op=async_op)
    return out, work


def quantized_mean(x: torch.Tensor, mesh, axis: str, sync: GradSyncConfig,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """JAX's _quantized_pmean on one tensor: quantize this rank's
    contribution, all-gather the int8 payload and the block scales over
    `axis`, dequant-sum in f32 in rank order, divide by the axis size."""
    q, s = quantize_blockwise(x, sync.quant_block_elems, generator)
    qs, _ = _gather(q, mesh, axis)
    ss, _ = _gather(s, mesh, axis)
    return _dequant_mean(qs, ss, x.numel()).view(x.shape).to(x.dtype)


# ------------------------------------------------- sharded optimizer update

class UpdateDim(NamedTuple):
    """Where a leaf's update is cut further: its dim, and the mesh axes
    (major first) that cut that dim of the rank's shard."""

    dim: int
    axes: Tuple[str, ...]


def _names(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def update_dims(cfg: ModelConfig, mesh, rules: AxisRules = TRAIN_RULES,
                axes: Sequence[str] = ("dp", "fsdp")) -> List[Optional[UpdateDim]]:
    """Per leaf (optimizer order), JAX's build_update_specs rule on the
    global shape and the leaf's spec by `rules`: the `axes` of more than one
    rank that the spec does not use yet, added to the dim with the largest
    evenly divisible local extent (the first on a tie), or None when no dim
    divides (the leaf's update stays replicated)."""
    out: List[Optional[UpdateDim]] = []
    for shape, leaf_axes in zip(llama.tree_leaves(llama.param_shapes(cfg)),
                                llama.tree_leaves(llama.param_axes(cfg))):
        spec = rules.spec(leaf_axes)
        used = {a for e in spec for a in _names(e)}
        add = tuple(a for a in axes if a not in used and axis_size(mesh, a) > 1)
        if not add or not shape:
            out.append(None)
            continue
        addf = math.prod(axis_size(mesh, a) for a in add)
        best, best_local = None, 0
        for i, (dim, entry) in enumerate(zip(shape, spec)):
            local = dim // math.prod(axis_size(mesh, a) for a in _names(entry))
            if local % addf == 0 and local >= addf and local > best_local:
                best, best_local = i, local
        out.append(None if best is None else UpdateDim(best, add))
    return out


def update_slice(x: torch.Tensor, mesh, d: Optional[UpdateDim]) -> torch.Tensor:
    """This rank's slice of a shard along its update dim (x without one)."""
    if d is None:
        return x
    idx, n = 0, 1
    for a in d.axes:
        idx, n = idx * axis_size(mesh, a) + axis_index(mesh, a), n * axis_size(mesh, a)
    size = x.shape[d.dim] // n
    return x.narrow(d.dim, idx * size, size)


def update_layout(tensors: List[torch.Tensor], mesh,
                  dims: List[Optional[UpdateDim]]) -> List[torch.Tensor]:
    """Each shard's update slice as a contiguous copy (the shard itself where
    the leaf has no update dim)."""
    return [x if d is None else update_slice(x, mesh, d).contiguous()
            for x, d in zip(tensors, dims)]


def opt_state_bytes_per_shard(opt_state: optim.AdamWState) -> int:
    """The rank's optimizer bytes: its moments (the count is a host int;
    optax's two int32 counts are not here)."""
    return sum(t.nelement() * t.element_size() for t in (*opt_state.mu, *opt_state.nu))


@torch.no_grad()
def sharded_update_(tx: optim.Optimizer, grads: List[torch.Tensor],
                    opt_state: optim.AdamWState, params: List[torch.Tensor],
                    norm: torch.Tensor, mesh,
                    dims: List[Optional[UpdateDim]]) -> Tuple[optim.AdamWState, torch.Tensor]:
    """AdamW on each leaf's update slice (`opt_state` holds the slices'
    moments), then the parameters all-gathered back to their shards. `norm`
    is the global norm of the whole reduced gradients. The list `grads` is
    emptied once its slices are taken, so the whole gradients can be freed
    before the update's temporaries are made."""
    g = update_layout(grads, mesh, dims)
    grads.clear()
    p = update_layout(params, mesh, dims)
    opt_state, norm = tx.update_(g, opt_state, p, norm)
    for leaf, piece, d in zip(params, p, dims):
        if d is None:
            continue  # updated in place
        for a in reversed(d.axes):  # the minor axis first: pieces join in spec order
            piece = all_gather(piece, mesh, a, dim=d.dim)
        leaf.copy_(piece)
    return opt_state, norm


# ----------------------------------------------------------------- the step

class _Reducer:
    """One backward's bucketed reduction over the sync axis: each leaf's
    hook hands its gradient in; a bucket whose leaves are all in is launched
    at once, asynchronously; ``finish`` waits and unpacks."""

    def __init__(self, step: "GradSyncStep", count: int, device: torch.device):
        self.step, self.count, self.device = step, count, device
        self.pending: List[Optional[torch.Tensor]] = [None] * len(step.names)
        self.left = [len(b) for b in step.buckets]
        self.works: List[tuple] = []
        self.events: List[Tuple[str, int, float]] = []
        self.scales: Dict[int, torch.Tensor] = {}

    def hook(self, i: int) -> Callable[[torch.Tensor], None]:
        def ready(grad: torch.Tensor) -> None:
            self.ready(i, grad)
        return ready

    def ready(self, i: int, grad: torch.Tensor) -> None:
        s = self.step
        self.events.append(("grad", i, time.perf_counter()))
        g = grad.detach()
        for axis in s.inner[i]:  # a batch axis inside the replica that does not cut it
            g = g.contiguous().clone()
            all_reduce(g, s.mesh, axis)
        self.pending[i] = g
        b = s.bucket_of[i]
        self.left[b] -= 1
        if not self.left[b]:
            self.launch(b)

    def launch(self, b: int) -> None:
        s = self.step
        axis, mesh = s.sync.axis, s.mesh
        idxs = s.buckets[b]
        plain = [i for i in idxs if not s.quant[i]]
        quant = [i for i in idxs if s.quant[i]]
        if plain:
            flat = torch.cat([self.pending[i].reshape(-1) for i in plain])
            work = None
            if axis_size(mesh, axis) > 1:
                work = dist.all_reduce(flat, group=mesh.get_group(axis), async_op=True)
            self.works.append(("f32", plain, flat, [work]))
        if quant:
            rank = dist.get_rank()
            qs, ss = [], []
            for i in quant:
                gen = (rounding_generator(self.count, i, rank, self.device)
                       if s.sync.stochastic_rounding else None)
                q, sc = quantize_blockwise(self.pending[i], s.sync.quant_block_elems, gen)
                qs.append(q.reshape(-1))
                ss.append(sc.reshape(-1))
            q_all, q_work = _gather(torch.cat(qs), mesh, axis, async_op=True)
            s_all, s_work = _gather(torch.cat(ss), mesh, axis, async_op=True)
            self.works.append(("int8", quant, (q_all, s_all), [q_work, s_work]))
        for i in idxs:
            self.pending[i] = None
        self.events.append(("reduce", b, time.perf_counter()))

    def finish(self, shapes: List[torch.Size]) -> List[torch.Tensor]:
        if any(self.left):
            raise RuntimeError(f"the backward left buckets unlaunched: {self.left}")
        out: List[Optional[torch.Tensor]] = [None] * len(shapes)
        w = axis_size(self.step.mesh, self.step.sync.axis)
        block = self.step.sync.quant_block_elems
        for kind, idxs, payload, works in self.works:
            for work in works:
                if work is not None:
                    work.wait()
            if kind == "f32":  # JAX's pmean: the sum over the axis / its size
                pieces = payload.div_(w).split([math.prod(shapes[i]) for i in idxs])
                for i, piece in zip(idxs, pieces):
                    out[i] = piece.view(shapes[i])
                continue
            q_all, s_all = payload
            q_at = s_at = 0
            for i in idxs:
                n = math.prod(shapes[i])
                nb = max(1, -(-n // block))
                qs = [q[q_at:q_at + nb * block].view(nb, block) for q in q_all]
                ss = [sc[s_at:s_at + nb].view(nb, 1) for sc in s_all]
                out[i] = _dequant_mean(qs, ss, n).view(shapes[i])
                self.scales[i] = torch.stack(ss)
                q_at, s_at = q_at + nb * block, s_at + nb
        return out


class GradSyncStep:
    """``step(state, batch) -> (state, metrics)`` with the grad sync of
    `sync` (see the module docstring); ``make_train_step`` builds it for
    every config, the default one included.

    ``buckets`` (the explicit sync's leaf indices per bucket, else None),
    ``names`` (the leaves' names), ``launches`` (the last backward's record:
    ("grad", leaf, t) when a leaf's gradient was ready and ("reduce",
    bucket, t) when its bucket was launched, t from time.perf_counter) and
    ``scales`` (the last int8 reduction's gathered block scales by leaf,
    [W, nblocks, 1]) are there to be read."""

    def __init__(self, cfg: ModelConfig, tx: optim.Optimizer, loss_fn: Optional[Callable],
                 sync: GradSyncConfig, donate: bool = True, *, device=None, mesh=None,
                 rules: AxisRules = TRAIN_RULES):
        self.cfg, self.tx, self.sync, self.donate = cfg, tx, sync, donate
        self.loss_fn = loss_fn or llama.loss_fn
        self.dev = resolve_device(device)
        self.mesh, self.rules = mesh, rules
        self.explicit = sync.mode == "bucketed" and mesh is not None
        if self.explicit:
            check_model_compat(cfg)
        self.names = leaf_names(cfg)
        self.cuts = [cut_axes(a, mesh, rules) for a in llama.tree_leaves(llama.param_axes(cfg))]
        sums = [a for a in llama.batch_axes(rules) if axis_size(mesh, a) > 1]
        # the batch axes each leaf's gradient is summed over where no mesh axis cuts it:
        # all of them after the backward (plain), or those inside a dp replica (explicit)
        self.inner = [[a for a in sums if a not in cut and not (self.explicit and a == sync.axis)]
                      for cut in self.cuts]
        glob = global_leaves(cfg)
        self.quant = [sync.compression == "int8" and _numel(x) >= sync.min_quant_elems
                      for x in glob]
        self.buckets = partition_buckets(glob, sync.bucket_bytes) if self.explicit else None
        self.bucket_of = {i: b for b, idxs in enumerate(self.buckets or []) for i in idxs}
        self.dims = (update_dims(cfg, mesh, rules, sync.update_axes)
                     if sync.sharded_update and mesh is not None else None)
        self.launches: List[Tuple[str, int, float]] = []
        self.scales: Dict[int, torch.Tensor] = {}

    def _kw(self, manual: Tuple[str, ...] = ()) -> Dict[str, Any]:
        if self.mesh is None:
            return {}
        kw = dict(mesh=self.mesh, rules=self.rules)
        if manual:
            kw["manual"] = manual
        return kw

    def grads(self, params: llama.Params, count: int, batch: Dict[str, torch.Tensor]
              ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
        """(metrics, the reduced gradients of this rank's shards): JAX's
        grads stage. `count` is the update count (it seeds stochastic
        rounding)."""
        leaves = llama.tree_leaves(params)
        if not self.explicit:
            with torch.enable_grad():
                for p in leaves:
                    p.requires_grad_(True)
                loss, aux = self.loss_fn(params, batch, self.cfg, **self._kw())
                grads = list(torch.autograd.grad(loss, leaves))
            for g, axes in zip(grads, self.inner):
                for axis in axes:
                    all_reduce(g, self.mesh, axis)
            return {name: val.detach() for name, val in aux.items()}, grads
        red = _Reducer(self, count, leaves[0].device)
        with torch.enable_grad():
            hooks = [p.requires_grad_(True).register_hook(red.hook(i))
                     for i, p in enumerate(leaves)]
            try:
                loss, aux = self.loss_fn(params, batch, self.cfg, **self._kw((self.sync.axis,)))
                torch.autograd.grad(loss, leaves)  # the hooks take the gradients
            finally:
                for h in hooks:
                    h.remove()
        grads = red.finish([p.shape for p in leaves])
        self.launches, self.scales = red.events, red.scales
        return self._replica_mean(aux), grads

    def _replica_mean(self, aux: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """loss and aux averaged over the sync axis, tokens summed (JAX's
        pmean, then tokens times the axis size)."""
        names = list(aux)
        vals = torch.stack([aux[k].detach() for k in names])
        w = axis_size(self.mesh, self.sync.axis)
        vals = all_reduce(vals, self.mesh, self.sync.axis) / w
        metrics = dict(zip(names, vals.unbind()))
        if "tokens" in metrics:
            metrics["tokens"] = metrics["tokens"] * w
        return metrics

    def _moments_laid_out(self, state):
        """The optimizer state in the update's layout: moments of whole shards
        are sliced once (a state from init_state without sync=), as JAX
        re-lays them out on the first step."""
        opt = state.opt_state
        leaves = llama.tree_leaves(state.params)
        want = [tuple(update_slice(x, self.mesh, d).shape)
                for x, d in zip(leaves, self.dims or [None] * len(leaves))]
        have = [tuple(m.shape) for m in opt.mu]
        if have == want and [tuple(v.shape) for v in opt.nu] == want:
            return opt
        if self.dims and have == [tuple(p.shape) for p in leaves]:
            return optim.AdamWState(opt.count, update_layout(opt.mu, self.mesh, self.dims),
                                    update_layout(opt.nu, self.mesh, self.dims))
        raise ValueError("the optimizer state's layout does not fit this step: init_state(sync=) "
                         "and make_train_step(sync=) must agree on sharded_update")

    def __call__(self, state, batch: Dict[str, torch.Tensor]):
        from .step import TrainState, _copy

        if any(p.device.type != self.dev.type for p in llama.tree_leaves(state.params)):
            raise ValueError(f"train state is not on the step's device {self.dev}")
        if not self.donate:
            state = _copy(state)
        metrics, grads = self.grads(state.params, state.step, batch)
        leaves = llama.tree_leaves(state.params)
        norm = None if self.mesh is None else optim.global_norm(grads, self.mesh, self.cuts)
        opt_state = self._moments_laid_out(state)
        if self.dims is None:
            opt_state, metrics["grad_norm"] = self.tx.update_(grads, opt_state, leaves, norm)
        else:
            opt_state, metrics["grad_norm"] = sharded_update_(
                self.tx, grads, opt_state, leaves, norm, self.mesh, self.dims)
        return TrainState(state.step + 1, state.params, opt_state), metrics


# ------------------------------------------------------- the launch record

def overlap_report(record: Union[GradSyncStep, Sequence[Tuple[str, int, float]]]
                   ) -> Dict[str, Any]:
    """Where a bucketed step launched its reductions, from its launch record
    (a GradSyncStep's last backward, or the record itself): JAX's
    overlap_report keys, positions counted in the record's events ("grad":
    a leaf's gradient ready, "reduce": a bucket launched) where JAX counts
    HLO instructions. `all_sunk_to_end` is True when every reduction was
    launched after the backward's last gradient; `launch_s` gives each
    launch's time relative to that last gradient (negative: before it)."""
    events = list(record.launches if isinstance(record, GradSyncStep) else record)
    red = [i for i, e in enumerate(events) if e[0] == "reduce"]
    grads = [i for i, e in enumerate(events) if e[0] == "grad"]
    t_last = events[grads[-1]][2] if grads else None
    return {
        "n_instructions": len(events),
        "n_reductions": len(red),
        "first_reduction_pos": red[0] if red else None,
        "last_reduction_pos": red[-1] if red else None,
        "last_compute_pos": grads[-1] if grads else None,
        "n_compute_after_first_reduction":
            sum(1 for i in grads if i > red[0]) if red else 0,
        "all_sunk_to_end": bool(red) and bool(grads) and red[0] > grads[-1],
        "launch_s": [events[i][2] - t_last for i in red] if grads else [],
    }
