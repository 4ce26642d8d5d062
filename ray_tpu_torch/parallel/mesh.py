"""Device-mesh construction (port of ray_tpu/parallel/mesh.py).

A ``MeshSpec`` is the one declarative knob for every parallelism strategy:
data (dp), fully-sharded data (fsdp), tensor (tp), sequence (sp), pipeline
(pp) and expert (ep). ``build_mesh`` turns it into a
``torch.distributed.device_mesh.DeviceMesh`` over one process per device,
every axis kept even at size 1 (as the JAX mesh keeps them), so code can name
any axis unconditionally.

Where JAX puts every device of a host in one process, here each rank is a
process: ``build_mesh`` runs on every rank with the same device list, and
rank r computes on ``devices[r]``. The process group's backend follows from
those devices: NCCL when every rank has a CUDA device of its own, gloo for
CPU ranks or for ranks the caller put on one shared card (NCCL refuses two
ranks on one device; gloo stages CUDA tensors through the host). The choice
is logged and never switched after a failure. The JAX module's ``use_mesh``
and its JAX-version shims have no counterpart.
"""
from __future__ import annotations

import dataclasses
import datetime
import logging
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.device import resolve_device

LOGGER = logging.getLogger(__name__)

# Canonical axis order: most-major -> most-minor (the JAX package's order).
AXIS_ORDER: Tuple[str, ...] = ("pp", "dp", "fsdp", "ep", "sp", "tp")

# seconds a collective (and the group's rendezvous) waits for a peer before
# it raises: a dead or wedged rank fails the call instead of hanging it
GROUP_TIMEOUT_S = 60.0


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape. Size -1 on at most one axis means "use all remaining".

    Examples:
        MeshSpec(dp=-1)                      # pure data parallel
        MeshSpec(tp=2)                       # 2-way tensor parallel
        MeshSpec(dp=2, sp=2, tp=2)           # 8 ranks mixed
    """

    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def sizes(self) -> Tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXIS_ORDER)

    def resolve(self, n_devices: int) -> "MeshSpec":
        """Fill in a single -1 axis so the product equals n_devices."""
        sizes = list(self.sizes())
        wild = [i for i, s in enumerate(sizes) if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {self}")
        fixed = math.prod(s for s in sizes if s != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh {self} needs {fixed} devices, have {n_devices}")
        return MeshSpec(**dict(zip(AXIS_ORDER, sizes)))

    @property
    def n_devices(self) -> int:
        return math.prod(self.sizes())


def _one_device(d) -> torch.device:
    """A rank's device, CUDA with an explicit index ("cuda" is card 0)."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def mesh_backend(devices: Sequence[torch.device]) -> str:
    """"nccl" when every rank has a CUDA device of its own; "gloo" for CPU
    ranks or for ranks that share a card."""
    types = {d.type for d in devices}
    if types == {"cpu"}:
        return "gloo"
    if types != {"cuda"}:
        raise ValueError(f"a mesh's ranks are all CPU or all CUDA, got {list(devices)}")
    return "nccl" if len({d.index for d in devices}) == len(devices) else "gloo"


def build_mesh(spec: MeshSpec, devices: Optional[Sequence] = None, *,
               rank: Optional[int] = None, init_method: Optional[str] = None):
    """A DeviceMesh of `spec` over one rank per device, this process's rank
    on ``devices[rank]``; every axis of AXIS_ORDER is kept.

    `devices` defaults to cuda:0..n-1 (raising without CUDA); a ValueError
    says when the card a rank names is not there. When no process group
    exists yet this starts one, with `rank` and `init_method` (e.g.
    "tcp://localhost:PORT"), a world of spec.n_devices ranks and a timeout of
    GROUP_TIMEOUT_S on every collective; an existing group must have that
    world size and the backend the devices call for."""
    if devices is None:
        resolve_device(None)  # CUDA unless the caller names the CPU
        n = torch.cuda.device_count() if -1 in spec.sizes() else spec.n_devices
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_one_device(d) for d in devices]
    cards = torch.cuda.device_count() if devices[0].type == "cuda" else 0
    if devices[0].type == "cuda" and max(d.index for d in devices) >= cards:
        raise ValueError(f"need {len(devices)} devices ({[str(d) for d in devices]}), "
                         f"have {cards} CUDA devices")
    spec = spec.resolve(len(devices))
    n = spec.n_devices
    backend = mesh_backend(devices)
    if dist.is_initialized():
        have = (dist.get_world_size(), dist.get_backend())
        if have != (n, backend):
            raise ValueError(f"the process group has (world, backend) {have}; the mesh "
                             f"needs ({n}, {backend!r})")
        rank = dist.get_rank()
    elif rank is None or init_method is None:
        raise ValueError("no process group yet: pass rank= and init_method=")
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # before the group: NCCL binds to it
    if not dist.is_initialized():
        LOGGER.info("mesh %s: rank %d of %d on %s, backend %s", spec.sizes(), rank, n, dev,
                    backend)
        dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(dev.type, torch.arange(n).reshape(spec.sizes()),
                      mesh_dim_names=AXIS_ORDER)


def axis_size(mesh, axis: str) -> int:
    """Ranks along a mesh axis (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along a mesh axis (0 without a mesh)."""
    if mesh is None:
        return 0
    return mesh.get_local_rank(axis)
