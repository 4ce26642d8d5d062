"""The hop between pipeline stages (serving's counterpart of the JAX
package's ``ppermute`` / ``psum`` over "pp" in ray_tpu/llm/model_runner.py).

A stage is a rank's coordinate on the mesh's "pp" axis; the ranks of one
(dp, tp) coordinate form this rank's "pp" group, and stage s hands its
activations to stage s + 1 of that group. ``send_to_next`` and
``recv_from_prev`` carry one microbatch's ``[smb, W, D]`` activations (or a
prefill's ``[1, S, D]``) one hop forward; ``from_last_stage`` gives every
stage the last stage's outputs, one broadcast over "pp", as JAX's psum of the
last stage's outputs does (ray_tpu/llm/model_runner.py:610-613).

Where every rank has a card of its own the group is NCCL and CUDA tensors go
point to point. Where ranks share a card (or run on the CPU) it is gloo, and
gloo's point-to-point calls take host tensors: a CUDA tensor is staged
through host memory here, copied to the host before the send and to the
card after the receive. The choice follows from the group's backend alone
(parallel.mesh.mesh_backend); nothing is switched after a failure. The
broadcast takes the tensor where it lies on either backend.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import axis_index, axis_size


def _peer(mesh, stage: int) -> int:
    """The global rank of `stage` in this rank's "pp" group."""
    return dist.get_global_rank(mesh.get_group("pp"), stage)


def _staged(device: torch.device, mesh) -> bool:
    """Whether a point-to-point call on a tensor on `device` goes through
    host memory: a CUDA tensor over a gloo group."""
    return device.type == "cuda" and dist.get_backend(mesh.get_group("pp")) == "gloo"


def send_to_next(x: torch.Tensor, mesh) -> None:
    """Send x to the next stage of this rank's "pp" group (this stage must
    not be the last)."""
    stage = axis_index(mesh, "pp")
    if stage + 1 >= axis_size(mesh, "pp"):
        raise ValueError(f"stage {stage} is the last: it has no next stage")
    x = x.contiguous()
    if _staged(x.device, mesh):
        x = x.cpu()
    dist.send(x, _peer(mesh, stage + 1), group=mesh.get_group("pp"))


def recv_from_prev(shape, dtype: torch.dtype, device, mesh) -> torch.Tensor:
    """Receive the previous stage's activations of `shape` and `dtype` onto
    `device` (this stage must not be the first)."""
    stage = axis_index(mesh, "pp")
    if stage == 0:
        raise ValueError("stage 0 has no previous stage")
    device = torch.device(device)
    staged = _staged(device, mesh)
    buf = torch.empty(shape, dtype=dtype, device="cpu" if staged else device)
    dist.recv(buf, _peer(mesh, stage - 1), group=mesh.get_group("pp"))
    return buf.to(device) if staged else buf


def from_last_stage(x: torch.Tensor, mesh) -> torch.Tensor:
    """The last stage's x on every stage of this rank's "pp" group, one
    broadcast. On the other stages x gives only the shape, dtype and device
    of a fresh buffer (never written: a send of it may still be reading).
    x itself without pipeline stages."""
    pp = axis_size(mesh, "pp")
    if pp == 1:
        return x
    if axis_index(mesh, "pp") == pp - 1:
        x = x.contiguous()
    else:
        x = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dist.broadcast(x, _peer(mesh, pp - 1), group=mesh.get_group("pp"))
    return x
