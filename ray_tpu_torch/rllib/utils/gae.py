"""Advantage estimation on the device: GAE and the V-trace recursion over a
trajectory block's time axis (port of ray_tpu/rllib/utils/gae.py).

The JAX package runs each recursion as a ``lax.scan`` (no Pallas kernel); here
each is a reverse loop over T of [B]-wide tensor ops, the same op sequence
from the same zero start, on whatever device the inputs lie on. Inputs are
time-major [T, B]; numpy inputs become CPU tensors.

Parity contract (tests/test_torch_port_rllib.py): the JAX functions' results
within 1e-6 across episode boundaries, truncation bootstraps and ``lambda_``
in {0, 0.95, 1}. Episode boundaries inside a block are carried by the
``terminated``/``truncated`` row flags: the recursion resets across a done
row exactly like the host connector's per-episode restart.
"""
from __future__ import annotations

import torch


def _device(*xs):
    return next((x.device for x in xs if isinstance(x, torch.Tensor)), torch.device("cpu"))


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _reverse_scan(deltas, coefs):
    """acc_t = delta_t + coef_t * acc_{t+1}, from acc_T = 0; returns [T, B]."""
    acc = torch.zeros_like(deltas[0])
    out = [None] * len(deltas)
    for t in range(len(deltas) - 1, -1, -1):
        acc = deltas[t] + coefs[t] * acc
        out[t] = acc
    return torch.stack(out)


def gae_scan(rewards, values, boot_values, terminated, truncated, *,
             gamma: float, lambda_: float):
    """GAE(lambda) over a time-major trajectory block.

    All inputs are [T, B] (f32; the flags may be bool/uint8):

    - ``rewards[t, b]``     reward of step t in column b
    - ``values[t, b]``      behaviour-policy V(obs_t)
    - ``boot_values[t, b]`` behaviour-policy V(obs_{t+1}) — the NEXT
      observation's value, which at an episode's last row is the value of the
      true final observation (gymnasium 1.x next-step autoreset returns it)
    - ``terminated[t, b]``  env terminated at step t (bootstrap masked to 0)
    - ``truncated[t, b]``   env truncated at step t (bootstraps from
      boot_values, but the accumulation chain still resets)

    Returns ``(advantages, value_targets)``, both [T, B] f32. Rows marked
    invalid by the caller (autoreset rows) come out as garbage and must be
    masked in the loss — the chain is already broken at the preceding done
    row, so they never contaminate a real row.
    """
    dev = _device(rewards, values, boot_values, terminated, truncated)
    rewards = _f32(rewards, dev)
    values = _f32(values, dev)
    boot = _f32(boot_values, dev)
    term = _f32(terminated, dev)
    done = torch.maximum(term, _f32(truncated, dev))

    deltas = rewards + gamma * (1.0 - term) * boot - values
    cont = (1.0 - done) * gamma * lambda_
    adv = _reverse_scan(deltas, cont)
    return adv, adv + values


def vtrace_scan(deltas, discounts, cs):
    """The V-trace reverse-time recursion (Espeholt et al. 2018, eq. 1):

        acc_t = delta_t + discount_t * c_t * acc_{t+1}

    over time-major [T, B] tensors; returns ``vs - V`` as [T, B].
    """
    return _reverse_scan(deltas, discounts * cs)


def vtrace_block(rewards, values, boot_values, terminated, truncated, rhos,
                 *, gamma: float, lambda_: float = 1.0,
                 clip_rho_threshold: float = 1.0,
                 clip_pg_rho_threshold: float = 1.0):
    """V-trace targets + policy-gradient advantages for a [T, B] block.

    ``values``/``boot_values`` are the CURRENT policy's value estimates of
    obs_t / obs_{t+1}, and ``rhos`` the per-step importance ratios
    pi_cur/pi_behaviour. Episode boundaries (done rows) cut the recursion;
    the row after a boundary starts a fresh chain. At a block's last row (and
    at done rows) the next-state target falls back to the bootstrap value.

    Returns ``(pg_advantages, value_targets)``, both [T, B] f32, both
    detached (the JAX package's stop_gradient).
    """
    dev = _device(rewards, values, boot_values, terminated, truncated, rhos)
    rewards = _f32(rewards, dev)
    values = _f32(values, dev)
    rhos = _f32(rhos, dev)
    term = _f32(terminated, dev)
    done = torch.maximum(term, _f32(truncated, dev))
    v_next = _f32(boot_values, dev) * (1.0 - term)

    clipped_rho = torch.clamp(rhos, max=clip_rho_threshold)
    cs = lambda_ * torch.clamp(rhos, max=1.0)
    discounts = gamma * (1.0 - done)
    # v_next carries the truncation bootstrap and zeroes out at termination,
    # so this is delta_t = rho_clip * (r + gamma*V(s_{t+1}) - V(s_t)) with
    # the recursion itself cut at done rows by `discounts`.
    deltas = clipped_rho * (rewards + gamma * v_next - values)
    vs = values + vtrace_scan(deltas, discounts, cs)
    # next-step target for the pg advantage: vs_{t+1} within a chain, the
    # bootstrap value across a boundary / at the block tail
    vs_next = torch.cat([vs[1:], v_next[-1:]], dim=0)
    vs_next = torch.where(done > 0, v_next, vs_next)
    clipped_pg_rho = torch.clamp(rhos, max=clip_pg_rho_threshold)
    pg_adv = clipped_pg_rho * (rewards + gamma * vs_next - values)
    return pg_adv.detach(), vs.detach()
