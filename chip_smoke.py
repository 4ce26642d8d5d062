#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no result):
  1. the card's name and power limit, the torch and CUDA versions; build every
     kernel library from ops/csrc with nvcc (sm_90a), one nvcc per source, all
     started together, and print the build time, each kernel's registers and
     spills (ptxas) and its counts of HGMMA, UTMALDG, UTMASTG and HMMA
     instructions (cuobjdump -sass);
  2. the SASS of every bf16 kernel (B1a, B1b, B1c at D = 64 and 128) must
     hold HGMMA and UTMALDG and no HMMA (wgmma fed by TMA, no mma.sync), and
     ptxas must report no spills for it; every kernel against its plain
     PyTorch version on the card, at the shapes the main paths give it, the
     edges of the 128-row tiles (S = 127, 129, 2047, Sq != Skv) and a tiny
     ragged one, in bf16 and f32, with the stated tolerance: B1a (forward) at
     the prefill and training shapes and at one tp 2 rank's heads (H16/4 at
     S = 16, 129, 1024), B1b and B1c (backward) at the training
     shape (B6 S2048 H32/8 D128 causal), a segment-id shape, the same tile
     edges, a tiny one and one training-mesh rank's heads (B2 S1024 H16/4,
     phase F's shape); each kernel's time (CUDA events, and
     device time per launch from torch.profiler) beside its plain version's,
     its bound and one library call's (a yardstick only: the port never calls
     it): B1a at every prefill bucket and at the training shape, B1b and B1c at
     the training shape;
  3. the serving path: LLMServer(LLMConfig(model_source="llama3-8b")) with
     seeded random weights in bf16, serving concurrent chat and completion
     requests (greedy and sampled, streamed and not, prompts in six prefill
     buckets), then solo greedy requests in three TTFT buckets, each repeated
     SOLO_REPEATS times; the kernel launch counts are zeroed just before and
     read just after, and the flash launches must equal n_layers x prefills;
     then torch.profiler over one prefill and one decode step of the served
     model (wall time, device busy share, top kernels);
  4. the served model's output checked against the plain path at full width
     (two layers of llama3-8b in f32): prefill logits through the flash kernel
     vs plain attention, and a decode step vs the full forward;
  T. tensor parallelism (A6a) on the same card, after 4: llama3-8b at
     tensor_parallel_size=2 as two ranks sharing cuda:0 over gloo (NCCL
     refuses two ranks on one device), and over NCCL on cuda:0,1 too where
     the machine has two cards (the line says which ran). Phase 3's three
     solo prompts (their tails that leave room for 8 tokens), each in a
     slot of its own, on tp 1 (phase 3's weights: prefill, then 16 greedy
     decode steps of the three slots) and on two spawned ranks, each holding
     its shard of the same seeded init (llama.init with the mesh),
     prefilling (B1a 32 times per rank per prefill, at 16 q and 4 kv heads)
     and decoding fed tp 1's ids: prefill and decode logits within 2e-2 of
     max|ref| of tp 1's, rank 0's and rank 1's logits bit-equal; each rank's
     start peak, decode step ms and the 1001-token prefill's ms, each with
     its collectives' ms. Then
     LLMServer(LLMConfig(model_source="llama3-8b", tensor_parallel_size=2),
     devices=["cuda:0", "cuda:0"]) in the slot layout (three concurrent
     requests, then the three solo prompts: TTFT per bucket, decode
     tokens/s), paged (bench_serve's settings, prefix cache off; the three
     concurrent requests) and int8 (the three, then the shortest solo
     prompt), 8 tokens each, each finishing with "length", rank 0's B1a
     count zeroed just before and read just after (n_layers per prefill),
     and the served greedy ids equal to tp 1's (int8: tp 1 on the same
     weights quantized) up to tp 1's first near tie (a top-2 gap under 2e-2
     of max|logits|), and where they part tp 2's token within 4e-2 of
     max|logits| of tp 1's top. Every number of T is two ranks on one
     card, not a TP speed;
 DP. data parallelism (A2f, dp half) on the same card, after T: dp 1's
     greedy ids on phase 3's weights (four of phase 3's prompts, 121 to 501
     tokens, each in a slot of its own, 16 decode steps), then
     TorchLLMEngine(LLMConfig(model_source="llama3-8b",
     data_parallel_size=2, max_num_seqs=8, max_model_len=1024)) as two
     replicas of the whole model sharing cuda:0 over gloo (and over NCCL on
     cuda:0,1 too where there are two cards), in the slot layout, paged
     (bench_serve's blocks and buckets, prefix cache on, fused bursts at the
     default width) and paged with n-gram speculation (k = 4): the four
     prompts at once, then a repeat of the first alone, 16 tokens each,
     every rank's counts zeroed just before and read just after. Gates:
     every request ends with "length" after its 16 tokens; the served ids
     equal dp 1's up to its first near tie (as T's gate); each rank
     launched B1a n_layers times per whole prefill it computed (one at
     least) and decoded with an active slot; the repeat ran on one replica
     only (slot: B1a n_layers times on its rank, 0 on the other's; paged: a
     prefix hit in that replica's cache, no launch). Recorded: engine start
     s, TTFT per prompt, decode tokens/s of the requests, of all replicas
     and of each rank, peak GiB per rank, the phase's wall time; two
     replicas on one card, not a DP speed;
 PP. pipeline parallelism (A2g) on the same card, after DP, against the same
     one-rank run (pp 1 = dp 1): TorchLLMEngine(LLMConfig(model_source=
     "llama3-8b", pipeline_parallel_size=2, max_num_seqs=8,
     max_model_len=1024)) as two stages sharing cuda:0 over gloo, each
     holding its 16 layers and their KV (and over NCCL on cuda:0,1 too
     where there are two cards), in the slot layout, paged (bench_serve's
     blocks and buckets, prefix cache on) and paged with n-gram speculation
     (k = 4), then paged at pp 2 x dp 2 on four ranks: DP's requests and
     gates, with B1a n_layers / 2 = 16 times per whole prefill on each stage
     rank of the owning replica and 0 elsewhere, the repeat computed on
     every stage of one replica (paged: a prefix hit there on both stages),
     the slot and paged engines' teacher-forced logits within 2e-2 of pp
     1's, and each stage rank's weight bytes equal to its reckoned share (16
     of 32 layers plus the embedding, final norm and head). Recorded as DP's;
     ranks sharing one card over gloo, not a pp speed;
  5. paged serving: llama3-8b on the same weights with kv_layout="paged" and
     bench_serve.py's engine settings (32 slots, 1024 positions, 32-token
     blocks, buckets 32..1024): decode_step_paged against decode_step on the
     same KV (8 slots, one inactive with a stale table); cold prompts of
     121, 501 and 960 tokens (B1a n_layers times per prefill); a 512-token
     prefix shared by 4 suffixes of 64 (512 hit tokens and no B1a launch per
     warm request, warm first-token logits against a cold whole prefill);
     chunked prefill of the 960-token prompt (logits against the whole
     prefill, no B1a launch); preemption of 4 concurrent 250-token prompts
     in a 36-block pool (all finish, >= 1 preemption, the pool all free);
     torch.profiler over one detached prefill and one 32-slot paged step;
  6. int8 weights and n-gram speculation on the same weights:
     LLMConfig(quantization="int8") quantizes them at start (weight bytes
     against bf16); three solo greedy prompts in the slot layout (TTFT and
     decode tok/s beside phase 3's bf16 medians, B1a n_layers times per
     prefill); one int8 prefill through B1a and one decode step against the
     plain path on the same dequantized weights. Then speculation at
     bench_serve's k = 4: propose_ngram_device on the card against the
     engine's host proposer on planted histories; in the slot and the paged
     layout, a verify window's logits at each position against the decode
     steps that produce the same positions; the n-gram proposer (host,
     single-window; device, fused m = 4) on three repetitive prompts P + C
     + P, C the plain engine's own greedy continuation of P (each run must
     draft; acceptance and tok/s beside the plain engine); bench_spec_modes
     at batch 1 and 8 (the paged layout at 8 only) of SPEC_GEN tokens (48;
     bench_serve's 96, cut to keep the run's time) in f32, as there (one f32 copy of the
     weights): the plain engine, fused-only m = 8, and the oracle (the
     plain engine's greedy continuation as drafts, through _propose_ngram
     and spec_multi's propose_fn seam) single-window and fused m = 4;
     every request finishes with its tokens and every prefill launches B1a
     n_layers times;
 6b. P/D disaggregation and the serving surface on the same weights, shared
     by every engine: a prefill engine (bench_serve's paged settings, no KV
     state), a paged and a slot decode engine (32 slots each) and a colocated
     paged engine; three greedy prompts (buckets 128, 512, 1024) of 32
     tokens prefilled with prefill_only and decoded with
     generate_from_prefill: ids identical to the colocated engine's in both
     layouts, the installed KV bit-equal to the transfer, B1a n_layers times
     per prefill_only and never on a decode engine; prefill_only ms, KV
     bytes shipped against the untrimmed bucket, host-to-device and
     device-to-host ms, TTFT against the colocated one, decode tok/s. Then
     OpenAIRouter and PDRouter over an in-process handle stand-in (chat,
     completions, streamed chat ending in [DONE], /models; texts equal the
     engine's), check_health, metrics() with every key of the JAX engine's,
     and build_llm_processor over 8 prompts against generate_sync;
  7. the training path: make_train_step(llama8b-geom2, make_optimizer(
     warmup_steps=2, total_steps=1000)) in bf16 with f32 parameters, with
     remat dots (bench.py's policy) and then full, on one seeded batch of
     6 x 2049 tokens: for each, one warm-up step, then TRAIN_STEPS timed
     steps with the launch counts zeroed just before and read just after
     (B1a must launch 2 x n_layers times a step under either policy, B1b and
     B1c n_layers times each); finite losses and grad norms, the last loss
     below the first timed one; step time, tokens/s, MFU against the bf16
     peak, peak memory; torch.profiler over one step;
  8. the training numerics at full width: llama8b-geom2 in f32 at B1 S256,
     loss_fn's value and every parameter's gradient through the kernels,
     with remat full and dots, against attention_impl="reference";
  F. after 8, training on a device mesh (A6): llama8b-geom2 at full width
     (bf16 activations, f32 parameters, remat dots) on MeshSpec(fsdp=2,
     tp=2), four spawned ranks sharing cuda:0 over gloo (each wait bounded,
     every rank killed on a failure), each holding its TRAIN_RULES shards
     of the seeded init (init_state(mesh=)) and calling make_train_step(
     mesh=) on the same seeded global batch of 4 x 1025 tokens: one
     warm-up step and MESH_STEPS steps with the launch counts zeroed just
     before and read just after. First, in this process, the one-rank step
     on the same init and batch (its numbers kept on the host, the card
     freed before the ranks start). Gates: loss and grad_norm of every step
     within MESH_LOSS_TOL / MESH_NORM_TOL of the one-rank step's, every
     rank's the same bits; each rank's parameters after the steps within
     MESH_PARAM_SLACK x the steps' learning rates of the slice of the
     one-rank parameters; B1a 2 x n_layers, B1b and B1c n_layers launches
     per rank per step, all at 16 q / 4 kv heads. Recorded: step ms per
     rank, one more step with every collective bracketed by syncs (their
     ms and count), the peak GiB per rank. Four ranks on one card through
     the host, not a mesh speed;
  9. MoE serving: mixtral-8x7b at full width and depth (32 layers, 8
     experts, top-2) with LLMConfig(quantization="int8"), which starts it
     in int8 one layer at a time (its bf16 weights do not fit the card):
     start seconds, weight bytes against bf16 and the peak (< 60 GiB); router
     ties on the card pick the lower expert first (a uniform row takes
     experts 0 and 1), as jax.lax.top_k does; the no-drop check (capacity factor 4.0: a 64-token prefill and 8 greedy
     decode steps against llama.forward over the sequence, slot and paged,
     within 2e-2 of max|ref| with f32 activations; bf16 reported); 3 solo
     greedy requests (buckets 128 / 512 / 1024) and 4 concurrent ones;
     torch.profiler over one 8-slot decode step and one 512-token prefill,
     and one layer's MoE MLP by part (dequant, expert GEMMs, dispatch
     einsums, the rest); an n-gram speculative request (k = 4) on P + C +
     P; then paged with bench_serve's settings on the same weights (a cold
     prompt, a cold and a warm one sharing a 512-token prefix, a chunked
     one). Every request finishes with its tokens; B1a launches n_layers
     times per whole prefill and never for a suffix or a chunk;
  A. after 6b, on the same weights: llama3-8b written as HF's release lays it
     out (bf16 tensors in 4 shards model-0000N-of-00004.safetensors, an index
     and config.json, ~16 GB) under a temporary directory (under build/ when
     the temp directory lacks twice the room), loaded back with
     load_llama_params (bit-equal), and served from the directory by
     LLMServer(LLMConfig(model_source=dir)): the engine's weights bit-equal,
     phase 3's three solo greedy prompts give phase 3's ids, B1a n_layers
     times per prefill; write, load and start seconds, GB/s, the start's
     peak. The directory is removed;
  B. after 9, MoE training (A3c): mixtral-8x7b's geometry at 2 layers (d 4096,
     8 experts of d_ff 14336, top-2, 3.16B parameters) in f32 at B1 S256,
     its gradients through B1a/B1b/B1c against the plain path (remat full
     and dots, 1e-3 of max|ref| per leaf); then trained with
     make_train_step at B6 S2048, remat dots (the batch is cut, never a
     width, if it does not fit): step ms, tokens/s, MFU on active
     parameters, peak, the loss falling, launch counts, and one step by
     kind with the dispatch / combine einsums' and the expert GEMMs' shares;
     then save_llama_params (f32, ~12.7 GB), load_llama_params in f32 and
     init_state(checkpoint_dir=...) bit-equal to the trained parameters, a
     warm-started step's loss equal to one from the trained parameters with
     a fresh optimizer state, and LLMServer(LLMConfig(model_source=dir,
     quantization="int8")): int8 leaves and scales bit-equal to
     quantize_llama_params of the bf16 load, the start's peak below int8 +
     one bf16 layer slice + 1 GiB, three greedy requests and a chat served.
     Each of A and B prints its wall time and the GiB held when it starts;
  R. after B, RLlib PPO (A9), whose device work is plain torch (no Pallas
     kernel lies on it, and no flash kernel may launch): R1, PPOLearner at
     bench_rllib's _tpu_learner_body geometry (obs 64, Discrete(6), fcnet
     [256, 256], batch 4096, minibatch 1024, 1 epoch), one update on the card
     against the port's own CPU run of it (f32, TF32 off; each step's
     gradients and the state after the update, the CPU's optimizer fed the
     card's gradients, each within 1e-4 of max|ref| per leaf: see
     update_against_cpu), then ms per minibatch update and updates/s over 20 updates
     and the busy share of one update (torch.profiler); R2, PPO on
     bench_rllib's Atari-shaped env (84x84x4 uint8, Discrete(6), its own
     space objects: the card's machine has no gymnasium) with bench_ppo's
     settings, the learner on the card and the runners on the host, 1
     warm-up and 12 timed iterations: env steps/s, learner updates/s, the
     learner's share of an iteration; the policy must learn (the last 3
     iterations' mean episode_return_mean above the first one reported, the
     share of action 1 in the last train batch above twice the first's and
     1/3, P(action 1 | the bank's first frame) above 1/6); R3, gae_scan and
     vtrace_block at [64, 1024] on the card against their CPU runs (1e-5 of
     max|ref|) and their time;
  O. after R, RLlib's off-policy and offline algorithms (A9e, A9f), plain
     torch too (no flash kernel may launch): O1, each learner at bench_rllib's
     learner widths (obs 64, fcnet [256, 256]) with its algorithm's default
     batch: DQN (Discrete(6), batch 64, with and without prioritized
     weights), SAC (Box(6) in [-1, 1], batch 256), CQL (SAC's geometry, 4
     actions, min_q_weight 5.0, a BC and a SAC update), MARWIL (Discrete(6),
     batch 512): one update on the card against the same update on the CPU,
     fed the same batch and noise (as R1: gradients and the state after it
     within 1e-4 of max|ref| per leaf, target and moment),
     then ms per update and updates/s over 20 updates and the busy share of
     one (torch.profiler); O2, DQN on chip_smoke's numpy CartPole-v1 with
     tests/test_dqn.py's config uncut (20 iterations), which must learn by
     that test's bars, then 3 iterations with prioritized replay; O3, SAC on
     the numpy Pendulum-v1 with tests/test_sac.py's config uncut (13
     iterations; alpha < 1, evaluate(800) > -800); env steps/s, learner
     updates/s and the learner's share for both; O4, BC on 40 episodes of
     the heuristic CartPole expert through dataset= (mean_logp > -0.35, the
     pole held > 100 steps), MARWIL from a newline-JSON file it writes, CQL
     on 8 x 50 random Pendulum transitions with a checkpoint round trip that
     must be bit-equal;
  M. after O, RLlib's multi-agent PPO (A9g), no flash kernel: M1, a
     MultiAgentLearner with modules p0 and p1, each at R1's geometry, held
     per module to its CPU run as R1 is, then ms per two-module update and
     the busy share of one; M2, tests/test_multi_agent.py:45-63 uncut (2
     CartPole agents through make_multi_agent, a shared policy, 2 runners,
     batch 1024, 6 epochs, 8 iterations), which must learn by that test's
     bar, agent steps/s and the learner's share; M3, :67-88 uncut
     (policies p0 and p1): per-module metric keys, a checkpoint round trip
     bit-equal, p0 and p1 apart;
  D. after M, RLlib's DreamerV3 (A9h), no flash kernel: D1, the learner at
     the JAX package's defaults (deter 128, stoch 8 x 8, 16 x 16, horizon
     15) on the card against the CPU, fed the same Gumbel noise with the
     CPU held to the card's picks: the world model's, the actor's and the
     critic's gradients and the state after the update (the CPU's three
     optimizers fed the card's gradients, the EMA critic included) within
     1e-4 of max|ref| per leaf, ret_range within 1e-5; the picks that differ
     and the smallest top-two margin; ms per update over 20 and the busy
     share of one; D2, tests/test_dreamerv3.py:87-110 uncut on the numpy
     CartPole (at most 45 iterations, best return >= 30), env steps/s,
     updates/s and the learner's share, then a checkpoint loaded into a
     second algorithm, bit-equal; D3, :52-66, the world-model loss falls
     over 6 iterations;
  I. after D, RLlib's IMPALA and APPO (A9d), no flash kernel: I1,
     IMPALALearner and APPOLearner (use_kl_loss) at R1's widths on one
     padded batch (obs_ext [64, 65, 64], 16 ragged sequences, off-policy
     behaviour logp), 2 whole-batch steps held to the CPU's as R1 is (APPO's
     kl_coeff after it equal), then ms per whole-batch step over 20 updates
     and the busy share of one; I2, tests/test_impala.py:71-88 uncut on the
     numpy CartPole (25 iterations), which must learn by that test's bar,
     env steps/s and the learner's share; I3, :108-125 uncut, APPO's
     checkpoint restores its weights and kl_coeff bit for bit;
 10. a JSON line of the kernels, the card's name and power limit, and last the
     line {"ok": true, "device": {...}}.
With ``--json PATH`` a copy of every number is written to PATH as JSON.
"""
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# O tolerances are atol + rtol*|O_ref| with atol == rtol, as assert_allclose
# reads them. bf16: the kernel rounds P to bf16 for the tensor-core product and
# O at the end, the plain version only O, so the two may differ by one bf16
# ulp of O, at most 2^-7 of |O|, plus ~2^-9 of |O| from P.
BF16_TOL = 2e-2
F32_TOL = 2e-3  # the f32 bound of tests/test_flash_attention.py:21
LSE_TOL = 2e-3  # LSE is f32 in both dtypes; only the summation order differs
# Backward tolerances, on max|grad - ref| relative to max|ref| per gradient.
# bf16: the kernels round P and dS to bf16 as inputs to the tensor-core
# products and the gradients to bf16 at the store, while the plain version
# (like JAX's dK/dV products) keeps all of it in f32 from the same bf16
# inputs; each rounding is 2^-9 relative, and the sums over up to 2048 rows
# stay well inside 2e-2 of the largest gradient. f32: the same f32 math in
# another summation order.
BWD_BF16_TOL = 2e-2
BWD_F32_TOL = 2e-4
# Phase F, the mesh step against the one-rank step on the same init and
# batch, both in bf16 activations: the mesh adds bf16 roundings where a
# row-parallel product's two partial sums are added (wo, w_down) and may
# change a GEMM's accumulation order (other N); each is ~2^-9 of an
# activation, random over 4096 tokens and two layers. Relative to the
# one-rank value. Parameters: Adam moves an element by at most ~lr a step,
# so two runs that differ in the gradients' last bits differ by at most
# 2 lr a step where a gradient is near 0; a wrong slice differs by the
# weights' own size (>= 4e-3), far above 2.5 x (1.5e-4 + 3e-4).
MESH_LOSS_TOL = 1e-3
MESH_NORM_TOL = 5e-3
MESH_PARAM_SLACK = 2.5
MESH_STEPS = 2  # counted steps after one warm-up step
MESH_BATCH = (4, 1025)
TRAIN_GRAD_TOL = 1e-3  # full-width f32 gradients through 2 layers, same relative form
TRAIN_LOSS_TOL = 1e-5  # relative
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SOLO_REPEATS = 3  # solo requests per TTFT bucket
SOLO_CHARS = (120, 500, 1000)  # solo prompts of phase 3 (and A): buckets 128, 512, 1024
SOLO_GEN = 32  # greedy tokens per solo request of phases 3, 6 (int8) and A
TRAIN_SHAPE = dict(b=6, s=2048, h=32, hkv=8, d=128)  # llama8b-geom2's attention at B6 S2048
TRAIN_STEPS = 8  # timed steps after one warm-up step
# bench_serve.py's engine settings for the paged phase
PAGED = dict(kv_layout="paged", max_num_seqs=32, max_model_len=1024, kv_block_size=32,
             prefill_buckets=[32, 64, 128, 256, 512, 1024])
# bf16 logits of the paged phase, max|d| over max|ref|: the two sides differ in
# their attention path (flash for a whole prompt, the plain path for a chunk or
# a suffix) and in their bf16 roundings, through 32 layers
PAGED_TOL = 2e-2
SPEC_K = 4  # bench_serve.py's drafts per window (bench_spec_modes)
SPEC_GEN = 48  # tokens per oracle request (bench_spec_modes' gen_tokens is 96)
SPEC_BATCHES = (1, 8)  # concurrent oracle requests (bench_serve.py:1600)
NGRAM_GEN = 48  # tokens per n-gram request
NGRAM_SEEDS = (1, 2, 3)  # one n-gram request per seed, served together


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(torch, fn, name, iters=10, attempts=3):
    """Device time per launch of the kernels whose name contains `name`, from
    torch.profiler: at small shapes the event timing above measures the host's
    launch overhead instead. The profiler now and then delivers a window with
    no device events at all, so an empty window is profiled again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for evt in prof.key_averages():
            if name in evt.key:
                total += evt.self_device_time_total
                count += evt.count
        if count:
            return total / 1e3 / count
    raise SystemExit(f"profiler saw no {name} kernel in {attempts} windows")


def flash_bound(b, s, h, hkv, d, dtype_bytes, causal, peak_flops, products=2,
                q_like=2, kv_like=2, row_f32=1):
    """Least time for the function at these inputs: each input read once, each
    output written once; causal counts the S(S+1)/2 pairs the mask keeps.
    products: S-sized matrix products (B1a 2, B1b 3, B1c 4); q_like / kv_like
    / row_f32: [B,S,H,D], [B,S,Hkv,D] and [B,H,S] f32 tensors moved."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = products * 2 * b * h * d * pairs  # 2 flops per multiply-add
    nbytes = ((q_like * b * s * h * d + kv_like * b * s * hkv * d) * dtype_bytes
              + row_f32 * b * h * s * 4)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# B1a: q, k, v in, O out (q_like 2, kv_like 2), LSE out. B1b: q, k, v, O, dO
# in, dQ out (3, 2), LSE in, delta out. B1c: q, dO in, dK, dV out (2, 4),
# LSE and delta in.
BOUND_ARGS = {"flash_fwd": dict(products=2, q_like=2, kv_like=2, row_f32=1),
              "flash_bwd_dq": dict(products=3, q_like=4, kv_like=2, row_f32=2),
              "flash_bwd_dkv": dict(products=4, q_like=2, kv_like=4, row_f32=2)}


def attn_inputs(torch, gen, b, s, h, hkv, d, dtype, seg=False, skv=None):
    """Seeded q, k, v, dO (and segment ids: a boundary at S/3) on the card;
    k and v hold skv rows (default s)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    skv = s if skv is None else skv
    q, k, v, do = randn(b, s, h, d), randn(b, skv, hkv, d), randn(b, skv, hkv, d), randn(b, s, h, d)
    segs = None
    if seg:
        segs = (torch.arange(s, device="cuda") >= s // 3).to(torch.int32)
        segs = segs[None, :].expand(b, s).contiguous()
    return q, k, v, do, segs


def kernel_checks(torch, fa):
    """B1a against flash_attention_reference on the card. Returns the rows."""
    rows = []
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = []
    for s in (16, 100, 1024):  # llama3-8b head geometry; 16/1024 are prefill buckets
        for causal in (True, False):
            cases.append(dict(b=1, s=s, h=32, hkv=8, d=128, causal=causal, seg=False))
    cases.append(dict(TRAIN_SHAPE, causal=True, seg=False))
    cases.append(dict(b=2, s=256, h=32, hkv=8, d=128, causal=True, seg=True))
    cases.append(dict(b=2, s=37, h=4, hkv=2, d=64, causal=True, seg=False))  # tiny
    # the edges of the bf16 kernel's 128-row TMA tiles: one row short of a
    # tile, one past it, one short of the training shape; a q tile against
    # more and fewer kv rows than it has (full attention)
    for s in (127, 129, 2047):
        cases.append(dict(b=1, s=s, h=32, hkv=8, d=128, causal=True, seg=False))
    cases.append(dict(b=1, s=100, skv=300, h=32, hkv=8, d=128, causal=False, seg=False))
    cases.append(dict(b=2, s=257, skv=77, h=4, hkv=2, d=64, causal=False, seg=False))
    # one rank's heads of llama3-8b at tensor_parallel_size=2 (phase T): the
    # smallest and largest prefill buckets and a tile edge
    for s in (16, 129, 1024):
        cases.append(dict(b=1, s=s, h=16, hkv=4, d=128, causal=True, seg=False))
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for c in cases:
            b, s, h, hkv, d = c["b"], c["s"], c["h"], c["hkv"], c["d"]
            q, k, v, _, seg = attn_inputs(torch, gen, b, s, h, hkv, d, dtype, c["seg"],
                                          c.get("skv"))
            o, lse = fa.flash_attention_forward(q, k, v, causal=c["causal"], segment_ids=seg)
            ro, rlse = fa.flash_attention_reference(q, k, v, causal=c["causal"],
                                                    segment_ids=seg)
            torch.cuda.synchronize()
            diff = (o.float() - ro.float()).abs()
            err_o = diff.max().item()
            over_o = (diff - tol * (1.0 + ro.float().abs())).max().item()
            err_lse = (lse - rlse).abs().max().item()
            ok = over_o <= 0 and err_lse <= LSE_TOL and bool(torch.isfinite(o).all())
            row = dict(c, dtype=str(dtype).replace("torch.", ""), err_o=err_o,
                       err_lse=err_lse, tol_o=tol, tol_lse=LSE_TOL, ok=ok)
            rows.append(row)
            print(f"  flash_fwd {row['dtype']:8s} B{b} S{s}/{c.get('skv', s)} H{h}/{hkv} D{d} "
                  f"causal={c['causal']} seg={c['seg']}: max|dO| {err_o:.3e} "
                  f"(tol {tol} + {tol}|O|) max|dLSE| {err_lse:.3e} (tol {LSE_TOL}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SystemExit(f"flash_fwd disagrees with its plain version: {row}")
            del q, k, v, o, lse, ro, rlse, diff
            torch.cuda.empty_cache()
    return rows


def backward_checks(torch, fa):
    """B1b and B1c (one flash_attention_backward call) against
    flash_attention_bwd_reference on the same inputs, O and LSE from B1a."""
    rows = []
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    cases = [dict(TRAIN_SHAPE, causal=True, seg=False),
             dict(b=2, s=256, h=32, hkv=8, d=128, causal=True, seg=True),
             dict(b=1, s=100, h=32, hkv=8, d=128, causal=False, seg=False),
             dict(b=2, s=37, h=4, hkv=2, d=64, causal=True, seg=False)]  # tiny, ragged
    # the edges of the bf16 kernels' 128-row own tiles and 64-row ring tiles:
    # one row short of a block, one past it, one short of the training shape;
    # a q tile against more and fewer kv rows than it has (full attention)
    for s in (127, 129, 2047):
        cases.append(dict(b=1, s=s, h=32, hkv=8, d=128, causal=True, seg=False))
    cases.append(dict(b=1, s=100, skv=300, h=32, hkv=8, d=128, causal=False, seg=False))
    cases.append(dict(b=2, s=257, skv=77, h=4, hkv=2, d=64, causal=False, seg=False))
    # causal with Sq < Skv: kv rows past Sq see no query, so B1c's blocks there
    # loop over no q tile and must still write dK = dV = 0
    cases.append(dict(b=1, s=100, skv=300, h=4, hkv=2, d=64, causal=True, seg=False))
    # one rank's heads and rows of llama8b-geom2 on phase F's fsdp 2 x tp 2
    # mesh: the batch of 4 over fsdp, 32 / 8 heads over tp
    cases.append(dict(b=MESH_BATCH[0] // 2, s=MESH_BATCH[1] - 1, h=16, hkv=4, d=128,
                      causal=True, seg=False))
    for dtype, tol in ((torch.bfloat16, BWD_BF16_TOL), (torch.float32, BWD_F32_TOL)):
        for c in cases:
            b, s, h, hkv, d = c["b"], c["s"], c["h"], c["hkv"], c["d"]
            q, k, v, do, seg = attn_inputs(torch, gen, b, s, h, hkv, d, dtype, c["seg"],
                                           c.get("skv"))
            kw = dict(causal=c["causal"], segment_ids=seg)
            o, lse = fa.flash_attention_forward(q, k, v, **kw)
            got = fa.flash_attention_backward(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
            errs, ok = {}, True
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                ref_max = w.float().abs().max().item()
                err = (g.float() - w.float()).abs().max().item()
                errs[name] = dict(max_abs_err=err, ref_max=ref_max, rel=err / ref_max)
                ok = ok and err <= tol * ref_max and bool(torch.isfinite(g).all())
            row = dict(c, dtype=str(dtype).replace("torch.", ""), errs=errs, tol=tol, ok=ok)
            rows.append(row)
            print(f"  flash_bwd {row['dtype']:8s} B{b} S{s}/{c.get('skv', s)} H{h}/{hkv} D{d} "
                  f"causal={c['causal']} seg={c['seg']}: " + ", ".join(
                      f"{n} max|d| {e['max_abs_err']:.3e} = {e['rel']:.2e} of max|ref|"
                      for n, e in errs.items()) + f" (tol {tol}) {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise SystemExit(f"flash_bwd disagrees with its plain version: {row}")
            del q, k, v, do, o, lse, got, want
            torch.cuda.empty_cache()
    return rows


def kernel_timings(torch, fa, buckets):
    """B1a at the main path's prefill shapes (B=1, llama3-8b heads, bf16,
    causal): kernel, plain version, SDPA as the library yardstick, bound."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    out = []
    for s in buckets:
        b, h, hkv, d = 1, 32, 8, 128
        q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        ms = time_ms(lambda: fa.flash_attention_forward(q, k, v, causal=True))
        dev_ms = kernel_device_ms(torch, lambda: fa.flash_attention_forward(q, k, v, causal=True),
                                  "flash_fwd")
        plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v, causal=True))
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        o, _ = fa.flash_attention_forward(q, k, v, causal=True)
        ro, _ = fa.flash_attention_reference(q, k, v, causal=True)
        diff = (o.float() - ro.float()).abs()
        err = diff.max().item()
        if (diff - BF16_TOL * (1.0 + ro.float().abs())).max().item() > 0:
            raise SystemExit(f"flash_fwd disagrees with its plain version at S={s}: "
                             f"max|dO| {err}")
        bound_ms, bound_by = flash_bound(b, s, h, hkv, d, 2, True, PEAK_BF16_FLOPS)
        row = dict(s=s, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
        out.append(row)
        print(f"  flash_fwd bf16 causal B1 S{s} H32/8 D128: kernel {ms:.4f} ms "
              f"(device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
              f"bound {bound_ms:.5f} ms ({bound_by}), kernel/bound {ms / bound_ms:.1f}x",
              flush=True)
    return out


def sdpa_inputs(torch, q, k, v):
    """BHSD copies for scaled_dot_product_attention(enable_gqa=True)."""
    return (q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous())


def training_timings(torch, fa):
    """B1a, B1b and B1c at the training shape (bf16, causal): each kernel's
    CUDA-event ms and profiler device ms, its bound, the plain versions' ms,
    and SDPA with enable_gqa=True as the library yardstick (its backward timed
    as forward+backward minus forward, against B1b + B1c, which include delta)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    t = TRAIN_SHAPE
    q, k, v, do, _ = attn_inputs(torch, gen, t["b"], t["s"], t["h"], t["hkv"], t["d"],
                                 torch.bfloat16)
    o, lse = fa.flash_attention_forward(q, k, v, causal=True)
    _, delta = fa.launch_bwd_dq(q, k, v, o, lse, do, None, causal=True, scale=None)
    calls = {
        "flash_fwd": lambda: fa.flash_attention_forward(q, k, v, causal=True),
        "flash_bwd_dq": lambda: fa.launch_bwd_dq(q, k, v, o, lse, do, None, causal=True,
                                                 scale=None),
        "flash_bwd_dkv": lambda: fa.launch_bwd_dkv(q, k, v, do, lse, delta, None,
                                                   causal=True, scale=None),
    }
    plain = {
        "fwd": time_ms(lambda: fa.flash_attention_reference(q, k, v, causal=True),
                       iters=3, warmup=1),
        "bwd": time_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                                causal=True),
                       iters=3, warmup=1),
    }
    torch.cuda.empty_cache()
    qt, kt, vt = (x.requires_grad_() for x in sdpa_inputs(torch, q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    lib_fwd = time_ms(sdpa)
    lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot))
    library = {"flash_fwd": lib_fwd, "bwd": lib_fwd_bwd - lib_fwd}
    rows = {}
    for name, fn in calls.items():
        ms = time_ms(fn, iters=10)
        dev_ms = kernel_device_ms(torch, fn, name, iters=5)
        bound_ms, bound_by = flash_bound(t["b"], t["s"], t["h"], t["hkv"], t["d"], 2, True,
                                         PEAK_BF16_FLOPS, **BOUND_ARGS[name])
        rows[name] = dict(ms=ms, device_ms=dev_ms, bound_ms=bound_ms, bound_by=bound_by,
                          plain_ms=plain["fwd" if name == "flash_fwd" else "bwd"],
                          library_ms=library.get(name, library["bwd"]))
        print(f"  {name:13s} bf16 causal B{t['b']} S{t['s']} H{t['h']}/{t['hkv']} D{t['d']}: "
              f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms), bound {bound_ms:.4f} ms "
              f"({bound_by}), kernel/bound {ms / bound_ms:.1f}x, plain "
              f"{rows[name]['plain_ms']:.3f} ms, sdpa {rows[name]['library_ms']:.4f} ms",
              flush=True)
    bwd_ms = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
    print(f"  backward B1b + B1c (delta included) {bwd_ms:.4f} ms against SDPA backward "
          f"{library['bwd']:.4f} ms (fwd+bwd {lib_fwd_bwd:.4f} - fwd {lib_fwd:.4f}): "
          f"{bwd_ms / library['bwd']:.2f}x", flush=True)
    del q, k, v, do, o, lse, delta, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return rows, dict(sdpa_fwd_ms=lib_fwd, sdpa_fwd_bwd_ms=lib_fwd_bwd,
                      sdpa_bwd_ms=library["bwd"], kernels_bwd_ms=bwd_ms)


PROMPT_TEXT = ("In the beginning the framework ran on one chip, and its users paid for "
               "every second the chip spent waiting. ")


def prompt_text(n_chars):
    """PROMPT_TEXT repeated to n_chars characters (a repetitive prompt)."""
    return (PROMPT_TEXT * (n_chars // len(PROMPT_TEXT) + 1))[:n_chars]


def main_path(torch, fa, card):
    """llama3-8b served through LLMServer on the card."""
    from ray_tpu_torch.llm import LLMConfig, LLMServer

    cfg = LLMConfig(model_source="llama3-8b")
    t0 = time.perf_counter()
    server = LLMServer(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = server.engine
    n_layers = eng.model_config.n_layers
    print(f"  llama3-8b server up in {init_s:.2f} s: {eng.model_config.n_params / 1e9:.2f}B "
          f"params in {cfg.dtype}, slots {cfg.max_num_seqs}, max_model_len "
          f"{cfg.max_model_len}, buckets {cfg.buckets()}", flush=True)

    prompt = prompt_text
    # (kind, stream, temperature, prompt chars) -> prompt tokens + template
    plan = [
        ("chat", False, 0.0, 10),      # bucket 32
        ("completions", False, 0.8, 100),  # bucket 128
        ("chat", True, 0.7, 300),      # bucket 512
        ("completions", True, 0.0, 700),   # bucket 1024
        ("completions", False, 0.0, 40),   # bucket 64
        ("chat", True, 0.9, 200),      # bucket 256
    ]

    def run(i):
        kind, stream, temp, n_chars = plan[i]
        body = {"max_tokens": 32, "temperature": temp, "top_p": 0.9, "top_k": 50}
        if kind == "chat":
            body["messages"] = [{"role": "user", "content": prompt(n_chars)}]
        else:
            body["prompt"] = prompt(n_chars)
        if stream:
            body["stream"] = True
        t = time.perf_counter()
        resp = getattr(server, kind)(body)
        if stream:
            frames = list(resp)
            final = json.loads(frames[-2][len("data: "):])
            # SSE frames carry text, not token counts: "length" says the
            # stream ran to max_tokens, so it finished with tokens
            if frames[-1] != "data: [DONE]\n\n" or \
                    final["choices"][0]["finish_reason"] != "length":
                raise AssertionError(f"bad SSE stream end: {frames[-2:]}")
            return dict(kind=kind, stream=True, temperature=temp,
                        frames=len(frames), wall_s=time.perf_counter() - t,
                        finish_reason=final["choices"][0]["finish_reason"])
        usage = resp["usage"]
        if usage["completion_tokens"] < 1 or resp["choices"][0]["finish_reason"] \
                not in ("length", "stop"):
            raise AssertionError(f"request {i} returned no tokens: {resp}")
        return dict(kind=kind, stream=False, temperature=temp,
                    prompt_tokens=usage["prompt_tokens"],
                    completion_tokens=usage["completion_tokens"],
                    wall_s=time.perf_counter() - t,
                    finish_reason=resp["choices"][0]["finish_reason"])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prefills0, gen0 = eng.num_prefills, eng.total_generated
    fa.reset_launch_count()
    # ---- the main path: counts zeroed just before, read just after ----
    results, phase_s = run_together(run, len(plan), timeout=600)
    phase_tokens = eng.total_generated - gen0

    solo = []
    from ray_tpu_torch.llm import SamplingParams

    # host time on a shared machine moves these numbers between calls, so each
    # bucket runs SOLO_REPEATS times in turn and the spread is reported
    for _ in range(SOLO_REPEATS):
        for n_chars in SOLO_CHARS:
            ids = eng.tokenizer.encode(prompt(n_chars))
            t = time.perf_counter()
            stamps, got = [], []
            for out in eng.generate(ids, SamplingParams(max_tokens=SOLO_GEN, temperature=0.0,
                                                        stop_token_ids=[-1])):
                stamps.append(time.perf_counter())
                got += out.token_ids
            n_tokens = len(got)
            if n_tokens != SOLO_GEN or out.finish_reason != "length":
                raise SystemExit(f"solo request ended with {n_tokens} tokens "
                                 f"({out.finish_reason})")
            ttft_ms = (stamps[0] - t) * 1e3
            tps = (len(stamps) - 1) / (stamps[-1] - stamps[0])
            # the engine keeps the prompt's tail that leaves room for max_tokens
            solo.append(dict(prompt_tokens=out.num_prompt_tokens, ttft_ms=ttft_ms,
                             decode_tok_s=tps, tokens=n_tokens, n_chars=n_chars,
                             token_ids=got))
    torch.cuda.synchronize()
    launches = fa.launch_count()
    prefills = eng.num_prefills - prefills0
    # ---- end of the main path ----
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    for r in results:
        print(f"  request {r}", flush=True)
    print(f"  concurrent phase: {len(plan)} requests, {phase_tokens} tokens in "
          f"{phase_s:.3f} s = {phase_tokens / phase_s:.1f} tok/s aggregate [{card}]",
          flush=True)
    for n in sorted({r["prompt_tokens"] for r in solo}):
        runs = [r for r in solo if r["prompt_tokens"] == n]
        ttft = sorted(r["ttft_ms"] for r in runs)
        tps = sorted(r["decode_tok_s"] for r in runs)
        print(f"  solo greedy, prompt {n} tokens, {len(runs)} runs: TTFT median "
              f"{statistics.median(ttft):.2f} ms (all {[round(x, 2) for x in ttft]}), "
              f"decode median {statistics.median(tps):.2f} tok/s (all "
              f"{[round(x, 2) for x in tps]}) over {runs[0]['tokens']} tokens [{card}]",
              flush=True)
    print(f"  peak device memory {peak_gb:.2f} GiB; flash launches {launches}, prefills "
          f"{prefills}, n_layers {n_layers}", flush=True)
    if prefills < len(plan) or launches != n_layers * prefills:
        raise SystemExit(f"flash launches {launches} != n_layers {n_layers} x prefills "
                         f"{prefills}: the prefill path did not run through the kernel")
    profile = where_time_goes(torch, eng)
    params = eng.params  # the paged phase serves the same weights
    server.shutdown()
    del server, eng
    torch.cuda.empty_cache()
    return dict(init_s=init_s, requests=results, phase_s=phase_s,
                phase_tokens=phase_tokens, aggregate_tok_s=phase_tokens / phase_s,
                solo=solo, peak_gib=peak_gb, launches=launches, prefills=prefills,
                n_layers=n_layers, profile=profile), params


# device time of a profile by kind, from the kernel's name (first match wins)
KERNEL_KINDS = [("flash", ("flash_fwd", "flash_bwd")),
                ("matmul", ("nvjet", "gemm", "gemv", "Gemm", "Gemv", "cutlass")),
                ("foreach", ("multi_tensor_apply",)),
                ("copy", ("copy_kernel", "Memcpy", "Memset"))]


def profile_once(torch, name, fn):
    """torch.profiler over one call of fn after a warm-up call: wall time,
    device busy share, top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for evt in prof.key_averages():
        dev_us = evt.self_device_time_total
        if dev_us > 0 and getattr(evt, "device_type", None) is not None and \
                str(evt.device_type).endswith("CUDA"):
            kernels.append((evt.key, dev_us / 1e3, evt.count))
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    by_kind = {}
    for key, ms, _ in kernels:
        kind = next((kind for kind, marks in KERNEL_KINDS if any(m in key for m in marks)),
                    "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    print(f"  {name}: wall {wall * 1e3:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / (wall * 1e3):.1f}%), {sum(k[2] for k in kernels)} kernels; "
          f"device ms by kind {by_kind}", flush=True)
    for k in kernels[:8]:
        print(f"    {k[1]:9.3f} ms x{k[2]:4d}  {k[0][:90]}", flush=True)
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms, busy_share=busy_ms / (wall * 1e3),
                by_kind=by_kind,
                top=[dict(name=k[0][:90], ms=k[1], count=k[2]) for k in kernels[:8]])


def where_time_goes(torch, eng):
    """torch.profiler over one prefill (bucket 512) and one 8-slot decode step
    of an engine's model."""
    from ray_tpu_torch.llm import model_runner

    cfg = eng.model_config
    state = model_runner.init_state(cfg, eng.config.max_num_seqs, eng.config.max_model_len)
    tokens = torch.randint(3, 259, (1, 512), device="cuda")
    last = torch.randint(3, 259, (eng.config.max_num_seqs,), device="cuda")
    active = torch.ones(eng.config.max_num_seqs, dtype=torch.bool, device="cuda")
    out = {
        "prefill_512": profile_once(torch, "prefill_512", lambda: model_runner.prefill(
            eng.params, state, tokens, 500, 0, cfg)),
        "decode_step_8": profile_once(torch, "decode_step_8", lambda: model_runner.decode_step(
            eng.params, state, last, active, cfg)),
    }
    del state
    return out


def output_check(torch):
    """Full-width numerics: two llama3-8b layers in f32 on the card. Prefill
    logits through the flash kernel vs plain attention, and one decode step vs
    the full forward over the longer sequence. f32 matmuls run in full f32."""
    from ray_tpu_torch.llm import model_runner
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.config import get_config

    cfg = get_config("llama3-8b", n_layers=2, dtype="float32")
    params = llama.init(cfg, seed=3, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    s = 100
    tokens = torch.randint(0, cfg.vocab_size, (1, s + 1), generator=gen, device="cuda")
    with torch.no_grad():
        ref, _ = llama.forward(params, tokens, dataclasses.replace(cfg, attention_impl="reference"))
        state = model_runner.init_state(cfg, 2, 128, "cuda")
        s_pad = 128
        padded = torch.zeros((1, s_pad), dtype=torch.long, device="cuda")
        padded[0, :s] = tokens[0, :s]
        state, last = model_runner.prefill(params, state, padded, s, 1, cfg)
        _, dec = model_runner.decode_step(
            params, state, torch.tensor([0, int(tokens[0, s])], device="cuda"),
            torch.tensor([False, True], device="cuda"), cfg)
    torch.cuda.synchronize()
    err_prefill = (last - ref[0, s - 1]).abs().max().item()
    err_decode = (dec[1] - ref[0, s]).abs().max().item()
    scale = ref.abs().max().item()
    finite = bool(torch.isfinite(last).all() and torch.isfinite(dec).all())
    tol = 1e-3
    print(f"  llama3-8b width, 2 layers, f32: prefill logits max|d| {err_prefill:.3e}, "
          f"decode logits max|d| {err_decode:.3e} (tol {tol}; max|logit| {scale:.2f}); "
          f"shapes {tuple(last.shape)}/{tuple(dec.shape)}", flush=True)
    if not finite or err_prefill > tol or err_decode > tol or last.shape != (cfg.vocab_size,):
        raise SystemExit("served model output disagrees with the plain path")
    return dict(err_prefill=err_prefill, err_decode=err_decode, tol=tol, max_logit=scale)


def launches_per_step(n_layers):
    """Kernel launches of one train step with remat full or dots: B1a in the
    forward and again in each layer's recomputation (the flash Function's
    output is not a product, so dots recomputes it too), B1b and B1c once per
    layer."""
    return {"flash_fwd": 2 * n_layers, "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers}


def train_path(torch, fa, card, policy):
    """llama8b-geom2 trained on the card through make_train_step, with the
    remat policy `policy`."""
    from ray_tpu_torch.models.config import get_config
    from ray_tpu_torch.train import init_state, make_optimizer, make_train_step

    cfg = get_config("llama8b-geom2", remat_policy=policy)  # remat=True, bf16
    tx = make_optimizer(warmup_steps=2, total_steps=1000)
    t0 = time.perf_counter()
    state = init_state(cfg, tx, seed=0)
    step = make_train_step(cfg, tx)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                                     device="cuda")}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_layers = cfg.n_layers
    print(f"  llama8b-geom2 up in {init_s:.2f} s: {cfg.n_params / 1e9:.3f}B params in f32, "
          f"activations {cfg.dtype}, remat {cfg.remat_policy}, batch {b} x {s + 1} tokens",
          flush=True)
    t0 = time.perf_counter()
    state, m = step(state, batch)  # warm-up: count 0, lr = 0
    warm = dict(loss=m["loss"].item(), grad_norm=m["grad_norm"].item(),
                s=time.perf_counter() - t0)
    print(f"  warm-up step (lr 0): loss {warm['loss']:.6f}, grad_norm "
          f"{warm['grad_norm']:.6f}, {warm['s']:.3f} s", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_count()
    # ---- the training path: counts zeroed just before, read just after ----
    steps = []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps.append(dict(loss=m["loss"].item(), grad_norm=m["grad_norm"].item(),
                          lr=tx.learning_rate(state.opt_state.count - 1), step_s=wall))
    launches = {name: fa.launch_count(name) for name in fa.KERNELS}
    # ---- end of the training path ----
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for i, r in enumerate(steps):
        print(f"  step {i + 1}: loss {r['loss']:.6f}, grad_norm {r['grad_norm']:.6f}, "
              f"lr {r['lr']:.3e}, {r['step_s'] * 1e3:.2f} ms", flush=True)
    step_s = statistics.median(r["step_s"] for r in steps)
    tokens = b * s
    tok_s = tokens / step_s
    mfu = 6 * cfg.n_params * tok_s / PEAK_BF16_FLOPS
    print(f"  remat {policy}: median step {step_s * 1e3:.2f} ms, {tok_s:.1f} tokens/s, "
          f"6*N*tokens/s over {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s (MFU against the bf16 "
          f"peak) {mfu:.4f}; peak device memory {peak_gib:.2f} GiB [{card}]", flush=True)
    want = launches_per_step(n_layers)
    print(f"  launches over {TRAIN_STEPS} steps: {launches}; per step expected {want}",
          flush=True)
    if any(launches[k] != TRAIN_STEPS * n for k, n in want.items()):
        raise SystemExit(f"launch counts {launches} != {TRAIN_STEPS} x {want}: the "
                         "training path did not run through the kernels as expected")
    finite = all(abs(r["loss"]) < float("inf") and abs(r["grad_norm"]) < float("inf")
                 and r["loss"] == r["loss"] and r["grad_norm"] == r["grad_norm"]
                 for r in steps)
    if not finite or not steps[-1]["loss"] < steps[0]["loss"] or steps[0]["lr"] <= 0:
        raise SystemExit(f"training did not run clean: finite={finite}, losses "
                         f"{[r['loss'] for r in steps]}, first lr {steps[0]['lr']}")
    profile = profile_once(torch, f"train_step_{policy}", lambda: step(state, batch))
    del state, step, batch
    torch.cuda.empty_cache()
    return dict(policy=policy, init_s=init_s, warmup=warm, steps=steps, step_ms=step_s * 1e3,
                tokens_per_step=tokens, tokens_per_s=tok_s, mfu_bf16_peak=mfu,
                peak_gib=peak_gib, launches=launches, launches_per_step=want,
                n_params=cfg.n_params, profile=profile)


def train_numerics(torch, fa, cfg=None):
    """A 2-layer model at full width in f32 at B1 S256 (llama8b-geom2 unless
    cfg is given): loss_fn's value and every parameter's gradient through the
    kernels (attention on the auto path, which takes flash on the card), with
    remat full and with dots (selective checkpointing around the flash
    Function), against attention_impl="reference" with remat full."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.config import get_config

    cfg = dataclasses.replace(cfg or get_config("llama8b-geom2"), dtype="float32")
    params = llama.init(cfg, seed=3, device="cuda", dtype=torch.float32)
    leaves = llama.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 257), generator=gen,
                                     device="cuda")}
    out = {}
    for impl, policy in (("reference", "full"), ("auto", "full"), ("auto", "dots")):
        fa.reset_launch_count()
        c = dataclasses.replace(cfg, attention_impl=impl, remat_policy=policy)
        loss, _ = llama.loss_fn(params, batch, c)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        out[impl, policy] = (loss.item(), grads, {k: fa.launch_count(k) for k in fa.KERNELS})
    loss_r, grads_r, ref_launches = out["reference", "full"]
    if any(ref_launches.values()):
        raise SystemExit(f"the reference path launched kernels: {ref_launches}")
    report = dict(loss_reference=loss_r, tol_loss=TRAIN_LOSS_TOL, tol_grad=TRAIN_GRAD_TOL)
    for policy in ("full", "dots"):
        loss_k, grads_k, launches = out["auto", policy]
        if launches != launches_per_step(cfg.n_layers):
            raise SystemExit(f"remat {policy}: kernel launches {launches} != "
                             f"{launches_per_step(cfg.n_layers)}")
        errs = []
        for g, r in zip(grads_k, grads_r):
            ref_max = r.abs().max().item()
            errs.append((g - r).abs().max().item() / max(ref_max, 1e-30))
        err_loss = abs(loss_k - loss_r) / abs(loss_r)
        finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
        print(f"  {cfg.name} geometry at {cfg.n_layers} layers, f32, B1 S256, remat {policy} "
              f"through the kernels: loss "
              f"{loss_k:.7f} vs {loss_r:.7f} (rel {err_loss:.2e}, tol {TRAIN_LOSS_TOL}); "
              f"worst gradient max|d| / max|ref| {max(errs):.2e} over {len(errs)} leaves "
              f"(tol {TRAIN_GRAD_TOL}); launches {launches}", flush=True)
        if not finite or err_loss > TRAIN_LOSS_TOL or max(errs) > TRAIN_GRAD_TOL:
            raise SystemExit(f"remat {policy}: training gradients through the kernels "
                             "disagree with the plain path")
        report[policy] = dict(loss_kernels=loss_k, err_loss=err_loss,
                              worst_grad_rel=max(errs), grad_rel=errs, launches=launches)
    del params, leaves, grads_r, out
    torch.cuda.empty_cache()
    return report


# phase F: training on a device mesh (A6). llama8b-geom2 on fsdp 2 x tp 2,
# four ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one device;
# gloo stages every CUDA collective through the host), against the one-rank
# step on the same seeded init and batch. Not a mesh speed.
MESH = dict(fsdp=2, tp=2)
MESH_LR = dict(warmup_steps=2, total_steps=1000)  # phase 7's optimizer


def mesh_tokens(torch):
    """Phase F's seeded global batch [4, 1025] of llama8b-geom2 ids, on the host."""
    gen = torch.Generator()
    gen.manual_seed(7)
    return torch.randint(0, 32000, MESH_BATCH, generator=gen)


def mesh_rank(rank, init_method, devices, tokens, ref_path, outbox):
    """One rank of phase F (a spawned process): its TRAIN_RULES shards of
    the seeded init, a warm-up step, MESH_STEPS steps with the kernel counts
    zeroed just before and read just after, its shards after them against
    the slices of the one-rank parameters at `ref_path`, then one step with
    every collective bracketed by syncs. Puts (rank, result) or (rank,
    traceback)."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.models.config import get_config
        from ray_tpu_torch.ops import flash_attention as fa
        from ray_tpu_torch.parallel import TRAIN_RULES, MeshSpec, build_mesh, shard_view
        from ray_tpu_torch.train import init_state, make_optimizer, make_train_step

        mesh = build_mesh(MeshSpec(**MESH), devices, rank=rank, init_method=init_method)
        dev = torch.device(devices[rank])
        cfg = get_config("llama8b-geom2", remat_policy="dots")
        tx = make_optimizer(**MESH_LR)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state = init_state(cfg, tx, seed=0, device=dev, mesh=mesh)
        step = make_train_step(cfg, tx, device=dev, mesh=mesh)
        batch = {"tokens": tokens.to(dev)}
        torch.cuda.synchronize(dev)
        out = dict(rank=rank, coord=list(mesh.get_coordinate()), backend=dist.get_backend(),
                   init_s=time.perf_counter() - t0, metrics=[], walls=[])
        seen = set()  # (q heads, kv heads) at every B1a and B1b/B1c call
        real = {name: getattr(fa, name) for name in ("flash_attention_forward",
                                                     "flash_attention_backward")}

        def spy(fn):
            def call(q, k, v, *args, **kw):
                seen.add((q.shape[0], q.shape[2], k.shape[2]))
                return fn(q, k, v, *args, **kw)
            return call

        for name, fn in real.items():
            setattr(fa, name, spy(fn))

        def run():
            nonlocal state
            t = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t
            out["metrics"].append({k: v.item() for k, v in m.items()})
            return wall

        out["warm_s"] = run()
        torch.cuda.synchronize(dev)
        fa.reset_launch_count()
        # ---- the mesh path: counts zeroed just before, read just after ----
        for _ in range(MESH_STEPS):
            out["walls"].append(run())
        out["launches"] = {name: fa.launch_count(name) for name in fa.KERNELS}
        # ---- end ----
        for name, fn in real.items():
            setattr(fa, name, fn)
        out["seen"] = sorted(seen)
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        ref = torch.load(ref_path, mmap=True, weights_only=True)
        axes = llama.param_axes(cfg)
        errs = {}
        for name, mine in state.params.items():
            pairs = (mine.items() if isinstance(mine, dict) else [(None, mine)])
            for key, leaf in pairs:
                whole = ref[name][key] if key else ref[name]
                ax = axes[name][key] if key else axes[name]
                want = shard_view(whole, ax, mesh, TRAIN_RULES).to(dev)
                errs[f"{name}/{key}" if key else name] = (leaf.detach() - want).abs().max().item()
                del want
        out["param_errs"] = errs
        del ref
        # one more step, each collective bracketed by syncs
        coll = [0.0, 0]
        calls = {name: getattr(dist, name) for name in ("all_reduce", "all_gather")}

        def timed(fn):
            def call(*args, **kw):
                torch.cuda.synchronize(dev)
                t = time.perf_counter()
                r = fn(*args, **kw)
                torch.cuda.synchronize(dev)
                coll[0] += time.perf_counter() - t
                coll[1] += 1
                return r
            return call

        for name, fn in calls.items():
            setattr(dist, name, timed(fn))
        out["synced_step_s"] = run()
        for name, fn in calls.items():
            setattr(dist, name, fn)
        out["collective_s"], out["collectives"] = coll
        out["metrics"].pop()  # the synced step's: a fourth step, not gated
        outbox.put((rank, out))
        dist.destroy_process_group()
    except BaseException:
        outbox.put((rank, traceback.format_exc()))


def mesh_reference(torch, fa, tokens):
    """The one-rank step (phase 7's path, remat dots) on the seeded init and
    `tokens`: the warm-up and MESH_STEPS steps -> (metrics of each, the
    learning rate of each, the launch counts of the counted steps, the
    parameters after them on the host)."""
    from ray_tpu_torch.models.config import get_config
    from ray_tpu_torch.train import init_state, make_optimizer, make_train_step

    cfg = get_config("llama8b-geom2", remat_policy="dots")
    tx = make_optimizer(**MESH_LR)
    state = init_state(cfg, tx, seed=0)
    step = make_train_step(cfg, tx)
    batch = {"tokens": tokens.to("cuda")}
    metrics, lrs = [], []
    for i in range(1 + MESH_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            fa.reset_launch_count()
        lrs.append(tx.learning_rate(state.opt_state.count))
        state, m = step(state, batch)
        metrics.append({k: v.item() for k, v in m.items()})
    launches = {name: fa.launch_count(name) for name in fa.KERNELS}
    params = {name: ({k: v.detach().cpu() for k, v in val.items()} if isinstance(val, dict)
                     else val.detach().cpu()) for name, val in state.params.items()}
    del state, step, batch
    torch.cuda.empty_cache()
    return metrics, lrs, launches, params


def mesh_ranks(torch, devices, tokens, ref_path):
    """Run mesh_rank on len(devices) spawned ranks -> their results by rank;
    exits if a rank fails or does not answer within 300 s, and joins them
    all (killing what is left)."""
    import multiprocessing
    import queue
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        init_method = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    ctx = multiprocessing.get_context("spawn")
    outbox = ctx.Queue()
    procs = [ctx.Process(target=mesh_rank, daemon=True,
                         args=(r, init_method, devices, tokens, ref_path, outbox))
             for r in range(len(devices))]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, out = outbox.get(timeout=300)
            if isinstance(out, str):
                raise SystemExit(f"phase F rank {rank} failed:\n{out}")
            got[rank] = out
    except queue.Empty:
        raise SystemExit("phase F: a rank did not answer within 300 s") from None
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(5)
    return got


def mesh_train_path(torch, fa, card):
    """Phase F: the one-rank reference in this process, then the mesh step
    on four ranks sharing cuda:0 (see the module docstring)."""
    import shutil

    from ray_tpu_torch.models.config import get_config

    t_phase = time.perf_counter()
    cfg = get_config("llama8b-geom2")
    held = torch.cuda.memory_allocated()
    if held > 2 * 2**30:
        raise SystemExit(f"{held / 2**30:.2f} GiB still allocated before phase F")
    tokens = mesh_tokens(torch)
    t0 = time.perf_counter()
    ref_metrics, lrs, ref_launches, ref_params = mesh_reference(torch, fa, tokens)
    ref_s = time.perf_counter() - t0
    want = launches_per_step(cfg.n_layers)
    if ref_launches != {k: MESH_STEPS * n for k, n in want.items()}:
        raise SystemExit(f"phase F one-rank launches {ref_launches}, want {MESH_STEPS} x {want}")
    out_dir = checkpoint_dir(4 * cfg.n_params)
    ref_path = os.path.join(out_dir, "reference_params.pt")
    try:
        torch.save(ref_params, ref_path)
        del ref_params
        devices = ["cuda:0"] * (MESH["fsdp"] * MESH["tp"])
        t0 = time.perf_counter()
        got = mesh_ranks(torch, devices, tokens, ref_path)
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"  one-rank reference (B{MESH_BATCH[0]} x {MESH_BATCH[1]}, remat dots): losses "
          f"{[m['loss'] for m in ref_metrics]}, grad_norms "
          f"{[m['grad_norm'] for m in ref_metrics]}, lrs {lrs}, launches {ref_launches}; "
          f"{ref_s:.1f} s", flush=True)
    slack = MESH_PARAM_SLACK * sum(lrs)
    errs = []
    for r, o in sorted(got.items()):
        loss_rel = [abs(m["loss"] - w["loss"]) / abs(w["loss"])
                    for m, w in zip(o["metrics"], ref_metrics)]
        norm_rel = [abs(m["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"])
                    for m, w in zip(o["metrics"], ref_metrics)]
        worst = max(o["param_errs"].items(), key=lambda kv: kv[1])
        errs.append(dict(loss_rel=loss_rel, norm_rel=norm_rel, param_max=worst))
        print(f"  rank {r} at {o['coord']} ({o['backend']}): losses "
              f"{[m['loss'] for m in o['metrics']]} (rel {[f'{e:.2e}' for e in loss_rel]}, "
              f"tol {MESH_LOSS_TOL}), grad_norms {[m['grad_norm'] for m in o['metrics']]} "
              f"(rel {[f'{e:.2e}' for e in norm_rel]}, tol {MESH_NORM_TOL}); params after "
              f"{1 + MESH_STEPS} steps: worst max|d| {worst[1]:.3e} at {worst[0]} (tol "
              f"{slack:.3e}); launches over {MESH_STEPS} steps {o['launches']} at (rows, q "
              f"heads, kv heads) {o['seen']}; shards in {o['init_s']:.2f} s, warm-up "
              f"{o['warm_s']:.2f} s, steps {[f'{w * 1e3:.1f}' for w in o['walls']]} ms, "
              f"synced step {o['synced_step_s'] * 1e3:.1f} ms of which "
              f"{o['collective_s'] * 1e3:.1f} ms in {o['collectives']} collectives; peak "
              f"{o['peak_gib']:.2f} GiB [4 ranks sharing one H100 over gloo; {card}]",
              flush=True)
    wall = time.perf_counter() - t_phase
    print(f"  ranks {ranks_s:.1f} s; phase F took {wall:.1f} s", flush=True)
    same = all(o["metrics"] == got[0]["metrics"] for o in got.values())
    heads = [(MESH_BATCH[0] // MESH["fsdp"], cfg.n_heads // MESH["tp"],
              cfg.n_kv_heads // MESH["tp"])]
    for r, o in got.items():
        if o["launches"] != {k: MESH_STEPS * n for k, n in want.items()} or o["seen"] != heads:
            raise SystemExit(f"phase F rank {r}: launches {o['launches']} at {o['seen']}, want "
                             f"{MESH_STEPS} x {want} at {heads}")
    if not same:
        raise SystemExit("phase F: the ranks' metrics differ")
    for r, e in enumerate(errs):
        if (max(e["loss_rel"]) > MESH_LOSS_TOL or max(e["norm_rel"]) > MESH_NORM_TOL
                or not e["param_max"][1] <= slack):
            raise SystemExit(f"phase F rank {r} disagrees with the one-rank step: {e}")
    left = torch.cuda.memory_allocated()
    return dict(mesh=MESH, batch=MESH_BATCH, devices=devices, reference=dict(
        metrics=ref_metrics, lrs=lrs, launches=ref_launches, s=ref_s), errs=errs,
        ranks={r: {k: v for k, v in o.items()} for r, o in got.items()},
        launches_per_rank_per_step={k: v // MESH_STEPS for k, v in got[0]["launches"].items()},
        tol=dict(loss=MESH_LOSS_TOL, grad_norm=MESH_NORM_TOL, params=slack), ranks_s=ranks_s,
        left_gib=left / 2**30, wall_s=wall)


def rel_err(got, ref):
    """max|got - ref| / max|ref|, in f32."""
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def random_ids(torch, gen, n):
    """n token ids inside llama3-8b's vocabulary, from a CPU generator."""
    return torch.randint(3, 128000, (n,), generator=gen).tolist()


def padded_ids(torch, ids, width):
    tokens = torch.zeros((1, width), dtype=torch.long)
    tokens[0, :len(ids)] = torch.tensor(ids)
    return tokens.cuda()


def paged_function_check(torch, params, cfg):
    """decode_step_paged against decode_step on the same KV: 8 slots of
    llama3-8b in bf16, each slot's random KV installed into a slot state and
    into shuffled blocks of a paged state; two steps, slot 7 inactive with a
    stale table entry that points at slot 0's first block."""
    from ray_tpu_torch.llm import model_runner, paged

    slots, max_len, bs = 8, PAGED["max_model_len"], PAGED["kv_block_size"]
    lengths = [37, 100, 250, 500, 777, 960, 1000, 64]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    slot_state = model_runner.init_state(cfg, slots, max_len)
    n_blocks = slots * max_len // bs
    pstate = paged.init_paged_state(cfg, slots, max_len, n_blocks, bs)
    free = torch.randperm(n_blocks, generator=torch.Generator().manual_seed(8)).tolist()
    for slot, n in enumerate(lengths):
        nb = -(-(n + 2) // bs)  # room for the two steps
        shape = (cfg.n_layers, 1, nb * bs, cfg.n_kv_heads, cfg.head_dim)
        k = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        model_runner.install_kv(slot_state, k, v, n, slot)
        ids, free = free[:nb], free[nb:]
        paged.install_prefill(pstate, k, v, ids, n, slot, nb)
        del k, v
    pstate.block_tables[7, lengths[7] // bs] = pstate.block_tables[0, 0]
    active = torch.tensor([True] * 7 + [False], device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, slots), generator=gen, device="cuda")
    errs = []
    for t in range(2):
        _, ref = model_runner.decode_step(params, slot_state, toks[t], active, cfg)
        _, got = paged.decode_step_paged(params, pstate, toks[t], active, cfg)
        torch.cuda.synchronize()
        errs.append(rel_err(got[:7], ref[:7]))
    same_lengths = pstate.lengths.tolist() == slot_state.lengths.tolist()
    print(f"  decode_step_paged vs decode_step, 8 slots of lengths {lengths}, slot 7 "
          f"inactive with a stale table: logits max|d| / max|ref| {errs} (tol "
          f"{PAGED_TOL}), lengths equal {same_lengths}", flush=True)
    if max(errs) > PAGED_TOL or not same_lengths:
        raise SystemExit("the paged decode step disagrees with the slot decode step")
    del slot_state, pstate
    torch.cuda.empty_cache()
    return dict(lengths=lengths, rel_errs=errs, tol=PAGED_TOL)


def solo_request(eng, ids, max_tokens):
    """One greedy request alone: TTFT, decode tokens/s, and its checks."""
    from ray_tpu_torch.llm import SamplingParams

    t = time.perf_counter()
    stamps, n_tokens, out = [], 0, None
    for out in eng.generate(ids, SamplingParams(max_tokens=max_tokens, temperature=0.0,
                                                stop_token_ids=[-1])):
        stamps.append(time.perf_counter())
        n_tokens += len(out.token_ids)
    if n_tokens != max_tokens or out.finish_reason != "length":
        raise SystemExit(f"request of {len(ids)} tokens ended with {n_tokens} tokens "
                         f"({out.finish_reason})")
    tps = (len(stamps) - 1) / (stamps[-1] - stamps[0]) if len(stamps) > 1 else None
    return dict(prompt_tokens=out.num_prompt_tokens, ttft_ms=(stamps[0] - t) * 1e3,
                decode_tok_s=tps, tokens=n_tokens)


def paged_path(torch, fa, card, params):
    """llama3-8b served with kv_layout="paged" and bench_serve.py's engine
    settings (32 slots, 1024 positions, 32-token blocks, buckets 32..1024),
    on the slot phase's weights: the paged decode step against the slot one;
    cold prompts through the engine; the prefix cache; chunked prefill;
    preemption in a small pool."""
    from ray_tpu_torch.llm import LLMConfig, LLMServer, TorchLLMEngine, model_runner, paged

    cfg = LLMConfig(model_source="llama3-8b", **PAGED)
    eng = TorchLLMEngine(cfg, params=params)
    server = LLMServer(cfg, engine=eng)
    mcfg = eng.model_config
    n_layers, bs = mcfg.n_layers, cfg.kv_block_size
    out = dict(config=dict(PAGED), function=paged_function_check(torch, eng.params, mcfg))
    gen = torch.Generator().manual_seed(9)

    # ---- served prompts, all cold: B1a n_layers times per prefill ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_count()
    prefills0 = eng.num_prefills
    solo = [solo_request(eng, random_ids(torch, gen, n), 32) for n in (121, 501, 960)]
    torch.cuda.synchronize()
    launches, prefills = fa.launch_count(), eng.num_prefills - prefills0
    m = eng.metrics()
    for r in solo:
        print(f"  paged, cold prompt {r['prompt_tokens']} tokens: TTFT {r['ttft_ms']:.2f} ms, "
              f"decode {r['decode_tok_s']:.2f} tok/s over {r['tokens']} tokens [{card}]",
              flush=True)
    print(f"  flash launches {launches} over {prefills} prefills (n_layers {n_layers}); "
          f"pool {m['kv_blocks_total']} blocks of {bs} tokens, prefix hits "
          f"{m['prefix_cache_hit_tokens']} tokens", flush=True)
    if prefills != 3 or launches != n_layers * prefills or m["prefix_cache_hit_tokens"]:
        raise SystemExit(f"paged prefills {prefills}, flash launches {launches}, hits "
                         f"{m['prefix_cache_hit_tokens']}: the fresh paged prefill did not "
                         "run through the kernel once per layer")
    out.update(solo=solo, launches=launches, prefills=prefills)

    # ---- the prefix cache: a shared 512-token prefix, 4 suffixes of 64 ----
    prefix = random_ids(torch, gen, 512)
    suffixes = [random_ids(torch, gen, 64) for _ in range(4)]
    runs = []
    for i, suffix in enumerate(suffixes):
        hits0 = eng.metrics()["prefix_cache_hit_tokens"]
        fa.reset_launch_count()
        r = solo_request(eng, prefix + suffix, 8)
        torch.cuda.synchronize()
        r.update(hit_tokens=eng.metrics()["prefix_cache_hit_tokens"] - hits0,
                 launches=fa.launch_count(), warm=i > 0)
        runs.append(r)
        print(f"  prefix {'warm' if i else 'cold'}: prompt {r['prompt_tokens']} tokens, hit "
              f"{r['hit_tokens']} tokens, TTFT {r['ttft_ms']:.2f} ms, flash launches "
              f"{r['launches']} [{card}]", flush=True)
    want = [(0, n_layers)] + [(512, 0)] * 3
    if [(r["hit_tokens"], r["launches"]) for r in runs] != want:
        raise SystemExit(f"prefix cache: (hit tokens, flash launches) per request "
                         f"{[(r['hit_tokens'], r['launches']) for r in runs]}, want {want}")
    # a warm request's first-token logits against a cold whole prefill
    prompt = prefix + suffixes[1]
    cached = [eng._blocks.cached[key] for key in eng._blocks.chain_keys(prefix, bs)]
    _, _, warm = paged.prefill_suffix_from_state(
        eng.params, eng.state, cached, padded_ids(torch, suffixes[1], 64), 64, mcfg,
        len(cached))
    _, _, cold = model_runner.prefill_detached(eng.params, padded_ids(torch, prompt, 1024),
                                               len(prompt), mcfg)
    err_prefix = rel_err(warm, cold)
    ttft_cold = runs[0]["ttft_ms"]
    ttft_warm = statistics.median(r["ttft_ms"] for r in runs[1:])
    print(f"  prefix: TTFT cold {ttft_cold:.2f} ms, warm median {ttft_warm:.2f} ms (all "
          f"{[round(r['ttft_ms'], 2) for r in runs[1:]]}); warm first-token logits vs a "
          f"cold whole prefill max|d| / max|ref| {err_prefix:.3e} (tol {PAGED_TOL}) "
          f"[{card}]", flush=True)
    if not err_prefix <= PAGED_TOL:
        raise SystemExit("the prefix-cache suffix prefill disagrees with a whole prefill")
    out.update(prefix=runs, ttft_cold_ms=ttft_cold, ttft_warm_ms=ttft_warm,
               prefix_rel_err=err_prefix)

    # ---- the prefix gate and the profile of one paged step ----
    out["prefix_min_hit_tokens"] = eng._prefix_min_hit_tokens()
    out["prefill_per_tok_ms"] = eng._prefill_per_tok_s * 1e3
    out["host_rt_ms"] = eng._host_rt_s * 1e3
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["profile"] = paged_where_time_goes(torch, eng)
    server.shutdown()

    # ---- chunked prefill, 256 tokens a chunk, of a 960-token prompt ----
    ids = random_ids(torch, gen, 960)
    fa.reset_launch_count()
    _, _, chunked = paged.chunked_prefill(eng.params, ids, mcfg, 256)
    torch.cuda.synchronize()
    chunk_launches = fa.launch_count()
    _, _, whole = model_runner.prefill_detached(eng.params, padded_ids(torch, ids, 1024),
                                                len(ids), mcfg)
    err_chunk = rel_err(chunked, whole)
    ceng = TorchLLMEngine(LLMConfig(model_source="llama3-8b", prefill_chunk=256,
                                    **dict(PAGED, num_kv_blocks=64)), params=eng.params)
    try:
        fa.reset_launch_count()
        served = solo_request(ceng, ids, 8)
        torch.cuda.synchronize()
        served["launches"] = fa.launch_count()
    finally:
        ceng.shutdown()
    print(f"  chunked prefill of {len(ids)} tokens in chunks of 256: last logits vs the "
          f"whole prefill max|d| / max|ref| {err_chunk:.3e} (tol {PAGED_TOL}), flash "
          f"launches {chunk_launches}; served through the engine: TTFT "
          f"{served['ttft_ms']:.2f} ms, flash launches {served['launches']} [{card}]",
          flush=True)
    if not err_chunk <= PAGED_TOL or chunk_launches or served["launches"]:
        raise SystemExit("chunked prefill disagrees with the whole prefill (or took flash)")
    out.update(chunked=dict(rel_err=err_chunk, launches=chunk_launches, served=served))

    # ---- preemption: 4 concurrent 250-token prompts in a 36-block pool ----
    peng = TorchLLMEngine(LLMConfig(model_source="llama3-8b", **dict(PAGED, num_kv_blocks=36)),
                          params=eng.params)
    prompts = [random_ids(torch, gen, 250) for _ in range(4)]
    try:
        results, wall_s = run_together(lambda i: solo_request(peng, prompts[i], 64), 4)
    finally:
        peng.shutdown()
    pm = peng.metrics()
    print(f"  preemption: 4 x 250-token prompts x 64 tokens in {pm['kv_blocks_total']} blocks: "
          f"{pm['num_preemptions']} preemptions, {pm['kv_blocks_free']} blocks free after, "
          f"{wall_s:.2f} s [{card}]", flush=True)
    if pm["num_preemptions"] < 1 or pm["kv_blocks_free"] != pm["kv_blocks_total"]:
        raise SystemExit(f"preemption run failed: metrics {pm}")
    out.update(preemption=dict(metrics=pm, wall_s=wall_s, requests=results))
    del eng, ceng, peng
    torch.cuda.empty_cache()
    return out


def paged_where_time_goes(torch, eng):
    """torch.profiler over one detached prefill (bucket 512) and one paged
    decode step of 32 slots of the served model."""
    from ray_tpu_torch.llm import model_runner, paged

    cfg, c = eng.model_config, eng.config
    state = paged.init_paged_state(cfg, c.max_num_seqs, c.max_model_len,
                                   c.max_num_seqs * c.max_model_len // c.kv_block_size,
                                   c.kv_block_size)
    tokens = torch.randint(3, 259, (1, 512), device="cuda")
    last = torch.randint(3, 259, (c.max_num_seqs,), device="cuda")
    active = torch.ones(c.max_num_seqs, dtype=torch.bool, device="cuda")
    out = {
        "prefill_detached_512": profile_once(torch, "prefill_detached_512", lambda: (
            model_runner.prefill_detached(eng.params, tokens, 500, cfg))),
        "decode_step_paged_32": profile_once(torch, "decode_step_paged_32", lambda: (
            paged.decode_step_paged(eng.params, state, last, active, cfg))),
    }
    del state
    return out


def tree_bytes(params):
    """Bytes a parameter dict holds (an int8 QTensor: its q and s)."""
    from ray_tpu_torch.ops.quant import QTensor

    total = 0
    for val in params.values():
        for t in (val.values() if isinstance(val, dict) else [val]):
            total += t.nbytes if isinstance(t, QTensor) else t.nelement() * t.element_size()
    return total


def release_layout(torch, params, cfg, out_dir, shards=4):
    """Write `params` as HF's Llama-3 release lays them out: bf16 tensors in
    `shards` files model-0000N-of-0000M.safetensors (consecutive tensors in
    HF's order, cut at about equal bytes), model.safetensors.index.json and
    config.json, with the port's writer. Returns the tensor bytes written."""
    from ray_tpu_torch.models import checkpoint
    from ray_tpu_torch.models.safetensors import save_file

    tensors = checkpoint.hf_state_dict(params, cfg)
    total = sum(t.nelement() * 2 for t in tensors.values())
    groups, done = [[]], 0
    for name, t in tensors.items():
        if groups[-1] and len(groups) < shards and done >= len(groups) * total / shards:
            groups.append([])
        groups[-1].append(name)
        done += t.nelement() * 2
    weight_map = {}
    for n, names in enumerate(groups, start=1):
        fname = f"model-{n:05d}-of-{len(groups):05d}.safetensors"
        save_file({k: tensors[k] for k in names}, os.path.join(out_dir, fname),
                  metadata={"format": "pt"}, dtypes={k: torch.bfloat16 for k in names})
        weight_map.update({k: fname for k in names})
    with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(checkpoint.config_to_hf(cfg), f, indent=2)
    return total


def run_together(fn, n, timeout=300):
    """Call fn(i) for i < n, each on a thread of its own, all started at once
    -> (results, wall seconds from the first start to the last join); exits
    if a call raised, returned None or outlived the timeout."""
    results, errors = [None] * n, []

    def run(i):
        try:
            results[i] = fn(i)
        except BaseException as e:  # recorded and raised below
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or errors or None in results:
        raise SystemExit(f"concurrent requests failed: errors {errors} results {results}")
    return results, wall


def serve_together(eng, requests):
    """Run (prompt ids, SamplingParams) requests concurrently -> (outputs,
    wall seconds from the first submission to the last token); each must
    finish with its max_tokens."""
    outs, wall = run_together(lambda i: eng.generate_sync(*requests[i]), len(requests))
    for out, (_, p) in zip(outs, requests):
        if len(out.token_ids) != p.max_tokens or out.finish_reason != "length":
            raise SystemExit(f"a request ended with {len(out.token_ids)} of {p.max_tokens} "
                             f"tokens ({out.finish_reason})")
    return outs, wall


def quant_path(torch, fa, card, params, served):
    """int8 weights (W8A16) on the slot phase's llama3-8b weights: the engine
    quantizes them at start; the weight bytes against bf16; three solo
    greedy prompts in the slot layout beside phase 3's bf16 numbers, B1a
    n_layers times per prefill; one prefill (through B1a) and one decode
    step against the plain path on the same dequantized weights."""
    from ray_tpu_torch.llm import LLMConfig, TorchLLMEngine, model_runner
    from ray_tpu_torch.models import llama

    bf16_bytes = tree_bytes(params)
    eng = TorchLLMEngine(LLMConfig(model_source="llama3-8b", quantization="int8"),
                         params=params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.start()
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    mcfg, n_layers = eng.model_config, eng.model_config.n_layers
    int8_bytes = tree_bytes(eng.params)
    print(f"  quantized at start in {quant_s:.2f} s: weights {int8_bytes / 1e9:.3f} GB int8 "
          f"against {bf16_bytes / 1e9:.3f} GB bf16 ({int8_bytes / bf16_bytes:.3f})", flush=True)

    fa.reset_launch_count()
    prefills0 = eng.num_prefills
    solo = [solo_request(eng, eng.tokenizer.encode(prompt_text(n)), SOLO_GEN)
            for n in SOLO_CHARS]
    torch.cuda.synchronize()
    launches, prefills = fa.launch_count(), eng.num_prefills - prefills0
    bf16 = {}
    for r in served["solo"]:
        bf16.setdefault(r["prompt_tokens"], []).append(r)
    for r in solo:
        ref = bf16.get(r["prompt_tokens"], [])
        ref_ttft = statistics.median(x["ttft_ms"] for x in ref) if ref else float("nan")
        ref_tps = statistics.median(x["decode_tok_s"] for x in ref) if ref else float("nan")
        r.update(bf16_ttft_ms=ref_ttft, bf16_decode_tok_s=ref_tps)
        print(f"  int8, prompt {r['prompt_tokens']} tokens: TTFT {r['ttft_ms']:.2f} ms (bf16 "
              f"median {ref_ttft:.2f}), decode {r['decode_tok_s']:.2f} tok/s (bf16 median "
              f"{ref_tps:.2f}) over {r['tokens']} tokens [{card}]", flush=True)
    print(f"  flash launches {launches} over {prefills} prefills (n_layers {n_layers})",
          flush=True)
    if prefills != 3 or launches != n_layers * prefills:
        raise SystemExit(f"int8 prefills {prefills}, flash launches {launches}: the int8 "
                         "prefill did not run through the kernel once per layer")

    # the plain path: attention_impl="reference" over the same int8 weights,
    # which as_weight dequantizes at each use
    ref_cfg = dataclasses.replace(mcfg, attention_impl="reference")
    ids = random_ids(torch, torch.Generator().manual_seed(12), 301)
    s = 300
    with torch.no_grad():
        state = model_runner.init_state(mcfg, 1, 512)
        state, last = model_runner.prefill(eng.params, state, padded_ids(torch, ids[:s], 512),
                                           s, 0, mcfg)
        _, dec = model_runner.decode_step(eng.params, state, torch.tensor([ids[s]], device="cuda"),
                                          torch.tensor([True], device="cuda"), mcfg)
        full_ids = torch.tensor([ids], device="cuda")
        ref, _ = llama.forward(eng.params, full_ids, ref_cfg)
        bf16_ref, _ = llama.forward(params, full_ids, ref_cfg)
    torch.cuda.synchronize()
    err_prefill, err_decode = rel_err(last, ref[0, s - 1]), rel_err(dec[0], ref[0, s])
    vs_bf16 = rel_err(ref[0, s], bf16_ref[0, s])
    print(f"  int8 logits vs the plain path on the dequantized weights, max|d| / max|ref|: "
          f"prefill {err_prefill:.3e}, decode {err_decode:.3e} (tol {PAGED_TOL}); int8 vs bf16 "
          f"weights (quantization error, not gated) {vs_bf16:.3e}", flush=True)
    if not (err_prefill <= PAGED_TOL and err_decode <= PAGED_TOL):
        raise SystemExit("int8 serving disagrees with the plain path on its weights")
    eng.shutdown()
    del eng, state, ref, bf16_ref
    torch.cuda.empty_cache()
    return dict(quantize_s=quant_s, weight_bytes_int8=int8_bytes, weight_bytes_bf16=bf16_bytes,
                solo=solo, launches=launches, prefills=prefills, err_prefill=err_prefill,
                err_decode=err_decode, tol=PAGED_TOL, int8_vs_bf16_rel=vs_bf16)


def verify_check(torch, params, mcfg):
    """The verify window's logits at each of its k+1 positions against the
    decode steps that produce the same positions (a 200-token prompt in slot
    0 of 8, the drafts the decode steps' own greedy picks), in the slot and
    the paged layout (bench_serve's 32-token blocks)."""
    from ray_tpu_torch.llm import model_runner, paged

    slots, max_len, bs, k = 8, PAGED["max_model_len"], PAGED["kv_block_size"], SPEC_K
    ids = random_ids(torch, torch.Generator().manual_seed(13), 200)
    n = len(ids)
    kv, vv, last = model_runner.prefill_detached(params, padded_ids(torch, ids, 256), n, mcfg)
    st = model_runner.install_kv(model_runner.init_state(mcfg, slots, max_len), kv, vv, n, 0)
    pst = paged.init_paged_state(mcfg, slots, max_len, slots * max_len // bs, bs)
    nb = 256 // bs  # the prefill's padded length; covers the window's n + k + 1
    paged.install_prefill(pst, kv, vv, list(range(nb, 2 * nb)), n, 0, nb)
    ref = model_runner.DecodeState(st.k.clone(), st.v.clone(), st.lengths.clone())
    del kv, vv
    active = torch.zeros(slots, dtype=torch.bool, device="cuda")
    active[0] = True
    window, ref_logits = [int(last.argmax())], []
    tokens = torch.zeros(slots, dtype=torch.long, device="cuda")
    for t in range(k + 1):
        tokens[0] = window[-1]
        _, lg = model_runner.decode_step(params, ref, tokens, active, mcfg)
        ref_logits.append(lg[0].clone())
        if t < k:
            window.append(int(lg[0].argmax()))
    win = torch.zeros((slots, k + 1), dtype=torch.long, device="cuda")
    win[0] = torch.tensor(window, device="cuda")
    draft_len = torch.zeros(slots, dtype=torch.long, device="cuda")
    draft_len[0] = k
    sampling = (torch.zeros(slots, device="cuda"), torch.ones(slots, device="cuda"),
                torch.zeros(slots, dtype=torch.long, device="cuda"))
    out = {}
    for layout, fn, state in (("slot", model_runner.spec_verify_step, st),
                              ("paged", paged.spec_verify_step_paged, pst)):
        _, toks, n_acc, logits = fn(params, state, win, draft_len, active, mcfg, *sampling,
                                    return_logits=True)
        torch.cuda.synchronize()
        errs = [rel_err(logits[0, t], ref_logits[t]) for t in range(k + 1)]
        out[layout] = dict(rel_errs=errs, n_acc=int(n_acc[0]), length=int(state.lengths[0]))
        print(f"  verify window of {k + 1} ({layout}) vs {k + 1} decode steps: logits max|d| / "
              f"max|ref| per position {[f'{e:.2e}' for e in errs]} (tol {PAGED_TOL}); the "
              f"decode steps' own greedy drafts accepted {int(n_acc[0])} of {k} (bf16 GEMM "
              f"shapes differ, so not gated)", flush=True)
        if max(errs) > PAGED_TOL or out[layout]["length"] != n + int(n_acc[0]) + 1:
            raise SystemExit(f"the {layout} verify window disagrees with the decode steps")
    del st, pst, ref
    torch.cuda.empty_cache()
    return out


def spec_engine(params, layout, **kw):
    """A llama3-8b engine on `params`: the slot layout's defaults, or
    bench_serve's paged settings with the prefix cache off (so that every
    prefill is whole and launches B1a n_layers times)."""
    from ray_tpu_torch.llm import LLMConfig, TorchLLMEngine

    extra = dict(PAGED, enable_prefix_caching=False) if layout == "paged" else {}
    return TorchLLMEngine(LLMConfig(model_source="llama3-8b", **{**extra, **kw}), params=params)


def run_counted(torch, fa, eng, requests, warmup):
    """Serve `warmup` (one request, untimed) and then `requests` together,
    shut the engine down; B1a must launch n_layers times per prefill."""
    try:
        serve_together(eng, [warmup])
        fa.reset_launch_count()
        prefills0, drafted0, accepted0 = (eng.num_prefills, eng.num_spec_drafted,
                                          eng.num_spec_accepted)
        outs, wall = serve_together(eng, requests)
        torch.cuda.synchronize()
        launches, prefills = fa.launch_count(), eng.num_prefills - prefills0
    finally:
        eng.shutdown()
    n_layers = eng.model_config.n_layers
    if prefills < len(requests) or launches != n_layers * prefills:
        raise SystemExit(f"flash launches {launches} != n_layers {n_layers} x prefills "
                         f"{prefills}")
    drafted = eng.num_spec_drafted - drafted0
    accepted = eng.num_spec_accepted - accepted0
    tokens = sum(len(o.token_ids) for o in outs)
    return dict(tok_s=tokens / wall, wall_s=wall, tokens=tokens, drafted=drafted,
                accepted=accepted, accept_rate=accepted / drafted if drafted else None,
                launches=launches, prefills=prefills, ids=[o.token_ids for o in outs])


def proposer_check(torch):
    """propose_ngram_device on the card against the engine's host proposer
    (_propose_ngram) on planted histories of llama3-8b ids in a 1024-wide
    row at k = 4: 64 random ones over a 6-id alphabet (matches everywhere,
    lengths 1..width-k), distinct ids (no match), lengths 1 and 2,
    overlapping repeats; and against the same function on the CPU (held to
    JAX by tests/test_torch_port_spec.py) on those and on full rows, whose
    drafts start past width - k (the start clamp)."""
    import types

    from ray_tpu_torch.llm import TorchLLMEngine, model_runner

    width, k, nmax = 1024, SPEC_K, 3
    gen = torch.Generator().manual_seed(16)
    alphabet = torch.randint(3, 128000, (6,), generator=gen)
    distinct = torch.randperm(128000, generator=gen)[:width].tolist()
    rows = [alphabet[torch.randint(0, 6, (int(n),), generator=gen)].tolist()
            for n in torch.randint(1, width - k + 1, (64,), generator=gen)]
    rows += [distinct[:500], distinct[:1], distinct[:1] * 2, distinct[:2] * 40,
             distinct[:1] * 300]
    n_host = len(rows)  # histories inside the engine's regime (hlen <= width - k)
    rows += [distinct[:width - 2] + distinct[width - 4:width - 2],  # drafts start at width - 2
             distinct[:3] * (width // 3) + distinct[:width % 3]]
    hist = torch.zeros((len(rows), width), dtype=torch.long)
    for i, r in enumerate(rows):
        hist[i, :len(r)] = torch.tensor(r)
    hlen = torch.tensor([len(r) for r in rows])
    last = hist[torch.arange(len(rows)), hlen - 1]
    window, draft_len = model_runner.propose_ngram_device(hist.cuda(), hlen.cuda(), last.cuda(),
                                                          k, nmax)
    torch.cuda.synchronize()
    window, draft_len = window.cpu(), draft_len.cpu()
    cpu_window, cpu_len = model_runner.propose_ngram_device(hist, hlen, last, k, nmax)
    fake = types.SimpleNamespace(config=types.SimpleNamespace(ngram_prompt_lookup_max=nmax))
    host = [TorchLLMEngine._propose_ngram(fake, types.SimpleNamespace(token_history=r), k)
            for r in rows[:n_host]]
    card = [window[i, 1:1 + int(draft_len[i])].tolist() for i in range(n_host)]
    bad_host = [i for i in range(n_host) if card[i] != host[i] or int(window[i, 0]) != rows[i][-1]]
    same_cpu = torch.equal(window, cpu_window) and torch.equal(draft_len, cpu_len)
    drafted = sum(len(h) for h in host)
    print(f"  propose_ngram_device on the card, {len(rows)} histories of width {width}: "
          f"{n_host - len(bad_host)} of {n_host} equal the host proposer ({drafted} drafts, "
          f"{sum(1 for h in host if not h)} rows without one); all {len(rows)} equal the CPU "
          f"run: {same_cpu}", flush=True)
    if bad_host or not same_cpu or not drafted:
        raise SystemExit(f"propose_ngram_device disagrees: rows {bad_host}, CPU equal {same_cpu}")
    return dict(rows=len(rows), host_rows=n_host, drafted=drafted)


def spec_path(torch, fa, card, params):
    """n-gram speculation at bench_serve's k = 4 on the slot phase's bf16
    weights, in the slot layout and the paged one: the verify window against
    decode steps; the device proposer against the host one; the n-gram
    proposer (host, single-window; device, fused m = 4) on prompts that
    make it draft; and bench_spec_modes (bench_serve.py:277-367, at batch 1
    and 8 of 96 tokens, in f32 as there): the plain engine, fused-only
    m = 8, and the oracle (the plain engine's own greedy continuation as
    drafts, through _propose_ngram and spec_multi's propose_fn seam)
    single-window and fused m = 4, in one call. Every request must finish with its tokens and every
    prefill launch B1a n_layers times."""
    import functools

    from ray_tpu_torch.llm import LLMConfig, SamplingParams, model_runner, paged

    mcfg = LLMConfig(model_source="llama3-8b").resolve_model_config()
    out = {"k": SPEC_K, "verify": verify_check(torch, params, mcfg),
           "proposer": proposer_check(torch)}
    greedy = dict(temperature=0.0, stop_token_ids=[-1])
    warm = ([1, 2, 3], SamplingParams(max_tokens=8, **greedy))
    seeded = [random_ids(torch, torch.Generator().manual_seed(s), 40) for s in NGRAM_SEEDS]
    prompt = [int(x) for x in np.random.default_rng(1).integers(1, 200, 40)]  # bench_spec_modes'
    # bench_spec_modes runs f32 engines: in bf16 a verify window's GEMMs
    # round otherwise than a decode step's, a near-tie flips (its prompt
    # makes many), and the fixed oracle stops matching from the fork on.
    # Weights and activations both f32 (LLMConfig.dtype sets only the
    # weights'). One f32 copy (32 GB) serves every oracle engine: an engine
    # keeps a weight already in its dtype.
    params32 = {name: ({k: v.float() for k, v in val.items()} if name == "layers"
                       else val.float()) for name, val in params.items()}
    for layout in ("slot", "paged"):
        res = {}

        def ngram_requests(prompts):
            return [(p, SamplingParams(max_tokens=NGRAM_GEN, **greedy)) for p in prompts]

        # ---- n-gram: P + C + P, C the plain engine's greedy continuation of
        # P. The first token after it repeats C's first, so the proposer
        # drafts the rest of C; a random model seldom continues it ----
        res["seed_plain"] = run_counted(
            torch, fa, spec_engine(params, layout, max_num_seqs=len(seeded)),
            ngram_requests(seeded), warm)
        looped = [p + c + p for p, c in zip(seeded, res["seed_plain"]["ids"])]
        for mode, kw in (("ngram_plain", {}),
                         ("ngram_single", dict(num_speculative_tokens=SPEC_K,
                                               num_decode_steps=1)),
                         ("ngram_fused_m4", dict(num_speculative_tokens=SPEC_K,
                                                 num_decode_steps=4))):
            res[mode] = run_counted(torch, fa, spec_engine(params, layout,
                                                           max_num_seqs=len(looped), **kw),
                                    ngram_requests(looped), warm)
        # ---- bench_spec_modes' oracle at each batch ----
        owner, name = (model_runner, "spec_multi") if layout == "slot" else \
            (paged, "spec_multi_paged")
        real = getattr(owner, name)
        # the paged layout at the largest batch only: its oracle runs the
        # same spec_multi_paged calls at every batch
        for batch in SPEC_BATCHES if layout == "slot" else SPEC_BATCHES[-1:]:
            reqs = [(prompt, SamplingParams(max_tokens=SPEC_GEN, **greedy))] * batch
            f32 = dict(dtype="float32", engine_kwargs=dict(dtype="float32"),
                       max_num_seqs=batch)
            res[f"b{batch}_plain"] = run_counted(
                torch, fa, spec_engine(params32, layout, **f32), reqs, warm)
            res[f"b{batch}_fused8"] = run_counted(
                torch, fa, spec_engine(params32, layout, num_decode_steps=8, **f32), reqs, warm)
            cont = res[f"b{batch}_plain"]["ids"][0]

            def host_oracle(req, cap, cont=cont):
                done = len(req.token_history) - len(prompt)
                return cont[done:done + cap]

            table = torch.zeros((batch, 1024), dtype=torch.long, device="cuda")
            table[:, :len(prompt) + len(cont)] = torch.tensor(prompt + cont, device="cuda")

            def device_oracle(h, hl, last, k, nmax, table=table):
                starts = hl.clamp(0, table.shape[1] - k)
                idx = starts[:, None] + torch.arange(k, device=h.device)[None, :]
                drafts = torch.gather(table[:h.shape[0]], 1, idx)
                return (torch.cat([last[:, None], drafts], dim=1),
                        torch.full((h.shape[0],), k, dtype=torch.long, device=h.device))

            setattr(owner, name, functools.partial(real, propose_fn=device_oracle))
            try:
                for mode, m in (("oracle_single", 1), ("oracle_fused_m4", 4)):
                    eng = spec_engine(params32, layout, num_speculative_tokens=SPEC_K,
                                      num_decode_steps=m, **f32)
                    eng._propose_ngram = host_oracle
                    res[f"b{batch}_{mode}"] = run_counted(torch, fa, eng, reqs, warm)
            finally:
                setattr(owner, name, real)
        for mode, r in res.items():  # seed_, ngram_, b1_, b8_: each group beside its plain run
            base = res[f"{mode.split('_')[0]}_plain"]
            r["same_ids_as_plain"] = r["ids"] == base["ids"]
            r["vs_plain"] = r["tok_s"] / base["tok_s"]
            if "oracle" in mode:
                r["vs_fused8"] = r["tok_s"] / res[f"{mode.split('_')[0]}_fused8"]["tok_s"]
        for mode, r in res.items():
            rate = "-" if r["accept_rate"] is None else f"{r['accept_rate']:.3f}"
            vs = f", {r['vs_fused8']:.2f}x fused8" if "vs_fused8" in r else ""
            print(f"  spec {layout} {mode}: {r['tokens']} tokens in {r['wall_s']:.3f} s = "
                  f"{r['tok_s']:.2f} tok/s ({r['vs_plain']:.2f}x plain{vs}), accepted "
                  f"{r['accepted']} of {r['drafted']} drafts ({rate}), ids as plain "
                  f"{r['same_ids_as_plain']}, flash launches {r['launches']} over "
                  f"{r['prefills']} prefills [{card}]", flush=True)
        for mode in ("ngram_single", "ngram_fused_m4"):
            if not res[mode]["drafted"]:
                raise SystemExit(f"the n-gram proposer drafted nothing ({layout}, {mode})")
        for mode, r in res.items():  # an oracle drafts the plain continuation: each window
            if "oracle" in mode:  # after the prefill's token drafts SPEC_K, all accepted
                batch = int(mode.split("_")[0][1:])
                least = 0.9 * (r["tokens"] - batch) * SPEC_K / (SPEC_K + 1)
                if r["accepted"] != r["drafted"] or r["drafted"] < least:
                    raise SystemExit(f"{layout} {mode}: the oracle's drafts did not reach the "
                                     f"engine: accepted {r['accepted']} of {r['drafted']}, "
                                     f"want all of at least {least:.0f}")
        for r in res.values():
            del r["ids"]
        out[layout] = res
    del params32
    torch.cuda.empty_cache()
    return out


# the P/D and serving-surface phase (6b): llama3-8b's bf16 weights shared by
# a prefill engine, two decode engines and a colocated one
PD_BUCKETS = (121, 501, 960)  # prompt tokens: buckets 128, 512 and 1024
PD_GEN = 32  # greedy tokens per P/D request
PD_SLOT = dict(max_num_seqs=32, max_model_len=1024,
               prefill_buckets=PAGED["prefill_buckets"])  # the paged step's GEMM widths
SURFACE_GEN = 8  # tokens per router and batch request
# the JAX engine's metrics() keys (ray_tpu/llm/engine.py:851-881), paged ones last
JAX_METRICS_KEYS = ("num_pending", "num_active", "total_generated", "num_preemptions",
                    "num_aborted", "num_spec_drafted", "num_spec_accepted",
                    "num_prefix_skipped", "pd_exports_live", "decode_fused_steps",
                    "decode_host_sync_fraction", "decode_host_rt_ms", "decode_device_step_ms")
JAX_PAGED_METRICS_KEYS = ("kv_blocks_total", "kv_blocks_free", "kv_pool_occupancy",
                          "prefix_cache_hit_tokens", "prefix_cached_blocks")


class _Response:
    """A deployment response stand-in: the call already ran; result() gives
    its value or raises its error."""

    def __init__(self, fn):
        try:
            self._value, self._error = fn(), None
        except Exception as e:  # raised at result(), as a response would
            self._value, self._error = None, e

    def result(self, timeout_s=None):
        if self._error is not None:
            raise self._error
        return self._value


class _Handle:
    """A deployment handle stand-in over an in-process server:
    .options(method_name=, stream=).remote(...) calls the method; a stream
    gives its generator, anything else a response with .result()."""

    def __init__(self, target, method="__call__", stream=False):
        self.target, self.method, self.stream = target, method, stream

    def options(self, method_name=None, stream=False):
        return _Handle(self.target, method_name or self.method, stream)

    def remote(self, *args, **kwargs):
        fn = getattr(self.target, self.method)
        if self.stream:
            return fn(*args, **kwargs)
        return _Response(lambda: fn(*args, **kwargs))


class _ListDataset:
    """A dataset stand-in over a list of row dicts: map, and map_batches over
    dict-of-array batches (a class is built once from fn_constructor_args
    and kept in `stages`), and take_all (the offline algorithms' read)."""

    def __init__(self, rows, stages=None):
        self.rows, self.stages = rows, stages if stages is not None else []

    def take_all(self):
        return list(self.rows)

    def map(self, fn):
        return _ListDataset([fn(dict(r)) for r in self.rows], self.stages)

    def map_batches(self, fn, batch_size=16, fn_constructor_args=(), concurrency=1):
        if isinstance(fn, type):
            fn = fn(*fn_constructor_args)
            self.stages.append(fn)
        rows = []
        for i in range(0, len(self.rows), batch_size):
            chunk = self.rows[i:i + batch_size]
            batch = {}
            for key in chunk[0]:
                col = np.empty(len(chunk), dtype=object)
                for j, r in enumerate(chunk):
                    col[j] = r[key]
                batch[key] = col
            out = fn(batch)
            rows += [{k: v[j] for k, v in out.items()} for j in range(len(chunk))]
        return _ListDataset(rows, self.stages)


def timed_stream(stream, t0):
    """Drain a RequestOutput stream -> (ids, first-token ms from t0, decode
    tokens/s over the tokens after the first, last output)."""
    ids, stamps, out = [], [], None
    for out in stream:
        stamps.append(time.perf_counter())
        ids.extend(out.token_ids)
    tps = (len(ids) - 1) / (stamps[-1] - stamps[0]) if len(stamps) > 1 else None
    return ids, (stamps[0] - t0) * 1e3, tps, out


def installed_kv(torch, eng, n):
    """(k, v) rows 0..n-1 that an engine holds for the request it served last
    in slot 0 (its blocks through the table in the paged layout)."""
    st = eng.state
    if eng.config.kv_layout == "paged":
        bs = eng.config.kv_block_size
        ids = st.block_tables[0, :-(-n // bs)]
        take = lambda pool: pool[:, ids].reshape(pool.shape[0], -1, *pool.shape[3:])[:, :n]
        return take(st.k), take(st.v)
    return st.k[:, 0, :n], st.v[:, 0, :n]


def copy_ms(torch, k, v):
    """Host-to-device and device-to-host ms of a transfer's k and v."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    kd, vd = k.cuda(), v.cuda()
    torch.cuda.synchronize()
    h2d = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    kd.cpu(), vd.cpu()
    d2h = (time.perf_counter() - t) * 1e3
    return h2d, d2h


def pd_engines_check(torch, fa, card, params):
    """P/D disaggregation on the host path and the serving surface, on the
    slot phase's llama3-8b weights shared by every engine: a paged prefill
    engine (bench_serve's settings; weights only), a paged decode engine
    (the same settings), a slot decode engine of 32 slots, and a colocated
    paged engine. Three greedy prompts (buckets 128, 512, 1024) of PD_GEN
    tokens each: P/D-paged, P/D-slot and colocated ids identical, the
    installed KV bit-equal to prefill_only's, B1a n_layers times per
    prefill_only and never on a decode engine. Then OpenAIRouter and
    PDRouter over in-process handles (chat, completions, streamed chat,
    /models; texts equal the engine's), check_health and the metrics keys.
    Every engine is shut down at the end."""
    from ray_tpu_torch.llm import (LLMConfig, LLMServer, OpenAIRouter, PDRouter,
                                   SamplingParams, TorchLLMEngine)
    from ray_tpu_torch.llm.server import render_chat_template

    pcfg = LLMConfig(model_id="llama3-8b", model_source="llama3-8b", **PAGED)
    scfg = LLMConfig(model_id="llama3-8b", model_source="llama3-8b", **PD_SLOT)
    prefill = TorchLLMEngine(pcfg, params=params)
    dec_paged = TorchLLMEngine(pcfg, params=params)
    dec_slot = TorchLLMEngine(scfg, params=params)
    colo = TorchLLMEngine(pcfg, params=params)
    engines = (prefill, dec_paged, dec_slot, colo)
    for eng in engines:
        eng.start()
    for eng in engines[1:]:  # KV state and loop up before any timed request
        eng._ensure_decode_started()
    if any(eng.params["embed"] is not params["embed"] for eng in engines):
        raise SystemExit("the P/D engines do not share one copy of the weights")
    n_layers = prefill.model_config.n_layers
    sampling = SamplingParams(max_tokens=PD_GEN, temperature=0.0, stop_token_ids=[-1])
    gen = torch.Generator().manual_seed(31)
    # one untimed request through each path first: TTFT is then compared warm
    warm_ids, warm = random_ids(torch, gen, 40), SamplingParams(max_tokens=4, temperature=0.0)
    colo.generate_sync(warm_ids, warm)
    for dec in (dec_paged, dec_slot):
        list(dec.generate_from_prefill(prefill.prefill_only(warm_ids, warm), warm))
    runs = []
    for n in PD_BUCKETS:
        ids = random_ids(torch, gen, n)
        bucket = next(b for b in pcfg.buckets() if b >= n)
        r = dict(prompt_tokens=n, bucket=bucket)
        t0 = time.perf_counter()
        (want, r["colo_ttft_ms"], r["colo_tok_s"], _), r["colo_launches"], _ = counted(
            torch, fa, colo, lambda: timed_stream(colo.generate(ids, sampling), t0))
        for name, dec in (("paged", dec_paged), ("slot", dec_slot)):
            t0 = time.perf_counter()
            pre, launches, _ = counted(torch, fa, prefill,
                                       lambda: prefill.prefill_only(ids, sampling))
            prefill_ms = (time.perf_counter() - t0) * 1e3
            (got, ttft, tps, last), dec_launches, _ = counted(
                torch, fa, dec, lambda: timed_stream(dec.generate_from_prefill(pre, sampling),
                                                     t0))
            k_in, v_in = installed_kv(torch, dec, n)
            row_bytes = 2 * pre["k"][:, :, :1].nbytes  # k and v of one position
            kv_equal = (torch.equal(k_in, pre["k"][:, 0, :n].cuda())
                        and torch.equal(v_in, pre["v"][:, 0, :n].cuda()))
            h2d, d2h = copy_ms(torch, pre["k"], pre["v"])
            r[name] = dict(ids_equal=got == want, kv_equal=kv_equal, prefill_ms=prefill_ms,
                           prefill_launches=launches, decode_launches=dec_launches,
                           ttft_ms=ttft, decode_tok_s=tps, tokens=len(got),
                           kv_bytes=pre["k"].nbytes + pre["v"].nbytes,
                           kv_bytes_untrimmed=row_bytes * bucket, h2d_ms=h2d, d2h_ms=d2h,
                           finish_reason=last.finish_reason, first_token=pre["first_token"])
            del pre
        runs.append(r)
        for name in ("paged", "slot"):
            x = r[name]
            print(f"  P/D {name}, prompt {n} tokens (bucket {bucket}): prefill_only "
                  f"{x['prefill_ms']:.2f} ms ({x['prefill_launches']} B1a launches), KV "
                  f"{x['kv_bytes']} bytes shipped against {x['kv_bytes_untrimmed']} untrimmed, "
                  f"h2d {x['h2d_ms']:.2f} ms, d2h {x['d2h_ms']:.2f} ms; TTFT {x['ttft_ms']:.2f} "
                  f"ms against colocated {r['colo_ttft_ms']:.2f} ms; decode "
                  f"{x['decode_tok_s']:.2f} tok/s (colocated {r['colo_tok_s']:.2f}), "
                  f"{x['decode_launches']} B1a launches on the decode engine; ids equal "
                  f"{x['ids_equal']}, installed KV bit-equal {x['kv_equal']} [{card}]",
                  flush=True)
    bad = [(r["prompt_tokens"], name) for r in runs for name in ("paged", "slot")
           if not (r[name]["ids_equal"] and r[name]["kv_equal"]
                   and r[name]["prefill_launches"] == n_layers
                   and r[name]["decode_launches"] == 0 and r[name]["tokens"] == PD_GEN)]
    if bad or any(r["colo_launches"] != n_layers for r in runs):
        raise SystemExit(f"P/D disagrees with the colocated engine (ids, KV or B1a launches): "
                         f"{bad}, colocated launches {[r['colo_launches'] for r in runs]}")
    if dec_paged.num_prefills or dec_slot.num_prefills:
        raise SystemExit("a decode engine computed a prefill")

    # ---- the serving surface over in-process handles ----
    servers = dict(prefill=LLMServer(pcfg, engine=prefill),
                   colo=LLMServer(pcfg, engine=colo))
    servers["decode"] = LLMServer(pcfg, engine=dec_paged,
                                  prefill_handle=_Handle(servers["prefill"]))
    routers = dict(openai=OpenAIRouter(**{"llama3-8b": _Handle(servers["colo"])}),
                   pd=PDRouter(_Handle(servers["prefill"]), _Handle(servers["decode"]),
                               "llama3-8b"))
    body = dict(max_tokens=SURFACE_GEN, temperature=0.0, model="llama3-8b")
    messages = [{"role": "user", "content": prompt_text(200)}]
    text_prompt = prompt_text(300)
    greedy = SamplingParams(max_tokens=SURFACE_GEN, temperature=0.0)
    direct = dict(chat=colo.generate_sync(render_chat_template(messages), greedy),
                  completions=colo.generate_sync(text_prompt, greedy))
    surface = {}
    for name, router in routers.items():
        chat = router.chat(dict(body, messages=messages))
        comp = router.completions(dict(body, prompt=text_prompt))
        frames = list(router.handle_http({"path": "/v1/chat/completions",
                                          "body": dict(body, messages=messages, stream=True)}))
        streamed = "".join(json.loads(f[len("data: "):])["choices"][0]["delta"].get(
            "content", "") for f in frames[:-1])
        models = router.handle_http({"path": "/v1/models"})
        ok = (chat["choices"][0]["message"]["content"] == direct["chat"].text
              and chat["usage"]["completion_tokens"] == len(direct["chat"].token_ids)
              and comp["choices"][0]["text"] == direct["completions"].text
              and comp["usage"]["completion_tokens"] == len(direct["completions"].token_ids)
              and frames[-1] == "data: [DONE]\n\n" and streamed == direct["chat"].text
              and [m["id"] for m in models["data"]] == ["llama3-8b"])
        surface[name] = dict(ok=ok, frames=len(frames), chat_tokens=chat["usage"][
            "completion_tokens"], completion_tokens=comp["usage"]["completion_tokens"])
        print(f"  {type(router).__name__}: chat, completions, streamed chat ({len(frames)} "
              f"frames, ending in [DONE]) and /models equal the engine's: {ok}", flush=True)
    keys_ok = {}
    for name, srv in servers.items():
        srv.check_health()
        # the pool's keys once it exists (a prefill-only engine has none)
        want_keys = set(JAX_METRICS_KEYS) | (
            set(JAX_PAGED_METRICS_KEYS) if srv.engine._blocks is not None else set())
        keys_ok[name] = set(srv.metrics()) == want_keys
    m = servers["decode"].metrics()
    print(f"  check_health passes on every server; metrics() keys equal the JAX engine's "
          f"{keys_ok}; decode engine: fused steps {m['decode_fused_steps']}, host sync "
          f"fraction {m['decode_host_sync_fraction']}, host rt {m['decode_host_rt_ms']} ms, "
          f"device step {m['decode_device_step_ms']} ms [{card}]", flush=True)
    if not all(s["ok"] for s in surface.values()) or not all(keys_ok.values()):
        raise SystemExit(f"the serving surface disagrees: {surface}, metrics keys {keys_ok}")
    if set(dec_slot.metrics()) != set(JAX_METRICS_KEYS):
        raise SystemExit("the slot engine's metrics() keys are not the JAX engine's")

    for eng in engines:
        eng.shutdown()
    return dict(runs=runs, surface=surface, metrics_keys=keys_ok, decode_metrics=m,
                launches=sum(r[name]["prefill_launches"] for r in runs
                             for name in ("paged", "slot")))


def batch_check(torch, card, params):
    """build_llm_processor over a list-backed dataset of 8 chat prompts
    against generate_sync on `params`: its engine draws the seeded weights
    itself (seed 0, as phase 3's server did)."""
    from ray_tpu_torch.llm import (LLMConfig, SamplingParams, TorchLLMEngine,
                                   build_llm_processor)
    from ray_tpu_torch.llm.server import render_chat_template

    bcfg = LLMConfig(model_id="llama3-8b", model_source="llama3-8b")
    topics = [prompt_text(40 + 37 * i) for i in range(8)]
    bsampling = {"max_tokens": SURFACE_GEN, "temperature": 0.0}
    dataset = _ListDataset([{"topic": t} for t in topics])
    processor = build_llm_processor(
        bcfg, sampling_params=bsampling, batch_size=8, has_messages=True,
        preprocess=lambda r: dict(r, messages=[{"role": "user", "content": r["topic"]}]))
    t0 = time.perf_counter()
    rows = processor(dataset).rows
    batch_s = time.perf_counter() - t0
    for stage in dataset.stages:
        stage.engine.shutdown()
    ref = TorchLLMEngine(bcfg, params=params)
    want, _ = run_together(lambda i: ref.generate_sync(
        render_chat_template([{"role": "user", "content": topics[i]}]),
        SamplingParams(**bsampling)), len(topics))
    ref.shutdown()
    batch_ok = ([r["generated_text"] for r in rows] == [w.text for w in want]
                and [int(r["num_generated_tokens"]) for r in rows]
                == [len(w.token_ids) for w in want])
    print(f"  build_llm_processor over 8 prompts in {batch_s:.2f} s: texts and token counts "
          f"equal generate_sync's {batch_ok} [{card}]", flush=True)
    if not batch_ok:
        raise SystemExit("the batch processor disagrees with generate_sync")
    return dict(ok=batch_ok, wall_s=batch_s)


def pd_path(torch, fa, card, params):
    """Phase 6b: pd_engines_check, then batch_check; each frees its engines
    as it returns, and the phase must leave no more than 1 GiB allocated
    (phase 9 needs < 2 GiB)."""
    import gc

    held0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = pd_engines_check(torch, fa, card, params)
    gc.collect()
    torch.cuda.empty_cache()
    out["batch"] = batch_check(torch, card, params)
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    left = torch.cuda.memory_allocated() - held0
    print(f"  phase 6b took {out['wall_s']:.1f} s and left {left / 2**30:.3f} GiB allocated",
          flush=True)
    if left > 2**30:
        raise SystemExit(f"the P/D phase left {left / 2**30:.2f} GiB allocated")
    return out




# the MoE phase: mixtral-8x7b with int8 weights on one card (its bf16
# weights, 93.4 GB, do not fit the card's 80 GB)
MOE = dict(model_source="mixtral-8x7b", quantization="int8", max_num_seqs=8, max_model_len=1024)
MOE_NODROP = 4.0  # capacity factor at which C = T: no pick is dropped, prefill == decode
MOE_STEPS = 8  # greedy decode steps of the no-drop check
MOE_GEN = 16  # tokens per served MoE request
MOE_START_PEAK_GIB = 60.0


def moe_ids(torch, gen, n, vocab=32000):
    """n token ids inside mixtral's vocabulary, from a CPU generator."""
    return torch.randint(3, vocab, (n,), generator=gen).tolist()


def counted(torch, fa, eng, fn):
    """fn() with the B1a count zeroed just before and read just after ->
    (fn's result, B1a launches, prefills the engine ran)."""
    torch.cuda.synchronize()
    fa.reset_launch_count()
    prefills0 = eng.num_prefills
    out = fn()
    torch.cuda.synchronize()
    return out, fa.launch_count(), eng.num_prefills - prefills0


def moe_consistency(torch, params, mcfg, dtype):
    """The no-drop regime (capacity factor MOE_NODROP, where C = T, the
    regime in which tests/test_moe.py:76-94 holds prefill and decode equal):
    a 64-token prompt prefilled (through B1a) and MOE_STEPS greedy decode
    steps in the slot layout, the same tokens through the paged prefill and
    decode step (32-token blocks), against llama.forward over the whole
    sequence with plain attention; activations in `dtype`, the same int8
    weights. -> max|d| / max|ref| per position, per layout."""
    from ray_tpu_torch.llm import model_runner, paged
    from ray_tpu_torch.models import llama

    cfg = dataclasses.replace(mcfg, moe_capacity_factor=MOE_NODROP, dtype=dtype)
    ids = moe_ids(torch, torch.Generator().manual_seed(22), 64)
    n = len(ids)
    active = torch.tensor([False, True], device="cuda")
    with torch.no_grad():
        state = model_runner.init_state(cfg, 2, 128)
        state, last = model_runner.prefill(params, state, padded_ids(torch, ids, n), n, 1, cfg)
        slot, toks = [last], [int(last.argmax())]
        for _ in range(MOE_STEPS):
            _, lg = model_runner.decode_step(params, state, torch.tensor([0, toks[-1]],
                                                                         device="cuda"),
                                             active, cfg)
            slot.append(lg[1])
            toks.append(int(lg[1].argmax()))
        del state
        pstate = paged.init_paged_state(cfg, 2, 128, 4, 32)
        k, v, plast = model_runner.prefill_detached(params, padded_ids(torch, ids, n), n, cfg)
        paged.install_prefill(pstate, k, v, [0, 1], n, 1, 2)
        paged.append_block(pstate, 1, 2, 2)
        pag = [plast]
        for t in range(MOE_STEPS):
            _, lg = paged.decode_step_paged(params, pstate, torch.tensor([0, toks[t]], device="cuda"),
                                            active, cfg)
            pag.append(lg[1])
        del pstate, k, v
        ref, _ = llama.forward(params, torch.tensor([ids + toks[:MOE_STEPS]], device="cuda"),
                               dataclasses.replace(cfg, attention_impl="reference"))
    torch.cuda.synchronize()
    out = {layout: [rel_err(got[t], ref[0, n - 1 + t]) for t in range(MOE_STEPS + 1)]
           for layout, got in (("slot", slot), ("paged", pag))}
    finite = all(bool(torch.isfinite(x).all()) for x in slot + pag)
    del ref
    torch.cuda.empty_cache()
    return out, finite


def moe_layer_breakdown(torch, params, mcfg, tokens):
    """One layer's MoE MLP of the served model at `tokens` tokens, by CUDA
    events: the whole moe_mlp; the dequant of its three int8 expert stacks;
    the three expert GEMMs on the dequantized weights; the dispatch and
    combine einsums ([T, E, C] against [T, D] and [E, C, D]); the rest
    (routing, the one-hot dispatch masks, SiLU) is the difference."""
    from ray_tpu_torch.models import llama, moe
    from ray_tpu_torch.ops.quant import as_weight

    bf16 = torch.bfloat16
    lp = llama.layer_params(params, 0)
    e, d, c = mcfg.n_experts, mcfg.d_model, moe.expert_capacity(mcfg, tokens)
    gen = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn(tokens, d, generator=gen, device="cuda").to(bf16)
    names = ("w_gate", "w_up", "w_down")
    with torch.no_grad():
        whole = time_ms(lambda: moe.moe_mlp(x, lp["router"], *(lp[k] for k in names), mcfg),
                        iters=10)
        dequant = time_ms(lambda: [as_weight(lp[k], bf16) for k in names], iters=10)
        wg, wu, wd = (as_weight(lp[k], bf16) for k in names)
        xin = torch.randn(e, c, d, generator=gen, device="cuda").to(bf16)
        act = torch.randn(e, c, mcfg.d_ff, generator=gen, device="cuda").to(bf16)
        gemm = time_ms(lambda: (torch.einsum("ecd,edf->ecf", xin, wg),
                                torch.einsum("ecd,edf->ecf", xin, wu),
                                torch.einsum("ecf,efd->ecd", act, wd)), iters=10)
        disp = (torch.rand(tokens, e, c, generator=gen, device="cuda") < 2.0 / (e * c)).to(bf16)
        dispatch = time_ms(lambda: (torch.einsum("tec,td->ecd", disp, x),
                                    torch.einsum("tec,ecd->td", disp, xin)), iters=10)
    del wg, wu, wd, xin, act, disp
    torch.cuda.empty_cache()
    return dict(tokens=tokens, capacity=c, whole_ms=whole, dequant_ms=dequant, gemm_ms=gemm,
                dispatch_ms=dispatch, rest_ms=whole - dequant - gemm - dispatch)


def moe_tie_check(torch, mcfg):
    """Router ties on the card pick the lower expert first, as jax.lax.top_k
    does: a row of equal probabilities takes experts 0 and 1, and a row with
    three equal maxima its first two."""
    from ray_tpu_torch.models import moe

    e = mcfg.n_experts
    probs = torch.full((2, e), 1.0 / e, device="cuda")
    probs[1] = 0.5 / (e - 3)
    probs[1, [1, 3, 5]] = 0.5 / 3
    _, idx = moe.top_k(probs, mcfg.moe_top_k)
    got, want = idx.tolist(), [[0, 1], [1, 3]]
    print(f"  router ties on the card: experts {got} (want {want}, jax.lax.top_k's order)",
          flush=True)
    if got != want:
        raise SystemExit("router ties do not pick the lower expert first")
    return got


def moe_path(torch, fa, card):
    """mixtral-8x7b at full width and depth (32 layers, 8 experts, top-2,
    d 4096, d_ff 14336, GQA 32/8) with int8 weights on one card: the engine
    starts it in int8 without holding its bf16 copy; the no-drop check; 3
    solo greedy requests (buckets 128 / 512 / 1024) and 4 concurrent ones in
    the slot layout; one n-gram speculative request (k = 4) on P + C + P;
    on the same weights the paged layout with bench_serve's settings (a
    cold prompt, a warm one sharing a 512-token prefix, a chunked one); a
    profile of one 8-slot decode step and one 512-token prefill, and one
    layer's MoE MLP by part. B1a launches n_layers times per whole prefill
    and never for a suffix or a chunk; every request finishes with its
    tokens."""
    from ray_tpu_torch.llm import LLMConfig, SamplingParams, TorchLLMEngine

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    if held > 2 * 2**30:
        raise SystemExit(f"{held / 2**30:.2f} GiB still allocated before the MoE phase")
    eng = TorchLLMEngine(LLMConfig(**MOE))
    mcfg, n_layers = eng.model_config, eng.model_config.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.start()
    torch.cuda.synchronize()
    start_s = time.perf_counter() - t0
    start_peak = torch.cuda.max_memory_allocated() / 2**30
    int8_bytes = tree_bytes(eng.params)
    bf16_bytes = 2 * param_count(torch, mcfg)
    print(f"  {mcfg.name} started in int8 in {start_s:.2f} s (seeded init, each layer "
          f"quantized as drawn): weights {int8_bytes / 1e9:.3f} GB int8 against "
          f"{bf16_bytes / 1e9:.3f} GB bf16 ({int8_bytes / bf16_bytes:.3f}); peak during start "
          f"{start_peak:.2f} GiB (limit {MOE_START_PEAK_GIB}) [{card}]", flush=True)
    if start_peak >= MOE_START_PEAK_GIB:
        raise SystemExit("the int8 start held more than the int8 model and one layer")
    out = dict(start_s=start_s, start_peak_gib=start_peak, weight_bytes_int8=int8_bytes,
               weight_bytes_bf16=bf16_bytes, tol=PAGED_TOL, ties=moe_tie_check(torch, mcfg))

    # ---- the no-drop check: f32 activations gated, bf16 reported ----
    for dtype in ("float32", "bfloat16"):
        errs, finite = moe_consistency(torch, eng.params, mcfg, dtype)
        out[f"nodrop_{dtype}"] = errs
        print(f"  no-drop (capacity factor {MOE_NODROP}), {dtype} activations, int8 weights: "
              f"prefill + {MOE_STEPS} decode logits vs llama.forward max|d| / max|ref|, slot "
              f"{[f'{e:.2e}' for e in errs['slot']]}, paged "
              f"{[f'{e:.2e}' for e in errs['paged']]} (tol {PAGED_TOL}"
              f"{'' if dtype == 'float32' else ', not gated: top-2 near-ties flip in bf16'})",
              flush=True)
        if not finite or (dtype == "float32" and max(errs["slot"] + errs["paged"]) > PAGED_TOL):
            raise SystemExit("MoE prefill and decode disagree with the whole forward")

    # ---- served requests, default capacity ----
    greedy = dict(temperature=0.0, stop_token_ids=[-1])
    gen = torch.Generator().manual_seed(21)
    launches = 0
    solo, n, prefills = counted(torch, fa, eng, lambda: [
        solo_request(eng, eng.tokenizer.encode(prompt_text(c)), MOE_GEN)
        for c in (120, 500, 1000)])
    for r in solo:
        print(f"  mixtral int8, solo prompt {r['prompt_tokens']} tokens: TTFT "
              f"{r['ttft_ms']:.2f} ms, decode {r['decode_tok_s']:.2f} tok/s over {r['tokens']} "
              f"tokens [{card}]", flush=True)
    if prefills != 3 or n != n_layers * prefills:
        raise SystemExit(f"solo: flash launches {n} over {prefills} prefills")
    launches += n
    reqs = [(moe_ids(torch, gen, m), SamplingParams(max_tokens=MOE_GEN, **greedy))
            for m in (40, 100, 200, 300)]
    (_, wall), n, prefills = counted(torch, fa, eng, lambda: serve_together(eng, reqs))
    print(f"  4 concurrent requests: {4 * MOE_GEN} tokens in {wall:.3f} s = "
          f"{4 * MOE_GEN / wall:.2f} tok/s aggregate, flash launches {n} over {prefills} "
          f"prefills [{card}]", flush=True)
    if prefills != 4 or n != n_layers * prefills:
        raise SystemExit(f"concurrent: flash launches {n} over {prefills} prefills")
    launches += n
    out.update(solo=solo, concurrent=dict(wall_s=wall, tok_s=4 * MOE_GEN / wall))
    # by kind: GEMMs ("matmul"), dtype converts and other copies ("copy", the
    # dequant's int8 -> bf16), the rest ("other": the dequant's scale
    # products, routing, norms)
    out["profile"] = where_time_goes(torch, eng)
    out["layer"] = [moe_layer_breakdown(torch, eng.params, mcfg, t) for t in (8, 512)]
    for r in out["layer"]:
        print(f"  one layer's MoE MLP at {r['tokens']} tokens (C {r['capacity']}): whole "
              f"{r['whole_ms']:.3f} ms = dequant of 3 expert stacks {r['dequant_ms']:.3f} + "
              f"expert GEMMs {r['gemm_ms']:.3f} + dispatch/combine einsums "
              f"{r['dispatch_ms']:.3f} + routing and the rest {r['rest_ms']:.3f} [{card}]",
              flush=True)

    # ---- n-gram speculation, k = 4, on P + C + P ----
    p_ids = moe_ids(torch, gen, 40)
    c_ids = eng.generate_sync(p_ids, SamplingParams(max_tokens=MOE_GEN, **greedy)).token_ids
    eng.shutdown()
    params = eng.params
    seng = TorchLLMEngine(LLMConfig(**MOE, num_speculative_tokens=SPEC_K, num_decode_steps=1),
                          params=params)
    try:
        spec, n, prefills = counted(torch, fa, seng, lambda: solo_request(
            seng, p_ids + c_ids + p_ids, MOE_GEN))
    finally:
        seng.shutdown()
    spec.update(drafted=seng.num_spec_drafted, accepted=seng.num_spec_accepted)
    print(f"  n-gram speculation k={SPEC_K} on P + C + P ({spec['prompt_tokens']} tokens): "
          f"TTFT {spec['ttft_ms']:.2f} ms, {spec['decode_tok_s']:.2f} tok/s, accepted "
          f"{spec['accepted']} of {spec['drafted']} drafts, flash launches {n} [{card}]",
          flush=True)
    if prefills != 1 or n != n_layers or not spec["drafted"]:
        raise SystemExit(f"speculation: drafted {spec['drafted']}, flash launches {n}")
    launches += n
    out["spec"] = spec
    del seng

    # ---- paged, bench_serve's settings: cold, warm (512-token prefix), chunked ----
    peng = TorchLLMEngine(LLMConfig(**dict(MOE, **PAGED)), params=params)
    prefix = moe_ids(torch, gen, 512)
    paged_runs = []
    try:
        for kind, ids in (("cold", moe_ids(torch, gen, 501)),
                          ("prefix_cold", prefix + moe_ids(torch, gen, 64)),
                          ("prefix_warm", prefix + moe_ids(torch, gen, 64))):
            hits0 = peng.metrics().get("prefix_cache_hit_tokens", 0)
            r, n, prefills = counted(torch, fa, peng, lambda: solo_request(peng, ids, MOE_GEN))
            r.update(kind=kind, launches=n, prefills=prefills,
                     hit_tokens=peng.metrics()["prefix_cache_hit_tokens"] - hits0)
            paged_runs.append(r)
    finally:
        peng.shutdown()
    del peng
    ceng = TorchLLMEngine(LLMConfig(**dict(MOE, **dict(PAGED, num_kv_blocks=64)),
                                    prefill_chunk=256), params=params)
    try:
        r, n, prefills = counted(torch, fa, ceng, lambda: solo_request(
            ceng, moe_ids(torch, gen, 700), MOE_GEN))
    finally:
        ceng.shutdown()
    del ceng
    r.update(kind="chunked", launches=n, prefills=prefills, hit_tokens=0)
    paged_runs.append(r)
    for r in paged_runs:
        print(f"  paged {r['kind']}: prompt {r['prompt_tokens']} tokens, hit {r['hit_tokens']}, "
              f"TTFT {r['ttft_ms']:.2f} ms, decode {r['decode_tok_s']:.2f} tok/s, flash "
              f"launches {r['launches']} [{card}]", flush=True)
    got = [(r["hit_tokens"], r["launches"]) for r in paged_runs]
    want = [(0, n_layers), (0, n_layers), (512, 0), (0, 0)]
    if got != want:
        raise SystemExit(f"paged MoE: (hit tokens, flash launches) {got}, want {want}")
    launches += sum(r["launches"] for r in paged_runs)
    out.update(paged=paged_runs, launches=launches)
    del params, eng
    torch.cuda.empty_cache()
    return out


# the checkpoint phases (A, B): each writes a directory, reads it back and
# removes it
MOE_TRAIN_BATCHES = (6, 4, 3, 2, 1)  # B at S2048: the first that fits the card trains
MOE_TRAIN_STEPS = 4  # timed steps after one warm-up step
MOE_TRAIN_GEN = 16  # tokens per request served from the trained checkpoint
CKPT_START_SLACK = 2**30  # an int8 start may hold 1 GiB beyond int8 + one layer slice


def checkpoint_dir(nbytes):
    """A fresh directory with room for 2 x nbytes: under the temp directory,
    else under build/ in the checkout; exits when neither has the room."""
    import shutil
    import tempfile

    roots = (tempfile.gettempdir(), os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                 "build"))
    for root in roots:
        os.makedirs(root, exist_ok=True)
        free = shutil.disk_usage(root).free
        print(f"  {root}: {free / 1e9:.1f} GB free, {2 * nbytes / 1e9:.1f} GB wanted",
              flush=True)
        if free >= 2 * nbytes:
            return tempfile.mkdtemp(prefix="ckpt-", dir=root)
    raise SystemExit(f"no room for a checkpoint of {nbytes / 1e9:.1f} GB under {roots}")


def same_weights(torch, a, b):
    """Two parameter dicts with the same leaves, bit for bit (an int8
    QTensor by its q and s), in the same dtypes."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.quant import QTensor

    if set(a) != set(b) or set(a["layers"]) != set(b["layers"]):
        return False
    for x, y in zip(llama.tree_leaves(a), llama.tree_leaves(b)):
        xs, ys = (list(x) if isinstance(x, QTensor) else [x],
                  list(y) if isinstance(y, QTensor) else [y])
        if len(xs) != len(ys) or any(u.dtype != v.dtype or u.shape != v.shape
                                     or not torch.equal(u, v) for u, v in zip(xs, ys)):
            return False
    return True


def checkpoint_serve_path(torch, fa, card, params, served):
    """Phase A: phase 3's llama3-8b weights written as HF's release lays them
    out (bf16, 4 shards and an index, config.json), loaded back, and served
    from the directory by LLMServer: the loaded and the engine's weights
    bit-equal to phase 3's, the greedy ids of phase 3's solo prompts
    identical, B1a n_layers times per prefill."""
    import shutil

    from ray_tpu_torch.llm import LLMConfig, LLMServer, SamplingParams
    from ray_tpu_torch.models import checkpoint
    from ray_tpu_torch.models.config import get_config

    cfg = get_config("llama3-8b")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    nbytes = tree_bytes(params)
    print(f"  phase A starts holding {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"(phase 3's weights, {nbytes / 1e9:.2f} GB)", flush=True)
    root = checkpoint_dir(nbytes)
    try:
        t0 = time.perf_counter()
        written = release_layout(torch, params, cfg, root)
        write_s = time.perf_counter() - t0
        files = sorted(f for f in os.listdir(root) if f.endswith(".safetensors"))
        file_bytes = sum(os.path.getsize(os.path.join(root, f)) for f in files)
        print(f"  wrote {written / 1e9:.3f} GB of bf16 tensors as {files} ({file_bytes} bytes "
              f"with headers) in {write_s:.2f} s = {written / write_s / 1e9:.2f} GB/s (to the "
              f"page cache, not synced) [{card}]", flush=True)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = checkpoint.load_llama_params(root, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_same = same_weights(torch, loaded, params)
        del loaded
        torch.cuda.empty_cache()
        print(f"  load_llama_params: {written / 1e9:.3f} GB in {load_s:.2f} s = "
              f"{written / load_s / 1e9:.2f} GB/s (files just written: from the page cache); "
              f"bit-equal to phase 3's weights: {load_same} [{card}]", flush=True)
        if not load_same:
            raise SystemExit("the loaded llama3-8b weights differ from the ones written")

        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        server = LLMServer(LLMConfig(model_source=root))
        torch.cuda.synchronize()
        start_s = time.perf_counter() - t0
        start_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        eng = server.engine
        engine_same = same_weights(torch, eng.params, params)
        print(f"  LLMServer(model_source=<dir>) up in {start_s:.2f} s, peak during the start "
              f"{start_peak:.2f} GiB against the weights' {nbytes / 2**30:.2f} GiB "
              f"({nbytes / 1e9:.2f} GB); engine weights bit-equal to phase 3's: "
              f"{engine_same} [{card}]", flush=True)
        if not engine_same:
            raise SystemExit("the engine's weights from the checkpoint differ from phase 3's")

        want = {r["n_chars"]: r["token_ids"] for r in reversed(served["solo"])}
        ids = {}
        fa.reset_launch_count()
        prefills0 = eng.num_prefills
        # ---- served from the directory: counts zeroed just before, read just after ----
        for n_chars in SOLO_CHARS:
            out = eng.generate_sync(eng.tokenizer.encode(prompt_text(n_chars)), SamplingParams(
                max_tokens=SOLO_GEN, temperature=0.0, stop_token_ids=[-1]))
            ids[n_chars] = out.token_ids
        torch.cuda.synchronize()
        launches, prefills = fa.launch_count(), eng.num_prefills - prefills0
        # ---- end ----
        repeats_agree = all(r["token_ids"] == want[r["n_chars"]] for r in served["solo"])
        same_ids = all(ids[n] == want[n] for n in SOLO_CHARS)
        print(f"  3 greedy prompts of {list(SOLO_CHARS)} chars x {SOLO_GEN} tokens: ids identical to "
              f"phase 3's: {same_ids} (phase 3's {SOLO_REPEATS} repeats agree: "
              f"{repeats_agree}); flash launches {launches} over {prefills} prefills, n_layers "
              f"{cfg.n_layers}", flush=True)
        if not same_ids or prefills != len(SOLO_CHARS) or launches != cfg.n_layers * prefills:
            raise SystemExit("serving from the checkpoint differs from phase 3")
        server.shutdown()
        del server, eng
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    print(f"  phase A took {wall:.1f} s", flush=True)
    return dict(bytes=written, file_bytes=file_bytes, files=files, write_s=write_s,
                write_gb_s=written / write_s / 1e9, load_s=load_s,
                load_gb_s=written / load_s / 1e9, start_s=start_s, start_peak_gib=start_peak,
                weights_gib=nbytes / 2**30, launches=launches, prefills=prefills,
                ids_identical=same_ids, phase3_repeats_agree=repeats_agree, wall_s=wall)


def param_count(torch, cfg):
    """Parameters of the model `cfg` describes, from its leaves' shapes."""
    from ray_tpu_torch.models import llama

    return sum(int(torch.Size(shape).numel())
               for val in llama.param_shapes(cfg).values()
               for shape in (val.values() if isinstance(val, dict) else [val]))


def active_params(cfg):
    """Parameters a token goes through (embedding and head counted, as
    ModelConfig.n_params counts them): attention, norms, the router and
    top_k of the n_experts expert MLPs."""
    d = cfg.d_model
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    attn = d * cfg.head_dim * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    mlp = cfg.moe_top_k * 3 * d * cfg.d_ff + d * cfg.n_experts
    return emb + cfg.n_layers * (attn + mlp + 2 * d) + d


def moe_step_profile(torch, cfg, step, state, batch):
    """torch.profiler over one train step (shapes recorded): device ms by
    kind, and the matrix products by part. A product with a dimension of
    E*C (one group's expert slots) is a dispatch or combine einsum, forward
    or backward; one batched over the E experts with C rows is an expert
    GEMM. Device time is each aten::bmm / aten::mm op's, its kernels
    included."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import moe

    tokens = batch["tokens"].shape[0] * (batch["tokens"].shape[1] - 1)
    g = moe._group_size(tokens)
    c, e = moe.expert_capacity(cfg, g), cfg.n_experts
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, by_kind = 0.0, {}
    for evt in prof.key_averages():
        dev_us = evt.self_device_time_total
        if dev_us > 0 and str(getattr(evt, "device_type", "")).endswith("CUDA"):
            busy += dev_us / 1e3
            kind = next((kind for kind, marks in KERNEL_KINDS
                         if any(m in evt.key for m in marks)), "other")
            by_kind[kind] = by_kind.get(kind, 0.0) + dev_us / 1e3
    parts = {"dispatch_combine": 0.0, "expert_gemms": 0.0, "other_products": 0.0}
    for evt in prof.key_averages(group_by_input_shape=True):
        if evt.key not in ("aten::bmm", "aten::mm"):
            continue
        shapes = [list(s) for s in evt.input_shapes if s]
        dims = [x for s in shapes for x in s]
        if e * c in dims:
            part = "dispatch_combine"
        elif shapes and len(shapes[0]) == 3 and shapes[0][0] == e and c in dims:
            part = "expert_gemms"
        else:
            part = "other_products"
        parts[part] += evt.device_time_total / 1e3
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy, busy_share=busy / (wall * 1e3),
                by_kind=by_kind, products_ms=parts, tokens=tokens, group=g, capacity=c,
                shares={k: v / busy for k, v in parts.items()} if busy else None)


def moe_train_path(torch, fa, card):
    """Phase B (A3c): mixtral-8x7b's geometry at 2 layers trained on the card
    with make_train_step at B6 S2048 with remat dots (the batch cut, never a
    width, if it does not fit), after its f32 gradients through the kernels
    against the plain path; then saved with save_llama_params, loaded back
    in f32, warm-started with init_state(checkpoint_dir=...), and served in
    int8 from the directory."""
    import gc
    import shutil

    from ray_tpu_torch.llm import LLMConfig, LLMServer
    from ray_tpu_torch.models import checkpoint, llama
    from ray_tpu_torch.models.config import get_config
    from ray_tpu_torch.ops.quant import quantize_llama_params
    from ray_tpu_torch.train import TrainState, init_state, make_optimizer, make_train_step

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"  phase B starts holding {held / 2**30:.2f} GiB", flush=True)
    if held > 2 * 2**30:
        raise SystemExit(f"{held / 2**30:.2f} GiB still allocated before the MoE training phase")
    # mixtral's widths at 2 of 32 layers: d 4096, 8 experts of d_ff 14336,
    # top-2, capacity factor 1.25, vocab 32000; bf16 activations
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=2, remat_policy="dots")
    n_params = param_count(torch, cfg)
    n_active = active_params(cfg)
    out = dict(n_params=n_params, n_active=n_active)
    print(f"  {cfg.name} at {cfg.n_layers} layers: {n_params / 1e9:.3f}B parameters "
          f"({16 * n_params / 2**30:.1f} GiB of f32 parameters, gradients and Adam moments), "
          f"{n_active / 1e9:.3f}B active per token", flush=True)

    # ---- gradients through the kernels against the plain path, f32, B1 S256 ----
    out["numerics"] = train_numerics(torch, fa, cfg)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- training: the first batch of MOE_TRAIN_BATCHES that fits ----
    tx = make_optimizer(warmup_steps=2, total_steps=1000)
    step = make_train_step(cfg, tx)
    s = TRAIN_SHAPE["s"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (MOE_TRAIN_BATCHES[0], s + 1), generator=gen,
                           device="cuda")
    state = warm = None
    for b in MOE_TRAIN_BATCHES:
        try:
            t0 = time.perf_counter()
            state = init_state(cfg, tx, seed=0)
            batch = {"tokens": tokens[:b]}
            state, m = step(state, batch)  # warm-up: count 0, lr = 0
            warm = dict(loss=m["loss"].item(), grad_norm=m["grad_norm"].item(),
                        s=time.perf_counter() - t0)
            break
        except torch.cuda.OutOfMemoryError as e:
            print(f"  B{b} S{s} does not fit the card ({str(e).splitlines()[0][:120]}): "
                  "the batch is cut", flush=True)
            state = m = None
        gc.collect()
        torch.cuda.empty_cache()
    if warm is None:
        raise SystemExit("no batch of the MoE training fits the card")
    print(f"  B{b} S{s} ({b * s} tokens a step{'' if b == MOE_TRAIN_BATCHES[0] else ', cut from B6'}),"
          f" remat dots, bf16 activations; warm-up step (lr 0, with init): loss "
          f"{warm['loss']:.6f}, grad_norm {warm['grad_norm']:.6f}, {warm['s']:.2f} s", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_count()
    # ---- the MoE training path: counts zeroed just before, read just after ----
    steps = []
    for _ in range(MOE_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        steps.append(dict(loss=m["loss"].item(), ce_loss=m["ce_loss"].item(),
                          moe_aux_loss=m["moe_aux_loss"].item(),
                          grad_norm=m["grad_norm"].item(), step_s=time.perf_counter() - t0))
    launches = {name: fa.launch_count(name) for name in fa.KERNELS}
    # ---- end of the MoE training path ----
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for i, r in enumerate(steps):
        print(f"  step {i + 1}: loss {r['loss']:.6f} (ce {r['ce_loss']:.6f}, aux "
              f"{r['moe_aux_loss']:.6f}), grad_norm {r['grad_norm']:.6f}, "
              f"{r['step_s'] * 1e3:.2f} ms", flush=True)
    step_s = statistics.median(r["step_s"] for r in steps)
    tok_s = b * s / step_s
    mfu = 6 * n_active * tok_s / PEAK_BF16_FLOPS
    want = launches_per_step(cfg.n_layers)
    print(f"  median step {step_s * 1e3:.2f} ms, {tok_s:.1f} tokens/s, 6*N_active*tokens/s "
          f"over {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s (MFU on active parameters) {mfu:.4f}; "
          f"peak device memory {peak_gib:.2f} GiB; launches over {MOE_TRAIN_STEPS} steps "
          f"{launches}, per step expected {want} [{card}]", flush=True)
    if any(launches[k] != MOE_TRAIN_STEPS * n for k, n in want.items()):
        raise SystemExit(f"launch counts {launches} != {MOE_TRAIN_STEPS} x {want}: the MoE "
                         "training path did not run through the kernels as expected")
    finite = all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in steps)
    if not finite or not steps[-1]["loss"] < steps[0]["loss"]:
        raise SystemExit(f"MoE training did not run clean: losses {[r['loss'] for r in steps]}")
    prof = moe_step_profile(torch, cfg, step, state, batch)
    shares = prof["shares"] or {}
    print(f"  one step profiled: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['device_busy_ms']:.2f} ms ({100 * prof['busy_share']:.1f}%), by kind "
          f"{ {k: round(v, 3) for k, v in prof['by_kind'].items()} }; T {prof['tokens']} in "
          f"groups of {prof['group']}, C {prof['capacity']}: dispatch and combine einsums "
          f"{prof['products_ms']['dispatch_combine']:.3f} ms "
          f"({100 * shares.get('dispatch_combine', float('nan')):.1f}% of busy), expert GEMMs "
          f"{prof['products_ms']['expert_gemms']:.3f} ms "
          f"({100 * shares.get('expert_gemms', float('nan')):.1f}%), other products "
          f"{prof['products_ms']['other_products']:.3f} ms [{card}]", flush=True)
    out.update(batch=b, seq=s, warmup=warm, steps=steps, step_ms=step_s * 1e3,
               tokens_per_s=tok_s, mfu_active=mfu, peak_gib=peak_gib, launches=launches,
               profile=prof)

    # ---- save, load, warm start ----
    params = state.params
    state = m = None
    gc.collect()
    torch.cuda.empty_cache()
    root = checkpoint_dir(4 * n_params)
    try:
        t0 = time.perf_counter()
        checkpoint.save_llama_params(params, cfg, root)
        save_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(os.path.join(root, "model.safetensors"))
        t0 = time.perf_counter()
        loaded = checkpoint.load_llama_params(root, device="cuda", dtype=torch.float32)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_same = same_weights(torch, loaded, params)
        del loaded
        torch.cuda.empty_cache()
        print(f"  save_llama_params: {file_bytes / 1e9:.3f} GB (f32, one file) in {save_s:.2f} s "
              f"= {file_bytes / save_s / 1e9:.2f} GB/s; load_llama_params in f32 in "
              f"{load_s:.2f} s = {file_bytes / load_s / 1e9:.2f} GB/s; bit-equal to the trained "
              f"parameters: {load_same} [{card}]", flush=True)
        if not load_same:
            raise SystemExit("the loaded MoE checkpoint differs from the trained parameters")

        # One card holds two f32 copies of the parameters and one optimizer
        # state, not two states: the step from the trained parameters with a
        # fresh optimizer state goes first. Its update has lr 0 (the warm-up
        # starts at 0), so the parameters keep their values, which the
        # comparison with the warm start then checks.
        one = {"tokens": tokens[:1]}
        m = step(TrainState(0, params, tx.init(llama.tree_leaves(params))), one)[1]
        loss_fresh = m["loss"].item()
        m = None
        gc.collect()
        torch.cuda.empty_cache()
        warm_state = init_state(cfg, tx, checkpoint_dir=root)
        warm_same = same_weights(torch, warm_state.params, params) and all(
            p.requires_grad for p in llama.tree_leaves(warm_state.params))
        params = None
        gc.collect()
        torch.cuda.empty_cache()
        loss_warm = step(warm_state, one)[1]["loss"].item()
        warm_state = None
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  init_state(checkpoint_dir=...): parameters bit-equal to the trained ones with "
              f"requires_grad: {warm_same}; B1 S{s} step loss {loss_warm:.9f} against "
              f"{loss_fresh:.9f} from the trained parameters with a fresh optimizer state "
              f"[{card}]", flush=True)
        if not warm_same or loss_warm != loss_fresh:
            raise SystemExit("the warm start differs from the trained parameters")

        # ---- served in int8 from the directory ----
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        server = LLMServer(LLMConfig(model_source=root, quantization="int8"))
        torch.cuda.synchronize()
        start_s = time.perf_counter() - t0
        start_peak = torch.cuda.max_memory_allocated() - base
        eng = server.engine
        int8_bytes = tree_bytes(eng.params)
        slice_bytes = max(2 * int(torch.Size(v[1:]).numel())
                          for v in llama.param_shapes(eng.model_config)["layers"].values())
        limit = int8_bytes + slice_bytes + CKPT_START_SLACK
        want_q = quantize_llama_params(
            checkpoint.load_llama_params(root, device="cuda", dtype=torch.bfloat16))
        int8_same = same_weights(torch, eng.params, want_q)
        del want_q
        torch.cuda.empty_cache()
        print(f"  LLMServer(model_source=<dir>, quantization='int8') up in {start_s:.2f} s: "
              f"weights {int8_bytes / 1e9:.3f} GB, peak during the start "
              f"{start_peak / 2**30:.3f} GiB (limit int8 + one bf16 layer slice "
              f"{slice_bytes / 1e9:.3f} GB + 1 GiB = {limit / 2**30:.3f} GiB); int8 leaves and "
              f"scales bit-equal to quantize_llama_params of the bf16 load: {int8_same} [{card}]",
              flush=True)
        if not int8_same or start_peak >= limit:
            raise SystemExit("the int8 start from the checkpoint is not load-then-quantize "
                             "within its peak")
        reqs, n, prefills = counted(torch, fa, eng, lambda: [
            solo_request(eng, eng.tokenizer.encode(prompt_text(c)), MOE_TRAIN_GEN)
            for c in SOLO_CHARS])
        chat = server.chat({"messages": [{"role": "user", "content": prompt_text(200)}],
                            "max_tokens": MOE_TRAIN_GEN, "temperature": 0.0})
        for r in reqs:
            print(f"  int8 from the checkpoint, prompt {r['prompt_tokens']} tokens: TTFT "
                  f"{r['ttft_ms']:.2f} ms, decode {r['decode_tok_s']:.2f} tok/s over "
                  f"{r['tokens']} tokens [{card}]", flush=True)
        print(f"  chat: {chat['usage']}, finish {chat['choices'][0]['finish_reason']}; flash "
              f"launches {n} over {prefills} prefills", flush=True)
        if prefills != len(SOLO_CHARS) or n != cfg.n_layers * prefills or \
                chat["usage"]["completion_tokens"] < 1:
            raise SystemExit("serving the trained MoE checkpoint in int8 failed")
        server.shutdown()
        del server, eng
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    print(f"  phase B took {wall:.1f} s", flush=True)
    out.update(save_s=save_s, file_bytes=file_bytes, load_s=load_s, loss_warm=loss_warm,
               loss_fresh=loss_fresh, int8_start_s=start_s, int8_start_peak_gib=start_peak / 2**30,
               int8_start_limit_gib=limit / 2**30, int8_bytes=int8_bytes, served=reqs,
               launches_serving=n, wall_s=wall)
    return out


# phase R: RLlib PPO on the card (A9). bench_rllib.py's geometries: the
# learner of _tpu_learner_body (bench_rllib.py:232-274) and bench_ppo's
# settings on its Atari-shaped env (bench_rllib.py:30-121, 311-313).
RL_LEARNER = dict(obs_dim=64, n_actions=6, hiddens=[256, 256], batch=4096, minibatch=1024,
                  epochs=1, timed=20)
RL_PPO = dict(runners=2, envs=4, fragment=64, train_batch=512, minibatch=128, epochs=2,
              lr=3e-4, gamma=0.99, lambda_=0.95, clip_param=0.3, entropy_coeff=0.01,
              iters=12)
RL_SCAN_BLOCK = (64, 1024)  # [T, B]
RL_LEARNER_TOL = 1e-4  # card against CPU, f32, per leaf of max|ref| (update_against_cpu)
RL_SCAN_TOL = 1e-5  # card against CPU, of max|ref|


class Box:
    """gymnasium.spaces.Box's shape and, where given, its bounds: all a
    module reads of it (the card's machine has no gymnasium)."""

    def __init__(self, shape, low=None, high=None):
        self.shape = tuple(shape)
        if low is not None:
            self.low = np.broadcast_to(np.asarray(low, np.float32), self.shape).copy()
            self.high = np.broadcast_to(np.asarray(high, np.float32), self.shape).copy()


class Discrete:
    def __init__(self, n):
        self.n = int(n)


class SyntheticAtariEnv:
    """bench_rllib.py's SyntheticAtariEnv: Atari-shaped observations at
    CartPole cost, random uint8 frames stamped from a pre-generated bank,
    fixed-length episodes, reward 1 for action 1."""

    def __init__(self, config=None):
        config = config or {}
        self.observation_space = Box((84, 84, 4))
        self.action_space = Discrete(6)
        self.ep_len = int(config.get("ep_len", 200))
        self._bank = np.random.default_rng(0).integers(
            0, 255, size=(16, 84, 84, 4), dtype=np.uint8)
        self._t = 0

    def reset(self, *, seed=None, options=None):
        self._t = 0
        return self._bank[0], {}

    def step(self, action):
        self._t += 1
        obs = self._bank[self._t % len(self._bank)]
        done = self._t >= self.ep_len
        return obs, float(action == 1), done, False, {}

    def close(self):
        pass

    @classmethod
    def make_vec(cls, num_envs, config=None):
        return SyntheticAtariVectorEnv(num_envs, config)


class SyntheticAtariVectorEnv:
    """bench_rllib.py's SyntheticAtariVectorEnv: one numpy-batched step for
    all envs, with gymnasium 1.x next-step autoreset (a done env's next step
    ignores the action and returns the new episode's first obs, reward 0)."""

    def __init__(self, num_envs, config=None):
        config = config or {}
        self.num_envs = int(num_envs)
        self.ep_len = int(config.get("ep_len", 200))
        self._bank = np.random.default_rng(0).integers(
            0, 255, size=(16, 84, 84, 4), dtype=np.uint8)
        self._t = np.zeros(self.num_envs, dtype=np.int64)
        self._needs_reset = np.zeros(self.num_envs, dtype=bool)

    def reset(self, *, seed=None, options=None):
        self._t[:] = 0
        self._needs_reset[:] = False
        return np.broadcast_to(
            self._bank[0], (self.num_envs,) + self._bank.shape[1:]).copy(), {}

    def step(self, actions):
        actions = np.asarray(actions)
        resetting = self._needs_reset
        self._t = np.where(resetting, 0, self._t + 1)
        obs = self._bank[self._t % len(self._bank)]
        rewards = np.where(resetting, 0.0, (actions == 1).astype(np.float64))
        term = np.where(resetting, False, self._t >= self.ep_len)
        trunc = np.zeros(self.num_envs, dtype=bool)
        self._needs_reset = term.copy()
        return obs, rewards, term, trunc, {}

    def close(self):
        pass


class SyncVectorEnv:
    """gymnasium 1.x's SyncVectorEnv over a list of envs: one step of each in
    turn, next-step autoreset (a done env's next step resets it, ignores its
    action and returns reward 0), reset(seed=s) seeding env i with s + i."""

    def __init__(self, envs):
        self.envs = envs
        self.num_envs = len(envs)
        self._autoreset = np.zeros(self.num_envs, dtype=bool)

    def reset(self, *, seed=None, options=None):
        seeds = [None if seed is None else seed + i for i in range(self.num_envs)]
        obs = [env.reset(seed=s)[0] for env, s in zip(self.envs, seeds)]
        self._autoreset[:] = False
        return np.stack(obs), {}

    def step(self, actions):
        obs, rewards = [], np.zeros(self.num_envs, np.float64)
        terms, truncs = np.zeros(self.num_envs, bool), np.zeros(self.num_envs, bool)
        for i, env in enumerate(self.envs):
            if self._autoreset[i]:
                o, _ = env.reset()
            else:
                o, rewards[i], terms[i], truncs[i], _ = env.step(actions[i])
            obs.append(o)
        self._autoreset = terms | truncs
        return np.stack(obs), rewards, terms, truncs, {}

    def close(self):
        pass


class CartPole:
    """gymnasium's CartPole-v1 (envs/classic_control/cartpole.py), copied:
    Euler steps of the cart-pole dynamics in f64, termination past 12 degrees
    or 2.4 units, reward 1 a step, f32 observations, and TimeLimit's
    truncation at 500 steps. reset(seed=s) draws the state as gymnasium's
    seeded np_random does (default_rng(s))."""

    max_episode_steps = 500

    def __init__(self, config=None):
        self.gravity, self.masscart, self.masspole = 9.8, 1.0, 0.1
        self.total_mass = self.masspole + self.masscart
        self.length = 0.5  # actually half the pole's length
        self.polemass_length = self.masspole * self.length
        self.force_mag, self.tau = 10.0, 0.02
        self.theta_threshold_radians = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4
        self.observation_space = Box((4,))
        self.action_space = Discrete(2)
        self.np_random = np.random.default_rng()
        self.state, self._elapsed = None, 0

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self.np_random = np.random.default_rng(seed)
        self.state = self.np_random.uniform(low=-0.05, high=0.05, size=(4,))
        self._elapsed = 0
        return np.array(self.state, dtype=np.float32), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot) * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta) / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(x < -self.x_threshold or x > self.x_threshold
                          or theta < -self.theta_threshold_radians
                          or theta > self.theta_threshold_radians)
        self._elapsed += 1
        return (np.array(self.state, dtype=np.float32), 1.0, terminated,
                self._elapsed >= self.max_episode_steps, {})

    def close(self):
        pass

    @classmethod
    def make_vec(cls, num_envs, config=None):
        return SyncVectorEnv([cls(config) for _ in range(num_envs)])


class Pendulum(CartPole):
    """gymnasium's Pendulum-v1 (envs/classic_control/pendulum.py), copied:
    g 10.0, m 1, l 1, max speed 8, max torque 2, dt 0.05, reward
    -(normalized angle^2 + 0.1 speed^2 + 0.001 torque^2), observations
    (cos, sin, speed) in f32, and TimeLimit's truncation at 200 steps."""

    max_episode_steps = 200

    def __init__(self, config=None):
        self.max_speed, self.max_torque, self.dt = 8, 2.0, 0.05
        self.g, self.m, self.l = 10.0, 1.0, 1.0
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.observation_space = Box((3,), -high, high)
        self.action_space = Box((1,), -self.max_torque, self.max_torque)
        self.np_random = np.random.default_rng()
        self.state, self._elapsed = None, 0

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self.np_random = np.random.default_rng(seed)
        high = np.array([np.pi, 1.0])
        self.state = self.np_random.uniform(low=-high, high=high)
        self._elapsed = 0
        return self._get_obs(), {}

    def step(self, u):
        th, thdot = self.state  # th := theta
        g, m, l, dt = self.g, self.m, self.l, self.dt
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        costs = (((th + np.pi) % (2 * np.pi)) - np.pi) ** 2 + 0.1 * thdot**2 + 0.001 * (u**2)
        newthdot = thdot + (3 * g / (2 * l) * np.sin(th) + 3.0 / (m * l**2) * u) * dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * dt
        self.state = np.array([newth, newthdot])
        self._elapsed += 1
        return self._get_obs(), -costs, False, self._elapsed >= self.max_episode_steps, {}

    def _get_obs(self):
        theta, thetadot = self.state
        return np.array([np.cos(theta), np.sin(theta), thetadot], dtype=np.float32)


def leaf_errors(got, want):
    """max|got - want| over max|want| for each leaf of two numpy trees; a
    leaf whose reference is all zero (a target's untouched bias) is 0 when
    got is zero too, else inf."""
    from ray_tpu_torch.rllib.core.rl_module import tree_leaves

    out = []
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        diff, scale = float(np.max(np.abs(g - w))), float(np.max(np.abs(w)))
        out.append(diff / scale if scale else (0.0 if diff == 0 else math.inf))
    return out


def update_against_cpu(card_l, cpu_l, batch):
    """`update(batch)` on the card's learner, then on the CPU's, where each
    optimizer step of the CPU's takes the card's gradients of that step.
    Returns the worst per-leaf error (of max|ref|) of every step's gradients,
    the card's against the CPU's own at the same parameters; the same of the
    state after the update (params, adam's moments, targets), which then
    holds the optimizer and the target syncs on equal inputs; and both
    updates' metrics.

    The two free-running updates are not compared: adam's step
    lr * m / (sqrt(v) + eps) turns the f32 rounding of a gradient element
    near 0 into a step difference of up to lr, so two correct f32 updates of
    a leaf that starts at 0 (a bias) can differ by more than 1e-4 of its
    max|ref|; and adam's first step, sign(g) * lr, hides a gradient's scale.
    Gradients, and the optimizer on equal gradients, are each
    well-conditioned."""
    card_grads, grad_errs = [], []

    def card_step(mbatch, *args, _grads=card_l._grads):
        loss, aux, grads = _grads(mbatch, *args)
        card_grads.append([g.detach().cpu().clone() for g in grads])
        return loss, aux, grads

    def cpu_step(mbatch, *args, _grads=cpu_l._grads):
        loss, aux, grads = _grads(mbatch, *args)
        want = card_grads[len(grad_errs)]
        grad_errs.append(leaf_errors([g.numpy() for g in want], [g.numpy() for g in grads]))
        return loss, aux, [g.clone() for g in want]

    card_l._grads, cpu_l._grads = card_step, cpu_step
    try:
        m_card, m_cpu = card_l.update(batch), cpu_l.update(batch)
    finally:
        del card_l._grads, cpu_l._grads
    if len(grad_errs) != len(card_grads):
        raise SystemExit(f"the card took {len(card_grads)} optimizer steps, the CPU "
                         f"{len(grad_errs)}")
    got, want = card_l.get_state(), cpu_l.get_state()
    keys = [k for k in ("params", "opt_state", "target_params") if k in want]
    state_errs = [e for k in keys
                  for e in leaf_errors(got[k], want[k])]
    return dict(grad_err=max(max(e) for e in grad_errs), state_err=max(state_errs),
                steps=len(grad_errs), m_card=m_card, m_cpu=m_cpu)


def rl_learner_path(torch, card):
    """R1: PPOLearner at _tpu_learner_body's geometry on the card: one update
    against the port's own CPU run of it (f32, TF32 off; update_against_cpu),
    then timed updates and one update under torch.profiler."""
    from ray_tpu_torch.rllib import PPOConfig, PPOLearner
    from ray_tpu_torch.rllib.core.rl_module import Columns, RLModuleSpec

    g = RL_LEARNER
    spec = RLModuleSpec(observation_space=Box((g["obs_dim"],)),
                        action_space=Discrete(g["n_actions"]),
                        model_config={"fcnet_hiddens": g["hiddens"]})

    def learner(device):
        cfg = (PPOConfig().training(lr=3e-4, train_batch_size=g["batch"],
                                    minibatch_size=g["minibatch"], num_epochs=g["epochs"])
               .learners(device=device).debugging(seed=0))
        out = PPOLearner(cfg, spec)
        out.build()
        return out

    rng = np.random.default_rng(0)
    n = g["batch"]
    batch = {
        Columns.OBS: rng.standard_normal((n, g["obs_dim"])).astype(np.float32),
        Columns.ACTIONS: rng.integers(0, g["n_actions"], n).astype(np.int32),
        Columns.ACTION_LOGP: np.full((n,), -np.log(g["n_actions"]), np.float32),
        Columns.ADVANTAGES: rng.standard_normal(n).astype(np.float32),
        Columns.VALUE_TARGETS: rng.standard_normal(n).astype(np.float32),
    }
    card_learner, cpu_learner = learner("cuda"), learner("cpu")
    if not all(p.is_cuda for p in card_learner._leaves + card_learner.opt_state.mu):
        raise SystemExit("R1: the learner's parameters or optimizer state are not on the card")
    cmp = update_against_cpu(card_learner, cpu_learner, batch)
    m_card, m_cpu = cmp["m_card"], cmp["m_cpu"]
    print(f"  R1 one update on the card against the CPU: worst leaf of max|ref| over "
          f"{cmp['steps']} steps' gradients {cmp['grad_err']:.3e}, of the state after it "
          f"{cmp['state_err']:.3e} (limit {RL_LEARNER_TOL}); total_loss "
          f"{m_card['total_loss']:.6f} vs {m_cpu['total_loss']:.6f}", flush=True)
    if (max(cmp["grad_err"], cmp["state_err"]) > RL_LEARNER_TOL
            or not all(math.isfinite(v) for v in m_card.values())):
        raise SystemExit(f"R1: the card's update differs from the CPU's: {cmp}")
    steps = g["timed"] * (n // g["minibatch"]) * g["epochs"]
    card_learner.update(batch)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(g["timed"]):
        card_learner.update(batch)  # each ends with the metrics read-back
    dt = time.perf_counter() - t0
    update_ms = dt / steps * 1e3
    print(f"  R1 learner: {update_ms:.3f} ms per minibatch update, {steps / dt:.1f} updates/s "
          f"over {g['timed']} updates of {n} rows in minibatches of {g['minibatch']} [{card}]",
          flush=True)
    prof = profile_once(torch, "R1 one learner update", lambda: card_learner.update(batch))
    return dict(max_grad_err=cmp["grad_err"], max_leaf_err=cmp["state_err"],
                total_loss_card=m_card["total_loss"],
                total_loss_cpu=m_cpu["total_loss"], minibatch_update_ms=update_ms,
                updates_per_s=steps / dt, profile=prof, geometry=dict(g))


def rl_ppo_path(torch, fa, card):
    """R2: PPO on the Atari-shaped env with bench_ppo's settings: the learner
    on the card, the runners on the host; 1 warm-up and RL_PPO['iters'] timed
    iterations; the policy must learn."""
    from ray_tpu_torch.rllib import PPOConfig

    g = RL_PPO
    cfg = (PPOConfig().environment(SyntheticAtariEnv)
           .env_runners(num_env_runners=g["runners"], num_envs_per_env_runner=g["envs"],
                        rollout_fragment_length=g["fragment"])
           .training(lr=g["lr"], train_batch_size=g["train_batch"],
                     minibatch_size=g["minibatch"], num_epochs=g["epochs"], gamma=g["gamma"],
                     lambda_=g["lambda_"], clip_param=g["clip_param"],
                     entropy_coeff=g["entropy_coeff"])
           .debugging(seed=0))
    algo = cfg.build_algo()
    try:
        learner = algo.learner_group.learners[0]
        if learner.device.type != "cuda" or not all(p.is_cuda for p in learner._leaves):
            raise SystemExit("R2: the learner is not on the card")
        learner_s, action1 = [], []
        update = algo.learner_group.update

        def timed_update(batch):
            action1.append(float(np.mean(batch["actions"] == 1)))
            t = time.perf_counter()
            out = update(batch)  # ends with the metrics read-back: the card is done
            learner_s.append(time.perf_counter() - t)
            return out

        algo.learner_group.update = timed_update
        results = [algo.train()]  # warm-up
        torch.cuda.synchronize()
        fa.reset_launch_count()
        learner_s.clear()  # the warm-up's action share stays: the random policy's
        t0 = time.perf_counter()
        for _ in range(g["iters"]):
            results.append(algo.train())
        dt = time.perf_counter() - t0
        flash = {k: fa.launch_count(k) for k in fa.KERNELS}
        weights = algo.get_weights()
        bank0 = SyntheticAtariEnv()._bank[0]
        logits = algo._module.apply_np(weights, bank0[None])["action_dist_inputs"][0]
    finally:
        algo.stop()
    timed = results[1:]
    env_steps = sum(r["num_env_steps_trained"] for r in timed)
    updates = sum(int(r["minibatch_steps"]) for r in timed)
    returns = [r.get("episode_return_mean") for r in results]
    first = next((i for i, r in enumerate(returns) if r is not None), None)
    last3 = returns[-3:]
    p = np.exp(logits - logits.max())
    p1 = float(p[1] / p.sum())
    out = dict(iters=g["iters"], wall_s=dt, env_steps=env_steps,
               env_steps_per_s=env_steps / dt, updates=updates, updates_per_s=updates / dt,
               learner_s=sum(learner_s), learner_share=sum(learner_s) / dt,
               iteration_ms=dt / g["iters"] * 1e3, returns=returns, first_return_iter=first,
               action1_share=action1, p_action1_frame0=p1, flash_launches=flash,
               settings=dict(g))
    print(f"  R2 PPO: {g['iters']} iterations in {dt:.3f} s: {env_steps / dt:.1f} env steps/s, "
          f"{updates / dt:.1f} learner updates/s, learner {100 * out['learner_share']:.1f}% of "
          f"an iteration ({out['iteration_ms']:.1f} ms) [{card}]", flush=True)
    print(f"  R2 episode_return_mean by iteration (warm-up first): {returns}; share of action "
          f"1 in each train batch: {[round(a, 4) for a in action1]}; P(action 1 | frame 0) = "
          f"{p1:.4f}; flash launches {flash}", flush=True)
    if first is None or None in last3 or not np.mean(last3) > returns[first]:
        raise SystemExit(f"R2: the policy did not learn: returns {returns}")
    # episode_return_mean is the return of an episode's last chunk (the
    # runner's semantics), and those chunks grow from one episode to the next
    # (8, 17, 26, 35 steps here), so it rises under a random policy too. The
    # share of the rewarded action in the batch does not: a random policy
    # keeps it at 1/6.
    if not action1[-1] > max(2 * action1[0], 1 / 3):
        raise SystemExit(f"R2: the share of action 1 did not grow: {action1}")
    if not p1 > 1 / 6:
        raise SystemExit(f"R2: P(action 1 | frame 0) = {p1}, not above 1/6")
    if any(flash.values()):
        raise SystemExit(f"R2: PPO launched a flash kernel: {flash}")
    return out


def rl_scan_check(torch, card):
    """R3: gae_scan and vtrace_block on a [64, 1024] block on the card against
    their CPU runs, and their time on the card."""
    from ray_tpu_torch.rllib.utils import gae_scan, vtrace_block

    rng = np.random.default_rng(0)
    shape = RL_SCAN_BLOCK
    host = dict(rewards=rng.standard_normal(shape).astype(np.float32),
                values=rng.standard_normal(shape).astype(np.float32),
                boot_values=rng.standard_normal(shape).astype(np.float32),
                terminated=(rng.random(shape) < 0.02).astype(np.float32),
                truncated=(rng.random(shape) < 0.01).astype(np.float32))
    rhos = np.exp(0.5 * rng.standard_normal(shape)).astype(np.float32)
    dev = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    rhos_dev = torch.from_numpy(rhos).cuda()
    kw = dict(gamma=0.99, lambda_=0.95)
    runs = {"gae_scan": (lambda: gae_scan(**dev, **kw), lambda: gae_scan(**host, **kw)),
            "vtrace_block": (lambda: vtrace_block(**dev, rhos=rhos_dev, **kw),
                             lambda: vtrace_block(**host, rhos=rhos, **kw))}
    out = {}
    for name, (on_card, on_cpu) in runs.items():
        got, want = on_card(), on_cpu()
        errs = [float((g.cpu() - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
        ms = time_ms(on_card)
        out[name] = dict(errs=errs, ms=ms)
        print(f"  R3 {name} [{shape[0]}, {shape[1]}]: card vs CPU {max(errs):.3e} of max|ref| "
              f"(limit {RL_SCAN_TOL}); {ms:.3f} ms on the card [{card}]", flush=True)
        if not all(g.is_cuda for g in got) or max(errs) > RL_SCAN_TOL:
            raise SystemExit(f"R3: {name} on the card differs from the CPU: {errs}")
    return out


def rl_path(torch, fa, card):
    """Phase R: R1, R2 and R3."""
    t0 = time.perf_counter()
    out = {"learner": rl_learner_path(torch, card), "ppo": rl_ppo_path(torch, fa, card),
           "scans": rl_scan_check(torch, card)}
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase R took {out['wall_s']:.1f} s", flush=True)
    return out


# phase O: RLlib's off-policy and offline algorithms on the card (A9e, A9f).
# O1 builds each learner at bench_rllib's learner widths (obs 64, fcnet [256,
# 256], bench_rllib.py:232-274) with its algorithm's default batch; O2-O4
# are tests/test_dqn.py:98-112,135-141, tests/test_sac.py:53-60 and
# tests/test_offline_rl.py:13-34,81-97,130-155 uncut, on chip_smoke's numpy
# copies of CartPole-v1 and Pendulum-v1.
RL_OFF_GEOM = dict(obs_dim=64, hiddens=[256, 256], n_actions=6, act_dim=6, timed=20)
RL_OFF_TOL = 1e-4  # card against CPU, f32, per leaf of max|ref| (update_against_cpu)
RL_DQN = dict(runners=2, envs=4, fragment=64, lr=1e-3, gamma=0.99, batch=128,
              capacity=20_000, learning_starts=500, target_freq=50, epsilon=(1.0, 0.05),
              epsilon_timesteps=3000, updates=64, steps=512, iters=20)
RL_DQN_PRIORITIZED = dict(runners=1, envs=2, fragment=32, batch=32, learning_starts=100,
                          updates=4, steps=128, iters=3)
RL_SAC = dict(runners=2, envs=2, fragment=64, lr=1e-3, batch=256, learning_starts=500,
              updates=256, steps=256, iters=13, eval_steps=800)


def _off_learner(name, dev):
    """O1's learner `name` on `dev` and a seeded batch for it: DQN (Discrete(6),
    batch 64, with and without prioritized weights), SAC and CQL (Box(6) in
    [-1, 1], batch 256; CQL with its defaults, 4 actions, min_q_weight 5.0, in
    a BC and a SAC update) and MARWIL (Discrete(6), batch 512, beta 1)."""
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib.core.rl_module import DQNModule, MLPModule, RLModuleSpec, SACModule

    g = RL_OFF_GEOM
    discrete = name.startswith(("dqn", "marwil"))
    act_space = Discrete(g["n_actions"]) if discrete else Box((g["act_dim"],), -1.0, 1.0)
    config, learner_cls, module_cls, b = {
        "dqn": (rllib.DQNConfig(), rllib.DQNLearner, DQNModule, 64),
        "dqn_prioritized": (rllib.DQNConfig(), rllib.DQNLearner, DQNModule, 64),
        "sac": (rllib.SACConfig(), rllib.SACLearner, SACModule, 256),
        "cql_bc": (rllib.CQLConfig(), rllib.CQLLearner, SACModule, 256),
        "cql_sac": (rllib.CQLConfig().training(bc_iters=0), rllib.CQLLearner, SACModule, 256),
        "marwil": (rllib.MARWILConfig(), rllib.MARWILLearner, MLPModule, 512),
    }[name]
    config = (config.training(train_batch_size=b)
              .rl_module(model_config={"fcnet_hiddens": g["hiddens"]})
              .learners(device=dev).debugging(seed=0))
    spec = RLModuleSpec(module_class=module_cls, observation_space=Box((g["obs_dim"],)),
                        action_space=act_space, model_config=config.model_config)
    learner = learner_cls(config, spec)
    learner.build()
    rng = np.random.default_rng(0)
    batch = {"obs": rng.standard_normal((b, g["obs_dim"])).astype(np.float32),
             "next_obs": rng.standard_normal((b, g["obs_dim"])).astype(np.float32),
             "actions": (rng.integers(0, g["n_actions"], b) if discrete else
                         rng.uniform(-1, 1, (b, g["act_dim"])).astype(np.float32)),
             "rewards": rng.standard_normal(b).astype(np.float32),
             "dones": (rng.random(b) < 0.1).astype(np.float32)}
    if name == "dqn_prioritized":
        batch["weights"] = rng.uniform(0.2, 1.0, b).astype(np.float32)
        batch["batch_indexes"] = np.arange(b, dtype=np.int64)
    if name == "marwil":
        batch["returns_to_go"] = rng.standard_normal(b).astype(np.float32)
    return learner, batch


def rl_off_learner_path(torch, card, dev="cuda"):
    """O1: each off-policy learner's update on the card against the same
    update on the CPU (the same batch and the same noise tensors), then
    RL_OFF_GEOM['timed'] updates timed on the host clock (each ends in its
    read-back) and one update under torch.profiler."""
    out = {}
    for name in ("dqn", "dqn_prioritized", "sac", "cql_bc", "cql_sac", "marwil"):
        card_l, batch = _off_learner(name, dev)
        cpu_l, _ = _off_learner(name, "cpu")
        if not all(p.device.type == torch.device(dev).type
                   for p in card_l._leaves + card_l.opt_state.mu):
            raise SystemExit(f"O1 {name}: the learner's parameters or optimizer state are "
                             "not on the card")
        if hasattr(cpu_l, "draw_noise"):  # the same noise on both sides
            noise = cpu_l.draw_noise(len(batch["obs"]))
            cpu_l.draw_noise = lambda _b, n=noise: n
            card_l.draw_noise = lambda _b, n={k: v.to(dev) for k, v in noise.items()}: n
        cmp = update_against_cpu(card_l, cpu_l, batch)
        m_card, m_cpu = cmp["m_card"], cmp["m_cpu"]
        losses_finite = all(math.isfinite(v) for k, v in m_card.items() if not k.startswith("_"))
        print(f"  O1 {name}: one update on the card against the CPU: worst leaf of max|ref| "
              f"over {cmp['steps']} steps' gradients {cmp['grad_err']:.3e}, of the state "
              f"after it (params, moments, targets) {cmp['state_err']:.3e} (limit "
              f"{RL_OFF_TOL}); total_loss {m_card['total_loss']:.6f} vs "
              f"{m_cpu['total_loss']:.6f}", flush=True)
        if max(cmp["grad_err"], cmp["state_err"]) > RL_OFF_TOL or not losses_finite:
            raise SystemExit(f"O1 {name}: the card's update differs from the CPU's: {cmp}")
        card_l.__dict__.pop("draw_noise", None)  # timed updates draw their own
        card_l.update(batch)  # warm
        torch.cuda.synchronize()
        n = RL_OFF_GEOM["timed"]
        t0 = time.perf_counter()
        for _ in range(n):
            card_l.update(batch)
        dt = time.perf_counter() - t0
        ms = dt / n * 1e3
        print(f"  O1 {name}: {ms:.3f} ms per update, {n / dt:.1f} updates/s over {n} updates "
              f"of {len(batch['obs'])} rows [{card}]", flush=True)
        prof = profile_once(torch, f"O1 {name} one update", lambda: card_l.update(batch))
        out[name] = dict(max_grad_err=cmp["grad_err"], max_leaf_err=cmp["state_err"],
                         total_loss_card=m_card["total_loss"],
                         total_loss_cpu=m_cpu["total_loss"], update_ms=ms,
                         updates_per_s=n / dt, batch=len(batch["obs"]), profile=prof)
    return out


def _timed_learner(algo):
    """Wrap the learner group's update to sum its seconds (it ends in the
    metrics read-back, so the card is done) and count its calls."""
    spent = {"s": 0.0, "updates": 0}
    update = algo.learner_group.update

    def timed(batch):
        t = time.perf_counter()
        res = update(batch)
        spent["s"] += time.perf_counter() - t
        spent["updates"] += 1
        return res

    algo.learner_group.update = timed
    return spent


def _on_card(torch, learners, dev, tag):
    kind = torch.device(dev).type
    for learner in learners:
        if learner.device.type != kind or not all(
                p.device.type == kind for p in learner._leaves):
            raise SystemExit(f"{tag}: the learner is not on the card")


def rl_dqn_path(torch, card, dev="cuda"):
    """O2: DQN on CartPole with tests/test_dqn.py's config, uncut; it must
    learn by that test's bars. Then 3 iterations with prioritized replay."""
    from ray_tpu_torch.rllib import DQNConfig

    g = RL_DQN
    algo = (DQNConfig().environment(CartPole)
            .env_runners(num_env_runners=g["runners"], num_envs_per_env_runner=g["envs"],
                         rollout_fragment_length=g["fragment"])
            .training(lr=g["lr"], gamma=g["gamma"], train_batch_size=g["batch"],
                      replay_buffer_capacity=g["capacity"],
                      num_steps_sampled_before_learning_starts=g["learning_starts"],
                      target_network_update_freq=g["target_freq"], epsilon=g["epsilon"],
                      epsilon_timesteps=g["epsilon_timesteps"],
                      num_updates_per_iteration=g["updates"],
                      sample_timesteps_per_iteration=g["steps"])
            .learners(device=dev).build_algo())
    try:
        _on_card(torch, algo.learner_group.learners, dev, "O2")
        spent = _timed_learner(algo)
        first, best, returns = None, -np.inf, []
        t0 = time.perf_counter()
        for _ in range(g["iters"]):
            result = algo.step()
            ret = result.get("episode_return_mean")
            returns.append(ret)
            if ret is not None:
                first = ret if first is None else first
                best = max(best, ret)
        dt = time.perf_counter() - t0
        steps = result["num_env_steps_sampled_lifetime"]
    finally:
        algo.stop()
    out = dict(iters=g["iters"], wall_s=dt, env_steps=steps, env_steps_per_s=steps / dt,
               updates=spent["updates"], updates_per_s=spent["updates"] / dt,
               learner_share=spent["s"] / dt, returns=returns, first_return=first,
               best_return=best, epsilon=result["epsilon"], mean_q=result["mean_q"],
               settings=dict(g))
    print(f"  O2 DQN on CartPole: {g['iters']} iterations in {dt:.3f} s: {steps / dt:.1f} env "
          f"steps/s, {spent['updates'] / dt:.1f} learner updates/s, learner "
          f"{100 * out['learner_share']:.1f}% of an iteration [{card}]", flush=True)
    print(f"  O2 episode_return_mean by iteration: {[None if r is None else round(r, 2) for r in returns]}; "
          f"epsilon {result['epsilon']:.4f}, mean_q {result['mean_q']:.3f}", flush=True)
    if not (result["epsilon"] < 0.5 and result["mean_q"] > 5.0 and first is not None
            and best >= 28.0 and best > first + 6.0):
        raise SystemExit(f"O2: DQN did not learn by tests/test_dqn.py's bars: epsilon "
                         f"{result['epsilon']}, mean_q {result['mean_q']}, first {first}, "
                         f"best {best}")
    p = RL_DQN_PRIORITIZED
    algo = (DQNConfig().environment(CartPole)
            .env_runners(num_env_runners=p["runners"], num_envs_per_env_runner=p["envs"],
                         rollout_fragment_length=p["fragment"])
            .training(prioritized_replay=True, train_batch_size=p["batch"],
                      num_steps_sampled_before_learning_starts=p["learning_starts"],
                      num_updates_per_iteration=p["updates"],
                      sample_timesteps_per_iteration=p["steps"])
            .learners(device=dev).build_algo())
    try:
        _on_card(torch, algo.learner_group.learners, dev, "O2 prioritized")
        for _ in range(p["iters"]):
            result = algo.step()
        prios = algo.buffer._priorities[: len(algo.buffer)]
    finally:
        algo.stop()
    out["prioritized_total_loss"] = result.get("total_loss")
    out["prioritized_distinct_priorities"] = int(len(np.unique(prios)))
    print(f"  O2 prioritized replay: total_loss {result.get('total_loss')}, "
          f"{out['prioritized_distinct_priorities']} distinct priorities in the buffer",
          flush=True)
    if not math.isfinite(result.get("total_loss", math.nan)) or len(np.unique(prios)) < 2:
        raise SystemExit("O2: prioritized replay gave no finite loss or no priority update")
    return out


def rl_sac_path(torch, card, dev="cuda"):
    """O3: SAC on Pendulum with tests/test_sac.py's config, uncut; it must
    learn by that test's bars."""
    from ray_tpu_torch.rllib import SACConfig

    g = RL_SAC
    algo = (SACConfig().environment(Pendulum)
            .env_runners(num_env_runners=g["runners"], num_envs_per_env_runner=g["envs"],
                         rollout_fragment_length=g["fragment"])
            .training(lr=g["lr"], train_batch_size=g["batch"],
                      num_steps_sampled_before_learning_starts=g["learning_starts"],
                      num_updates_per_iteration=g["updates"],
                      sample_timesteps_per_iteration=g["steps"])
            .learners(device=dev).build_algo())
    try:
        _on_card(torch, algo.learner_group.learners, dev, "O3")
        spent = _timed_learner(algo)
        t0 = time.perf_counter()
        for _ in range(g["iters"]):
            result = algo.step()
        dt = time.perf_counter() - t0
        steps = result["num_env_steps_sampled_lifetime"]
        ev = algo.evaluate(num_timesteps=g["eval_steps"])["evaluation"]["episode_return_mean"]
    finally:
        algo.stop()
    out = dict(iters=g["iters"], wall_s=dt, env_steps=steps, env_steps_per_s=steps / dt,
               updates=spent["updates"], updates_per_s=spent["updates"] / dt,
               learner_share=spent["s"] / dt, alpha=result["alpha"],
               critic_loss=result["critic_loss"], eval_return=ev, settings=dict(g))
    print(f"  O3 SAC on Pendulum: {g['iters']} iterations in {dt:.3f} s: {steps / dt:.1f} env "
          f"steps/s, {spent['updates'] / dt:.1f} learner updates/s, learner "
          f"{100 * out['learner_share']:.1f}% of an iteration [{card}]", flush=True)
    print(f"  O3 alpha {result['alpha']:.4f}, critic_loss {result['critic_loss']:.4f}, "
          f"evaluate({g['eval_steps']}) return {ev}", flush=True)
    if not (result["alpha"] < 1.0 and math.isfinite(result["critic_loss"])
            and ev is not None and ev > -800.0):
        raise SystemExit(f"O3: SAC did not learn by tests/test_sac.py's bars: {out}")
    return out


def expert_cartpole_rows(n_eps=40, seed=0):
    """tests/test_offline_rl.py's recording: a heuristic policy (push toward
    the pole's lean) on CartPole, at most 200 steps an episode."""
    rng = np.random.default_rng(seed)
    env = CartPole()
    rows, eid = [], 0
    for _ in range(n_eps):
        obs, _ = env.reset(seed=int(rng.integers(1 << 30)))
        t = 0
        while True:
            action = int(obs[2] + 0.4 * obs[3] > 0)  # angle + angular velocity
            nxt, r, term, trunc, _ = env.step(action)
            rows.append({"obs": obs.tolist(), "actions": action, "rewards": float(r),
                         "next_obs": nxt.tolist(), "dones": bool(term), "eps_id": eid, "t": t})
            obs, t = nxt, t + 1
            if term or trunc or t >= 200:
                break
        eid += 1
    return rows


def random_pendulum_rows(n_eps=8, steps=50, seed=0):
    """tests/test_offline_rl.py's CQL data: random torques on Pendulum."""
    env = Pendulum()
    rng = np.random.default_rng(seed)
    rows = []
    for eid in range(n_eps):
        obs, _ = env.reset(seed=int(rng.integers(1 << 30)))
        for t in range(steps):
            a = rng.uniform(-2, 2, size=(1,)).astype(np.float32)
            nxt, r, term, trunc, _ = env.step(a)
            rows.append({"obs": obs.tolist(), "actions": a.tolist(), "rewards": float(r),
                         "next_obs": nxt.tolist(), "dones": False, "eps_id": eid, "t": t})
            obs = nxt
    return rows


def rl_offline_path(torch, card, dev="cuda"):
    """O4: BC on the heuristic expert's CartPole rows through dataset=, which
    must hold the pole; MARWIL from a newline-JSON file; CQL on random
    Pendulum transitions, saved and loaded bit-equal."""
    import shutil
    import tempfile

    from ray_tpu_torch.rllib import BCConfig, CQLConfig, MARWILConfig
    from ray_tpu_torch.rllib.core.rl_module import tree_leaves

    out = {}
    env = CartPole()
    rows = expert_cartpole_rows()
    algo = (BCConfig().environment(observation_space=env.observation_space,
                                   action_space=env.action_space)
            .offline_data(dataset=_ListDataset(rows))
            .training(lr=1e-3, train_batch_size=512, num_updates_per_iteration=40)
            .learners(device=dev).debugging(seed=0).build_algo())
    try:
        _on_card(torch, algo.learner_group.learners, dev, "O4 BC")
        t0 = time.perf_counter()
        for _ in range(4):
            result = algo.train()
        dt = time.perf_counter() - t0
        module, params = algo._module, algo.get_weights()
    finally:
        algo.stop()
    obs, _ = env.reset(seed=3)
    held = 0
    for _ in range(300):
        logits = module.apply_np(params, obs[None].astype(np.float32))["action_dist_inputs"]
        obs, _, term, trunc, _ = env.step(int(np.argmax(logits[0])))
        held += 1
        if term or trunc:
            break
    out["bc"] = dict(rows=len(rows), mean_logp=result["mean_logp"], held_steps=held,
                     wall_s=dt, updates_per_s=4 * 40 / dt)
    print(f"  O4 BC on {len(rows)} expert rows: mean_logp {result['mean_logp']:.4f} (bar "
          f"-0.35), the cloned policy holds the pole {held} steps (bar 100); 160 updates "
          f"in {dt:.3f} s [{card}]", flush=True)
    if not (result["mean_logp"] > -0.35 and held > 100):
        raise SystemExit(f"O4: BC did not clone the expert: {out['bc']}")

    root = tempfile.mkdtemp(prefix="offline-")
    try:
        path = os.path.join(root, "rows.json")
        with open(path, "w") as f:
            for row in expert_cartpole_rows(n_eps=10):
                f.write(json.dumps(row) + "\n")
        algo = (MARWILConfig().environment(observation_space=env.observation_space,
                                           action_space=env.action_space)
                .offline_data(input_=path)
                .training(beta=1.0, train_batch_size=256, num_updates_per_iteration=5)
                .learners(device=dev).debugging(seed=0).build_algo())
        try:
            _on_card(torch, algo.learner_group.learners, dev, "O4 MARWIL")
            result = algo.train()
            n_rows = len(algo.offline_data)
        finally:
            algo.stop()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["marwil"] = dict(rows=n_rows, policy_loss=result["policy_loss"],
                         vf_loss=result["vf_loss"])
    print(f"  O4 MARWIL (beta 1) from {n_rows} newline-JSON rows: policy_loss "
          f"{result['policy_loss']:.4f}, vf_loss {result['vf_loss']:.4f}", flush=True)
    if not (math.isfinite(result["policy_loss"]) and math.isfinite(result["vf_loss"])):
        raise SystemExit(f"O4: MARWIL's losses are not finite: {out['marwil']}")

    pend = Pendulum()

    def cql():
        return (CQLConfig().environment(observation_space=pend.observation_space,
                                        action_space=pend.action_space)
                .offline_data(dataset=_ListDataset(random_pendulum_rows()))
                .training(train_batch_size=64, num_updates_per_iteration=6, bc_iters=3,
                          min_q_weight=1.0, num_cql_actions=2)
                .learners(device=dev).debugging(seed=0).build_algo())

    algo, other = cql(), cql()
    try:
        _on_card(torch, algo.learner_group.learners, dev, "O4 CQL")
        result = algo.train()  # covers bc_iters warm-start then Q-based actor
        state = algo.save_checkpoint()
        other.load_checkpoint(state)
        a, b = algo.learner_group.get_state(), other.learner_group.get_state()
    finally:
        algo.stop()
        other.stop()
    same = (a["num_updates"] == b["num_updates"] == 6
            and a["opt_state"]["count"] == b["opt_state"]["count"]
            and all(np.array_equal(x, y) for key in ("params", "target_params")
                    for x, y in zip(tree_leaves(a[key]), tree_leaves(b[key])))
            and all(np.array_equal(x, y) for key in ("mu", "nu") for x, y in
                    zip(tree_leaves(a["opt_state"][key]), tree_leaves(b["opt_state"][key]))))
    out["cql"] = dict(critic_loss=result["critic_loss"], cql_loss=result["cql_loss"],
                      checkpoint_bit_equal=same)
    print(f"  O4 CQL on 8 x 50 random Pendulum transitions: critic_loss "
          f"{result['critic_loss']:.4f}, cql_loss {result['cql_loss']:.4f}; checkpoint round "
          f"trip bit-equal (params, targets, moments, num_updates): {same}", flush=True)
    if not (math.isfinite(result["critic_loss"]) and math.isfinite(result["cql_loss"]) and same):
        raise SystemExit(f"O4: CQL failed: {out['cql']}")
    return out


def rl_offpolicy_path(torch, fa, card, dev="cuda"):
    """Phase O: O1, O2, O3 and O4; no flash kernel may launch."""
    t0 = time.perf_counter()
    fa.reset_launch_count()
    out = {"learners": rl_off_learner_path(torch, card, dev),
           "dqn": rl_dqn_path(torch, card, dev), "sac": rl_sac_path(torch, card, dev),
           "offline": rl_offline_path(torch, card, dev)}
    out["flash_launches"] = {k: fa.launch_count(k) for k in fa.KERNELS}
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase O took {out['wall_s']:.1f} s; flash launches {out['flash_launches']}",
          flush=True)
    if any(out["flash_launches"].values()):
        raise SystemExit(f"O: an off-policy algorithm launched a flash kernel: "
                         f"{out['flash_launches']}")
    return out


# phase M: RLlib multi-agent PPO on the card (A9g). M1 holds a two-module
# MultiAgentLearner at R1's geometry (RL_LEARNER) to its CPU run per module;
# M2 and M3 are tests/test_multi_agent.py:45-63 and :67-88 uncut, on the
# numpy CartPole through make_multi_agent.
RL_MA_SHARED = dict(agents=2, runners=2, fragment=64, lr=3e-4, batch=1024, minibatch=256,
                    epochs=6, entropy_coeff=0.01, iters=8)
RL_MA_SEPARATE = dict(agents=2, runners=1, fragment=32, batch=256, minibatch=64, epochs=1)
# phase D: RLlib DreamerV3 on the card (A9h). D1 is the learner at the JAX
# package's defaults (dreamerv3.py:74-102) on CartPole's obs 4 and 2 actions;
# D2 and D3 are tests/test_dreamerv3.py:13-27,87-110 and :52-82 uncut.
RL_DREAMER_TIMED = 20
RL_DREAMER_TOL = 1e-4  # card against CPU, f32, per leaf of max|ref|
RL_DREAMER_RET_TOL = 1e-5  # ret_range, relative
RL_DREAMER_TINY = dict(deter_size=128, hidden=128, embed_size=64, stoch_groups=8,
                       stoch_classes=8, batch_size_seqs=8, seq_len=24,
                       num_updates_per_iteration=12, sample_timesteps_per_iteration=300,
                       num_steps_sampled_before_learning_starts=300, imag_horizon=15,
                       entropy_coef=1e-2)
RL_DREAMER_ITERS = 45  # D2's most iterations (tests/test_dreamerv3.py:95)
RL_DREAMER_WM_ITERS = 6  # D3: iterations over which the world-model loss must fall


def rl_ma_learner_path(torch, card, r1_update_ms=None, dev="cuda"):
    """M1: a MultiAgentLearner with modules p0 and p1, each at R1's geometry,
    on the card: each module's update against its CPU run (update_against_cpu),
    then RL_LEARNER['timed'] two-module updates timed on the host clock and one
    under torch.profiler."""
    from ray_tpu_torch.rllib import MultiAgentLearner, PPOConfig, PPOLearner
    from ray_tpu_torch.rllib.core.rl_module import Columns, RLModuleSpec

    g = RL_LEARNER
    spec = RLModuleSpec(observation_space=Box((g["obs_dim"],)),
                        action_space=Discrete(g["n_actions"]),
                        model_config={"fcnet_hiddens": g["hiddens"]})

    def learner(device):
        cfg = (PPOConfig().training(lr=3e-4, train_batch_size=g["batch"],
                                    minibatch_size=g["minibatch"], num_epochs=g["epochs"])
               .learners(device=device).debugging(seed=0))
        cfg.base_learner_class = PPOLearner
        out = MultiAgentLearner(cfg, {"p0": spec, "p1": spec})
        out.build()
        return out

    n = g["batch"]
    batches = {}
    for i, mid in enumerate(("p0", "p1")):
        rng = np.random.default_rng(i)
        batches[mid] = {
            Columns.OBS: rng.standard_normal((n, g["obs_dim"])).astype(np.float32),
            Columns.ACTIONS: rng.integers(0, g["n_actions"], n).astype(np.int32),
            Columns.ACTION_LOGP: np.full((n,), -np.log(g["n_actions"]), np.float32),
            Columns.ADVANTAGES: rng.standard_normal(n).astype(np.float32),
            Columns.VALUE_TARGETS: rng.standard_normal(n).astype(np.float32)}
    card_l, cpu_l = learner(dev), learner("cpu")
    _on_card(torch, card_l._subs.values(), dev, "M1")
    out = {"modules": {}}
    for mid in ("p0", "p1"):
        cmp = update_against_cpu(card_l._subs[mid], cpu_l._subs[mid], batches[mid])
        print(f"  M1 module {mid}: one update on the card against the CPU: worst leaf of "
              f"max|ref| over {cmp['steps']} steps' gradients {cmp['grad_err']:.3e}, of the "
              f"state after it {cmp['state_err']:.3e} (limit {RL_LEARNER_TOL}); total_loss "
              f"{cmp['m_card']['total_loss']:.6f} vs {cmp['m_cpu']['total_loss']:.6f}",
              flush=True)
        if (max(cmp["grad_err"], cmp["state_err"]) > RL_LEARNER_TOL
                or not all(math.isfinite(v) for v in cmp["m_card"].values())):
            raise SystemExit(f"M1 {mid}: the card's update differs from the CPU's: {cmp}")
        out["modules"][mid] = dict(max_grad_err=cmp["grad_err"], max_leaf_err=cmp["state_err"],
                                   steps=cmp["steps"])
    metrics = card_l.update(batches)  # warm
    if sorted(metrics) != ["p0", "p1"]:
        raise SystemExit(f"M1: the update returned modules {sorted(metrics)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(g["timed"]):
        card_l.update(batches)  # each sub-update ends with its read-back
    dt = time.perf_counter() - t0
    update_ms = dt / g["timed"] * 1e3
    steps = 2 * (n // g["minibatch"]) * g["epochs"]
    out.update(update_ms=update_ms, minibatch_update_ms=update_ms / steps,
               updates_per_s=g["timed"] / dt, r1_minibatch_update_ms=r1_update_ms)
    ratio = "" if not r1_update_ms else \
        f", {update_ms / steps / r1_update_ms:.3f}x R1's {r1_update_ms:.3f} ms"
    print(f"  M1 two-module update: {update_ms:.3f} ms ({steps} minibatch steps, "
          f"{update_ms / steps:.3f} ms each{ratio}) over {g['timed']} updates [{card}]",
          flush=True)
    out["profile"] = profile_once(torch, "M1 one two-module update",
                                  lambda: card_l.update(batches))
    return out


def _ma_shared_config(dev):
    from ray_tpu_torch.rllib import MultiAgentPPOConfig, make_multi_agent

    g = RL_MA_SHARED
    return (MultiAgentPPOConfig()
            .environment(make_multi_agent(CartPole), env_config={"num_agents": g["agents"]})
            .multi_agent(policies=["shared"], policy_mapping_fn=lambda aid: "shared")
            .env_runners(num_env_runners=g["runners"], rollout_fragment_length=g["fragment"])
            .training(lr=g["lr"], train_batch_size=g["batch"], minibatch_size=g["minibatch"],
                      num_epochs=g["epochs"], entropy_coeff=g["entropy_coeff"])
            .learners(device=dev).debugging(seed=0))


def rl_ma_shared_path(torch, card, dev="cuda"):
    """M2: tests/test_multi_agent.py:45-63 uncut: 2 CartPole agents on one
    shared policy, 8 iterations; it must learn by that test's bar."""
    g = RL_MA_SHARED
    algo = _ma_shared_config(dev).build_algo()
    try:
        _on_card(torch, algo.learner_group.learners[0]._subs.values(), dev, "M2")
        spent = _timed_learner(algo)
        returns, trained = [], 0
        t0 = time.perf_counter()
        for _ in range(g["iters"]):
            result = algo.train()
            returns.append(result.get("episode_return_mean") or 0.0)
            trained += result["num_env_steps_trained"]
        dt = time.perf_counter() - t0
    finally:
        algo.stop()
    out = dict(iters=g["iters"], wall_s=dt, agent_steps=trained,
               agent_steps_per_s=trained / dt, learner_s=spent["s"],
               learner_share=spent["s"] / dt, iteration_ms=dt / g["iters"] * 1e3,
               returns=returns, settings=dict(g))
    print(f"  M2 multi-agent PPO, shared policy: {g['iters']} iterations in {dt:.3f} s: "
          f"{trained / dt:.1f} agent steps/s, learner {100 * out['learner_share']:.1f}% of an "
          f"iteration ({out['iteration_ms']:.1f} ms) [{card}]", flush=True)
    print(f"  M2 episode_return_mean by iteration: {[round(r, 2) for r in returns]}",
          flush=True)
    if not max(returns[2:]) > returns[0] + 20:
        raise SystemExit(f"M2: the shared policy did not learn by tests/test_multi_agent.py's "
                         f"bar: {returns}")
    return out


def rl_ma_separate_path(torch, card, dev="cuda"):
    """M3: tests/test_multi_agent.py:67-88 uncut: policies p0 and p1, the
    "{mid}/..." metrics, a checkpoint round trip bit for bit, p0 and p1 apart."""
    from ray_tpu_torch.rllib import MultiAgentPPOConfig, make_multi_agent
    from ray_tpu_torch.rllib.core.rl_module import tree_leaves

    g = RL_MA_SEPARATE
    algo = (MultiAgentPPOConfig()
            .environment(make_multi_agent(CartPole), env_config={"num_agents": g["agents"]})
            .multi_agent(policies=["p0", "p1"], policy_mapping_fn=lambda aid: f"p{aid}")
            .env_runners(num_env_runners=g["runners"], rollout_fragment_length=g["fragment"])
            .training(train_batch_size=g["batch"], minibatch_size=g["minibatch"],
                      num_epochs=g["epochs"])
            .learners(device=dev).debugging(seed=0).build_algo())
    try:
        _on_card(torch, algo.learner_group.learners[0]._subs.values(), dev, "M3")
        result = algo.train()
        keys = {mid: sorted(k for k in result if k.startswith(f"{mid}/")) for mid in ("p0", "p1")}
        state = algo.save_checkpoint()
        w_before = algo.get_weights()
        algo.train()
        algo.load_checkpoint(state)
        w_after = algo.get_weights()
        restored = all(np.array_equal(a, b) for a, b in zip(tree_leaves(w_after),
                                                            tree_leaves(w_before)))
        apart = not np.allclose(w_after["p0"]["pi"][0]["w"], w_after["p1"]["pi"][0]["w"])
    finally:
        algo.stop()
    print(f"  M3 separate policies: metric keys {keys['p0'][:3]}... and {keys['p1'][:3]}...; "
          f"checkpoint restored bit for bit: {restored}; p0 and p1 apart: {apart}", flush=True)
    if not (keys["p0"] and keys["p1"] and restored and apart):
        raise SystemExit(f"M3: keys {keys}, restored {restored}, apart {apart}")
    return dict(metric_keys=keys, restored=restored, apart=apart, settings=dict(g))


def rl_multi_agent_path(torch, fa, card, r1_update_ms=None, dev="cuda"):
    """Phase M: M1, M2 and M3; no flash kernel may launch."""
    t0 = time.perf_counter()
    fa.reset_launch_count()
    out = {"learner": rl_ma_learner_path(torch, card, r1_update_ms, dev),
           "shared": rl_ma_shared_path(torch, card, dev),
           "separate": rl_ma_separate_path(torch, card, dev)}
    out["flash_launches"] = {k: fa.launch_count(k) for k in fa.KERNELS}
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase M took {out['wall_s']:.1f} s; flash launches {out['flash_launches']}",
          flush=True)
    if any(out["flash_launches"].values()):
        raise SystemExit(f"M: multi-agent PPO launched a flash kernel: {out['flash_launches']}")
    return out


def _dreamer_learner(dev):
    from ray_tpu_torch.rllib import DreamerV3Config, DreamerV3Learner
    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

    learner = DreamerV3Learner(DreamerV3Config().learners(device=dev).debugging(seed=0),
                               RLModuleSpec(observation_space=Box((4,)),
                                            action_space=Discrete(2)))
    learner.build()
    return learner


def _dreamer_batch(cfg, seed=0):
    """A replayed batch of the learner's shape from chip_smoke's CartPole under
    a random policy: 40 episodes through the stream buffer."""
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import _StreamBuffer

    rng = np.random.default_rng(seed)
    env, eps = CartPole(), []
    for i in range(40):
        obs = [env.reset(seed=seed * 1000 + i)[0]]
        acts, rews, term, trunc = [], [], False, False
        while not (term or trunc):
            acts.append(int(rng.integers(0, 2)))
            o, r, term, trunc, _ = env.step(acts[-1])
            obs.append(o)
            rews.append(r)
        eps.append({"obs": np.stack(obs[:-1]), "next_obs_last": obs[-1],
                    "actions": np.array(acts), "rewards": np.array(rews, np.float32),
                    "terminated": term, "truncated": trunc})
    buf = _StreamBuffer(10_000, 4)
    buf.add_episodes(eps)
    return buf.sample(cfg.batch_size_seqs, cfg.seq_len, rng)


def dreamer_update_against_cpu(torch, card_l, cpu_l, batch):
    """`update(batch)` on the card's DreamerV3 learner, then on the CPU's, fed
    the same Gumbel noise. The CPU's world-model and imagination draws are held
    to the card's picks (a near tie may flip a pick, after which the
    recurrences part); each of its three optimizers takes the card's gradients.
    Returns the worst per-leaf error (of max|ref|) of the card's world-model,
    actor and critic gradients against the CPU's own at the same inputs; the
    same of the state after the update (params, critic_ema, the three
    optimizers' moments; counts equal); ret_range's relative error; and the
    picks where the CPU, on the same history, would pick otherwise, with the
    smallest top-two margin of any pick and of those that differ."""
    noise = cpu_l.draw_noise(batch["actions"].shape[0], batch["actions"].shape[1])
    card_noise = {k: v.to(card_l.device) for k, v in noise.items()}
    cpu_l.draw_noise = lambda b, length: noise
    card_l.draw_noise = lambda b, length: card_noise
    card, errs, picks = {}, {}, {"total": 0, "differ": 0, "min_margin": math.inf,
                                 "min_margin_differ": None}

    def count(scores, held):
        top2 = torch.topk(scores, 2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        differ = scores.argmax(-1) != held
        picks["total"] += held.numel()
        picks["differ"] += int(differ.sum())
        picks["min_margin"] = min(picks["min_margin"], float(margin.min()))
        if differ.any():
            picks["min_margin_differ"] = min(picks["min_margin_differ"] or math.inf,
                                             float(margin[differ].min()))

    def host(grads):
        return [g.detach().cpu().clone() for g in grads]

    card_wm, card_ac = card_l._wm_grads, card_l._ac_grads
    cpu_wm, cpu_ac = cpu_l._wm_grads, cpu_l._ac_grads

    def card_wm_hook(b, n, idx=None):
        aux, grads = card_wm(b, n)
        card["wm"], card["wm_idx"] = host(grads), aux["z_scores"].argmax(-1).cpu()
        return aux, grads

    def card_ac_hook(h0, z0, n, idx_a=None, idx_z=None):
        aux, ga, gc = card_ac(h0, z0, n)
        card["actor"], card["critic"] = host(ga), host(gc)
        card["a_idx"] = aux["a_scores"].argmax(-1).cpu()
        card["z_idx"] = aux["z_scores"].argmax(-1).cpu()
        return aux, ga, gc

    def cpu_wm_hook(b, n, idx=None):
        aux, grads = cpu_wm(b, n, card["wm_idx"])
        count(aux["z_scores"], card["wm_idx"])
        errs["wm"] = leaf_errors([g.numpy() for g in card["wm"]], [g.numpy() for g in grads])
        return aux, [g.clone() for g in card["wm"]]

    def cpu_ac_hook(h0, z0, n, idx_a=None, idx_z=None):
        aux, ga, gc = cpu_ac(h0, z0, n, card["a_idx"], card["z_idx"])
        count(aux["a_scores"], card["a_idx"])
        count(aux["z_scores"], card["z_idx"])
        errs["actor"] = leaf_errors([g.numpy() for g in card["actor"]], [g.numpy() for g in ga])
        errs["critic"] = leaf_errors([g.numpy() for g in card["critic"]],
                                     [g.numpy() for g in gc])
        return aux, [g.clone() for g in card["actor"]], [g.clone() for g in card["critic"]]

    card_l._wm_grads, card_l._ac_grads = card_wm_hook, card_ac_hook
    cpu_l._wm_grads, cpu_l._ac_grads = cpu_wm_hook, cpu_ac_hook
    try:
        m_card, m_cpu = card_l.update(batch), cpu_l.update(batch)
    finally:
        for learner in (card_l, cpu_l):
            for k in ("_wm_grads", "_ac_grads", "draw_noise"):
                learner.__dict__.pop(k)
    got, want = card_l.get_state(), cpu_l.get_state()
    state_errs = leaf_errors(got["params"], want["params"]) + leaf_errors(
        got["critic_ema"], want["critic_ema"])
    for k in ("st_world", "st_actor", "st_critic"):
        if got[k]["count"] != want[k]["count"]:
            raise SystemExit(f"D1: {k} counts {got[k]['count']} vs {want[k]['count']}")
        state_errs += leaf_errors(got[k]["mu"], want[k]["mu"])
        state_errs += leaf_errors(got[k]["nu"], want[k]["nu"])
    ret_err = abs(got["ret_range"] - want["ret_range"]) / abs(want["ret_range"])
    return dict(grad_err={k: max(v) for k, v in errs.items()}, state_err=max(state_errs),
                ret_range_err=ret_err, picks=picks, m_card=m_card, m_cpu=m_cpu)


def rl_dreamer_learner_path(torch, card, dev="cuda"):
    """D1: DreamerV3Learner at the JAX package's defaults on the card against
    the same update on the CPU (dreamer_update_against_cpu), then
    RL_DREAMER_TIMED updates timed on the host clock and one under
    torch.profiler."""
    from ray_tpu_torch.rllib.core.rl_module import tree_leaves

    card_l, cpu_l = _dreamer_learner(dev), _dreamer_learner("cpu")
    _on_card(torch, [card_l], dev, "D1")
    if not all(t.device.type == torch.device(dev).type for t in
               card_l.st_world.mu + card_l.st_actor.mu + card_l.st_critic.mu
               + tree_leaves(card_l.critic_ema)):
        raise SystemExit("D1: the optimizer state or the EMA critic is not on the card")
    cfg = card_l.config
    batch = _dreamer_batch(cfg)
    cmp = dreamer_update_against_cpu(torch, card_l, cpu_l, batch)
    p = cmp["picks"]
    print(f"  D1 one update on the card against the CPU (deter {cfg.deter_size}, stoch "
          f"{cfg.stoch_groups}x{cfg.stoch_classes}, {cfg.batch_size_seqs} x {cfg.seq_len}, "
          f"horizon {cfg.imag_horizon}): worst leaf of max|ref| of the gradients "
          + ", ".join(f"{k} {v:.3e}" for k, v in cmp["grad_err"].items())
          + f"; of the state after it {cmp['state_err']:.3e} (limit {RL_DREAMER_TOL}); "
          f"ret_range {cmp['ret_range_err']:.3e} relative (limit {RL_DREAMER_RET_TOL}); "
          f"wm_loss {cmp['m_card']['wm_loss']:.6f} vs {cmp['m_cpu']['wm_loss']:.6f}", flush=True)
    print(f"  D1 picks: {p['differ']} of {p['total']} differ on the CPU given the card's "
          f"history; smallest top-two margin {p['min_margin']:.3e}, of those that differ "
          f"{p['min_margin_differ']}", flush=True)
    if (max(max(cmp["grad_err"].values()), cmp["state_err"]) > RL_DREAMER_TOL
            or cmp["ret_range_err"] > RL_DREAMER_RET_TOL
            or not all(math.isfinite(v) for v in cmp["m_card"].values())):
        raise SystemExit(f"D1: the card's update differs from the CPU's: {cmp}")
    if p["differ"] and not p["min_margin_differ"] < 1e-5:  # a near tie flips, nothing else
        raise SystemExit(f"D1: a pick that differs has a top-two margin of "
                         f"{p['min_margin_differ']}, not a near tie")
    card_l.update(batch)  # warm
    torch.cuda.synchronize()
    n = RL_DREAMER_TIMED
    t0 = time.perf_counter()
    for _ in range(n):
        card_l.update(batch)  # each ends with its one read-back
    dt = time.perf_counter() - t0
    ms = dt / n * 1e3
    print(f"  D1 learner: {ms:.3f} ms per update, {n / dt:.2f} updates/s over {n} updates "
          f"[{card}]", flush=True)
    prof = profile_once(torch, "D1 one DreamerV3 update", lambda: card_l.update(batch))
    return dict(grad_err=cmp["grad_err"], max_leaf_err=cmp["state_err"],
                ret_range_err=cmp["ret_range_err"], picks=p,
                wm_loss_card=cmp["m_card"]["wm_loss"], wm_loss_cpu=cmp["m_cpu"]["wm_loss"],
                update_ms=ms, updates_per_s=n / dt, profile=prof,
                geometry=dict(deter=cfg.deter_size, stoch=(cfg.stoch_groups, cfg.stoch_classes),
                              hidden=cfg.hidden, embed=cfg.embed_size,
                              batch=(cfg.batch_size_seqs, cfg.seq_len),
                              horizon=cfg.imag_horizon))


def _dreamer_tiny(dev):
    from ray_tpu_torch.rllib import DreamerV3Config

    return (DreamerV3Config().environment(CartPole)
            .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                         rollout_fragment_length=50)
            .training(**RL_DREAMER_TINY).learners(device=dev).debugging(seed=0))


def rl_dreamer_train_path(torch, card, dev="cuda"):
    """D2: tests/test_dreamerv3.py:87-110 uncut on the numpy CartPole: at most
    45 iterations, stopping as the test stops (best >= 30 from iteration 10);
    the best return must reach 30. Then D3's checkpoint round trip on the
    trained algorithm: a second algorithm loads it, and the actor's weights and
    the whole learner state come back bit for bit."""
    from ray_tpu_torch.rllib.core.rl_module import tree_leaves

    algo = _dreamer_tiny(dev).build_algo()
    try:
        _on_card(torch, algo.learner_group.learners, dev, "D2")
        spent = _timed_learner(algo)
        best, baseline, returns = 0.0, None, []
        t0 = time.perf_counter()
        for it in range(RL_DREAMER_ITERS):
            r = algo.train()
            ret = r.get("episode_return_mean")
            returns.append(ret)
            if ret is None:
                continue
            if baseline is None:
                baseline = ret
            best = max(best, ret)
            if best >= 30.0 and it >= 10:
                break
        dt = time.perf_counter() - t0
        steps = r["num_env_steps_sampled_lifetime"]
        iters = len(returns)
        state = algo.save_checkpoint()
        other = _dreamer_tiny(dev).build_algo()
        try:
            other.load_checkpoint(state)
            w1, w2 = algo.learner_group.get_weights(), other.learner_group.get_weights()
            actor_same = np.array_equal(w1["actor"][0]["w"], w2["actor"][0]["w"])
            got = other.learner_group.get_state()
            state_same = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
                tree_leaves(got), tree_leaves(state["learner"])))
        finally:
            other.stop()
    finally:
        algo.stop()
    out = dict(iters=iters, wall_s=dt, env_steps=steps, env_steps_per_s=steps / dt,
               updates=spent["updates"], updates_per_s=spent["updates"] / dt,
               learner_s=spent["s"], learner_share=spent["s"] / dt, returns=returns,
               baseline=baseline, best_return=best, checkpoint_actor_equal=actor_same,
               checkpoint_state_equal=state_same, settings=dict(RL_DREAMER_TINY))
    print(f"  D2 DreamerV3 on CartPole: {iters} iterations in {dt:.3f} s: {steps / dt:.1f} env "
          f"steps/s, {spent['updates'] / dt:.2f} learner updates/s, learner "
          f"{100 * out['learner_share']:.1f}% of an iteration [{card}]", flush=True)
    print(f"  D2 episode_return_mean by iteration: "
          f"{[None if x is None else round(x, 2) for x in returns]}; best {best:.2f} "
          f"(baseline {baseline})", flush=True)
    print(f"  D3 checkpoint round trip: actor weights bit-equal {actor_same}, the whole "
          f"learner state bit-equal {state_same}", flush=True)
    if baseline is None or not best >= 30.0:
        raise SystemExit(f"D2: no learning by tests/test_dreamerv3.py's bar: best {best} "
                         f"(baseline {baseline})")
    if not (actor_same and state_same):
        raise SystemExit("D3: the checkpoint round trip is not bit-equal")
    return out


def rl_dreamer_wm_path(torch, card, dev="cuda"):
    """D3: tests/test_dreamerv3.py:52-66: one iteration fills the buffer past
    warm-up, then the world-model loss must fall over 6 iterations."""
    algo = _dreamer_tiny(dev).build_algo()
    try:
        algo.train()
        losses = [algo.train().get("wm_loss") for _ in range(RL_DREAMER_WM_ITERS)]
    finally:
        algo.stop()
    seen = [x for x in losses if x is not None]
    print(f"  D3 wm_loss over {RL_DREAMER_WM_ITERS} iterations: "
          f"{[None if x is None else round(x, 4) for x in losses]}", flush=True)
    if not seen or not seen[-1] < seen[0]:
        raise SystemExit(f"D3: the world-model loss did not fall: {losses}")
    return dict(wm_losses=losses)


def rl_dreamer_path(torch, fa, card, dev="cuda"):
    """Phase D: D1, D2 (with D3's checkpoint round trip) and D3; no flash
    kernel may launch."""
    t0 = time.perf_counter()
    fa.reset_launch_count()
    out = {"learner": rl_dreamer_learner_path(torch, card, dev),
           "train": rl_dreamer_train_path(torch, card, dev),
           "world_model": rl_dreamer_wm_path(torch, card, dev)}
    out["flash_launches"] = {k: fa.launch_count(k) for k in fa.KERNELS}
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase D took {out['wall_s']:.1f} s; flash launches {out['flash_launches']}",
          flush=True)
    if any(out["flash_launches"].values()):
        raise SystemExit(f"D: DreamerV3 launched a flash kernel: {out['flash_launches']}")
    return out


# phase I: RLlib IMPALA and APPO on the card (A9d). I1 holds IMPALALearner
# and APPOLearner (KL on) at R1's widths (RL_LEARNER) to their CPU runs on one
# padded batch of 64 sequences at max_seq_len 64; I2 and I3 are
# tests/test_impala.py:71-88 and :108-125 uncut, on the numpy CartPole.
RL_IMPALA_LEARNER = dict(seqs=64, max_seq_len=64, ragged=16, epochs=2, timed=20)
RL_IMPALA = dict(runners=2, envs=4, fragment=32, lr=1e-3, batch=512, gamma=0.99,
                 entropy_coeff=0.005, max_seq_len=64, broadcast_interval=1, epochs=4, iters=25)
RL_APPO = dict(runners=1, envs=2, fragment=32, batch=128, clip_param=0.3)


def _impala_batch(seed=0):
    """I1's padded batch (pad_time_major): RL_IMPALA_LEARNER['seqs']
    sequences of R1's observations and actions, all at max_seq_len but the
    last `ragged`, which are shorter; every third terminated, every third
    truncated; the behaviour logp is the uniform policy's, off by 0.05 plus
    N(0, 0.5) noise, so rho spreads on both sides of its clips."""
    from ray_tpu_torch.rllib.algorithms.impala import pad_time_major

    g, gi = RL_LEARNER, RL_IMPALA_LEARNER
    rng = np.random.default_rng(seed)
    T = gi["max_seq_len"]
    lens = np.full(gi["seqs"], T)
    lens[-gi["ragged"]:] = rng.integers(1, T, gi["ragged"])
    eps = []
    for i, n in enumerate(lens):
        eps.append({"obs": rng.standard_normal((n, g["obs_dim"])).astype(np.float32),
                    "next_obs_last": rng.standard_normal(g["obs_dim"]).astype(np.float32),
                    "actions": rng.integers(0, g["n_actions"], n),
                    "rewards": rng.standard_normal(n).astype(np.float32),
                    "terminated": i % 3 == 0, "truncated": i % 3 == 1,
                    "action_logp": (-np.log(g["n_actions"]) + 0.05
                                    + rng.normal(0.0, 0.5, n)).astype(np.float32)})
    return pad_time_major(eps, T)


def _impala_learner(name, dev):
    from ray_tpu_torch.rllib import APPOConfig, APPOLearner, IMPALAConfig, IMPALALearner
    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

    g, gi = RL_LEARNER, RL_IMPALA_LEARNER
    spec = RLModuleSpec(observation_space=Box((g["obs_dim"],)),
                        action_space=Discrete(g["n_actions"]),
                        model_config={"fcnet_hiddens": g["hiddens"]})
    cfg, cls = ((IMPALAConfig(), IMPALALearner) if name == "IMPALA"
                else (APPOConfig().training(use_kl_loss=True), APPOLearner))
    cfg = (cfg.training(num_epochs=gi["epochs"], max_seq_len=gi["max_seq_len"])
           .learners(device=dev).debugging(seed=0))
    out = cls(cfg, spec)
    out.build()
    return out


def rl_impala_learner_path(torch, card, dev="cuda"):
    """I1: IMPALALearner and APPOLearner (use_kl_loss) at R1's widths on the
    card: one update of RL_IMPALA_LEARNER['epochs'] whole-batch steps against
    the CPU's (update_against_cpu; APPO's kl_coeff after it equal), then ms
    per whole-batch step over RL_IMPALA_LEARNER['timed'] updates and one
    update under torch.profiler."""
    gi = RL_IMPALA_LEARNER
    batch = _impala_batch()
    steps_real = int(batch["mask"].sum())
    out = {}
    for name in ("IMPALA", "APPO"):
        card_l, cpu_l = _impala_learner(name, dev), _impala_learner(name, "cpu")
        _on_card(torch, [card_l], dev, "I1")
        cmp = update_against_cpu(card_l, cpu_l, batch)
        m_card, m_cpu = cmp["m_card"], cmp["m_cpu"]
        kl = (card_l._kl_coeff, cpu_l._kl_coeff) if name == "APPO" else None
        print(f"  I1 {name}Learner, one update of {cmp['steps']} whole-batch steps on "
              f"obs_ext {list(batch['obs_ext'].shape)} ({steps_real} real steps) on the card "
              f"against the CPU: worst leaf of max|ref| of the gradients {cmp['grad_err']:.3e}, "
              f"of the state after it {cmp['state_err']:.3e} (limit {RL_LEARNER_TOL}); "
              f"total_loss {m_card['total_loss']:.6f} vs {m_cpu['total_loss']:.6f}, mean_rho "
              f"{m_card['mean_rho']:.4f}" + (f", kl_coeff {kl[0]} vs {kl[1]}" if kl else ""),
              flush=True)
        if (max(cmp["grad_err"], cmp["state_err"]) > RL_LEARNER_TOL
                or not all(math.isfinite(v) for v in m_card.values())
                or (kl is not None and kl[0] != kl[1])):
            raise SystemExit(f"I1: the card's {name} update differs from the CPU's: {cmp}")
        card_l.update(batch)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(gi["timed"]):
            card_l.update(batch)  # each ends with its one read-back
        dt = time.perf_counter() - t0
        steps = gi["timed"] * gi["epochs"]
        step_ms = dt / steps * 1e3
        print(f"  I1 {name}Learner: {step_ms:.3f} ms per whole-batch step, {steps / dt:.1f} "
              f"steps/s, {gi['timed'] / dt:.2f} updates/s over {gi['timed']} updates of "
              f"{gi['epochs']} steps [{card}]", flush=True)
        prof = profile_once(torch, f"I1 one {name} update", lambda: card_l.update(batch))
        out[name] = dict(grad_err=cmp["grad_err"], max_leaf_err=cmp["state_err"],
                         total_loss_card=m_card["total_loss"], total_loss_cpu=m_cpu["total_loss"],
                         mean_rho=m_card["mean_rho"], kl_coeff=kl, step_ms=step_ms,
                         steps_per_s=steps / dt, updates_per_s=gi["timed"] / dt, profile=prof)
    out["geometry"] = dict(obs_dim=RL_LEARNER["obs_dim"], n_actions=RL_LEARNER["n_actions"],
                           hiddens=RL_LEARNER["hiddens"], **gi, real_steps=steps_real)
    return out


def rl_impala_train_path(torch, card, dev="cuda"):
    """I2: tests/test_impala.py:71-88 uncut on the numpy CartPole: 25
    iterations; it must learn by that test's bar (the best return after the
    third iteration 15 above the first)."""
    from ray_tpu_torch.rllib import IMPALAConfig

    g = RL_IMPALA
    algo = (IMPALAConfig().environment(CartPole)
            .env_runners(num_env_runners=g["runners"], num_envs_per_env_runner=g["envs"],
                         rollout_fragment_length=g["fragment"])
            .training(lr=g["lr"], train_batch_size=g["batch"], gamma=g["gamma"],
                      entropy_coeff=g["entropy_coeff"], max_seq_len=g["max_seq_len"],
                      broadcast_interval=g["broadcast_interval"], num_epochs=g["epochs"])
            .learners(device=dev).debugging(seed=0).build_algo())
    try:
        _on_card(torch, algo.learner_group.learners, dev, "I2")
        spent = _timed_learner(algo)
        returns, trained, rhos = [], 0, []
        t0 = time.perf_counter()
        for _ in range(g["iters"]):
            result = algo.train()
            returns.append(result.get("episode_return_mean") or 0.0)
            trained += result["num_env_steps_trained"]
            rhos.append(result["mean_rho"])
        dt = time.perf_counter() - t0
    finally:
        algo.stop()
    out = dict(iters=g["iters"], wall_s=dt, env_steps=trained, env_steps_per_s=trained / dt,
               updates=spent["updates"] * g["epochs"],
               updates_per_s=spent["updates"] * g["epochs"] / dt, learner_s=spent["s"],
               learner_share=spent["s"] / dt, iteration_ms=dt / g["iters"] * 1e3,
               returns=returns, mean_rho=rhos, settings=dict(g))
    print(f"  I2 IMPALA on CartPole: {g['iters']} iterations in {dt:.3f} s: "
          f"{trained / dt:.1f} env steps/s, {out['updates_per_s']:.1f} whole-batch steps/s, "
          f"learner {100 * out['learner_share']:.1f}% of an iteration "
          f"({out['iteration_ms']:.1f} ms) [{card}]", flush=True)
    print(f"  I2 episode_return_mean by iteration: {[round(r, 2) for r in returns]}; "
          f"mean_rho {[round(r, 4) for r in rhos]}", flush=True)
    if not max(returns[3:]) > returns[0] + 15:
        raise SystemExit(f"I2: IMPALA did not learn by tests/test_impala.py's bar: {returns}")
    return out


def rl_appo_checkpoint_path(torch, card, dev="cuda"):
    """I3: tests/test_impala.py:108-125 uncut: APPO with the KL term trains,
    and a checkpoint restores its weights and kl_coeff bit for bit."""
    from ray_tpu_torch.rllib import APPOConfig
    from ray_tpu_torch.rllib.core.rl_module import tree_leaves

    g = RL_APPO
    algo = (APPOConfig().environment(CartPole)
            .env_runners(num_env_runners=g["runners"], num_envs_per_env_runner=g["envs"],
                         rollout_fragment_length=g["fragment"])
            .training(train_batch_size=g["batch"], clip_param=g["clip_param"], use_kl_loss=True)
            .learners(device=dev).debugging(seed=0).build_algo())
    try:
        _on_card(torch, algo.learner_group.learners, dev, "I3")
        first = algo.train()
        state = algo.save_checkpoint()
        w_before = algo.get_weights()
        second = algo.train()
        algo.load_checkpoint(state)
        restored = all(np.array_equal(a, b) for a, b in zip(tree_leaves(algo.get_weights()),
                                                            tree_leaves(w_before)))
        kl_restored = algo.learner_group.learners[0]._kl_coeff == state["learner"]["kl_coeff"]
    finally:
        algo.stop()
    print(f"  I3 APPO: kl_coeff {first['kl_coeff']} then {second['kl_coeff']}; checkpoint "
          f"restored bit for bit: weights {restored}, kl_coeff {kl_restored}", flush=True)
    if not (restored and kl_restored and math.isfinite(first["total_loss"])):
        raise SystemExit(f"I3: weights restored {restored}, kl_coeff restored {kl_restored}")
    return dict(restored=restored, kl_restored=kl_restored,
                kl_coeff=[first["kl_coeff"], second["kl_coeff"]], settings=dict(g))


def rl_impala_path(torch, fa, card, dev="cuda"):
    """Phase I: I1, I2 and I3; no flash kernel may launch."""
    t0 = time.perf_counter()
    fa.reset_launch_count()
    out = {"learner": rl_impala_learner_path(torch, card, dev),
           "train": rl_impala_train_path(torch, card, dev),
           "checkpoint": rl_appo_checkpoint_path(torch, card, dev)}
    out["flash_launches"] = {k: fa.launch_count(k) for k in fa.KERNELS}
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase I took {out['wall_s']:.1f} s; flash launches {out['flash_launches']}",
          flush=True)
    if any(out["flash_launches"].values()):
        raise SystemExit(f"I: IMPALA or APPO launched a flash kernel: {out['flash_launches']}")
    return out


SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "HMMA")  # wgmma, TMA load / store, mma.sync
# the bf16 kernels of B1a, B1b and B1c at D = 64 and 128
WGMMA_KERNELS = tuple(f"flash_{k}_bf16_wgmma_kernel<{d}>"
                      for k in ("fwd", "bwd_dq", "bwd_dkv") for d in (64, 128))


# phase T: tensor parallelism on one card (A6a). llama3-8b at tp 2, phase 3's
# seed and solo prompts: two ranks share cuda:0 over gloo (NCCL refuses two
# ranks on one device, and gloo stages each CUDA collective through the
# host), and NCCL on cuda:0 and cuda:1 runs too where the machine has two
# cards. The numbers are those of 2 ranks sharing one H100, not a TP speed.
TP = 2
TP_FED = 16  # decode steps teacher-forced with tp 1's greedy ids
TP_TOL = 2e-2  # bf16 logits, max|d| / max|ref|, tp 2 against tp 1 on the same weights
TP_GEN = 16  # tokens per served request
TP_LABEL = {"gloo": "2 ranks sharing one H100 over gloo", "nccl": "2 H100s over NCCL"}


def tp_rank(rank, init_method, devices, prompts, fed, outbox):
    """One rank of phase T's function-level check (a spawned process): its
    shard of the seeded llama3-8b, each prompt prefilled into a slot of its
    own (B1a at this rank's heads, counted), then TP_FED decode steps of
    all slots fed tp 1's ids, then decode steps timed, the last with every
    collective timed. Puts (rank, result) or (rank, traceback)."""
    import hashlib
    import traceback

    import torch
    import torch.distributed as dist

    try:
        from ray_tpu_torch.llm import model_runner
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.models.config import get_config
        from ray_tpu_torch.ops import flash_attention as fa
        from ray_tpu_torch.parallel import MeshSpec, build_mesh

        mesh = build_mesh(MeshSpec(tp=TP), devices, rank=rank, init_method=init_method)
        cfg = get_config("llama3-8b")
        dev = torch.device(devices[rank])
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = llama.init(cfg, seed=0, device=dev, dtype=torch.bfloat16, mesh=mesh)
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        start_peak = torch.cuda.max_memory_allocated(dev)
        heads = (params["layers"]["wq"].shape[2], params["layers"]["wk"].shape[2])
        seen = []  # (q heads, kv heads) of every B1a launch
        real_fwd = fa.flash_attention_forward

        def spy(q, k, v, **kw):
            seen.append((q.shape[2], k.shape[2]))
            return real_fwd(q, k, v, **kw)

        fa.flash_attention_forward = spy
        out = dict(rank=rank, backend=dist.get_backend(), heads=heads, init_s=init_s,
                   start_peak=start_peak, launches=[])
        with torch.no_grad():
            state = model_runner.init_state(cfg, len(prompts), tp_max_len(prompts), dev,
                                            mesh=mesh)
            first = []
            for slot, prompt in enumerate(prompts):
                torch.cuda.synchronize(dev)
                fa.reset_launch_count()
                state, last = model_runner.prefill(params, state, tp_tokens(torch, prompt, dev),
                                                   len(prompt), slot, cfg, mesh=mesh)
                torch.cuda.synchronize(dev)
                out["launches"].append(fa.launch_count())
                first.append(last.float())
            active = torch.ones((len(prompts),), dtype=torch.bool, device=dev)
            steps = []
            for t in range(TP_FED):
                row = torch.tensor([ids[t] for ids in fed], device=dev)
                state, lg = model_runner.decode_step(params, state, row, active, cfg,
                                                     mesh=mesh)
                steps.append(lg)
            first, steps = torch.stack(first).cpu().numpy(), torch.stack(steps).cpu().numpy()
            out["digest"] = hashlib.sha256(first.tobytes() + steps.tobytes()).hexdigest()
            if rank == 0:
                out.update(prefill=first, decode=steps)
            out["heads_seen"] = sorted(set(seen))
            # decode steps of every slot, timed; the last with every collective
            # bracketed by syncs
            row = torch.tensor([ids[TP_FED] for ids in fed], device=dev)

            def step():
                model_runner.decode_step(params, state, row, active, cfg, mesh=mesh)
                torch.cuda.synchronize(dev)

            step()
            walls = []
            for _ in range(3):
                t = time.perf_counter()
                step()
                walls.append(time.perf_counter() - t)
            coll = [0.0, 0]
            real = {name: getattr(dist, name) for name in ("all_reduce", "all_gather")}

            def timed(fn):
                def call(*args, **kw):
                    torch.cuda.synchronize(dev)
                    t = time.perf_counter()
                    r = fn(*args, **kw)
                    torch.cuda.synchronize(dev)
                    coll[0] += time.perf_counter() - t
                    coll[1] += 1
                    return r
                return call

            # the longest prompt prefilled again into its slot, once plain
            # and once with its collectives timed
            long = prompts[-1]

            def fill():
                model_runner.prefill(params, state, tp_tokens(torch, long, dev), len(long),
                                     len(prompts) - 1, cfg, mesh=mesh)
                torch.cuda.synchronize(dev)

            t = time.perf_counter()
            fill()
            fill_wall = time.perf_counter() - t
            for name, fn in real.items():
                setattr(dist, name, timed(fn))
            t = time.perf_counter()
            step()
            synced = time.perf_counter() - t
            step_coll = list(coll)
            coll[:] = [0.0, 0]
            t = time.perf_counter()
            fill()
            fill_synced = time.perf_counter() - t
            for name, fn in real.items():
                setattr(dist, name, fn)
        out.update(step_ms=statistics.median(walls) * 1e3, synced_step_ms=synced * 1e3,
                   collective_ms=step_coll[0] * 1e3, collectives=step_coll[1],
                   prefill_tokens=len(long), prefill_ms=fill_wall * 1e3,
                   synced_prefill_ms=fill_synced * 1e3, prefill_collective_ms=coll[0] * 1e3,
                   prefill_collectives=coll[1])
        outbox.put((rank, out))
        dist.destroy_process_group()
    except BaseException:
        outbox.put((rank, traceback.format_exc()))


def tp_max_len(prompts):
    """Slot length for phase T's prompts: the largest bucket, the fed and
    timed steps, and room to spare."""
    return max(1 << (len(p) - 1).bit_length() for p in prompts) + TP_FED + 16


def tp_tokens(torch, prompt, dev):
    """[1, bucket] ids: the prompt padded to the next power of two."""
    tokens = torch.zeros((1, 1 << (len(prompt) - 1).bit_length()), dtype=torch.long,
                         device=dev)
    tokens[0, :len(prompt)] = torch.tensor(prompt, device=dev)
    return tokens


def tp_ranks_check(torch, devices, prompts, fed):
    """Run tp_rank on len(devices) spawned ranks -> their results by rank;
    exits if a rank fails or does not answer in 300 s, and joins them all."""
    import multiprocessing
    import queue
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        init_method = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    ctx = multiprocessing.get_context("spawn")
    outbox = ctx.Queue()
    procs = [ctx.Process(target=tp_rank, daemon=True,
                         args=(r, init_method, devices, prompts, fed, outbox))
             for r in range(len(devices))]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, out = outbox.get(timeout=300)
            if isinstance(out, str):
                raise SystemExit(f"phase T rank {rank} failed:\n{out}")
            got[rank] = out
    except queue.Empty:
        raise SystemExit("phase T: a rank did not answer within 300 s") from None
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(5)
    return got


def tp1_greedy(torch, params, prompts, dev):
    """tp 1 (one process, `params` whole): each prompt prefilled into a slot
    of its own, then TP_FED greedy decode steps of all slots -> (prefill
    logits [P, V], decode logits [TP_FED, P, V], each prompt's TP_FED + 1
    greedy ids)."""
    from ray_tpu_torch.llm import model_runner
    from ray_tpu_torch.models.config import get_config

    cfg = get_config("llama3-8b")
    with torch.no_grad():
        state = model_runner.init_state(cfg, len(prompts), tp_max_len(prompts), dev)
        first = []
        for slot, prompt in enumerate(prompts):
            state, last = model_runner.prefill(params, state, tp_tokens(torch, prompt, dev),
                                               len(prompt), slot, cfg)
            first.append(last.float())
        fed = [[int(lg.argmax())] for lg in first]
        active = torch.ones((len(prompts),), dtype=torch.bool, device=dev)
        steps = []
        for _ in range(TP_FED):
            row = torch.tensor([ids[-1] for ids in fed], device=dev)
            state, lg = model_runner.decode_step(params, state, row, active, cfg)
            steps.append(lg)
            for ids, tok in zip(fed, lg.argmax(dim=-1).tolist()):
                ids.append(tok)
        ref_first, ref_steps = torch.stack(first).cpu().numpy(), torch.stack(steps).cpu().numpy()
        del state
    torch.cuda.empty_cache()
    return ref_first, ref_steps, fed


def tp_ids_gate(name, runs, first, steps, fed, side="tp 2", base="tp 1", phase="T"):
    """The served `side` (tp 2) greedy ids against `base`'s (tp 1: prefill
    logits `first`, decode logits `steps`, ids `fed`). They must be equal up
    to the base's first near tie, a top-2 logit gap under TP_TOL of
    max|logits|. Where they part, the context is still the same, so the
    token the side took must fall short of the base's top by under 2 TP_TOL
    of max|logits|, what two sets of logits each within TP_TOL of the other
    allow. Prints where they part, the base's top-2 gap there and the taken
    token's shortfall."""
    every = np.concatenate([first[None], steps])  # [TP_FED + 1, P, V]
    scale = np.abs(every).max(axis=-1)
    top2 = np.sort(every, axis=-1)[..., -2:]
    gaps = (top2[..., 1] - top2[..., 0]) / scale
    gates = []
    for i, (r, want) in enumerate(zip(runs, fed)):
        got = r["token_ids"]
        want = want[:len(got)]
        lead = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), len(want))
        tie = next((j for j, g in enumerate(gaps[:, i]) if g < TP_TOL), len(gaps))
        gate = dict(prompt_tokens=r["prompt_tokens"], parted_at=None, first_near_tie=tie)
        if lead < len(want):
            lg = every[lead, i]
            gate.update(parted_at=lead, gap=float(gaps[lead, i]),
                        shortfall=float(lg.max() - lg[got[lead]]) / float(scale[lead, i]))
        gates.append(gate)
        parted = ("none part" if gate["parted_at"] is None else
                  f"they part at token {lead}: {base}'s top-2 gap {gate['gap']:.3e} of "
                  f"max|logits|, {side}'s token {gate['shortfall']:.3e} short of {base}'s "
                  f"top (tol {2 * TP_TOL})")
        print(f"  {name} {side} greedy ids ({r['prompt_tokens']} tokens): {got[:12]}..., the "
              f"first {lead} of {len(want)} as {base}'s, whose first near tie (gap < "
              f"{TP_TOL}) is at token {tie}; {parted}", flush=True)
        if gate["parted_at"] is not None and (lead < tie or gate["shortfall"] >= 2 * TP_TOL):
            raise SystemExit(f"phase {phase} {name}: the served ids part from {base}'s where "
                             f"{base} has no near tie: {gate}")
    return gates


def tp_logits_check(torch, params, card, prompts, devices):
    """tp 1 on phase 3's weights in this process (tp1_greedy), then tp 2 on
    `devices` fed the same ids: prefill and decode logits within TP_TOL of
    max|ref|, rank 0's and rank 1's logits bit-equal, 32 B1a launches per
    rank per prefill at H16/KV4."""
    from ray_tpu_torch.models.config import get_config

    cfg = get_config("llama3-8b")
    dev = torch.device(devices[0])  # tp 1 runs on rank 0's card
    ref_first, ref_steps, fed = tp1_greedy(torch, params, prompts, dev)
    backend = "gloo" if len({str(d) for d in devices}) == 1 else "nccl"
    print(f"  ranks on {devices} ({backend})", flush=True)
    t0 = time.perf_counter()
    got = tp_ranks_check(torch, devices, prompts, fed)
    wall = time.perf_counter() - t0
    r0 = got[0]
    errs = dict(
        prefill=[float(np.abs(r0["prefill"][i] - ref_first[i]).max()
                       / np.abs(ref_first[i]).max()) for i in range(len(prompts))],
        decode=[float(np.abs(r0["decode"][:, i] - ref_steps[:, i]).max()
                      / np.abs(ref_steps[:, i]).max()) for i in range(len(prompts))])
    same = len({r["digest"] for r in got.values()}) == 1
    for r, out in sorted(got.items()):
        print(f"  rank {r} ({out['backend']}): local heads q/kv {out['heads']}, B1a launches "
              f"per prefill {out['launches']} at q/kv heads {out['heads_seen']}; seeded "
              f"shard in {out['init_s']:.2f} s, start peak {out['start_peak'] / 2**30:.2f} GiB; "
              f"{len(prompts)}-slot decode step {out['step_ms']:.3f} ms, collectives "
              f"{out['collective_ms']:.3f} of {out['synced_step_ms']:.3f} ms "
              f"({out['collectives']} calls, synced); {out['prefill_tokens']}-token prefill "
              f"{out['prefill_ms']:.3f} ms, collectives {out['prefill_collective_ms']:.3f} of "
              f"{out['synced_prefill_ms']:.3f} ms ({out['prefill_collectives']} calls, synced) "
              f"[{TP_LABEL[backend]}; {card}]", flush=True)
    print(f"  tp 2 vs tp 1 bf16 logits, max|d|/max|ref| per prompt: prefill "
          f"{[f'{e:.3e}' for e in errs['prefill']]}, {TP_FED} fed decode steps "
          f"{[f'{e:.3e}' for e in errs['decode']]} (tol {TP_TOL}); ranks bit-equal {same}; "
          f"{wall:.1f} s", flush=True)
    want_heads = [(cfg.n_heads // TP, cfg.n_kv_heads // TP)]
    for out in got.values():
        if out["launches"] != [cfg.n_layers] * len(prompts) or out["heads_seen"] != want_heads:
            raise SystemExit(f"phase T: B1a launches {out['launches']} at {out['heads_seen']}, "
                             f"want {cfg.n_layers} per prefill at {want_heads}")
    if max(errs["prefill"] + errs["decode"]) > TP_TOL or not same:
        raise SystemExit("phase T: tp 2 logits disagree with tp 1, or the ranks disagree")
    return dict(devices=[str(d) for d in devices], backend=backend, errs=errs,
                ranks_bit_equal=same, wall_s=wall, fed=fed, ref=(ref_first, ref_steps),
                ranks={r: {k: v for k, v in out.items() if k not in ("prefill", "decode")}
                       for r, out in got.items()})


def tp_serve(torch, fa, card, devices, solo, **kw):
    """LLMServer(LLMConfig(llama3-8b, tensor_parallel_size=2, **kw)) on
    `devices`: three concurrent requests (completions, chat, streamed chat)
    and the `solo` prompts one at a time, with rank 0's B1a count zeroed
    just before and read just after; each request must finish with
    "length"."""
    from ray_tpu_torch.llm import LLMConfig, LLMServer, SamplingParams

    cfg = LLMConfig(model_source="llama3-8b", tensor_parallel_size=TP, **kw)
    t0 = time.perf_counter()
    server = LLMServer(cfg, devices=devices)
    start_s = time.perf_counter() - t0
    eng = server.engine
    body = {"max_tokens": TP_GEN, "temperature": 0.0}
    try:
        torch.cuda.synchronize()
        fa.reset_launch_count()
        prefills0 = eng.num_prefills
        # ---- the tensor-parallel path: counts zeroed just before, read just after ----
        plan = [("completions", {"prompt": prompt_text(100)}),
                ("chat", {"messages": [{"role": "user", "content": prompt_text(300)}]}),
                ("chat", {"messages": [{"role": "user", "content": prompt_text(40)}],
                          "stream": True})]

        def run(i):
            kind, extra = plan[i]
            resp = getattr(server, kind)({**body, **extra})
            if extra.get("stream"):
                frames = list(resp)
                return json.loads(frames[-2][len("data: "):])["choices"][0]["finish_reason"]
            return resp["choices"][0]["finish_reason"]

        reasons, together_s = run_together(run, len(plan), timeout=300)
        runs = []
        for ids in solo:
            t = time.perf_counter()
            stamps, got = [], []
            for out in eng.generate(ids, SamplingParams(max_tokens=TP_GEN, temperature=0.0,
                                                        stop_token_ids=[-1])):
                stamps.append(time.perf_counter())
                got += out.token_ids
            reasons.append(out.finish_reason)
            runs.append(dict(prompt_tokens=out.num_prompt_tokens, ttft_ms=(stamps[0] - t) * 1e3,
                             decode_tok_s=(len(stamps) - 1) / (stamps[-1] - stamps[0]),
                             token_ids=got))
        torch.cuda.synchronize()
        launches = fa.launch_count()
        prefills = eng.num_prefills - prefills0
        # ---- end ----
        server.check_health()
        metrics = eng.metrics()
        n_layers = eng.model_config.n_layers
    finally:
        server.shutdown()
        del server, eng
        torch.cuda.empty_cache()
    print(f"  {kw or 'slot, bf16'}: up in {start_s:.1f} s; reasons {reasons}; {prefills} "
          f"prefills, rank 0's B1a launches {launches}; together {together_s:.2f} s; "
          + "; ".join(f"solo {r['prompt_tokens']} tokens TTFT {r['ttft_ms']:.1f} ms, decode "
                      f"{r['decode_tok_s']:.2f} tok/s" for r in runs)
          + f" [{TP_LABEL['gloo']}; {card}]", flush=True)
    if any(r != "length" for r in reasons) or launches != n_layers * prefills or not prefills:
        raise SystemExit(f"phase T serving {kw}: reasons {reasons}, B1a {launches} for "
                         f"{prefills} prefills")
    return dict(config=kw, start_s=start_s, reasons=reasons, together_s=together_s,
                solo=runs, launches=launches, prefills=prefills, metrics=metrics)


def tp_path(torch, fa, card, params):
    """Phase T: the logits check on two ranks sharing cuda:0 over gloo (and
    over NCCL on cuda:0,1 where there are two cards), then LLMServer at
    tensor_parallel_size=2 in the slot and paged layouts and in int8, on
    phase 3's solo prompts (their tails that leave room for TP_GEN tokens,
    as the engine keeps them)."""
    from ray_tpu_torch.llm.tokenizer import get_tokenizer
    from ray_tpu_torch.ops.quant import quantize_llama_params

    t_phase = time.perf_counter()
    tok = get_tokenizer("byte")
    prompts = [tok.encode(prompt_text(n))[-(1024 - TP_GEN):] for n in SOLO_CHARS]
    shared = ["cuda:0"] * TP
    out = {"logits": {"gloo": tp_logits_check(torch, params, card, prompts, shared)}}
    if torch.cuda.device_count() >= TP:
        out["logits"]["nccl"] = tp_logits_check(torch, params, card, prompts,
                                                [f"cuda:{r}" for r in range(TP)])
    else:
        print(f"  NCCL across cards: not run ({torch.cuda.device_count()} card)", flush=True)
    # TTFT per bucket in the slot layout; the paged engine serves the
    # concurrent requests with the prefix cache off (every prefill whole, B1a
    # n_layers times each); int8 one solo prompt for its greedy ids
    out["slot"] = tp_serve(torch, fa, card, shared, prompts)
    out["paged"] = tp_serve(torch, fa, card, shared, [], enable_prefix_caching=False, **PAGED)
    out["int8"] = tp_serve(torch, fa, card, shared, prompts[:1], quantization="int8")
    # the served ids against tp 1's greedy ids (prefill + TP_FED steps): bf16
    # on phase 3's weights, int8 on them quantized as the tp 2 engine's
    # seeded init quantizes them
    bf16 = out["logits"]["gloo"]
    out["slot"]["ids_gate"] = tp_ids_gate("slot", out["slot"]["solo"], *bf16.pop("ref"),
                                          bf16["fed"])
    for extra in out["logits"].values():
        extra.pop("ref", None)
    qparams = quantize_llama_params(params)
    first8, steps8, fed8 = tp1_greedy(torch, qparams, prompts[:1], torch.device("cuda:0"))
    del qparams
    torch.cuda.empty_cache()
    out["int8"].update(tp1_ids=fed8,
                       ids_gate=tp_ids_gate("int8", out["int8"]["solo"], first8, steps8, fed8))
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase T took {out['wall_s']:.1f} s", flush=True)
    return out


# phase DP: data parallelism on one card (A2f, dp half). llama3-8b at dp 2 on
# phase 3's seed: two replicas of the whole model share cuda:0 over gloo (and
# NCCL on cuda:0 and cuda:1 runs too where the machine has two cards), each
# with 4 of 8 slots and, paged, half the pool and a prefix cache of its own.
# The numbers are those of 2 replicas sharing one H100, not a DP speed.
DP = 2
DP_GEN = 16  # tokens per served request (<= TP_FED + 1: the ids gate's depth)
# four of phase 3's prompts (121, 201, 301, 501 tokens). They share their
# leading text, so a later one hits the prefix cache of its replica; the
# 1001-token one would then fail with "length" in both packages (its cached
# blocks plus its suffix's bucket pass the 32-block table)
DP_CHARS = (120, 200, 300, 500)
DP_ENGINE = dict(model_source="llama3-8b", data_parallel_size=DP, max_num_seqs=8,
                 max_model_len=1024)
DP_PAGED = dict(kv_layout="paged", kv_block_size=32,
                prefill_buckets=[32, 64, 128, 256, 512, 1024])  # bench_serve's, 8 slots


def mesh_logits_check(eng, name, prompts, fed, ref_steps, side, base, phase):
    """Teacher-forced logits of a multi-rank engine on its own ranks, after
    its requests: each prompt prefilled into a slot of its own (the
    replicas take turns), then TP_FED decode steps of those slots fed the
    one-rank greedy ids (ShardRunner.decode_logits: the engine's batched
    decode step, the replicas' rows gathered over "dp", the stages'
    microbatches through the schedule). Every step's logits of every prompt
    must be within TP_TOL of the one-rank run's (`ref_steps`, tp1_greedy) in
    max|d| / max|ref|."""
    c = eng.config
    dp = c.data_parallel_size
    n_slots, per = c.max_num_seqs, c.max_num_seqs // dp
    slots = [i // dp + per * (i % dp) for i in range(len(prompts))]
    greedy = (0.0, 1.0, 0)
    t0 = time.perf_counter()
    for prompt, slot in zip(prompts, slots):
        if c.kv_layout == "paged":
            bucket = next(b for b in c.buckets() if b >= len(prompt))
            ids = eng._blocks.allocate(slot, eng._blocks.blocks_needed(
                max(bucket, len(prompt) + TP_FED + 1)))
            eng._run("prefill_paged", prompt, slot, ids, greedy)
        else:
            eng._run("prefill", prompt, slot, greedy)
    last = np.zeros((n_slots,), np.int64)
    active = np.zeros((n_slots,), bool)
    active[slots] = True
    errs = [0.0] * len(prompts)
    for t in range(TP_FED):
        last[slots] = [ids[t] for ids in fed]
        logits = eng._run("decode_logits", last, active).float().cpu().numpy()
        for i, slot in enumerate(slots):
            ref = ref_steps[t, i]
            errs[i] = max(errs[i], float(np.abs(logits[slot] - ref).max() / np.abs(ref).max()))
    if c.kv_layout == "paged":
        for slot in slots:
            eng._blocks.release(slot)
    print(f"    {name}: teacher-forced {side} vs {base} bf16 logits over {TP_FED} fed decode "
          f"steps, max|d|/max|ref| per prompt {[f'{e:.3e}' for e in errs]} (tol {TP_TOL}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if max(errs) > TP_TOL:
        raise SystemExit(f"phase {phase} {name}: {side}'s logits disagree with {base}'s: {errs}")
    return errs


def weight_share(cfg, pp, dtype_bytes=2):
    """(bytes of a stage's weights: n_layers / pp layers, the embedding,
    final norm and head; bytes of a whole replica's), from the shapes."""
    from ray_tpu_torch.models import llama

    shapes = llama.param_shapes(cfg)
    per_layer = sum(int(np.prod(s[1:])) for s in shapes["layers"].values())
    rest = sum(int(np.prod(shapes[k])) for k in shapes if k != "layers")
    return ((per_layer * (cfg.n_layers // pp) + rest) * dtype_bytes,
            (per_layer * cfg.n_layers + rest) * dtype_bytes)


def mesh_serve(torch, card, devices, prompts, name, engine, check=None, phase="DP",
               side="dp 2", base="dp 1", **kw):
    """TorchLLMEngine(LLMConfig(**engine, **kw)) on `devices` (replicas of
    dp, each of pp stages): the prompts at once (the replicas take turns at
    admission, so all decode), then a repeat of the first alone, each
    DP_GEN greedy tokens; every rank's counts zeroed just before each part
    and read just after. Gates: every request ends with "length" after
    DP_GEN tokens; in the concurrent part each rank launched B1a
    n_layers / pp times per whole prefill it computed and computed one at
    least, and decoded with an active slot; in the repeat every stage of the
    owner replica computed and no other rank (slot layout: one whole
    prefill on each of its stages, B1a n_layers / pp times on each and 0
    elsewhere; paged: a prefix hit on each of its stages in that replica's
    cache, no whole prefill, B1a 0 times anywhere); under pp each rank's
    weights are its reckoned share (weight_share). With `check` (the one-rank
    fed ids and decode logits), mesh_logits_check after."""
    from ray_tpu_torch.llm import LLMConfig, SamplingParams, TorchLLMEngine

    greedy = SamplingParams(max_tokens=DP_GEN, temperature=0.0, stop_token_ids=[-1])
    held = torch.cuda.memory_allocated()  # phase 3's weights, in rank 0's process
    t0 = time.perf_counter()
    eng = TorchLLMEngine(LLMConfig(**engine, **kw), devices=devices)
    eng.start()
    torch.cuda.synchronize()
    start_s = time.perf_counter() - t0
    pp, dp = eng.config.pipeline_parallel_size, eng.config.data_parallel_size
    model_cfg = eng.model_config
    stage_layers = model_cfg.n_layers // pp
    backend = "gloo" if len(set(devices)) == 1 else "nccl"

    def timed(ids, t):
        stamps, got = [], []
        for out in eng.generate(ids, greedy):
            stamps.append(time.perf_counter())
            got += out.token_ids
        return dict(prompt_tokens=out.num_prompt_tokens, finish_reason=out.finish_reason,
                    ttft_ms=(stamps[0] - t) * 1e3, token_ids=got,
                    decode_tok_s=((len(stamps) - 1) / (stamps[-1] - stamps[0])
                                  if len(got) > 1 else 0.0))

    try:
        eng.rank_counts(reset=True)
        # ---- the multi-rank path: counts zeroed just before, read just after ----
        t_all = time.perf_counter()
        runs, wall = run_together(lambda i: timed(prompts[i], t_all), len(prompts), timeout=300)
        together = eng.rank_counts(reset=True)
        # ---- end ----
        subs = getattr(eng._blocks, "subs", None)
        blocks = subs or ([eng._blocks] if eng._blocks is not None else None)
        hits0 = [b.hit_tokens for b in blocks] if blocks else None
        # ---- the repeat: counts zeroed just before, read just after ----
        repeat = timed(prompts[0], time.perf_counter())
        again = eng.rank_counts()
        # ---- end ----
        hits = [b.hit_tokens - h for b, h in zip(blocks, hits0)] if blocks else None
        metrics = eng.metrics()
        errs = (mesh_logits_check(eng, name, prompts, *check, side=side, base=base,
                                  phase=phase) if check else None)
    finally:
        eng.shutdown()
        del eng
        torch.cuda.empty_cache()
    tokens = sum(len(r["token_ids"]) for r in runs)
    for r in together:  # rank 0's peak without what its process held before
        r["peak_gib"] = (r.pop("peak_bytes") - (held if r["rank"] == 0 else 0)) / 2**30
        r["decode_tok_s"] = r["tokens"] / wall
    label = f"[{MESH_LABEL[phase, backend]}; {card}]"
    print(f"  {name}: up in {start_s:.1f} s; " + "; ".join(
        f"{r['prompt_tokens']} tokens TTFT {r['ttft_ms']:.1f} ms, decode "
        f"{r['decode_tok_s']:.2f} tok/s" for r in runs)
        + f"; together {tokens} tokens in {wall:.2f} s = {tokens / wall:.2f} tok/s {label}",
        flush=True)
    for r in together:
        print(f"    rank {r['rank']} (replica {r['replica']}, stage {r['stage']}): "
              f"{r['prefills']} whole prefills, {r['prefix_prefills']} over a cached prefix, "
              f"B1a launches {r['flash_launches']}, {r['active_steps']} decode steps with an "
              f"active slot, {r['tokens']} tokens = {r['decode_tok_s']:.2f} tok/s over the "
              f"part's wall, weights {r['param_bytes'] / 1e9:.3f} GB, peak "
              f"{r['peak_gib']:.2f} GiB beyond what the process held before {label}",
              flush=True)
    owner = [r for r in again if r["prefills"] + r["prefix_prefills"]]
    print(f"    repeat of the {repeat['prompt_tokens']}-token prompt alone: TTFT "
          f"{repeat['ttft_ms']:.1f} ms; ranks that computed it "
          f"{[(r['rank'], r['prefills'], r['prefix_prefills']) for r in owner]}, B1a launches "
          f"by rank {[r['flash_launches'] for r in again]}, prefix hit tokens by replica "
          f"{hits}", flush=True)
    reasons = [(r["finish_reason"], len(r["token_ids"])) for r in runs + [repeat]]
    fails = []
    if any(x != ("length", DP_GEN) for x in reasons):
        fails.append(f"(reason, tokens) {reasons}")
    for r in together:
        if not r["prefills"] or r["flash_launches"] != stage_layers * r["prefills"]:
            fails.append(f"rank {r['rank']}: B1a {r['flash_launches']} for {r['prefills']} "
                         f"whole prefills ({stage_layers} layers)")
        if not r["active_steps"]:
            fails.append(f"rank {r['rank']} decoded no step with an active slot")
    replicas = {r["replica"] for r in owner}
    if len(replicas) != 1 or len(owner) != len(again) // dp:
        fails.append(f"the repeat ran on ranks {[r['rank'] for r in owner]}")
    elif blocks is None:
        if any(r["prefills"] != 1 for r in owner) or [r["flash_launches"] for r in again] != [
                stage_layers if r in owner else 0 for r in again]:
            fails.append(f"the repeat's prefill: {again}")
    elif any(r["prefix_prefills"] != 1 for r in owner) or any(
            r["flash_launches"] for r in again) or not hits[owner[0]["replica"]] or \
            sum(hits) != hits[owner[0]["replica"]]:
        fails.append(f"the repeat missed its replica's prefix cache: hits {hits}, {again}")
    share = None
    if pp > 1:
        share = weight_share(model_cfg, pp)
        print(f"    weights per stage rank {[r['param_bytes'] for r in together]} B, reckoned "
              f"{share[0]} B of a replica's {share[1]} B", flush=True)
        if any(r["param_bytes"] != share[0] for r in together):
            fails.append(f"a stage holds other than its share {share[0]} B: "
                         f"{[r['param_bytes'] for r in together]}")
    if fails:
        raise SystemExit(f"phase {phase} {name}: " + "; ".join(fails))
    return dict(config=kw, devices=[str(d) for d in devices], backend=backend,
                start_s=start_s, runs=runs, wall_s=wall, tokens=tokens,
                decode_tok_s=tokens / wall, ranks=together, repeat=repeat, repeat_ranks=again,
                repeat_hits=hits, metrics=metrics, logits_errs=errs, weight_share=share,
                launches=[r["flash_launches"] for r in together],
                launches_repeat=[r["flash_launches"] for r in again])


def serve_reference(torch, params):
    """The one-rank reference of phases DP and PP on phase 3's weights: the
    DP_CHARS prompts, each in a slot of its own (tp1_greedy) -> (prompts,
    prefill logits, decode logits, greedy ids)."""
    from ray_tpu_torch.llm.tokenizer import get_tokenizer

    tok = get_tokenizer("byte")
    prompts = [tok.encode(prompt_text(n))[-(1024 - DP_GEN):] for n in DP_CHARS]
    return (prompts, *tp1_greedy(torch, params, prompts, torch.device("cuda:0")))


def ids_gates(out, reference, side, base, phase):
    """tp_ids_gate over every engine's requests and repeat (the repeat is
    prompt 0 again: its column of the reference once more)."""
    _, first, steps, fed = reference
    first, steps, fed = (np.concatenate([first, first[:1]]),
                         np.concatenate([steps, steps[:, :1]], axis=1), fed + [fed[0]])
    for name, run in out.items():
        run["ids_gate"] = tp_ids_gate(name, run["runs"] + [run["repeat"]], first, steps, fed,
                                      side=side, base=base, phase=phase)


def dp_path(torch, fa, card, params, reference=None):
    """Phase DP: dp 1's greedy ids on phase 3's weights (serve_reference, each
    prompt in a slot of its own), then TorchLLMEngine at data_parallel_size 2
    on two ranks sharing cuda:0 over gloo: the slot layout, paged (prefix
    cache on, fused bursts at the default width) and paged with n-gram
    speculation (k = 4), each serving the four prompts at once and a repeat
    (mesh_serve); every served request's ids equal dp 1's up to dp 1's first
    near tie (tp_ids_gate), and the slot and paged engines' teacher-forced
    logits are within TP_TOL of dp 1's at every fed step (mesh_logits_check).
    Where there are two cards, the slot engine runs over NCCL on cuda:0 and
    cuda:1 too."""
    t_phase = time.perf_counter()
    reference = reference or serve_reference(torch, params)
    prompts, _, steps, fed = reference
    shared = ["cuda:0"] * DP
    check = (fed, steps)

    def serve(devices, name, check=None, **kw):
        return mesh_serve(torch, card, devices, prompts, name, DP_ENGINE, check, **kw)

    out = {"slot": serve(shared, "slot", check),
           "paged": serve(shared, "paged", check, **DP_PAGED),
           "spec": serve(shared, "paged, n-gram k 4", **DP_PAGED,
                         num_speculative_tokens=SPEC_K)}
    if torch.cuda.device_count() >= DP:
        out["slot_nccl"] = serve([f"cuda:{r}" for r in range(DP)], "slot over NCCL")
    else:
        print(f"  NCCL across cards: not run ({torch.cuda.device_count()} card)", flush=True)
    ids_gates(out, reference, "dp 2", "dp 1", "DP")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase DP took {out['wall_s']:.1f} s", flush=True)
    return out


# phase PP: pipeline parallelism on one card (A2g). llama3-8b at pp 2 on phase
# 3's seed: two stages of 16 layers each, holding their layers' weights and
# KV, share cuda:0 over gloo (and NCCL on cuda:0 and cuda:1 runs too where the
# machine has two cards); then pp 2 x dp 2, four ranks. The numbers are those
# of ranks sharing one H100 over gloo: not a pp speed.
PP = 2
PP_ENGINE = dict(model_source="llama3-8b", pipeline_parallel_size=PP, max_num_seqs=8,
                 max_model_len=1024)
MESH_LABEL = {("DP", "gloo"): "2 replicas sharing one H100 over gloo",
              ("DP", "nccl"): "2 H100s over NCCL",
              ("PP", "gloo"): "not a pp speed: ranks share one card over gloo",
              ("PP", "nccl"): "2 stages on 2 H100s over NCCL"}


def pp_path(torch, fa, card, params, reference=None):
    """Phase PP: pp 1's greedy ids on phase 3's weights (serve_reference),
    then TorchLLMEngine at pipeline_parallel_size 2 on two ranks sharing
    cuda:0 over gloo, each holding its 16 layers and their KV: the slot
    layout, paged (bench_serve's 32-token blocks, prefix cache on) and paged
    with n-gram speculation (k = 4), then paged at pp 2 x dp 2 on four
    ranks, each serving the four prompts at once and a repeat (mesh_serve:
    B1a 16 times per whole prefill on each stage rank of the owning
    replica, the paged repeat a hit in that replica's cache on both its
    stages, each stage's weight bytes its share); every served request's ids
    equal pp 1's up to pp 1's first near tie (tp_ids_gate), and the slot and
    paged engines' teacher-forced logits are within TP_TOL of pp 1's at every
    fed step (mesh_logits_check). Where there are two cards, the slot engine
    runs over NCCL on cuda:0 and cuda:1 too."""
    t_phase = time.perf_counter()
    reference = reference or serve_reference(torch, params)
    prompts, _, steps, fed = reference
    check = (fed, steps)

    def serve(n, name, check=None, **kw):
        return mesh_serve(torch, card, ["cuda:0"] * n, prompts, name, PP_ENGINE, check,
                          phase="PP", side="pp 2", base="pp 1", **kw)

    out = {"slot": serve(PP, "slot", check),
           "paged": serve(PP, "paged", check, **DP_PAGED),
           "spec": serve(PP, "paged, n-gram k 4", **DP_PAGED, num_speculative_tokens=SPEC_K),
           "pp2dp2": serve(PP * DP, "paged, pp 2 x dp 2", **DP_PAGED,
                           data_parallel_size=DP)}
    if torch.cuda.device_count() >= PP:
        out["slot_nccl"] = mesh_serve(torch, card, [f"cuda:{r}" for r in range(PP)], prompts,
                                      "slot over NCCL", PP_ENGINE, phase="PP", side="pp 2",
                                      base="pp 1")
    else:
        print(f"  NCCL across cards: not run ({torch.cuda.device_count()} card)", flush=True)
    ids_gates(out, reference, "pp 2", "pp 1", "PP")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase PP took {out['wall_s']:.1f} s", flush=True)
    return out


def ptxas_report(_build):
    """Print each kernel's registers and spills from its library's build log
    (nvcc -Xptxas -v); return {kernel: (spill store bytes, spill load bytes)}."""
    spills = {}
    for name in _build.LIBRARIES:
        with open(os.path.join(os.path.dirname(_build.build(name)), "build.log")) as f:
            log = f.read()
        entry = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"\d(flash_[a-z0-9_]+?_kernel)ILi(\d+)E", line)
                entry = f"{m.group(1)}<{m.group(2)}>" if m else line.strip()
            elif "ptxas info" in line and "registers" in line:
                print(f"  {name} {entry}: {line.split(':', 1)[1].strip()}", flush=True)
            elif "spill stores" in line:
                print(f"  {name} {entry}: {line.strip()}", flush=True)
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m:
                    spills[entry] = (int(m.group(1)), int(m.group(2)))
    return spills


def sass_counts(_build):
    """For every kernel of every built library, how many HGMMA, UTMALDG,
    UTMASTG and HMMA instructions `cuobjdump -sass` finds in it."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = {}
    for name in _build.LIBRARIES:
        text = subprocess.run([cuobjdump, "-sass", _build.build(name)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        func = None
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                k = re.search(r"\d(flash_[a-z0-9_]+?_kernel)ILi(\d+)E", m.group(1))
                func = f"{k.group(1)}<{k.group(2)}>" if k else m.group(1)
                out[func] = dict.fromkeys(SASS_OPS, 0)
            elif func is not None:
                for op in SASS_OPS:
                    if re.search(rf"\b{op}\b", line):
                        out[func][op] += 1
    return out


def header(t_start, text):
    """A phase's header line, with the seconds since the run started."""
    print(f"{text} ({time.perf_counter() - t_start:.1f} s into the run)", flush=True)


def build_all(_build):
    """One nvcc per library, all started together; then load each."""
    with ThreadPoolExecutor(len(_build.LIBRARIES)) as pool:
        list(pool.map(_build.build, _build.LIBRARIES))
    for name in _build.LIBRARIES:
        _build.load(name)


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", dest="json_path", default=None,
                        help="also write every number to this JSON file")
    json_path = parser.parse_args().json_path
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    t_start = time.perf_counter()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    build_all(_build)
    build_s = time.perf_counter() - t0
    print(f"  built {sorted(_build.LIBRARIES)} in {build_s:.2f} s", flush=True)
    spills = ptxas_report(_build)
    sass = sass_counts(_build)
    for func, counts in sorted(sass.items()):
        print(f"  sass {func}: " + ", ".join(f"{op} {n}" for op, n in counts.items()),
              flush=True)

    header(t_start, "[2] kernels against their plain versions")
    for func in WGMMA_KERNELS:  # every bf16 kernel runs on wgmma, fed by TMA, spilling nothing
        counts = sass.get(func, {})
        if not counts.get("HGMMA") or not counts.get("UTMALDG") or counts.get("HMMA", 1):
            raise SystemExit(f"{func}: its SASS needs HGMMA > 0, UTMALDG > 0 and HMMA = 0: "
                             f"{counts}")
        if spills.get(func, (1, 1)) != (0, 0):
            raise SystemExit(f"{func}: ptxas spill stores / loads {spills.get(func)}, want 0")
    print(f"  SASS and spills of {len(WGMMA_KERNELS)} bf16 kernels ok: HGMMA > 0, UTMALDG > 0, "
          "HMMA 0, no spills", flush=True)
    checks = kernel_checks(torch, fa)
    bwd_checks = backward_checks(torch, fa)
    buckets = [16, 32, 64, 128, 256, 512, 1024]
    timings = kernel_timings(torch, fa, buckets)
    train_timings, sdpa_bwd = training_timings(torch, fa)

    header(t_start, "[3] serving path: llama3-8b served on the card")
    served, params = main_path(torch, fa, card)

    header(t_start, "[4] served model output against the plain path")
    numerics = output_check(torch)

    header(t_start, "[T] tensor parallelism: llama3-8b at tp 2 on one card, against tp 1 on phase 3's "
          "weights, and served")
    tp_served = tp_path(torch, fa, card, params)

    header(t_start, "[DP] data parallelism: llama3-8b at dp 2 on one card, served in the slot and "
           "paged layouts and with speculation, against dp 1 on phase 3's weights")
    t0 = time.perf_counter()
    mesh_ref = serve_reference(torch, params)  # dp 1 = pp 1: one rank, the whole model
    print(f"  the one-rank reference of DP and PP took {time.perf_counter() - t0:.1f} s",
          flush=True)
    dp_served = dp_path(torch, fa, card, params, mesh_ref)

    header(t_start, "[PP] pipeline parallelism: llama3-8b at pp 2 (and pp 2 x dp 2) on one card, "
           "served in the slot and paged layouts and with speculation, against pp 1 on phase "
           "3's weights")
    pp_served = pp_path(torch, fa, card, params, mesh_ref)

    header(t_start, "[5] paged serving: llama3-8b with bench_serve's paged settings")
    paged_served = paged_path(torch, fa, card, params)

    header(t_start, "[6] int8 weights and n-gram speculation: llama3-8b on the same weights")
    quant_served = quant_path(torch, fa, card, params, served)
    spec_served = spec_path(torch, fa, card, params)

    header(t_start, "[6b] P/D disaggregation and the serving surface: llama3-8b on the same "
           "weights")
    pd_served = pd_path(torch, fa, card, params)

    header(t_start, "[A] a llama3-8b checkpoint in HF's release layout (bf16, 4 shards): written, "
          "loaded and served")
    ckpt_served = checkpoint_serve_path(torch, fa, card, params, served)
    del params
    torch.cuda.empty_cache()

    header(t_start, "[7] training path: llama8b-geom2 trained on the card, remat dots and full")
    trained_runs = {policy: train_path(torch, fa, card, policy) for policy in ("dots", "full")}
    trained = trained_runs["dots"]  # bench.py's policy
    print(f"  dots against full: step {trained['step_ms']:.2f} vs "
          f"{trained_runs['full']['step_ms']:.2f} ms, MFU {trained['mfu_bf16_peak']:.4f} vs "
          f"{trained_runs['full']['mfu_bf16_peak']:.4f}, peak {trained['peak_gib']:.2f} vs "
          f"{trained_runs['full']['peak_gib']:.2f} GiB [{card}]", flush=True)

    header(t_start, "[8] training gradients against the plain path")
    train_check = train_numerics(torch, fa)

    header(t_start, "[F] training on a device mesh: llama8b-geom2 on fsdp 2 x tp 2, four ranks sharing "
          "the card over gloo, against the one-rank step")
    mesh_trained = mesh_train_path(torch, fa, card)

    header(t_start, "[9] MoE serving: mixtral-8x7b, int8, one card")
    moe_served = moe_path(torch, fa, card)

    header(t_start, "[B] MoE training: mixtral-8x7b's geometry at 2 layers trained on the card, saved, "
          "loaded, warm-started and served in int8 from the directory")
    moe_trained = moe_train_path(torch, fa, card)

    header(t_start, "[R] RLlib PPO on the card: the learner at bench_rllib's geometry, PPO on its "
          "Atari-shaped env, the GAE and V-trace scans")
    rl = rl_path(torch, fa, card)

    header(t_start, "[O] RLlib off-policy and offline on the card: DQN, SAC, CQL and MARWIL learners "
          "against the CPU, DQN on CartPole, SAC on Pendulum, BC, MARWIL and CQL from "
          "recorded rows")
    rl_off = rl_offpolicy_path(torch, fa, card)

    header(t_start, "[M] RLlib multi-agent PPO on the card: a two-module learner at bench_rllib's "
          "geometry against the CPU, a shared and two separate policies on CartPole copies")
    rl_ma = rl_multi_agent_path(torch, fa, card, rl["learner"]["minibatch_update_ms"])

    header(t_start, "[D] RLlib DreamerV3 on the card: the learner at the JAX defaults against the "
          "CPU, DreamerV3 on CartPole, the world-model loss and a checkpoint")
    rl_dreamer = rl_dreamer_path(torch, fa, card)

    header(t_start, "[I] RLlib IMPALA and APPO on the card: both learners at bench_rllib's widths "
          "against the CPU, IMPALA on CartPole, APPO's checkpoint")
    rl_impala = rl_impala_path(torch, fa, card)

    sources = {"flash_fwd": ("ray_tpu_torch/ops/csrc/flash_fwd.cu",
                             "ray_tpu/ops/flash_attention.py:123"),
               "flash_bwd_dq": ("ray_tpu_torch/ops/csrc/flash_bwd.cu",
                                "ray_tpu/ops/flash_attention.py:201"),
               "flash_bwd_dkv": ("ray_tpu_torch/ops/csrc/flash_bwd.cu",
                                 "ray_tpu/ops/flash_attention.py:253")}
    bwd_err = max(max(e["max_abs_err"] for e in r["errs"].values())
                  for r in bwd_checks if r["dtype"] == "bfloat16" and r["s"] == TRAIN_SHAPE["s"])
    fwd_err = max(r["err_o"] for r in checks
                  if r["dtype"] == "bfloat16" and r["s"] == TRAIN_SHAPE["s"])
    status = {"flash_fwd": "redesigned, PR 6", "flash_bwd_dq": "redesigned, PR 7",
              "flash_bwd_dkv": "redesigned, PR 7"}
    kernels = []
    for name, (source, replaces) in sources.items():
        t = train_timings[name]
        kernels.append({
            "name": name, "route": "cuda", "status": status.get(name, "ported"),
            "source": source,
            "replaces": replaces, "launches": trained["launches"][name],
            "max_abs_err": fwd_err if name == "flash_fwd" else bwd_err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"], "library_ratio": t["ms"] / t["library_ms"],
            "shape": "B6 S2048 H32/8 D128 bf16 causal",
        })
    kernels[0]["launches_serving"] = served["launches"]
    kernels[0]["launches_paged"] = paged_served["launches"]
    kernels[0]["launches_int8"] = quant_served["launches"]
    kernels[0]["launches_spec"] = sum(r["launches"] for layout in ("slot", "paged")
                                      for r in spec_served[layout].values())
    kernels[0]["launches_moe"] = moe_served["launches"]
    kernels[0]["launches_pd"] = pd_served["launches"]
    for k in kernels:  # per rank per step, on each rank's B2 and H16/KV4
        k["launches_train_mesh"] = mesh_trained["launches_per_rank_per_step"][k["name"]]
    kernels[0]["launches_tp"] = {  # per rank per prefill at H16/KV4; rank 0 while served
        "per_rank_per_prefill": tp_served["logits"]["gloo"]["ranks"][0]["launches"],
        **{name: tp_served[name]["launches"] for name in ("slot", "paged", "int8")}}
    kernels[0]["launches_dp"] = {  # by rank: the four prompts together, then the repeat alone
        name: {"together": run["launches"],
               "whole_prefills": [r["prefills"] for r in run["ranks"]],
               "repeat": run["launches_repeat"]}
        for name, run in dp_served.items() if name != "wall_s"}
    kernels[0]["launches_pp"] = {  # by rank: the four prompts together, then the repeat alone
        name: {"together": run["launches"],
               "stages": [r["stage"] for r in run["ranks"]],
               "replicas": [r["replica"] for r in run["ranks"]],
               "whole_prefills": [r["prefills"] for r in run["ranks"]],
               "repeat": run["launches_repeat"]}
        for name, run in pp_served.items() if name != "wall_s"}
    kernels[0]["design"] = (
        "bf16: a producer warpgroup keeps a 3-stage TMA ring of 128-row K/V tiles "
        "(mbarrier full/empty); two consumer warpgroups of 64 q rows run S = QK^T and "
        "O += PV on wgmma m64n128k16 (P from registers, V MN-major), setmaxnreg 24/240, "
        "O through shared memory and a TMA store")
    kernels[1]["design"] = (
        "bf16: a producer warpgroup loads Q and dO of 128 q rows once and keeps a 4-slot "
        "TMA ring of 64-row K/V tiles; two consumer warpgroups of 64 q rows run S = QK^T "
        "and dP = dO V^T on wgmma m64n64k16 and dQ += dS K on wgmma m64nDk16 (dS from "
        "registers, K MN-major), issuing S_t, dP_t with dQ += dS_{t-1} K_{t-1}; delta from "
        "dO in shared memory; dQ through shared memory and a TMA store; last q tile first")
    kernels[2]["design"] = (
        "bf16: a producer warpgroup loads K and V of 128 kv rows once and keeps a 4-slot "
        "TMA ring of 64-row Q/dO tiles with their LSE, delta and segment ids (plain loads); "
        "two consumer warpgroups of 64 kv rows run S^T = KQ^T and dP^T = V dO^T on wgmma "
        "m64n64k16, then dV += P^T dO and dK += dS^T Q on wgmma m64nDk16 (A from registers, "
        "dO and Q MN-major from the same slot), dK/dV summed over the n_rep q heads in f32 "
        "registers, out through shared memory and TMA stores; kv tile 0 first")
    total_s = time.perf_counter() - t_start
    print(f"  whole run {total_s:.1f} s", flush=True)
    report = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  build_s=build_s, sass=sass, checks=checks, backward_checks=bwd_checks,
                  timings=timings, training_timings=train_timings, sdpa_backward=sdpa_bwd,
                  served=served, numerics=numerics, tensor_parallel=tp_served,
                  data_parallel=dp_served, pipeline_parallel=pp_served,
                  paged=paged_served,
                  int8=quant_served, spec=spec_served, pd=pd_served,
                  trained=trained_runs, train_numerics=train_check,
                  mesh_training=mesh_trained, moe=moe_served,
                  checkpoint=ckpt_served, moe_trained=moe_trained, rl=rl,
                  rl_offpolicy=rl_off, rl_multi_agent=rl_ma, rl_dreamer=rl_dreamer,
                  rl_impala=rl_impala,
                  kernels=kernels,
                  total_s=total_s)
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
