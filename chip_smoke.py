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
     the prefill and training shapes, B1b and B1c (backward) at the training
     shape (B6 S2048 H32/8 D128 causal), a segment-id shape, the same tile
     edges and a tiny one; each kernel's time (CUDA events, and
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
     at batch 1 and 8 of 96 tokens in f32, as there (one f32 copy of the
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
TRAIN_GRAD_TOL = 1e-3  # full-width f32 gradients through 2 layers, same relative form
TRAIN_LOSS_TOL = 1e-5  # relative
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SOLO_REPEATS = 3  # solo requests per TTFT bucket
SOLO_CHARS = (120, 500, 1000)  # solo prompts of phase 3 (and A): buckets 128, 512, 1024
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
SPEC_GEN = 96  # tokens per oracle request (bench_spec_modes' gen_tokens)
SPEC_BATCHES = (1, 8)  # concurrent oracle requests (bench_serve.py:1600)
NGRAM_GEN = 64  # tokens per n-gram request
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
            for out in eng.generate(ids, SamplingParams(max_tokens=64, temperature=0.0,
                                                        stop_token_ids=[-1])):
                stamps.append(time.perf_counter())
                got += out.token_ids
            n_tokens = len(got)
            if n_tokens != 64 or out.finish_reason != "length":
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
    solo = [solo_request(eng, eng.tokenizer.encode(prompt_text(n)), 64)
            for n in (120, 500, 1000)]
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

    import numpy as np

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
        for batch in SPEC_BATCHES:
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
    and kept in `stages`)."""

    def __init__(self, rows, stages=None):
        self.rows, self.stages = rows, stages if stages is not None else []

    def map(self, fn):
        return _ListDataset([fn(dict(r)) for r in self.rows], self.stages)

    def map_batches(self, fn, batch_size=16, fn_constructor_args=(), concurrency=1):
        import numpy as np

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
MOE_GEN = 32  # tokens per served MoE request
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
                max_tokens=64, temperature=0.0, stop_token_ids=[-1]))
            ids[n_chars] = out.token_ids
        torch.cuda.synchronize()
        launches, prefills = fa.launch_count(), eng.num_prefills - prefills0
        # ---- end ----
        repeats_agree = all(r["token_ids"] == want[r["n_chars"]] for r in served["solo"])
        same_ids = all(ids[n] == want[n] for n in SOLO_CHARS)
        print(f"  3 greedy prompts of {list(SOLO_CHARS)} chars x 64 tokens: ids identical to "
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


SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "HMMA")  # wgmma, TMA load / store, mma.sync
# the bf16 kernels of B1a, B1b and B1c at D = 64 and 128
WGMMA_KERNELS = tuple(f"flash_{k}_bf16_wgmma_kernel<{d}>"
                      for k in ("fwd", "bwd_dq", "bwd_dkv") for d in (64, 128))


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

    print("[2] kernels against their plain versions", flush=True)
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

    print("[3] serving path: llama3-8b served on the card", flush=True)
    served, params = main_path(torch, fa, card)

    print("[4] served model output against the plain path", flush=True)
    numerics = output_check(torch)

    print("[5] paged serving: llama3-8b with bench_serve's paged settings", flush=True)
    paged_served = paged_path(torch, fa, card, params)

    print("[6] int8 weights and n-gram speculation: llama3-8b on the same weights",
          flush=True)
    quant_served = quant_path(torch, fa, card, params, served)
    spec_served = spec_path(torch, fa, card, params)

    print("[6b] P/D disaggregation and the serving surface: llama3-8b on the same weights",
          flush=True)
    pd_served = pd_path(torch, fa, card, params)

    print("[A] a llama3-8b checkpoint in HF's release layout (bf16, 4 shards): written, "
          "loaded and served", flush=True)
    ckpt_served = checkpoint_serve_path(torch, fa, card, params, served)
    del params
    torch.cuda.empty_cache()

    print("[7] training path: llama8b-geom2 trained on the card, remat dots and full",
          flush=True)
    trained_runs = {policy: train_path(torch, fa, card, policy) for policy in ("dots", "full")}
    trained = trained_runs["dots"]  # bench.py's policy
    print(f"  dots against full: step {trained['step_ms']:.2f} vs "
          f"{trained_runs['full']['step_ms']:.2f} ms, MFU {trained['mfu_bf16_peak']:.4f} vs "
          f"{trained_runs['full']['mfu_bf16_peak']:.4f}, peak {trained['peak_gib']:.2f} vs "
          f"{trained_runs['full']['peak_gib']:.2f} GiB [{card}]", flush=True)

    print("[8] training gradients against the plain path", flush=True)
    train_check = train_numerics(torch, fa)

    print("[9] MoE serving: mixtral-8x7b, int8, one card", flush=True)
    moe_served = moe_path(torch, fa, card)

    print("[B] MoE training: mixtral-8x7b's geometry at 2 layers trained on the card, saved, "
          "loaded, warm-started and served in int8 from the directory", flush=True)
    moe_trained = moe_train_path(torch, fa, card)

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
                  served=served, numerics=numerics, paged=paged_served,
                  int8=quant_served, spec=spec_served, pd=pd_served,
                  trained=trained_runs, train_numerics=train_check, moe=moe_served,
                  checkpoint=ckpt_served, moe_trained=moe_trained,
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
