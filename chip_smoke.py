#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no result):
  1. the card's name and power limit, the torch and CUDA versions; build every
     kernel library from ops/csrc with nvcc (sm_90a), one nvcc per source, all
     started together, and print the build time, each kernel's registers and
     spills (ptxas) and its counts of HGMMA, UTMALDG, UTMASTG and HMMA
     instructions (cuobjdump -sass);
  2. the bf16 forward's SASS must hold HGMMA and UTMALDG (wgmma fed by TMA);
     every kernel against its plain PyTorch version on the card, at the shapes
     the main paths give it, the edges of the 128-row tiles (S = 127, 129,
     2047, Sq != Skv) and a tiny ragged one, in bf16 and f32, with the
     stated tolerance: B1a (forward) at the prefill and training shapes, B1b
     and B1c (backward) at the training shape (B6 S2048 H32/8 D128 causal), a
     segment-id shape and a tiny one; each kernel's time (CUDA events, and
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
  5. the training path: make_train_step(llama8b-geom2, make_optimizer(
     warmup_steps=2, total_steps=1000)) in bf16 with f32 parameters and
     remat=full, on one seeded batch of 6 x 2049 tokens: one warm-up step, then
     TRAIN_STEPS timed steps with the launch counts zeroed just before and read
     just after (B1a must launch 2 x n_layers times a step, B1b and B1c
     n_layers times each); finite losses and grad norms, the last loss below
     the first timed one; step time, tokens/s, MFU against the bf16 peak, peak
     memory; torch.profiler over one step;
  6. the training numerics at full width: llama8b-geom2 in f32 at B1 S256,
     loss_fn's value and every parameter's gradient through the kernels against
     the same step with attention_impl="reference";
  7. a JSON line of the kernels, the card's name and power limit, and last the
     line {"ok": true, "device": {...}}.
With ``--json PATH`` a copy of every number is written to PATH as JSON.
"""
import dataclasses
import json
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
TRAIN_SHAPE = dict(b=6, s=2048, h=32, hkv=8, d=128)  # llama8b-geom2's attention at B6 S2048
TRAIN_STEPS = 8  # timed steps after one warm-up step


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
    for dtype, tol in ((torch.bfloat16, BWD_BF16_TOL), (torch.float32, BWD_F32_TOL)):
        for c in cases:
            b, s, h, hkv, d = c["b"], c["s"], c["h"], c["hkv"], c["d"]
            q, k, v, do, seg = attn_inputs(torch, gen, b, s, h, hkv, d, dtype, c["seg"])
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
            print(f"  flash_bwd {row['dtype']:8s} B{b} S{s} H{h}/{hkv} D{d} "
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

    text = ("In the beginning the framework ran on one chip, and its users paid for "
            "every second the chip spent waiting. ")

    def prompt(n_chars):
        return (text * (n_chars // len(text) + 1))[:n_chars]

    # (kind, stream, temperature, prompt chars) -> prompt tokens + template
    plan = [
        ("chat", False, 0.0, 10),      # bucket 32
        ("completions", False, 0.8, 100),  # bucket 128
        ("chat", True, 0.7, 300),      # bucket 512
        ("completions", True, 0.0, 700),   # bucket 1024
        ("completions", False, 0.0, 40),   # bucket 64
        ("chat", True, 0.9, 200),      # bucket 256
    ]
    results = [None] * len(plan)
    errors = []

    def run(i, kind, stream, temp, n_chars):
        try:
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
                results[i] = dict(kind=kind, stream=True, temperature=temp,
                                  frames=len(frames), wall_s=time.perf_counter() - t,
                                  finish_reason=final["choices"][0]["finish_reason"])
            else:
                usage = resp["usage"]
                if usage["completion_tokens"] < 1 or resp["choices"][0]["finish_reason"] \
                        not in ("length", "stop"):
                    raise AssertionError(f"request {i} returned no tokens: {resp}")
                results[i] = dict(kind=kind, stream=False, temperature=temp,
                                  prompt_tokens=usage["prompt_tokens"],
                                  completion_tokens=usage["completion_tokens"],
                                  wall_s=time.perf_counter() - t,
                                  finish_reason=resp["choices"][0]["finish_reason"])
        except BaseException as e:  # recorded and re-raised by the caller
            errors.append((i, repr(e)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prefills0, gen0 = eng.num_prefills, eng.total_generated
    fa.reset_launch_count()
    # ---- the main path: counts zeroed just before, read just after ----
    t_phase = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i, *p), daemon=True, name=f"req-{i}")
               for i, p in enumerate(plan)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads) or errors or None in results:
        raise SystemExit(f"concurrent requests failed: errors={errors} results={results}")
    phase_s = time.perf_counter() - t_phase
    phase_tokens = eng.total_generated - gen0

    solo = []
    from ray_tpu_torch.llm import SamplingParams

    # host time on a shared machine moves these numbers between calls, so each
    # bucket runs SOLO_REPEATS times in turn and the spread is reported
    for _ in range(SOLO_REPEATS):
        for n_chars in (120, 500, 1000):  # prompt buckets 128, 512, 1024
            ids = eng.tokenizer.encode(prompt(n_chars))
            t = time.perf_counter()
            stamps, n_tokens = [], 0
            for out in eng.generate(ids, SamplingParams(max_tokens=64, temperature=0.0,
                                                        stop_token_ids=[-1])):
                stamps.append(time.perf_counter())
                n_tokens += len(out.token_ids)
            if n_tokens != 64 or out.finish_reason != "length":
                raise SystemExit(f"solo request ended with {n_tokens} tokens "
                                 f"({out.finish_reason})")
            ttft_ms = (stamps[0] - t) * 1e3
            tps = (len(stamps) - 1) / (stamps[-1] - stamps[0])
            # the engine keeps the prompt's tail that leaves room for max_tokens
            solo.append(dict(prompt_tokens=out.num_prompt_tokens, ttft_ms=ttft_ms,
                             decode_tok_s=tps, tokens=n_tokens))
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
    profile = where_time_goes(torch, server)
    server.shutdown()
    del server, eng
    torch.cuda.empty_cache()
    return dict(init_s=init_s, requests=results, phase_s=phase_s,
                phase_tokens=phase_tokens, aggregate_tok_s=phase_tokens / phase_s,
                solo=solo, peak_gib=peak_gb, launches=launches, prefills=prefills,
                n_layers=n_layers, profile=profile)


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


def where_time_goes(torch, server):
    """torch.profiler over one prefill (bucket 512) and one 8-slot decode step
    of the served model."""
    from ray_tpu_torch.llm import model_runner

    eng = server.engine
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
    """Kernel launches of one train step with remat=full: B1a in the forward
    and again in each layer's recomputation, B1b and B1c once per layer."""
    return {"flash_fwd": 2 * n_layers, "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers}


def train_path(torch, fa, card):
    """llama8b-geom2 trained on the card through make_train_step."""
    from ray_tpu_torch.models.config import get_config
    from ray_tpu_torch.train import init_state, make_optimizer, make_train_step

    cfg = get_config("llama8b-geom2")  # remat=True, remat_policy="full", bf16
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
    print(f"  median step {step_s * 1e3:.2f} ms, {tok_s:.1f} tokens/s, 6*N*tokens/s "
          f"over {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s (MFU against the bf16 peak) "
          f"{mfu:.4f}; peak device memory {peak_gib:.2f} GiB [{card}]", flush=True)
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
    profile = profile_once(torch, "train_step", lambda: step(state, batch))
    del state, step, batch
    torch.cuda.empty_cache()
    return dict(init_s=init_s, warmup=warm, steps=steps, step_ms=step_s * 1e3,
                tokens_per_step=tokens, tokens_per_s=tok_s, mfu_bf16_peak=mfu,
                peak_gib=peak_gib, launches=launches, launches_per_step=want,
                n_params=cfg.n_params, profile=profile)


def train_numerics(torch, fa):
    """llama8b-geom2 in f32 at B1 S256: loss_fn's value and every parameter's
    gradient through the kernels (attention on the auto path, which takes
    flash on the card) against attention_impl="reference"."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.config import get_config

    cfg = get_config("llama8b-geom2", dtype="float32")
    params = llama.init(cfg, seed=3, device="cuda", dtype=torch.float32)
    leaves = llama.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 257), generator=gen,
                                     device="cuda")}
    out = {}
    for impl in ("auto", "reference"):
        fa.reset_launch_count()
        c = dataclasses.replace(cfg, attention_impl=impl)
        loss, _ = llama.loss_fn(params, batch, c)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        out[impl] = (loss.item(), grads, {k: fa.launch_count(k) for k in fa.KERNELS})
    (loss_k, grads_k, launches), (loss_r, grads_r, ref_launches) = out["auto"], out["reference"]
    if launches != launches_per_step(cfg.n_layers) or any(ref_launches.values()):
        raise SystemExit(f"kernel launches {launches} (reference {ref_launches}) != "
                         f"{launches_per_step(cfg.n_layers)}")
    errs = []
    for g, r in zip(grads_k, grads_r):
        ref_max = r.abs().max().item()
        errs.append((g - r).abs().max().item() / max(ref_max, 1e-30))
    err_loss = abs(loss_k - loss_r) / abs(loss_r)
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
    print(f"  llama8b-geom2, f32, B1 S256: loss {loss_k:.7f} vs {loss_r:.7f} (rel "
          f"{err_loss:.2e}, tol {TRAIN_LOSS_TOL}); worst gradient max|d| / max|ref| "
          f"{max(errs):.2e} over {len(errs)} leaves (tol {TRAIN_GRAD_TOL}); launches "
          f"{launches}", flush=True)
    if not finite or err_loss > TRAIN_LOSS_TOL or max(errs) > TRAIN_GRAD_TOL:
        raise SystemExit("training gradients through the kernels disagree with the "
                         "plain path")
    del params, leaves, grads_k, grads_r, out
    torch.cuda.empty_cache()
    return dict(loss_kernels=loss_k, loss_reference=loss_r, err_loss=err_loss,
                worst_grad_rel=max(errs), grad_rel=errs, launches=launches,
                tol_loss=TRAIN_LOSS_TOL, tol_grad=TRAIN_GRAD_TOL)


SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "HMMA")  # wgmma, TMA load / store, mma.sync
WGMMA_FWD = ("flash_fwd_bf16_wgmma_kernel<64>", "flash_fwd_bf16_wgmma_kernel<128>")


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
    for name, log in _build.build_logs.items():
        entry = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"\d(flash_[a-z0-9_]+?_kernel)ILi(\d+)E", line)
                entry = f"{m.group(1)}<{m.group(2)}>" if m else line.strip()
            elif "ptxas info" in line and "registers" in line:
                print(f"  {name} {entry}: {line.split(':', 1)[1].strip()}", flush=True)
            elif "spill stores" in line:
                print(f"  {name} {entry}: {line.strip()}", flush=True)
    sass = sass_counts(_build)
    for func, counts in sorted(sass.items()):
        print(f"  sass {func}: " + ", ".join(f"{op} {n}" for op, n in counts.items()),
              flush=True)

    print("[2] kernels against their plain versions", flush=True)
    for func in WGMMA_FWD:  # the bf16 forward must run on wgmma, fed by TMA
        counts = sass.get(func, {})
        if not counts.get("HGMMA") or not counts.get("UTMALDG"):
            raise SystemExit(f"{func}: no HGMMA or no UTMALDG in its SASS: {counts}")
    checks = kernel_checks(torch, fa)
    bwd_checks = backward_checks(torch, fa)
    buckets = [16, 32, 64, 128, 256, 512, 1024]
    timings = kernel_timings(torch, fa, buckets)
    train_timings, sdpa_bwd = training_timings(torch, fa)

    print("[3] serving path: llama3-8b served on the card", flush=True)
    served = main_path(torch, fa, card)

    print("[4] served model output against the plain path", flush=True)
    numerics = output_check(torch)

    print("[5] training path: llama8b-geom2 trained on the card", flush=True)
    trained = train_path(torch, fa, card)

    print("[6] training gradients against the plain path", flush=True)
    train_check = train_numerics(torch, fa)

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
    status = {"flash_fwd": "redesigned, PR 6"}
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
            "device_ms": t["device_ms"], "shape": "B6 S2048 H32/8 D128 bf16 causal",
        })
    kernels[0]["launches_serving"] = served["launches"]
    kernels[0]["design"] = (
        "bf16: a producer warpgroup keeps a 3-stage TMA ring of 128-row K/V tiles "
        "(mbarrier full/empty); two consumer warpgroups of 64 q rows run S = QK^T and "
        "O += PV on wgmma m64n128k16 (P from registers, V MN-major), setmaxnreg 24/240, "
        "O through shared memory and a TMA store")
    total_s = time.perf_counter() - t_start
    print(f"  whole run {total_s:.1f} s", flush=True)
    report = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  build_s=build_s, sass=sass, checks=checks, backward_checks=bwd_checks,
                  timings=timings, training_timings=train_timings, sdpa_backward=sdpa_bwd,
                  served=served, numerics=numerics, trained=trained,
                  train_numerics=train_check, kernels=kernels, total_s=total_s)
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
