#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no result):
  1. the card's name and power limit, the torch and CUDA versions; build every
     kernel from ops/csrc with nvcc (sm_90a) and print the build time;
  2. every kernel against its plain PyTorch version on the card, at the shapes
     the main path gives it and a tiny one, in bf16 and f32, with the stated
     tolerance; the kernel's time (CUDA events, and device time per launch
     from torch.profiler) beside its plain version's, its bound and one
     library call's (a yardstick only: the port never calls it);
  3. the main path: LLMServer(LLMConfig(model_source="llama3-8b")) with seeded
     random weights in bf16, serving concurrent chat and completion requests
     (greedy and sampled, streamed and not, prompts in six prefill buckets),
     then solo greedy requests in three TTFT buckets, each repeated
     SOLO_REPEATS times; the kernel launch counts
     are zeroed just before and read just after, and the flash launches must
     equal n_layers x prefills; then torch.profiler over one prefill and one
     decode step of the served model (wall time, device busy share, top kernels);
  4. the served model's output checked against the plain path at full width
     (two layers of llama3-8b in f32): prefill logits through the flash kernel
     vs plain attention, and a decode step vs the full forward;
  5. a JSON line of the kernels, the card's name and power limit, and last the
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

# O tolerances are atol + rtol*|O_ref| with atol == rtol, as assert_allclose
# reads them. bf16: the kernel rounds P to bf16 for the tensor-core product and
# O at the end, the plain version only O, so the two may differ by one bf16
# ulp of O, at most 2^-7 of |O|, plus ~2^-9 of |O| from P.
BF16_TOL = 2e-2
F32_TOL = 2e-3  # the f32 bound of tests/test_flash_attention.py:21
LSE_TOL = 2e-3  # LSE is f32 in both dtypes; only the summation order differs
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SOLO_REPEATS = 3  # solo requests per TTFT bucket


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


def kernel_device_ms(torch, fn, name, iters=10):
    """Device time per launch of the kernels whose name contains `name`, from
    torch.profiler: at small shapes the event timing above measures the host's
    launch overhead instead."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if name in evt.key:
            total += evt.self_device_time_total
            count += evt.count
    if count == 0:
        raise SystemExit(f"profiler saw no {name} kernel")
    return total / 1e3 / count


def flash_bound(b, s, h, hkv, d, dtype_bytes, causal, peak_flops):
    """Least time for the function at these inputs: each input read once, each
    output written once; causal counts the S(S+1)/2 pairs the mask keeps."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * d * pairs  # QK^T and PV, 2 flops per multiply-add
    nbytes = (2 * b * s * h * d + 2 * b * s * hkv * d) * dtype_bytes + b * h * s * 4
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_checks(torch, fa):
    """B1a against flash_attention_reference on the card. Returns the rows."""
    rows = []
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = []
    for s in (16, 100, 1024):  # llama3-8b head geometry; 16/1024 are prefill buckets
        for causal in (True, False):
            cases.append(dict(b=1, s=s, h=32, hkv=8, d=128, causal=causal, seg=False))
    cases.append(dict(b=2, s=256, h=32, hkv=8, d=128, causal=True, seg=True))
    cases.append(dict(b=2, s=37, h=4, hkv=2, d=64, causal=True, seg=False))  # tiny
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for c in cases:
            b, s, h, hkv, d = c["b"], c["s"], c["h"], c["hkv"], c["d"]
            q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
            seg = None
            if c["seg"]:
                seg = (torch.arange(s, device="cuda") >= s // 3).to(torch.int32)
                seg = seg[None, :].expand(b, s).contiguous()
            o, lse = fa.flash_attention(q, k, v, causal=c["causal"], segment_ids=seg)
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
            print(f"  flash_fwd {row['dtype']:8s} B{b} S{s} H{h}/{hkv} D{d} "
                  f"causal={c['causal']} seg={c['seg']}: max|dO| {err_o:.3e} "
                  f"(tol {tol} + {tol}|O|) max|dLSE| {err_lse:.3e} (tol {LSE_TOL}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SystemExit(f"flash_fwd disagrees with its plain version: {row}")
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
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
        dev_ms = kernel_device_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True),
                                  "flash_fwd")
        plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v, causal=True))
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        o, _ = fa.flash_attention(q, k, v, causal=True)
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


def where_time_goes(torch, server):
    """torch.profiler over one prefill (bucket 512) and one 8-slot decode step
    of the served model: wall time, device busy share, top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.llm import model_runner

    eng = server.engine
    cfg = eng.model_config
    state = model_runner.init_state(cfg, eng.config.max_num_seqs, eng.config.max_model_len)
    tokens = torch.randint(3, 259, (1, 512), device="cuda")
    last = torch.randint(3, 259, (eng.config.max_num_seqs,), device="cuda")
    active = torch.ones(eng.config.max_num_seqs, dtype=torch.bool, device="cuda")
    out = {}
    for name, fn in (
            ("prefill_512", lambda: model_runner.prefill(eng.params, state, tokens, 500, 0, cfg)),
            ("decode_step_8", lambda: model_runner.decode_step(eng.params, state, last,
                                                               active, cfg))):
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
        out[name] = dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                         busy_share=busy_ms / (wall * 1e3),
                         top=[dict(name=k[0][:90], ms=k[1], count=k[2]) for k in kernels[:8]])
        print(f"  {name}: wall {wall * 1e3:.2f} ms, device busy {busy_ms:.2f} ms "
              f"({100 * busy_ms / (wall * 1e3):.1f}%), {sum(k[2] for k in kernels)} kernels",
              flush=True)
        for k in kernels[:8]:
            print(f"    {k[1]:9.3f} ms x{k[2]:4d}  {k[0][:90]}", flush=True)
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
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    for name in _build.LIBRARIES:
        _build.load(name)
    build_s = time.perf_counter() - t0
    print(f"  built {sorted(_build.LIBRARIES)} in {build_s:.2f} s", flush=True)
    for name, log in _build.build_logs.items():
        entry = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"\d(flash_fwd_[a-z0-9_]+?_kernel)ILi(\d+)E", line)
                entry = f"{m.group(1)}<{m.group(2)}>" if m else line.strip()
            elif "ptxas info" in line and ("registers" in line or "spill" in line):
                print(f"  {name} {entry}: {line.split(':', 1)[1].strip()}", flush=True)

    print("[2] kernels against their plain versions", flush=True)
    checks = kernel_checks(torch, fa)
    buckets = [16, 32, 64, 128, 256, 512, 1024]
    timings = kernel_timings(torch, fa, buckets)

    print("[3] main path: llama3-8b served on the card", flush=True)
    served = main_path(torch, fa, card)

    print("[4] served model output against the plain path", flush=True)
    numerics = output_check(torch)

    main_shape = timings[-1]  # the largest prefill bucket the main path used
    kernels = [{
        "name": "flash_fwd", "route": "cuda", "status": "ported",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:123",
        "launches": served["launches"], "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
    }]
    report = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  build_s=build_s, checks=checks, timings=timings, served=served,
                  numerics=numerics, kernels=kernels)
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
