"""Run chosen phases of chip_smoke.py alone on one card, from the checkout at
ROOT (this one, or an unpacked parent commit to compare with on the same host):

    python3 chip_phases.py ROOT PHASE [PHASE ...]    # PHASE: T, 6 or PP

It imports ROOT's chip_smoke.py and ray_tpu_torch, builds the kernels, takes
phase 3's weights from a seeded llama3-8b engine, then runs each phase in
turn (T: tensor parallelism, 6: int8 and speculation, PP: pipeline
parallelism) with its own gates, and prints each one's wall time.
"""
import os
import sys
import time

PHASES = ("T", "6", "PP")


def main() -> int:
    root, phases = os.path.abspath(sys.argv[1]), sys.argv[2:]
    if not phases or any(p not in PHASES for p in phases):
        print(f"usage: python3 chip_phases.py ROOT PHASE... (PHASE in {PHASES})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device; nothing run", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import ray_tpu_torch
    from ray_tpu_torch.llm import LLMConfig, LLMServer
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa

    for mod in (cs, ray_tpu_torch):
        if not mod.__file__.startswith(root):
            raise SystemExit(f"{mod.__name__} came from {mod.__file__}, not {root}")
    card = cs.nvidia_smi()
    t0 = time.perf_counter()
    cs.build_all(_build)
    print(f"[{root}] {card}; torch threads {torch.get_num_threads()}; built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    server = LLMServer(LLMConfig(model_source="llama3-8b"))
    params = server.engine.params  # phase 3's weights
    server.engine.shutdown()
    for phase in phases:
        t0 = time.perf_counter()
        print(f"[{root}] phase {phase}", flush=True)
        if phase == "T":
            cs.tp_path(torch, fa, card, params)
        elif phase == "6":
            cs.spec_path(torch, fa, card, params)
        else:
            cs.pp_path(torch, fa, card, params, cs.serve_reference(torch, params))
        print(f"[{root}] phase {phase} wall {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
