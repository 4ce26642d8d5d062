"""The port stands alone: ray_tpu_torch imports neither JAX nor ray_tpu, runs
on CUDA unless asked for the CPU, and builds its kernels or raises."""
import ast
import os
import re
import subprocess
import sys

import pytest
import torch

from _torch_port_util import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ray_tpu_torch")

_IMPORT_ALL_BLOCKED = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "ray_tpu", "safetensors", "transformers", "gymnasium"):
    sys.modules[blocked] = None
import ray_tpu_torch
assert "torch" not in sys.modules, "importing the package must stay light"
names = [m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__, "ray_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the mesh, the sharding rules and the tensor-parallel follower's entry point
assert {"ray_tpu_torch.parallel.mesh", "ray_tpu_torch.parallel.sharding",
        "ray_tpu_torch.llm.tp_worker"} <= set(names), names
from ray_tpu_torch.ops import _build
assert not _build._loaded, "importing must build no kernel"
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("jax", "ray_tpu", "safetensors", "transformers",
                                        "gymnasium"))
assert not leaked, leaked
print(len(names))
"""


def test_every_module_imports_with_jax_and_ray_tpu_blocked():
    """In a fresh interpreter (never this worker's sys.modules), with
    safetensors and transformers blocked too: the port reads and writes
    checkpoints itself; and gymnasium, which the card's machine lacks (the
    RL slice imports it only to make a string env id or wrap an env class
    without make_vec)."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL_BLOCKED], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15  # the walk saw the whole package


def _sources():
    """chip_smoke.py and every source of the package, parallel/ and the
    tensor-parallel follower (llm/tp_worker.py) among them."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for must in ("parallel/mesh.py", "parallel/sharding.py", "llm/tp_worker.py"):
        assert os.path.join(PKG, must) in files, must
    return files


def test_no_jax_or_ray_tpu_import_in_the_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|ray_tpu)(\.|\s|$)")
    files = _sources()
    hits = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            for no, line in enumerate(f, 1):
                if pattern.match(line) or re.search(r"\bray_tpu\.", line.split("#")[0]):
                    hits.append(f"{path}:{no}: {line.strip()}")
    assert len(files) > 15 and not hits, hits


def _imported_modules(tree):
    """(module, line, inside a function) for every import in a syntax tree:
    import and from-import statements at any depth, and importlib or
    __import__ calls with a literal name."""
    found = []

    def visit(node, in_func):
        if isinstance(node, ast.Import):
            found.extend((a.name, node.lineno, in_func) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            found.append((node.module, node.lineno, in_func))
        elif isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
            if (name in ("import_module", "__import__") and node.args
                    and isinstance(node.args[0], ast.Constant)):
                found.append((str(node.args[0].value), node.lineno, in_func))
        nested = in_func or isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                              ast.Lambda))
        for child in ast.iter_child_nodes(node):
            visit(child, nested)

    visit(tree, False)
    return found


def test_no_import_of_jax_or_ray_tpu_at_any_depth():
    """The syntax tree of every source, functions included: a lazy import
    inside a builder or a method is an import all the same."""
    files = _sources()
    hits, in_functions = [], 0
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for module, line, in_func in _imported_modules(tree):
            in_functions += in_func
            if module.split(".")[0] in ("jax", "ray_tpu", "jaxlib"):
                hits.append(f"{path}:{line}: {module}")
    assert not hits, hits
    assert in_functions > 20  # the walk reached the imports inside functions


def test_the_import_walk_sees_lazy_imports():
    tree = ast.parse("def build(serve=None):\n    from ray_tpu import serve\n"
                     "    import importlib\n    importlib.import_module('jax.numpy')\n")
    assert [(m, f) for m, _, f in _imported_modules(tree)] == [
        ("ray_tpu", True), ("importlib", True), ("jax.numpy", True)]


class _RLSpace:
    def __init__(self, shape=(), n=None, low=None, high=None):
        self.shape = shape
        if n is not None:
            self.n = n
        if low is not None:
            self.low, self.high = low, high


class _NoRows:
    """A dataset that must not be read: the device check comes first."""

    def take_all(self):
        raise AssertionError("read before the device check")


class _RLEnv:
    """An env that must not be built: the device check comes first."""

    def __init__(self, config=None):
        raise AssertionError("built before the device check")


def _entry_point(name):
    from ray_tpu_torch.device import resolve_device
    from ray_tpu_torch.llm import LLMConfig, LLMEngineStage, LLMServer, TorchLLMEngine
    from ray_tpu_torch.llm import model_runner, paged
    from ray_tpu_torch.models import config, llama

    from ray_tpu_torch import parallel, rllib, train
    from ray_tpu_torch.rllib.core.rl_module import DQNModule

    tiny = config.get_config("byte-tiny")
    tx = train.make_optimizer()
    box = _RLSpace((3,), low=[-1.0, -1.0], high=[1.0, 1.0])
    return {"resolve_device": lambda: resolve_device(),
            "DQN": lambda: rllib.DQNConfig().environment(_RLEnv).build_algo(),
            "SAC": lambda: rllib.SACConfig().environment(_RLEnv).build_algo(),
            "CQL": lambda: rllib.CQLConfig().environment(
                observation_space=box, action_space=box).offline_data(
                dataset=_NoRows()).build_algo(),
            "BC": lambda: rllib.BCConfig().environment(
                observation_space=box, action_space=_RLSpace(n=2)).offline_data(
                input_="rows.json").build_algo(),
            "MultiAgentPPO": lambda: rllib.MultiAgentPPOConfig().environment(
                rllib.make_multi_agent(_RLEnv)).build_algo(),
            "DreamerV3": lambda: rllib.DreamerV3Config().environment(_RLEnv).build_algo(),
            "IMPALA": lambda: rllib.IMPALAConfig().environment(_RLEnv).build_algo(),
            "APPO": lambda: rllib.APPOConfig().environment(_RLEnv).build_algo(),
            "IMPALALearner": lambda: rllib.IMPALALearner(rllib.IMPALAConfig(), rllib.RLModuleSpec(
                observation_space=box, action_space=_RLSpace(n=2))),
            "DQNLearner": lambda: rllib.DQNLearner(rllib.DQNConfig(), rllib.RLModuleSpec(
                module_class=DQNModule, observation_space=box, action_space=_RLSpace(n=2))),
            "TorchLLMEngine": lambda: TorchLLMEngine(LLMConfig()),
            "TorchLLMEngine-int8": lambda: TorchLLMEngine(LLMConfig(quantization="int8")),
            "TorchLLMEngine-spec": lambda: TorchLLMEngine(LLMConfig(num_speculative_tokens=2)),
            "LLMServer": lambda: LLMServer(LLMConfig()),
            "LLMEngineStage": lambda: LLMEngineStage(LLMConfig()),
            "LLMServer-spec-paged": lambda: LLMServer(LLMConfig(
                kv_layout="paged", speculative={"num_tokens": 4}, quantization="int8")),
            "llama.init": lambda: llama.init(tiny),
            "init_state": lambda: model_runner.init_state(tiny, 1, 16),
            "init_paged_state": lambda: paged.init_paged_state(tiny, 1, 16, 2, 16),
            "train.init_state": lambda: train.init_state(tiny, tx),
            "make_train_step": lambda: train.make_train_step(tiny, tx),
            "build_mesh": lambda: parallel.build_mesh(parallel.MeshSpec(tp=2)),
            "TorchLLMEngine-tp2": lambda: TorchLLMEngine(LLMConfig(tensor_parallel_size=2))}[name]


@pytest.mark.parametrize("name", ["resolve_device", "TorchLLMEngine", "TorchLLMEngine-int8",
                                  "TorchLLMEngine-spec", "LLMServer", "LLMServer-spec-paged",
                                  "LLMEngineStage",
                                  "llama.init", "init_state", "init_paged_state",
                                  "train.init_state",
                                  "make_train_step", "build_mesh", "TorchLLMEngine-tp2",
                                  "DQN", "SAC", "CQL", "BC", "DQNLearner",
                                  "MultiAgentPPO", "DreamerV3", "IMPALA", "APPO",
                                  "IMPALALearner"])
def test_entry_points_default_to_cuda_and_refuse_a_silent_cpu(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_point(name)()


def test_cpu_is_there_when_asked_for():
    from ray_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")


def test_train_step_refuses_a_state_on_another_device(monkeypatch):
    """A step built for the card does not quietly train a CPU state."""
    from ray_tpu_torch import train
    from ray_tpu_torch.models import config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    tiny = config.get_config("test-tiny")
    tx = train.make_optimizer()
    state = train.init_state(tiny, tx, device="cpu")
    with pytest.raises(ValueError, match="not on the step's device"):
        train.make_train_step(tiny, tx)(state, {"tokens": torch.zeros((1, 4), dtype=torch.long)})


@pytest.mark.parametrize("kwarg,error,match", [
    ("checkpoint_dir", FileNotFoundError, "no-such-checkpoint"),
    ("mesh", NotImplementedError, "A6"),
    ("sync", NotImplementedError, "A8")])
def test_training_options_outside_the_slice_raise(tmp_path, kwarg, error, match):
    """What training does not run yet raises naming its ROADMAP item: a
    mixture-of-experts model on a mesh (ep, A6: refused from the config,
    before the mesh is read; tests/test_torch_port_train_mesh.py drives the
    dense model on gloo meshes and the sp / pp refusals) and the grad-sync
    modes (A8); a checkpoint_dir that does not exist raises
    FileNotFoundError, as the JAX package's reader does."""
    from ray_tpu_torch import train
    from ray_tpu_torch.models import config

    tiny = config.get_config("moe-tiny" if kwarg == "mesh" else "test-tiny")
    tx = train.make_optimizer()
    value = str(tmp_path / "no-such-checkpoint") if kwarg == "checkpoint_dir" else "x"
    with pytest.raises(error, match=match):
        train.init_state(tiny, tx, device="cpu", **{kwarg: value})
    if kwarg == "sync":
        with pytest.raises(error, match=match):
            train.make_train_step(tiny, tx, sync="x", device="cpu")


@pytest.mark.parametrize("lib", ["flash_fwd", "flash_bwd"])
def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path, lib):
    from ray_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "kernels"))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load(lib)
    assert lib not in _build._loaded


def _fake_nvcc(monkeypatch, tmp_path, body):
    """Stand in for nvcc with this interpreter running `body` as a script, so
    the test needs no exec permission on its temporary directory."""
    from ray_tpu_torch.ops import _build

    script = tmp_path / "fake_nvcc.py"
    script.write_text(body)
    monkeypatch.setattr(_build.shutil, "which", lambda name: sys.executable)
    monkeypatch.setattr(_build, "NVCC_FLAGS", [str(script), *_build.NVCC_FLAGS])
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "kernels"))
    return _build


def test_kernel_build_raises_on_compiler_failure(monkeypatch, tmp_path):
    """A build that fails raises with nvcc's output; nothing is loaded."""
    _build = _fake_nvcc(monkeypatch, tmp_path, "import sys\n"
                        "sys.stderr.write('error: no such target\\n')\nsys.exit(3)\n")
    with pytest.raises(_build.KernelBuildError, match="no such target"):
        _build.load("flash_fwd")
    assert "flash_fwd" not in _build._loaded
    assert not list((tmp_path / "kernels").glob("*/*.so"))


def test_kernel_build_is_keyed_by_its_sources(monkeypatch, tmp_path):
    """A library built from these sources is reused: a second build() finds it
    and runs no compiler. nvcc is asked for sm_90a."""
    log = tmp_path / "argv"
    _build = _fake_nvcc(monkeypatch, tmp_path, "import pathlib, sys\n"
                        f"with open({str(log)!r}, 'a') as f:\n"
                        "    f.write(' '.join(sys.argv[1:]) + '\\n')\n"
                        "pathlib.Path(sys.argv[sys.argv.index('-o') + 1]).touch()\n")
    first = _build.build("flash_fwd")
    assert _build.build("flash_fwd") == first and os.path.isfile(first)
    calls = log.read_text().splitlines()
    assert len(calls) == 1 and "arch=compute_90a,code=sm_90a" in calls[0]


@pytest.mark.parametrize("lib", ["flash_fwd", "flash_bwd"])
def test_kernel_build_is_keyed_by_every_shared_header(monkeypatch, tmp_path, lib):
    """Every header a kernel source includes lies in csrc/, and a change to
    any header (hopper.cuh, flash_common.cuh) gives each library a new build
    key, so no build from older headers is reused."""
    import re
    import shutil

    from ray_tpu_torch.ops import _build

    sources, _ = _build.LIBRARIES[lib]
    for src in sources:
        with open(os.path.join(_build.CSRC, src)) as f:
            for name in re.findall(r'#include "([^"]+)"', f.read()):
                assert os.path.isfile(os.path.join(_build.CSRC, name)), (src, name)
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    before = _build._digest(sources)
    for header in ("hopper.cuh", "flash_common.cuh"):
        with open(csrc / header, "a") as f:
            f.write("\n// changed\n")
        after = _build._digest(sources)
        assert after != before, header
        before = after
