"""Port parity: the serving surface around LLMServer (ray_tpu_torch/llm/
server.py, batch.py and the engine's metrics and health) against the JAX
package, on byte-tiny in f32 on the CPU.

The JAX engine is constructed but never started (its metrics() and
decode_host_sync_fraction need no device); the JAX batch stages run on the
same batches. The routers run over an in-process handle stand-in, and the
builders under ray_tpu.serve's local testing mode, as the JAX tests
(tests/test_llm.py, test_pd_disagg.py, test_pd_paged.py,
test_llm_stages.py) run theirs.
"""
import base64
import io
import json
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest
import torch

from ray_tpu import serve
from ray_tpu.llm import JaxLLMEngine
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import batch as jax_batch
from ray_tpu.llm import paged as jax_paged
from ray_tpu_torch.llm import (LLMConfig, LLMServer, OpenAIRouter, PDRouter, SamplingParams,
                               TorchLLMEngine, build_llm_processor, build_openai_app,
                               build_pd_openai_app)
from ray_tpu_torch.llm import batch as pt_batch
from ray_tpu_torch.llm import paged as pt_paged
from ray_tpu_torch.llm import server as pt_server
from ray_tpu_torch.llm.server import render_chat_template

from _torch_port_util import one_torch_thread  # noqa: F401

BASE = dict(model_source="byte-tiny", max_num_seqs=2, max_model_len=64)
GREEDY_BODY = {"max_tokens": 6, "temperature": 0.0}
MESSAGES = [{"role": "user", "content": "hello there"}]


def _cfg(model_id="tiny", **kw):
    return LLMConfig(model_id=model_id, dtype="float32", **dict(BASE, **kw))


class DevicePlaneError(RuntimeError):
    """Named as the JAX device plane's error, which the routers match by name."""


class _Response:
    def __init__(self, fn):
        try:
            self._value, self._error = fn(), None
        except Exception as e:  # raised at result(), as a future would
            self._value, self._error = None, e

    def result(self, timeout_s=None):
        if self._error is not None:
            raise self._error
        return self._value


class _Handle:
    """A deployment handle stand-in over a local instance: .options(
    method_name=, stream=).remote(...) calls the method at once; a stream
    returns its generator, anything else a response with .result()."""

    def __init__(self, target, method="__call__", stream=False):
        self.target, self.method, self.stream = target, method, stream

    def options(self, method_name=None, stream=False):
        return _Handle(self.target, method_name or self.method, stream)

    def remote(self, *args, **kwargs):
        fn = getattr(self.target, self.method)
        if self.stream:
            return fn(*args, **kwargs)
        return _Response(lambda: fn(*args, **kwargs))


@pytest.fixture(scope="module")
def weights():
    eng = TorchLLMEngine(_cfg(), device="cpu")
    eng.start()
    return eng.params


@pytest.fixture
def servers(weights):
    made = []

    def make(model_id="tiny", layout="slot", prefill_handle=None, **kw):
        cfg = _cfg(model_id, kv_layout=layout, **kw)
        made.append(LLMServer(cfg, engine=TorchLLMEngine(cfg, params=weights, device="cpu"),
                              prefill_handle=prefill_handle))
        return made[-1]

    try:
        yield make
    finally:
        for srv in made:
            srv.shutdown()


def _chat(**kw):
    return dict(GREEDY_BODY, messages=MESSAGES, **kw)


def _sse_text(frames, chat=True):
    """The text an SSE stream carries; it must end in data: [DONE]."""
    frames = list(frames)
    assert frames[-1] == "data: [DONE]\n\n"
    text = ""
    for f in frames[:-1]:
        choice = json.loads(f[len("data: "):])["choices"][0]
        text += choice["delta"].get("content", "") if chat else choice["text"]
    return text


# ----------------------------------------------------------- engine metrics

def _set_state(eng, blocks):
    eng._blocks = blocks
    eng._host_rt_s, eng._step_s, eng._fused_fixed = 0.00123456789, 0.0045678912, 4
    for i, name in enumerate(("num_pending", "num_active", "total_generated",
                              "num_preemptions", "num_aborted", "num_spec_drafted",
                              "num_spec_accepted", "num_prefix_skipped")):
        setattr(eng, name, i + 3)
    return eng.metrics()


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_metrics_equal_the_jax_engines(weights, layout):
    """Every key of the JAX engine's metrics() and the same values for the
    same counters, timings and pool (JAX's rounding included)."""
    kw = dict(BASE, kv_layout=layout)
    blocks = {"slot": (None, None), "paged": (pt_paged.make_block_manager(8, 16, 4, 2),
                                              jax_paged.make_block_manager(8, 16, 4, 2))}
    pt_blocks, jax_blocks = blocks[layout]
    got = _set_state(TorchLLMEngine(LLMConfig(**kw), params=weights, device="cpu"), pt_blocks)
    want = _set_state(JaxLLMEngine(JaxLLMConfig(**kw)), jax_blocks)
    assert got == want
    assert got["pd_exports_live"] == 0 and got["decode_fused_steps"] == 4


@pytest.mark.parametrize("rt,step,k", [(0.0, 0.01, 1), (0.002, 0.0, 1), (0.002, 0.01, 1),
                                       (0.002, 0.01, 8), (1e-4, 0.02, 32)])
def test_decode_host_sync_fraction_is_the_jax_formula(weights, rt, step, k):
    eng = TorchLLMEngine(_cfg(), params=weights, device="cpu")
    eng._host_rt_s, eng._step_s, eng._fused_fixed = rt, step, k
    stub = types.SimpleNamespace(_host_rt_s=rt, _step_s=step, decode_steps_target=lambda: k)
    assert eng.decode_host_sync_fraction() == JaxLLMEngine.decode_host_sync_fraction(stub)


def test_metrics_count_requests_through_their_life(servers):
    """Active while decoding, aborted once, generated tokens counted, and
    nothing pending or active after."""
    eng = servers().engine
    stream = eng.generate([1, 2, 3], SamplingParams(max_tokens=40, temperature=0.0,
                                                    stop_token_ids=[-1]), request_id="r")
    next(stream)
    m = eng.metrics()
    assert (m["num_active"], m["num_pending"]) == (1, 0)
    eng.abort("r")
    assert list(stream)[-1].finish_reason == "abort"
    eng.generate_sync([1, 4], SamplingParams(max_tokens=3, temperature=0.0,
                                             stop_token_ids=[-1]))
    m = eng.metrics()
    assert (m["num_active"], m["num_pending"], m["num_aborted"]) == (0, 0, 1)
    assert m["total_generated"] >= 4


def test_check_health_raises_on_a_stale_tick(servers):
    """A loop wedged inside admission while a request waits fails health
    once its tick is older than ENGINE_STALL_S; a live loop and an idle one
    pass; a stopped engine fails."""
    srv = servers()
    eng = srv.engine
    srv.check_health()  # started, idle
    release, admit = threading.Event(), eng._admit
    entered = threading.Event()

    def wedged():
        entered.set()
        release.wait(30)
        admit()

    srv.ENGINE_STALL_S = 0.05
    eng._ensure_decode_started()
    eng._admit = wedged
    done = []
    t = threading.Thread(target=lambda: done.append(eng.generate_sync(
        [1, 2], SamplingParams(max_tokens=2, temperature=0.0, stop_token_ids=[-1]))))
    t.start()
    assert entered.wait(10)
    deadline = time.monotonic() + 10
    while eng.num_pending == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    with pytest.raises(RuntimeError, match="stalled"):
        srv.check_health()
    release.set()
    t.join(10)
    assert done and len(done[0].token_ids) == 2
    eng._admit = admit
    srv.check_health()
    srv.shutdown()
    with pytest.raises(RuntimeError, match="engine stopped"):
        srv.check_health()


# ----------------------------------------------------------------- routers

def test_openai_router_routes_by_model_and_lists_models(servers):
    a, b = servers("a"), servers("b", max_num_seqs=1)
    router = OpenAIRouter(a=_Handle(a), b=_Handle(b))
    got = router.chat(_chat(model="a"))
    assert got["model"] == "a"
    assert got["choices"][0]["message"] == a.chat(_chat())["choices"][0]["message"]
    body = dict(GREEDY_BODY, model="b", prompt="once upon")
    assert router.completions(body)["choices"][0]["text"] == \
        b.completions(body)["choices"][0]["text"]
    stream = router.handle_http({"path": "/v1/chat/completions",
                                 "body": _chat(model="a", stream=True)})
    assert _sse_text(stream) == got["choices"][0]["message"]["content"]
    assert router.handle_http({"path": "/v1/models"}) == pt_server._models_list(["b", "a"])
    assert [m["id"] for m in router.handle_http({"path": "/v1/models"})["data"]] == ["a", "b"]
    with pytest.raises(ValueError, match="unknown model"):
        router.chat(_chat(model="c"))
    with pytest.raises(ValueError, match="unknown model"):
        router.chat(_chat())  # two models served, none named
    with pytest.raises(ValueError, match="unsupported path"):
        router.handle_http({"path": "/v1/embeddings", "body": {"model": "a"}})


def test_models_list_matches_jax():
    from ray_tpu.llm import server as jax_server

    assert pt_server._models_list(["b", "a"]) == jax_server._models_list(["b", "a"])


@pytest.fixture
def pd(servers):
    """A paged prefill server, a paged decode server holding a handle to it,
    a colocated paged server, and a PDRouter over the first two."""
    prefill = servers("pd", "paged", kv_block_size=4)
    decode = servers("pd", "paged", prefill_handle=_Handle(prefill), kv_block_size=4)
    colo = servers("pd", "paged", kv_block_size=4)
    return prefill, decode, colo, PDRouter(_Handle(prefill), _Handle(decode), "pd")


def test_pd_router_unary_and_stream_match_colocated(pd):
    prefill, decode, colo, router = pd
    want = colo.chat(_chat())
    got = router.chat(_chat())
    assert got["choices"] == want["choices"] and got["usage"] == want["usage"]
    body = dict(GREEDY_BODY, prompt="the quick brown")
    assert router.completions(body)["choices"] == colo.completions(body)["choices"]
    text = want["choices"][0]["message"]["content"]
    frames = router.handle_http({"path": "/v1/chat/completions", "body": _chat(stream=True)})
    assert _sse_text(frames) == text
    frames = router.handle_http({"path": "/v1/completions", "body": dict(body, stream=True)})
    assert _sse_text(frames, chat=False) == colo.completions(body)["choices"][0]["text"]
    assert router.handle_http({"path": "/v1/models"})["data"][0]["id"] == "pd"
    assert decode.engine.num_prefills == 0 and prefill.engine.num_prefills == 4


def test_pd_router_hands_the_stream_off_when_the_runtime_can(pd):
    """With a StreamHandoff from the hosting runtime the router yields the
    handoff alone; without one it relays the frames."""
    prefill, decode, _, _ = pd
    marker = object()
    handoff = types.SimpleNamespace(of=lambda resp: marker)
    router = PDRouter(_Handle(prefill), _Handle(decode), "pd", stream_handoff=handoff)
    assert list(router.handle_http({"path": "/v1/chat/completions",
                                    "body": _chat(stream=True)})) == [marker]
    handoff.of = lambda resp: None
    frames = list(router.handle_http({"path": "/v1/chat/completions",
                                      "body": _chat(stream=True)}))
    assert frames[-1] == "data: [DONE]\n\n"


class _DevicePlanePrefill:
    """A prefill pool whose first answer carries a device-plane handle."""

    def __init__(self, server):
        self.server, self.bodies = server, []

    def prefill(self, prompt, body):
        self.bodies.append(body)
        out = self.server.prefill(prompt, body)
        if not body.get("_kv_host_fallback"):
            out = dict(out, kv_handle=object(), kv_key="ab")
        return out


class _DevicePlaneDecode:
    """A decode pool whose pull of a device-plane handle fails."""

    def __init__(self, server):
        self.server = server

    def decode_from_prefill(self, pre, body):
        if "kv_handle" in pt_server._materialize_prefill(pre):
            raise DevicePlaneError("export gone")
        return self.server.decode_from_prefill(pre, body)


def test_pd_router_falls_back_to_the_host_path(pd):
    """A DevicePlaneError from the decode pool on a device-plane result
    prefills again over the host path; other errors, and a DevicePlaneError
    on a host-path result, propagate."""
    prefill, decode, colo, _ = pd
    pool = _DevicePlanePrefill(prefill)
    router = PDRouter(_Handle(pool), _Handle(_DevicePlaneDecode(decode)), "pd")
    got = router.chat(_chat())
    assert got["choices"] == colo.chat(_chat())["choices"]
    assert [bool(b.get("_kv_host_fallback")) for b in pool.bodies] == [False, True]

    class Broken:
        def decode_from_prefill(self, pre, body):
            raise ValueError("not a device-plane failure")

    with pytest.raises(ValueError, match="not a device-plane"):
        PDRouter(_Handle(pool), _Handle(Broken()), "pd").chat(_chat())

    class Unplugged:
        def decode_from_prefill(self, pre, body):
            raise DevicePlaneError("plane down")

    with pytest.raises(DevicePlaneError):  # a host-path result has nothing to fall back to
        PDRouter(_Handle(prefill), _Handle(Unplugged()), "pd").chat(_chat())


def test_device_plane_errors_are_matched_by_name():
    try:
        try:
            raise DevicePlaneError("pull failed")
        except DevicePlaneError as e:
            raise RuntimeError("replica call failed") from e
    except RuntimeError as wrapped:
        assert pt_server._is_device_plane_error(wrapped)
    assert pt_server._is_device_plane_error(RuntimeError("DevicePlaneError: gone"))
    assert not pt_server._is_device_plane_error(RuntimeError("other"))
    pt_server._release_orphan_export({"k": None})  # a host result pins nothing


def test_decode_stream_resumes_without_repeating_tokens(pd, monkeypatch):
    """A device-plane failure after two streamed chunks prefills again over
    the host path and resumes the same SSE stream, skipping the tokens
    already yielded; a failed prefill result takes the same path."""
    prefill, decode, colo, _ = pd
    want = colo.chat(_chat())["choices"][0]["message"]["content"]
    real = decode.engine.generate_from_prefill
    calls = []

    def flaky(pre, params, request_id=None):
        calls.append(pre)
        stream = real(pre, params, request_id=request_id)
        if len(calls) > 1:
            return stream

        def broken():
            yield next(stream)
            yield next(stream)
            decode.engine.abort(request_id)
            list(stream)
            raise DevicePlaneError("pull failed mid-stream")

        return broken()

    monkeypatch.setattr(decode.engine, "generate_from_prefill", flaky)
    prompt = render_chat_template(MESSAGES)
    pre = prefill.prefill(prompt, _chat())
    frames = decode.decode_stream(pre, _chat(stream=True), True)
    assert _sse_text(frames) == want
    assert len(calls) == 2
    failed = _Response(lambda: (_ for _ in ()).throw(DevicePlaneError("prefill lost")))
    assert _sse_text(decode.decode_stream(failed, _chat(stream=True), True)) == want


# ---------------------------------------------------------------- builders

def _servers_of(handle):
    """The LLMServer instances behind a local-testing router handle."""
    router = handle._instance
    if isinstance(router, PDRouter):
        return [router.prefill_handle._instance, router.decode_handle._instance]
    return [h._instance for h in router.handles.values()]


def test_builders_serve_under_ray_tpu_serve_local_testing_mode():
    """build_openai_app and build_pd_openai_app with serve=ray_tpu.serve and
    device="cpu": P/D chat equals colocated chat (the same seeded weights),
    unary and streamed."""
    cfg = _cfg(deployment_config={"max_ongoing_requests": 8})
    colo = serve.run(build_openai_app([cfg], serve=serve, device="cpu"),
                     _local_testing_mode=True)
    pd = serve.run(build_pd_openai_app(cfg, serve=serve, device="cpu"),
                   _local_testing_mode=True)
    try:
        want = colo.options(method_name="chat").remote(_chat()).result()
        got = pd.options(method_name="chat").remote(_chat()).result()
        assert got["choices"] == want["choices"] and got["model"] == "tiny"
        stream = pd.options(method_name="handle_http").remote(
            {"path": "/v1/chat/completions", "body": _chat(stream=True)}).result()
        assert _sse_text(stream) == want["choices"][0]["message"]["content"]
        models = colo.options(method_name="handle_http").remote({"path": "/v1/models"}).result()
        assert [m["id"] for m in models["data"]] == ["tiny"]
        assert all(s.engine.device == torch.device("cpu")
                   for s in _servers_of(colo) + _servers_of(pd))
    finally:
        for srv in _servers_of(colo) + _servers_of(pd):
            srv.shutdown()


def test_builders_wire_replicas_and_autoscaling_as_jax_does():
    cfg = _cfg("pd-as")
    app = build_pd_openai_app(cfg, serve=serve, num_prefill=1, max_prefill=3, num_decode=2,
                              max_decode=5, ttft_slo_name="llm-ttft")
    prefill_app, decode_app = app.args[0], app.args[1]
    pa = prefill_app.deployment.config.autoscaling_config
    da = decode_app.deployment.config.autoscaling_config
    assert pa.mode == "slo" and pa.slo_names == ["llm-ttft"]
    assert (pa.min_replicas, pa.max_replicas) == (1, 3)
    assert da.mode == "slo" and da.slo_names is None
    assert (da.min_replicas, da.max_replicas) == (2, 5)
    assert decode_app.kwargs["prefill_handle"] is prefill_app
    assert app.kwargs["stream_handoff"] is serve.handle.StreamHandoff
    pinned = build_pd_openai_app(cfg, serve=serve)
    assert pinned.args[0].deployment.config.autoscaling_config is None
    assert pinned.args[1].deployment.config.autoscaling_config is None
    multi = build_openai_app([_cfg("x", deployment_config={"num_replicas": 2,
                                                           "max_ongoing_requests": 5})],
                             serve=serve, device="cpu")
    server_app = multi.kwargs["x"]
    assert server_app.deployment.config.num_replicas == 2
    assert server_app.deployment.config.max_ongoing_requests == 5
    assert server_app.kwargs["device"] == "cpu"


# ------------------------------------------------------------------- batch

class _ListDataset:
    """A dataset stand-in over a list of row dicts: map, and map_batches over
    dict-of-array batches with a callable or a class built from
    fn_constructor_args (kept in `stages`, shared along the chain)."""

    def __init__(self, rows, stages=None):
        self.rows, self.stages = rows, stages if stages is not None else []

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


def test_build_llm_processor_over_a_list_dataset():
    """8 chat rows in batches of 3: the processor's texts are the engine's
    generate_sync texts on the same (seeded) weights."""
    cfg = _cfg()
    sampling = {"max_tokens": 5, "temperature": 0.0}
    topics = ["cats", "dogs", "tea", "rain", "maps", "salt", "jazz", "ice"]
    processor = build_llm_processor(
        cfg, sampling_params=sampling, batch_size=3, has_messages=True, device="cpu",
        preprocess=lambda r: dict(r, messages=[{"role": "user", "content": r["topic"]}]),
        postprocess=lambda r: {"topic": r["topic"], "text": r["generated_text"]})
    dataset = _ListDataset([{"topic": t} for t in topics])
    try:
        rows = processor(dataset).rows
    finally:
        for stage in dataset.stages:
            stage.engine.shutdown()
    ref = TorchLLMEngine(cfg, device="cpu")
    try:
        want = [ref.generate_sync(render_chat_template([{"role": "user", "content": t}]),
                                  SamplingParams(**sampling)).text for t in topics]
    finally:
        ref.shutdown()
    assert [r["topic"] for r in rows] == topics
    assert [r["text"] for r in rows] == want


def _image_batch():
    from PIL import Image

    img = (np.arange(20 * 30 * 3).reshape(20, 30, 3) % 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    uri = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
    messages = np.empty(2, dtype=object)
    messages[0] = [{"role": "user", "content": [{"type": "image_url",
                                                  "image_url": {"url": uri}}]}]
    messages[1] = [{"role": "user", "content": "no image"}]
    image = np.empty(2, dtype=object)
    image[0], image[1] = img, buf.getvalue()
    return {"image": image, "messages": messages}


def _messages_batch():
    col = np.empty(2, dtype=object)
    col[0] = MESSAGES
    col[1] = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"}]
    return {"messages": col}


STAGES = {
    "chat_template": (lambda m: m.ChatTemplateStage(), _messages_batch),
    "tokenize": (lambda m: m.TokenizeStage("byte"),
                 lambda: {"prompt": np.array(["hello", "wørld"], dtype=object)}),
    "detokenize": (lambda m: m.DetokenizeStage("byte"),
                   lambda: {"generated_tokens": np.array([[104, 105], [119, 195, 184]],
                                                         dtype=object)}),
    "image": (lambda m: m.PrepareImageStage(size=(16, 16)), _image_batch),
}


@pytest.mark.parametrize("name", list(STAGES))
def test_batch_stages_match_jax(name):
    make, batch = STAGES[name]
    got, want = make(pt_batch)(batch()), make(jax_batch)(batch())
    assert sorted(got) == sorted(want)
    for key in want:
        for g, w in zip(got[key], want[key]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_http_request_stage_posts_to_an_openai_endpoint():
    seen = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            seen.append(body)
            data = json.dumps({"choices": [{"text": body["prompt"].upper()}]}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        stage = pt_batch.HttpRequestStage(f"http://127.0.0.1:{srv.server_port}/v1/completions",
                                          model="m", sampling_params={"max_tokens": 8},
                                          concurrency=2)
        out = stage({"prompt": np.array(["abc", "def"], dtype=object)})
    finally:
        srv.shutdown()
        srv.server_close()
    assert list(out["generated_text"]) == ["ABC", "DEF"]
    assert seen[0]["model"] == "m" and seen[0]["max_tokens"] == 8
