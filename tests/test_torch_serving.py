"""The port's serving slice against the JAX package, on the CPU.

  * The SD engines: the JAX `SDAdapter` engine and the port's, on the tiny
    SD2 pair of tests/torch_parity.py (the same seeded weights carried by
    `io/sd_weights.state_dict_from_jax`), the same toy tokenizer and the
    same (prompt, seed): uint8 images within 1 level, as
    test_torch_pipeline.py holds the pipelines. Both engines draw x_T on the
    host from Philox(seed), so the same bits enter both.
  * Batch invariance of the port's engine, bitwise: a request's image does
    not depend on its batch or its padding.
  * GLIDE `row_seeds`: the cascade with row_seeds equals the cascade fed
    the explicit draws row_seeds stands for, built here from per-row
    generators (the explicit path is held against JAX by
    test_torch_glide.py::test_cascade_matches_jax); rows move with their
    seeds; the per_step mode and a second draw are refused.
  * The JAX tests/test_serving.py engine and HTTP cases re-run against the
    port, with stub adapters where those tests use them.
  * `cast_serving_params`: the JAX function's leaf set, read through the
    weight carrier's names, and outputs unchanged on an fp32-master UNet.
  * The serve CLI on the CPU, and its refusals.
"""
import base64
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_parity as tp
from minddiffusion_tpu.pipelines.stable_diffusion import StableDiffusionPipeline as JaxPipe
from minddiffusion_tpu.serving import BatchingEngine as JaxEngine
from minddiffusion_tpu.serving import SDAdapter as JaxSDAdapter
from minddiffusion_tpu.utils.params import cast_serving_params as jax_cast
from minddiffusion_tpu_torch.cli import common as cli_common
from minddiffusion_tpu_torch.cli import serve
from minddiffusion_tpu_torch.cli.glide_txt2img import tiny_kwargs
from minddiffusion_tpu_torch.io import sd_weights
from minddiffusion_tpu_torch.pipelines.glide_cascade import (
    ROW_SEED_TAGS, GlideCascadePipeline, GlideModels)
from minddiffusion_tpu_torch.pipelines.stable_diffusion import (
    SDModels, StableDiffusionPipeline)
from minddiffusion_tpu_torch.serving import (
    BatchingEngine, GlideAdapter, SDAdapter, make_server)
from minddiffusion_tpu_torch.serving.engine import BatchExecutionError
from minddiffusion_tpu_torch.utils.params import cast_serving_params, serving_cast_names

SIZE, STEPS, BATCH, SCALE = 64, 3, 2, 7.5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def toy_tokenize(prompt: str) -> np.ndarray:
    """Deterministic toy tokenizer: characters hashed into the vocab, SOT
    first, zero-padded to 77."""
    ids = [49406] + [(3 + ord(ch)) % 997 + 1 for ch in prompt][:75]
    return np.asarray(ids + [0] * (77 - len(ids)), np.int32)


@pytest.fixture(scope="module")
def sd():
    jm = tp.jax_models()
    params = tp.jax_params(jm, seed=11, size=SIZE)
    pm = tp.port_models(jm, params)
    f = pm.latent_factor
    port_fn = StableDiffusionPipeline(pm).build_txt2img(SIZE, SIZE, STEPS, "ddim", SCALE,
                                                        BATCH)
    engine = BatchingEngine(SDAdapter(port_fn, pm, toy_tokenize, (SIZE // f, SIZE // f)),
                            batch_size=BATCH, max_wait_ms=30.0).start()
    yield dict(jm=jm, params=params, pm=pm, engine=engine)
    engine.stop()


def test_sd_engine_matches_the_jax_engine(sd):
    jm, f = sd["jm"], sd["pm"].latent_factor
    jax_fn = JaxPipe(jm).build_txt2img(height=SIZE, width=SIZE, num_steps=STEPS,
                                       sampler="ddim", guidance_scale=SCALE, batch_size=BATCH)
    jax_engine = JaxEngine(JaxSDAdapter(jax_fn, sd["params"], toy_tokenize,
                                        (SIZE // f, SIZE // f)),
                           batch_size=BATCH, max_wait_ms=30.0).start()
    try:
        for prompt, neg, seed in (("a cat", "", 7), ("a red fox", "blurry", 12345)):
            ref = jax_engine.submit(prompt, neg, seed, timeout=600)
            got = sd["engine"].submit(prompt, neg, seed, timeout=600)
            assert got.shape == ref.shape == (SIZE, SIZE, 3) and got.dtype == np.uint8
            assert got.std() > 1.0
            assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1, (prompt, seed)
    finally:
        jax_engine.stop()


def test_sd_engine_batch_invariance(sd):
    engine = sd["engine"]
    solo = engine.submit("a cat", seed=7, timeout=300)
    results = {}

    def worker(name, prompt, seed):
        results[name] = engine.submit(prompt, seed=seed, timeout=300)

    threads = [threading.Thread(target=worker, args=(f"other{i}", f"dog {i}", i))
               for i in range(2)]
    threads.append(threading.Thread(target=worker, args=("cat", "a cat", 7)))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    np.testing.assert_array_equal(solo, results["cat"])
    assert not np.array_equal(results["other0"], results["other1"])
    assert engine.requests_served >= 4 and engine.batches_run >= 3


def test_sd_engine_over_http(sd):
    engine = sd["engine"]
    srv = make_server(engine, host="127.0.0.1", port=0, info={"family": "sd2"})
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        payload = _post(port, {"prompt": "a cat", "seed": 7})
        png = base64.b64decode(payload["image_png_b64"])
        assert png[:8] == b"\x89PNG\r\n\x1a\n" and payload["seed"] == 7
        assert "ignored" not in payload
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                      engine.submit("a cat", seed=7, timeout=300))
        health = _get(port, "/healthz")
        assert health["ok"] and health["requests_served"] >= 1
        assert _get(port, "/v1/info") == {"family": "sd2"}
    finally:
        srv.shutdown()
        srv.server_close()


def _post(port: int, body, timeout: float = 300):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/txt2img", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return json.loads(resp.read())


def _http_code(port: int, body) -> int:
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, body, timeout=30)
    return e.value.code


@pytest.mark.parametrize("stride,pad,hw", [(1, (1, 1, 1, 1), (8, 8)), (2, (1, 1, 1, 1), (8, 6)),
                                           (2, (0, 1, 0, 1), (10, 8))])
def test_patch_gemm_conv_matches_conv2d(stride, pad, hw):
    """The card's small-output conv route (models/layers.patch_gemm_conv3x3)
    against F.conv2d in fp32, within 1e-5 of max |ref| (another summation
    order), and batch-invariant bitwise."""
    from minddiffusion_tpu_torch.models.layers import patch_gemm_conv3x3

    g = torch.Generator().manual_seed(stride + hw[0])
    x = torch.randn(4, *hw, 24, generator=g)
    w = torch.randn(16, 24, 3, 3, generator=g) * 0.1
    b = torch.randn(16, generator=g)
    ref = torch.nn.functional.conv2d(torch.nn.functional.pad(x.permute(0, 3, 1, 2), pad), w,
                                     b, stride=stride).permute(0, 2, 3, 1)
    got = patch_gemm_conv3x3(x, w, b, stride, pad)
    assert got.shape == ref.shape
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    perm = torch.tensor([2, 0, 3, 1])
    assert torch.equal(patch_gemm_conv3x3(x[perm], w, b, stride, pad), got[perm])


# ---- GLIDE row_seeds ----------------------------------------------------

@pytest.fixture(scope="module")
def glide():
    models = GlideModels.create(dtype=torch.float32, device="cpu", base_respacing="3",
                                sr_respacing="ddim3", with_srgan=False,
                                generator=torch.Generator().manual_seed(3), **tiny_kwargs())
    return models


def _glide_fn(models, **kw):
    return GlideCascadePipeline(models).build_generate(batch_size=2, base_size=16,
                                                       sr_size=32, **kw)


def _glide_tokens(rows):
    tokens = torch.tensor([[5 + r, 9, 63, 63, 63, 63, 63, 63] for r in rows])
    return tokens, (tokens != 63).long()


def test_row_seeds_equal_the_explicit_draws_they_stand_for(glide):
    """Row b's draws come from generators seeded seed_b * 8 + tag: uncond
    tokens (1), base x_T (2), every ancestral step's noise (3), SR x_T (4)."""
    fn = _glide_fn(glide)
    tokens, mask = _glide_tokens([0, 1])
    seeds = [7, 2**31 - 1]
    steps, vocab = glide.base_schedule.num_timesteps, glide.base.xf_config.n_vocab

    def gen(seed, tag):
        return torch.Generator().manual_seed(seed * ROW_SEED_TAGS + tag)

    draws = dict(
        uncond_tokens=torch.stack([torch.randint(1, vocab - 1, (8,), generator=gen(s, 1))
                                   for s in seeds]),
        noise=torch.stack([torch.randn(16, 16, 3, generator=gen(s, 2)) for s in seeds]),
        step_noise=torch.stack([torch.randn(steps, 16, 16, 3, generator=gen(s, 3))
                                for s in seeds], dim=1),
        sr_noise=torch.stack([torch.randn(32, 32, 3, generator=gen(s, 4)) for s in seeds]))
    got = fn(glide, tokens, mask, None, row_seeds=seeds)
    ref = fn(glide, tokens, mask, None, **draws)
    assert set(got) == {"base", "super_res"}
    for stage in got:
        assert torch.equal(got[stage], ref[stage]), stage
        assert got[stage].float().std() > 1.0


def test_row_seeds_batch_invariance(glide):
    fn = _glide_fn(glide)
    t01, m01 = _glide_tokens([0, 1])
    t10, m10 = _glide_tokens([1, 0])
    a = fn(glide, t01, m01, None, row_seeds=[7, 9])
    b = fn(glide, t10, m10, None, row_seeds=[9, 7])    # the rows swapped
    pad = fn(glide, *_glide_tokens([0, 0]), None, row_seeds=[7, 7])   # repeat-padded
    for stage in a:
        assert torch.equal(a[stage][0], b[stage][1]) and torch.equal(a[stage][1], b[stage][0])
        assert torch.equal(a[stage][0], pad[stage][0]) and torch.equal(pad[stage][0],
                                                                       pad[stage][1])
        assert not torch.equal(a[stage][0], a[stage][1])


def test_row_seeds_refusals(glide):
    tokens, mask = _glide_tokens([0, 1])
    with pytest.raises(ValueError, match="per_generation"):
        _glide_fn(glide, uncond_mode="per_step")(glide, tokens, mask, None, row_seeds=[1, 2])
    fn = _glide_fn(glide)
    with pytest.raises(ValueError, match="noise"):
        fn(glide, tokens, mask, None, row_seeds=[1, 2], noise=torch.zeros(2, 16, 16, 3))
    with pytest.raises(ValueError, match="2\\*\\*31"):
        fn(glide, tokens, mask, None, row_seeds=[1, -2])


def test_glide_engine_serves_per_request_seeds(glide):
    fn = _glide_fn(glide)
    def tok_pair(prompt):
        tokens, mask = _glide_tokens([len(prompt) % 3])
        return tokens[0].numpy(), mask[0].numpy()

    adapter = GlideAdapter(fn, glide, tok_pair, stage="super_res")
    eng = BatchingEngine(adapter, batch_size=2, max_wait_ms=30.0).start()
    try:
        solo = eng.submit("a cat", seed=7, timeout=300)
        assert solo.shape == (32, 32, 3) and solo.dtype == np.uint8
        results = {}
        t1 = threading.Thread(target=lambda: results.update(
            cat=eng.submit("a cat", seed=7, timeout=300)))
        t2 = threading.Thread(target=lambda: results.update(
            dog=eng.submit("a dog!", seed=9, timeout=300)))
        t1.start(), t2.start(), t1.join(300), t2.join(300)
        np.testing.assert_array_equal(solo, results["cat"])
        assert not np.array_equal(solo, eng.submit("a cat", seed=8, timeout=300))
        with pytest.raises(ValueError):
            eng.submit("a cat", seed=2**31, timeout=30)
        srv = make_server(eng, host="127.0.0.1", port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            port = srv.server_address[1]
            reply = _post(port, {"prompt": "a cat", "seed": 7, "negative_prompt": "blurry"})
            assert reply["ignored"] == ["negative_prompt"]
            assert "ignored" not in _post(port, {"prompt": "a cat", "seed": 7})
        finally:
            srv.shutdown()
            srv.server_close()
    finally:
        eng.stop()


# ---- the JAX test_serving.py cases, against the port ---------------------

class _ConstAdapter:
    """Images filled with the seed: a stub that needs no model."""

    def prepare(self, prompt, negative_prompt, seed):
        seed = int(seed)
        if seed < 0:
            raise ValueError(f"seed must be >= 0, got {seed}")
        return {"seed": seed}

    def run(self, payloads):
        return np.stack([np.full((4, 4, 3), p["seed"] % 256, np.uint8) for p in payloads])


@pytest.fixture
def stub_server():
    eng = BatchingEngine(_ConstAdapter(), batch_size=4, max_wait_ms=5.0).start()
    srv = make_server(eng, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield eng, srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    eng.stop()


@pytest.mark.parametrize("body", [b"{}", b'"hello"', b"[1,2]", b"not json",
                                  b'{"prompt": "x", "seed": -4}',
                                  b'{"prompt": "x", "seed": "NaN"}',
                                  b'{"prompt": "x", "seed": ""}', b'{"prompt": "x", "seed": []}',
                                  b'{"prompt": "x", "seed": {}}',
                                  b'{"prompt": "x", "seed": false}'])
def test_http_bad_request_is_400(stub_server, body):
    _, port = stub_server
    assert _http_code(port, body) == 400


def test_http_null_seed_means_default_and_unknown_route_404(stub_server):
    eng, port = stub_server
    reply = _post(port, b'{"prompt": "x", "seed": null}')
    assert reply["seed"] == 0
    img = np.asarray(Image.open(io.BytesIO(base64.b64decode(reply["image_png_b64"]))))
    assert img.shape == (4, 4, 3) and not img.any()
    assert _post(port, {"prompt": "x", "seed": "5"})["seed"] == 5
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
    assert e.value.code == 404
    assert _get(port, "/healthz")["queue_depth"] == 0


def test_worker_fault_is_batch_execution_error_and_http_500():
    class BoomAdapter(_ConstAdapter):
        def run(self, payloads):
            raise ValueError("ragged batch")  # a server-side fault

    eng = BatchingEngine(BoomAdapter(), batch_size=2, max_wait_ms=5.0).start()
    srv = make_server(eng, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        with pytest.raises(BatchExecutionError):
            eng.submit("a cat", seed=1, timeout=30)
        assert _http_code(srv.server_address[1], {"prompt": "x", "seed": 1}) == 500
    finally:
        srv.shutdown()
        srv.server_close()
        eng.stop()


def test_http_timeout_is_504():
    release = threading.Event()

    class SlowAdapter(_ConstAdapter):
        def run(self, payloads):
            release.wait(30)
            return super().run(payloads)

    eng = BatchingEngine(SlowAdapter(), batch_size=1, max_wait_ms=1.0).start()
    srv = make_server(eng, host="127.0.0.1", port=0, request_timeout=0.2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        assert _http_code(srv.server_address[1], {"prompt": "x", "seed": 1}) == 504
    finally:
        release.set()
        srv.shutdown()
        srv.server_close()
        eng.stop()


def _split_adapter(calls, fail_seed=None):
    class SplitAdapter(_ConstAdapter):
        def dispatch(self, payloads):
            calls.append("dispatch")
            return [p["seed"] for p in payloads]

        def fetch(self, handle):
            calls.append("fetch")
            if handle[0] == fail_seed:
                raise RuntimeError("device fault")
            return np.full((len(handle), 2, 2, 3), handle[0], np.uint8)

    return SplitAdapter()


def _two_queued_requests(adapter, seeds):
    eng = BatchingEngine(adapter, batch_size=1, max_wait_ms=1.0)
    results, errors = {}, {}

    def worker(s):
        try:
            results[s] = eng.submit("p", seed=s, timeout=30)
        except BatchExecutionError as e:
            errors[s] = e

    threads = [threading.Thread(target=worker, args=(s,)) for s in seeds]
    for t in threads:
        t.start()
    time.sleep(0.2)   # both queued before the worker starts
    eng.start()
    for t in threads:
        t.join(timeout=30)
    eng.stop()
    assert not any(t.is_alive() for t in threads)
    return results, errors


def test_pipelined_dispatch_overlaps_fetch():
    """Split adapters run with one batch in flight: batch N+1 is dispatched
    before batch N is fetched, and every request gets its own result."""
    calls = []
    results, _ = _two_queued_requests(_split_adapter(calls), (3, 5))
    assert calls[:3] == ["dispatch", "dispatch", "fetch"], calls
    assert results[3][0, 0, 0] == 3 and results[5][0, 0, 0] == 5


def test_pipelined_fetch_error_attributed_to_its_own_batch():
    results, errors = _two_queued_requests(_split_adapter([], fail_seed=13), (13, 7))
    assert 13 in errors and 13 not in results
    assert results[7][0, 0, 0] == 7 and 7 not in errors


def test_queue_depth_excludes_abandoned():
    release = threading.Event()

    class SlowAdapter(_ConstAdapter):
        def run(self, payloads):
            release.wait(30)
            return super().run(payloads)

    eng = BatchingEngine(SlowAdapter(), batch_size=1, max_wait_ms=1.0).start()
    try:
        t = threading.Thread(target=lambda: eng.submit("a", seed=0, timeout=60))
        t.start()
        time.sleep(0.3)    # the first request holds the worker
        for s in (1, 2):
            with pytest.raises(TimeoutError):
                eng.submit("b", seed=s, timeout=0.05)
        assert eng.queue_depth == 0   # both abandoned: no live backlog
        release.set()
        t.join(timeout=60)
        assert not t.is_alive()
    finally:
        release.set()
        eng.stop()


def test_engine_under_concurrent_load():
    """40 concurrent requests over a batch-4 engine: all served, each by its
    own seed wherever it landed."""
    eng = BatchingEngine(_ConstAdapter(), batch_size=4, max_wait_ms=5.0).start()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        results = [None] * 40
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, eng.submit(f"p{i}", seed=i % 5, timeout=60))) for i in range(40)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(r is not None and r[0, 0, 0] == i % 5 for i, r in enumerate(results))
        assert eng.requests_served == 40
    finally:
        sys.setswitchinterval(old)
        eng.stop()


# ---- cast_serving_params -------------------------------------------------

def test_cast_serving_params_leaf_set_matches_jax(sd):
    params, jm, pm = sd["params"], sd["jm"], sd["pm"]
    translators = {"unet": sd_weights.unet_translator(jm.unet.config),
                   "vae": sd_weights.vae_translator, "text": sd_weights.clip_translator}
    cast = jax_cast(jax.tree.map(jnp.asarray, params))
    expected = set()
    for kind, translate in translators.items():
        for path, leaf in sd_weights._flatten(cast[kind]).items():
            if leaf.dtype == jnp.bfloat16:
                expected.add(sd_weights.PREFIXES[kind]
                             + translate(path[1:] if path[0] == "params" else path)[0])
    got = {sd_weights.PREFIXES[kind] + name for kind, module in pm.modules().items()
           for name in serving_cast_names(module)}
    assert got == expected and len(got) > 100


def test_cast_serving_params_keeps_the_outputs_of_an_fp32_master_unet():
    models = SDModels.create(family="sd2", dtype=torch.bfloat16, device="cpu",
                             generator=torch.Generator().manual_seed(4),
                             param_dtype=torch.float32, **cli_common.tiny_configs("sd2"))
    unet = models.unet
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 8, 8, 4, generator=g)
    ctx = torch.randn(2, 77, 32, generator=g)
    t = torch.tensor([10, 700])
    with torch.no_grad():
        before = unet(x, t, ctx)
        cast_serving_params(unet)
        after = unet(x, t, ctx)
    dtypes = {n: p.dtype for n, p in unet.named_parameters()}
    assert dtypes["input_blocks.0.0.weight"] == torch.bfloat16
    assert dtypes["input_blocks.0.0.bias"] == torch.float32
    assert dtypes["out.0.weight"] == torch.float32       # a GroupNorm scale
    assert torch.equal(before, after)


# ---- the serve CLI --------------------------------------------------------

def test_serve_cli_glide_on_the_cpu_answers_a_request(tmp_path):
    """`python -m minddiffusion_tpu_torch.cli.serve --family glide` in its own
    process: it warms up, listens, answers, counts, and stops on SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "minddiffusion_tpu_torch.cli.serve", "--family", "glide",
         "--debug_tiny", "--device", "cpu", "--dtype", "fp32", "--batch_size", "2",
         "--denoise_steps", "2", "--super_res_steps", "2", "--host", "127.0.0.1",
         "--port", "0"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        port = None
        deadline = time.time() + 240
        while port is None and time.time() < deadline:
            line = proc.stdout.readline()
            assert line, "the server exited before listening"
            if "listening on" in line:
                port = int(line.rsplit(":", 1)[1])
        reply = _post(port, {"prompt": "一只猫", "seed": 3})
        img = Image.open(io.BytesIO(base64.b64decode(reply["image_png_b64"])))
        assert img.size == (128, 128)    # 32 px super-res -> x4 SRGAN
        assert _get(port, "/healthz")["requests_served"] == 2   # warm-up + this one
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert proc.poll() is not None


def test_serve_cli_sd2_with_a_stub_tokenizer(monkeypatch, tmp_path):
    """The SD engine of the serve CLI, with the seeded random weights and
    with the same weights from a .safetensors --ckpt: the same image."""
    class StubTokenizer:
        def tokenize(self, texts):
            return np.stack([toy_tokenize(t) for t in texts])

    monkeypatch.setattr(cli_common, "tokenizer_for", lambda family: StubTokenizer())
    argv = ["--debug_tiny", "--device", "cpu", "--dtype", "fp32", "--height", "64", "--width",
            "64", "--steps", "2", "--batch_size", "2"]
    ckpt = str(tmp_path / "sd2.safetensors")
    weights, report = sd_weights.export_sd_checkpoint(
        cli_common.build_sd("sd2", "fp32", torch.device("cpu"), tiny=True))
    assert not report
    sd_weights.save_safetensors(weights, ckpt)
    images = []
    for extra in ([], ["--ckpt", ckpt]):
        engine, desc = serve._build_sd_engine(serve.build_argparser().parse_args(argv + extra))
        engine.start()
        try:
            images.append(engine.submit("a cat", seed=1, timeout=300))
        finally:
            engine.stop()
        assert images[-1].shape == (64, 64, 3) and desc == "ddim-2 64x64"
    np.testing.assert_array_equal(images[0], images[1])


def test_serve_cli_refusals(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--family", "glide", "--debug_tiny"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit, match="fp32"):
        serve.main(["--family", "glide", "--debug_tiny", "--dtype", "fp32"])
    with pytest.raises(SystemExit, match="orbax directory"):      # the one format refused
        serve.main(["--family", "sd2", "--device", "cpu", "--dtype", "fp32",
                    "--ckpt", str(tmp_path)])
    (tmp_path / "w.safetensors").write_bytes(b"{}")
    (tmp_path / "ms.ckpt").write_bytes(b"\x0a\x05proto")
    torch.save({"a": torch.zeros(1)}, tmp_path / "ok.ckpt")
    for name in ("w.safetensors", "ms.ckpt", "ok.ckpt"):       # build_sd reads all three
        serve.check_ckpt(str(tmp_path / name))
