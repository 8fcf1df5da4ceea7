"""The port's inference server (``dctn_tpu_torch/cli/serve.py``) on the CPU:
the counterparts of ``tests/test_serve.py`` (batch routing onto an
artifact's entry points, both response formats, health and meta, bad input,
the ConvSBS and int8 artifacts, micro-batching, graceful drain), against a
live server on a free port, with the logits held to the eager port model's.

A request whose batch is an exported size gets the eager logits bit for
bit; padded and chunked ones within 1e-6 of the largest logit, as in the
JAX package's tests (the padding rows share the products' batch dimension).
"""

import concurrent.futures
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from dctn_tpu_torch.cli import export
from dctn_tpu_torch.cli.serve import make_server
from dctn_tpu_torch.interop import conv_sbs_params_from_numpy, params_from_numpy
from dctn_tpu_torch.models import (
    ConvSBSModel,
    ConvSBSModelConfig,
    EPSesPlusLinear,
    EPSesPlusLinearConfig,
    EPSesPlusLinearQ8,
    fast_layer_plans,
    init_conv_sbs_model,
)
from dctn_tpu_torch.train import save_conv_sbs_params_npz, save_params_npz

REPO = Path(__file__).resolve().parents[1]
CFG = EPSesPlusLinearConfig(epses_specs=((2, 4),), image_size=6, q0=2)
SBS = ConvSBSModelConfig(num_sbs_layers=2, bond_dim_size=2)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A numpy-seeded model's npz and its eager port models."""
    tmp = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(0)
    (plan,) = fast_layer_plans(CFG)
    np_params = {
        "epses": ((rng.standard_normal(plan["core_shape"]) * 0.5).astype(np.float32),),
        "linear": {"w": (rng.standard_normal((CFG.linear_in_features, 10)) * 0.5).astype(np.float32),
                   "b": (rng.standard_normal(10) * 0.5).astype(np.float32)},
    }
    path = str(tmp / "ckpt.npz")
    save_params_npz(np_params, path)
    params = params_from_numpy(np_params)
    return {"tmp": tmp, "path": path, "f32": EPSesPlusLinear.from_reference(params, CFG),
            "int8": EPSesPlusLinearQ8.from_reference(params, CFG)}


def _artifact(ckpt, name, batch_sizes, **kw):
    out = str(ckpt["tmp"] / f"{name}.zip")
    export.run(checkpoint=ckpt["path"], epses_specs=CFG.epses_specs, image_size=6, q0=2,
               batch_sizes=batch_sizes, device="cpu", out=out, **kw)
    return out


class _Live:
    """A server on a free port in a thread; ``stop`` drains and closes it."""

    def __init__(self, artifact, **kw):
        self.server, self.model = make_server(artifact, **kw)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self.model.close()


@pytest.fixture(scope="module")
def served(ckpt):
    live = _Live(_artifact(ckpt, "served", (2, 4)))
    yield live.base, ckpt["f32"]
    live.stop()


def _post(base, x, query=""):
    buf = io.BytesIO()
    np.save(buf, x)
    req = urllib.request.Request(f"{base}/predict{query}", data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req) as resp:
        return resp.read(), resp.headers.get("Content-Type")


def _x(bs, seed=1):
    return np.random.default_rng(seed).random((1, bs, 6, 6, 2)).astype(np.float32)


def _want(model, x):
    with torch.inference_mode():
        return model(torch.tensor(x)).numpy()


def _status(fn):
    try:
        fn()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    return 200, None


def test_healthz_and_meta(served):
    base, _ = served
    with urllib.request.urlopen(f"{base}/healthz") as r:
        health = json.loads(r.read())
    assert health == {"status": "ok", "model_family": "eps", "batch_sizes": [2, 4],
                      "platforms": ["cpu"]}
    with urllib.request.urlopen(f"{base}/meta") as r:
        meta = json.loads(r.read())
    assert meta["epses_specs"] == [[2, 4]] and meta["backend"] == "pallas"
    assert _status(lambda: urllib.request.urlopen(f"{base}/nothing"))[0] == 404


def test_predict_exact_entry(served):
    base, model = served
    x = _x(4)
    body, ctype = _post(base, x)
    assert ctype == "application/octet-stream"
    np.testing.assert_array_equal(np.load(io.BytesIO(body)), _want(model, x))


def test_predict_padded_and_chunked(served):
    base, model = served
    for bs in (1, 3, 7):  # pad to 2, pad to 4, a chunk of 4 and a tail padded to 4
        x = _x(bs, seed=bs)
        logits = np.load(io.BytesIO(_post(base, x)[0]))
        want = _want(model, x)
        np.testing.assert_allclose(logits, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_predict_json_format(served):
    base, model = served
    x = _x(4, seed=11)
    body, ctype = _post(base, x, query="?format=json")
    assert ctype == "application/json"
    np.testing.assert_array_equal(json.loads(body)["predictions"],
                                  np.argmax(_want(model, x), axis=1))


def test_predict_bad_input_is_400(served):
    base, _ = served
    for body in (b"not an npy file", None):
        if body is None:
            buf = io.BytesIO()
            np.save(buf, np.zeros((3, 3), np.float32))  # wrong rank
            body = buf.getvalue()
        req = urllib.request.Request(f"{base}/predict", data=body, method="POST")
        code, err = _status(lambda: urllib.request.urlopen(req))
        assert code == 400 and "error" in err


def test_device_error_is_500_and_not_retried(ckpt):
    """A failing device call answers 500, and nothing else is called."""
    live = _Live(_artifact(ckpt, "err", (2,)))
    calls = []

    def failing(bs, xb):
        calls.append(bs)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    live.model._call = failing
    try:
        code, err = _status(lambda: _post(live.base, _x(2)))
        assert code == 500 and "illegal memory access" in err["error"] and calls == [2]
    finally:
        live.stop()


def test_serve_conv_sbs_family(ckpt):
    """Batch routing on axis 0 (a ConvSBS artifact), with a padded tail."""
    rng = np.random.default_rng(2)
    cores = tuple(tuple(tuple((rng.standard_normal(tuple(c.shape)) * 0.7).astype(np.float32)
                              for c in s) for s in layer)
                  for layer in init_conv_sbs_model(torch.Generator(), SBS))
    path = str(ckpt["tmp"] / "sbs.npz")
    save_conv_sbs_params_npz(cores, path)
    art = str(ckpt["tmp"] / "sbs.zip")
    export.run(checkpoint=path, model_family="conv_sbs", image_size=8, bond_dim=2,
               batch_sizes=(4,), device="cpu", out=art)
    live = _Live(art)
    try:
        x = rng.random((6, 8, 8)).astype(np.float32)  # a chunk of 4 and a tail padded to 4
        logits = np.load(io.BytesIO(_post(live.base, x)[0]))
        want = _want(ConvSBSModel(conv_sbs_params_from_numpy(cores), SBS), x)
        np.testing.assert_allclose(logits, want, rtol=0, atol=1e-6 * np.abs(want).max())
    finally:
        live.stop()


def test_serve_int8_artifact(ckpt):
    live = _Live(_artifact(ckpt, "q8", (3,), quantize="int8"))
    try:
        with urllib.request.urlopen(f"{live.base}/meta") as resp:
            assert json.loads(resp.read())["quantize"] == "int8"
        x = _x(3, seed=41)
        np.testing.assert_array_equal(np.load(io.BytesIO(_post(live.base, x)[0])),
                                      _want(ckpt["int8"], x))
    finally:
        live.stop()


def test_serve_microbatching_coalesces(ckpt):
    """Concurrent batch-1 requests share device calls (fewer calls than
    requests), and every client gets its own example's logits."""
    live = _Live(_artifact(ckpt, "mb", (1, 8)), microbatch_wait_s=0.5)
    calls = []
    orig = live.model._call

    def counting(bs, xb):
        calls.append(bs)
        return orig(bs, xb)

    live.model._call = counting
    try:
        xs = [_x(1, seed=100 + i) for i in range(6)]
        with concurrent.futures.ThreadPoolExecutor(6) as pool:
            outs = list(pool.map(lambda x: np.load(io.BytesIO(_post(live.base, x)[0])), xs))
        for x, got in zip(xs, outs):
            want = _want(ckpt["f32"], x)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
        assert len(calls) < 6, calls
    finally:
        live.stop()


def test_listen_backlog_takes_a_burst_of_clients(ckpt):
    """32 clients connect at once, before the server accepts any: each is
    queued at once, none dropped or reset (socketserver's backlog is 5)."""
    server, model = make_server(_artifact(ckpt, "burst", (1,)))
    socks = []
    try:
        for _ in range(32):
            s = socket.socket()
            s.settimeout(0.5)
            s.connect(("127.0.0.1", server.server_address[1]))
            socks.append(s)
    finally:
        for s in socks:
            s.close()
        server.server_close()
        model.close()
    assert len(socks) == 32


def test_serve_microbatching_shape_isolation(ckpt):
    """A mis-shaped request under micro-batching fails alone: it cannot join
    or corrupt a group of valid requests."""
    live = _Live(_artifact(ckpt, "mb2", (1, 4)), microbatch_wait_s=0.3)
    good, bad = _x(1, seed=200), np.zeros((1, 1, 5, 5, 2), np.float32)

    def post_status(x):
        try:
            return 200, np.load(io.BytesIO(_post(live.base, x)[0]))
        except urllib.error.HTTPError as e:
            return e.code, None

    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            f_good, f_bad = pool.submit(post_status, good), pool.submit(post_status, bad)
            (code_g, out_g), (code_b, out_b) = f_good.result(), f_bad.result()
        assert code_g == 200 and code_b == 400 and out_b is None
        np.testing.assert_array_equal(out_g, _want(ckpt["f32"], good))
    finally:
        live.stop()


def test_graceful_shutdown_drains_inflight(ckpt):
    """shutdown() then server_close() (what SIGTERM does in main) lets a
    /predict in flight finish with its full response, and refuses new
    connections afterwards."""
    live = _Live(_artifact(ckpt, "g", (2,)))
    entered = threading.Event()
    orig = live.model._call

    def slow(bs, xb):
        entered.set()
        time.sleep(0.8)  # hold the request past the shutdown below
        return orig(bs, xb)

    live.model._call = slow
    x = _x(2, seed=200)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_post, live.base, x)
        assert entered.wait(10), "the request never reached the model"
        live.stop()
        body, _ = fut.result(timeout=10)
    np.testing.assert_array_equal(np.load(io.BytesIO(body)), _want(ckpt["f32"], x))
    with pytest.raises(urllib.error.URLError):
        _post(live.base, x)


def test_cli_serves_and_drains_on_sigterm(ckpt):
    """``python -m dctn_tpu_torch.cli.serve``: it answers, and on SIGTERM it
    drains and exits 0."""
    art = _artifact(ckpt, "cli", (2,))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dctn_tpu_torch.cli.serve", art, "--port", "0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"},
    )
    try:
        line = proc.stdout.readline()
        assert "serving eps artifact on http://127.0.0.1:" in line, (line, proc.stderr.read())
        base = line.split(" on ")[1].split(" ")[0]
        x = _x(2, seed=7)
        np.testing.assert_array_equal(np.load(io.BytesIO(_post(base, x)[0])),
                                      _want(ckpt["f32"], x))
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0 and "drained in-flight requests and stopped" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
