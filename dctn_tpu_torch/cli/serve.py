"""Minimal inference server over a deployment artifact (port of
``dctn_tpu/cli/serve.py``).

Standard library HTTP, no web framework: load a ``cli/export.py`` artifact
once and serve logits or predictions from its entry points. With export,
this is the last mile of the port: train → export → serve.

Endpoints:
  GET  /healthz           {"status": "ok", "batch_sizes": [...], ...}
  GET  /meta              the artifact's meta.json
  POST /predict           body: a .npy array, (channels, bs, H, W, q0) for
                          the eps family, (bs, H, W) for conv_sbs. Any bs:
                          requests are chunked and padded onto the exported
                          entry points. Response: logits as .npy, or
                          {"predictions": [...]} with ?format=json.

A sharded artifact (``export --mesh-devices N``) serves on its N cards:
every device call, a micro-batch included, is split over them.

A malformed body, or an array of the wrong shape, gets 400; a failure of
the device call (a kernel that fails to build or launch, memory) gets 500
and is never retried on the CPU.

Usage:
  python -m dctn_tpu_torch.cli.serve model.zip --port 8000
  curl -s --data-binary @batch.npy localhost:8000/predict?format=json
"""

from __future__ import annotations

import collections
import io
import json
import queue
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import click
import numpy as np
import torch

from .export import load_artifact


class ArtifactModel:
    """Batch-size routing over an artifact's static entry points: a request
    of any batch size is chunked to the largest exported size and the tail
    padded to the smallest one that fits (padding rows repeat the last
    example and are trimmed before returning).

    A device call moves the numpy chunk to the artifact's device, calls the
    entry point under ``torch.inference_mode`` and brings the logits back;
    calls are serialized by the model's lock.

    ``microbatch_wait_s > 0`` turns on cross-request micro-batching: the
    first request in an idle window waits up to that long for concurrent
    requests, and same-shaped ones are coalesced into one device call up to
    the largest entry point (exact: the batch dimension is never a
    reduction, so each example's logits do not depend on its neighbours).
    The trade is up to ``microbatch_wait_s`` of added latency on an idle
    server."""

    def __init__(self, path: str, microbatch_wait_s: float = 0.0):
        self.meta, self.fns = load_artifact(path)
        # a sharded artifact's entry points split the batch (or the image's
        # rows) over their cards from the host: its input stays on the CPU
        sharded = max(self.meta.get("mesh_devices", 1), self.meta.get("space_devices", 1)) > 1
        self.device = torch.device("cpu" if sharded else self.meta["platforms"][0])
        self.sizes = sorted(self.fns)
        self.family = self.meta.get("model_family", "eps")
        self.batch_axis = 1 if self.family == "eps" else 0
        self.in_dtype = self.meta.get("in_dtype", "float32")
        self.example_shape = self._example_shape()
        self._lock = threading.Lock()  # device calls are serialized
        self._batcher = _MicroBatcher(self, microbatch_wait_s) if microbatch_wait_s > 0 else None

    def _example_shape(self):
        """The input's shape without the batch axis, as the meta gives it."""
        size = self.meta["image_size"]
        if self.family == "eps":
            return (self.meta.get("channels", 1), size, size, self.meta["q0"])
        return (size, size)

    def _check(self, x: np.ndarray) -> None:
        ax = self.batch_axis
        got = tuple(d for i, d in enumerate(x.shape) if i != ax) if x.ndim > ax else None
        if got != self.example_shape:
            raise ValueError(
                f"input of shape {x.shape}: the artifact takes {self.example_shape} with the "
                f"batch on axis {ax}"
            )
        if x.shape[ax] == 0:
            raise ValueError("empty batch")

    def _call(self, bs: int, xb: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.as_tensor(xb.astype(self.in_dtype), device=self.device)
            return self.fns[bs](x).cpu().numpy()

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Direct chunk-and-pad prediction (one request, no coalescing)."""
        self._check(x)
        ax = self.batch_axis
        n = x.shape[ax]
        outs = []
        with self._lock:
            start = 0
            while start < n:
                take = min(n - start, self.sizes[-1])
                bs = next(s for s in self.sizes if s >= take)
                xb = np.take(x, range(start, start + take), axis=ax)
                if take < bs:
                    last = np.take(xb, [take - 1] * (bs - take), axis=ax)
                    xb = np.concatenate([xb, last], axis=ax)
                outs.append(self._call(bs, xb)[:take])
                start += take
        return np.concatenate(outs)

    def submit(self, x: np.ndarray) -> np.ndarray:
        """Request entry point: through the micro-batcher when it is on."""
        if self._batcher is None:
            return self.predict(x)
        self._check(x)
        return self._batcher.submit(x)

    def close(self):
        if self._batcher is not None:
            self._batcher.close()


class _MicroBatcher:
    """Coalesce concurrent same-shaped requests into shared device calls.

    One dispatcher thread drains a queue: the first request opens a window
    of ``wait_s``; further requests whose non-batch dimensions match join
    until the window closes or the largest entry point fills. An arrival of
    another shape closes the group and opens the next, so clients of
    different shapes never share a call. An exception of the shared call
    goes to every member of the group."""

    def __init__(self, model: ArtifactModel, wait_s: float):
        self.model = model
        self.wait_s = wait_s
        self.max_batch = model.sizes[-1]
        self.q: queue.Queue = queue.Queue()
        self._held = collections.deque()  # the arrival that opens the next group
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, x: np.ndarray) -> np.ndarray:
        item = {"x": x, "n": x.shape[self.model.batch_axis], "evt": threading.Event()}
        self.q.put(item)
        item["evt"].wait()
        if "err" in item:
            raise item["err"]
        return item["out"]

    def close(self):
        self.q.put(None)

    def _shape_key(self, x: np.ndarray):
        ax = self.model.batch_axis
        return tuple(d for i, d in enumerate(x.shape) if i != ax) + (x.ndim,)

    def _loop(self):
        while True:
            first = self._held.popleft() if self._held else self.q.get()
            if first is None:
                return
            group, total = [first], first["n"]
            key = self._shape_key(first["x"])
            deadline = time.monotonic() + self.wait_s
            while total < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = self.q.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is None:
                    self.q.put(None)  # shut down after this group
                    break
                if self._shape_key(item["x"]) != key or total + item["n"] > self.max_batch:
                    self._held.append(item)
                    break
                group.append(item)
                total += item["n"]
            try:
                xs = (group[0]["x"] if len(group) == 1 else
                      np.concatenate([it["x"] for it in group], axis=self.model.batch_axis))
                out = self.model.predict(xs)
            except Exception as e:
                for it in group:
                    it["err"] = e
                    it["evt"].set()
                continue
            start = 0
            for it in group:
                it["out"] = out[start : start + it["n"]]
                start += it["n"]
                it["evt"].set()


def _handler_for(model: ArtifactModel):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet; the CLI logs its start only
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "model_family": model.family,
                    "batch_sizes": model.sizes,
                    "platforms": model.meta.get("platforms"),
                })
            elif path == "/meta":
                self._json(200, model.meta)
            else:
                self._json(404, {"error": f"no route {path!r}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/predict":
                return self._json(404, {"error": f"no route {url.path!r}"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                x = np.load(io.BytesIO(self.rfile.read(length)), allow_pickle=False)
            except Exception as e:  # not a .npy body: the client's error
                return self._json(400, {"error": str(e)})
            try:
                logits = model.submit(x)
            except (ValueError, TypeError, KeyError) as e:
                # shape, dtype or rank mismatches: the client's error
                return self._json(400, {"error": str(e)})
            except Exception as e:
                # a kernel that fails to build or launch, device memory: the
                # server's error, so that callers retry elsewhere
                return self._json(500, {"error": str(e)})
            if parse_qs(url.query).get("format", ["npy"])[0] == "json":
                self._json(200, {"predictions": np.argmax(logits, axis=1).tolist()})
            else:
                buf = io.BytesIO()
                np.save(buf, logits)
                self._send(200, buf.getvalue(), "application/octet-stream")

    return Handler


class _DrainingHTTPServer(ThreadingHTTPServer):
    """Graceful shutdown: ``shutdown()`` stops accepting, then
    ``server_close()`` blocks until the request threads in flight finish,
    so no client holding an open /predict has its connection cut (the stock
    ThreadingHTTPServer's daemon threads would be dropped mid-response).
    Its listen backlog takes a burst of concurrent clients, the traffic
    micro-batching coalesces: socketserver's default of 5 drops the
    connections beyond it, or resets them."""

    daemon_threads = False
    block_on_close = True
    request_queue_size = 128


def make_server(artifact: str, host: str = "127.0.0.1", port: int = 0,
                microbatch_wait_s: float = 0.0):
    """(server, model): serve with ``server.serve_forever()``; port 0 picks
    a free one (``server.server_address[1]``). ``server.shutdown()`` then
    ``server.server_close()`` drains the requests in flight."""
    model = ArtifactModel(artifact, microbatch_wait_s=microbatch_wait_s)
    server = _DrainingHTTPServer((host, port), _handler_for(model))
    return server, model


@click.command()
@click.argument("artifact", type=click.Path(exists=True, dir_okay=False))
@click.option("--host", default="127.0.0.1")
@click.option("--port", type=int, default=8000)
@click.option("--microbatch-wait-ms", type=float, default=0.0,
              help="coalesce concurrent same-shaped requests into shared device calls, "
                   "waiting up to this long for companions (0 = off). Exact per example; adds "
                   "up to this much latency on an idle server")
def main(artifact, host, port, microbatch_wait_ms):
    server, model = make_server(artifact, host, port, microbatch_wait_s=microbatch_wait_ms / 1e3)
    print(
        f"serving {model.family} artifact on http://{host}:{server.server_address[1]} "
        f"({model.meta['platforms'][0]} x {model.meta.get('mesh_devices', 1)}; entry points: "
        f"bs {model.sizes}"
        + (f", micro-batching {microbatch_wait_ms:g} ms)" if microbatch_wait_ms > 0 else ")"),
        flush=True,
    )

    def _terminate(signum, frame):
        # stop accepting from another thread: shutdown() waits for the serve
        # loop to exit, which on the signal's own frame would deadlock
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _terminate)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    server.shutdown()
    server.server_close()  # drains the requests in flight
    model.close()
    print("serve: drained in-flight requests and stopped", flush=True)


if __name__ == "__main__":
    main()
