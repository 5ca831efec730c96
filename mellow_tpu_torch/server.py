"""Minimal HTTP serving front over the port's ``BatchingEngine``: the port's
copy of ``mellow_tpu/server.py``, with the same endpoints and the same
security posture, over ``mellow_tpu_torch.serving`` and the port's wrapper.

Endpoints:
  GET  /healthz            -> {"status": "ok"}
  GET  /metrics            -> the metrics registry snapshot (JSON)
  POST /generate           -> {"text": ...}
      body: {"audio1": path, "audio2": path, "prompt": str,
             "max_len"?: int, "top_p"?: float, "temperature"?: float,
             "sample"?: bool}
      Audio may also be sent inline as {"audio1_b64": base64-wav-bytes}
      (written to a temp file server-side, deleted after the request).
  POST /generate_stream    -> Server-Sent Events, one {"text", "done"} per
      decode window, the last with "done": true (same body).

Security posture: path-based audio reads files on the server, which is an
arbitrary-file-read oracle if exposed. Paths are therefore accepted only
when (a) an ``audio_root`` allowlist directory is configured (resolved
paths must lie under it) or (b) no root is set and the server is bound to
loopback. Error responses never echo the probed path. Request bodies are
capped (413 above ``max_body_bytes``) and inline temp wavs are removed after
each request, so disk use stays bounded under sustained load.

Run: ``mellow-tpu-torch-serve --port 8080`` or ``python -m
mellow_tpu_torch.server`` (weights from ``MELLOW_TPU_PARAMS`` or
``MELLOW_TPU_CKPT``, else random weights; on the card unless ``--device``).
"""

from __future__ import annotations

import base64
import itertools
import json
import os
import shutil
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from mellow_tpu_torch.serving import BatchingEngine
from mellow_tpu_torch.utils.metrics import GLOBAL as metrics

_LOOPBACK_HOSTS = ("127.0.0.1", "localhost", "::1")


class _LockedEngine(BatchingEngine):
    """The engine with each batch's ``wrapper.generate`` under the server's
    device lock (see ``MellowServer``)."""

    def __init__(self, wrapper, device_lock: threading.Lock, **kw):
        self._device_lock = device_lock  # before the dispatcher thread starts
        super().__init__(wrapper, **kw)

    def _run(self, batch) -> None:
        with self._device_lock:
            super()._run(batch)


class MellowServer:
    def __init__(
        self,
        wrapper,
        max_batch_size: int = 32,
        max_wait_ms: float = 20.0,
        audio_root: Optional[str] = None,
        max_body_bytes: int = 64 << 20,
        request_timeout: Optional[float] = None,
    ):
        self.wrapper = wrapper
        # The engine's dispatcher thread and the streaming handlers' threads
        # both drive the wrapper on one device. JAX serialized their
        # dispatches; PyTorch does not, and the two would share more than the
        # read-only weights: the kernels' lazy build on first use and their
        # launch counters (``+=`` on module globals), the log-mel tables'
        # device cache, and the device's memory (two requests at once double
        # the peak). So every batch and every stream window holds this lock
        # while it computes; a stream releases it between windows, and while
        # it writes to its client.
        self._device_lock = threading.Lock()
        self.engine = _LockedEngine(wrapper, self._device_lock, max_batch_size=max_batch_size,
                                    max_wait_ms=max_wait_ms)
        self.audio_root = None if audio_root is None else os.path.realpath(audio_root)
        self.max_body_bytes = max_body_bytes
        self.request_timeout = request_timeout
        self._tmpdir = tempfile.mkdtemp(prefix="mellow_srv_")
        # Until make_http_server gives the bind host, assume loopback
        # (library callers of handle_generate are local).
        self._loopback = True

    # ------------------------------------------------------------------

    def _resolve_audio(self, body: dict, key: str, cleanup: list) -> str:
        if key in body:
            path = os.path.realpath(str(body[key]))
            if self.audio_root is not None:
                if os.path.commonpath([path, self.audio_root]) != self.audio_root:
                    raise PermissionError(f"{key}: path outside the audio root")
            elif not self._loopback:
                raise PermissionError(
                    f"{key}: path-based audio is disabled on a non-loopback bind without --audio-root; "
                    f"send inline {key}_b64 instead"
                )
            if not os.path.isfile(path):
                # No path echo: the server is not an existence oracle.
                raise FileNotFoundError(f"{key}: file not found")
            return path
        b64 = body.get(f"{key}_b64")
        if b64 is None:
            raise KeyError(f"missing {key} or {key}_b64")
        raw = base64.b64decode(b64)
        fd, path = tempfile.mkstemp(suffix=".wav", dir=self._tmpdir)
        with os.fdopen(fd, "wb") as f:
            f.write(raw)
        cleanup.append(path)
        return path

    @staticmethod
    def _remove(paths: list) -> None:
        for p in paths:
            try:
                os.unlink(p)
            except OSError:
                pass

    def handle_generate(self, body: dict) -> dict:
        tmp_wavs: list = []
        try:
            a1 = self._resolve_audio(body, "audio1", tmp_wavs)
            a2 = self._resolve_audio(body, "audio2", tmp_wavs)
            fut = self.engine.submit(
                a1, a2, body["prompt"],
                max_len=int(body.get("max_len", 300)),
                top_p=float(body.get("top_p", 0.8)),
                temperature=float(body.get("temperature", 1.0)),
                sample=bool(body.get("sample", False)),
                timeout=self.request_timeout,
            )
            return {"text": fut.result(self.request_timeout)}
        finally:
            self._remove(tmp_wavs)

    def handle_generate_stream(self, body: dict):
        """Yield SSE event dicts: one ``{"text", "done"}`` per decode window
        (the text trimmed at the stop token), the last with ``done=True``
        (``MellowWrapper.generate_stream``)."""
        tmp_wavs: list = []
        try:
            a1 = self._resolve_audio(body, "audio1", tmp_wavs)
            a2 = self._resolve_audio(body, "audio2", tmp_wavs)
            prompt = body["prompt"]
            with metrics.timer("http_generate_stream"):
                it = self.wrapper.generate_stream(
                    [[a1, a2, prompt]],
                    max_len=int(body.get("max_len", 300)),
                    top_p=float(body.get("top_p", 0.8)),
                    temperature=float(body.get("temperature", 1.0)),
                    sample=bool(body.get("sample", False)),
                )
                prev = None
                while True:
                    with self._device_lock:
                        texts = next(it, None)
                    if texts is None:
                        break
                    if prev is not None:
                        yield {"text": prev, "done": False}
                    prev = texts[0]
                yield {"text": prev if prev is not None else "", "done": True}
        finally:
            self._remove(tmp_wavs)

    def shutdown(self) -> None:
        self.engine.shutdown()
        shutil.rmtree(self._tmpdir, ignore_errors=True)

    # ------------------------------------------------------------------

    def make_http_server(self, host: str = "127.0.0.1", port: int = 8080) -> ThreadingHTTPServer:
        app = self
        self._loopback = host in _LOOPBACK_HOSTS

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet; the metrics cover it
                pass

            def _send(self, code: int, payload: dict):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _body(self) -> Optional[dict]:
                """The JSON body, or None after a 413 for one too large."""
                n = int(self.headers.get("Content-Length", "0"))
                if n > app.max_body_bytes:
                    self._send(413, {"error": "request body too large"})
                    return None
                return json.loads(self.rfile.read(n) or b"{}")

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "ok"})
                elif self.path == "/metrics":
                    self._send(200, metrics.summary())
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path == "/generate_stream":
                    self._post_stream()
                    return
                if self.path != "/generate":
                    self._send(404, {"error": f"no route {self.path}"})
                    return
                try:
                    body = self._body()
                    if body is None:
                        return
                    with metrics.timer("http_generate"):
                        out = app.handle_generate(body)
                    self._send(200, out)
                except (KeyError, FileNotFoundError, ValueError) as e:
                    self._send(400, {"error": str(e)})
                except PermissionError as e:
                    self._send(403, {"error": str(e)})
                except TimeoutError:
                    self._send(504, {"error": "generation timed out"})
                except Exception as e:  # noqa: BLE001 - reported to the client
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

            def _post_stream(self):
                try:
                    body = self._body()
                    if body is None:
                        return
                    events = app.handle_generate_stream(body)
                    # Validate the inputs before the SSE status line: pull the
                    # first event inside the try.
                    first = next(events)
                except (KeyError, FileNotFoundError, ValueError) as e:
                    self._send(400, {"error": str(e)})
                    return
                except PermissionError as e:
                    self._send(403, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001 - reported to the client
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                try:
                    # Each window's event is written as soon as it is made.
                    for ev in itertools.chain([first], events):
                        self.wfile.write(b"data: " + json.dumps(ev).encode() + b"\n\n")
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    # The client left: close the generator now, so its finally
                    # deletes the temp wavs.
                    events.close()

        return ThreadingHTTPServer((host, port), Handler)


def serve(wrapper, host: str = "127.0.0.1", port: int = 8080, **kw) -> None:
    """Blocking entry point. ``**kw`` goes to ``MellowServer`` (audio_root,
    max_body_bytes, request_timeout, batching knobs)."""
    srv = MellowServer(wrapper, **kw)
    httpd = srv.make_http_server(host, port)
    print(f"mellow_tpu_torch server on http://{host}:{port}")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        srv.shutdown()


def _main(argv=None):
    import argparse

    from mellow_tpu_torch.cli import build_wrapper

    ap = argparse.ArgumentParser(description="Serve the PyTorch port of Mellow over HTTP.")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--config", default="v0")
    ap.add_argument("--model", default="v0")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compute-dtype", default=None, choices=[None, "float32", "bfloat16"])
    ap.add_argument("--weight-dtype", default=None, choices=[None, "int8", "int8-w8a8"])
    ap.add_argument(
        "--audio-root", default=None,
        help="directory allowlist for path-based audio; required to accept paths on a non-loopback "
             "--host (inline *_b64 always works)",
    )
    ap.add_argument("--request-timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    wrapper = build_wrapper(args.config, args.model, args.device, compute_dtype=args.compute_dtype,
                            weight_dtype=args.weight_dtype)
    if args.host not in _LOOPBACK_HOSTS and args.audio_root is None:
        print("note: non-loopback bind without --audio-root: path-based audio disabled, inline *_b64 only")
    serve(wrapper, args.host, args.port, audio_root=args.audio_root, request_timeout=args.request_timeout)


if __name__ == "__main__":
    _main()
