"""The port's HTTP front (``mellow_tpu_torch.server``) on loopback over the
port's wrapper at the tiny configuration on the CPU: every rule of
``tests/test_server.py`` (endpoints, answers equal to ``wrapper.generate``,
inline audio and its cleanup, the error paths, the body cap, the audio-root
allowlist, the loopback rule, SSE), plus concurrent requests coalesced
into one batch. Every wait carries a timeout of at most 60 s, and the
server shuts down in a ``finally``, so a hang fails fast."""

import base64
import json
import os
import threading
import urllib.error
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from mellow_tpu_torch.io.tokenizer import ByteTokenizer
from mellow_tpu_torch.server import MellowServer
from mellow_tpu_torch.wrapper import MellowWrapper
from tests.torch_port_common import TINY, port_params_np

WAIT = 60  # seconds: every HTTP and future wait


def _write_wav(path, seconds: float, seed: int) -> str:
    rng = np.random.RandomState(seed)
    pcm = (np.clip(rng.randn(int(16000 * seconds)) * 0.2, -1, 1) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return str(path)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("server_wavs")
    wav1, wav2 = _write_wav(d / "a.wav", 1.5, 1), _write_wav(d / "b.wav", 2.5, 2)
    wrapper = MellowWrapper(TINY.name, "v0", "cpu", params=port_params_np(TINY), tokenizer=ByteTokenizer(),
                            use_native_audio=False)
    srv = MellowServer(wrapper, max_batch_size=4, max_wait_ms=20)
    httpd = srv.make_http_server("127.0.0.1", 0)  # an ephemeral port
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", wrapper, srv, wav1, wav2
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.shutdown()
        t.join(timeout=WAIT)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return r.status, json.loads(r.read())


def _stream(url, body):
    req = urllib.request.Request(url + "/generate_stream", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as resp:
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        return [json.loads(line[len("data: "):]) for line in (r.decode().strip() for r in resp)
                if line.startswith("data: ")]


def test_healthz_and_metrics(served):
    url = served[0]
    with urllib.request.urlopen(url + "/healthz", timeout=WAIT) as r:
        assert json.loads(r.read())["status"] == "ok"
    with urllib.request.urlopen(url + "/metrics", timeout=WAIT) as r:
        assert isinstance(json.loads(r.read()), dict)


def test_concurrent_generates_equal_the_wrapper_and_coalesce(served):
    """Three POSTs at once to a server whose engine dispatches at 3 rows:
    each answer equals ``wrapper.generate``'s on its example, and
    ``/metrics`` shows one generate call of 6 clips for the three."""
    _, wrapper, _, wav1, wav2 = served
    bodies = [{"audio1": a, "audio2": b, "prompt": p, "max_len": 5}
              for a, b, p in ((wav1, wav2, "hello"), (wav2, wav1, "what changed?"), (wav1, wav1, "is it loud?"))]
    srv = MellowServer(wrapper, max_batch_size=3, max_wait_ms=WAIT * 1000)
    httpd = srv.make_http_server("127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(url + "/metrics", timeout=WAIT) as r:
            before = json.loads(r.read())
        with ThreadPoolExecutor(max_workers=3) as pool:
            answers = list(pool.map(lambda b: _post(url + "/generate", b), bodies))
        with urllib.request.urlopen(url + "/metrics", timeout=WAIT) as r:
            after = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.shutdown()
        t.join(timeout=WAIT)
    assert [s for s, _ in answers] == [200] * 3
    assert after["generate_calls"] - before.get("generate_calls", 0) == 1
    assert after["clips"] - before.get("clips", 0) == 6
    direct = wrapper.generate([[b["audio1"], b["audio2"], b["prompt"]] for b in bodies], max_len=5)
    assert [out["text"] for _, out in answers] == direct


def test_generate_inline_base64_audio_and_cleanup(served):
    url, wrapper, srv, wav1, wav2 = served
    with open(wav1, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    status, out = _post(url + "/generate", {"audio1_b64": b64, "audio2_b64": b64, "prompt": "y", "max_len": 3})
    assert status == 200
    assert out["text"] == wrapper.generate([[wav1, wav1, "y"]], max_len=3)[0]
    assert os.listdir(srv._tmpdir) == []


def test_error_paths(served):
    url, _, _, wav1, wav2 = served
    for path, body, code in (("/generate", {"audio1": wav1, "prompt": "x"}, 400),  # no audio2
                             ("/generate", {"audio1": wav1, "audio2": "/nonexistent.wav", "prompt": "x"}, 400),
                             ("/nope", {}, 404)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + path, body)
        assert e.value.code == code, path
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope", timeout=WAIT)
    assert e.value.code == 404


def test_oversized_body_rejected_413(served):
    url, _, srv, wav1, wav2 = served
    old = srv.max_body_bytes
    srv.max_body_bytes = 100
    try:
        for path in ("/generate", "/generate_stream"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url + path, {"audio1": wav1, "audio2": wav2, "prompt": "x" * 200})
            assert e.value.code == 413
    finally:
        srv.max_body_bytes = old


def test_audio_root_allowlist_and_loopback_rule(served):
    """Paths outside the root are refused without echoing them (403 over
    HTTP), traversal does not escape it, a missing file under it is a
    FileNotFoundError without its name, and a file under it is served.
    Without a root, a non-loopback bind refuses every path."""
    _, wrapper, _, wav1, _ = served
    root = os.path.dirname(wav1)
    srv = MellowServer(wrapper, audio_root=root)
    try:
        with pytest.raises(PermissionError) as e:
            srv.handle_generate({"audio1": "/etc/passwd", "audio2": wav1, "prompt": "x"})
        assert "/etc/passwd" not in str(e.value)
        with pytest.raises(PermissionError):
            srv.handle_generate({"audio1": os.path.join(root, "../../../etc/passwd"), "audio2": wav1,
                                 "prompt": "x"})
        with pytest.raises(FileNotFoundError) as e:
            srv.handle_generate({"audio1": os.path.join(root, "nope.wav"), "audio2": wav1, "prompt": "x"})
        assert "nope" not in str(e.value)
        assert srv.handle_generate({"audio1": wav1, "audio2": wav1, "prompt": "x", "max_len": 2})["text"] == \
            wrapper.generate([[wav1, wav1, "x"]], max_len=2)[0]
    finally:
        srv.shutdown()
    srv = MellowServer(object())
    srv._loopback = False  # as make_http_server sets it for a public bind
    try:
        with pytest.raises(PermissionError):
            srv.handle_generate({"audio1": wav1, "audio2": wav1, "prompt": "x"})
    finally:
        srv.shutdown()


def test_generate_stream_sse_equals_one_shot(served):
    url, _, _, wav1, wav2 = served
    body = {"audio1": wav1, "audio2": wav2, "prompt": "caption", "max_len": 10}
    events = _stream(url, body)
    assert events and events[-1]["done"] is True and all(not e["done"] for e in events[:-1])
    status, direct = _post(url + "/generate", body)
    assert status == 200 and events[-1]["text"] == direct["text"]


def test_generate_stream_is_incremental(served):
    """The first event reaches the client while the stream's producer is
    still blocked before its last window."""
    url, _, srv, wav1, wav2 = served
    gate = threading.Event()

    def fake_stream(examples, **kw):
        yield ["a"]
        yield ["ab"]
        gate.wait(timeout=WAIT)
        yield ["abc"]

    real = srv.wrapper
    srv.wrapper = type("W", (), {"generate_stream": staticmethod(fake_stream)})()
    try:
        req = urllib.request.Request(url + "/generate_stream",
                                     data=json.dumps({"audio1": wav1, "audio2": wav2, "prompt": "x"}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            line = resp.readline().decode().strip()
            while not line.startswith("data: "):
                line = resp.readline().decode().strip()
            assert json.loads(line[len("data: "):]) == {"text": "a", "done": False}
            assert not gate.is_set()
            gate.set()
            rest = [json.loads(x[len("data: "):]) for x in (r.decode().strip() for r in resp)
                    if x.startswith("data: ")]
        assert rest[-1] == {"text": "abc", "done": True}
    finally:
        gate.set()
        srv.wrapper = real


def test_generate_stream_error_before_sse(served):
    url, _, _, _, wav2 = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _stream(url, {"audio1": "/nonexistent.wav", "audio2": wav2, "prompt": "x"})
    assert e.value.code == 400
