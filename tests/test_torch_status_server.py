"""The port's status server (``paddle_tpu_torch/status.py``) against the
JAX package's, with each package's serving engine registered.

Both servers run in this process on ephemeral loopback ports (port 0).
The same requests go to both: /healthz, /generate, /drain and the 400,
404 and 503 replies must be equal apart from the time and pid fields
(and the measured seconds inside an engine's numbers). /status carries
the three sections whose modules are not ported (memory, dynamics,
comms) as ``{"available": false, "not_ported": <ROADMAP item>}`` beside
a live `serving` section. Then an ``HttpReplica`` round trip through the
port's server, and one boot of ``tools/torch_serve_replica.py --device
cpu`` as a process: READY, /generate, SIGTERM.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import pytest

from paddle_tpu import goodput as jgoodput
from paddle_tpu import monitor as jmonitor
from paddle_tpu import serving as jserving
from paddle_tpu import status as jstatus
from paddle_tpu.serving import ledger as jledger
from paddle_tpu import dynamics as jdynamics
from paddle_tpu import memwatch as jmemwatch
from paddle_tpu_torch import (dynamics, goodput, memwatch, monitor, serving,
                              status)
from paddle_tpu_torch.serving import ledger as serving_ledger
from paddle_tpu_torch.serving import router as rt
from test_torch_serving_model import rich_params

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CFG = dict(vocab_size=128, n_layer=2, n_head=2, d_model=32, max_seq_len=64)
_ENV = dict(max_batch=4, n_blocks=16, block_size=8, prefill_buckets=[16, 32])
_TIMEOUT = 30.0
# keys whose values are clocks, pids or measured seconds, and the
# process-wide rank and progress count each package keeps for itself
# (other tests in the process may move the JAX package's); ``_own``
# holds those two to each package's own monitor
_VOLATILE = ("time_unix", "pid", "service_ema_s", "engine_e2e_s",
             "uptime_seconds", "rank", "progress")


@pytest.fixture(scope="module")
def engines():
    jm = jserving.DecodeModel(jserving.GPTConfig(**_CFG),
                              params=rich_params(), **_ENV)
    tm = serving.DecodeModel(serving.GPTConfig(**_CFG), params=rich_params(),
                             device="cpu", **_ENV)
    return jm, tm


@pytest.fixture()
def servers(engines):
    """Both packages' servers on port 0, each package's engine registered
    and started; everything stopped and unregistered afterwards."""
    jm, tm = engines
    serving_ledger.reset()
    jledger.reset()
    goodput.reset()
    jgoodput.reset()
    jeng, teng = jserving.ServingEngine(jm), serving.ServingEngine(tm)
    jeng.start()
    teng.start()
    jserving.set_replica_engine(jeng)
    serving.set_replica_engine(teng)
    try:
        jsrv = jstatus.start_status_server(port=0, host="127.0.0.1")
        try:
            tsrv = status.start_status_server(port=0, host="127.0.0.1")
            try:
                yield {"reference": (jsrv.server_port, jeng),
                       "port": (tsrv.server_port, teng)}
            finally:
                status.stop_status_server()
        finally:
            jstatus.stop_status_server()
    finally:
        jserving.set_replica_engine(None)
        serving.set_replica_engine(None)
        jeng.stop(flush=False)
        teng.stop(flush=False)
        serving_ledger.reset()
        jledger.reset()
        goodput.reset()
        jgoodput.reset()


def _call(port, path, body=None, raw=None):
    """(status code, JSON body) of one request; POST when a body is
    given."""
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=_TIMEOUT) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _stable(doc):
    """``doc`` without its clock, pid and measured-seconds fields; an
    attribution keeps its bucket names."""
    if isinstance(doc, dict):
        return {k: (sorted(v) if k == "attribution" and isinstance(v, dict)
                    else _stable(v))
                for k, v in doc.items() if k not in _VOLATILE}
    if isinstance(doc, list):
        return [_stable(v) for v in doc]
    return doc


def _own(doc, mon):
    """The reply's rank and progress count are its package's own."""
    assert doc.get("rank", mon.trainer_rank()) == mon.trainer_rank()
    assert doc.get("progress", mon.progress_count()) == mon.progress_count()


def _both(servers, path, body=None, raw=None):
    out = [_call(servers[w][0], path, body, raw)
           for w in ("reference", "port")]
    for (_, doc), mon in zip(out, (jmonitor, monitor)):
        _own(doc, mon)
    return out


def test_healthz_equal(servers):
    ref, port = _both(servers, "/healthz")
    assert ref[0] == port[0] == 200
    assert _stable(port[1]) == _stable(ref[1])
    assert port[1]["serving"]["draining"] is False


def test_generate_equal(servers):
    body = {"request_id": "g-1", "prompt": [5, 9, 3, 44, 17],
            "max_new_tokens": 6, "deadline_s": 60.0}
    ref, port = _both(servers, "/generate", body)
    assert ref[0] == port[0] == 200
    assert _stable(port[1]) == _stable(ref[1])
    assert len(port[1]["tokens"]) == 6 and port[1]["cached"] is False
    # a repeat of the same request_id replays from the idempotency cache
    ref, port = _both(servers, "/generate", body)
    assert _stable(port[1]) == _stable(ref[1])
    assert port[1]["cached"] is True


@pytest.mark.parametrize("body,raw", [
    ({"prompt": []}, None),                    # empty prompt
    ({"prompt": "1 2 3"}, None),               # not a token list
    ({"max_new_tokens": 2}, None),             # no prompt at all
    (None, b"{not json"),                      # a body that is not JSON
])
def test_generate_400_equal(servers, body, raw):
    ref, port = _both(servers, "/generate", body, raw)
    assert ref[0] == port[0] == 400
    assert port[1] == ref[1]


@pytest.mark.parametrize("method,path", [
    ("GET", "/nope"), ("POST", "/nope"), ("POST", "/status")])
def test_unknown_path_404_equal(servers, method, path):
    body = {} if method == "POST" else None
    ref, port = _both(servers, path, body)
    assert ref[0] == port[0] == 404
    assert port[1] == ref[1]
    assert "/generate" in port[1]["endpoints"]


def test_generate_and_drain_503_without_an_engine(servers):
    jserving.set_replica_engine(None)
    serving.set_replica_engine(None)
    for path, body in (("/generate", {"prompt": [1, 2]}), ("/drain", {})):
        ref, port = _both(servers, path, body)
        assert ref[0] == port[0] == 503
        assert port[1] == ref[1]
    ref, port = _both(servers, "/healthz")
    assert "serving" not in port[1]
    assert _stable(port[1]) == _stable(ref[1])


def test_drain_equal_then_503_while_draining(servers):
    ref, port = _both(servers, "/drain", {})
    assert ref[0] == port[0] == 200
    assert _stable(port[1]) == _stable(ref[1])
    assert port[1]["draining"] is True and port[1]["drained"] is True
    ref, port = _both(servers, "/generate",
                      {"request_id": "late-1", "prompt": [1, 2, 3]})
    assert ref[0] == port[0] == 503
    assert port[1] == ref[1]
    assert port[1]["draining"] is True
    ref, port = _both(servers, "/healthz")
    assert _stable(port[1]) == _stable(ref[1])
    assert port[1]["serving"]["drained"] is True


def test_status_marks_unported_sections(servers):
    """The port's /status: goodput's document, the memory and dynamics
    sections of the ported memwatch and dynamics (their ``status()``
    documents, as the JAX package serves them), the one section whose
    module is not ported marked with its ROADMAP item (never a 500,
    which would hide the serving section), and a live serving section."""
    port, _ = servers["port"]
    _call(port, "/generate", {"prompt": [3, 4, 5], "max_new_tokens": 3})
    code, doc = _call(port, "/status")
    assert code == 200
    assert doc["memory"]["schema"] == memwatch.SCHEMA
    assert "step_tail" in doc["memory"] and "not_ported" not in doc["memory"]
    assert doc["dynamics"]["schema"] == dynamics.SCHEMA
    assert "trajectory_tail" in doc["dynamics"]
    assert "not_ported" not in doc["dynamics"]
    assert doc["comms"] == {"available": False, "not_ported": "A12"}
    assert status.NOT_PORTED == {"comms": "A12"}
    assert doc["schema"] == goodput.SCHEMA
    assert doc["serving"]["available"] is True
    jcode, jdoc = _call(servers["reference"][0], "/status")
    assert jcode == 200
    assert set(jdoc) == set(doc)


def test_metrics_carry_goodput_and_router_series(servers):
    goodput.add("device_compute", 0.25)
    goodput.end_step(0.5)
    req = urllib.request.Request(
        f"http://127.0.0.1:{servers['port'][0]}/metrics")
    with urllib.request.urlopen(req, timeout=_TIMEOUT) as r:
        text = r.read().decode()
    assert "goodput_bucket_seconds_total" in text
    assert "goodput_fraction" in text
    assert "serve_router_dispatch_total" in text


def test_http_replica_round_trip(servers):
    """Router -> HttpReplica -> the port's /generate -> its engine: the
    tokens of a LocalReplica on the same engine, and a typed failure
    for a port nothing listens on."""
    port, teng = servers["port"]
    router = rt.Router([rt.HttpReplica("h", f"http://127.0.0.1:{port}")],
                       retries=0, hedge_ms=0, default_slo_s=60.0)
    try:
        rec = router.dispatch([7, 8, 9, 10], max_new_tokens=5,
                              request_id="http-1")
        local = rt.LocalReplica("l", teng).submit(
            [7, 8, 9, 10], 5, 60.0, "local-1", timeout=_TIMEOUT)
        assert rec["ok"], rec
        assert rec["tokens"] == local["tokens"]
        assert rec["attribution"]["transport"] >= 0.0
        assert router.replica_state("h") == rt.HEALTHY
    finally:
        router.stop()
    dead = rt.HttpReplica("d", f"http://127.0.0.1:{status.free_port()}")
    with pytest.raises(Exception) as exc:
        dead.healthz(timeout=5.0)
    assert type(exc.value).__name__ == "UnavailableError"
    assert exc.value.reason == "connect"


def test_replica_process_boots_serves_and_stops():
    """``tools/torch_serve_replica.py --device cpu``: READY with its port
    and cost record, one /generate through it, SIGTERM ends it with 0."""
    cmd = [sys.executable, os.path.join(_REPO, "tools",
                                        "torch_serve_replica.py"),
           "--device", "cpu", "--vocab", "128", "--n-layer", "2",
           "--n-head", "2", "--d-model", "32", "--max-seq-len", "64",
           "--max-batch", "4", "--kv-blocks", "16", "--block-size", "8",
           "--prefill-buckets", "16,32"]
    env = {k: v for k, v in torch_threads.subprocess_env().items()
           if k not in ("PADDLE_TPU_STATUS_PORT", "PADDLE_TPU_SERVE_PARAMS")}
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("READY "):
                break
        assert lines and lines[-1].startswith("READY "), "".join(lines)
        ready = json.loads(lines[-1][len("READY "):])
        assert ready["device"] == "cpu"
        assert ready["params_source"] == "init"
        assert ready["decode_cost"]["flops"] > 0
        code, doc = _call(ready["port"], "/generate",
                          {"prompt": [1, 2, 3], "max_new_tokens": 3})
        assert code == 200 and len(doc["tokens"]) == 3
        assert doc["pid"] == ready["pid"] == proc.pid
        code, doc = _call(ready["port"], "/status")
        roof = doc["serving"]["roofline"]
        assert roof["program"] == ready["decode_cost"]["key_hash"]
        assert doc["serving"]["roofline_reconciliation"]["available"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()


def _untimed(doc):
    """``doc`` without the closed steps' clock field ``t``."""
    if isinstance(doc, dict):
        return {k: _untimed(v) for k, v in doc.items() if k != "t"}
    if isinstance(doc, list):
        return [_untimed(v) for v in doc]
    return doc


def test_status_memory_and_dynamics_sections_match_reference(servers):
    """The same memory samples and training telemetry fed to both
    packages' ledgers give the same /status ``memory`` and ``dynamics``
    sections (clock, pid and host fields aside)."""
    docs = []
    for name, mw, dyn in (("port", memwatch, dynamics),
                          ("reference", jmemwatch, jdynamics)):
        mw.reset()
        dyn.reset()
        for i, loss in enumerate((3.0, 2.5, 2.25)):
            mw.sample(stats={"bytes_in_use": 1000 + 10 * i,
                             "peak_bytes_in_use": 1500 + 10 * i,
                             "bytes_limit": 80_000, "source": "synthetic"})
            dyn.feed(loss=loss, grad_norm=1.0 / (i + 1), lr=1e-3)
            mw.end_step(step=i)
            dyn.end_step(step=i)
        code, doc = _call(servers[name][0], "/status")
        assert code == 200
        docs.append({k: _untimed(_stable(doc[k]))
                     for k in ("memory", "dynamics")})
        mw.reset()
        dyn.reset()
    assert docs[0] == docs[1]
    assert docs[0]["memory"]["lifetime_peak_bytes"] == 1520
    assert [r["loss"] for r in docs[0]["dynamics"]["trajectory_tail"]] == [
        3.0, 2.5, 2.25]
