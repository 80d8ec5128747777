"""The port's TCP transport against fedicra_tpu's (CPU).

Every case of ``tests/test_transport.py`` and ``tests/test_transport_failures.py``
on the port's server and proxies, with fake clients that return tensors;
then the wire format shared with JAX, and two faults of JAX's transport
that the port does not inherit: a client that dies once it waits longer
than its connect timeout for a request, and a server with remote clients
that crashes at its first periodic checkpoint. Every socket wait here has
a finite timeout.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from fedicra_torch.engine.config import TrainConfig as PortConfig
from fedicra_torch.federation import transport as port_transport
from fedicra_torch.federation.api import EvaluateIns, EvaluateRes, FitIns, FitRes
from fedicra_torch.federation.server import FederatedServer
from fedicra_torch.federation.strategies import get_strategy
from fedicra_torch.utils.checkpoint import CheckpointManager
from fedicra_tpu.engine.config import TrainConfig as JaxConfig
from fedicra_tpu.federation import api as jax_api
from fedicra_tpu.federation import transport as jax_transport
from fedicra_tpu.federation.server import FederatedServer as JaxServer
from fedicra_tpu.federation.strategies import get_strategy as jax_get_strategy
from torch_port_helpers import free_port

WAIT = 30.0  # seconds: the longest any socket wait of these tests may take


class _FakeClient:
    device = torch.device("cpu")

    def __init__(self, cid):
        self.cid = cid
        self.num_batches = 3

    def fit(self, ins):
        w = ins.payload["params"]["w"]
        assert isinstance(w, torch.Tensor)
        return FitRes(payload={"params": {"w": w + 1}}, num_examples=self.num_batches,
                      metrics={"loss": torch.tensor(0.5)}, fit_duration=0.01)

    def evaluate(self, ins):
        return EvaluateRes(loss=0.0, num_examples=2,
                           metrics={f"client_{self.cid}_val_mean_dice": 0.9})


class _JaxFakeClient:
    """JAX's test client: numpy in, numpy out."""

    def __init__(self, cid):
        self.cid = cid
        self.num_batches = 3

    def fit(self, ins):
        payload = {"params": {"w": np.asarray(ins.payload["params"]["w"]) + 1}}
        return jax_api.FitRes(payload=payload, num_examples=self.num_batches,
                              metrics={"loss": 0.5}, fit_duration=0.01)

    def evaluate(self, ins):
        return jax_api.EvaluateRes(loss=0.0, num_examples=2,
                                   metrics={f"client_{self.cid}_val_mean_dice": 0.9})


class _Cfg:
    iters = 5
    eval_iters = 1000  # never evaluates in these tests
    batch_size = 2
    max_iterations = 10
    num_classes = 3
    max_consecutive_failures = 10
    ckpt_iters = 3000


class _FlakyClient:
    """Serves fits normally until ``die_at_fit``, then ends its serving
    thread mid-round (simulating a crashed client process)."""

    device = torch.device("cpu")

    def __init__(self, cid, die_at_fit=None):
        self.cid = cid
        self.num_batches = 2
        self.fit_calls = 0
        self.die_at_fit = die_at_fit

    def fit(self, ins):
        self.fit_calls += 1
        if self.die_at_fit is not None and self.fit_calls >= self.die_at_fit:
            raise SystemExit  # ends the serve_client thread, which closes the socket
        payload = {"params": {"w": ins.payload["params"]["w"] + 1.0}, "batch_stats": {}}
        return FitRes(payload=payload, num_examples=self.num_batches,
                      metrics={f"client_{self.cid}_total_loss": 0.5}, fit_duration=0.01)

    def evaluate(self, ins):
        return EvaluateRes(loss=0.0, num_examples=1, metrics={})


def _spawn(clients, port, serve=port_transport.serve_client, errors=None):
    """Serve each client on a daemon thread; ``errors`` collects the type
    of what ended a thread."""

    def run(c):
        try:
            serve(c, "127.0.0.1", port)
        except (SystemExit, OSError) as exc:
            if errors is not None:
                errors.append(type(exc))

    threads = [threading.Thread(target=run, args=(c,), daemon=True) for c in clients]
    for t in threads:
        t.start()
    return threads


def _accept(port, n):
    proxies = port_transport.accept_clients("127.0.0.1", port, n, timeout=WAIT, device="cpu")
    for p in proxies:
        p.round_timeout = WAIT
    return proxies


def _payload(n=4):
    return {"params": {"w": torch.zeros(n)}, "batch_stats": {}}


# ----- tests/test_transport.py -----

@pytest.mark.parametrize("client_package", ["port", "jax"])
def test_transport_round_trip(client_package):
    """The port's server side with the port's clients, and with JAX's
    clients (the wire format is shared)."""
    port = free_port()
    if client_package == "port":
        clients, serve = [_FakeClient(0), _FakeClient(1)], port_transport.serve_client
    else:
        clients, serve = [_JaxFakeClient(0), _JaxFakeClient(1)], jax_transport.serve_client
    threads = _spawn(clients, port, serve)
    proxies = _accept(port, 2)
    assert [p.cid for p in proxies] == [0, 1]
    assert [p.num_batches for p in proxies] == [3, 3]

    payload = {"params": {"w": torch.zeros(4)}}
    for p in proxies:
        res = p.fit(FitIns(payload, {"iter_global": 10}))
        w = res.payload["params"]["w"]
        assert isinstance(w, torch.Tensor) and w.device.type == "cpu"
        torch.testing.assert_close(w, torch.ones(4, dtype=w.dtype))
        assert res.num_examples == 3
        assert float(res.metrics["loss"]) == 0.5 and not isinstance(res.metrics["loss"], torch.Tensor)
        ev = p.evaluate(EvaluateIns(payload, {}))
        assert f"client_{p.cid}_val_mean_dice" in ev.metrics
    for p in proxies:
        p.close()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()


# ----- tests/test_transport_failures.py -----

def test_dropped_client_aborts_round_and_server_continues():
    port = free_port()
    _spawn([_FlakyClient(0), _FlakyClient(1, die_at_fit=2)], port)
    proxies = _accept(port, 2)
    server = FederatedServer(_Cfg(), proxies, get_strategy("FedAvg"), _payload())
    history = server.run(num_rounds=10, progress=False)

    # round 1 (iters=5 -> round index 5) aggregated: w == 1
    torch.testing.assert_close(server.global_payload["params"]["w"], torch.ones(4))
    # round 2 (index 10): client 1 died mid-round -> aborted, w unchanged
    aborted = [h for h in history if h.get("aborted")]
    assert len(aborted) == 1 and aborted[0]["round"] == 10, history
    ok = [h for h in history if not h.get("aborted")]
    assert len(ok) == 1 and ok[0]["round"] == 5


def test_accept_clients_connect_timeout():
    port = free_port()
    t0 = time.perf_counter()
    with pytest.raises(OSError):  # socket.timeout is a subclass
        port_transport.accept_clients("127.0.0.1", port, expected=1, timeout=0.5, device="cpu")
    assert time.perf_counter() - t0 < 10


def test_round_timeout_on_hung_client():
    """A client that stops responding trips the per-round timeout."""

    class _HangingClient(_FlakyClient):
        def fit(self, ins):
            time.sleep(30)
            return super().fit(ins)

    port = free_port()
    _spawn([_HangingClient(0)], port)
    (proxy,) = _accept(port, 1)
    proxy.round_timeout = 0.5
    with pytest.raises(OSError):
        proxy.fit(FitIns(_payload(2), {}))


def test_timed_out_proxy_never_consumes_stale_reply():
    """After a round_timeout fires mid-fit, the late reply must not be
    delivered to the next round: the proxy is dead, and later calls fail
    fast instead of desynchronising."""

    class _SlowThenFastClient(_FlakyClient):
        def fit(self, ins):
            self.fit_calls += 1
            if self.fit_calls == 1:
                time.sleep(1.5)  # exceeds the round timeout; reply arrives late
            payload = {"params": {"w": ins.payload["params"]["w"] + 1.0}, "batch_stats": {}}
            return FitRes(payload=payload, num_examples=2, metrics={}, fit_duration=0.01)

    port = free_port()
    _spawn([_SlowThenFastClient(0)], port)
    (proxy,) = _accept(port, 1)
    proxy.round_timeout = 0.3
    ins = FitIns(_payload(2), {})
    with pytest.raises(OSError):
        proxy.fit(ins)
    assert proxy.dead
    time.sleep(1.5)  # the late fit_res for seq 1 is now sitting in flight
    with pytest.raises(ConnectionError, match="dead"):
        proxy.fit(ins)  # must NOT return the stale seq-1 result


def _socketpair():
    a, b = socket.socketpair()
    a.settimeout(10)
    b.settimeout(10)
    return a, b


def test_malformed_length_header_rejected():
    a, b = _socketpair()
    try:
        a.sendall((2**60).to_bytes(8, "big") + b"garbage")
        with pytest.raises(ConnectionError, match="malformed"):
            port_transport.recv_msg(b)
    finally:
        a.close()
        b.close()


def test_truncated_payload_rejected():
    a, b = _socketpair()
    try:
        port_transport.send_msg(a, ("fit", {"x": np.ones(4)}, {}))
        port_transport.recv_msg(b)
        a.sendall((1024).to_bytes(8, "big") + b"short")
        a.close()
        with pytest.raises(ConnectionError, match="closed"):
            port_transport.recv_msg(b)
    finally:
        b.close()


# ----- the wire format shared with JAX -----

class _Capture:
    def __init__(self):
        self.data = b""

    def sendall(self, data):
        self.data += data


def _message():
    rng = np.random.default_rng(0)
    payload = {"params": {"enc.w": rng.normal(size=(3, 2, 3, 3)).astype(np.float32),
                          "out.b": rng.normal(size=(3,)).astype(np.float32)},
               "batch_stats": {"bn.mean": rng.normal(size=(2,)).astype(np.float32),
                               "bn.count": np.asarray(7, np.int64)}}
    return ("fit", 3, payload, {"iter_global": 10, "iters": 5})


def test_send_msg_writes_jax_bytes():
    ours, theirs = _Capture(), _Capture()
    port_transport.send_msg(ours, _message())
    jax_transport.send_msg(theirs, _message())
    assert ours.data == theirs.data and len(ours.data) > 8


def test_tensors_become_numpy_only_at_the_socket():
    """The proxy's frame of a tensor payload is JAX's frame of the same
    numbers, and each side reads the other's frames."""
    kind, seq, payload, config = _message()
    tensors = {part: {k: torch.as_tensor(v) for k, v in tree.items()}
               for part, tree in payload.items()}
    ours, theirs = _Capture(), _Capture()
    port_transport.send_msg(ours, (kind, seq, port_transport._to_numpy(tensors), config))
    jax_transport.send_msg(theirs, _message())
    assert ours.data == theirs.data

    for send, recv in ((port_transport.send_msg, jax_transport.recv_msg),
                       (jax_transport.send_msg, port_transport.recv_msg)):
        a, b = _socketpair()
        try:
            send(a, _message())
            got = recv(b)
        finally:
            a.close()
            b.close()
        assert got[:2] == (kind, seq) and got[3] == config
        for part, tree in payload.items():
            for k, v in tree.items():
                assert got[2][part][k].dtype == v.dtype
                np.testing.assert_array_equal(got[2][part][k], v)

    back = port_transport._to_tensors(payload, torch.device("cpu"))
    for part, tree in payload.items():
        for k, v in tree.items():
            assert isinstance(back[part][k], torch.Tensor)
            np.testing.assert_array_equal(back[part][k].numpy(), v)


# ----- fault (a): the client's connect timeout -----

def test_port_client_waits_past_its_connect_timeout(monkeypatch):
    monkeypatch.setattr(port_transport, "CONNECT_TIMEOUT_S", 0.5)
    port = free_port()
    errors = []
    (thread,) = _spawn([_FakeClient(0)], port, errors=errors)
    (proxy,) = _accept(port, 1)
    time.sleep(1.0)  # the other clients' fits, twice the connect timeout
    res = proxy.fit(FitIns(_payload(), {}))
    torch.testing.assert_close(res.payload["params"]["w"], torch.ones(4))
    proxy.close()
    thread.join(timeout=10)
    assert not thread.is_alive() and errors == []


def test_jax_client_dies_after_its_connect_timeout(monkeypatch):
    """JAX's serve_client keeps the connect timeout on its socket, so a
    client whose next request comes later than that exits."""
    connect = socket.create_connection
    monkeypatch.setattr(jax_transport.socket, "create_connection",
                        lambda address, timeout=None: connect(address, timeout=0.5))
    port = free_port()
    errors = []
    (thread,) = _spawn([_JaxFakeClient(0)], port, jax_transport.serve_client, errors)
    proxies = _accept(port, 1)
    time.sleep(1.0)
    thread.join(timeout=10)
    assert not thread.is_alive() and errors == [TimeoutError]
    for p in proxies:
        p.close()


# ----- fault (b): periodic checkpoints with remote clients -----

def test_port_server_with_proxies_writes_its_resume_file(tmp_path):
    port = free_port()
    _spawn([_FlakyClient(0), _FlakyClient(1)], port)
    proxies = _accept(port, 2)
    cfg = PortConfig.for_task("faz", iters=2, ckpt_iters=2, eval_iters=1000, max_iterations=4)
    snap = str(tmp_path / "snap")
    server = FederatedServer(cfg, proxies, get_strategy("FedAvg"), _payload(), snapshot_dir=snap)
    history = server.run(progress=False)
    assert [h["round"] for h in history] == [2, 4] and not any(h.get("aborted") for h in history)
    resume = CheckpointManager(snap).restore_resume()
    assert resume["server"]["current_round"] == 4 and resume["clients"] == {}
    torch.testing.assert_close(resume["global"]["params"]["w"], torch.full((4,), 2.0))
    # a server resumed from it keeps its remote clients as they are
    again = FederatedServer(cfg, proxies, get_strategy("FedAvg"), _payload(), snapshot_dir=snap)
    assert again.try_resume() and again.current_round == 4
    for p in proxies:
        p.close()


def test_jax_server_with_proxies_crashes_at_its_first_checkpoint(tmp_path):
    port = free_port()

    class _JaxFlaky(_JaxFakeClient):
        def fit(self, ins):
            res = super().fit(ins)
            return jax_api.FitRes({**res.payload, "batch_stats": {}}, res.num_examples,
                                  res.metrics, res.fit_duration)

    _spawn([_JaxFlaky(0), _JaxFlaky(1)], port, jax_transport.serve_client)
    proxies = jax_transport.accept_clients("127.0.0.1", port, 2, timeout=WAIT)
    for p in proxies:
        p.round_timeout = WAIT
    cfg = JaxConfig.for_task("faz", iters=2, ckpt_iters=2, eval_iters=1000, max_iterations=4)
    server = JaxServer(cfg, proxies, jax_get_strategy("FedAvg"),
                       {"params": {"w": np.zeros(4, np.float32)}, "batch_stats": {}},
                       snapshot_dir=str(tmp_path / "snap"))
    with pytest.raises(AttributeError, match="_asdict"):
        server.run(progress=False)
    for p in proxies:
        p.close()

