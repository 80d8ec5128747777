"""Cross-process federation transport: 1 server and N client processes over TCP.

Counterpart of ``fedicra_tpu/federation/transport.py``, with its wire
format: each message is a length-prefixed (``!Q``) pickle of a tuple whose
payloads are trees of numpy arrays, so for the same numpy object both
packages write the same bytes. Tensors become numpy only at the socket and
numpy becomes tensors on the receiver's device on arrival; the
FitIns/FitRes shapes are the in-process simulator's, so ``FederatedServer``
drives ``RemoteClientProxy`` objects unchanged. This is the reference's way
of running (flower_runner.py: one OS process per role) and the route that
federates across trust domains; on one card the in-process federation
(``federation/experiment.py``) serialises nothing.

Beside JAX's transport, ``serve_client`` waits for requests without a
time limit: the connect timeout (``CONNECT_TIMEOUT_S``) applies to the
connect only. JAX's client keeps it on the socket and exits once it waits
longer than that for its next request, i.e. as soon as the other clients'
fits take more than 10 s together.
"""

from __future__ import annotations

import pickle
import socket
import struct
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from .api import EvaluateIns, EvaluateRes, FitIns, FitRes

_LEN = struct.Struct("!Q")

# Payload sanity cap: the round payload is the full model state (a few MB at
# the reference's 1.8M params); anything near this bound is a corrupt or
# malicious length header, and rejecting it up front fails the round fast
# instead of blocking in _recv_exact until the peer goes away.
MAX_MSG_BYTES = 4 << 30

# seconds a client waits for each connection attempt to the server
CONNECT_TIMEOUT_S = 10.0


def _to_numpy(tree):
    """A payload tree with every tensor as a numpy array (host copy)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree


def _to_tensors(tree, device: torch.device):
    """A received payload tree with every numpy array as a tensor on ``device``."""
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree, device=device)
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    return tree


def send_msg(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    if len(data) > MAX_MSG_BYTES:
        raise ValueError(f"message of {len(data)} bytes exceeds cap")
    sock.sendall(_LEN.pack(len(data)) + data)


def recv_msg(sock: socket.socket) -> Any:
    header = _recv_exact(sock, _LEN.size)
    (length,) = _LEN.unpack(header)
    if length > MAX_MSG_BYTES:
        raise ConnectionError(f"malformed message header: length {length} exceeds cap")
    # the peer is this program's own server or client process
    return pickle.loads(_recv_exact(sock, length))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("socket closed")
        buf.extend(chunk)
    return bytes(buf)


class RemoteClientProxy:
    """Server-side handle implementing the FederatedClient interface over a
    socket (fit / evaluate / num_batches). Returned payloads are tensors on
    ``device`` (the card unless named)."""

    def __init__(
        self,
        sock: socket.socket,
        cid: int,
        num_batches: int,
        round_timeout: Optional[float] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.sock = sock
        self.cid = cid
        self.num_batches = num_batches
        self.round_timeout = round_timeout  # None = wait forever (reference
        # parity: round_timeout=None, ..._Ours.py:405)
        self.dead = False
        self._seq = 0  # request/reply correlation id

    def _request(self, req: tuple, expected_kind: str) -> tuple:
        """One request/reply exchange. Any failure (timeout mid-round,
        partial read, mismatched seq) permanently kills the proxy: a
        timed-out request leaves the late reply in flight, so reusing the
        socket would deliver round N's result to round N+1 (silently stale
        aggregation), and a timeout inside _recv_exact additionally
        desynchronises the length-prefixed framing."""
        if self.dead:
            raise ConnectionError(f"client {self.cid} proxy is dead (previous round failed)")
        self._seq += 1
        try:
            self.sock.settimeout(self.round_timeout)
            send_msg(self.sock, (req[0], self._seq, *req[1:]))
            reply = recv_msg(self.sock)
        except Exception:
            self.dead = True
            try:
                self.sock.close()
            except OSError:
                pass
            raise
        kind, seq = reply[0], reply[1]
        if kind != expected_kind or seq != self._seq:
            self.dead = True
            self.sock.close()
            raise ConnectionError(
                f"unexpected reply ({kind!r}, seq {seq}) to "
                f"{req[0]!r} seq {self._seq} from client {self.cid}"
            )
        return reply[2:]

    def fit(self, ins: FitIns) -> FitRes:
        payload, num, metrics, dur = self._request(
            ("fit", _to_numpy(ins.payload), ins.config), "fit_res"
        )
        return FitRes(payload=_to_tensors(payload, self.device), num_examples=num,
                      metrics=metrics, fit_duration=dur)

    def evaluate(self, ins: EvaluateIns) -> EvaluateRes:
        loss, num, metrics = self._request(
            ("evaluate", _to_numpy(ins.payload), ins.config), "evaluate_res"
        )
        return EvaluateRes(loss=loss, num_examples=num, metrics=metrics)

    def close(self):
        try:
            if not self.dead:
                send_msg(self.sock, ("shutdown", 0))
        except OSError:
            pass
        self.sock.close()


def accept_clients(
    host: str, port: int, expected: int, timeout: float = 300.0, device=None
) -> List[RemoteClientProxy]:
    """Listen until ``expected`` clients register (cid + batch count); the
    proxies return payloads on ``device`` (the card unless named)."""
    device = resolve_device(device)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    proxies: Dict[int, RemoteClientProxy] = {}
    try:
        srv.bind((host, port))
        srv.listen(expected)
        srv.settimeout(timeout)
        while len(proxies) < expected:
            sock, _ = srv.accept()
            sock.settimeout(timeout)  # for the registration only
            kind, cid, num_batches = recv_msg(sock)
            if kind != "register":
                sock.close()
                raise ConnectionError(f"expected a registration, got {kind!r}")
            proxies[cid] = RemoteClientProxy(sock, cid, num_batches, device=device)
    finally:
        srv.close()
    return [proxies[c] for c in sorted(proxies)]


def serve_client(client, host: str, port: int, retries: int = 60) -> None:
    """Client-side loop: register, then answer fit/evaluate until shutdown.

    ``client`` is a FederatedClient (federation/client.py); payloads arrive
    as tensors on ``client.device``.
    """
    sock = None
    for _ in range(retries):
        try:
            sock = socket.create_connection((host, port), timeout=CONNECT_TIMEOUT_S)
            break
        except OSError:
            time.sleep(1.0)
    if sock is None:
        raise ConnectionError(f"could not reach server at {host}:{port}")
    # the connect timeout stays on a socket; a client waits for its next
    # request as long as the other clients' fits take
    sock.settimeout(None)

    try:
        send_msg(sock, ("register", client.cid, client.num_batches))
        while True:
            msg = recv_msg(sock)
            if msg[0] == "shutdown":
                break
            _, seq, payload, config = msg
            payload = _to_tensors(payload, client.device)
            if msg[0] == "fit":
                res = client.fit(FitIns(payload, config))
                reply = ("fit_res", seq, _to_numpy(res.payload), res.num_examples,
                         _to_numpy(res.metrics), res.fit_duration)
            elif msg[0] == "evaluate":
                res = client.evaluate(EvaluateIns(payload, config))
                reply = ("evaluate_res", seq, res.loss, res.num_examples, _to_numpy(res.metrics))
            else:
                raise ConnectionError(f"unknown request {msg[0]!r}")
            del res, payload
            if client.device.type == "cuda":
                # Clients fit one after another on one card, but each
                # process's caching allocator keeps its peak (~28 GiB at the
                # headline configuration) after it replies: five would ask
                # for more than an 80 GB card holds. Return it before the
                # reply, so the server's next request finds it free.
                torch.cuda.empty_cache()
            send_msg(sock, reply)
    finally:
        sock.close()
