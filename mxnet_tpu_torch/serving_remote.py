"""Serving replicas in other processes: a length-prefixed socket
protocol, so that a ``ReplicaRouter`` replica can live in another process
or host.

Counterpart of ``mxnet_tpu/serving_remote.py``, whole (host Python):

- **The wire is dumb; the router is smart.** One frame is a 4-byte
  big-endian length and a UTF-8 JSON object (:func:`send_frame`,
  :func:`recv_frame`, capped at ``_MAX_FRAME``), byte for byte the
  reference's frames. :class:`RemoteReplica` (the client) exposes the
  engine surface the router scores and dispatches (``generate()`` /
  ``load()``), so breakers, wedge detection, hedging, failover and the
  ``router.dispatch`` fault site wrap a remote replica unchanged. The
  remote hop is its own fault site (``router.remote``).
- **One deadline budget, one trace identity.** The client forwards the
  ambient ``faults.deadline_scope`` remainder, ``telemetry.current_trace()``
  and the request's ``SamplingSpec`` (``to_wire``) in the frame; the
  server re-enters the deadline and the trace around the engine call.
- **Typed sheds cross the wire.** An engine-side ``ShedError(kind=...)``
  comes back as a typed refusal and is raised again as the same type and
  kind on the client, so a remote ``draining`` shed fails over like a local
  one. Transport faults (refused, reset, EOF, timeout) raise
  ``faults.TransientFault``: the replica is blamed, its breaker trips and
  the request fails over.
- **Scale-down is a preemption.** ``RemoteReplica.preempt()`` asks the
  server's process to send itself SIGTERM: typed draining sheds at every
  admission edge, ``engine.waitall()``, exit ``MXNET_PREEMPTION_EXIT_CODE``
  (83).

:class:`ReplicaServer` is an ``engine`` drainable: ``engine.waitall()``,
and so the preemption drain, waits until every accepted request is
answered. The protocol carries token ids and JSON only, never tensors, so
a replica's engine may run on any device.

Chaos coverage: ``mxnet_tpu_torch.drills`` ``router_host_loss`` (SIGKILL
of the replica's process mid-storm) and ``router_scale_storm`` (warm join,
typed drain, exit 83), gated by
``tools/torch_check_availability_budget.py``.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional

from . import config as _config
from . import faults as _faults
from . import telemetry as _telemetry
from .faults import ShedError

__all__ = ["ReplicaServer", "RemoteReplica", "send_frame", "recv_frame"]

# one frame = !I length prefix + utf-8 JSON.  The cap is a sanity bound
# (a corrupt prefix must not allocate gigabytes), far above any real
# prompt/response in this protocol.
_MAX_FRAME = 16 << 20


def send_frame(sock: socket.socket, obj: Dict[str, Any]) -> None:
    payload = json.dumps(obj).encode("utf-8")
    sock.sendall(struct.pack("!I", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError(
                f"peer closed mid-frame ({len(buf)}/{n} bytes)")
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Dict[str, Any]:
    (n,) = struct.unpack("!I", _recv_exact(sock, 4))
    if n > _MAX_FRAME:
        raise _faults.FatalFault(
            f"frame length {n} exceeds the {_MAX_FRAME}-byte protocol "
            "cap (corrupt length prefix?)")
    return json.loads(_recv_exact(sock, n).decode("utf-8"))


class ReplicaServer:
    """Serve one engine's ``generate``/``load`` surface over the framed
    protocol.  ``start()`` binds (port 0 = ephemeral; read ``.port``),
    registers the server as an ``engine`` drainable, and accepts
    connections on a background thread — one handler thread per
    connection, each request answered in order on its connection.

    The server is transport only: admission control, deadline budgets,
    shedding, and page accounting all stay the engine's."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 name: Optional[str] = None):
        self.engine = engine
        self.host = host
        self.port = port
        self.name = name or _telemetry.instance_name("replica_server")
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._active = 0          # in-flight requests, for drain()
        self._closed = False
        self._threads: List[threading.Thread] = []

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ReplicaServer":
        from . import engine as _engine

        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.host, self.port))
        srv.listen(64)
        srv.settimeout(0.2)       # poll so close() is prompt
        self._sock = srv
        self.port = srv.getsockname()[1]
        _engine.register_drainable(self)
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"mxnet-replica-srv-{self.name}")
        self._threads.append(t)
        t.start()
        _telemetry.event("replica_serve", self.name, host=self.host,
                         port=self.port, pid=os.getpid())
        return self

    def drain(self, timeout: float = 60.0) -> None:
        """engine.waitall() hook: every accepted request answered —
        the preemption drain flushes replies before exit 83."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._active == 0:
                    return
            time.sleep(0.002)

    def close(self) -> None:
        self._closed = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    def __enter__(self):
        return self.start() if self._sock is None else self

    def __exit__(self, *exc):
        self.close()

    # -- serving ------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return                        # closed under us
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True,
                                 name=f"mxnet-replica-conn-{self.name}")
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            while not self._closed:
                try:
                    req = recv_frame(conn)
                except (ConnectionError, OSError, ValueError):
                    return                    # client went away
                with self._lock:
                    self._active += 1
                try:
                    rep = self._handle(req)
                except BaseException as e:    # transport must answer
                    rep = {"ok": False, "error": repr(e)}
                finally:
                    with self._lock:
                        self._active -= 1
                try:
                    send_frame(conn, rep)
                except OSError:
                    return
                if req.get("op") == "preempt":
                    # reply flushed; now take the notice like any
                    # preemptible process: SIGTERM → typed
                    # draining sheds → waitall → exit 83
                    os.kill(os.getpid(), signal.SIGTERM)
                    return

    def _handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        op = req.get("op")
        if op == "ping":
            return {"ok": True, "pid": os.getpid(), "name": self.name}
        if op == "load":
            return {"ok": True, "load": self.engine.load()}
        if op == "stats":
            st = {k: v for k, v in self.engine.stats().items()
                  if isinstance(v, (int, float, str, bool, type(None)))}
            return {"ok": True, "stats": st}
        if op == "pool":
            audit = (self.engine.pool_audit()
                     if hasattr(self.engine, "pool_audit") else [])
            in_use = (self.engine.pool_in_use()
                      if hasattr(self.engine, "pool_in_use") else 0)
            return {"ok": True, "in_use": in_use, "audit": audit}
        if op == "preempt":
            return {"ok": True, "pid": os.getpid()}
        if op == "generate":
            return self._generate(req)
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _generate(self, req: Dict[str, Any]) -> Dict[str, Any]:
        from .serving_decode import SamplingSpec

        deadline_us = req.get("deadline_us")
        # the sampling spec (temperature/top-k/top-p + counter-PRNG
        # seed) crosses the wire like the deadline does: positional
        # seeding means a failed-over or hedged SAMPLED request replays
        # token-exact on whichever replica answers
        wire_samp = req.get("sampling")
        sampling = (SamplingSpec.from_wire(wire_samp)
                    if wire_samp is not None else None)
        try:
            # re-enter the request's ONE identity and ONE budget: the
            # engine's admission/shed/span records stamp the trace_id
            # the router minted a process away
            with _telemetry.trace_scope(trace_id=req.get("trace_id")):
                if deadline_us is not None:
                    with _faults.deadline_scope(
                            deadline_us=int(deadline_us),
                            site="router.remote"):
                        toks = self.engine.generate(
                            req["prompt"],
                            max_new_tokens=int(
                                req.get("max_new_tokens", 32)),
                            eos=req.get("eos"),
                            sampling=sampling)
                else:
                    toks = self.engine.generate(
                        req["prompt"],
                        max_new_tokens=int(req.get("max_new_tokens", 32)),
                        eos=req.get("eos"),
                        sampling=sampling)
            return {"ok": True, "tokens": [int(t) for t in toks]}
        except ShedError as e:
            return {"ok": False, "shed_kind": getattr(e, "kind", None),
                    "error": str(e)}
        except _faults.DeadlineExceeded as e:
            return {"ok": False, "shed_kind": "deadline",
                    "error": str(e)}
        except BaseException as e:
            return {"ok": False, "error": repr(e)}


class RemoteReplica:
    """Client shim: the engine surface a ``ReplicaRouter`` dispatches
    to, backed by a ``ReplicaServer`` in another process/host.  One
    TCP connection per in-flight call (the router's per-dispatch worker
    threads stay independent; a SIGKILL'd server fails every open call
    at once, which is exactly the signal failover needs)."""

    def __init__(self, host: str, port: int, *,
                 name: Optional[str] = None,
                 timeout_s: Optional[float] = None):
        self.host = host
        self.port = port
        self.name = name or f"remote[{host}:{port}]"
        self._timeout_s = float(
            _config.get("MXNET_ROUTER_REMOTE_TIMEOUT_S")
            if timeout_s is None else timeout_s)
        self._closed = False

    # -- wire ---------------------------------------------------------------
    def _call(self, req: Dict[str, Any],
              timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """One framed round trip.  Transport faults are replica-blamed
        (``TransientFault`` → breaker + failover); typed sheds re-raise
        as ``ShedError(kind=...)`` — the wire never invents outcomes."""
        if self._closed:
            raise RuntimeError(f"{self.name} is closed")
        # the remote hop is its own registered fault site: the matrix
        # can sever the wire without killing a process
        _faults.inject("router.remote")
        budget = timeout_s if timeout_s is not None else self._timeout_s
        try:
            with socket.create_connection((self.host, self.port),
                                          timeout=budget) as sock:
                sock.settimeout(budget)
                send_frame(sock, req)
                rep = recv_frame(sock)
        except _faults.FaultInjected:
            raise
        except (OSError, ConnectionError, socket.timeout,
                json.JSONDecodeError) as e:
            raise _faults.TransientFault(
                f"{self.name} transport fault on {req.get('op')!r}: "
                f"{e!r}") from e
        if rep.get("ok"):
            return rep
        kind = rep.get("shed_kind")
        if kind:
            raise ShedError(f"{self.name}: {rep.get('error')}",
                            kind=kind)
        raise _faults.TransientFault(
            f"{self.name} remote error on {req.get('op')!r}: "
            f"{rep.get('error')}")

    # -- the engine surface the router dispatches -----------------------------
    def generate(self, prompt, max_new_tokens: int = 32,
                 eos: Optional[int] = None,
                 sampling=None) -> List[int]:
        """Remote ``GenerativeEngine.generate``: forwards the ambient
        deadline remainder, trace id, and sampling spec in-band; the
        socket timeout is the same budget (+slack for the reply frame),
        so a wedged or dead server bounds the wait and fails over.
        The sampling seed rides the frame like ``t_enqueue`` rides the
        router: position-keyed PRNG makes a retried/hedged sampled
        request token-exact across replicas."""
        amb = _faults.deadline_remaining_us()
        timeout_s = (min(self._timeout_s, amb / 1e6 + 1.0)
                     if amb is not None else None)
        rep = self._call({
            "op": "generate",
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
            "eos": eos,
            "sampling": (sampling.to_wire()
                         if sampling is not None else None),
            "deadline_us": amb,
            "trace_id": _telemetry.current_trace(),
        }, timeout_s=timeout_s)
        return [int(t) for t in rep["tokens"]]

    def load(self) -> Dict[str, float]:
        """Remote ``engine.load()`` for the router's scoring/probing —
        a short-deadline liveness call (the kvstore heartbeat idiom:
        liveness IS a cheap answered request)."""
        rep = self._call({"op": "load"}, timeout_s=min(self._timeout_s,
                                                      5.0))
        return {k: float(v) for k, v in rep["load"].items()}

    def ping(self) -> bool:
        try:
            return bool(self._call({"op": "ping"},
                                   timeout_s=min(self._timeout_s,
                                                 5.0)).get("ok"))
        except (RuntimeError, ShedError, _faults.TransientFault):
            return False

    def pool(self) -> Dict[str, Any]:
        """Remote page accounting (drills: the leak/audit check crosses
        the wire too)."""
        return self._call({"op": "pool"},
                          timeout_s=min(self._timeout_s, 5.0))

    def preempt(self) -> int:
        """Scale-down: ask the server process to SIGTERM itself — the
        graceful preemption (typed draining sheds, waitall, exit
        83) IS the retirement path.  Returns the server pid (the
        supervisor holding the process handle awaits the exit code)."""
        rep = self._call({"op": "preempt"},
                         timeout_s=min(self._timeout_s, 5.0))
        return int(rep["pid"])

    def close(self) -> None:
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
