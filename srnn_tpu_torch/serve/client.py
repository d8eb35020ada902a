"""Client for the experiment service (``serve.server`` transport); port
of ``srnn_tpu/serve/client.py``.

One connection per op — the ops are tiny JSON lines and the service is
local (Unix socket), so connection reuse buys nothing and per-op sockets
keep the client trivially thread-safe (a load generator may run many
client threads).

Self-healing etiquette: with ``retries > 0`` the client rides out
a service restart — connection failures (``ECONNREFUSED`` / missing
socket / timeout / a connection the dying service closed mid-op) retry
with DETERMINISTIC seeded exponential backoff, and a typed ``overloaded``
rejection (admission control pushing back) backs off the same way instead
of hammering a saturated queue.  Pair that with ``idempotency_key``:
a resubmit after a restart dedupes against the service's durable journal
and returns the ORIGINAL ticket instead of double-running the work.
"""

import json
import socket
import time
import uuid
from typing import Optional

from ..resilience.supervisor import BackoffPolicy


def mint_trace_id() -> str:
    """A fresh 16-hex-char trace id (fleet tracing).  Host-only entropy:
    the id labels telemetry rows and never reaches a dispatch path, so
    minting cannot perturb results (the ``--no-spans`` bitwise oracle
    covers the whole propagation chain)."""
    return uuid.uuid4().hex[:16]


class ServiceError(RuntimeError):
    """The service answered ``ok: false`` (bad request, failed dispatch)."""


class ServiceOverloaded(ServiceError):
    """Typed admission rejection (``overloaded: true``): the queue is at
    ``--max-queue``.  Back off and resubmit — the request was never
    admitted, so resubmitting cannot double-run."""


#: failures where the op can never have REACHED the service (the connect
#: itself failed) — always safe to retry.  BlockingIOError is Linux's
#: EAGAIN from connect(2) on an AF_UNIX socket whose listen backlog is
#: full (a burst of per-op connects against a momentarily stalled accept
#: loop): nothing was delivered
_RETRY_SAFE_EXC = (ConnectionRefusedError, FileNotFoundError,
                   BlockingIOError)
#: failures where the op may have been DELIVERED before the connection
#: died — retried only for idempotent messages (reads, or admissions
#: carrying an ``idempotency_key`` the service dedupes on); a keyless
#: submit retried here could double-run work that was already admitted
_RETRY_DELIVERED_EXC = (ConnectionResetError, BrokenPipeError,
                        TimeoutError, socket.timeout)

#: ops that are idempotent regardless of payload (pure reads)
_IDEMPOTENT_OPS = frozenset({"ping", "stats", "wait"})


def _retry_is_safe(msg: dict) -> bool:
    return msg.get("op") in _IDEMPOTENT_OPS \
        or bool(msg.get("idempotency_key"))


class ServiceClient:
    def __init__(self, socket_path: str, timeout_s: float = 600.0,
                 retries: int = 0, backoff_base_s: float = 0.2,
                 backoff_max_s: float = 5.0, seed: int = 0):
        self.socket_path = socket_path
        self.timeout_s = timeout_s
        self.retries = max(0, int(retries))
        # the supervisor's deterministic-backoff policy, reused verbatim:
        # the same seed yields the same delay sequence, so a
        # chaos-harness run replays end to end; real fleets seed per
        # client and decorrelate
        self._policy = BackoffPolicy(max_restarts=self.retries,
                                     base_s=backoff_base_s,
                                     max_s=backoff_max_s, jitter=0.25,
                                     seed=int(seed) ^ 0xC11E)

    def _op_once(self, msg: dict, timeout_s: Optional[float] = None) -> dict:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(timeout_s or self.timeout_s)
            s.connect(self.socket_path)
            s.sendall((json.dumps(msg) + "\n").encode())
            line = s.makefile("rb").readline()
        if not line:
            # a dying service closes mid-op; retryable like a refused
            # connect (the op may not have been admitted — idempotency
            # keys make the retry safe either way)
            raise ConnectionResetError("service closed the connection "
                                       "mid-op")
        resp = json.loads(line.decode("utf-8", "replace"))
        if not resp.get("ok"):
            err = resp.get("error") or f"request failed: {resp}"
            if resp.get("overloaded"):
                raise ServiceOverloaded(err)
            raise ServiceError(err)
        return resp

    def _op(self, msg: dict, timeout_s: Optional[float] = None,
            retry_overload: bool = False) -> dict:
        attempt = 0
        while True:
            try:
                return self._op_once(msg, timeout_s=timeout_s)
            except ServiceOverloaded:
                # never admitted: always safe to resubmit
                if not retry_overload or attempt >= self.retries:
                    raise
            except _RETRY_SAFE_EXC:
                if attempt >= self.retries:
                    raise
            except _RETRY_DELIVERED_EXC:
                # the op may have landed before the connection died —
                # only idempotent messages may go again
                if attempt >= self.retries or not _retry_is_safe(msg):
                    raise
            time.sleep(self._policy.delay(attempt))
            attempt += 1

    def ping(self, timeout_s: float = 5.0) -> bool:
        try:
            self._op_once({"op": "ping"}, timeout_s=timeout_s)
            return True
        except (OSError, ServiceError):
            return False

    def wait_until_up(self, timeout_s: float = 30.0) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.ping(timeout_s=2.0):
                return
            time.sleep(0.1)
        raise TimeoutError(
            f"no experiment service answering on {self.socket_path} "
            f"after {timeout_s}s")

    def _submit_msg(self, op: str, kind: str, params: dict,
                    tenant: Optional[str],
                    deadline_s: Optional[float],
                    idempotency_key: Optional[str],
                    trace_id: Optional[str] = None,
                    parent_span: Optional[int] = None) -> dict:
        msg = {"op": op, "kind": kind, "params": params, "tenant": tenant}
        if deadline_s is not None:
            msg["deadline_s"] = deadline_s
        if idempotency_key is not None:
            msg["idempotency_key"] = idempotency_key
        # trace context rides as optional header fields: a traceless
        # submit is byte-identical to the pre-tracing protocol
        if trace_id is not None:
            msg["trace_id"] = trace_id
        if parent_span is not None:
            msg["parent_span"] = parent_span
        return msg

    def submit(self, kind: str, params: dict,
               tenant: Optional[str] = None,
               deadline_s: Optional[float] = None,
               idempotency_key: Optional[str] = None,
               trace_id: Optional[str] = None,
               parent_span: Optional[int] = None) -> str:
        return self._op(self._submit_msg("submit", kind, params, tenant,
                                         deadline_s, idempotency_key,
                                         trace_id or mint_trace_id(),
                                         parent_span),
                        retry_overload=True)["ticket"]

    def wait(self, ticket: str, timeout_s: Optional[float] = None) -> dict:
        t = timeout_s if timeout_s is not None else self.timeout_s
        # socket deadline sits OUTSIDE the service-side wait timeout so the
        # service's own TimeoutError (a clean ok:false) arrives first
        return self._op({"op": "wait", "ticket": ticket, "timeout_s": t},
                        timeout_s=t + 10.0)["result"]

    def request(self, kind: str, params: dict,
                tenant: Optional[str] = None,
                timeout_s: Optional[float] = None,
                deadline_s: Optional[float] = None,
                idempotency_key: Optional[str] = None,
                trace_id: Optional[str] = None,
                parent_span: Optional[int] = None) -> dict:
        """Submit + wait in one op (the setups' submit mode)."""
        t = timeout_s if timeout_s is not None else self.timeout_s
        msg = self._submit_msg("request", kind, params, tenant,
                               deadline_s, idempotency_key,
                               trace_id or mint_trace_id(), parent_span)
        msg["timeout_s"] = t
        return self._op(msg, timeout_s=t + 10.0,
                        retry_overload=True)["result"]

    def stats(self) -> dict:
        return self._op({"op": "stats"}, timeout_s=10.0)["stats"]

    def drain(self) -> None:
        """Graceful drain (the socket spelling of SIGTERM): in-flight
        dispatches finish, the queued rest stays journaled for a restart
        to replay."""
        self._op_once({"op": "drain"}, timeout_s=10.0)

    def shutdown(self) -> None:
        self._op_once({"op": "shutdown"}, timeout_s=10.0)
