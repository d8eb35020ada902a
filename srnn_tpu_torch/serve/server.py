"""Unix-socket JSON-lines transport around :class:`ExperimentService`;
port of ``srnn_tpu/serve/server.py``, the same protocol (a client of
either package talks to a server of the other).

One request per line, one response per line:

  {"op": "ping"}                               -> {"ok": true}
  {"op": "submit", "kind": K, "params": {...},
   "tenant": "name"}                           -> {"ok": true, "ticket": id}
  {"op": "wait", "ticket": id, "timeout_s": S} -> {"ok": true, "status":
                                                   "done", "result": {...}}
  {"op": "request", ...submit fields...}       -> submit + wait in one line
  {"op": "stats"}                              -> {"ok": true, "stats": ...}
  {"op": "shutdown"}                           -> {"ok": true} and the
                                                  server stops

Connection handling rides ``socketserver.ThreadingMixIn`` (per-connection
threads, joined on ``server_close``); the DISPATCH loop is one dedicated
thread (``pipeline.spawn_thread``) draining the service queue with a
batching window, so the device's launches stay on one thread however many
clients connect.  The batching window is the stacking knob: requests
arriving within the window of each other are scheduled together and stack
when their static spellings match.

Continuous batching: the dispatcher BLOCKS on the service's
admission condition variable while idle (no poll-sleep — an idle worker
burns no CPU, and the first ticket after quiet wakes it immediately), and
with a ``controller`` attached the wait window is the ADAPTIVE per-group
value (``serve.controller``) instead of the fixed ``batch_window_s`` —
tickets admit into the very next dispatch as soon as the current one
retires.  ``controller=None`` keeps the fixed-window dispatch
byte-exact (the ``--no-adaptive`` A/B oracle).
"""

import json
import os
import socket
import socketserver
import threading
import time
from typing import Optional

from ..utils.pipeline import spawn_thread
from .service import DeadlineExpired, ExperimentService, OverloadedError


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        server: "ServiceServer" = self.server  # type: ignore[assignment]
        for raw in self.rfile:
            line = raw.decode("utf-8", "replace").strip()
            if not line:
                continue
            try:
                resp = server.handle_op(json.loads(line))
            except Exception as e:
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()
            if resp.get("bye"):
                break


class ServiceServer(socketserver.ThreadingMixIn,
                    socketserver.UnixStreamServer):
    """The long-lived server: socket accept loop + one dispatch thread."""

    daemon_threads = False   # joined on server_close: no stranded handlers
    allow_reuse_address = True
    # connection-per-op clients connect in bursts; the socketserver
    # default backlog of 5 turns any accept-loop stall into EAGAIN
    # connect failures under concurrent load
    request_queue_size = 128

    def __init__(self, service: ExperimentService, socket_path: str,
                 batch_window_s: float = 0.25, controller=None,
                 idle_tick_s: float = 1.0):
        if os.path.exists(socket_path):
            # only a STALE socket (killed server) may be reclaimed — a
            # live server answering ping must not have its socket stolen
            # out from under its clients by a second instance
            if wait_for_socket(socket_path, timeout_s=0.0):
                raise RuntimeError(
                    f"a live experiment service already answers on "
                    f"{socket_path}; refusing to steal its socket")
            os.unlink(socket_path)
        super().__init__(socket_path, _Handler)
        self.service = service
        self.socket_path = socket_path
        self.batch_window_s = batch_window_s
        #: adaptive window controller (None = fixed window, the A/B
        #: oracle); attaching it also flips the service's fairness plan
        self.controller = controller
        if controller is not None:
            service.attach_controller(controller)
        #: idle heartbeat: how often a blocked dispatcher wakes to slide
        #: the rate-alert windows (throttled inside the service) and
        #: re-check its stop flag
        self._idle_tick_s = max(0.05, float(idle_tick_s))
        self._stop = threading.Event()
        #: graceful-drain flag (the SIGTERM path): finish the in-flight
        #: dispatch, do NOT dispatch the remaining queue — those tickets
        #: stay journaled-unfinished and a restarted service replays them
        self._drain = threading.Event()
        self._dispatcher = None

    # -- ops -------------------------------------------------------------

    def handle_op(self, msg: dict) -> dict:
        op = msg.get("op")
        if op == "ping":
            return {"ok": True}
        if op == "submit":
            if self._stop.is_set():
                return {"ok": False, "error": "service shutting down"}
            return self._admit(msg)
        if op in ("wait", "request"):
            if op == "request":
                if self._stop.is_set():
                    return {"ok": False, "error": "service shutting down"}
                admitted = self._admit(msg)
                if not admitted["ok"]:
                    return admitted
                ticket = admitted["ticket"]
            else:
                ticket = msg["ticket"]
            entry = self.service.wait(ticket,
                                      timeout_s=float(msg.get("timeout_s",
                                                              600.0)))
            out = {"ok": entry["status"] == "done", "ticket": ticket}
            out.update(entry)
            return out
        if op == "stats":
            return {"ok": True, "stats": self.service.stats()}
        if op == "drain":
            # socket spelling of the SIGTERM drain (tests, orchestrators)
            self.stop(drain=True)
            return {"ok": True, "bye": True, "draining": True}
        if op == "shutdown":
            self._stop.set()
            self.service.wake()   # a condvar-blocked dispatcher re-checks
            # unblock serve_forever from a handler thread without joining
            # ourselves: shutdown() must run off the serve_forever thread
            spawn_thread(self.shutdown, name="serve-shutdown")
            return {"ok": True, "bye": True}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _admit(self, msg: dict) -> dict:
        """Submit with the typed admission responses: ``overloaded`` and
        ``deadline_expired`` flags let the client pick the right reaction
        (back off and resubmit vs give up) without string-matching."""
        try:
            ticket = self.service.submit(
                msg["kind"], msg.get("params", {}),
                tenant=msg.get("tenant"),
                deadline_s=msg.get("deadline_s"),
                idempotency_key=msg.get("idempotency_key"),
                trace_id=msg.get("trace_id"),
                parent_span=msg.get("parent_span"))
        except OverloadedError as e:
            return {"ok": False, "error": str(e), "overloaded": True}
        except DeadlineExpired as e:
            return {"ok": False, "error": str(e), "deadline_expired": True}
        return {"ok": True, "ticket": ticket}

    # -- lifecycle -------------------------------------------------------

    def _dispatch_loop(self) -> None:
        """Single-threaded device dispatch, continuous batching: block on
        the admission condvar while idle, give the (adaptive) batching
        window a chance to aggregate, drain, loop straight into the next
        round — tickets admit into the next dispatch the moment the
        current one retires."""
        while not self._stop.is_set():
            if not self.service.wait_for_work(timeout_s=self._idle_tick_s):
                # rate-alert windows keep sliding while idle (throttled
                # inside — a fired SLO-burn alert must clear on quiet)
                self.service.idle_sample_live()
                continue
            if self.controller is None:
                window = self.batch_window_s
            else:
                window = self.controller.window_s(
                    self.service.pending_groups())
            if window > 0:
                time.sleep(window)
            if self._drain.is_set():
                # SIGTERM landed during the window: the queued tickets
                # stay journaled-unfinished for the restart to replay —
                # dispatching them now is exactly what drain forbids
                return
            # window_s = the sleep just performed: the service splits each
            # ticket's pre-dispatch wait into queue vs window spans with it
            self.service.run_pending(window_s=window)
        if self._drain.is_set():
            return
        # drain whatever raced the stop (handle_op rejects new traffic
        # once _stop is set, so this converges; no window sleep here)
        while self.service.queue_depth() > 0:
            self.service.run_pending()

    def serve_until_shutdown(self) -> None:
        """Run the accept loop on THIS thread and the dispatch loop on a
        spawned one; returns after a ``shutdown`` op (or ``stop()``)."""
        self._dispatcher = spawn_thread(self._dispatch_loop,
                                        name="serve-dispatch")
        try:
            self.serve_forever(poll_interval=0.1)
        finally:
            self._stop.set()
            self.service.wake()
            self._dispatcher.join()
            # a submit that slipped between the stop-check and the
            # dispatcher's final drain must not leave its handler thread
            # blocked in wait() — server_close() JOINS handler threads,
            # so a stranded waiter would hang shutdown for its timeout.
            # Either way the stranded tickets stay journaled-unfinished;
            # the drain spelling says so in the typed response.
            if self._drain.is_set():
                self.service.fail_pending(
                    "service draining; ticket journaled for replay "
                    "after restart", resumable=True)
            else:
                self.service.fail_pending(
                    "service shut down before dispatch")
            self.server_close()
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass

    def stop(self, drain: bool = False) -> None:
        """Signal-safe stop (the SIGTERM path): ``shutdown()`` blocks
        until ``serve_forever`` exits, and a signal handler runs ON the
        thread inside ``serve_forever`` — calling it synchronously there
        deadlocks, so it moves to a helper thread like the shutdown op.
        ``drain=True`` is the graceful-preemption contract: finish the
        in-flight dispatch, journal (keep) the rest, exit clean so a
        restart resumes them."""
        if drain:
            self._drain.set()
        self._stop.set()
        self.service.wake()
        spawn_thread(self.shutdown, name="serve-stop")


def wait_for_socket(path: str, timeout_s: float = 30.0) -> bool:
    """Readiness probe: can we connect and ping?  Always probes at least
    once, so ``timeout_s=0`` is a one-shot liveness check."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.settimeout(2.0)
                s.connect(path)
                s.sendall(b'{"op": "ping"}\n')
                if b'"ok": true' in s.makefile("rb").readline():
                    return True
        except OSError:
            pass
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.1)
