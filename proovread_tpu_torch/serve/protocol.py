"""Local-socket JSONL protocol for the correction service (port of
``proovread_tpu/serve/protocol.py``: the same wire format, so a client of
either server talks to both).

One JSON object per line, UTF-8, over an ``AF_UNIX`` stream socket — the
deliberately boring transport for a single-host service (the reference's
SGE/"xargs -P" queue never left the host either; multi-host serving would
front this with a real RPC layer, not replace it). Every request carries
an ``op``; every response carries ``ok`` plus op-specific fields. A
submission that cannot be accepted is NEVER dropped on the floor: the
response says ``status: "rejected"`` with a machine-readable ``reason``
and, for backpressure rejections, a ``retry_after_s`` hint.

Ops::

    submit  {op, job_id, tenant, mode: clr|ccs|unitig, reads: [record],
             deadline_s?}            -> {ok, status: accepted|rejected,
                                         reason?, retry_after_s?}
    status  {op, job_id}             -> {ok, status, reason?, ...}
    result  {op, job_id}             -> {ok, status, untrimmed, trimmed,
                                         ignored, qc}   (completed jobs)
    cancel  {op, job_id}             -> {ok, status}
    stats   {op}                     -> {ok, slo: {...}}  (SLO snapshot)
    drain   {op}                     -> {ok, draining: true}
    ping    {op}                     -> {ok, draining: bool,
                                         replica_id: str, uptime_s: num,
                                         wave: null | {wave, jobs,
                                                       busy_s}}

The ``ping`` response is the fleet dispatcher's health probe
(``serve/fleet.py``): ``replica_id`` pins identity across a socket
reconnect, ``uptime_s`` is monotonic since the server was constructed
(a restart resets it — how the dispatcher notices a silent replace),
and ``wave`` carries the in-flight wave state so a replica hung in
a wave (``busy_s`` growing) is distinguishable from a healthy idle one
(``wave: null``).

Records on the wire are ``{"id", "seq", "qual": base64-u8 | null}`` —
the same qual encoding the checkpoint journal uses, so a journaled job
payload and a wire payload are byte-comparable.
"""

from __future__ import annotations

import json
import socket
from typing import Any, Dict, List, Optional, Sequence

from proovread_tpu_torch.io.records import SeqRecord
from proovread_tpu_torch.pipeline.resilience import _decode_qual, _encode_qual

# one read line cap: a malicious/buggy client must not buffer the server
# into the ground — bounded memory is the whole point of backpressure
MAX_LINE = 64 << 20

OPS = ("submit", "status", "result", "cancel", "stats", "drain", "ping")
MODES = ("clr", "ccs", "unitig")


def encode_record(r: SeqRecord) -> Dict[str, Any]:
    return {"id": r.id, "seq": r.seq, "qual": _encode_qual(r.qual)}


def decode_record(d: Dict[str, Any]) -> SeqRecord:
    if not isinstance(d, dict) or not isinstance(d.get("id"), str) \
            or not isinstance(d.get("seq"), str):
        raise ValueError(f"bad record object: {d!r}")
    return SeqRecord(id=d["id"], seq=d["seq"],
                     qual=_decode_qual(d.get("qual")))


def encode_records(records: Sequence[SeqRecord]) -> List[Dict[str, Any]]:
    return [encode_record(r) for r in records]


def decode_records(objs: Sequence[Dict[str, Any]]) -> List[SeqRecord]:
    if not isinstance(objs, (list, tuple)):
        raise ValueError("reads must be a list of record objects")
    return [decode_record(o) for o in objs]


def read_line(fh) -> Optional[bytes]:
    """One protocol line (bounded); None at EOF."""
    line = fh.readline(MAX_LINE + 1)
    if not line:
        return None
    if len(line) > MAX_LINE:
        raise ValueError(f"protocol line exceeds {MAX_LINE} bytes")
    return line


class ServeClient:
    """Blocking JSONL client over one persistent connection. Thin by
    design: tests, the smoke runner and operator tooling all drive the
    server through exactly this class, so the wire protocol is what gets
    exercised — not a parallel in-process shortcut."""

    def __init__(self, socket_path: str, timeout: float = 60.0):
        self.socket_path = socket_path
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        self._sock.connect(socket_path)
        self._fh = self._sock.makefile("rwb")

    def close(self) -> None:
        try:
            self._fh.close()
        finally:
            self._sock.close()

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def request(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        self._fh.write(json.dumps(obj).encode() + b"\n")
        self._fh.flush()
        line = read_line(self._fh)
        if line is None:
            raise ConnectionError("server closed the connection")
        return json.loads(line)

    # -- op helpers --------------------------------------------------------
    def submit(self, job_id: str, tenant: str,
               records: Sequence[SeqRecord], mode: str = "clr",
               deadline_s: Optional[float] = None) -> Dict[str, Any]:
        req: Dict[str, Any] = {
            "op": "submit", "job_id": job_id, "tenant": tenant,
            "mode": mode, "reads": encode_records(records)}
        if deadline_s is not None:
            req["deadline_s"] = deadline_s
        return self.request(req)

    def status(self, job_id: str) -> Dict[str, Any]:
        return self.request({"op": "status", "job_id": job_id})

    def result(self, job_id: str) -> Dict[str, Any]:
        return self.request({"op": "result", "job_id": job_id})

    def cancel(self, job_id: str) -> Dict[str, Any]:
        return self.request({"op": "cancel", "job_id": job_id})

    def stats(self) -> Dict[str, Any]:
        return self.request({"op": "stats"})

    def drain(self) -> Dict[str, Any]:
        return self.request({"op": "drain"})

    def ping(self) -> Dict[str, Any]:
        return self.request({"op": "ping"})

    def wait(self, job_id: str, timeout: float = 120.0,
             poll_s: float = 0.05) -> Dict[str, Any]:
        """Poll until the job reaches a terminal state (or timeout)."""
        import time
        t0 = time.monotonic()
        while True:
            st = self.status(job_id)
            if not st.get("ok") or st.get("terminal"):
                return st
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"job {job_id!r} not terminal after {timeout}s "
                    f"(last status: {st.get('status')})")
            time.sleep(poll_s)
