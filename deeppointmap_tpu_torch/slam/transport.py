"""TCP transport for multi-agent messages (port of
deeppointmap_tpu/slam/transport.py).

The reference's agents and cloud share one process and exchange Python
objects through queues (reference: system/modules/utils.py:116-154). For
deployments where agents run in processes or hosts of their own, this
module carries the same message schema over TCP using the byte codec
(slam/serialization.py), in the JAX package's framing:

    [1-byte op][1-byte source id][8-byte big-endian payload length][payload]

`RemoteCommModule` stands in for the agent side of CommModule:
`send_message` serializes UPLOAD_SCAN payloads and control messages to the
cloud host. `TransportServer` feeds a local CommModule on the cloud host,
so CloudSystem runs unchanged. Either end may be the JAX package's.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
from typing import Optional

from deeppointmap_tpu_torch.slam.serialization import (decode_upload,
                                                       encode_upload)
from deeppointmap_tpu_torch.slam.utils import CommModule

logger = logging.getLogger(__name__)

_OPS = {"NO_OP": 0, "UPLOAD_SCAN": 1, "AGENT_QUIT": 2, "QUIT": 3}
_OPS_INV = {v: k for k, v in _OPS.items()}
_HDR = struct.Struct(">BBQ")  # op, src_id, payload length


def _send_frame(sock: socket.socket, op: str, src_id: int,
                payload: bytes = b"") -> None:
    sock.sendall(_HDR.pack(_OPS[op], src_id, len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class TransportServer:
    """Accepts agent connections and forwards messages into a local
    CommModule (the cloud's inbox, member id 0)."""

    def __init__(self, comm: CommModule, host: str = "127.0.0.1",
                 port: int = 0):
        self.comm = comm
        comm.register(0)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        # agents whose AGENT_QUIT was forwarded: their connection carries
        # it after every upload, so all of their uploads are in `comm`
        self._quit = threading.Condition()
        self._quit_ids: set = set()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                break
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        with conn:
            while True:
                hdr = _recv_exact(conn, _HDR.size)
                if hdr is None:
                    return
                op_code, src_id, n = _HDR.unpack(hdr)
                payload = _recv_exact(conn, n) if n else b""
                if n and payload is None:
                    return
                op = _OPS_INV[op_code]
                if op == "UPLOAD_SCAN":
                    scan, odom, nbrs = decode_upload(payload)
                    self.comm.send_message(src_id, 0, op, dict(
                        new_scan=scan, odometer_edge=odom,
                        neighbor_edges=nbrs))
                else:
                    self.comm.send_message(src_id, 0, op)
                    if op == "AGENT_QUIT":
                        with self._quit:
                            self._quit_ids.add(src_id)
                            self._quit.notify_all()

    def wait_agents_quit(self, agent_ids, timeout: float) -> bool:
        """Wait until every agent in `agent_ids` has sent AGENT_QUIT (and so
        all of its uploads are in the cloud's inbox). -> False on timeout."""
        want = set(agent_ids)
        with self._quit:
            return self._quit.wait_for(lambda: want <= self._quit_ids,
                                       timeout=timeout)

    def close(self) -> None:
        self._stop.set()
        self._srv.close()


class RemoteCommModule:
    """Agent-side CommModule replacement that ships messages to the cloud
    over TCP. Implements the subset of the CommModule API that
    SlamSystem uses (register / send_message)."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))
        self._lock = threading.Lock()

    def register(self, member_id: int) -> None:
        pass  # membership is implicit in the connection

    def send_message(self, src_id: int, dst_id: int, operation: str,
                     message=None) -> None:
        if dst_id != 0:
            raise ValueError("the remote transport targets the cloud (id 0)")
        if operation == "UPLOAD_SCAN":
            payload = encode_upload(message["new_scan"],
                                    message.get("odometer_edge"),
                                    message.get("neighbor_edges", []))
        else:
            payload = b""
        with self._lock:
            _send_frame(self._sock, operation, src_id, payload)

    def close(self) -> None:
        self._sock.close()
