"""Control-plane wire protocol: length-prefixed JSON frames over TCP (copy
of qmf_tpu/distributed/protocol.py).

The same frames as qmf_tpu's, so a scheduler, labor or submit client of
either package talks to the other's: 4-byte magic ``QMFT`` + uint32
big-endian payload length + UTF-8 JSON. Message kinds mirror the reference
OpCodes (reference distributed/common/Message.h:40-70):

    submit_task / submit_task_rsp      (kSubmitTask / kSubmitTaskRsp)
    attach_labor / attach_labor_rsp    (kAttachLabor / kAttachLaborRsp)
    heartbeat / info_rsp               (kHeartBeat / kInfoRsp)
    task_announce / task_announce_rsp  (kPushRate-era task sync, control only)
    status / status_rsp                (new: job-queue observability)

The bulk payloads of the reference's binary protocol (dataset and factor
broadcasts) ride the ranks' process group here (qmf_tpu_torch/parallel/),
so the control plane carries only small control messages.
"""

from __future__ import annotations

import asyncio
import json
import socket
import struct
from typing import Any, Dict, Optional

MAGIC = b"QMFT"
MAX_FRAME = 64 * 1024 * 1024
HEARTBEAT_INTERVAL_S = 30.0  # reference kHeartBeatInternal (Common.h:23)


class ProtocolError(RuntimeError):
    pass


def encode_frame(msg: Dict[str, Any]) -> bytes:
    payload = json.dumps(msg, separators=(",", ":")).encode()
    if len(payload) > MAX_FRAME:
        raise ProtocolError(f"frame too large: {len(payload)}")
    return MAGIC + struct.pack(">I", len(payload)) + payload


def _decode_head(head: bytes) -> int:
    if head[:4] != MAGIC:
        raise ProtocolError(f"bad magic: {head[:4]!r}")
    (length,) = struct.unpack(">I", head[4:8])
    if length > MAX_FRAME:
        raise ProtocolError(f"frame too large: {length}")
    return length


# --- asyncio side (scheduler / labor daemons) ------------------------------
async def read_frame(reader: asyncio.StreamReader) -> Optional[Dict[str, Any]]:
    """Read one frame; None on clean EOF."""
    try:
        head = await reader.readexactly(8)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    length = _decode_head(head)
    try:
        payload = await reader.readexactly(length)
    except asyncio.IncompleteReadError as e:
        # mid-payload EOF is an abnormal drop, not a clean shutdown; raise
        # a ConnectionError (IncompleteReadError is an EOFError, which the
        # daemons' reconnect/drop handlers do NOT catch — an unwrapped one
        # would exit the labor CLI instead of triggering its backoff loop)
        raise ConnectionError(
            f"connection dropped mid-frame ({len(e.partial)}/{length} bytes)"
        ) from e
    return json.loads(payload.decode())


async def write_frame(writer: asyncio.StreamWriter, msg: Dict[str, Any]) -> None:
    writer.write(encode_frame(msg))
    await writer.drain()


# --- blocking side (submit client) ------------------------------------------
def send_and_recv(
    host: str, port: int, msg: Dict[str, Any], timeout: float = 30.0
) -> Dict[str, Any]:
    """One-shot blocking request/response."""
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall(encode_frame(msg))
        head = _recv_exact(sock, 8)
        length = _decode_head(head)
        payload = _recv_exact(sock, length)
        return json.loads(payload.decode())


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ProtocolError("connection closed mid-frame")
        buf += chunk
    return buf
