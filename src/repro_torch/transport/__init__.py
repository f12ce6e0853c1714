"""Transport layer: frame codec + channels + SDF streaming (Flight analogue)."""

from repro_torch.transport.channel import InProcChannel, SocketChannel, channel_pair, connect_tcp
from repro_torch.transport.flight import recv_sdf, send_error, send_sdf
from repro_torch.transport.framing import BATCH, END, ERROR, OK, REQUEST, SCHEMA, FrameReader, FrameWriter

__all__ = [
    "InProcChannel",
    "SocketChannel",
    "channel_pair",
    "connect_tcp",
    "recv_sdf",
    "send_error",
    "send_sdf",
    "BATCH",
    "END",
    "ERROR",
    "OK",
    "REQUEST",
    "SCHEMA",
    "FrameReader",
    "FrameWriter",
]
