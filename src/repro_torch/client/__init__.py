"""DACP client SDK: multiplexed sessions, chainable lazy API, network fabric."""

from repro_torch.client.client import DacpClient, GroupedFrame, RemoteFrame, open_blob
from repro_torch.client.network import LocalNetwork, Network, TcpNetwork
from repro_torch.client.session import DacpSession

__all__ = [
    "DacpClient",
    "DacpSession",
    "GroupedFrame",
    "RemoteFrame",
    "open_blob",
    "LocalNetwork",
    "Network",
    "TcpNetwork",
]
