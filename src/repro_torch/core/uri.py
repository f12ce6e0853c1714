"""dacp:// unified resource addressing (paper §III-C, eq. 3).

    dacp://<host>:<port>/[<dataset_name>]/<path>

``dataset_name`` is optional — whether the first segment names a dataset is
resolved against the server catalog, so the parsed form keeps raw segments
and exposes both interpretations.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from repro_torch.core.errors import ResourceNotFound

__all__ = ["DacpUri", "parse", "format_uri"]

_URI_RE = re.compile(
    r"^dacp://(?P<host>\[[0-9a-fA-F:]+\]|[^:/\s]+)(?::(?P<port>\d{1,5}))?(?P<path>/.*)?$"
)

DEFAULT_PORT = 3101


@dataclass(frozen=True)
class DacpUri:
    host: str
    port: int
    segments: tuple  # path split on '/', no empties

    @property
    def path(self) -> str:
        return "/" + "/".join(self.segments)

    @property
    def dataset_candidate(self) -> str | None:
        return self.segments[0] if self.segments else None

    @property
    def subpath(self) -> str:
        return "/".join(self.segments[1:])

    def child(self, *more: str) -> "DacpUri":
        extra = []
        for m in more:
            extra.extend(s for s in m.split("/") if s)
        return DacpUri(self.host, self.port, self.segments + tuple(extra))

    @property
    def authority(self) -> str:
        return f"{self.host}:{self.port}"

    def __str__(self) -> str:
        return f"dacp://{self.host}:{self.port}{self.path}"


def parse(uri: str) -> DacpUri:
    m = _URI_RE.match(uri.strip())
    if not m:
        raise ResourceNotFound(f"not a dacp:// URI: {uri!r}")
    host = m.group("host")
    port = int(m.group("port") or DEFAULT_PORT)
    if not (0 < port < 65536):
        raise ResourceNotFound(f"bad port in {uri!r}")
    raw = m.group("path") or "/"
    segments = tuple(s for s in raw.split("/") if s)
    return DacpUri(host=host, port=port, segments=segments)


def format_uri(host: str, port: int, *segments: str) -> str:
    segs = []
    for s in segments:
        segs.extend(x for x in str(s).split("/") if x)
    return str(DacpUri(host, port, tuple(segs)))
