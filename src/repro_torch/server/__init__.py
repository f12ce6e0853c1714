"""faird: the DACP reference server (paper §IV)."""

from repro_torch.server.catalog import Catalog, Dataset, Policy
from repro_torch.server.datasource import scan_path, write_sdf_dataset
from repro_torch.server.engine import SDFEngine
from repro_torch.server.faird import FairdServer
from repro_torch.server.scheduler import CrossDomainScheduler

__all__ = [
    "Catalog",
    "Dataset",
    "Policy",
    "scan_path",
    "write_sdf_dataset",
    "SDFEngine",
    "FairdServer",
    "CrossDomainScheduler",
]
