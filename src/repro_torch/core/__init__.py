"""DACP protocol core: the paper's §III as a composable library.

Public surface:
    Schema / Field / dtypes      — scientific type system (§III-A eq.2)
    RecordBatch / Column         — columnar atomic transport unit beta_k
    StreamingDataFrame (SDF)     — D = <S, F> (§III-A eq.1)
    Expr / col / lit             — serializable predicates & projections
    Dag / Node                   — COOK task graphs G=(V,E) (§III-B)
    optimize / required_columns  — predicate & projection pushdown
    plan / Plan / SubTask        — cross-domain decomposition (§III-D)
    TokenAuthority               — short-lived scoped access tokens (§III-C)
    parse / DacpUri              — dacp:// addressing (§III-C eq.3)
"""

from repro_torch.core import dtypes
from repro_torch.core.batch import Column, RecordBatch, concat_batches
from repro_torch.core.dag import Dag, Node
from repro_torch.core.errors import (
    DacpError,
    PermissionDenied,
    PlanError,
    ResourceNotFound,
    SchemaError,
    SubTaskFailed,
    TokenError,
    TransportError,
    TypeMismatchError,
)
from repro_torch.core.expr import Expr, and_, col, lit, not_, or_
from repro_torch.core.operators import MAP_REGISTRY, execute, get_map, register_map
from repro_torch.core.planner import CLIENT_DOMAIN, Plan, SubTask, assign_domains, plan
from repro_torch.core.pushdown import optimize, required_columns
from repro_torch.core.schema import Field, Schema
from repro_torch.core.sdf import SDF, StreamingDataFrame
from repro_torch.core.tokens import Token, TokenAuthority
from repro_torch.core.uri import DacpUri, format_uri, parse

__all__ = [
    "dtypes",
    "Column",
    "RecordBatch",
    "concat_batches",
    "Dag",
    "Node",
    "DacpError",
    "PermissionDenied",
    "PlanError",
    "ResourceNotFound",
    "SchemaError",
    "SubTaskFailed",
    "TokenError",
    "TransportError",
    "TypeMismatchError",
    "Expr",
    "and_",
    "col",
    "lit",
    "not_",
    "or_",
    "MAP_REGISTRY",
    "execute",
    "get_map",
    "register_map",
    "CLIENT_DOMAIN",
    "Plan",
    "SubTask",
    "assign_domains",
    "plan",
    "optimize",
    "required_columns",
    "Field",
    "Schema",
    "SDF",
    "StreamingDataFrame",
    "Token",
    "TokenAuthority",
    "DacpUri",
    "format_uri",
    "parse",
]
