"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into an object file, all
at once in parallel, and the objects link into one shared library with a
plain C interface, loaded with ``ctypes``.  The library lands in
``build/kernels/<hash>/`` at the repository root, keyed by a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses it.

The build happens at the first CUDA launch, never at import, behind a
thread lock (executor workers race for it) and a file lock (so do
processes).  The flags keep numpy's float semantics: no FMA contraction,
correctly rounded division and denormals kept; ``--use_fast_math`` is never
used.  A failed build raises: there is no fallback on a CUDA device.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = [
    "NVCC_FLAGS",
    "SOURCES",
    "LaunchCounter",
    "build",
    "check",
    "check_tensor",
    "library",
    "runs_plain",
    "stream_of",
]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (
    "filter_select.cu",
    "project_arith.cu",
    "segment_reduce.cu",
    "fused_chain.cu",
    "flash_attention.cu",
    "decode_attention.cu",
    "ssd_scan.cu",
    "mlstm_chunk.cu",
    "gated_norm.cu",
    "causal_conv.cu",
    "rms_norm.cu",
)
HEADERS = ("common.cuh", "dataplane.cuh", "attention.cuh", "scan.cuh", "mma.cuh", "norm.cuh")
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-fmad=false",
    "-prec-div=true",
    "-prec-sqrt=true",
    "-ftz=false",
    "-Xptxas",
    "-v",
)
LIB_NAME = "libdacp_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_D = ctypes.c_double
# C signature of every entry point: (restype int = cudaGetLastError(), argtypes)
_SIGNATURES = {
    "dacp_filter_select_planes": (_P, _I, _P, _I, _L, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "dacp_project_tiles": (_P, _I, _L, _I, _P, _I, _P, _I, _P),
    "dacp_segment_sum": (_P, _P, _I, _I, _I, _P, _P, _P),
    "dacp_segment_minmax": (_P, _P, _I, _I, _I, _I, _P, _P, _P),
    "dacp_fused_chain": (
        (_P, _I, _P, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I)  # tables and widths
        + (_L, _I, _I, _I, _I, _I, _I)  # N, tile, n_rows, t_hi, t_lo, op, kind
        + (_P, _I, _P, _I, _I) * 2  # f32 and i32 programs
        + (_P, _I, _P, _P, _I, _I, _I)  # csums, fns, with_gidx, segmented, G
        + (_P,) * 8  # seven outputs and the ticket
        + (_P, _P, _I, _P, _P, _P)  # float sums' offsets, kinds, count; fsum, the nonfinite flag; the stream
    ),
    # q, k, v, o, dtype, B, KV, G, S, T, hd, causal, scale (0: hd^-0.5), strides, stream
    "dacp_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _D, _P, _P),
    # q, k, v, o, dtype, B, KV, G, T, hd, length, chunk, splits, scale, strides, m, l, acc partials, stream
    "dacp_decode_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _D, _P, _P, _P, _P, _P),
    # q, k, v, m, l, acc, then as dacp_decode_attention from dtype on
    "dacp_decode_attention_partials": (_P,) * 6 + (_I,) * 9 + (_D,) + (_P,) * 5,
    # x, dt, A, B, C, y, S_final, dtype, B, S, H, P, N, G (B/C groups), chunk, scratch (Ls, Tl, Tb, Sp), stream
    "dacp_ssd_scan": (_P,) * 7 + (_I,) * 8 + (_P,) * 5,
    # q, k, v, log_i, log_f, y, C, n, m, dtype, B, S, H, D, chunk, scratch (Cs, ns, mprev), stream
    "dacp_mlstm_chunk": (_P,) * 9 + (_I,) * 6 + (_P,) * 4,
    # y, x, z, D, scale, out, dtype, scale dtype, rows, d_inner, groups, head dim, eps, stream
    "dacp_gated_rmsnorm": (_P,) * 6 + (_I, _I, _L, _I, _I, _I, _D, _P),
    # x, w, bias, state, y, dtype, batch, S, C, K, vector loads, stream
    "dacp_causal_conv_silu": (_P,) * 5 + (_I, _L, _I, _I, _I, _I, _P),
    # x, scale, out, dtype, scale dtype, rows, row stride, width, eps, stream
    "dacp_rms_norm": (_P,) * 3 + (_I, _I, _L, _L, _I, _D, _P),
}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's -Xptxas -v report of the last build (registers, spills)


class LaunchCounter:
    """Thread-safe count of a kernel wrapper's launches on the card."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def bump(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH)")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_root() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def build() -> Path:
    """Compile the sources (if this hash is not built yet) and return the
    library's path.  Safe to call from several processes at once."""
    global build_log
    out_dir = build_root() / _digest()
    lib_path = out_dir / LIB_NAME
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if lib_path.exists():
                log = out_dir / "build.log"
                build_log = log.read_text() if log.exists() else ""
                return lib_path
            nvcc = _nvcc()
            procs = []
            for src in SOURCES:
                obj = out_dir / (src + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
                procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            logs = []
            failed = []
            for cmd, p in procs:
                text, _ = p.communicate()
                logs.append(f"$ {' '.join(cmd)}\n{text}")
                if p.returncode != 0:
                    failed.append(cmd[-3])
            build_log = "\n".join(logs)
            (out_dir / "build.log").write_text(build_log)
            if failed:
                raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
            tmp = out_dir / (LIB_NAME + ".tmp")
            link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp)]
            link += [str(out_dir / (src + ".o")) for src in SOURCES]
            res = subprocess.run(link, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
            os.replace(tmp, lib_path)
            return lib_path
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))  # dacpcheck: ignore[blocking] reason=racing workers must wait for the one build; no other lock nests inside
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                _lib = lib
    return _lib


def runs_plain(t) -> bool:
    """True when a wrapper runs its kernel's plain version on ``t``: a CPU
    tensor, or one that holds shapes and no data (the meta device, or a
    ``FakeTensor``, as the dry-run traces the model).  Neither is a card,
    so this is no fallback."""
    if t.device.type in ("cpu", "meta"):
        return True
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(t)


def stream_of(t) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error (a refused launch, a
    bad argument); the wrapper counts the launch only after this passes."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} (cudaError_t)")


def check_tensor(t, what: str, dtype, device, ndim: int) -> None:
    """Validate a kernel input before its pointer reaches C: a local tensor
    (not a DTensor) on ``device`` with this dtype and rank, contiguous
    (row-major)."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor, got {type(t).__name__}")
    if type(t) is not torch.Tensor:  # a DTensor holds no storage of its own: its data_ptr() is 0
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            raise TypeError(f"{what} is a DTensor: a kernel takes each rank's local tensor (per_shard.run)")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must have {ndim} dimensions, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
