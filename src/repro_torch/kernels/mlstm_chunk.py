"""Chunkwise stabilised mLSTM — the port of ``repro.kernels.mlstm_chunk``.

    q/k/v (b, s, h, d), log_i/log_f (b, s, h) f32
        -> y (b, s, h, d) f32, C (b, h, d, d) f32, n (b, h, d) f32, m (b, h) f32

The exponentially gated matrix memory of xLSTM (arXiv:2405.04517 App. A),
computed chunk by chunk (length ``chunk``): within a chunk as D-masked
attention, across chunks through the stabilised (C, n, m).  m starts at
-1e30 as in the TPU kernel.  The TPU kernel returns y only; the port also
returns the final (C, n, m) — equal to the recurrent scan's final carry —
because prefill hands it to the decode state.  Any S: the last chunk may be
shorter (the same as padding with log f = 0 and log i = -inf).

For a CUDA tensor the wrapper launches the hand-written kernels of
``csrc/mlstm_chunk.cu`` (q, k, v float32 or bfloat16; d 32, 64, 128, 256
or 384; chunk at most 256; bfloat16 rows 16-byte aligned) or raises; for a
CPU tensor it runs ``mlstm_chunk_plain``.  On card tensors that need a
gradient, y and the final (C, n, m) carry the plain version's backward
(``grad.PlainBackward``).  Which kernels run is decided by
dtype.  bfloat16 runs two kernels on the tensor cores, counted as one
launch: the carry chunk after chunk over tiles of C (keeping the state
before each chunk), then every chunk's outputs in parallel, the float32
operands of its products split into bf16 hi + lo (see the source); the
states between them live in float32 scratch allocated here, (b·h, chunks,
d, d) for C.  float32 runs
one CUDA-core kernel that walks the chunks in order, splitting the value
dimension over blocks of 64 columns, since the TPU kernel's (d, d) scratch
(576 KB at xlstm-125m's d = 384) is beyond an SM's shared memory; its 5e-4
tolerance holds either way, but float32 inputs would lose bits in bf16
products.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, grad

__all__ = ["HEAD_DIMS", "MAX_CHUNK", "NEG", "launches", "mlstm_chunk", "mlstm_chunk_plain"]

NEG = -1e30
MAX_CHUNK = 256  # one chunk row per thread of the CUDA kernel's block
HEAD_DIMS = (32, 64, 128, 256, 384)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = _build.LaunchCounter("mlstm_chunk")


def mlstm_chunk_plain(q, k, v, log_i, log_f, chunk: int = 256):
    """Plain PyTorch version: the TPU kernel's chunk step on (b·h)-batched
    tensors, one chunk after another, with each chunk's (L, L) matrices
    materialised."""
    b, s, h, d = q.shape
    scale = d**-0.5
    l = min(chunk, s)

    def heads(a):
        return a.permute(0, 2, 1, 3).reshape(b * h, s, d).float()

    qh, kh, vh = heads(q), heads(k), heads(v)
    lih = log_i.permute(0, 2, 1).reshape(b * h, s).float()
    lfh = log_f.permute(0, 2, 1).reshape(b * h, s).float()
    C = torch.zeros((b * h, d, d), dtype=torch.float32, device=q.device)
    n = torch.zeros((b * h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b * h,), NEG, dtype=torch.float32, device=q.device)
    ys = []
    for c0 in range(0, s, l):
        qc, kc, vc = qh[:, c0 : c0 + l], kh[:, c0 : c0 + l], vh[:, c0 : c0 + l]
        li, lf = lih[:, c0 : c0 + l], lfh[:, c0 : c0 + l]
        lc = qc.shape[1]
        cf = torch.cumsum(lf, dim=-1)
        keep = torch.ones((lc, lc), dtype=torch.bool, device=q.device).tril()
        w = (cf[:, :, None] - cf[:, None, :] + li[:, None, :]).masked_fill(~keep, NEG)
        bb = cf + m[:, None]
        m_row = torch.maximum(w.amax(dim=-1), bb)
        D = torch.exp(w - m_row[..., None])
        inter = torch.exp(bb - m_row)
        sd = (qc @ kc.transpose(1, 2)) * scale * D
        num = sd @ vc + inter[..., None] * (qc @ C) * scale
        nvec = D @ kc + inter[..., None] * n[:, None, :]
        den = torch.maximum((qc * nvec).sum(dim=-1).abs() * scale, torch.exp(-m_row))
        ys.append(num / den[..., None])
        # carry to the next chunk
        last = cf[:, -1:]
        m_carry = torch.maximum(m + last[:, 0], (last - cf + li).amax(dim=-1))
        wk = torch.exp(last - cf + li - m_carry[:, None])
        decay = torch.exp(m + last[:, 0] - m_carry)
        kw = kc * wk[..., None]
        C = decay[:, None, None] * C + kw.transpose(1, 2) @ vc
        n = decay[:, None] * n + kw.sum(dim=1)
        m = m_carry
    y = torch.cat(ys, dim=1).reshape(b, h, s, d).permute(0, 2, 1, 3)
    return y, C.reshape(b, h, d, d), n.reshape(b, h, d), m.reshape(b, h)


def _check(q, k, v, log_i, log_f, chunk: int) -> None:
    """Validate the inputs of a CUDA launch; raise on what the kernel does not take."""
    _build.check_tensor(q, "mlstm_chunk: q", q.dtype, q.device, 4)
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"mlstm_chunk takes float32 or bfloat16 q/k/v, got {q.dtype}")
    b, s, h, d = q.shape
    for what, t, dtype, shape in (
        ("k", k, q.dtype, (b, s, h, d)),
        ("v", v, q.dtype, (b, s, h, d)),
        ("log_i", log_i, torch.float32, (b, s, h)),
        ("log_f", log_f, torch.float32, (b, s, h)),
    ):
        _build.check_tensor(t, f"mlstm_chunk: {what}", dtype, q.device, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"mlstm_chunk: {what} has shape {tuple(t.shape)}, expected {shape}")
    if d not in HEAD_DIMS:
        raise ValueError(f"mlstm_chunk takes head dims {HEAD_DIMS}, got {d}")
    if q.numel() == 0 or chunk < 1:
        raise ValueError(f"mlstm_chunk: empty input {tuple(q.shape)} or chunk {chunk}")
    if min(chunk, s) > MAX_CHUNK:
        raise ValueError(f"mlstm_chunk's CUDA kernel takes chunks of at most {MAX_CHUNK} rows, got {chunk}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("mlstm_chunk: bfloat16 q, k and v must start on a 16-byte boundary")


def mlstm_chunk(q, k, v, log_i, log_f, chunk: int = 256):
    """q/k/v (b, s, h, d); log_i/log_f (b, s, h) f32 -> (y (b, s, h, d),
    C (b, h, d, d), n (b, h, d), m (b, h)), all f32."""
    if _build.runs_plain(q):
        return mlstm_chunk_plain(q, k, v, log_i, log_f, chunk)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunk runs on cuda or cpu, got {q.device}")
    if grad.needs_grad(q, k, v, log_i, log_f):
        return grad.PlainBackward.apply(_launch, mlstm_chunk_plain, {"chunk": chunk}, q, k, v, log_i, log_f)
    return _launch(q, k, v, log_i, log_f, chunk)


def _launch(q, k, v, log_i, log_f, chunk: int):
    """The CUDA kernels on card tensors; raises on what they do not take."""
    _check(q, k, v, log_i, log_f, chunk)
    b, s, h, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    y = torch.empty((b, s, h, d), **f32)
    C = torch.empty((b, h, d, d), **f32)
    n = torch.empty((b, h, d), **f32)
    m = torch.empty((b, h), **f32)
    lc = min(chunk, s)
    if q.dtype == torch.bfloat16:  # the states between the bf16 kernels
        nc = -(-s // lc)
        scratch = (torch.empty((b * h, nc, d, d), **f32), torch.empty((b * h, nc, d), **f32),
                   torch.empty((b * h, nc), **f32))
        ptrs = [t.data_ptr() for t in scratch]
    else:
        ptrs = [None] * 3
    rc = _build.library().dacp_mlstm_chunk(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        log_i.data_ptr(),
        log_f.data_ptr(),
        y.data_ptr(),
        C.data_ptr(),
        n.data_ptr(),
        m.data_ptr(),
        DTYPE_CODES[q.dtype],
        b,
        s,
        h,
        d,
        lc,
        *ptrs,
        _build.stream_of(q),
    )
    _build.check(rc, "mlstm_chunk")
    launches.bump()
    return y, C, n, m
