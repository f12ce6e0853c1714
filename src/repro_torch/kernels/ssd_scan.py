"""Mamba2 SSD chunk scan — the port of ``repro.kernels.ssd_scan``.

    x (b, s, h, p), dt (b, s, h) f32, A (h,) f32 < 0, B/C (b, s, n) or (b, s, g, n)
        -> y (b, s, h, p) f32, S_final (b, h, p, n) f32

B and C in ``g`` groups (g divides h): head h reads group h // (h / g),
as Mamba2's ``ngroups`` lays them out; (b, s, n) is one group.

The recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_tᵀ, y_t = h_t C_t,
computed chunk by chunk (length ``chunk``): within a chunk in its quadratic
(attention-like) form, across chunks through the f32 (p, n) state.  The TPU
kernel returns y only; the port also returns the final state, the contract
of ``repro.kernels.ref.ssd_scan_ref``, because prefill hands it to the
decode cache.  Any S: a ragged tail chunk is shorter (the reference model
pads it with dt = 0, which leaves the state unchanged and adds nothing).

For a CUDA tensor the wrapper launches the hand-written kernels of
``csrc/ssd_scan.cu`` (x, B, C float32 or bfloat16; p 32 or 64; n 16, 32,
64 or 128; chunk at most 256; bfloat16 rows 16-byte aligned; in bfloat16 a
group's heads a multiple of 4, so that the four heads of a block share
one group's B and C) or raises; for a
CPU tensor it runs ``ssd_scan_plain``.  On card tensors that need a
gradient, y and the final state carry the plain version's backward
(``grad.PlainBackward``).  Which kernels run is decided by
dtype.  bfloat16 runs three kernels on the tensor cores, counted as one
launch: every chunk's own end state at once, the carry over the chunks,
then every chunk's outputs, the float32 operands of the products split
into bf16 hi + lo (three parts where the carry sums them over chunks; see
the source); what the kernels hand on (each chunk's own state, its decay
tables, the state before it) lives in scratch allocated here, about 48 MB
at zamba2-1.2b's prefill.  float32 runs one CUDA-core kernel, one block
per (b, h) walking the chunks in order with the state in shared memory,
tiling each chunk's (L, L) matrix into 64 × 64 blocks that it never holds
whole.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, grad

__all__ = ["MAX_CHUNK", "P_DIMS", "N_DIMS", "grouped_launches", "launches", "ssd_scan", "ssd_scan_plain",
           "wide_state_launches"]

MAX_CHUNK = 256  # one chunk row per thread of the CUDA kernels' blocks
HEADS_A_BLOCK = 4  # heads of one block of the bfloat16 kernels' state and output passes
P_DIMS = (32, 64)
N_DIMS = (16, 32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = _build.LaunchCounter("ssd_scan")
grouped_launches = _build.LaunchCounter("ssd_scan_grouped")  # of those, with B/C in more than one group
wide_state_launches = _build.LaunchCounter("ssd_scan_n128")  # of those, at d_state 128


def _segsum(x):
    """x (..., L) -> (..., L, L): out[i, j] = sum_{j<k<=i} x_k for i >= j, -inf above."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~keep, float("-inf"))


def ssd_scan_plain(x, dt, A, B, C, chunk: int = 256):
    """Plain PyTorch version: ``repro.models.ssm._ssd_chunked`` in torch,
    with the (L, L) decay matrix of every chunk materialised; B/C in groups
    (b, s, g, n) scan each group's heads in turn."""
    if B.dim() == 4:
        g = B.shape[2]
        if g == 1:
            return ssd_scan_plain(x, dt, A, B[:, :, 0], C[:, :, 0], chunk)
        hg = x.shape[2] // g
        parts = [ssd_scan_plain(x[:, :, i * hg : (i + 1) * hg], dt[:, :, i * hg : (i + 1) * hg],
                                A[i * hg : (i + 1) * hg], B[:, :, i], C[:, :, i], chunk) for i in range(g)]
        return torch.cat([y for y, _ in parts], dim=2), torch.cat([st for _, st in parts], dim=1)
    b, s, nh, p = x.shape
    n = B.shape[-1]
    l = min(chunk, s)
    s_orig = s
    if s % l:
        pad = l - s % l  # dt = 0: decay 1, contribution 0, state unchanged
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
        s += pad
    c = s // l
    xc = x.reshape(b, c, l, nh, p).float()
    dtc = dt.reshape(b, c, l, nh).float()
    Bc = B.reshape(b, c, l, n).float()
    Cc = C.reshape(b, c, l, n).float()
    dA = (dtc * A.float()[None, None, None, :]).permute(0, 1, 3, 2)  # (b, c, h, l)
    dA_cs = torch.cumsum(dA, dim=-1)

    # 1. within each chunk
    L = torch.exp(_segsum(dA))  # (b, c, h, l, l)
    scores = torch.einsum("bcln,bcmn->bclm", Cc, Bc)
    M = scores[:, :, None] * L
    xdt = xc * dtc[..., None]
    y_diag = torch.einsum("bchlm,bcmhp->bclhp", M, xdt)

    # 2. each chunk's own contribution to the state at its end
    r = torch.exp(dA_cs[..., -1:] - dA_cs)  # (b, c, h, l)
    states = torch.einsum("bcln,bchl,bclhp->bchpn", Bc, r, xdt)

    # 3. the state across chunks
    chunk_decay = torch.exp(dA_cs[..., -1])  # (b, c, h)
    S = torch.zeros((b, nh, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for ci in range(c):
        prev.append(S)
        S = S * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)  # (b, c, h, p, n): the state before each chunk

    # 4. the state before a chunk, read by each of its rows
    q = torch.exp(dA_cs).permute(0, 1, 3, 2).contiguous()  # (b, c, l, h)
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", Cc, prev_states, q)
    y = (y_diag + y_off).reshape(b, s, nh, p)[:, :s_orig]
    return y, S


def _check(x, dt, A, B, C, chunk: int) -> None:
    """Validate the inputs of a CUDA launch; raise on what the kernel does not take."""
    _build.check_tensor(x, "ssd_scan: x", x.dtype, x.device, 4)
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x/B/C, got {x.dtype}")
    if B.dim() == 3:  # one group
        B, C = B.unsqueeze(2), C.unsqueeze(2)
    _build.check_tensor(B, "ssd_scan: B", x.dtype, x.device, 4)
    b, s, h, p = x.shape
    g, n = B.shape[2:]
    for what, t, dtype, shape in (
        ("dt", dt, torch.float32, (b, s, h)),
        ("A", A, torch.float32, (h,)),
        ("B", B, x.dtype, (b, s, g, n)),
        ("C", C, x.dtype, (b, s, g, n)),
    ):
        _build.check_tensor(t, f"ssd_scan: {what}", dtype, x.device, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_scan: {what} has shape {tuple(t.shape)}, expected {shape}")
    if p not in P_DIMS or n not in N_DIMS:
        raise ValueError(f"ssd_scan takes p in {P_DIMS} and n in {N_DIMS}, got p={p} n={n}")
    if h % g or (g > 1 and x.dtype == torch.bfloat16 and (h // g) % HEADS_A_BLOCK):
        raise ValueError(f"ssd_scan: {g} groups over {h} heads (bfloat16: a group's heads a multiple of "
                         f"{HEADS_A_BLOCK})")
    if x.numel() == 0 or chunk < 1:
        raise ValueError(f"ssd_scan: empty input {tuple(x.shape)} or chunk {chunk}")
    if min(chunk, s) > MAX_CHUNK:
        raise ValueError(f"ssd_scan's CUDA kernel takes chunks of at most {MAX_CHUNK} rows, got {chunk}")
    if x.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd_scan: bfloat16 x, B and C must start on a 16-byte boundary")


def ssd_scan(x, dt, A, B, C, chunk: int = 256):
    """x (b, s, h, p); dt (b, s, h) f32; A (h,) f32; B/C (b, s, n) or (b,
    s, g, n), x's type -> (y (b, s, h, p) f32, S_final (b, h, p, n) f32)."""
    if _build.runs_plain(x):
        return ssd_scan_plain(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, got {x.device}")
    if B.dim() == 3:  # one group
        B, C = B.unsqueeze(2), C.unsqueeze(2)
    if grad.needs_grad(x, dt, A, B, C):
        return grad.PlainBackward.apply(_launch, ssd_scan_plain, {"chunk": chunk}, x, dt, A, B, C)
    return _launch(x, dt, A, B, C, chunk)


def _launch(x, dt, A, B, C, chunk: int):
    """The CUDA kernels on card tensors; raises on what they do not take."""
    _check(x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    g, n = B.shape[2:]
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    S_final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lc = min(chunk, s)
    if x.dtype == torch.bfloat16:  # what the bf16 kernels hand on: see dacp_ssd_scan
        nc = -(-s // lc)
        f32 = dict(dtype=torch.float32, device=x.device)
        scratch = (torch.empty((b, h, nc, p, n), **f32), torch.empty((b, h, nc), **f32),
                   torch.empty((b, h, nc, 6, MAX_CHUNK), **f32),
                   torch.empty((b, h, nc, 3, p, n), dtype=torch.bfloat16, device=x.device))
        ptrs = [t.data_ptr() for t in scratch]
    else:
        ptrs = [None] * 4
    rc = _build.library().dacp_ssd_scan(
        x.data_ptr(),
        dt.data_ptr(),
        A.data_ptr(),
        B.data_ptr(),
        C.data_ptr(),
        y.data_ptr(),
        S_final.data_ptr(),
        DTYPE_CODES[x.dtype],
        b,
        s,
        h,
        p,
        n,
        g,
        lc,
        *ptrs,
        _build.stream_of(x),
    )
    _build.check(rc, "ssd_scan")
    launches.bump()
    if g > 1:
        grouped_launches.bump()
    if n == 128:
        wide_state_launches.bump()
    return y, S_final
