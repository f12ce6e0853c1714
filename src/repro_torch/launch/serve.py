"""Serving launcher of the port: batched prefill + greedy decode for any
configuration the port's model zoo builds (dense and MoE attention, zamba2,
xlstm, the encoder-decoder), on an explicit device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b --reduced \
        --batch 4 --prompt-len 64 --new-tokens 32                 # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b --full \
        --prompts dacp://127.0.0.1:3101/prompts/prompts.jsonl     # prompts from a faird
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --full \
        --batch 4 --prompt-len 1024 --new-tokens 32               # Mamba2 + shared attention
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small --full   # stub frames

Weights are random, drawn on the device from a ``torch.Generator`` seeded
with 0.  An encoder-decoder takes stub frame embeddings (B, enc_seq, d),
drawn from the same seeded numpy generator as random prompts, as the
reference's launcher draws them.
Prompts are random token ids unless ``--prompts`` names a DACP text corpus:
then the server tokenizes and packs them in place (``training_dag``, whose
``tokenize_and_pack`` map is registered by importing ``repro_torch.data`` in
the *server's* process) and the client reads the token blobs.  Prints the
prefill time and the decode time per token, with the device's name.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

__all__ = ["dacp_prompts", "greedy_generate", "main"]


def dacp_prompts(uri: str, batch: int, prompt_len: int) -> np.ndarray:
    """(batch, prompt_len) int32 prompt tokens: COOK ``training_dag`` on the
    corpus a TCP ``faird`` serves at ``uri``, read the whole stream of packed
    token blobs and take the first ``batch`` rows."""
    from repro_torch.client import TcpNetwork
    from repro_torch.client.torch_adapter import tokens_from_blob_column
    from repro_torch.core.uri import parse
    from repro_torch.data import TOKENS_COLUMN, training_dag

    net = TcpNetwork()
    try:
        client = net.client_for(parse(uri).authority)
        dag = training_dag(uri, seq_len=prompt_len - 1, batch_rows=batch)
        rows = [tokens_from_blob_column(rb, TOKENS_COLUMN, prompt_len) for rb in client.cook(dag).iter_batches()]
        prompts = np.concatenate(rows) if rows else np.zeros((0, prompt_len), np.int32)
    finally:
        net.close_all()
    if prompts.shape[0] < batch:
        raise ValueError(f"{uri} holds {prompts.shape[0]} prompts, {batch} asked for")
    return np.array(prompts[:batch])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def greedy_generate(api, params, tokens: torch.Tensor, new_tokens: int, frames: torch.Tensor | None = None) -> dict:
    """Prefill ``tokens`` (B, S) — with ``frames`` (B, enc_seq, d) for an
    encoder-decoder — then ``new_tokens`` greedy decode steps.

    Returns ``ids`` (B, new_tokens + 1) int64 numpy — the argmax after the
    prefill and after each decode step — the prefill's last logits, the
    final cache, and the prefill and decode wall seconds (each ending in a
    device synchronise)."""
    dev = tokens.device
    max_seq = tokens.shape[1] + new_tokens
    _sync(dev)
    t0 = time.perf_counter()
    batch = {"tokens": tokens} if frames is None else {"tokens": tokens, "frames": frames}
    logits, cache = api.prefill(params, batch, max_seq)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    cur = logits[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
    ids = [cur]
    t0 = time.perf_counter()
    for _ in range(new_tokens):
        step_logits, cache = api.decode_step(params, cur, cache)
        cur = step_logits[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
        ids.append(cur)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return {
        "ids": torch.cat(ids, dim=1).cpu().numpy().astype(np.int64),
        "prefill_logits": logits,
        "cache": cache,
        "prefill_s": prefill_s,
        "decode_s": decode_s,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-lm-100m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--prompts", default=None, help="dacp:// URI of a jsonl text corpus with a 'text' column")
    args = ap.parse_args(argv)

    from repro_torch import device as device_mod
    from repro_torch.configs import get_config
    from repro_torch.models import build

    dev = device_mod.resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = build(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = api.init(gen, dev)
    r = np.random.default_rng(0)
    if args.prompts:
        prompts = dacp_prompts(args.prompts, args.batch, args.prompt_len)
    else:
        prompts = r.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    tokens = torch.from_numpy(prompts).to(dev)
    frames = None
    if cfg.is_encdec:
        frames = torch.from_numpy(r.normal(size=(args.batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)).to(dev)

    out = greedy_generate(api, params, tokens, args.new_tokens, frames)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(
        f"arch={cfg.name} device={name} batch={args.batch} prefill({args.prompt_len})={out['prefill_s'] * 1e3:.1f}ms "
        f"decode={out['decode_s'] / max(args.new_tokens, 1) * 1e3:.2f}ms/tok last_ids={out['ids'][:4, -1]}"
    )
    return out


if __name__ == "__main__":
    main()
