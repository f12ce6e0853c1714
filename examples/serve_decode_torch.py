"""Serving example of the PyTorch port: batched prefill + greedy decode with
a decode cache, on the port's kernels (attention; Mamba2's ``ssd_scan`` for
``--arch zamba2-1.2b``; ``mlstm_chunk`` for ``--arch xlstm-125m``).

Prompts arrive as rows of a DACP SDF (the request queue is itself a
streaming data frame); the port's ``faird`` tokenizes them in place over
TCP; ``TorchFeed`` brings the token batch to the device; the model prefills
the batch and decodes N new tokens per request.

    PYTHONPATH=src python examples/serve_decode_torch.py                 # on the card
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu    # plain versions
"""

import argparse
import os
import shutil
import socket
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

import repro_torch.data  # noqa: F401  registers tokenize_and_pack for this process's server
from repro_torch import device as device_mod
from repro_torch.client import TcpNetwork
from repro_torch.client.torch_adapter import TorchFeed
from repro_torch.configs import get_config
from repro_torch.core.executor import ExecutorConfig
from repro_torch.data import training_dag, write_token_corpus
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels import ops
from repro_torch.launch.serve import greedy_generate
from repro_torch.models import build
from repro_torch.server import FairdServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--arch", default="paper-lm-100m")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    # request queue as a DACP stream, tokenized in place by a faird over TCP
    tmp = tempfile.mkdtemp(prefix="dacp_serve_")
    corpus = os.path.join(tmp, "prompts.jsonl")
    write_token_corpus(corpus, docs=args.requests)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    server = FairdServer(f"127.0.0.1:{port}", executor=ExecutorConfig(device=str(dev)))
    server.catalog.register_path("prompts", tmp)
    server.serve_tcp(port=port)
    net = TcpNetwork()
    try:
        client = net.client_for(f"127.0.0.1:{port}")
        dag = training_dag(f"dacp://127.0.0.1:{port}/prompts/prompts.jsonl", seq_len=args.prompt_len,
                           batch_rows=args.requests)
        # TorchFeed splits each packed row into tokens (all but the last) and
        # labels; serving takes the tokens: prompt_len ids per request
        feed = TorchFeed(lambda: client.cook(dag), token_column="tokens", seq_len=args.prompt_len + 1,
                         global_batch=args.requests, device=dev)
        prompts = next(iter(feed))["tokens"].contiguous()
    finally:
        net.close_all()
        server.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"request batch: {tuple(prompts.shape)} on {prompts.device}")

    cfg = get_config(args.arch).reduced()
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    for c in ops.LAUNCHES.values():
        c.reset()
    out = greedy_generate(api, params, prompts, args.new_tokens)

    tok = ByteTokenizer()
    host_prompts = prompts.cpu().numpy()
    for i, ids in enumerate(out["ids"]):
        print(f"req{i}: prompt={tok.decode(host_prompts[i])[:40]!r}... completion_ids={ids[:8].tolist()}...")
    cache = out["cache"]
    index = (cache["kv"] if "kv" in cache else cache)["index"]  # zamba2 keeps it with its shared block's cache
    launched = ", ".join(f"{name} {c.value}" for name, c in ops.LAUNCHES.items() if c.value)
    print(f"decode steps: {args.new_tokens} | cache index: {index} | "
          f"prefill {out['prefill_s'] * 1e3:.1f} ms, decode {out['decode_s'] / args.new_tokens * 1e3:.2f} ms/token | "
          f"kernel launches: {launched or 'none (plain versions on the cpu)'}")


if __name__ == "__main__":
    main()
