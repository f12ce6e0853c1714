"""Training launcher of the port: a port ``FairdServer`` (its executor on the
same device) tokenizes a text corpus in place (``training_dag``), ``TorchFeed`` streams the token blobs
onto the device, and ``Trainer`` trains a decoder-only configuration.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b --seq 1024 \
        --batch 4 --micro 2 --compress-grads --steps 4           # full width, on the card

The reference's flags, plus ``--device`` (``cuda`` unless ``cpu`` is asked
for).  Weights are random, drawn on the device from a ``torch.Generator``
seeded with 0.  Without ``--corpus`` a synthetic corpus is written to a
temporary directory.  Prints the step, loss and learning rate of the last
logged steps, with the device's name.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-lm-100m")
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--micro", type=int, default=1, help="gradient accumulation microbatches")
    ap.add_argument("--corpus", default=None, help="jsonl with a 'text' column; synthetic if absent")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)

    import torch

    import repro_torch.data  # noqa: F401  registers tokenize_and_pack for the in-process server
    from repro_torch import device as device_mod
    from repro_torch.client import LocalNetwork
    from repro_torch.client.torch_adapter import TorchFeed
    from repro_torch.configs import get_config
    from repro_torch.core.executor import ExecutorConfig
    from repro_torch.data import training_dag, write_token_corpus
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.server import FairdServer
    from repro_torch.train import Trainer

    dev = device_mod.resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encdec:
        ap.error(f"{cfg.name} is an encoder-decoder: the token feed carries no frames")

    tmp = None
    corpus = args.corpus
    if corpus is None:
        tmp = tempfile.mkdtemp(prefix="dacp_train_")
        corpus = os.path.join(tmp, "docs.jsonl")
        write_token_corpus(corpus, docs=1024)
    server = FairdServer("data:3101", executor=ExecutorConfig(device=str(dev)))
    try:
        net = LocalNetwork()
        server.catalog.register_path("corpus", os.path.dirname(os.path.abspath(corpus)))
        net.register(server)
        client = net.client_for("data:3101")
        dag = training_dag(
            f"dacp://data:3101/corpus/{os.path.basename(corpus)}", seq_len=args.seq, batch_rows=args.batch
        )

        def feed():
            return iter(TorchFeed(lambda: client.cook(dag), token_column="tokens", seq_len=args.seq + 1,
                                  global_batch=args.batch, device=dev))

        trainer = Trainer(
            cfg,
            feed,
            AdamWConfig(lr=warmup_cosine(args.lr, max(args.steps // 20, 1), args.steps)),
            ckpt_dir=args.ckpt,
            ckpt_every=args.ckpt_every,
            n_micro=args.micro,
            compress_grads=args.compress_grads,
            log_every=5,
            device=dev,
        )
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        print(f"arch={cfg.name} params={cfg.n_params() / 1e6:.1f}M device={name} resume_step={trainer.step}")
        trainer.run(args.steps)
        for m in trainer.metrics_log[-5:]:
            print(f"step {m['step']:6d} loss={m['loss']:.4f} lr={m['lr']:.2e} wall={m['wall_s']:.2f}s")
        return trainer
    finally:
        server.shutdown()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
