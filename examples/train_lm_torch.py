"""End-to-end training example of the PyTorch port: an LM trained from a
DACP data plane (the port's counterpart of ``examples/train_lm.py``).

The corpus lives at a faird "data center"; tokenization + packing run in
place as COOK map operators; fixed-size token blobs stream to the training
host; ``TorchFeed`` stages each batch in pinned memory and uploads it to the
card; the ``Trainer`` checkpoints and resumes.

    PYTHONPATH=src python examples/train_lm_torch.py                        # reduced, on the card
    PYTHONPATH=src python examples/train_lm_torch.py --full --steps 300     # ~100M params
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu           # plain versions on the CPU
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch.data  # noqa: F401,E402  registers tokenize_and_pack for this process's server
from repro_torch import device as device_mod  # noqa: E402
from repro_torch.client import LocalNetwork  # noqa: E402
from repro_torch.client.torch_adapter import TorchFeed  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.executor import ExecutorConfig  # noqa: E402
from repro_torch.data import training_dag, write_token_corpus  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.server import FairdServer  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--full", action="store_true", help="paper-lm-100m (~100M params)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    corpus = os.path.join(tempfile.mkdtemp(prefix="dacp_corpus_"), "docs.jsonl")
    write_token_corpus(corpus, docs=512)

    net = LocalNetwork()
    server = FairdServer("data:3101", executor=ExecutorConfig(device=str(dev)))
    server.catalog.register_path("corpus", os.path.dirname(corpus))
    net.register(server)
    client = net.client_for("data:3101")

    cfg = get_config("paper-lm-100m")
    if not args.full:
        cfg = cfg.reduced()
    print(f"model: {cfg.name} ({cfg.n_params()/1e6:.1f}M params, full={args.full}) on {dev}")

    dag = training_dag("dacp://data:3101/corpus/docs.jsonl", seq_len=args.seq, batch_rows=args.batch)

    def feed():
        return iter(TorchFeed(lambda: client.cook(dag), token_column="tokens", seq_len=args.seq + 1,
                              global_batch=args.batch, device=dev))

    try:
        trainer = Trainer(
            cfg,
            feed,
            AdamWConfig(lr=3e-3),
            ckpt_dir=args.ckpt or os.path.join(tempfile.mkdtemp(prefix="dacp_ckpt_")),
            ckpt_every=max(args.steps // 2, 10),
            compress_grads=args.compress_grads,
            log_every=5,
            device=dev,
        )
        print(f"starting at step {trainer.step}")
        trainer.run(args.steps)
        for m in trainer.metrics_log:
            print(f"  step {m['step']:5d} loss={m['loss']:.4f} gnorm={m['grad_norm']:.3f} {m['wall_s']:.1f}s")
        print("done; checkpoints in", trainer.ckpt.dir)
        return trainer
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
