"""The warehouse feeds an LM train loop, in PyTorch.

Token batches come from snapshot-isolated SQL over an ACID corpus (the
warehouse is the data pipeline), and the training side (``make_train_step``
with AdamW, ``CheckpointManager`` with save-on-preemption) consumes them.
The same DDL, skewed unigram corpus and SQL as the JAX package's
``examples/train_lm.py``.  By the port's device rule the SQL's engine is
``cuda`` and the model lies on the card unless the caller passes
``engine="auto"`` or ``"ref"`` and ``device="cpu"``.

Run (reduced mamba2-130m, on the CPU):

    PYTHONPATH=src python -m repro_torch.train.lm_from_warehouse \\
        --engine ref --device cpu [--steps 200]
"""
from __future__ import annotations

import argparse
import signal
import tempfile
import time
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import get_config, reduced_config
from ..core.acid import AcidTable
from ..core.runtime.vector import VectorBatch
from ..core.session import Warehouse
from ..distributed.checkpoint import (CheckpointManager,
                                      install_preemption_handler)
from ..models import model as M
from .optimizer import adamw_init
from .steps import make_train_step


def build_corpus(wh: Warehouse, vocab: int, n_docs: int = 400,
                 doc_len: int = 256) -> None:
    """An ACID 'documents' table: id, split, packed token ids."""
    s = wh.session()
    s.execute("CREATE TABLE corpus (doc_id INT, split STRING, tok_off INT)")
    s.execute("CREATE TABLE tokens (doc_id INT, pos INT, tok INT)")
    rng = np.random.default_rng(0)
    hms = wh.hms
    tx = hms.open_txn()
    # skewed unigram distribution so there is something to learn
    probs = 1.0 / np.arange(1, vocab + 1)
    probs /= probs.sum()
    doc_ids = np.repeat(np.arange(n_docs), doc_len)
    AcidTable(hms.get_table("tokens"), hms).insert(tx, VectorBatch({
        "doc_id": doc_ids,
        "pos": np.tile(np.arange(doc_len), n_docs),
        "tok": rng.choice(vocab, size=n_docs * doc_len, p=probs),
    }))
    AcidTable(hms.get_table("corpus"), hms).insert(tx, VectorBatch({
        "doc_id": np.arange(n_docs),
        "split": np.where(np.arange(n_docs) % 10 == 0, "eval", "train"),
        "tok_off": np.arange(n_docs) * doc_len,
    }))
    hms.commit_txn(tx)


def split_tokens(wh: Warehouse, split: str, engine: str = "cuda"
                 ) -> np.ndarray:
    """A split's tokens in document order: one snapshot-isolated scan and
    join, so training data versions are transactional (a delete shows in
    the next epoch's snapshot)."""
    s = wh.session(result_cache=False, engine=engine)
    r = s.execute(
        "SELECT t.doc_id, t.pos, t.tok FROM tokens t, corpus c"
        f" WHERE t.doc_id = c.doc_id AND c.split = '{split}'"
        " ORDER BY t.doc_id, t.pos")
    return np.asarray(list(r.batch.cols.values())[2], dtype=np.int32)


def batches_from_warehouse(wh: Warehouse, split: str, batch: int, seq: int,
                           vocab: int, engine: str = "cuda", device=None
                           ) -> Iterator[dict]:
    """The data pipeline: one scan, then shuffle and pack into (batch, seq)
    int32 inputs and next-token labels on ``device`` (the card unless the
    caller passes one), epoch after epoch."""
    del vocab  # the tokens are the table's
    device = torch.device("cuda" if device is None else device)
    toks = split_tokens(wh, split, engine)
    rng = np.random.default_rng(1)
    n = (len(toks) - 1) // seq
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            idx = order[i:i + batch]
            x = np.stack([toks[j * seq:(j + 1) * seq] for j in idx])
            y = np.stack([toks[j * seq + 1:(j + 1) * seq + 1] for j in idx])
            yield {"inputs": torch.from_numpy(x).to(device),
                   "labels": torch.from_numpy(y).to(device)}


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Train reduced mamba2-130m on the corpus; returns the losses and
    raises if the mean of the last 20 is not 0.2 below the first 20's."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--engine", default="cuda",
                    help="SQL engine: cuda (default), ref or auto")
    ap.add_argument("--device", default="cuda",
                    help="the model's device: cuda (default) or cpu")
    ap.add_argument("--work-dir", default=None,
                    help="warehouse and checkpoints (default: a new "
                         "temporary directory)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    work = args.work_dir or tempfile.mkdtemp(prefix="train_lm_")

    cfg = reduced_config(get_config("mamba2-130m"))
    wh = Warehouse(f"{work}/warehouse")
    old_handler = signal.getsignal(signal.SIGTERM)
    try:
        print(f"building ACID corpus (vocab={cfg.vocab_size}) ...")
        build_corpus(wh, cfg.vocab_size)
        data = batches_from_warehouse(wh, "train", args.batch, args.seq,
                                      cfg.vocab_size, engine=args.engine,
                                      device=device)

        gen = torch.Generator(device=device).manual_seed(0)
        model = M.init_params(cfg, gen, device=device)
        opt = adamw_init(model)
        n_params = sum(p.numel() for p in model.parameters())
        print(f"model: {cfg.name} (reduced), {n_params / 1e6:.2f}M params, "
              f"on {device}; SQL engine {args.engine}")

        ckpt = CheckpointManager(f"{work}/checkpoints", keep=2)
        params = dict(model.named_parameters())
        install_preemption_handler(
            lambda: ckpt.save(-1, {"params": params, "opt": opt}))

        step_fn = make_train_step(cfg, lr=3e-3)
        losses = []
        t0 = time.perf_counter()
        for step in range(1, args.steps + 1):
            model, opt, metrics = step_fn(model, opt, next(data))
            losses.append(float(metrics["loss"]))
            if step % 25 == 0:
                print(f"step {step:4d} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({(time.perf_counter() - t0) / step * 1e3:.0f} "
                      f"ms/step)")
            if step % 100 == 0:
                ckpt.save(step, {"params": params, "opt": opt},
                          blocking=False)
        ckpt.wait()
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        wh.close()

    first, last = np.mean(losses[:20]), np.mean(losses[-20:])
    print(f"\nloss: {first:.4f} -> {last:.4f} "
          f"({'OK, learning' if last < first - 0.2 else 'NOT LEARNING?'})")
    _, step = ckpt.restore({"params": params, "opt": opt})
    print(f"checkpoint restore OK (step {step})")
    if not last < first - 0.2:
        raise RuntimeError("training failed to reduce loss")
    return losses


if __name__ == "__main__":
    main()
