"""Training launcher of the port (``repro.launch.train``'s counterpart).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-minicpm \
        --steps 50 --batch 8 --seq 64 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
        --steps 8 --batch 8 --seq 512          # the card

It trains on ``repro``'s synthetic corpus (numpy, seed 0; ``--dedup`` masks
repeated spans first with the SA dedup pipeline in doubling mode) through
``run_training`` on one process: ``--device cuda`` (the default) on the
card, ``--device cpu`` on the CPU.  It prints ``repro.launch.train``'s
lines; the ``arch=...`` and ``dedup:`` lines are the same, the losses and
the monitor's times differ (the weights come from a ``torch.Generator``,
seed 0).  ``repro``'s ``--dry-run`` (and its ``--shape``, which only the
dry-run reads) is not ported.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.config import SAConfig, ShardingPolicy, TrainConfig, get_arch
from repro_torch.data.corpus import synth_token_corpus
from repro_torch.data.dedup import dedup_corpus
from repro_torch.data.loader import DeterministicLoader
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.sharding.rules import make_mesh
from repro_torch.train.loop import run_training
from repro_torch.train.step import make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd", "constant"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--corpus-tokens", type=int, default=200_000)
    ap.add_argument("--dedup", action="store_true",
                    help="run the SA dedup pipeline on the corpus first")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def train(arch: str, steps: int = 20, batch: int = 8, seq: int = 64, lr: float = 3e-4,
          schedule: str = "cosine", microbatches: int = 1, ckpt=None,
          resume: bool = False, corpus_tokens: int = 200_000, dedup: bool = False,
          device=None, log=print):
    """Train ``arch`` on ``device`` (the card by default) as the launcher
    does, printing its lines through ``log``.  Returns the ``LoopResult``
    and the model."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    model = Model(cfg)
    mesh = make_mesh((1, 1), ("data", "model"))  # one process: one device
    log(f"arch={cfg.name} params={model.num_params() / 1e6:.1f}M "
        f"devices={mesh.size}")

    vocab = min(cfg.vocab_size - 1, 255)
    tokens, _ = synth_token_corpus(corpus_tokens, vocab, seed=0,
                                   dup_fraction=0.02, dup_span=64)
    mask = None
    if dedup:
        tokens, keep, stats = dedup_corpus(
            tokens, min_len=48, cfg=SAConfig(vocab_size=vocab, packing="bits"),
            device=dev, mode="doubling",
        )
        mask = keep.astype(np.float32)
        log(f"dedup: masked {stats['masked_tokens']} tokens")
    loader = DeterministicLoader(tokens, batch=batch, seq_len=seq, seed=1, mask=mask)

    tcfg = TrainConfig(learning_rate=lr, schedule=schedule,
                       warmup_steps=max(steps // 10, 1),
                       decay_steps=steps, microbatches=microbatches)
    step, _, _ = make_train_step(
        model, mesh, ShardingPolicy(), tcfg, batch, seq,
        donate=False, with_mask=mask is not None,
    )
    res = run_training(model, step, loader, tcfg, steps=steps, ckpt_dir=ckpt,
                       resume=resume, device=dev)
    log(f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
        f"({res.final_step} steps, {res.retries} retries)")
    log(f"monitor: {res.monitor}")
    return res, model


def main(argv=None):
    a = parse_args(argv)
    train(a.arch, a.steps, a.batch, a.seq, a.lr, a.schedule, a.microbatches, a.ckpt,
          a.resume, a.corpus_tokens, a.dedup, device=a.device)


if __name__ == "__main__":
    main()
