"""Training launcher of the port (``repro.launch.train``'s counterpart).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-minicpm \
        --steps 50 --batch 8 --seq 64 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
        --steps 8 --batch 8 --seq 512          # the card
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.train --arch tiny-minicpm \
        --device cpu                            # 2 ranks
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
        --shape train_4k --dry-run              # counted on meta, no card

It trains on ``repro``'s synthetic corpus (numpy, seed 0; ``--dedup`` masks
repeated spans first with the SA dedup pipeline in doubling mode) through
``run_training``: ``--device cuda`` (the default) on the card, ``--device
cpu`` on the CPU.  Under ``torchrun`` it joins the process group the
environment describes (NCCL where every local rank has a card of its own,
gloo otherwise) and trains on the ``(D, 1)`` mesh of its D ranks, as
``repro``'s launcher trains on its devices: the state FSDP-sharded by the
spec trees, every rank given the global batch (``train.step``), rank 0
printing.  It prints ``repro.launch.train``'s lines; the ``arch=...`` and
``dedup:`` lines are the same, the losses and the monitor's times differ
(the weights come from a ``torch.Generator``, seed 0).  ``--dry-run``
counts the ``--shape`` cell of ``--arch`` on the single-pod mesh with
``launch.dryrun.run_cell`` (the ``meta`` device: no card, no allocation)
and prints ``repro``'s dict line.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.config import SAConfig, ShardingPolicy, TrainConfig, get_arch
from repro_torch.data.corpus import synth_token_corpus
from repro_torch.data.dedup import dedup_corpus
from repro_torch.data.loader import DeterministicLoader
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.sa_build import init_ranks
from repro_torch.models.model import Model
from repro_torch.sharding.placement import placement
from repro_torch.train.loop import run_training
from repro_torch.train.step import make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd", "constant"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--dry-run", action="store_true")
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
    does, printing its lines through ``log`` (on rank 0 of a process
    group).  Returns the ``LoopResult`` and the model."""
    ranks = init_ranks(torch.device(device or "cuda").type)
    dev = resolve_device(device)
    if ranks.rank != 0:
        log = _quiet  # one rank prints
    cfg = get_arch(arch)
    model = Model(cfg)
    mesh = make_local_mesh()  # (D, 1): one device a rank
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
    step, sspecs, _ = make_train_step(
        model, mesh, ShardingPolicy(), tcfg, batch, seq,
        donate=False, with_mask=mask is not None,
    )
    place = placement(sspecs, mesh, ranks) if mesh.size > 1 else None
    res = run_training(model, step, loader, tcfg, steps=steps, ckpt_dir=ckpt,
                       resume=resume, device=dev, state_shardings=place)
    log(f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
        f"({res.final_step} steps, {res.retries} retries)")
    log(f"monitor: {res.monitor}")
    return res, model


def _quiet(msg: str) -> None:
    del msg


def main(argv=None):
    a = parse_args(argv)
    if a.dry_run:
        from repro_torch.launch import dryrun

        r = dryrun.run_cell(a.arch, a.shape, multi_pod=False)
        print({k: r.get(k) for k in ("arch", "shape", "status", "bottleneck",
                                     "roofline_fraction")})
        return
    train(a.arch, a.steps, a.batch, a.seq, a.lr, a.schedule, a.microbatches, a.ckpt,
          a.resume, a.corpus_tokens, a.dedup, device=a.device)


if __name__ == "__main__":
    main()
