"""End-to-end driver of the PyTorch port: dedup the corpus with the paper's
pipeline, then train an LM on it — checkpointing, fault-retry and resume
included.

Defaults are CPU-friendly (~3M params, 60 steps).  ``--full`` trains a
~100M-parameter minicpm-family model.

    PYTHONPATH=src python examples/torch_train_lm.py              # the card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu
    PYTHONPATH=src python examples/torch_train_lm.py --ckpt DIR --steps 100 --resume

The counterpart of ``examples/train_lm.py``: the same model, corpus, dedup
and schedule; the weights come from a ``torch.Generator``, so the losses
differ.  Checkpoints go to ``--ckpt``, or to a temporary directory removed
at exit.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.config import (
    ArchConfig,
    AttentionConfig,
    SAConfig,
    ShardingPolicy,
    TrainConfig,
)
from repro_torch.data.corpus import synth_token_corpus
from repro_torch.data.dedup import dedup_corpus
from repro_torch.data.loader import DeterministicLoader
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.sharding.rules import make_mesh
from repro_torch.train.loop import run_training
from repro_torch.train.step import make_train_step


def small_cfg() -> ArchConfig:
    return ArchConfig(
        name="train-demo-3m", family="dense", num_layers=4, d_model=128,
        d_ff=384, vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=32),
        param_dtype="float32", compute_dtype="float32",
    )


def full_cfg() -> ArchConfig:
    """~100M params (minicpm-family shape)."""
    return ArchConfig(
        name="train-demo-100m", family="dense", num_layers=12, d_model=768,
        d_ff=2048, vocab_size=32_000,
        attention=AttentionConfig(num_heads=12, num_kv_heads=4, head_dim=64),
    )


def run(args, ckpt):
    dev = resolve_device(args.device)
    cfg = full_cfg() if args.full else small_cfg()
    model = Model(cfg)
    print(f"model: {cfg.name}  params={model.num_params() / 1e6:.1f}M")

    # --- data: synth + SA dedup (the paper's pipeline in the loop) ---------
    tokens, _planted = synth_token_corpus(
        50_000, min(cfg.vocab_size - 1, 255), seed=0,
        dup_fraction=0.05, dup_span=64,
    )
    tokens, keep, stats = dedup_corpus(
        tokens, min_len=48,
        cfg=SAConfig(vocab_size=int(tokens.max()), packing="bits"),
        device=dev, mode="doubling",
    )
    print(f"dedup: masked {stats['masked_tokens']} tokens "
          f"({100 * stats['masked_fraction']:.2f}%)")
    loader = DeterministicLoader(tokens, batch=args.batch, seq_len=args.seq,
                                 seed=1, mask=keep.astype(np.float32))

    mesh = make_mesh((1, 1), ("data", "model"))
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=10,
                       decay_steps=max(args.steps, 100), schedule="cosine")
    step, _, _ = make_train_step(
        model, mesh, ShardingPolicy(), tcfg, args.batch, args.seq,
        donate=False, with_mask=True,
    )
    res = run_training(
        model, step, loader, tcfg, steps=args.steps, ckpt_dir=ckpt,
        ckpt_every=25, resume=args.resume, device=dev,
    )
    print(f"steps: {res.final_step}  restored_from: {res.restored_from}")
    print(f"loss: {res.losses[0]:.3f} -> {res.losses[-1]:.3f}")
    print(f"monitor: {res.monitor}")
    assert res.losses[-1] < res.losses[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.ckpt is not None:
        run(args, args.ckpt)
    else:
        with tempfile.TemporaryDirectory() as ckpt:
            run(args, ckpt)


if __name__ == "__main__":
    main()
