"""LM serving launcher of the port: prefill + batched greedy decode for any
``--arch`` (``repro.launch.lm_serve``'s counterpart).

    PYTHONPATH=src python -m repro_torch.launch.lm_serve --arch gemma3-1b \
        --batch 4 --prompt-len 1024 --gen 32 --max-seq 2048
    PYTHONPATH=src python -m repro_torch.launch.lm_serve --arch tiny-gemma3 \
        --device cpu

It prints ``repro.launch.lm_serve``'s lines: the ``arch=... params=...M``
line is the same; the walls differ, and so does ``sample:``, since the
weights come from a ``torch.Generator`` (seed 0) and not from jax's
stream.  The prompts are ``repro``'s (numpy, seed 0).  ``--device cuda``
(the default) serves on the card, ``--device cpu`` on the CPU; each wall
ends with the device synchronized.
"""
from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, batch: int, prompt_len: int, gen: int, max_seq: int,
          device=None, log=print):
    """Initialize ``arch`` on ``device`` (the card by default), prefill
    ``batch`` prompts of ``prompt_len`` tokens and decode ``gen`` tokens
    greedily, printing the launcher's lines through ``log``.  Returns the
    walls, the generated tokens (B, gen), the last logits, and the model,
    its parameters, the cache and the next positions (to step further)."""
    import numpy as np
    import torch

    from repro_torch.config import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models.model import Model

    dev = resolve_device(device)
    cfg = get_arch(arch)
    model = Model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), device=dev)
    log(f"arch={cfg.name} params={model.num_params() / 1e6:.1f}M")

    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, size=(batch, prompt_len)).astype(np.int32)
    toks = torch.as_tensor(toks, device=dev)

    t0 = time.perf_counter()
    logits, cache = model.prefill(params, tokens=toks, max_seq=max_seq)
    last = logits[:, -1]
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    log(f"prefill: {prefill_s:.2f}s ({batch}x{prompt_len} tokens)")
    del logits

    pos = torch.full((batch,), prompt_len, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    outs = []
    for _ in range(gen):
        nxt = torch.argmax(last, dim=-1).to(torch.int32)
        outs.append(nxt.cpu().numpy())
        logits_d, cache = model.decode_step(params, cache, nxt[:, None], pos)
        last = logits_d[:, 0]
        pos = pos + 1
    _sync(dev)
    decode_s = time.perf_counter() - t0
    log(f"decode: {gen} steps in {decode_s:.2f}s "
        f"({batch * gen / decode_s:.1f} tok/s batched)")
    sample = np.stack(outs, 1) if outs else np.zeros((batch, 0), np.int32)
    log(f"sample: {sample[0].tolist()}")
    return {"prefill_s": prefill_s, "decode_s": decode_s,
            "tok_s": batch * gen / decode_s, "sample": sample, "last": last,
            "model": model, "params": params, "cache": cache, "pos": pos}


def main(argv=None):
    args = parse_args(argv)
    serve(args.arch, args.batch, args.prompt_len, args.gen, args.max_seq,
          device=args.device)


if __name__ == "__main__":
    main()
