"""Batched serving demo of the PyTorch port: prefill + decode with the KV
cache, greedy sampling, mixed prompt lengths in one batch
(continuous-batching-style position tracking).

    PYTHONPATH=src python examples/torch_serve_lm.py              # the card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

The counterpart of ``examples/serve_lm.py``: the same model, prompts and
checks; the weights come from a ``torch.Generator``, so the generated
tokens differ.  It ends by checking that decoding reproduces the
teacher-forced forward for the first sequence.
"""
import argparse

import numpy as np
import torch

from repro_torch.config import get_arch
from repro_torch.device import resolve_device
from repro_torch.models.model import Model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = get_arch("tiny-gemma3")
    model = Model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), dtype=torch.float32,
                        device=dev)
    print(f"serving {cfg.name}: {model.num_params() / 1e3:.0f}K params")

    b, maxseq, gen = 3, 64, 12
    rng = np.random.default_rng(0)
    prompt_lens = np.array([5, 9, 3])
    prompts = [rng.integers(1, cfg.vocab_size, size=(int(n),)) for n in prompt_lens]

    # right-pad prompts into one batch, prefill once
    maxp = int(prompt_lens.max())
    toks = np.zeros((b, maxp), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    logits, cache = model.prefill(params, tokens=toks, max_seq=maxseq)

    # greedy decode loop, per-sequence positions (mixed lengths)
    pos = torch.as_tensor(prompt_lens.astype(np.int32), device=dev)
    last = logits[torch.arange(b, device=dev), pos - 1]  # each prompt's last token
    out_tokens = [[] for _ in range(b)]
    for _step in range(gen):
        nxt = torch.argmax(last, dim=-1).to(torch.int32)
        for i, t in enumerate(nxt.tolist()):
            out_tokens[i].append(t)
        logits_d, cache = model.decode_step(params, cache, nxt[:, None], pos)
        last = logits_d[:, 0]
        pos = pos + 1

    for i in range(b):
        print(f"seq{i}: prompt_len={int(prompt_lens[i])} generated={out_tokens[i]}")

    # sanity: decode path reproduces teacher-forced forward for seq 0
    full = np.concatenate([prompts[0], np.array(out_tokens[0])])[None, :]
    ref_argmax = model.forward(params, tokens=full.astype(np.int32))[0].argmax(-1).tolist()
    got = out_tokens[0]
    want = [ref_argmax[len(prompts[0]) - 1 + t] for t in range(gen)]
    assert got == want, (got, want)
    print("decode == teacher-forced forward:", got == want)


if __name__ == "__main__":
    main()
