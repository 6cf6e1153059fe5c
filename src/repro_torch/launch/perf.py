"""§Perf hillclimb driver (``repro.launch.perf``'s counterpart): named
(cell, change) experiments over the port's dry-run
(``repro_torch.launch.dryrun.run_cell_corrected``: counted on the ``meta``
device, H100 roofline), results appended to perf_experiments.json.

    PYTHONPATH=src python -m repro_torch.launch.perf --exp mixtral-train-base
    PYTHONPATH=src python -m repro_torch.launch.perf --all

The registry is ``repro``'s as it stands.
"""
import argparse
import dataclasses
import json
import os
import traceback

from repro_torch.config import ShardingPolicy

# ---------------------------------------------------------------------------
# experiment registry: name -> (arch, shape, cfg_override, policy_override)
# ---------------------------------------------------------------------------


def _cfg(**kw):
    def ov(c):
        return dataclasses.replace(c, **kw)

    return ov


_FSDP = ShardingPolicy()  # baseline: FSDP over data + TP over model
_REPL = ShardingPolicy(fsdp_axes=())  # params replicated over data
_EP = ShardingPolicy(moe_ep=True)

EXPERIMENTS = {
    # --- cell 1: hymba-1.5b train_4k (worst train-cell roofline) ----------
    "hymba-train-base": ("hymba-1.5b", "train_4k", None, None),
    "hymba-train-chunked-ce": ("hymba-1.5b", "train_4k", _cfg(loss_chunk=512), None),
    "hymba-train-flash": ("hymba-1.5b", "train_4k",
                          _cfg(loss_chunk=512, attn_chunk=512), None),
    "hymba-train-dots-remat": ("hymba-1.5b", "train_4k",
                               _cfg(loss_chunk=512, attn_chunk=512,
                                    remat="dots_saveable"), None),
    # chunked mamba: outer scan over 64-token chunks (memory-term fix) —
    # now the default mamba path; this row re-measures the full opt stack
    "hymba-train-chunked-mamba": ("hymba-1.5b", "train_4k",
                                  _cfg(loss_chunk=512, attn_chunk=512,
                                       remat="dots_saveable"), None),
    # --- cell 2: minicpm-2b prefill_32k (most collective-bound) -----------
    "minicpm-prefill-base": ("minicpm-2b", "prefill_32k", None, None),
    "minicpm-prefill-replicated": ("minicpm-2b", "prefill_32k", None, _REPL),
    "minicpm-prefill-flash": ("minicpm-2b", "prefill_32k",
                              _cfg(attn_chunk=1024), _REPL),
    # --- cell 3: mixtral-8x7b train_4k (the paper's index-routing cell) ---
    "mixtral-train-base": ("mixtral-8x7b", "train_4k", None, None),
    "mixtral-train-chunked-ce": ("mixtral-8x7b", "train_4k",
                                 _cfg(loss_chunk=512), None),
    "mixtral-train-flash": ("mixtral-8x7b", "train_4k",
                            _cfg(loss_chunk=512, attn_chunk=512), None),
    "mixtral-train-ep": ("mixtral-8x7b", "train_4k",
                         _cfg(loss_chunk=512, attn_chunk=512), _EP),
    "mixtral-train-dots-remat": ("mixtral-8x7b", "train_4k",
                                 _cfg(loss_chunk=512, attn_chunk=512,
                                      remat="dots_saveable"), None),
    # --- bonus: gemma3-27b decode_32k windowed caches ----------------------
    "gemma3-decode-base": ("gemma3-27b", "decode_32k", None, None),
    "gemma3-decode-window-cache": ("gemma3-27b", "decode_32k",
                                   _cfg(window_decode_cache=True,
                                        scan_layers=False), None),
    # --- bonus: gemma3-27b train chunked ----------------------------------
    "gemma3-train-base": ("gemma3-27b", "train_4k", None, None),
    "gemma3-prefill-flash": ("gemma3-27b", "prefill_32k",
                             _cfg(attn_chunk=1024), None),
    # 27B can't replicate params; TP-only embedding kills the logits
    # all-reduce while the rest of the net stays FSDP
    "gemma3-prefill-flash-tpembed": ("gemma3-27b", "prefill_32k",
                                     _cfg(attn_chunk=1024),
                                     ShardingPolicy(embed_fsdp=False)),
    "gemma3-train-opt-tpembed": ("gemma3-27b", "train_4k",
                                 _cfg(loss_chunk=512, attn_chunk=512),
                                 ShardingPolicy(embed_fsdp=False)),
    "mixtral-decode-window-cache": ("mixtral-8x7b", "decode_32k",
                                    _cfg(window_decode_cache=True,
                                         scan_layers=False), None),
    "gemma3-train-opt": ("gemma3-27b", "train_4k",
                         _cfg(loss_chunk=512, attn_chunk=512), None),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", action="append", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="perf_experiments.json")
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import run_cell_corrected

    names = args.exp or (list(EXPERIMENTS) if args.all else [])
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {r["exp"] for r in results}

    for name in names:
        if name in done:
            continue
        arch, shape, cfg_ov, pol_ov = EXPERIMENTS[name]
        try:
            r = run_cell_corrected(arch, shape, multi_pod=False,
                                   cfg_override=cfg_ov, policy_override=pol_ov)
        except Exception as e:
            r = {"status": "error", "error": f"{type(e).__name__}: {e}",
                 "trace": traceback.format_exc()[-1500:]}
        r["exp"] = name
        results.append(r)
        print(json.dumps({k: r.get(k) for k in
                          ("exp", "status", "bottleneck", "t_compute",
                           "t_memory", "t_collective", "roofline_fraction",
                           "error")}), flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
