"""A gloo rank of the compressed all-reduce test (a ``torch.multiprocessing``
spawn target; torch and numpy only, so the spawned ranks start quickly)."""
import os
import pickle

import numpy as np

N, RATIO = 96, 0.1


def rank_inputs(rank):
    """(x, error) of ``rank``: numpy float32, with a tie of magnitudes that
    straddles the top-k cut."""
    rng = np.random.default_rng(100 + rank)
    x = rng.normal(size=(N,)).astype(np.float32)
    x[[3, 40, 77]] = [2.5, -2.5, 2.5]
    err = (0.1 * rng.normal(size=(N,))).astype(np.float32)
    return x, err


def compress_rank(rank, d, out_dir):
    import torch
    import torch.distributed as dist

    from repro_torch.train import compression

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out_dir, 'rdzv')}",
                            rank=rank, world_size=d)
    try:
        x, err = (torch.from_numpy(a) for a in rank_inputs(rank))
        out = {"int8": compression.compressed_allreduce_int8(x).numpy()}
        red, new_err = compression.compressed_allreduce_topk(x, None, RATIO, err)
        out["topk"], out["topk_error"] = red.numpy(), new_err.numpy()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
