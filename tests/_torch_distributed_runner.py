"""Subprocess body of the port's distributed parity tests: P gloo ranks on
the CPU, started with ``torch.multiprocessing.spawn``.

    python tests/_torch_distributed_runner.py P OUT_DIR

Rank r takes shard r of ``_two_pass_case.stream(P)`` and runs
``make_distributed_two_pass_multi`` and ``make_distributed_two_pass`` with
each merge; every rank writes what it got to ``OUT_DIR/rank{r}.npz``.  The
rendezvous is a file in OUT_DIR (no TCP port), and ``init_process_group``
gives up after 60 s, so a broken rank fails the run instead of hanging it.
Imports torch and the port only.
"""
import datetime
import sys
from pathlib import Path

import numpy as np
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _two_pass_case as case  # noqa: E402


def _rank(rank: int, P: int, out_dir: str) -> None:
    from repro_torch.core import distributed as DZ

    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous",
                            rank=rank, world_size=P,
                            timeout=datetime.timedelta(seconds=60))
    keys, weights = case.stream(P)
    sk, sw = case.shard(keys, rank), case.shard(weights, rank)
    res = {}
    for merge in case.MERGES:
        multi = DZ.make_distributed_two_pass_multi(
            ls=case.LS, salt=case.SALT, k=case.K, chunk=case.CHUNK, merge=merge,
            device="cpu")
        single = DZ.make_distributed_two_pass(
            kind="continuous", l=case.L_SINGLE, salt=case.SALT, k=case.K,
            chunk=case.CHUNK, merge=merge, device="cpu")
        for prog, out in (("multi", multi(sk, sw)), ("single", single(sk, sw))):
            for name, t in zip(("keys", "seeds", "weights"), out):
                res[f"{prog}_{merge}_{name}"] = t.numpy()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    P, out_dir = int(sys.argv[1]), sys.argv[2]
    mp.spawn(_rank, args=(P, out_dir), nprocs=P, join=True)
