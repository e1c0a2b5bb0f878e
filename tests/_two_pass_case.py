"""The stream and configuration shared by the distributed two-pass parity
tests and their subprocess runners (numpy only: every runner imports it),
and the two helpers that start the runners.

P shards of ``SHARD`` elements each, contiguous in one seeded Zipf stream
with small integer weights, so that every pass-II weight is an integer sum
that is exact in f32 in any order of addition.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

K, CHUNK, SALT = 64, 512, 0x5EED
LS = (2.0, 5.0, 64.0)
L_SINGLE = 5.0  # the single-l program's l: one of the grid's lanes
SHARD = 2048
MERGES = ("tree", "allgather")


def stream(P: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = P * SHARD
    keys = (rng.zipf(1.3, n) % 700).astype(np.int32)
    weights = rng.integers(1, 4, n).astype(np.float32)
    return keys, weights


def shard(a, rank: int):
    return a[rank * SHARD:(rank + 1) * SHARD]


def _run(script: str, *args, timeout=300) -> None:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / script), *map(str, args)],
                          capture_output=True, text=True, timeout=timeout, env=env,
                          cwd=ROOT)
    if proc.returncode != 0:
        raise AssertionError(f"{script} failed ({proc.returncode}):\n{proc.stderr[-3000:]}")


def run_reference_program(P: int, tmp_dir) -> dict:
    """The reference's program outputs on P fake devices (device 0's copy)."""
    out = Path(tmp_dir) / f"ref{P}.npz"
    _run("_distributed_ref_runner.py", P, out)
    return dict(np.load(out))


def run_port_program(P: int, tmp_dir) -> list:
    """Every rank's outputs of the port's programs over P gloo ranks."""
    out = Path(tmp_dir) / f"port{P}"
    out.mkdir()
    _run("_torch_distributed_runner.py", P, out)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(P)]
