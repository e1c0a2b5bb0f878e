"""Count how often the port's CPU ``attention_ref``, run right after a fresh
process's first JAX computation, lapses, and where a lapse starts.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_first_call_probe.py \\
        --mode bare|helper [--procs 6] [--seconds 600]

Runs fresh interpreters, ``--procs`` at a time, for ``--seconds``.  Each does
what a test worker's first flash-attention parity test does: the reference's
flash kernel in interpret mode on case (2, 4, 4, 128, 16), causal, f32 (the
process's first JAX computation), then the port's ``attention_ref`` on the
same inputs three times.  A lapse is a first torch result that differs from
the third; the two einsums of each call are recorded, to tell whether a
lapse starts in the scores, the softmax or the output.  ``--env`` sets
variables in the children (a library's switches).  ``bare`` imports JAX, torch and the two packages directly
(torch on all its intra-op threads); ``helper`` imports
``tests/_torch_ref.py`` first, as the port's parity tests do, which puts
torch on one thread; ``torch_only`` is ``bare`` without the JAX
computation.  Prints one JSON line: children run, lapses, the
largest lapse, the (batch, head) pairs each lapse touched, and for each
lapse how many of its elements equal JAX's output or lie nearer to it than
the third call does.  Beside them, what each child saw of the float modes:
the main thread's SSE control word (MXCSR, flags masked off) before and
after JAX's computation and at the end, the children in which any of
torch's intra-op threads flushed denormals or rounded other than to
nearest after the calls, torch's thread count and its f32 matmul precision.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHILD = """
import sys
sys.path[:0] = [{tests!r}, {src!r}]
if {helper!r}:
    import _torch_ref  # noqa: F401
import ctypes
import ctypes.util
import json
import jax.numpy as jnp
import numpy as np
import torch
from repro.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

libm = ctypes.CDLL(ctypes.util.find_library("m"))


def mxcsr():  # this thread's SSE control word, flags masked off
    env = (ctypes.c_uint8 * 32)()
    libm.fegetenv(env)
    return int.from_bytes(bytes(env[28:32]), "little") & 0xffc0


B, Hq, Hkv, S, D = case = (2, 4, 4, 128, 16)
rng = np.random.default_rng(sum(case))
arrays = [rng.normal(size=(B, H, S, D)).astype(np.float32) for H in (Hq, Hkv, Hkv)]
before = mxcsr()
ref = (np.asarray(flash_attention(*map(jnp.asarray, arrays), causal=True, interpret=True))
       if {jax!r} else np.zeros((B, Hq, S, D), np.float32))
after = mxcsr()
# attention_ref's einsums, exponentials and row sums, recorded (copies made
# after each op, so its arithmetic is unchanged)
seen = {{"einsum": [], "exp": [], "sum": []}}
real = {{"einsum": torch.einsum, "exp": torch.exp, "sum": torch.Tensor.sum}}


def recorder(name):
    def op(*args, **kwargs):
        out = real[name](*args, **kwargs)
        seen[name].append([t.clone() for t in (*args, out) if isinstance(t, torch.Tensor)])
        return out
    return op


torch.einsum, torch.exp, torch.Tensor.sum = (recorder(k) for k in ("einsum", "exp", "sum"))
outs = [attention_ref(*map(torch.from_numpy, arrays)).numpy() for _ in range(3)]
torch.einsum, torch.exp, torch.Tensor.sum = real["einsum"], real["exp"], real["sum"]
d = np.abs(outs[0] - outs[2])
off = d > 0
# where a lapse starts, first call against the third: the scores (first
# einsum), the exponentials, their row sums, the probabilities (the second
# einsum's operand) or the output given the same probabilities
first, third = (lambda k, i: seen[k][i]), (lambda k, i: seen[k][len(seen[k]) // 3 * 2 + i])
stages = {{"scores": int((first("einsum", 0)[2] != third("einsum", 0)[2]).sum()),
           "exponentials": int((first("exp", 0)[1] != third("exp", 0)[1]).sum()),
           "row_sums": int((first("sum", 0)[1] != third("sum", 0)[1]).sum()),
           "row_sums_max_rel": float(((first("sum", 0)[1] - third("sum", 0)[1]).abs()
                                      / third("sum", 0)[1]).max()),
           "probabilities": int((first("einsum", 1)[0] != third("einsum", 1)[0]).sum()),
           "output": int((first("einsum", 1)[2] != third("einsum", 1)[2]).sum())}}
# each intra-op thread's SSE mode, after the calls: 2^22 elements are split
# over all the threads; a thread with FTZ or DAZ turns a denormal to 0, one
# rounding toward zero or down leaves 1 + 1.5 * 2^-24 at 1, one rounding up
# takes 1 + 2^-25 to 1 + 2^-23
n = 1 << 22
modes = {{"denormal_zeroed": int(((torch.full((n,), 1e-40) * 1.0) == 0).sum()),
          "rounded_down": int(((torch.ones(n) + 1.5 * 2.0**-24) == 1).sum()),
          "rounded_up": int(((torch.ones(n) + 2.0**-25) != 1).sum())}}
print(json.dumps({{"max": float(d.max()),
                   "items": sorted({{tuple(i) for i in np.argwhere(off)[:, :2].tolist()}}),
                   "elements": int(off.sum()),
                   "lapse_equals_jax": int((outs[0][off] == ref[off]).sum()),
                   "lapse_nearer_jax": int((np.abs(outs[0] - ref)[off]
                                            < np.abs(outs[2] - ref)[off]).sum()),
                   "mxcsr": [before, after, mxcsr()], "thread_modes": modes,
                   "stages": stages,
                   "threads": torch.get_num_threads(),
                   "matmul_precision": torch.get_float32_matmul_precision()}}))
"""


def child(helper: bool, jax: bool, extra_env: dict) -> dict:
    code = CHILD.format(tests=str(ROOT / "tests"), src=str(ROOT / "src"), helper=helper,
                        jax=jax)
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra_env)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(out.stderr[-2000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("bare", "helper", "torch_only"), required=True)
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=600)
    ap.add_argument("--env", nargs="*", default=[], metavar="NAME=VALUE",
                    help="set in each child's environment")
    args = ap.parse_args()
    extra_env = dict(kv.split("=", 1) for kv in args.env)
    end = time.monotonic() + args.seconds

    def loop(_):
        results = []
        while time.monotonic() < end:
            results.append(child(args.mode == "helper", args.mode != "torch_only",
                                 extra_env))
        return results

    with ThreadPoolExecutor(args.procs) as pool:
        runs = [r for rs in pool.map(loop, range(args.procs)) for r in rs]
    lapses = [r for r in runs if r["max"] > 0]
    print(json.dumps({"mode": args.mode, "env": extra_env, "children": len(runs), "lapses": len(lapses),
                      "largest": max((r["max"] for r in lapses), default=0.0),
                      "items": [r["items"] for r in lapses],
                      "lapse_details": [{k: r[k] for k in ("elements", "lapse_equals_jax",
                                                           "lapse_nearer_jax", "stages")}
                                        for r in lapses],
                      "mxcsr_seen": sorted({tuple(r["mxcsr"]) for r in runs}),
                      "thread_modes_off": sum(any(r["thread_modes"].values()) for r in runs),
                      "threads_seen": sorted({r["threads"] for r in runs}),
                      "matmul_precision_seen": sorted({r["matmul_precision"] for r in runs})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
