#!/usr/bin/env python3
"""Build variants of the bf16 tensor-core attention kernel and time each at
the serving prefill's shape: what each design choice is worth on the card.

    python3 flash_variants.py [--seed 0] [--variants sound,drop_lo,...]

Each variant is a copy of ``src/repro_torch/kernels/csrc/
flash_attention_sm90.cu`` with a few text edits, compiled into a temporary
directory (the checkout's sources are not touched):

* ``sound``        — the kernel as it is;
* ``drop_lo``      — no P_lo.V product: what splitting P costs (it fails
  the bf16 gate; ``flash_fault_check.py`` holds it to that);
* ``stages2``      — a ring of 2 K/V slots in place of 3;
* ``bk64_stages4`` — kv tiles of 64 rows, 4 slots;
* ``trap_wait``    — mbarrier waits that trap after ~2^34 cycles, the
  timeout the kernel does without.

For each it reads ptxas's report of the D = 128 instantiation (spills and
the C75xx performance warnings), the highest register the D = 128 code
uses (``cuobjdump -sass``), the kernel's time per call at (4,32,4,4096,128)
bf16 causal on strided [B,S,H,D] views (CUDA events, the variants in turns,
twice), and the worst |got - want| / (atol + rtol |want|) against
``attention_ref`` at chip_smoke's bf16 prefill gate.  Needs one card;
writes ``chiprun_out/flash_variants.json`` and prints one JSON object last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SOURCE = "flash_attention_sm90"

SPIN = """  while (!mbar_try_wait(bar, parity)) {
  }"""
TRAP = """  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1LL << 34)) __trap();
  }"""
# variant -> [(text of the source, the text that replaces it)]
VARIANTS = {
    "sound": [],
    "drop_lo": [("wgmma_rs<D>(acc, p_lo[kk], desc_mn_major<D>(v_tile, kk * 16));", ";")],
    "stages2": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
    "bk64_stages4": [("constexpr int BK = 128;", "constexpr int BK = 64;"),
                     ("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    "trap_wait": [(SPIN, TRAP)],
}


def build(names, out_dir: Path) -> dict[str, dict]:
    """One nvcc per variant, all at once; returns name -> {lib, ptxas}."""
    from repro_torch.kernels import _build

    source = (_build.CSRC / f"{SOURCE}.cu").read_text()
    jobs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the text to replace is not in {SOURCE}.cu once")
            text = text.replace(old, new)
        cu, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(text)
        jobs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                                        str(cu)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        built[name] = {"lib": lib, **ptxas_d128(log), "max_register_d128": max_register(lib)}
    return built


def ptxas_d128(log: str) -> dict:
    """Spills and C75xx warnings that ptxas reports for the D = 128 kernel."""
    spill = re.search(r"Function properties for \S*flash_tc_kernelILi128\S*\s*\n"
                      r"\s*\d+ bytes stack frame, (\d+) bytes spill stores", log)
    warnings = sorted({m for m in re.findall(r"\((C75\d\d)\)[^']*'([^']*)'", log)
                       if "ILi128" in m[1]})
    return {"spill_store_bytes_d128": int(spill.group(1)) if spill else None,
            "ptxas_warnings_d128": [w[0] for w in warnings]}


def max_register(lib: Path) -> int | None:
    """The highest register index in the D = 128 kernel's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    for fn in re.split(r"\n\s*Function : ", sass):
        if "flash_tc_kernelILi128" in fn.splitlines()[0]:
            return max(int(r) for r in re.findall(r"\bR(\d+)\b", fn))
    return None


def use_library(path: Path) -> None:
    """Make ``flash_attention_cuda`` launch the bf16 kernel in ``path``."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    lib = ctypes.CDLL(str(path))
    fn = ops.KERNELS[torch.bfloat16][1]
    getattr(lib, fn).argtypes, getattr(lib, fn).restype = ops.SIGNATURE
    _build._LIBS[SOURCE] = lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(SRC), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cs.log(f"card {smi}")
    names = args.variants.split(",")
    cs.exact_f32()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    q, k, v = cs._flash_inputs(gen, cs.PREFILL_SHAPE, torch.bfloat16, True)
    want = ops.attention_ref(q, k, v, causal=True)
    atol, rtol = cs.PREFILL_TOL["bfloat16"]
    B, Hq, _, S, D = cs.PREFILL_SHAPE
    n_ops = 4 * B * Hq * D * S * (S + 1) / 2
    result = {"card": smi, "shape": cs.PREFILL_SHAPE, "variants": {}}
    with tempfile.TemporaryDirectory() as tmp:
        built = build(names, Path(tmp))
        for name in names:
            result["variants"][name] = {key: val for key, val in built[name].items()
                                        if key != "lib"}
            result["variants"][name]["ms"] = []
        for _ in range(2):
            for name in names:
                use_library(built[name]["lib"])
                row = result["variants"][name]
                got = ops.flash_attention_cuda(q, k, v, causal=True)
                torch.cuda.synchronize()
                row["worst_ratio"] = cs._closeness(got, want, atol, rtol)["worst_ratio"]
                del got
                row["ms"].append(cs.cuda_ms(lambda: ops.flash_attention_cuda(q, k, v, causal=True),
                                            iters=20, warmup=3))
                row["tflops"] = n_ops / min(row["ms"]) * 1e-9
        for name in names:
            cs.log(f"{name}: {json.dumps(result['variants'][name])}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "flash_variants.json").write_text(json.dumps(result, indent=1))
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
