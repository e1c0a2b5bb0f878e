#!/usr/bin/env python3
"""Plant faults in the flash_attention kernel and read what chip_smoke's
checks of it see: do their limits separate a faulty kernel from a sound one?

    python3 flash_fault_check.py [--seed 0] [--variants sound,drop_tile,...]

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it is and
three mutants of it, each a copy with one planted fault, compiled into a
temporary directory (the checkout's sources are not touched):

* ``drop_tile``  — skips one kv tile (the middle one) of every block whose
  loop has at least 32 tiles: only the long rows (past 2048 at S = 4096,
  causal) lose 1/32..1/64 of their keys;
* ``shift_mask`` — the causal mask also hides the diagonal;
* ``zero_out``   — stores zeros.

For each variant it runs phase 2c's prefill-shape check
(``chip_smoke.check_flash_prefill``: f32 and bf16 at (4,32,4,4096,128)
against ``attention_ref``) and all of phase 7 (``chip_smoke.run_lm_serving``:
yi-6b at full width, bf16 and the f32 copy), and records their readings and
verdicts whether they pass or fail.  Needs one card; writes
``chiprun_out/flash_fault_check.json`` and prints one JSON object last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

DROP_AT = "  for (int j = 0; j < upper; ++j) {\n    const int k0 = j * BK;\n"
MUTANTS = {
    "drop_tile": (DROP_AT, DROP_AT.replace(
        "{\n", "{\n    if (upper >= 32 && j == upper / 2) continue;\n", 1)),
    "shift_mask": ("(causal && qpos < kpos)", "(causal && qpos <= kpos)"),
    "zero_out": ("from_f32<T>(acc[i][c] / l[i])", "from_f32<T>(0.0f)"),
}
LM_KEYS = ("prefill_logits_rel_l2", "prefill_k_cache_rel_l2", "prefill_v_cache_rel_l2",
           "decode_vs_full_prefill_rel_l2", "f32_prefill_logits_rel_l2",
           "f32_prefill_k_cache_rel_l2", "f32_prefill_v_cache_rel_l2")


def build_mutants(names, out_dir: Path) -> dict[str, Path]:
    """One nvcc per mutant, all at once; returns name -> shared library."""
    from repro_torch.kernels import _build

    source = (_build.CSRC / "flash_attention.cu").read_text()
    jobs = {}
    for name in names:
        old, new = MUTANTS[name]
        if source.count(old) != 1:
            raise RuntimeError(f"{name}: the text to mutate is not in the source once")
        cu = out_dir / f"{name}.cu"
        cu.write_text(source.replace(old, new))
        lib = out_dir / f"lib{name}.so"
        jobs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                                        str(cu)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        libs[name] = lib
    return libs


def use_library(path: Path) -> None:
    """Make ``flash_attention_cuda`` launch the kernel in ``path``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in ops._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    _build._LIBS["flash_attention"] = lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", default="sound," + ",".join(MUTANTS))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_fault_check: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(SRC), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cs.log(f"card {smi}")
    variants = args.variants.split(",")
    device = torch.device("cuda")
    cs.exact_f32()
    result = {"card": smi, "seed": args.seed, "variants": {}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _build.build_all(("flash_attention",))
        libs = {"sound": _build._target("flash_attention"),
                **build_mutants([v for v in variants if v != "sound"], Path(tmp))}
        cs.log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
        for name in variants:
            use_library(libs[name])
            row = {}
            gen = torch.Generator(device=device).manual_seed(args.seed)
            try:
                row["prefill_shape"], _ = cs.check_flash_prefill(gen)
                row["prefill_shape_passed"] = True
            except cs.CheckFailed as e:
                row["prefill_shape"], row["prefill_shape_passed"] = e.readings, False
            torch.cuda.empty_cache()
            try:
                lm, row["lm_failures"] = cs.run_lm_serving(args.seed, device), []
            except cs.CheckFailed as e:
                lm, row["lm_failures"] = e.readings, str(e).split("; ")
            row["lm"] = {k: lm.get(k) for k in LM_KEYS}
            row["lm_passed"] = not row["lm_failures"]
            torch.cuda.empty_cache()
            result["variants"][name] = row
            cs.log(f"{name}: {json.dumps(row)}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "flash_fault_check.json").write_text(json.dumps(result, indent=1))
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
