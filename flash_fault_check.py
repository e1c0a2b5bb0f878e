#!/usr/bin/env python3
"""Plant faults in the flash_attention kernels and read what chip_smoke's
checks of them see: do their limits separate a faulty kernel from a sound one?

    python3 flash_fault_check.py [--seed 0] [--variants sound,drop_tile,...]

Builds the two attention kernels of the routes as they are (``src/
repro_torch/kernels/csrc/flash_attention_sm90.cu``, the bf16 tensor-core
kernel, and ``flash_attention_sm90_f32.cu``, the f32 3xTF32 tensor-core
kernel) and five mutants, each a copy with one planted fault, compiled into
a temporary directory (the checkout's sources are not touched):

* ``drop_tile``  — skips one kv tile (the middle one) of every block whose
  loop is long: at S = 4096, causal, the rows past 1920 lose 1/16..1/32 of
  their keys (bf16 kernel: tiles of 128, loops of at least 16 tiles) or
  1/64..1/128 (f32 kernel: tiles of 32, loops of at least 64);
* ``shift_mask`` — the causal mask also hides the diagonal;
* ``zero_out``   — stores zeros;
* ``drop_lo``    — the bf16 kernel skips the P_lo.V product, so P is
  rounded once to bf16 (the f32 kernel is left sound);
* ``tf32_only``  — the f32 kernel's split keeps no lo half (lo = 0), so
  every product is one TF32 product (the bf16 kernel is left sound).

The first three plant the fault in both kernels, so the bf16 and the f32
checks each see it.

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

TC, TF32 = "flash_attention_sm90", "flash_attention_sm90_f32"
SOFTMAX_TF32 = "      softmax_tile(s, m, l, alpha, j, S, causal, at);\n"
# mutant -> {library: (text of its source, the text that replaces it)}
MUTANTS = {
    "drop_tile": {
        TC: ("int k_end = S;", "int k_end = (n_tiles >= 16 && j == n_tiles / 2) ? 0 : S;"),
        TF32: (SOFTMAX_TF32, "      if (n_tiles >= 64 && j == n_tiles / 2) {\n"
                             "#pragma unroll\n"
                             "        for (int i = 0; i < BK / 2; ++i) s[i] = NEG_INF;\n"
                             "      }\n" + SOFTMAX_TF32)},
    "shift_mask": {TC: ("(causal && kpos > qpos)", "(causal && kpos >= qpos)"),
                   TF32: ("(causal && kpos > qpos)", "(causal && kpos >= qpos)")},
    "zero_out": {TC: ("__floats2bfloat162_rn(o0 / l[r], o1 / l[r])",
                      "__floats2bfloat162_rn(0.0f, 0.0f)"),
                 TF32: ("make_float2(acc[4 * c + 2 * r] / l[r], acc[4 * c + 2 * r + 1] / l[r])",
                        "make_float2(0.0f, 0.0f)")},
    "drop_lo": {TC: ("wgmma_rs<D>(acc, p_lo[kk], desc_mn_major<D>(v_tile, kk * 16));",
                     ";")},
    "tf32_only": {TF32: ("  lo = tf32_rna(x - __uint_as_float(hi));", "  lo = 0u;")},
}
LM_KEYS = ("prefill_logits_rel_l2", "prefill_k_cache_rel_l2", "prefill_v_cache_rel_l2",
           "decode_vs_full_prefill_rel_l2", "f32_prefill_logits_rel_l2",
           "f32_prefill_k_cache_rel_l2", "f32_prefill_v_cache_rel_l2")


def build_mutants(names, out_dir: Path) -> dict[str, dict[str, Path]]:
    """One nvcc per mutated source, all at once; returns name -> {library:
    shared library}, with the sound library where a mutant leaves one be."""
    from repro_torch.kernels import _build

    jobs, libs = {}, {}
    for name in names:
        libs[name] = {lib: _build._target(lib) for lib in (TC, TF32)}
        for lib, (old, new) in MUTANTS[name].items():
            source = (_build.CSRC / f"{lib}.cu").read_text()
            if source.count(old) != 1:
                raise RuntimeError(f"{name}: the text to mutate is not in {lib}.cu once")
            cu = out_dir / f"{name}-{lib}.cu"
            cu.write_text(source.replace(old, new))
            so = out_dir / f"lib{name}-{lib}.so"
            jobs[name, lib] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    for (name, lib), (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} {lib} failed:\n{log}")
        libs[name][lib] = so
    return libs


def use_libraries(paths: dict[str, Path]) -> None:
    """Make ``flash_attention_cuda`` launch the kernels in ``paths``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    for name, fn, _ in ops.KERNELS.values():
        lib = ctypes.CDLL(str(paths[name]))
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = ops.SIGNATURE
        _build._LIBS[name] = lib


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
        _build.build_all((TC, TF32))
        libs = {"sound": {lib: _build._target(lib) for lib in (TC, TF32)},
                **build_mutants([v for v in variants if v != "sound"], Path(tmp))}
        cs.log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
        for name in variants:
            use_libraries(libs[name])
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
