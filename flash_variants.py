#!/usr/bin/env python3
"""Build variants of the two attention tensor-core kernels and time each at
the serving prefill's shape: what each design choice is worth on the card.

    python3 flash_variants.py [--seed 0] [--variants sound,drop_lo,...]

Each variant is a copy of ``src/repro_torch/kernels/csrc/
flash_attention_sm90.cu`` (bf16) or ``flash_attention_sm90_f32.cu`` (f32,
3xTF32) with a few text edits, compiled into a temporary directory (the
checkout's sources are not touched):

* ``sound``        — the bf16 kernel as it is;
* ``drop_lo``      — no P_lo.V product: what splitting P costs (it fails
  the bf16 gate; ``flash_fault_check.py`` holds it to that);
* ``stages2``      — a ring of 2 K/V slots in place of 3;
* ``bk64_stages4`` — kv tiles of 64 rows, 4 slots;
* ``trap_wait``    — mbarrier waits that trap after ~2^34 cycles, the
  timeout the kernel does without;
* ``f32_sound``    — the f32 kernel as it is;
* ``f32_one_term`` — one TF32 wgmma per product (Q_hi.K_hi, P_hi.V_hi):
  what the two lo terms cost, and whether the tensor cores bound the
  kernel (it fails the f32 gate);
* ``f32_exp2``     — the softmax's expf(x) as exp2f(x log2 e), as the bf16
  kernel takes it: what the accurate expf costs;
* ``f32_slots1``   — one K/V ring slot in place of 2: the converter's split
  of the next tile no longer overlaps the consumers;
* ``f32_no_split_v`` — the converter skips V's transpose and split (V^T is
  whatever the slot held: wrong output), what that work costs;
* ``f32_no_softmax`` — the scores go to P.V as they are (wrong output):
  what the softmax costs;
* ``f32_pingpong`` — the two consumers take turns on the tensor cores
  (named barriers, as FlashAttention-3 does), so one's softmax overlaps the
  other's products;
* ``f32_raw_slot`` — TMA lands K and V in one raw slot of their own, and the
  split writes K_hi beside K_lo in the 2 ring slots (the same 224 KB): the
  next tile's copy no longer waits for the consumers to free a ring slot;
* ``fma``          — the f32 FMA kernel the 3xTF32 kernel replaced, as it is.

For each it reads ptxas's report of the D = 128 instantiation (spills and
the C75xx performance warnings), the highest register the D = 128 code
uses (``cuobjdump -sass``), the kernel's time per call at (4,32,4,4096,128)
causal on strided [B,S,H,D] views in its dtype (CUDA events, the variants
in turns, twice), and the worst |got - want| / (atol + rtol |want|) against
``attention_ref`` at chip_smoke's prefill gate of that dtype.  Needs one
card; writes ``chiprun_out/flash_variants.json`` and prints one JSON object
last.
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
TC, TF32, FMA = "flash_attention_sm90", "flash_attention_sm90_f32", "flash_attention"
# library -> (the D = 128 kernel's mangled name, its dtype)
KERNEL = {TC: ("flash_tc_kernelILi128", "bfloat16"),
          TF32: ("flash_tf32_kernelILi128", "float32"),
          FMA: ("flash_kernelIfLi128", "float32")}

SPIN = """  while (!mbar_try_wait(bar, parity)) {
  }"""
TRAP = """  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1LL << 34)) __trap();
  }"""
# variant -> (library, [(text of the source, the text that replaces it)])
VARIANTS = {
    "sound": (TC, []),
    "drop_lo": (TC, [("wgmma_rs<D>(acc, p_lo[kk], desc_mn_major<D>(v_tile, kk * 16));", ";")]),
    "stages2": (TC, [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")]),
    "bk64_stages4": (TC, [("constexpr int BK = 128;", "constexpr int BK = 64;"),
                          ("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")]),
    "trap_wait": (TC, [(SPIN, TRAP)]),
    "f32_sound": (TF32, []),
    "f32_one_term": (TF32, [
        ("wgmma_ss_n32(s, desc_dims<D>(q_lo, BQ, kk), desc_dims<D>(k_hi(st), BK, kk), kk > 0);",
         "if (kk == 0) for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;"),
        ("wgmma_rs_n32(s, q_hi[kk], desc_dims<D>(k_lo(st), BK, kk));", ";"),
        ("wgmma_rs<D>(acc, p_lo[kk], desc_keys(vt_hi(st), kk));", ";"),
        ("wgmma_rs<D>(acc, p_hi[kk], desc_keys(vt_lo(st), kk));", ";")]),
    "f32_exp2": (TF32, [
        ("alpha[r] = expf(m[r] - m_new);",
         "alpha[r] = exp2f((m[r] - m_new) * 1.4426950408889634f);"),
        ("const float p = expf(s[i] - m[(i / 2) % 2]);",
         "const float p = exp2f((s[i] - m[(i / 2) % 2]) * 1.4426950408889634f);")]),
    "f32_slots1": (TF32, [("constexpr int SLOTS = 2;", "constexpr int SLOTS = 1;")]),
    "f32_no_split_v": (TF32, [("      split_v<D>(v_raw(st), vt_hi(st), vt_lo(st), t);\n",
                               "")]),
    "f32_no_softmax": (TF32, [("      softmax_tile(s, m, l, alpha, j, S, causal, at);\n",
                               "      alpha[0] = alpha[1] = 1.0f;\n")]),
    "f32_pingpong": (TF32, [
        ("    float acc[D / 2];\n",
         "    auto my_turn = [&]() { asm volatile(\"bar.sync %0, 256;\" ::\"r\"(3 + cw)); };\n"
         "    auto your_turn = [&]() {\n"
         "      asm volatile(\"bar.arrive %0, 256;\" ::\"r\"(4 - cw));\n"
         "    };\n"
         "    if (cw == 1) your_turn();\n"
         "    float acc[D / 2];\n"),
        ("      // S = Q_lo.K_hi + Q_hi.K_lo + Q_hi.K_hi, small terms first\n"
         "      wgmma_fence();",
         "      my_turn();\n      wgmma_fence();"),
        ("desc_dims<D>(k_hi(st), BK, kk));\n      wgmma_commit();",
         "desc_dims<D>(k_hi(st), BK, kk));\n      wgmma_commit();\n      your_turn();"),
        ("      fence_regs(acc);\n      wgmma_fence();",
         "      fence_regs(acc);\n      my_turn();\n      wgmma_fence();"),
        ("desc_keys(vt_hi(st), kk));\n      wgmma_commit();",
         "desc_keys(vt_hi(st), kk));\n      wgmma_commit();\n"
         "      if (cw == 0 || j + 1 < n_tiles) your_turn();")]),
    "f32_raw_slot": (TF32, [
        ("  static constexpr int SLOT_BYTES = 5 * KV_BYTES;\n"
         "  static constexpr int SMEM = Q_BYTES + SLOTS * SLOT_BYTES + 1024;",
         "  static constexpr int SLOT_BYTES = 4 * KV_BYTES;\n"
         "  static constexpr int SMEM =\n"
         "      Q_BYTES + 2 * KV_BYTES + SLOTS * SLOT_BYTES + 1024;"),
        ("  auto slot = [&](int st) { return q_tile + T::Q_BYTES + st * T::SLOT_BYTES; };",
         "  const uint32_t k_raw = q_tile + T::Q_BYTES, v_raw0 = k_raw + T::KV_BYTES;\n"
         "  auto slot = [&](int st) { return v_raw0 + T::KV_BYTES + st * T::SLOT_BYTES; };"),
        ("  auto v_raw = [&](int st) { return slot(st) + 4 * T::KV_BYTES; };",
         "  auto v_raw = [&](int) { return v_raw0; };"),
        ("  auto k_full = [&](int st) { return smem_u32(&bars[1 + st]); };\n"
         "  auto v_full = [&](int st) { return smem_u32(&bars[1 + SLOTS + st]); };",
         "  auto k_full = [&](int) { return smem_u32(&bars[1]); };\n"
         "  auto v_full = [&](int) { return smem_u32(&bars[1 + SLOTS]); };"),
        ("    for (int j = 0; j < n_tiles; ++j) {\n      const int st = j % SLOTS;\n"
         "      const uint32_t ph = (j / SLOTS) & 1;\n      if (t == 0) {",
         "    auto load_raw = [&](int j) {\n"
         "      mbar_expect_tx(k_full(0), T::KV_BYTES);\n"
         "      for (int c = 0; c < D / T::COLS; ++c)\n"
         "        tma_load(k_raw + c * BK * T::SWIZZLE, &tk, k_full(0), c * T::COLS, j * BK,\n"
         "                 hk, b);\n"
         "      mbar_expect_tx(v_full(0), T::KV_BYTES);\n"
         "      for (int c = 0; c < D / T::COLS; ++c)\n"
         "        tma_load(v_raw0 + c * BK * T::SWIZZLE, &tv, v_full(0), c * T::COLS, j * BK,\n"
         "                 hk, b);\n"
         "    };\n"
         "    if (t == 0) load_raw(0);\n"
         "    for (int j = 0; j < n_tiles; ++j) {\n      const int st = j % SLOTS;\n"
         "      const uint32_t ph = j & 1;\n"
         "      mbar_wait(empty(st), ((j / SLOTS) & 1) ^ 1);\n      if (false) {"),
        ("      split_k<D>(k_hi(st), k_lo(st), t);",
         "      {\n        for (int i = t; i < T::KV_BYTES / 16; i += 128) {\n"
         "          const float4 x = lds4(k_raw + 16 * i);\n          uint4 hi, lo;\n"
         "          split(x.x, hi.x, lo.x);\n          split(x.y, hi.y, lo.y);\n"
         "          split(x.z, hi.z, lo.z);\n          split(x.w, hi.w, lo.w);\n"
         "          sts4(k_hi(st) + 16 * i, hi);\n          sts4(k_lo(st) + 16 * i, lo);\n"
         "        }\n      }"),
        ("      if (lane == 0) mbar_arrive(split_done(st));\n    }",
         "      if (lane == 0) mbar_arrive(split_done(st));\n"
         "      named_sync(3, 128);\n"
         "      if (t == 0 && j + 1 < n_tiles) load_raw(j + 1);\n    }")]),
    "fma": (FMA, []),
}


def build(names, out_dir: Path) -> dict[str, dict]:
    """One nvcc per variant, all at once; returns name -> {lib, ptxas}."""
    from repro_torch.kernels import _build

    jobs = {}
    for name in names:
        lib, edits = VARIANTS[name]
        text = (_build.CSRC / f"{lib}.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the text to replace is not in {lib}.cu once")
            text = text.replace(old, new)
        cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(text)
        jobs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                                        str(cu)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), so)
    built = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        kernel = KERNEL[VARIANTS[name][0]][0]
        built[name] = {"lib": so, **ptxas_d128(log, kernel),
                       "max_register_d128": max_register(so, kernel)}
    return built


def ptxas_d128(log: str, kernel: str) -> dict:
    """Spills and C75xx warnings that ptxas reports for the D = 128 kernel."""
    spill = re.search(rf"Function properties for \S*{kernel}\S*\s*\n"
                      r"\s*\d+ bytes stack frame, (\d+) bytes spill stores", log)
    warnings = sorted({m for m in re.findall(r"\((C75\d\d)\)[^']*'([^']*)'", log)
                       if kernel in m[1]})
    return {"spill_store_bytes_d128": int(spill.group(1)) if spill else None,
            "ptxas_warnings_d128": [w[0] for w in warnings]}


def max_register(lib: Path, kernel: str) -> int | None:
    """The highest register index in the D = 128 kernel's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    for fn in re.split(r"\n\s*Function : ", sass):
        if kernel in fn.splitlines()[0]:
            return max(int(r) for r in re.findall(r"\bR(\d+)\b", fn))
    return None


def use_library(name: str, path: Path):
    """Make the op launch the kernel in ``path`` in place of the variant's
    library; returns the call that launches it on (q, k, v)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    lib_name = VARIANTS[name][0]
    fn = ops.FMA_KERNEL[1] if lib_name == FMA else next(
        f for n, f, _ in ops.KERNELS.values() if n == lib_name)
    lib = ctypes.CDLL(str(path))
    getattr(lib, fn).argtypes, getattr(lib, fn).restype = ops.SIGNATURE
    _build._LIBS[lib_name] = lib
    launch = ops.flash_attention_fma if lib_name == FMA else ops.flash_attention_cuda
    return lambda q, k, v: launch(q, k, v, causal=True)


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
    B, Hq, _, S, D = cs.PREFILL_SHAPE
    n_ops = 4 * B * Hq * D * S * (S + 1) / 2
    result = {"card": smi, "shape": cs.PREFILL_SHAPE, "variants": {}}
    with tempfile.TemporaryDirectory() as tmp:
        built = build(names, Path(tmp))
        for name in names:
            result["variants"][name] = {key: val for key, val in built[name].items()
                                        if key != "lib"}
            result["variants"][name]["ms"] = []
        for dtype in ("bfloat16", "float32"):
            mine = [n for n in names if KERNEL[VARIANTS[n][0]][1] == dtype]
            if not mine:
                continue
            gen = torch.Generator(device="cuda").manual_seed(args.seed)
            q, k, v = cs._flash_inputs(gen, cs.PREFILL_SHAPE, getattr(torch, dtype), True)
            want = ops.attention_ref(q, k, v, causal=True)
            atol, rtol = cs.PREFILL_TOL[dtype]
            for _ in range(2):
                for name in mine:
                    call = use_library(name, built[name]["lib"])
                    row = result["variants"][name]
                    got = call(q, k, v)
                    torch.cuda.synchronize()
                    row["worst_ratio"] = cs._closeness(got, want, atol, rtol)["worst_ratio"]
                    del got
                    row["ms"].append(cs.cuda_ms(lambda: call(q, k, v), iters=20, warmup=3))
                    row["tflops"] = n_ops / min(row["ms"]) * 1e-9
            del q, k, v, want
            torch.cuda.empty_cache()
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
