"""LM serving launcher: continuous-batched decode with prefill admission
(port of ``repro/launch/serve.py``).

Requests arrive with prompts, are admitted token by token into free KV-cache
slots, and all active slots decode together every step.  The batched
prefill path (``models.transformer.prefill``, through the attention kernel)
is not used by this loop, as in the reference.  ``main`` makes demo weights
from a seeded ``torch.Generator`` and prompts from a seeded numpy generator.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import registry
from ..core.incremental import resolve_device
from ..models import transformer as T


class DecodeServer:
    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 160, device=None):
        self.cfg, self.params = cfg, params
        self.device = resolve_device(device)
        self.slots, self.max_len = slots, max_len
        self.cache = T.init_cache(cfg, slots, max_len, torch.float32, device=self.device)
        self.pos = np.zeros(slots, np.int32)
        self.active = np.zeros(slots, bool)
        self.outputs: dict[int, list[int]] = {}
        self.slot_req: dict[int, int] = {}

    def _decode(self, token: np.ndarray, pos: np.ndarray):
        # the cache is written in place and returned
        token = torch.from_numpy(token.astype(np.int64)).to(self.device)
        pos = torch.from_numpy(pos.astype(np.int64)).to(self.device)
        logits, self.cache = T.decode_step(self.params, self.cfg, token, self.cache, pos)
        return logits

    def admit(self, req_id: int, prompt: np.ndarray) -> bool:
        free = np.nonzero(~self.active)[0]
        if len(free) == 0:
            return False
        slot = int(free[0])
        # prefill the prompt token by token into the slot (slot-local prefill;
        # the batched-prefill path is models.transformer.prefill)
        for t, tok in enumerate(prompt.tolist()):
            token = np.zeros(self.slots, np.int32)
            token[slot] = tok
            pos = np.where(self.active, self.pos, 0).astype(np.int32)
            pos[slot] = t
            # decode writes kv at pos for every slot; inactive slots write
            # into their own scratch position 0 and are ignored
            logits = self._decode(token, pos)
            self.pos[slot] = t + 1
        self.active[slot] = True
        self.outputs[req_id] = []
        self.slot_req[slot] = req_id
        self._last_logits = logits
        return True

    def step(self) -> list[int]:
        """One decode step for all active slots; returns finished req ids."""
        if not self.active.any():
            return []
        last = {s: (self.outputs[r][-1] if self.outputs[r] else 1)
                for s, r in self.slot_req.items() if self.active[s]}
        token = np.array([last.get(s, 0) for s in range(self.slots)], np.int32)
        logits = self._decode(token, self.pos)
        nxt = logits.argmax(dim=-1).cpu().numpy()
        done = []
        for s in range(self.slots):
            if not self.active[s]:
                continue
            r = self.slot_req[s]
            self.outputs[r].append(int(nxt[s]))
            self.pos[s] += 1
            if self.pos[s] >= self.max_len - 1:
                self.active[s] = False
                done.append(r)
        return done


def serve(server: DecodeServer, prompts, *, log=print) -> dict:
    """Admit ``prompts`` ([(req_id, tokens)]) as slots free up and decode
    until every request is done; returns counts and the wall time."""
    pending = list(prompts)
    t0 = time.time()
    finished, steps = 0, 0
    while finished < len(prompts):
        while pending and server.admit(pending[0][0], pending[0][1]):
            log(f"[serve] admitted request {pending[0][0]} "
                f"(prompt len {len(pending[0][1])})")
            pending.pop(0)
        done = server.step()
        steps += 1
        for r in done:
            finished += 1
            log(f"[serve] request {r} done: {len(server.outputs[r])} tokens")
        if steps > 10000:
            raise RuntimeError("server wedged")
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in server.outputs.values())
    return {"requests": len(prompts), "tokens": total_tokens, "steps": steps,
            "seconds": dt}


def demo_prompts(n: int, vocab: int, seed: int = 0):
    """The reference demo's traffic: prompts of 3-8 tokens over the vocab."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(1, vocab, size=rng.integers(3, 9))) for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card ('cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = dataclasses.replace(registry.get_config(args.arch, smoke=True), dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_params(gen, cfg)
    server = DecodeServer(cfg, params, slots=args.slots, max_len=args.max_new + 16,
                          device=device)
    out = serve(server, demo_prompts(args.requests, cfg.vocab))
    dt = out["seconds"]
    print(f"[serve] {out['requests']} requests, {out['tokens']} tokens in "
          f"{dt:.1f}s ({out['tokens'] / dt:.1f} tok/s, continuous batching over "
          f"{args.slots} slots)")


if __name__ == "__main__":
    main()
