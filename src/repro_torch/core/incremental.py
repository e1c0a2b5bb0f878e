"""Incremental multi-lane sampler state (port of ``repro/core/incremental.py``).

One fixed-k continuous SH_l sketch per l of a grid, stacked on a leading
lane axis, plus each lane's lossless bottom-(k+1) (key, seed) summary.  A
batch advances every lane chunk by chunk (the reference's ``lax.scan`` as a
Python loop); each chunk is sorted once (``chunk_order``), scored and reduced
for all lanes in one fused op (``capscore_agg``), merged into the sorted
tables, evicted on the ``evict_every`` cadence, and folded into the
key-sorted summaries.  On a CUDA device the sort and the fused op are the
hand-written kernels; nothing in the loop synchronises with the device.

The update functions never modify their input state, so a state stays
usable after it was passed in (the flush path relies on that).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import convert
from ..kernels.capscore.ops import capscore_agg
from . import vectorized as VZ
from .samplers import SampleResult
from .segments import EMPTY, chunk_order, normalize_keys, searchsorted


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card.  Without one this raises: the port's
    entry points never carry on on the CPU unless the caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class SamplerState:
    """Streaming state of a stacked multi-l sampler.

    ``table`` leaves are [L, capacity]; ``l`` is the f32 [L] lane column on
    the device; ``n_seen`` (host int) is the stream position, which seeds
    element ids shared by all lanes; ``bk_keys``/``bk_seeds`` are the
    per-lane bottom-(k+1) summaries, seed-sorted.
    """

    table: VZ.TableState
    n_seen: int
    l: torch.Tensor
    salt: int
    bk_keys: torch.Tensor
    bk_seeds: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.table.keys.shape[-1]


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Static configuration of a multi-l sampler.

    ``host_id`` namespaces element randomness across hosts that ingest
    disjoint shards (ids become ``hash(SALT_SHARD, host_id, position)``);
    ``None`` keeps raw positions.  ``evict_every`` = E amortizes eviction:
    capacity ``k + E * chunk``, eviction every E-th chunk (E=1 evicts every
    chunk).
    """

    kind: str = "continuous"
    k: int | None = None
    chunk: int = 2048
    host_id: int | None = None
    evict_every: int = 1

    def eids(self, pos: int, device) -> torch.Tensor:
        """int32 element ids of one chunk starting at stream position
        ``pos`` (int32 wrap-around, as the reference's int32 positions)."""
        base = torch.arange(pos, pos + self.chunk, dtype=torch.int64,
                            device=device) & 0xFFFFFFFF
        if self.host_id is None:
            return VZ.to_int32(base)
        return VZ.shard_eids(self.host_id, base)


def init_multi_state(ls, *, k, chunk=2048, salt=0, host_id=None,
                     evict_every=1, device=None) -> tuple[SamplerState, SamplerSpec]:
    """One fixed-k continuous sketch per l, stacked, plus empty per-lane
    bottom-(k+1) summaries."""
    if evict_every < 1:
        raise ValueError(f"evict_every must be >= 1, got {evict_every}")
    device = resolve_device(device)
    ls = np.asarray(ls, np.float32)
    L = len(ls)
    capacity = k + evict_every * chunk
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    table = VZ.TableState(
        keys=torch.full((L, capacity), EMPTY, **i32),
        counts=torch.zeros((L, capacity), **f32),
        kb=torch.full((L, capacity), float("inf"), **f32),
        seed=torch.full((L, capacity), float("inf"), **f32),
        tau=torch.full((L,), float("inf"), **f32),
        step=torch.zeros((L,), **i32),
        overflow=torch.zeros((L,), **i32),
    )
    state = SamplerState(
        table=table, n_seen=0, l=torch.as_tensor(ls, device=device),
        salt=int(salt) & 0xFFFFFFFF,
        bk_keys=torch.full((L, k + 1), EMPTY, **i32),
        bk_seeds=torch.full((L, k + 1), float("inf"), **f32),
    )
    return state, SamplerSpec(kind="continuous", k=k, chunk=chunk,
                              host_id=host_id, evict_every=evict_every)


def _multi_chunk_step(table, bk_keys, bk_seeds, pos, ck, cw, l, salt,
                      spec: SamplerSpec, evict_now: bool):
    """One chunk through the fused multi-l step (summaries carried
    key-sorted):

    1. the ONE chunk sort, with the pre-gathered (eids, weights) view;
    2. ``capscore_agg`` scores every l lane on that view and reduces to the
       per-key columns [L, C] in the same pass;
    3. the per-lane sorted-runs table merges, and eviction when due;
    4. the aggregate's ``min_score`` column IS the pass-1 chunk summary, so
       the bottom-(k+1) summaries advance with no re-scoring.
    """
    cap_bk = bk_keys.shape[-1]
    eids = spec.eids(pos, ck.device)
    order = chunk_order(ck, eids, cw)
    w_total, entered, contrib, kb_min, min_score = capscore_agg(
        order.ks, order.eids, order.ws, order.seg, l, table.tau, salt)
    agg = VZ.ChunkAgg(ukeys=order.ukeys, w_total=w_total, entered=entered,
                      contrib=contrib, kb=kb_min, min_score=min_score)
    table = VZ.fixed_k_merge(table, agg)
    if evict_now:
        table = VZ.evict_table(table, k=spec.k, l=l, salt=salt)
    bk_keys, bk_seeds = VZ.pass1_fold_keysorted(bk_keys, bk_seeds, order.ukeys,
                                                min_score, cap_bk)
    return table, bk_keys, bk_seeds, pos + spec.chunk


def update_multi(state: SamplerState, keys, weights, spec: SamplerSpec) -> SamplerState:
    """Advance every l-lane sketch over a chunk-aligned batch of int32 keys
    and f32 weights (tensors on the state's device)."""
    chunk = spec.chunk
    n = keys.shape[0]
    if n % chunk:
        raise ValueError(f"update batch ({n}) must be a multiple of chunk ({chunk})")
    cap_bk = state.bk_keys.shape[-1]
    bkk, bks = VZ.summary_to_keysorted(state.bk_keys, state.bk_seeds)
    table, pos = state.table, state.n_seen
    E = spec.evict_every
    # lanes advance in lockstep, so lane 0's round counter schedules
    # eviction for all; read once per batch, and only when E > 1
    step = int(table.step[0]) if E > 1 else 0
    for c in range(n // chunk):
        step += 1
        table, bkk, bks, pos = _multi_chunk_step(
            table, bkk, bks, pos, keys[c * chunk:(c + 1) * chunk],
            weights[c * chunk:(c + 1) * chunk], state.l, state.salt, spec,
            evict_now=(E == 1 or step % E == 0))
    bk_keys, bk_seeds = VZ.summary_from_keysorted(bkk, bks, cap_bk)
    return SamplerState(table, pos, state.l, state.salt, bk_keys, bk_seeds)


def finalize_multi(state: SamplerState, spec: SamplerSpec,
                   ls=None) -> dict[float, SampleResult]:
    """Per-lane SampleResults keyed by l (host-side extraction).  With
    ``evict_every > 1`` a non-persisted eviction round projects the lazily
    evicted table down to <= k first."""
    table = state.table
    if spec.evict_every > 1:
        table = VZ.evict_table(table, k=spec.k, l=state.l, salt=state.salt)
    keys = table.keys.cpu().numpy()
    counts = table.counts.cpu().numpy()
    taus = table.tau.cpu().numpy()
    if ls is None:
        ls = state.l.cpu().numpy()
    return {float(l): VZ._to_result(keys[j], counts[j], l=float(l),
                                    kind=spec.kind, tau=float(taus[j]))
            for j, l in enumerate(ls)}


# ---------------------------------------------------------------------------
# Multi-lane pass II: exact-weight accumulation over stacked bottom-k keys
# ---------------------------------------------------------------------------


def init_pass2(lane_keys, *, device):
    """Device-resident pass-II accumulator over per-lane sorted sample keys.

    ``lane_keys``: one *sorted* int32 key array per lane (each <= k long, no
    EMPTY).  Returns (stacked_keys [L, cap] int32 EMPTY-padded, acc [L, cap]
    float64 zeros) on ``device``, ``cap`` the longest lane's length.  Run
    every shard of the stream through ``pass2_accumulate``; read
    ``acc[j, :len(lane_keys[j])]`` at the end.
    """
    L = len(lane_keys)
    cap = max(1, max((len(k) for k in lane_keys), default=1))
    keys = np.full((L, cap), EMPTY, np.int32)
    for j, kk in enumerate(lane_keys):
        keys[j, : len(kk)] = kk
    return (torch.from_numpy(keys).to(device),
            torch.zeros((L, cap), dtype=torch.float64, device=device))


def pass2_accumulate(skeys, acc, keys, weights=None):
    """Advance every lane's exact-weight accumulator by one stream batch
    (host arrays; keys validated by ``normalize_keys``), all lanes in one
    searchsorted + scatter-add.  ``acc`` is advanced in place and returned
    (the reference donates it).  f64 sums: on the CPU they add in element
    order like ``np.add.at``; on a card the scatter-add's atomics add in any
    order, which is exact for integer weights."""
    keys = normalize_keys(keys)
    n = len(keys)
    w = (np.ones(n, np.float64) if weights is None
         else np.asarray(weights, np.float64).reshape(-1))
    if len(w) != n:
        raise ValueError(f"weights length {len(w)} != keys length {n}")
    kd = torch.from_numpy(keys).to(skeys.device)
    wd = torch.from_numpy(w).to(skeys.device)
    loc = torch.clamp(searchsorted(skeys, kd), 0, skeys.shape[-1] - 1)
    match = skeys.gather(-1, loc) == kd
    return acc.scatter_add_(-1, loc, torch.where(match, wd, 0.0))


# ---------------------------------------------------------------------------
# Host-side wrapper: remainder buffering for unaligned batches
# ---------------------------------------------------------------------------


class _RemainderBuffer:
    """O(chunk) host staging area between arbitrary observe() batches and the
    chunk-aligned update."""

    def __init__(self, chunk: int):
        self.chunk = chunk
        self.keys = np.zeros(0, np.int32)
        self.weights = np.zeros(0, np.float32)

    def add(self, keys, weights):
        """Append normalized keys; return the chunk-aligned prefix ready for
        dispatch (or ``(None, None)``)."""
        keys = np.concatenate([self.keys, np.asarray(keys, np.int32).reshape(-1)])
        if weights is None:
            weights = np.ones(len(keys) - len(self.weights), np.float32)
        weights = np.concatenate(
            [self.weights, np.asarray(weights, np.float32).reshape(-1)])
        m = (len(keys) // self.chunk) * self.chunk
        self.keys, self.weights = keys[m:], weights[m:]
        return (keys[:m], weights[:m]) if m else (None, None)

    def flush_padded(self):
        """The trailing partial chunk, EMPTY/0-padded to one full chunk."""
        if not len(self.keys):
            return None, None
        pad = self.chunk - len(self.keys)
        keys = np.concatenate([self.keys, np.full(pad, EMPTY, np.int32)])
        weights = np.concatenate([self.weights, np.zeros(pad, np.float32)])
        return keys, weights

    def state_dict(self) -> dict:
        """Fixed-shape payload ([chunk] + a length scalar)."""
        pad = self.chunk - len(self.keys)
        return {
            "rem_keys": np.concatenate([self.keys, np.zeros(pad, np.int32)]),
            "rem_weights": np.concatenate([self.weights, np.zeros(pad, np.float32)]),
            "rem_len": np.int32(len(self.keys)),
        }

    def load_state_dict(self, d: dict) -> None:
        m = int(d["rem_len"])
        self.keys = np.asarray(d["rem_keys"], np.int32)[:m]
        self.weights = np.asarray(d["rem_weights"], np.float32)[:m]


class MultiSampler:
    """l-grid streaming sampler: all lanes advance per batch.

    Besides the fixed-k sketches, every lane carries the lossless
    bottom-(k+1) (key, seed) summary of the observed stream, which makes
    cross-host merges exact (see ``stats.service``); hosts that merge must
    have distinct ``host_id``s.  ``device=None`` runs on the CUDA card (and
    raises without one); pass ``device="cpu"`` for the plain PyTorch path.
    """

    def __init__(self, ls, *, k, chunk=2048, salt=0, host_id=None,
                 evict_every=1, device=None):
        self.ls = tuple(float(l) for l in ls)  # full-precision query keys
        self.device = resolve_device(device)
        self.state, self.spec = init_multi_state(
            ls, k=k, chunk=chunk, salt=salt, host_id=host_id,
            evict_every=evict_every, device=self.device)
        self._rem = _RemainderBuffer(chunk)
        self._n_real = 0  # real (non-padding) elements

    def _upload(self, keys, weights):
        return (torch.from_numpy(keys).to(self.device),
                torch.from_numpy(weights).to(self.device))

    def observe(self, keys, weights=None) -> None:
        keys = normalize_keys(keys)
        self._n_real += len(keys)
        bk, bw = self._rem.add(keys, weights)
        if bk is not None:
            self.state = update_multi(self.state, *self._upload(bk, bw), self.spec)

    def flushed_state(self) -> SamplerState:
        """State with the (padded) sub-chunk remainder folded in — what
        finalize sees; the live state is left untouched."""
        fk, fw = self._rem.flush_padded()
        if fk is None:
            return self.state
        return update_multi(self.state, *self._upload(fk, fw), self.spec)

    def absorb(self, other: "MultiSampler", *, k, merge_summaries: bool) -> None:
        """Fold another host's sampler into this one (both flushed first):
        the fixed-k tables through the 1-pass merge, and with
        ``merge_summaries`` the lossless bottom-(k+1) summaries too."""
        self.absorb_many([other], k=k, merge_summaries=merge_summaries)

    def absorb_many(self, others, *, k, merge_summaries: bool) -> None:
        """Fold any number of other hosts' samplers into this one at once,
        equal to calling ``absorb`` on each in turn (the fixed-k fold is a
        left fold).  Every remainder is flushed in its own host's element-id
        namespace, never re-scored under this host's ids."""
        from . import distributed as DZ  # deferred: distributed imports this module

        others = list(others)
        if not others:
            return
        states = [self.flushed_state()] + [o.flushed_state() for o in others]
        mine = states[0]
        table = DZ.merge_fixed_k_multi_states([s.table for s in states], mine.l,
                                              mine.salt, k=k)
        if merge_summaries:
            bk_keys, bk_seeds = DZ.merge_bottomk_multi_states(
                [(s.bk_keys, s.bk_seeds) for s in states],
                cap=mine.bk_keys.shape[-1])
        else:
            bk_keys, bk_seeds = mine.bk_keys, mine.bk_seeds
        self.state = SamplerState(
            table=table, n_seen=sum(s.n_seen for s in states), l=mine.l,
            salt=mine.salt, bk_keys=bk_keys, bk_seeds=bk_seeds)
        # the remainders are inside the merged state now
        self._n_real += sum(o._n_real for o in others)
        self._rem = _RemainderBuffer(self.spec.chunk)

    def finalize(self) -> dict[float, SampleResult]:
        return finalize_multi(self.flushed_state(), self.spec, ls=self.ls)

    def bottomk_summaries(self) -> tuple[np.ndarray, np.ndarray]:
        """Host copies of the flushed per-lane bottom-(k+1) summaries:
        ([L, k+1] keys, [L, k+1] seeds), seed-sorted."""
        st = self.flushed_state()
        return st.bk_keys.cpu().numpy(), st.bk_seeds.cpu().numpy()

    @property
    def n_observed(self) -> int:
        return self._n_real

    # -- serialization (O(k * |ls| + chunk), independent of stream length) --

    def state_dict(self) -> dict:
        """Tensors on the sampler's device, with the leaf names and dtypes of
        the reference ``MultiSampler.state_dict``."""
        st, t = self.state, self.state.table
        host = {
            "n_seen": np.int64(st.n_seen).astype(np.int32),
            "n_real": np.int64(self._n_real),
            "ls": st.l.cpu().numpy(),
            "salt": np.uint32(st.salt),
        }
        host.update(self._rem.state_dict())
        d = {"keys": t.keys, "counts": t.counts, "kb": t.kb, "seed": t.seed,
             "tau": t.tau, "step": t.step, "overflow": t.overflow,
             "bk_keys": st.bk_keys, "bk_seeds": st.bk_seeds}
        d.update(convert.state_from_reference(host, device=self.device))
        return {name: d[name] for name in convert.SAMPLER_LEAVES}

    def load_state_dict(self, d: dict) -> None:
        """Restore from this package's ``state_dict`` or from the reference
        package's (numpy arrays), through ``convert.state_from_reference``."""
        d = convert.state_from_reference(d, device=self.device)
        if d["keys"].shape[-1] != self.state.capacity:
            raise ValueError(
                f"state blob table capacity {d['keys'].shape[-1]} != configured "
                f"capacity {self.state.capacity} (k + evict_every*chunk) — "
                "restore with the same (k, chunk, evict_every) the blob was "
                "written with")
        # re-canonicalize the table layout (a stable per-lane key sort is a
        # no-op on current-format blobs)
        o = torch.sort(d["keys"], dim=-1, stable=True).indices
        table = VZ.TableState(
            keys=d["keys"].gather(-1, o), counts=d["counts"].gather(-1, o),
            kb=d["kb"].gather(-1, o), seed=d["seed"].gather(-1, o),
            tau=d["tau"], step=d["step"], overflow=d["overflow"])
        L, cap_bk = table.keys.shape[0], self.spec.k + 1
        bk_keys = d.get("bk_keys")
        bk_seeds = d.get("bk_seeds")
        if bk_keys is None:
            # blobs without summaries load with fresh (empty) ones
            bk_keys = torch.full((L, cap_bk), EMPTY, dtype=torch.int32,
                                 device=self.device)
            bk_seeds = torch.full((L, cap_bk), float("inf"),
                                  dtype=torch.float32, device=self.device)
        self.state = SamplerState(
            table=table, n_seen=int(d["n_seen"]), l=d["ls"],
            salt=int(d["salt"].cpu()), bk_keys=bk_keys, bk_seeds=bk_seeds)
        self._rem.load_state_dict({name: d[name].cpu().numpy() for name in
                                   ("rem_keys", "rem_weights", "rem_len")})
        self._n_real = (int(d["n_real"]) if "n_real" in d
                        else self.state.n_seen + len(self._rem.keys))
