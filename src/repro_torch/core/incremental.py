"""Incremental sampler state (port of ``repro/core/incremental.py``).

A single sketch (``init_state`` / ``update`` / ``finalize``,
``IncrementalSampler``) in fixed-k or fixed-tau mode is the L = 1 case of the
lane-stacked table: each chunk step is the one-shot samplers' own
(``vectorized.fixed_k_step``'s stages, ``fixed_tau_step``), with element ids
continuing from ``n_seen``, so a stream fed in pieces reproduces the
one-shot sample bit for bit.  A fixed-k continuous step launches one
``chunksort`` and one ``capscore_agg`` on a card.

A multi-lane sampler keeps one fixed-k continuous SH_l sketch per l of a
grid, stacked on a leading lane axis, plus each lane's lossless
bottom-(k+1) (key, seed) summary.  A batch advances every lane chunk by
chunk (the reference's ``lax.scan`` as a Python loop); each chunk is sorted
once (``chunk_order``), scored and reduced for all lanes in one fused op
(``capscore_agg``), merged into the sorted tables, evicted on the
``evict_every`` cadence, and folded into the key-sorted summaries.  On a
CUDA device the sort and the fused op are the hand-written kernels; nothing
in the loop synchronises with the device.  ``update_multi(...,
reference=True)`` is the oracle route: ``capscore_multi``, then the
re-sorting ``_ref`` steps of ``core.vectorized``.

The update functions never modify their input state, so a state stays
usable after it was passed in (the flush path relies on that).

A ``TenantBank`` stacks N such samplers ([T, L, ...] leaves).  Each tick
advances every tenant with a full chunk queued by one chunk: the tenants'
rows are gathered, run through the same stages as A x L rows -- one
``chunksort`` and one ``capscore_agg`` launch for all of them -- and
written back; the other tenants keep every bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import convert
from ..kernels.capscore.ops import capscore_agg, capscore_multi
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
    """Streaming state of a sampler: one sketch (L = 1) or a stacked multi-l
    grid.

    ``table`` leaves are [L, capacity]; ``l`` is the f32 [L] lane column on
    the device; ``n_seen`` (host int) is the stream position, which seeds
    element ids shared by all lanes; ``bk_keys``/``bk_seeds`` are the
    per-lane bottom-(k+1) summaries, seed-sorted (multi-l states only, else
    ``None``).
    """

    table: VZ.TableState
    n_seen: int
    l: torch.Tensor
    salt: int
    bk_keys: torch.Tensor | None = None
    bk_seeds: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        return self.table.keys.shape[-1]


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Static configuration of a sampler: ``k`` set is fixed-k mode, else
    fixed-tau (``kind`` continuous, discrete, distinct or sh).

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

    @property
    def mode(self) -> str:
        return "fixed_k" if self.k is not None else "fixed_tau"

    def eids(self, pos: int, device) -> torch.Tensor:
        """int32 element ids of one chunk starting at stream position
        ``pos`` (int32 wrap-around, as the reference's int32 positions)."""
        base = torch.arange(pos, pos + self.chunk, dtype=torch.int64,
                            device=device) & 0xFFFFFFFF
        return self._ids(base)

    def eids_rows(self, pos: torch.Tensor) -> torch.Tensor:
        """int32 element ids [A, chunk] of A chunks starting at the int64
        stream positions ``pos`` [A] (a bank's tenants, each its own
        stream): row a equals ``eids(pos[a])``."""
        base = (pos[:, None] + torch.arange(self.chunk, dtype=torch.int64,
                                            device=pos.device)) & 0xFFFFFFFF
        return self._ids(base)

    def _ids(self, base):
        if self.host_id is None:
            return VZ.to_int32(base)
        return VZ.shard_eids(self.host_id, base)


def init_state(l, *, k=None, tau=None, kind="continuous", chunk=2048,
               capacity=8192, salt=0, evict_every=1,
               device=None) -> tuple[SamplerState, SamplerSpec]:
    """A fresh single-sketch state and its spec.  Fixed-k (``k`` set, only
    ``kind="continuous"``): capacity ``k + evict_every * chunk``, so the
    merges of an eviction period never overflow.  Fixed-tau (``tau`` set):
    ``capacity`` slots, the overflow counted and raised at finalize."""
    if (k is None) == (tau is None):
        raise ValueError("exactly one of k= / tau= must be given")
    if evict_every < 1:
        raise ValueError(f"evict_every must be >= 1, got {evict_every}")
    device = resolve_device(device)
    if k is not None:
        if kind != "continuous":
            raise ValueError("one-pass fixed-k requires kind='continuous'")
        table = VZ.init_table(k + evict_every * chunk, device=device)
    else:
        if evict_every != 1:
            raise ValueError("evict_every applies to fixed-k samplers only")
        table = VZ.init_table(capacity, tau, device=device)
    state = SamplerState(table=table, n_seen=0,
                         l=torch.tensor([l], dtype=torch.float32, device=device),
                         salt=int(salt) & 0xFFFFFFFF)
    return state, SamplerSpec(kind=kind, k=k, chunk=chunk, evict_every=evict_every)


def _evict_due(spec: SamplerSpec, step: int) -> bool:
    """Whether the chunk step that brings the round counter to ``step``
    evicts: every step at E = 1, every E-th otherwise."""
    return spec.evict_every == 1 or step % spec.evict_every == 0


def _first_step(table, spec: SamplerSpec) -> int:
    """The round counter before a batch, read from the device only where
    the schedule needs it (E > 1); lanes advance in lockstep, so lane 0's
    counter schedules them all."""
    return int(table.step[0]) if spec.evict_every > 1 else 0


def update(state: SamplerState, keys, weights, spec: SamplerSpec) -> SamplerState:
    """Advance a single sketch over a chunk-aligned batch of int32 keys and
    f32 weights (tensors on the state's device), chunk by chunk: fixed-k
    through ``fixed_k_step``'s stages with eviction on the E cadence,
    fixed-tau through ``fixed_tau_step``."""
    chunk = spec.chunk
    n = keys.shape[0]
    if n % chunk:
        raise ValueError(f"update batch ({n}) must be a multiple of chunk ({chunk})")
    table, pos = state.table, state.n_seen
    step = _first_step(table, spec)
    for c in range(n // chunk):
        ck, cw = keys[c * chunk:(c + 1) * chunk], weights[c * chunk:(c + 1) * chunk]
        eids = spec.eids(pos, ck.device)
        order = chunk_order(ck, eids, cw)
        if spec.mode == "fixed_k":
            agg = VZ.aggregate_continuous(ck, cw, eids, table.tau, state.l,
                                          state.salt, order)
            table = VZ.fixed_k_merge(table, agg)
            step += 1
            if _evict_due(spec, step):
                table = VZ.evict_table(table, k=spec.k, l=state.l, salt=state.salt)
        else:
            table = VZ.fixed_tau_step(table, ck, cw, eids, state.l, state.salt,
                                      kind=spec.kind, order=order)
        pos += chunk
    return SamplerState(table, pos, state.l, state.salt)


def _final_evict(table, l, salt, spec: SamplerSpec):
    """Project a lazily evicted table (E > 1 holds up to ``k + E*chunk``
    keys between scheduled evictions) down to <= k for extraction: one
    eviction round at the current step, not persisted.  Deterministic in the
    state, and a no-op when the table holds <= k keys."""
    return VZ.evict_table(table, k=spec.k, l=l, salt=salt)


def finalize(state: SamplerState, spec: SamplerSpec) -> SampleResult:
    """The single sketch's SampleResult; the state stays usable.  Raises on
    a fixed-tau capacity overflow."""
    st = state.table
    overflow = int(st.overflow[0])
    if overflow > 0:
        raise RuntimeError(f"fixed-tau capacity overflow ({overflow}); raise capacity")
    if spec.mode == "fixed_k" and spec.evict_every > 1:
        st = _final_evict(st, state.l, state.salt, spec)
    return VZ.table_result(st, l=float(state.l[0]), kind=spec.kind, tau=float(st.tau[0]))


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


def update_multi(state: SamplerState, keys, weights, spec: SamplerSpec, *,
                 reference: bool = False) -> SamplerState:
    """Advance every l-lane sketch over a chunk-aligned batch of int32 keys
    and f32 weights (tensors on the state's device).  ``reference=True``
    takes the oracle route (``_update_multi_reference``): the same samples
    and summaries at evict_every=1, more slowly."""
    chunk = spec.chunk
    n = keys.shape[0]
    if n % chunk:
        raise ValueError(f"update batch ({n}) must be a multiple of chunk ({chunk})")
    if reference:
        return _update_multi_reference(state, keys, weights, spec)
    cap_bk = state.bk_keys.shape[-1]
    bkk, bks = VZ.summary_to_keysorted(state.bk_keys, state.bk_seeds)
    table, pos = state.table, state.n_seen
    step = _first_step(table, spec)
    for c in range(n // chunk):
        step += 1
        table, bkk, bks, pos = _multi_chunk_step(
            table, bkk, bks, pos, keys[c * chunk:(c + 1) * chunk],
            weights[c * chunk:(c + 1) * chunk], state.l, state.salt, spec,
            evict_now=_evict_due(spec, step))
    bk_keys, bk_seeds = VZ.summary_from_keysorted(bkk, bks, cap_bk)
    return SamplerState(table, pos, state.l, state.salt, bk_keys, bk_seeds)


def _update_multi_reference(state: SamplerState, keys, weights,
                            spec: SamplerSpec) -> SamplerState:
    """The multi-l chunk step through the oracles: one ``capscore_multi``
    launch scores every lane, then each lane re-sorts the chunk in its
    aggregate, re-sorts its whole table in the merge and full-sorts its
    eviction race (``fixed_k_step_scored_ref``), and the summaries advance
    through ``pass1_step_multi``, which sorts the chunk once more.  The
    bit-identity oracle of the fused route; evict_every=1 only."""
    if spec.evict_every != 1:
        raise ValueError("reference path supports evict_every=1 only")
    chunk = spec.chunk
    table, bk, pos = state.table, (state.bk_keys, state.bk_seeds), state.n_seen
    cap_bk = state.bk_keys.shape[-1]
    for c in range(keys.shape[0] // chunk):
        ck, cw = keys[c * chunk:(c + 1) * chunk], weights[c * chunk:(c + 1) * chunk]
        eids = spec.eids(pos, ck.device)
        score, delta, entry, kb = capscore_multi(ck, eids, cw, state.l, table.tau,
                                                 state.salt)
        table = VZ.fixed_k_step_scored_ref(table, ck, cw, score, delta, entry, kb,
                                           k=spec.k, l=state.l, salt=state.salt)
        bk = VZ.pass1_step_multi(bk, ck, score, cap=cap_bk)
        pos += chunk
    return SamplerState(table, pos, state.l, state.salt, *bk)


def finalize_multi(state: SamplerState, spec: SamplerSpec,
                   ls=None) -> dict[float, SampleResult]:
    """Per-lane SampleResults keyed by l (host-side extraction).  With
    ``evict_every > 1`` a non-persisted eviction round projects the lazily
    evicted table down to <= k first."""
    table = state.table
    if spec.evict_every > 1:
        table = _final_evict(table, state.l, state.salt, spec)
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


def _upload(device, keys, weights):
    """Host keys and weights of a chunk-aligned batch, on ``device``."""
    return torch.from_numpy(keys).to(device), torch.from_numpy(weights).to(device)


class IncrementalSampler:
    """Single-sketch streaming sampler with arbitrary batch sizes (fixed-k
    with ``k=``, fixed-tau with ``tau=``).

    Buffers the sub-chunk remainder on the host, advances the device state
    over chunk-aligned prefixes, and pads only at (non-destructive)
    finalize, exactly as the one-shot samplers pad the end of a stream: at
    evict_every=1 it finalizes bit for bit like ``sample_fixed_k`` /
    ``sample_fixed_tau`` on the concatenated stream.  ``device=None`` runs
    on the CUDA card (and raises without one).
    """

    def __init__(self, l, *, k=None, tau=None, kind="continuous", chunk=2048,
                 capacity=8192, salt=0, host_id=None, evict_every=1, device=None):
        self.device = resolve_device(device)
        self.state, self.spec = init_state(
            l, k=k, tau=tau, kind=kind, chunk=chunk, capacity=capacity, salt=salt,
            evict_every=evict_every, device=self.device)
        if host_id is not None:
            self.spec = dataclasses.replace(self.spec, host_id=host_id)
        self._rem = _RemainderBuffer(chunk)

    def observe(self, keys, weights=None) -> None:
        bk, bw = self._rem.add(normalize_keys(keys), weights)
        if bk is not None:
            self.state = update(self.state, *_upload(self.device, bk, bw), self.spec)

    def flushed_state(self) -> SamplerState:
        """State with the (padded) sub-chunk remainder folded in -- what
        finalize sees; the live state is left untouched."""
        fk, fw = self._rem.flush_padded()
        if fk is None:
            return self.state
        return update(self.state, *_upload(self.device, fk, fw), self.spec)

    def finalize(self) -> SampleResult:
        """Current sample over everything observed; ingestion may continue."""
        return finalize(self.flushed_state(), self.spec)

    @property
    def n_observed(self) -> int:
        return self.state.n_seen + len(self._rem.keys)


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

    def observe(self, keys, weights=None) -> None:
        keys = normalize_keys(keys)
        self._n_real += len(keys)
        bk, bw = self._rem.add(keys, weights)
        if bk is not None:
            self.state = update_multi(self.state, *_upload(self.device, bk, bw), self.spec)

    def flushed_state(self) -> SamplerState:
        """State with the (padded) sub-chunk remainder folded in — what
        finalize sees; the live state is left untouched."""
        fk, fw = self._rem.flush_padded()
        if fk is None:
            return self.state
        return update_multi(self.state, *_upload(self.device, fk, fw), self.spec)

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


# ---------------------------------------------------------------------------
# Stacked tenant banks: N resident multi-l samplers (tenant x l-grid) as one
# set of [T, L, ...] leaves, every active tenant advanced by one stacked step
# per ingest tick
# ---------------------------------------------------------------------------


def init_bank_state(ls, *, n_tenants, k, chunk=2048, salts=0, host_id=None,
                    evict_every=1, device=None) -> tuple[SamplerState, SamplerSpec]:
    """A bank of ``n_tenants`` independent multi-l samplers.

    Device leaves gain a leading tenant axis: table leaves [T, L, capacity],
    tau/step/overflow [T, L], summaries [T, L, k+1].  ``n_seen`` (each
    tenant's own stream position) and ``salt`` (``salts``: one int shared by
    all tenants or one per tenant) are host arrays [T], int64 and uint32.
    ``l`` stays [L]: the grid is shared bank-wide.
    """
    if n_tenants < 1:
        raise ValueError(f"n_tenants must be >= 1, got {n_tenants}")
    one, spec = init_multi_state(ls, k=k, chunk=chunk, host_id=host_id,
                                 evict_every=evict_every, device=device)
    T = int(n_tenants)
    stack = lambda x: x.expand((T,) + x.shape).clone()
    state = SamplerState(
        table=VZ.TableState(*(stack(x) for x in one.table)),
        n_seen=np.zeros(T, np.int64), l=one.l,
        salt=np.broadcast_to(np.asarray(salts, np.int64) & 0xFFFFFFFF,
                             (T,)).astype(np.uint32),
        bk_keys=stack(one.bk_keys), bk_seeds=stack(one.bk_seeds))
    return state, spec


_STAGED_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
                  np.dtype(np.float32): torch.float32}


def _stage(device, *arrays):
    """Host arrays (each a whole number of 32-bit words; 64-bit ones first)
    packed into one buffer and sent to ``device`` in ONE copy -- on a card a
    non-blocking copy from pinned memory, which never waits for the device.
    Returns the device views, with the arrays' dtypes and shapes."""
    words = [np.ascontiguousarray(a).reshape(-1).view(np.int32) for a in arrays]
    buf = torch.empty(sum(len(w) for w in words), dtype=torch.int32,
                      pin_memory=device.type == "cuda")
    host = buf.numpy()
    off = 0
    for w in words:
        host[off:off + len(w)] = w
        off += len(w)
    dev = buf.to(device, non_blocking=True)
    out, off = [], 0
    for a, w in zip(arrays, words):
        out.append(dev[off:off + len(w)].view(_STAGED_DTYPES[a.dtype]).view(a.shape))
        off += len(w)
    return out


def _bank_chunk_step(table, bkk, bks, pos, ck, cw, l, salts, spec: SamplerSpec,
                     n_evict: int):
    """One chunk for each of A tenants, their L lanes as A x L rows.

    ``table`` leaves are the tenants' rows [A*L, ...] (tenant-major),
    ``bkk``/``bks`` their key-sorted summary carries, ``pos`` [A] int64 their
    stream positions, ``ck``/``cw`` [A, chunk], ``salts`` [A] int32 bits.
    The first ``n_evict`` tenants are due for eviction.  The stages of
    ``_multi_chunk_step`` in the same order, each row through the same f32
    operations as its lane of a standalone sampler: ONE chunksort launch for
    the A chunks, ONE capscore_agg launch with each chunk's salt and taus.
    """
    A, C = ck.shape
    L = l.shape[0]
    R = A * L
    order = chunk_order(ck, spec.eids_rows(pos), cw)
    w_total, entered, contrib, kb_min, min_score = capscore_agg(
        order.ks, order.eids, order.ws, order.seg, l, table.tau.view(A, L), salts)
    per_row = lambda x: x[:, None].expand(A, L, C).reshape(R, C)
    agg = VZ.ChunkAgg(ukeys=per_row(order.ukeys), w_total=per_row(w_total),
                      entered=entered.view(R, C), contrib=contrib.view(R, C),
                      kb=kb_min.view(R, C), min_score=min_score.view(R, C))
    table = VZ.fixed_k_merge(table, agg)
    if n_evict:
        D = n_evict * L
        due = VZ.TableState(*(x[:D] for x in table))
        ev = VZ.evict_table(due, k=spec.k, l=l.repeat(n_evict),
                            salt=salts[:n_evict, None].expand(n_evict, L).reshape(D))
        if D == R:
            table = ev
        else:  # the merged rows are this step's own tensors
            for new, old in zip(ev[:5], table[:5]):
                old[:D].copy_(new)
    bkk, bks = VZ.pass1_fold_keysorted(bkk, bks, agg.ukeys, agg.min_score,
                                       bkk.shape[-1])
    return table, bkk, bks


def update_bank(state: SamplerState, keys, weights, tenants, spec: SamplerSpec,
                *, n_evict: int) -> SamplerState:
    """Advance tenants ``tenants`` (distinct ids, host [A]) by one chunk each:
    ``keys``/``weights`` host [A, chunk]; the first ``n_evict`` of them are
    due for eviction (the caller knows each tenant's round).  Keys, weights,
    tenant ids, positions and salts go up in one staged copy; the tenants'
    rows are gathered, stepped and written back into ``state``'s leaves, in
    place (the reference donates them).  Nothing here waits for the device.
    """
    tenants = np.asarray(tenants, np.int64)
    A, L = len(tenants), state.l.shape[0]
    R = A * L
    dev = state.l.device
    idx, pos, ck, salts, cw = _stage(
        dev, tenants, state.n_seen[tenants], np.asarray(keys, np.int32),
        state.salt[tenants].view(np.int32), np.asarray(weights, np.float32))
    rows = lambda x: x.index_select(0, idx).reshape((R,) + x.shape[2:])
    table = VZ.TableState(*(rows(x) for x in state.table))
    bkk, bks = VZ.summary_to_keysorted(rows(state.bk_keys), rows(state.bk_seeds))
    table, bkk, bks = _bank_chunk_step(table, bkk, bks, pos, ck, cw, state.l,
                                       salts, spec, n_evict)
    bk_keys, bk_seeds = VZ.summary_from_keysorted(bkk, bks, bkk.shape[-1])

    def put(leaf, new):
        return leaf.index_copy_(0, idx, new.reshape((A,) + leaf.shape[1:]))

    n_seen = state.n_seen.copy()
    n_seen[tenants] += spec.chunk
    return SamplerState(
        table=VZ.TableState(*(put(x, y) for x, y in zip(state.table, table))),
        n_seen=n_seen, l=state.l, salt=state.salt,
        bk_keys=put(state.bk_keys, bk_keys), bk_seeds=put(state.bk_seeds, bk_seeds))


def _final_evict_bank(table: VZ.TableState, l, salts, spec: SamplerSpec):
    """The non-persisted eviction round of ``finalize_multi`` for every row
    of a bank's [n, L, cap] table (``salts`` int32 bits [n] on its device)."""
    n, L = table.tau.shape
    flat = VZ.TableState(*(x.reshape((n * L,) + x.shape[2:]) for x in table))
    ev = VZ.evict_table(flat, k=spec.k, l=l.repeat(n),
                        salt=salts[:, None].expand(n, L).reshape(-1))
    return VZ.TableState(*(x.view((n, L) + x.shape[1:]) for x in ev))


class _PendingQueue:
    """Per-tenant ingest staging: a list of host arrays with O(1) appends;
    ``take``/``peek_all`` concatenate lazily.  It may hold many chunks: the
    bank drains one chunk per tick."""

    def __init__(self):
        self._keys: list[np.ndarray] = []
        self._weights: list[np.ndarray] = []
        self.size = 0

    def push(self, keys: np.ndarray, weights) -> None:
        """``keys`` must already be normalized (int32, validated)."""
        keys = np.asarray(keys, np.int32).reshape(-1)
        if weights is None:
            weights = np.ones(len(keys), np.float32)
        weights = np.asarray(weights, np.float32).reshape(-1)
        if len(weights) != len(keys):
            raise ValueError(
                f"weights length {len(weights)} != keys length {len(keys)}")
        if len(keys):
            self._keys.append(keys)
            self._weights.append(weights)
            self.size += len(keys)

    def _compact(self):
        if len(self._keys) > 1:
            self._keys = [np.concatenate(self._keys)]
            self._weights = [np.concatenate(self._weights)]

    def take(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Pop exactly the oldest ``n`` elements (requires size >= n)."""
        if n > self.size:
            raise ValueError(f"take({n}) from queue of {self.size}")
        self._compact()
        k, w = self._keys[0], self._weights[0]
        self._keys = [k[n:]] if len(k) > n else []
        self._weights = [w[n:]] if len(w) > n else []
        self.size -= n
        return k[:n], w[:n]

    def peek_all(self) -> tuple[np.ndarray, np.ndarray]:
        """Everything queued, without popping."""
        self._compact()
        if not self._keys:
            return np.zeros(0, np.int32), np.zeros(0, np.float32)
        return self._keys[0], self._weights[0]

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self._keys) + sum(a.nbytes for a in self._weights)


class TenantBank:
    """N resident multi-l samplers advanced as ONE stacked set of leaves.

    ``observe(tenant, ...)`` stages elements in per-tenant host queues; each
    ``tick()`` takes one chunk from EVERY tenant with a full chunk queued and
    advances all of their l-grids in one stacked step: one ``chunksort`` and
    one ``capscore_agg`` launch for all of them.  Sub-chunk remainders stay
    queued and are folded in, padded, only at finalize time (and saved as
    ``rem_*`` leaves by ``state_dict``).

    Contract: tenant t finalizes bit for bit (tables, taus, bottom-(k+1)
    summaries, query answers) like a standalone ``MultiSampler`` built with
    ``salt=salts[t]`` and fed the same chunks -- the bank changes the number
    of launches, not one bit of any tenant's sample.

    Checkpoints: ``state_dict`` is one flat dict of [T, ...]-stacked leaves,
    leaf for leaf the reference bank's; ``tenant_state_dict(t)`` is one
    tenant in the ``MultiSampler.state_dict`` format, and
    ``load_tenant_state_dict(t, d)`` splices one in (the handoff surface;
    ``checkpoint.manager.restore_slice`` restores one tenant from a bank
    checkpoint).  ``device=None`` runs on the CUDA card.
    """

    def __init__(self, ls, *, n_tenants, k, chunk=2048, salts=0, host_id=None,
                 evict_every=1, device=None):
        self.ls = tuple(float(l) for l in ls)
        self.n_tenants = int(n_tenants)
        self.device = resolve_device(device)
        self.state, self.spec = init_bank_state(
            ls, n_tenants=n_tenants, k=k, chunk=chunk, salts=salts,
            host_id=host_id, evict_every=evict_every, device=self.device)
        self._queues = [_PendingQueue() for _ in range(self.n_tenants)]
        self._n_real = np.zeros(self.n_tenants, np.int64)
        # each tenant's eviction round (table.step), kept on the host: the
        # bank knows who advanced in each tick, so it never reads it back
        self._rounds = np.zeros(self.n_tenants, np.int64)

    # -- ingestion ---------------------------------------------------------

    def observe(self, tenant: int, keys, weights=None) -> None:
        """Stage a batch of tenant ``tenant``'s stream (host arrays); the
        device state advances at the next ``tick``."""
        keys = normalize_keys(keys)
        self._queues[tenant].push(keys, weights)
        self._n_real[tenant] += len(keys)

    def backlog_chunks(self) -> np.ndarray:
        """Full chunks currently queued, per tenant."""
        return np.asarray([q.size // self.spec.chunk for q in self._queues], np.int64)

    def _due_first(self, tenants) -> tuple[np.ndarray, int]:
        """The order that puts the tenants whose next round evicts first,
        and how many those are."""
        E = self.spec.evict_every
        if E == 1:
            return np.arange(len(tenants)), len(tenants)
        due = (self._rounds[tenants] + 1) % E == 0
        return np.concatenate([np.nonzero(due)[0], np.nonzero(~due)[0]]), int(due.sum())

    def tick(self) -> int:
        """One stacked step: every tenant with >= 1 full chunk queued
        advances by exactly one chunk.  Returns the number of active tenants
        (0: nothing to do, nothing launched).  Never waits for the device."""
        chunk = self.spec.chunk
        active = np.asarray([t for t, q in enumerate(self._queues) if q.size >= chunk],
                            np.int64)
        if not len(active):
            return 0
        order, n_evict = self._due_first(active)
        tenants = active[order]
        K = np.empty((len(tenants), chunk), np.int32)
        W = np.empty((len(tenants), chunk), np.float32)
        for i, t in enumerate(tenants):
            K[i], W[i] = self._queues[t].take(chunk)
        self.state = update_bank(self.state, K, W, tenants, self.spec, n_evict=n_evict)
        self._rounds[tenants] += 1
        return len(tenants)

    def drain(self) -> int:
        """Tick until no tenant holds a full chunk; returns ticks issued."""
        ticks = 0
        while self.tick():
            ticks += 1
        return ticks

    # -- extraction --------------------------------------------------------

    def _subset(self, tenants) -> SamplerState:
        """A copy of the chosen tenants' state (leaves [n, ...], in the
        order given)."""
        st = self.state
        tenants = np.asarray(tenants, np.int64)
        (idx,) = _stage(self.device, tenants)
        return SamplerState(
            table=VZ.TableState(*(x.index_select(0, idx) for x in st.table)),
            n_seen=st.n_seen[tenants], l=st.l, salt=st.salt[tenants],
            bk_keys=st.bk_keys.index_select(0, idx),
            bk_seeds=st.bk_seeds.index_select(0, idx))

    def _flushed(self, tenants) -> SamplerState:
        """The chosen tenants' state with each queued remainder folded in
        (full chunks are drained for real first; each sub-chunk remainder is
        EMPTY/0 padded to one chunk, exactly the padding a standalone
        MultiSampler applies at finalize).  The live state and queues are
        left as they were."""
        self.drain()
        tenants = np.asarray(tenants, np.int64)
        sub = self._subset(tenants)
        rem = np.asarray([i for i, t in enumerate(tenants) if self._queues[t].size])
        if not len(rem):
            return sub
        chunk = self.spec.chunk
        K = np.full((len(rem), chunk), EMPTY, np.int32)
        W = np.zeros((len(rem), chunk), np.float32)
        for i, j in enumerate(rem):
            kk, ww = self._queues[tenants[j]].peek_all()
            K[i, :len(kk)], W[i, :len(ww)] = kk, ww
        order, n_evict = self._due_first(tenants[rem])
        # ``sub`` is this call's own copy: it is updated in place
        return update_bank(sub, K[order], W[order], rem[order], self.spec,
                           n_evict=n_evict)

    def flushed_state(self) -> SamplerState:
        """The whole bank with every queued element folded in (see
        ``_flushed``); the live state is untouched."""
        return self._flushed(range(self.n_tenants))

    def finalize_some(self, tenants) -> dict[int, dict[float, SampleResult]]:
        """The per-lane SampleResults of a SUBSET of tenants: only their rows
        are flushed and evicted, and they leave the device in ONE copy."""
        tenants = np.asarray(sorted({int(t) for t in tenants}), np.int64)
        st = self._flushed(tenants)
        table = st.table
        if self.spec.evict_every > 1:
            (salts,) = _stage(self.device, st.salt.view(np.int32))
            table = _final_evict_bank(table, st.l, salts, self.spec)
        n, L, cap = table.keys.shape
        host = torch.cat([table.keys.reshape(-1), table.counts.view(torch.int32).reshape(-1),
                          table.tau.view(torch.int32).reshape(-1)]).cpu().numpy()
        keys = host[: n * L * cap].reshape(n, L, cap)
        counts = host[n * L * cap: 2 * n * L * cap].view(np.float32).reshape(n, L, cap)
        taus = host[2 * n * L * cap:].view(np.float32).reshape(n, L)
        return {int(t): {l: VZ._to_result(keys[i, j], counts[i, j], l=l,
                                          kind=self.spec.kind, tau=float(taus[i, j]))
                         for j, l in enumerate(self.ls)}
                for i, t in enumerate(tenants)}

    def finalize_all(self) -> list[dict[float, SampleResult]]:
        """Every tenant's per-lane SampleResults, ``out[tenant][l]``."""
        some = self.finalize_some(range(self.n_tenants))
        return [some[t] for t in range(self.n_tenants)]

    def finalize(self, tenant: int) -> dict[float, SampleResult]:
        """One tenant's per-lane SampleResults."""
        return self.finalize_some([tenant])[tenant]

    def n_observed(self, tenant: int) -> int:
        return int(self._n_real[tenant])

    # -- serialization (O(T * k * |ls| + T * chunk)) -------------------------

    def state_dict(self) -> dict:
        """Flat dict of [T, ...]-stacked tensors on the bank's device, leaf
        for leaf the reference ``TenantBank.state_dict`` (the names and
        dtypes of ``MultiSampler.state_dict`` with a leading tenant axis,
        ``ls`` shared).  Queued full chunks are drained into the state
        first; the remainders travel as ``rem_*``."""
        self.drain()
        chunk = self.spec.chunk
        st, t = self.state, self.state.table
        host = {"n_seen": st.n_seen.astype(np.int32), "n_real": self._n_real.copy(),
                "salt": st.salt.copy(),
                "rem_keys": np.zeros((self.n_tenants, chunk), np.int32),
                "rem_weights": np.zeros((self.n_tenants, chunk), np.float32),
                "rem_len": np.zeros(self.n_tenants, np.int32)}
        for i, q in enumerate(self._queues):
            kk, ww = q.peek_all()
            host["rem_keys"][i, :len(kk)] = kk
            host["rem_weights"][i, :len(ww)] = ww
            host["rem_len"][i] = len(kk)
        d = {"keys": t.keys, "counts": t.counts, "kb": t.kb, "seed": t.seed,
             "tau": t.tau, "step": t.step, "overflow": t.overflow,
             "bk_keys": st.bk_keys, "bk_seeds": st.bk_seeds, "ls": st.l}
        d.update(convert.state_from_reference(host, device=self.device))
        return {name: d[name] for name in convert.SAMPLER_LEAVES}

    def tenant_state_dict(self, tenant: int) -> dict:
        """One tenant in the ``MultiSampler.state_dict`` format: it loads
        into a standalone ``MultiSampler`` / ``StreamStatsService`` (the
        leave handoff) bit for bit."""
        return {k: (v if k == "ls" else v[tenant]) for k, v in self.state_dict().items()}

    def load_tenant_state_dict(self, tenant: int, d: dict) -> None:
        """Splice a ``MultiSampler``-format blob (either package's) into one
        bank row (the join handoff), through a scratch sampler's loader
        (the same validation and layout canonicalization)."""
        probe = MultiSampler(self.ls, k=self.spec.k, chunk=self.spec.chunk,
                             evict_every=self.spec.evict_every, device=self.device)
        probe.load_state_dict(d)
        ps, st = probe.state, self.state
        for leaf, new in zip((*st.table, st.bk_keys, st.bk_seeds),
                             (*ps.table, ps.bk_keys, ps.bk_seeds)):
            leaf[tenant] = new
        st.n_seen[tenant] = ps.n_seen
        st.salt[tenant] = ps.salt
        self._rounds[tenant] = int(ps.table.step[0])
        self._queues[tenant] = _PendingQueue()
        self._queues[tenant].push(probe._rem.keys, probe._rem.weights)
        self._n_real[tenant] = int(d["n_real"]) if "n_real" in d else 0

    def load_state_dict(self, d: dict) -> None:
        """Restore from this package's or the reference's bank state dict."""
        d = convert.state_from_reference(d, device=self.device)
        T = self.n_tenants
        if d["keys"].shape[0] != T:
            raise ValueError(f"bank blob has {d['keys'].shape[0]} tenants, bank "
                             f"configured with {T}")
        if d["keys"].shape[-1] != self.state.capacity:
            raise ValueError(
                f"state blob table capacity {d['keys'].shape[-1]} != configured "
                f"capacity {self.state.capacity} (k + evict_every*chunk) -- "
                "restore with the same (k, chunk, evict_every) the blob was "
                "written with")
        # the same per-row layout canonicalization as MultiSampler (a no-op
        # on current-format blobs)
        o = torch.sort(d["keys"], dim=-1, stable=True).indices
        self.state = SamplerState(
            table=VZ.TableState(
                keys=d["keys"].gather(-1, o), counts=d["counts"].gather(-1, o),
                kb=d["kb"].gather(-1, o), seed=d["seed"].gather(-1, o),
                tau=d["tau"], step=d["step"], overflow=d["overflow"]),
            n_seen=d["n_seen"].cpu().numpy().astype(np.int64), l=d["ls"],
            salt=d["salt"].cpu().numpy().copy(),
            bk_keys=d["bk_keys"], bk_seeds=d["bk_seeds"])
        self._rounds = d["step"][:, 0].cpu().numpy().astype(np.int64)
        rem_keys, rem_weights, rem_len = (d[k].cpu().numpy() for k in
                                          ("rem_keys", "rem_weights", "rem_len"))
        self._queues = [_PendingQueue() for _ in range(T)]
        for t in range(T):
            self._queues[t].push(rem_keys[t, :rem_len[t]], rem_weights[t, :rem_len[t]])
        self._n_real = d["n_real"].cpu().numpy().astype(np.int64)

    @property
    def resident_bytes(self) -> int:
        """The bytes of the reference bank's state leaves (the device
        tables, summaries and lane grid plus the int32 positions and uint32
        salts, [T] each) and of the queued elements."""
        st = self.state
        dev = sum(x.nbytes for x in (*st.table, st.bk_keys, st.bk_seeds, st.l))
        return dev + 8 * self.n_tenants + sum(q.nbytes for q in self._queues)
