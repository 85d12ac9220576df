"""LM serving engines on the stream: wave and continuous batching
(port of ``repro.serve.lm_engine``).

- :class:`LMEngine` — wave batching: up to ``n_slots`` equal-length
  prompts are prefilled as one batch, then decoded together.
- :class:`ContinuousLMEngine` — continuous (per-slot) batching over a
  paged KV cache: a request is admitted the moment a slot frees up, each
  slot decodes at its own position, finished slots are recycled at once.
  Greedy outputs are token-identical to the wave engine's.

The engines take the model (which holds its parameters) in place of the
JAX engines' ``(model, params)`` pair, and run where the model lives.
:func:`serve_stream` drains a request topic through either engine and
writes completions to a response topic. The record codecs are
byte-identical to the JAX package's, so both can share a topic.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis.witness import make_lock
from repro_torch.core.log import StreamLog
from repro_torch.models.model import StreamModel

__all__ = [
    "ContinuousLMEngine",
    "KVBlockTable",
    "LMEngine",
    "Request",
    "decode_completion",
    "decode_request",
    "encode_completion",
    "encode_request",
    "serve_stream",
    "tenant_key",
]


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new: int
    tenant: int = 0  # partitioning key on the request/response topics


# ------------------------------------------------------- topic record codec
# Request records: int32 header [req_id, tenant, max_new, plen] || prompt
# tokens. Completion records: int32 [req_id, tenant, n] || n generated
# tokens. Variable length — decoded per record, not via to_matrix.

def encode_request(req: Request) -> bytes:
    hdr = np.array([req.req_id, req.tenant, req.max_new, len(req.prompt)], np.int32)
    return hdr.tobytes() + np.asarray(req.prompt, np.int32).tobytes()


def decode_request(buf) -> Request:
    a = np.frombuffer(buf, np.int32)
    rid, tenant, max_new, plen = (int(x) for x in a[:4])
    return Request(rid, a[4 : 4 + plen].copy(), max_new, tenant=tenant)


def encode_completion(req_id: int, tenant: int, tokens: np.ndarray) -> bytes:
    hdr = np.array([req_id, tenant, len(tokens)], np.int32)
    return hdr.tobytes() + np.asarray(tokens, np.int32).tobytes()


def decode_completion(buf) -> tuple[int, int, np.ndarray]:
    a = np.frombuffer(buf, np.int32)
    return int(a[0]), int(a[1]), a[3 : 3 + int(a[2])].copy()


def tenant_key(tenant: int) -> bytes:
    """The record key a tenant's requests/completions partition by."""
    return np.int32(tenant).tobytes()


def _engine_device(model: StreamModel, device) -> torch.device:
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"engine device {dev} but the model lives on {model.device}")
    return dev


def _tokens(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)


# ------------------------------------------------------------- wave engine
class LMEngine:
    """Fixed-slot wave batching around prefill + decode_step.

    ``s_cache`` is the cache length a row gets; a local-attention layer's
    ring holds ``min(window, s_cache)`` of it, so an ``s_cache`` below the
    window narrows what that layer sees, as in the JAX engine: serve a
    windowed model with ``s_cache`` of at least prompt plus new tokens (or
    the window) to serve the function its forward computes.
    """

    def __init__(
        self,
        model: StreamModel,
        *,
        n_slots: int = 4,
        s_cache: int = 128,
        eos_id: int | None = None,
        device: str | torch.device | None = None,
    ):
        self.model = model
        self.device = _engine_device(model, device)
        self.n_slots = n_slots
        self.s_cache = s_cache
        self.eos_id = eos_id
        self.queue: deque[Request] = deque()
        self._lock = make_lock("engine", name="lm-wave")
        self.waves = 0
        self.lane_steps = 0
        self.useful_steps = 0
        self.first_token_s: dict[int, float] = {}  # req_id -> TTFT timestamp

    def submit(self, req: Request) -> None:
        with self._lock:
            self.queue.append(req)

    def qsize(self) -> int:
        with self._lock:
            return len(self.queue)

    def _next_wave(self) -> list[Request]:
        wave: list[Request] = []
        with self._lock:
            while self.queue and len(wave) < self.n_slots:
                nxt = self.queue[0]
                if wave and len(nxt.prompt) != len(wave[0].prompt):
                    break  # waves are equal-length: leave it for the next wave
                wave.append(self.queue.popleft())
        return wave

    def run_wave(self) -> list[tuple[int, np.ndarray]]:
        wave = self._next_wave()
        if not wave:
            return []
        self.waves += 1
        plen = len(wave[0].prompt)
        # pad the batch up to n_slots with a copy of row 0 (fixed shapes)
        rows = [r.prompt for r in wave] + [wave[0].prompt] * (self.n_slots - len(wave))
        logits, cache = self.model.prefill(
            _tokens(np.stack(rows), self.device), self.s_cache, cache_dtype=torch.float32
        )
        tok = torch.argmax(logits, -1)[:, None]
        t0 = tok[:, 0].cpu().numpy()
        now = time.perf_counter()
        for r in wave:
            self.first_token_s[r.req_id] = now
        max_new = max(r.max_new for r in wave)
        gen = np.full((self.n_slots, max_new), -1, np.int32)
        gen[:, 0] = t0
        alive = np.array([r.max_new > 1 for r in wave] + [False] * (self.n_slots - len(wave)))
        if self.eos_id is not None:
            alive &= gen[:, 0] != self.eos_id
        for step in range(1, max_new):
            if not alive.any():
                break
            lg, cache = self.model.decode_step(cache, tok)
            tok = torch.argmax(lg[:, 0], -1)[:, None]
            t = tok[:, 0].cpu().numpy()
            self.lane_steps += self.n_slots
            self.useful_steps += int(alive.sum())
            for i, r in enumerate(wave):
                if alive[i]:
                    gen[i, step] = t[i]
                    if (self.eos_id is not None and t[i] == self.eos_id) or step + 1 >= r.max_new:
                        alive[i] = False
        return [(r.req_id, gen[i, : r.max_new].copy()) for i, r in enumerate(wave)]

    def run_until_drained(self, max_waves: int = 10_000):
        out = []
        for _ in range(max_waves):
            if not self.qsize():
                break
            out.extend(self.run_wave())
        return out

    @property
    def lane_utilization(self) -> float:
        return self.useful_steps / max(self.lane_steps, 1)


# --------------------------------------------------------- paged KV blocks
class KVBlockTable:
    """Host-side free-list over the physical KV block pool.

    Block 0 is the reserved scratch target idle rows' (discarded) decode
    writes land in — it is never handed out, so a recycled slot's
    zeroed block table can never alias a live row's blocks.
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved scratch)")
        self.n_blocks = n_blocks
        self._free = list(range(n_blocks - 1, 0, -1))  # pop() yields 1, 2, ...

    def reserve(self, n: int) -> list[int] | None:
        """n physical block ids, or None if the pool can't cover them
        (all-or-nothing, so admission never deadlocks holding a rump)."""
        if len(self._free) < n:
            return None
        return [self._free.pop() for _ in range(n)]

    def release(self, ids: list[int]) -> None:
        self._free.extend(ids)

    @property
    def free_blocks(self) -> int:
        return len(self._free)


@dataclasses.dataclass
class _Slot:
    req: Request
    blocks: list[int]  # physical block ids owned by this row
    generated: list[int]


# -------------------------------------------------------- continuous engine
class ContinuousLMEngine:
    """Continuous (per-slot) batching over a paged KV cache.

    Each :meth:`step` first admits queued requests into free slots — a
    per-request prefill written into reserved blocks by ``paged_insert`` —
    then runs ONE ``decode_step`` across all slots with a per-row position
    vector. Slots that hit ``eos`` / ``max_new`` are recycled at once
    (blocks released, block table zeroed by ``paged_clear``).
    """

    def __init__(
        self,
        model: StreamModel,
        *,
        n_slots: int = 4,
        n_blocks: int = 64,
        block_size: int = 16,
        max_blocks: int = 16,
        eos_id: int | None = None,
        device: str | torch.device | None = None,
    ):
        self.model = model
        self.device = _engine_device(model, device)
        self.n_slots = n_slots
        self.block_size = block_size
        self.max_blocks = max_blocks
        self.eos_id = eos_id
        self.queue: deque[Request] = deque()
        self._lock = make_lock("engine", name="lm-continuous")
        self.blocks = KVBlockTable(n_blocks)
        # f32 cache, as the JAX engine builds it: exact greedy parity
        self.caches = model.init_paged_cache(
            n_slots, n_blocks, block_size, max_blocks, dtype=torch.float32
        )
        self.slots: list[_Slot | None] = [None] * n_slots
        self._tok = np.zeros((n_slots, 1), np.int32)  # each row's last token
        self.lane_steps = 0
        self.useful_steps = 0
        self.admissions = 0
        self.first_token_s: dict[int, float] = {}  # req_id -> TTFT timestamp

    def _blocks_needed(self, req: Request) -> int:
        # final decode step writes K/V at position plen + max_new - 2;
        # the cache must hold plen + max_new - 1 tokens
        return -(-(len(req.prompt) + max(req.max_new, 1) - 1) // self.block_size)

    def submit(self, req: Request) -> None:
        if self._blocks_needed(req) > self.max_blocks:
            raise ValueError(
                f"request {req.req_id}: {len(req.prompt)}+{req.max_new} tokens "
                f"exceeds max_blocks={self.max_blocks} * block={self.block_size}"
            )
        with self._lock:
            self.queue.append(req)

    def qsize(self) -> int:
        with self._lock:
            return len(self.queue)

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def _finish(self, row: int, out: list[tuple[int, np.ndarray]]) -> None:
        slot = self.slots[row]
        gen = np.asarray(slot.generated[: slot.req.max_new], np.int32)
        out.append((slot.req.req_id, gen))
        self.blocks.release(slot.blocks)
        # zero the row's position + block table so its idle writes land
        # in the scratch block — a stale table would corrupt whichever
        # row the freed blocks go to next
        self.model.paged_clear(self.caches, row)
        self.slots[row] = None

    def _admit(self, req: Request, row: int, blocks: list[int]) -> int:
        """Prefill one request into its reserved blocks; returns its first token."""
        plen = len(req.prompt)
        nb_prefill = -(-plen // self.block_size)
        bt_row = np.zeros(self.max_blocks, np.int32)
        bt_row[: len(blocks)] = blocks
        # pad the prefill cache to whole blocks so it splits into them
        logits, small = self.model.prefill(
            _tokens(req.prompt[None], self.device),
            nb_prefill * self.block_size,
            cache_dtype=torch.float32,
        )
        self.model.paged_insert(self.caches, small, row, blocks[:nb_prefill], bt_row, plen)
        return int(torch.argmax(logits[0]))

    def _admit_pending(self, out: list[tuple[int, np.ndarray]]) -> None:
        for row in range(self.n_slots):
            if self.slots[row] is not None:
                continue
            with self._lock:
                req = self.queue.popleft() if self.queue else None
            if req is None:
                return
            blocks = self.blocks.reserve(self._blocks_needed(req))
            if blocks is None:
                with self._lock:
                    self.queue.appendleft(req)  # pool exhausted: retry later
                return
            tok0 = self._admit(req, row, blocks)
            self.first_token_s[req.req_id] = time.perf_counter()
            self.admissions += 1
            self.slots[row] = _Slot(req, blocks, [tok0])
            self._tok[row, 0] = tok0
            if req.max_new <= 1 or (self.eos_id is not None and tok0 == self.eos_id):
                self._finish(row, out)

    def step(self) -> list[tuple[int, np.ndarray]]:
        """One engine tick: admit from the queue, then one decode step
        across every active slot. Returns completions finished this tick
        as ``(req_id, generated)`` pairs."""
        out: list[tuple[int, np.ndarray]] = []
        self._admit_pending(out)
        rows = [r for r in range(self.n_slots) if self.slots[r] is not None]
        if not rows:
            return out
        # each row decodes at its own position, which the paged cache carries
        lg, self.caches = self.model.decode_step(self.caches, _tokens(self._tok, self.device))
        t = torch.argmax(lg[:, 0], -1).cpu().numpy()
        self.lane_steps += self.n_slots
        self.useful_steps += len(rows)
        for r in rows:
            slot = self.slots[r]
            slot.generated.append(int(t[r]))
            self._tok[r, 0] = t[r]
            if (
                self.eos_id is not None and t[r] == self.eos_id
            ) or len(slot.generated) >= slot.req.max_new:
                self._finish(r, out)
        return out

    def run_until_drained(self, max_steps: int = 100_000):
        out: list[tuple[int, np.ndarray]] = []
        for _ in range(max_steps):
            if not self.qsize() and self.active == 0:
                break
            out.extend(self.step())
        return out

    @property
    def lane_utilization(self) -> float:
        return self.useful_steps / max(self.lane_steps, 1)


# ---------------------------------------------------------- topic serving
def serve_stream(
    engine: LMEngine | ContinuousLMEngine,
    log: StreamLog,
    input_topic: str,
    output_topic: str,
    prompt_len: int | None = None,
    *,
    max_new: int = 16,
) -> int:
    """Drain partition 0 of an input topic through the engine.

    With ``prompt_len`` the records are the JAX package's fixed-length
    prompts, int32[prompt_len], and each output record is ``req_id int32
    || generated int32[max_new]`` (padded with -1), request ids counting
    from 0 in topic order. With ``prompt_len=None`` the records are
    :func:`encode_request` records of any length, each with its own id,
    tenant and ``max_new``, and each output record is the
    :func:`encode_completion` of its request, keyed by tenant. Returns
    the number of completions written.
    """
    log.ensure_topic(output_topic)
    offset, rid = 0, 0
    tenants: dict[int, int] = {}
    end = log.end_offset(input_topic, 0)
    while offset < end:
        batch = log.read(input_topic, 0, offset, 64)
        if prompt_len is None:
            for buf in batch.values:
                req = decode_request(buf)
                tenants[req.req_id] = req.tenant
                engine.submit(req)
        else:
            mat = batch.to_matrix()
            toks = np.ascontiguousarray(mat).view(np.int32).reshape(len(batch), -1)
            for row in toks:
                engine.submit(Request(rid, row[:prompt_len], max_new))
                rid += 1
        offset = batch.next_offset
    served = 0
    for req_id, gen in engine.run_until_drained():
        if prompt_len is None:
            tenant = tenants.pop(req_id)
            log.produce(output_topic, encode_completion(req_id, tenant, gen), key=tenant_key(tenant))
        else:
            out = np.full(max_new + 1, -1, np.int32)
            out[0] = req_id
            out[1 : 1 + len(gen)] = gen[:max_new]
            log.produce(output_topic, out.tobytes())
        served += 1
    return served
