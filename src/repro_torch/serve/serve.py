"""Batched serving loop: continuous-batching-lite over fixed slots.

Requests occupy batch slots; each engine tick runs either a prefill (for
newly admitted requests) or one decode step for all active slots. The
decode step is shape-stable (fixed batch, fixed max cache len).

The port of the JAX package's ``serve.serve``. It runs eagerly on the
model's device (there is no ``jit`` counterpart): the same wave admission,
left padding with token 0 and no padding mask, greedy ``argmax`` with the
first index on ties, and the shared access service drained once per wave.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 16
    out_tokens: Optional[list] = None


@dataclasses.dataclass
class ServeLoop:
    model: Any
    batch_slots: int = 4
    max_cache_len: int = 256
    # Optional shared bulk-access service (repro_torch.serve.AccessService).
    # When set, pending access-program submissions from other tenants are
    # drained once per admission wave — the serving host and the shared
    # DX100 frontend share one tick loop, as in the paper's deployment.
    access: Any = None

    def __post_init__(self):
        self._decode = self.model.decode_step
        self._prefill = self.model.prefill

    def run(self, requests: List[Request]) -> List[Request]:
        """Admit requests in waves of `batch_slots`; greedy-decode each.
        Needs ``loop.params`` (the model's parameters) set first."""
        params = getattr(self, "params", None)
        if params is None:
            raise ValueError("set loop.params first")
        dev = self.model.device
        done: List[Request] = []
        queue = list(requests)
        while queue:
            if self.access is not None and self.access.pending:
                # drain shared bulk-access work; inflight_ok — an earlier
                # auto-flushed window may still be in flight, and this
                # tick-loop drain is a deliberate resolve point
                self.access.flush(inflight_ok=True)
            wave = queue[:self.batch_slots]
            queue = queue[self.batch_slots:]
            # pad the wave to the slot count for shape stability
            while len(wave) < self.batch_slots:
                wave.append(Request(rid=-1, prompt=wave[0].prompt,
                                    max_new_tokens=wave[0].max_new_tokens))
            plen = max(len(r.prompt) for r in wave)
            toks = np.stack([np.pad(r.prompt, (plen - len(r.prompt), 0))
                             for r in wave]).astype(np.int32)
            cache = self.model.init_cache(self.batch_slots,
                                          self.max_cache_len)
            logits, cache = self._prefill(
                params, {"tokens": torch.as_tensor(toks, device=dev)}, cache)
            steps = max(r.max_new_tokens for r in wave)
            outs = [[] for _ in wave]
            for _ in range(steps):
                nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
                picked = nxt.tolist()          # one host read per step
                for i, r in enumerate(wave):
                    if r.rid >= 0 and len(outs[i]) < r.max_new_tokens:
                        outs[i].append(picked[i])
                logits, cache = self._decode(params,
                                             {"tokens": nxt[:, None]}, cache)
            for i, r in enumerate(wave):
                if r.rid >= 0:
                    r.out_tokens = outs[i]
                    done.append(r)
        return done
