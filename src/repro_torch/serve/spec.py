"""Speculative decoding: host-side acceptance rule + per-round length math
(the port's own copy of ``repro.serve.spec``; pure numpy).

The device side is two fixed-signature steps, each a captured CUDA graph
on the card (``train.servestep.make_spec_step``): ``propose_fn`` runs k
greedy draft steps per lane in one replay, ``verify_fn`` runs the target
once over (num_slots, k + 1) positions — the last committed token plus the
k proposals. Everything
else — which proposals survive, how far the per-slot KV lengths roll
back, when the draft lags its own cache — is plain Python here, shared
by the engine and unit-testable without a device.

**Acceptance rule (greedy).** Feed the target ``[c, p_1 .. p_k]`` where
``c`` is the lane's last committed token (its KV was not yet written —
the engine's standing invariant). The verify logits at position ``i``
are conditioned on ``c, p_1 .. p_i``, so ``g_i = argmax(logits[i])`` is
exactly the token non-speculative greedy decode would emit after those
tokens. Walk ``i = 0..k``: commit ``g_i``; stop after the first ``i``
with ``p_{i+1} != g_i`` (or after ``g_k``). Every committed token equals
the target's own greedy choice at its position, which is why speculative
output is token-for-token identical to baseline decode — the draft only
decides *how many* positions each round commits (1 best-case-free bonus
token up to k + 1).

**Rollback math.** The verify pass wrote k + 1 keys past the lane's old
length L (= committed tokens minus the one still-unfed sample). With j
accepted proposals the new committed length is ``old + j + 1`` and the
correct KV coverage is everything but the new last token:
``target length = L + j + 1`` → rewind ``k - j`` of the k + 1 written.
Blocks were allocated at budget during admission, so rewinding is a pure
length decrement — the allocator is never involved, and the stale tail
keys are overwritten when the next round re-feeds those positions.

**Draft lag.** The draft ingests ``[c, p_1 .. p_{k-1}]`` while proposing
(it proposes ``p_k`` without feeding it back). After a partial accept
its KV prefix is correct through the new committed length minus one — in
sync. After a full accept it is one token short (``p_k`` un-ingested):
the lane carries ``lag = 1`` and the next ``propose_fn`` call's masked
catch-up decode feeds that token (``tokens[-2]`` of the committed
stream) before proposing again.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np


def accept_prefix(
    proposed: Sequence[int], greedy: Sequence[int],
) -> tuple[list[int], int]:
    """Apply the greedy acceptance rule to one lane's verify round.

    ``proposed`` — the draft's k tokens; ``greedy`` — the target's argmax
    at each of the k + 1 verified positions. Returns ``(committed,
    n_accepted)``: the tokens to append (accepted proposals plus the one
    bonus token — the target's own pick at the first divergence) and how
    many proposals survived. ``len(committed) == n_accepted + 1`` always:
    worst case one token (the plain decode step's output), best case
    k + 1.
    """
    k = len(proposed)
    if len(greedy) != k + 1:
        raise ValueError(
            f"need k+1 greedy tokens for k={k} proposals, got {len(greedy)}")
    committed: list[int] = []
    n_accepted = 0
    for i, g in enumerate(greedy):
        committed.append(int(g))
        if i < k and int(proposed[i]) == int(g):
            n_accepted += 1
        else:
            break
    return committed, n_accepted


def verify_rewind(spec_k: int, n_accepted: int) -> int:
    """How many of the verify pass's k + 1 written positions to roll back.

    The committed length grows by ``n_accepted + 1`` and KV must cover
    all committed tokens except the newest: keep ``n_accepted + 1`` of
    the writes, rewind the rest."""
    if not 0 <= n_accepted <= spec_k:
        raise ValueError(
            f"n_accepted={n_accepted} out of range for spec_k={spec_k}")
    return spec_k - n_accepted


def draft_sync(committed_len: int, n_accepted: int, spec_k: int,
               ) -> tuple[int, bool]:
    """(draft KV length, lag flag) for a lane after a verify round.

    ``committed_len`` is the lane's sequence length (prompt + generated)
    *after* the round's commits. The draft's correct coverage is
    ``committed_len - 1`` except after a full accept, where the last
    proposal was never fed back — coverage stops one earlier and the
    lane owes a catch-up decode next round."""
    lag = n_accepted == spec_k
    return committed_len - 1 - (1 if lag else 0), lag


@dataclasses.dataclass
class SpecStats:
    """Cumulative speculation counters (the metrics ``speculation``
    section). ``accepted`` counts draft proposals that were committed;
    ``bonus`` the target-argmax tokens committed on top of them (<= 1
    per round — fewer only when a stop/length finish truncates the
    round). ``draft_s``/``verify_s`` split speculative tick time between
    the two dispatches."""

    spec_k: int = 0
    rounds: int = 0
    proposed: int = 0
    accepted: int = 0
    committed: int = 0
    draft_s: float = 0.0
    verify_s: float = 0.0

    def record_round(self, n_proposed: int, n_accepted: int,
                     n_committed: int) -> None:
        self.rounds += 1
        self.proposed += n_proposed
        self.accepted += n_accepted
        self.committed += n_committed

    @property
    def bonus(self) -> int:
        return self.committed - self.accepted

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def mean_accepted_len(self) -> float:
        return self.accepted / self.rounds if self.rounds else 0.0

    def to_dict(self) -> dict[str, Any]:
        return {
            "enabled": True,
            "spec_k": self.spec_k,
            "rounds": self.rounds,
            "proposed_tokens": self.proposed,
            "accepted_tokens": self.accepted,
            "bonus_tokens": self.bonus,
            "committed_tokens": self.committed,
            "acceptance_rate": self.acceptance_rate,
            "mean_accepted_len": self.mean_accepted_len,
            "mean_committed_per_round": (
                self.committed / self.rounds if self.rounds else 0.0),
            "draft_s": self.draft_s,
            "verify_s": self.verify_s,
        }

    def publish(self, registry, prefix: str = "serve_spec") -> int:
        """Mirror the counters into a :class:`repro_torch.obs.Registry` as
        ``repro_serve_spec_*`` gauges; returns how many were set."""
        return registry.ingest(prefix, self.to_dict())


def greedy_rows(logits: np.ndarray, vocab_size: int) -> np.ndarray:
    """Argmax over the true vocab for one lane's (S, Vp) verify logits —
    float64, first-index tie-break: bit-identical to the engine's greedy
    ``_sample`` on the same logits, which is what makes acceptance
    commute with baseline decode."""
    return np.argmax(
        np.asarray(logits[:, :vocab_size], np.float64), axis=-1)
