"""Host-side draft-token proposers for the engine's speculative verify path
(the counterpart of ``trlx_tpu.engine.drafters``).

The verify call (``RolloutEngine._step_verify``) takes any object with
``reset_slot`` / ``observe`` / ``propose``. Drafting is per slot and on the
host: O(n_slots * spec_k) dictionary lookups a sync, and a slot's table is
dropped when the slot is readmitted, so a refill never inherits another
prompt's statistics.

``NgramDrafter`` keeps a per-slot bigram table seeded from the admitted
prompt and updated from the ACCEPTED tokens only (rejected drafts are what
the model disagreed with). A ``transition`` function, when given, replaces
the table (a next-token map known in advance). ``make_drafter("model")``
raises ``NotImplementedError``, as in the JAX package: the drafter-model
hook is reserved there too.
"""

from typing import Callable, Optional, Sequence

__all__ = ["NgramDrafter", "make_drafter"]


class NgramDrafter:
    """Per-slot bigram (order-1 n-gram) draft proposer.

    ``propose(slot, last_token, k)`` chains k predictions through the slot's
    table; a miss proposes ``pad_token_id``, a draft the verify call rejects
    at no cost beyond the window it dispatched anyway. A cold table decodes
    at the non-speculative rate (the window's first token is the model's
    own)."""

    def __init__(self, pad_token_id: int, transition: Optional[Callable[[int], int]] = None):
        self.pad_token_id = int(pad_token_id)
        self.transition = transition
        self._tables = {}  # slot -> {prev_token: next_token}, the last seen wins

    def reset_slot(self, slot: int, prompt_tokens: Sequence[int]) -> None:
        """A slot was (re)admitted: drop its table and seed one from the
        prompt's bigrams."""
        toks = [int(t) for t in prompt_tokens]
        self._tables[int(slot)] = dict(zip(toks, toks[1:]))

    def observe(self, slot: int, tokens: Sequence[int]) -> None:
        """Fold newly ACCEPTED tokens into the slot's table; the caller puts
        the previous frontier token first, so its transition counts too."""
        table = self._tables.setdefault(int(slot), {})
        toks = [int(t) for t in tokens]
        for prev, nxt in zip(toks, toks[1:]):
            table[prev] = nxt

    def propose(self, slot: int, last_token: int, k: int) -> list:
        """k draft tokens continuing ``last_token``, chained through the
        table (or the transition function)."""
        out = []
        cur = int(last_token)
        table = self._tables.get(int(slot), {})
        for _ in range(k):
            cur = int(self.transition(cur)) if self.transition is not None else table.get(cur, self.pad_token_id)
            out.append(cur)
        return out


def make_drafter(kind: str, pad_token_id: int):
    """The drafter of a ``method.spec_decode`` value: "ngram" is
    ``NgramDrafter``; "model" (a small on-device LM proposing the window) is
    reserved and raises ``NotImplementedError``."""
    if kind == "ngram":
        return NgramDrafter(pad_token_id)
    if kind == "model":
        raise NotImplementedError(
            "spec_decode='model' (drafter-model hook) is reserved: implement a propose() backed by a small LM "
            "and register it here"
        )
    raise ValueError(f"unknown spec_decode drafter kind: {kind!r}")
