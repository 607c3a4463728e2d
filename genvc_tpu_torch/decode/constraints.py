"""Phrasal-constraint progress tracking for constrained beam search
(``genvc_tpu/decode/constraints.py``, kept as the port's own copy).

The reference's vendored HF generator routes ``constraints`` /
``force_words_ids`` to constrained beam search; :func:`engine.decode_constrained`
runs the banked beam selection on the host over the engine's KV-cached
forwards, and this module supplies the constraint bookkeeping it needs.

Semantics of HF's ``PhrasalConstraint`` + ``ConstraintListState``
(``transformers.generation.beam_constraints``):

* at most ONE phrase is "in progress" at a time; a token that does not extend
  it resets that phrase back to pending (list-level reset, not global),
* while no phrase is in progress, a token may start any pending phrase (the
  first match wins, one phrase per token),
* ``bank`` = completed_phrases * max_phrase_len + progress_of_inprogress —
  the quantity the beam scorer round-robins over.
"""

from __future__ import annotations


class PhraseListState:
    """Progress of one hypothesis through a list of token phrases."""

    def __init__(self, phrases):
        if not phrases or any(len(p) == 0 for p in phrases):
            raise ValueError("constraints must be non-empty token phrases")
        self.phrases = [tuple(int(t) for t in p) for p in phrases]
        self.max_len = max(len(p) for p in self.phrases)
        self.n_complete = 0
        self.inprogress = None      # (phrase, fulfilled_count) or None
        self.pending = list(self.phrases)
        self.completed = False

    def copy(self):
        c = PhraseListState.__new__(PhraseListState)
        c.phrases = self.phrases
        c.max_len = self.max_len
        c.n_complete = self.n_complete
        c.inprogress = self.inprogress
        c.pending = list(self.pending)
        c.completed = self.completed
        return c

    def get_bank(self) -> int:
        # HF's formula: in-progress credit is max_seqlen - remaining() — the
        # GLOBAL max phrase length minus tokens left in the in-progress
        # phrase (progress on short phrases is deliberately inflated)
        if self.inprogress is not None:
            phrase, done = self.inprogress
            add = self.max_len - (len(phrase) - done)
        else:
            add = 0
        return self.n_complete * self.max_len + add

    def advance(self):
        """Tokens that make progress: the in-progress phrase's next token, or
        the first token of every pending phrase."""
        if self.completed:
            return []
        if self.inprogress is not None:
            phrase, done = self.inprogress
            return [phrase[done]]
        return [p[0] for p in self.pending]

    def add(self, token: int) -> None:
        """Advance (or reset) by one generated token — one phrase max."""
        if self.completed:
            return
        if self.inprogress is not None:
            phrase, done = self.inprogress
            if token == phrase[done]:
                done += 1
                if done == len(phrase):
                    self.n_complete += 1
                    self.inprogress = None
                else:
                    self.inprogress = (phrase, done)
            else:
                # broken mid-phrase: back to pending (this phrase only)
                self.pending.append(phrase)
                self.inprogress = None
        else:
            for i, phrase in enumerate(self.pending):
                if token == phrase[0]:
                    del self.pending[i]
                    if len(phrase) == 1:
                        self.n_complete += 1
                    else:
                        self.inprogress = (phrase, 1)
                    break
        if not self.pending and self.inprogress is None:
            self.completed = True

    def reset(self, token_ids) -> None:
        """Recompute progress from scratch over a full token sequence."""
        self.n_complete = 0
        self.inprogress = None
        self.pending = list(self.phrases)
        self.completed = False
        for t in token_ids:
            self.add(int(t))
            if self.completed:
                break


def completes_all(phrases, token_ids) -> bool:
    st = PhraseListState(phrases)
    st.reset(token_ids)
    return st.completed
