"""Deterministic synthetic language-model data (``repro/data/synthetic.py``).

A sparse first-order Markov chain over the vocabulary: each token has
``branching`` possible successors with Dirichlet-distributed
probabilities, so an optimizer's progress shows in the loss curve; the
chain's conditional entropy is the achievable loss floor.

The successor and probability tables come from
``np.random.default_rng(seed)`` exactly as in the reference, so they are
equal bit for bit. The walks cannot be: the reference samples with jax's
threefry generator, which PyTorch does not have, so :meth:`MarkovLM.sample`
takes an explicit ``torch.Generator`` and gives other (equally
distributed) tokens than the reference for the same seed. Tests that hold
the two packages to the same data make the batches with numpy and hand
them to both.
"""

from __future__ import annotations

import numpy as np
import torch


class MarkovLM:
    def __init__(self, vocab_size: int, *, seed: int = 0, branching: int = 8,
                 concentration: float = 0.5):
        self.vocab_size = vocab_size
        self.branching = min(branching, vocab_size)
        rng = np.random.default_rng(seed)
        succ = np.stack([
            rng.choice(vocab_size, size=self.branching, replace=False)
            for _ in range(vocab_size)
        ])  # (V, B) successor ids
        probs = rng.dirichlet(np.full(self.branching, concentration), size=vocab_size)
        self.succ = torch.from_numpy(succ.astype(np.int32))
        self.probs = torch.from_numpy(probs.astype(np.float32))
        self._cdf = torch.cumsum(self.probs.double(), dim=-1)

    @property
    def entropy(self) -> float:
        """Conditional entropy in nats = the achievable loss floor."""
        p = self.probs.numpy()
        return float(np.mean(-np.sum(p * np.log(p), axis=-1)))

    def sample(self, gen: torch.Generator, batch: int, seq_len: int) -> torch.Tensor:
        """(batch, seq_len + 1) int32 token walk, on the CPU, from ``gen``."""
        first = torch.randint(0, self.vocab_size, (batch,), generator=gen)
        u = torch.rand((seq_len, batch), generator=gen, dtype=torch.float64)
        toks = [first]
        tok = first
        for t in range(seq_len):
            idx = torch.searchsorted(self._cdf[tok], u[t][:, None])[:, 0]
            idx = idx.clamp_max(self.branching - 1)
            tok = self.succ[tok, idx].long()
            toks.append(tok)
        return torch.stack(toks, dim=1).to(torch.int32)


def make_train_batch(lm: MarkovLM, gen: torch.Generator, batch: int, seq_len: int):
    """{"tokens": (B, S), "labels": (B, S)} next-token pairs (int32, CPU)."""
    toks = lm.sample(gen, batch, seq_len)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
