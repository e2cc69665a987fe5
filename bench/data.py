"""Inputs of a run, all made from the run's seed: the posting lists of a
configuration and the queries of a traffic mix.

Posting lists are drawn on the device with one ``torch.Generator``, in a few
large calls, and handed to the program as sorted uint32 arrays.  Every seed
gets the same list lengths and the same pool of queries (drawn from the
traffic file's ``pool_seed``); the run's seed picks the document ids and the
order in which the pool is sent.  So two seeds do the same amount of work,
in another order.

Configuration generators (the ``generator`` key of a configuration file):

- ``independent_terms``: term j holds a uniform random subset of
  [0, 2^universe_bits) of ``lengths[j]`` ids.  Term ids are popularity
  ranks: term 0 is the most popular.
- ``planted_sets``: ``n_sets`` sets of ``n`` ids over [0, 2^universe_bits);
  ``planted`` ids are in every set, the rest of each set is drawn
  independently from the other ids.

Traffic (a traffic file): k terms per query drawn from ``kw_dist``, then k
distinct terms drawn without replacement by the ``popularity`` law (``zipf``
with exponent ``s`` over the rank, or ``uniform``).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

Query = Tuple[int, ...]


def sample_ids(gen: torch.Generator, n: int, universe: int,
               exclude: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A uniform random n-subset of [0, universe) that avoids the sorted ids
    ``exclude``, sorted, int64, on the generator's device: draws with
    replacement, keeps the distinct ones, tops up until n are left, then
    keeps a uniform n of them."""
    dev = gen.device
    have = torch.empty(0, dtype=torch.int64, device=dev)
    draw = n + n // 8 + 64
    while True:
        cand = torch.randint(0, universe, (draw,), generator=gen, device=dev,
                             dtype=torch.int64)
        have = torch.unique(torch.cat([have, cand]))
        if exclude is not None and len(exclude):
            have = have[~torch.isin(have, exclude)]
        if len(have) >= n:
            break
        draw = n // 8 + 64
    pick = torch.randperm(len(have), generator=gen, device=dev)[:n]
    return torch.sort(have[pick]).values


def make_postings(config: Dict, seed: int, device: str = "cuda"
                  ) -> Dict[int, np.ndarray]:
    """{term: sorted uint32 ids} for ``config`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))
    universe = 1 << int(config["universe_bits"])
    kind = config["generator"]
    lists: Dict[int, torch.Tensor] = {}
    if kind == "independent_terms":
        for term, n in enumerate(config["lengths"]):
            lists[term] = sample_ids(gen, int(n), universe)
    elif kind == "planted_sets":
        shared = sample_ids(gen, int(config["planted"]), universe)
        for term in range(int(config["n_sets"])):
            rest = sample_ids(gen, int(config["n"]) - len(shared), universe,
                              exclude=shared)
            lists[term] = torch.sort(torch.cat([shared, rest])).values
    else:
        raise ValueError(f"unknown generator {kind!r}")
    return {t: v.cpu().numpy().astype(np.uint32) for t, v in lists.items()}


def term_lengths(config: Dict) -> List[int]:
    """The length of each term's list, by term id, as ``make_postings``
    makes them."""
    if config["generator"] == "independent_terms":
        return [int(n) for n in config["lengths"]]
    return [int(config["n"])] * int(config["n_sets"])


def popularity(traffic: Dict, n_terms: int) -> np.ndarray:
    """Probability of each term id under the traffic's popularity law."""
    law = traffic["popularity"]
    if law["law"] == "zipf":
        p = 1.0 / np.arange(1, n_terms + 1, dtype=np.float64) ** float(law["s"])
    elif law["law"] == "uniform":
        p = np.ones(n_terms)
    else:
        raise ValueError(f"unknown popularity law {law['law']!r}")
    return p / p.sum()


def draw_queries(traffic: Dict, n_terms: int, n: int,
                 rng: np.random.Generator) -> List[Query]:
    """``n`` queries: k from ``kw_dist``, then k distinct terms without
    replacement by the popularity law (never a repeated term, so k holds)."""
    ks, ps = zip(*traffic["kw_dist"])
    ps = np.asarray(ps, dtype=np.float64)
    p = popularity(traffic, n_terms)
    out = []
    for k in rng.choice(ks, size=n, p=ps / ps.sum()):
        k = min(int(k), n_terms)
        out.append(tuple(sorted(int(t) for t in
                                rng.choice(n_terms, size=k, replace=False,
                                           p=p))))
    return out


def query_pool(traffic: Dict, n_terms: int) -> List[Query]:
    """The traffic's fixed pool: ``pool_size`` queries from ``pool_seed``,
    the same for every run seed."""
    rng = np.random.default_rng(int(traffic["pool_seed"]))
    return draw_queries(traffic, n_terms, int(traffic["pool_size"]), rng)


def pool_order(pool: Sequence[Query], seed: int) -> Iterator[Query]:
    """The pool sent over and over, each pass in a new order drawn from the
    run's seed."""
    rng = np.random.default_rng(seed % (1 << 64))
    while True:
        for i in rng.permutation(len(pool)):
            yield pool[i]
