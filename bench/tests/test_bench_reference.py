"""The plain reference against brute force, and its control: the same
search in float32, one precision below the exact ids, has to answer wrong."""
import numpy as np
import pytest
import torch

from bench import data, reference


def lists(seed, sizes, universe):
    rng = np.random.default_rng(seed)
    return [np.sort(rng.choice(universe, n, replace=False)).astype(np.int64)
            for n in sizes]


@pytest.mark.parametrize("sizes", [(50, 80), (10, 2000, 3000),
                                   (500, 500, 600, 4000), (0, 100), (1, 1)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_intersect_equals_brute_force(sizes, seed):
    raw = lists(seed, sizes, 5000)
    want = raw[0]
    for other in raw[1:]:
        want = np.intersect1d(want, other)
    got = reference.intersect([torch.from_numpy(x) for x in raw])
    assert np.array_equal(got.numpy(), want)


def test_reference_memoizes_each_conjunction():
    posting = {t: v.astype(np.uint32)
               for t, v in enumerate(lists(3, (300, 900, 2000), 4000))}
    ref = reference.Reference(posting)
    a = ref.answer((2, 0))
    assert ref.answer([0, 2, 0]) is a
    assert np.array_equal(a, np.intersect1d(posting[0], posting[2]))
    assert a.dtype == np.uint32


def test_control_answers_wrong_past_2_to_24():
    config = {"generator": "independent_terms", "universe_bits": 25,
              "lengths": [20000, 60000, 200000, 400000]}
    posting = data.make_postings(config, 5, device="cpu")
    exact = reference.Reference(posting)
    control = reference.Reference(posting, control=True)
    pool = [(0, 1), (1, 2), (2, 3), (0, 2, 3), (0, 1, 2, 3)]
    wrong = sum(not np.array_equal(exact.answer(q), control.answer(q))
                for q in pool)
    assert wrong >= 3


def test_control_is_exact_below_2_to_24():
    config = {"generator": "independent_terms", "universe_bits": 24,
              "lengths": [5000, 20000]}
    posting = data.make_postings(config, 6, device="cpu")
    assert np.array_equal(reference.Reference(posting).answer((0, 1)),
                          reference.Reference(posting, control=True)
                          .answer((0, 1)))


@pytest.mark.card
def test_reference_and_control_on_the_card(card):
    config = {"generator": "planted_sets", "universe_bits": 31,
              "n_sets": 3, "n": 1_000_000, "planted": 10_000}
    posting = data.make_postings(config, 8, device=card)
    exact = reference.Reference(posting, device=card)
    want = np.intersect1d(posting[0], posting[1])
    assert np.array_equal(exact.answer((0, 1)), want)
    control = reference.Reference(posting, device=card, control=True)
    assert not np.array_equal(control.answer((0, 1)), want)
