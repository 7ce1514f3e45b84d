"""The traffic generator repeats exactly for a seed, and every seed gets
the same sizes in another order."""
import pytest

from bench import generator, harness

MIXES = sorted(p.stem for p in (harness.ROOT / "bench" / "traffic").glob("*.json"))


def _draw(mix, seed, n, vocab=50000):
    s = generator.Stream(generator.load(harness.ROOT / "bench" / "traffic" / f"{mix}.json"),
                         seed, vocab)
    return [s.next() for _ in range(n)]


@pytest.mark.parametrize("mix", MIXES)
def test_generator_repeats_for_a_seed(mix):
    a, b = _draw(mix, 2 ** 31 + 17, 150), _draw(mix, 2 ** 31 + 17, 150)
    assert [(r.prompt, r.max_new) for r in a] == [(r.prompt, r.max_new) for r in b]
    c = _draw(mix, 2 ** 31 + 18, 150)
    assert [r.prompt for r in a] != [r.prompt for r in c]


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_draws_the_same_sizes(mix):
    spec = generator.load(harness.ROOT / "bench" / "traffic" / f"{mix}.json")
    n = 3 * spec["block"]
    sizes, orders = [], []
    for seed in (1, 99, 2 ** 33 + 5):
        reqs = _draw(mix, seed, n)
        sizes.append((sorted(r.max_new for r in reqs), sorted(len(r.prompt) for r in reqs)))
        orders.append([len(r.prompt) for r in reqs])
    assert sizes[0] == sizes[1] == sizes[2]
    assert orders[0] != orders[1]
    for key, got in (("output", sizes[0][0]), ("prompt", sizes[0][1])):
        lo, hi = spec[key].get("clip", spec[key].get("uniform"))
        assert all(lo <= m <= hi for m in got)


@pytest.mark.parametrize("spec,want", [
    ({"uniform": [10, 20]}, [11, 13, 15, 17, 19]),
    ({"lognormal": {"median": 100, "sigma": 0.7}, "clip": [60, 150]}, [60, 69, 100, 144, 150]),
])
def test_sizes_are_the_distributions_block_quantiles(spec, want):
    assert generator._quantiles(spec, 5) == want
