"""The traffic is the same for the same seed; the sizes are the same for
every seed and follow the mix's published statistic; a mix key that the
generator does not read is refused."""

import numpy as np
import pytest

from ovbench.tests.tiny import tiny_cell
from ovbench.traffic import Traffic, load_mix, seconds


def pools(mix, seed):
    return Traffic(mix, seed, 32, 22050).pool


def test_same_seed_same_clips():
    mix = load_mix("backlog32")
    a, b = pools(mix, 2 ** 33 + 7), pools(mix, 2 ** 33 + 7)
    for x, y in zip(a, b):
        assert np.array_equal(x["audio"], y["audio"]) and x["seed"] == y["seed"]
        assert np.array_equal(x["src"], y["src"]) and np.array_equal(x["tgt"], y["tgt"])


def test_seeds_share_sizes_not_content():
    mix = load_mix("interactive")
    a, b = pools(mix, 1), pools(mix, 2)
    assert sorted(len(x["audio"]) for x in a) == sorted(len(x["audio"]) for x in b)
    assert [len(x["audio"]) for x in a] != [len(x["audio"]) for x in b]   # another order
    assert min(seconds(mix)) >= mix["seconds_min"] and max(seconds(mix)) <= mix["seconds_max"]


@pytest.mark.parametrize("mean", [2.0, 5.605, 6.57, 9.5])
def test_lengths_have_the_mix_mean_and_range(mean):
    mix = dict(load_mix("backlog32"), seconds_mean=mean, pool=4096)
    s = seconds(mix)
    assert abs(np.mean(s) - mean) < 1e-3 * mean
    assert mix["seconds_min"] < min(s) and max(s) < mix["seconds_max"] and s == sorted(s)


@pytest.mark.parametrize("mix,key", [("backlog32", "loop"), ("prose_lines", "sentences")])
def test_unread_mix_keys_are_refused(mix, key):
    with pytest.raises(ValueError, match="takes the keys"):
        Traffic(dict(load_mix(mix), **{key: "open"}), 1, 32, 22050)


def test_text_same_seed_same_requests_and_every_seed_same_lines():
    mix = load_mix("prose_lines")
    a, b, c = pools(mix, 99), pools(mix, 99), pools(mix, 100)
    assert [(x["text"], x["speaker"], x["seed"]) for x in a] == [(x["text"], x["speaker"], x["seed"]) for x in b]
    assert sorted((x["text"], x["speaker"]) for x in a) == sorted((x["text"], x["speaker"]) for x in c)
    assert [x["text"] for x in a] != [x["text"] for x in c]   # another order
    assert all(mix["min_chars"] <= len(x["text"]) <= mix["max_chars"] for x in a)
    words = [len(x["text"].split()) for x in a]
    assert min(words) >= 1 and abs(np.mean(words) - mix["words_per_second"] * mix["seconds_mean"]) < 1.0


def test_clients_walk_the_whole_pool():
    cell = tiny_cell("v2-batcher-backlog")
    t = Traffic(dict(cell.mix, clients=3), 5, 32, 22050)
    for c in range(3):
        assert {t.request(c, j)["index"] for j in range(len(t.pool))} == set(range(len(t.pool)))
