"""The traffic generator: the same work for every seed, in the seed's
order; deterministic; within the stated lengths and rate."""
import pytest

import tiny  # noqa: F401  (puts the checkout on sys.path)

from gpubench import core, load

REG = core.Registry()
CHAT = REG.cell("mistral-7b.chat")["params"]
# an open-loop mix of uniform lengths, for the generator's other paths
RAG = {"driver": "serve_open", "rate_per_s": 2.0, "block": 10,
       "prompt_tokens": {"dist": "uniform", "min": 1536, "max": 3584},
       "output_tokens": {"dist": "uniform", "min": 16, "max": 128}}
SEEDS = [0, 1, 2 ** 31 + 11, -5, 2 ** 40]


@pytest.mark.parametrize("seed", SEEDS)
def test_lengths_are_the_strata_in_the_seeds_order(seed):
    for dist in (CHAT["prompt_tokens"], CHAT["output_tokens"],
                 RAG["prompt_tokens"], RAG["output_tokens"]):
        got = load.lengths(dist, 100, seed, 1)
        assert got == load.lengths(dist, 100, seed, 1)
        assert sorted(got) == load.strata(dist, 100)
        assert all(dist["min"] <= n <= dist["max"] for n in got)
    assert load.lengths(RAG["prompt_tokens"], 100, seed, 1) != \
        load.lengths(RAG["prompt_tokens"], 100, seed + 1, 1)


def test_strata_follow_the_distribution():
    med = load.strata(CHAT["prompt_tokens"], 1001)[500]
    assert med == CHAT["prompt_tokens"]["median"]
    # the source's medians, and every request within the deployment's
    # positions
    assert "2311.18677" in CHAT["source"]
    assert (CHAT["prompt_tokens"]["median"],
            CHAT["output_tokens"]["median"]) == (1020, 129)
    assert CHAT["prompt_tokens"]["max"] + CHAT["output_tokens"]["max"] \
        <= REG.config("mistral-7b")["max_position_embeddings"]
    uni = load.strata(RAG["prompt_tokens"], 2048)
    assert uni[0] == 1536 and uni[-1] == 3584
    assert abs(sum(uni) / len(uni) - 2560) < 2


@pytest.mark.parametrize("seed", SEEDS)
def test_closed_loop_rounds_carry_the_same_work(seed):
    clients = CHAT["clients"]
    vals = load.rounds(CHAT["output_tokens"], clients, 4, seed, 2)
    want = load.strata(CHAT["output_tokens"], clients)
    for r in range(4):
        assert sorted(vals[r * clients:(r + 1) * clients]) == want


@pytest.mark.parametrize("rate,seconds", [(2.0, 50.0), (3.3, 40.0),
                                          (0.5, 10.0)])
def test_arrivals_keep_the_rate_and_the_window(rate, seconds):
    a = load.arrivals(rate, seconds, 9, 4)
    b = load.arrivals(rate, seconds, 10, 4)
    assert len(a) == len(b) == round(rate * seconds)
    assert a[0] == 0.0 and all(0 <= t < seconds for t in a)
    assert a == sorted(a) and a != b
    gaps = lambda d: sorted(round(y - x, 9)  # noqa: E731
                            for x, y in zip(d, d[1:] + [seconds]))
    assert gaps(a) == gaps(b)        # the same gaps, in another order


def test_prompts_are_seeded_and_within_the_vocabulary():
    p = load.prompts([5, 9], 32768, 3, 3)
    assert p == load.prompts([5, 9], 32768, 3, 3)
    assert [len(x) for x in p] == [5, 9]
    assert all(0 <= t < 32768 for x in p for t in x)


def test_schedules_of_the_drivers():
    cfg = core.dims(REG.config("mistral-7b"))
    chat = REG.driver("serve_closed").schedule(cfg, CHAT, 4, 50.0)[0]
    assert len(chat) == CHAT["clients"] == \
        REG.config("mistral-7b")["serving"]["max_batch"]
    firsts = sorted(c[0].max_tokens for c in chat)
    assert firsts == load.strata(CHAT["output_tokens"], CHAT["clients"])
    rag, lens = REG.driver("serve_open").schedule(cfg, RAG, 4, 50.0)
    assert len(rag) == round(RAG["rate_per_s"] * 50)
    assert all(len(r.prompt) + r.max_tokens <= cfg.max_seq_len
               for r in rag)
    assert sorted(lens) == sorted(set(len(r.prompt) for r in rag))
