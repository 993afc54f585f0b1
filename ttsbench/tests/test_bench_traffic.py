import pytest

from ttsbench import traffic
from ttsbench.tests.tiny import TINY_CLOSED, TINY_OPEN

SEED = 2**31 + 12345
MIXES = sorted(p.stem for p in (traffic.ROOT / "traffic").glob("*.json"))


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_repeats_exactly(mix):
    m = traffic.load(mix)
    assert traffic.generate(m, SEED, 30) == traffic.generate(m, SEED, 30)


def _sizes(g):
    reqs = g["requests"] if g["loop"] == "open" else \
        [r for c in g["clients"] for r in c]
    return [sorted(r[k] for r in reqs) for k in ("max_tokens", "greedy")] \
        + [sorted(len(r["text"]) for r in reqs)]


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_change_the_order_not_the_work(mix):
    m = traffic.load(mix)
    a, b = traffic.generate(m, 1, 30), traffic.generate(m, SEED, 30)
    assert _sizes(a) == _sizes(b)
    assert a != b
    if a["loop"] == "open":
        assert a["requests"][-1]["due_s"] == pytest.approx(
            b["requests"][-1]["due_s"])


def test_open_loop_spans_ramp_and_window():
    m = traffic.load("agent-1.6rps")
    g = traffic.generate(m, 3, 30)
    due = [r["due_s"] for r in g["requests"]]
    assert len(due) == round(m["rate_per_s"] * 35)
    assert 0 == due[0] and max(due) < 35
    assert all(b >= a for a, b in zip(due, due[1:]))


def test_texts_unique_and_lengths_in_range():
    for mix in MIXES:
        m = traffic.load(mix)
        g = traffic.generate(m, 9, 30)
        reqs = g["requests"] if g["loop"] == "open" else \
            [r for c in g["clients"] for r in c]
        assert len({r["text"] for r in reqs}) == len(reqs)
        lo = traffic.frames_of(m["audio_s"]["min"]) * 7
        hi = traffic.frames_of(m["audio_s"]["max"]) * 7
        assert all(lo <= r["max_tokens"] <= hi for r in reqs)
        assert all(m["text_bytes"]["min"] <= len(r["text"])
                   <= m["text_bytes"]["max"] for r in reqs)
        # every request's prompt fits the mix's largest prefill bucket and
        # its whole sequence the engine's max_seq
        eng = m["engine"]
        assert all(len(r["text"]) + 6 + 5 <= eng["max_input_len"]
                   for r in reqs)
        assert all(len(r["text"]) + 11 + r["max_tokens"] + 8
                   <= eng["max_input_len"] + eng["max_output_len"]
                   for r in reqs)


def test_tiny_mixes_generate():
    assert traffic.generate(TINY_OPEN, 1, 3)["requests"]
    assert traffic.generate(TINY_CLOSED, 1, 3)["clients"]
