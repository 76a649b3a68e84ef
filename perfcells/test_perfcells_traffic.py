"""The traffic generator: the same seed gives the same requests, lengths
keep to their ranges, every seed gets the same work, the shared document
is whole pages."""
import collections
import json

import numpy as np
import pytest

from perfcells import harness, traffic

MIXES = ["chat", "shared-doc", "long-prompt"]
SEED = 2**31 + 977


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = traffic.load(name)
    a = traffic.requests(mix, SEED, 50304, 100)
    b = traffic.requests(mix, SEED, 50304, 100)
    assert [(r.max_tokens, r.prompt.tolist()) for r in a] == [
        (r.max_tokens, r.prompt.tolist()) for r in b]
    c = traffic.requests(mix, SEED + 1, 50304, 100)
    assert [r.prompt.tolist() for r in a] != [r.prompt.tolist() for r in c]


@pytest.mark.parametrize("name", MIXES)
def test_lengths_in_range(name):
    mix = traffic.load(name)
    shared = mix.get("shared_prefix", 0)
    reqs = traffic.requests(mix, SEED, 1000, 300)
    for r in reqs:
        own = len(r.prompt) - shared
        assert mix["prompt"]["min"] <= own <= mix["prompt"]["max"]
        assert r.prompt.dtype == np.int32
        assert 1 <= r.prompt.min() and r.prompt.max() < 1000
        assert 1 <= r.max_tokens <= mix["output"]["max"]
    for r in reqs[mix["clients"]:]:
        assert mix["output"]["min"] <= r.max_tokens


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gets_the_same_work(name):
    """Each whole block after the opening holds the same multiset of
    lengths on every seed; only the order and the token ids differ, and
    the order only where the mix has no ``order_seed``."""
    mix = traffic.load(name)
    block = mix["block"]
    n = mix["clients"] + 4 * block
    n -= n % block

    def work(seed):
        reqs = traffic.requests(mix, seed, 1000, n)
        return (collections.Counter(len(r.prompt) for r in reqs),
                collections.Counter(r.max_tokens for r in reqs),
                [r.max_tokens for r in reqs])

    a, b = work(1), work(2**31 + 5)
    assert a[0] == b[0] and a[1] == b[1]
    assert (a[2] == b[2]) == ("order_seed" in mix)


def test_shared_document_is_whole_pages():
    mix = traffic.load("shared-doc")
    path = harness.HERE / "configs/nemotron-4-15b.json"
    cfg = json.loads(path.read_text())
    ps = cfg["serving"]["page_size"]
    doc = traffic.shared_prefix(mix, SEED, cfg["vocab"])
    assert len(doc) == mix["shared_prefix"] and len(doc) % ps == 0
    assert len(doc) % mix["prefix_chunk"] == 0
    reqs = traffic.requests(mix, SEED, cfg["vocab"], 40)
    assert all(np.array_equal(r.prompt[:len(doc)], doc) for r in reqs)
    assert not np.array_equal(traffic.shared_prefix(mix, SEED + 1, 99), doc)


def test_quantile_lengths():
    assert traffic.quantile_lengths(
        {"dist": "uniform", "min": 0, "max": 100}, 4) == [12, 38, 62, 88]
    lognormal = traffic.quantile_lengths(
        {"dist": "lognormal", "median": 320, "sigma": 0.6, "min": 128,
         "max": 1024}, 33)
    assert lognormal[16] == 320 and lognormal == sorted(lognormal)
    assert min(lognormal) >= 128 and max(lognormal) <= 1024
    loguniform = traffic.quantile_lengths(
        {"dist": "loguniform", "min": 512, "max": 3072}, 2)
    assert loguniform == [round(512 * 6 ** 0.25), round(512 * 6 ** 0.75)]


def test_warmup_buckets():
    assert traffic.warmup_prompt_lengths(traffic.load("chat")) == [
        128, 256, 512, 1024]
    assert traffic.warmup_prompt_lengths(traffic.load("long-prompt")) == [
        512, 1024, 2048, 3072]
    assert traffic.warmup_prompt_lengths(traffic.load("shared-doc")) == [
        32, 64, 128, 256]
