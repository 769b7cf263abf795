"""The generator repeats exactly for a seed and differs across seeds, with
the same sizes for every seed."""

import numpy as np
import pytest
import torch

from perfbench import spec, traffic

BIG_SEED = 2**31 + 12345


def _cfg():
    cfg = spec.cell("amazon.eval")["config"]
    cfg.update(num_users=500, num_items=400, num_interactions=30000,
               pretrain_interactions=20000, finetune_interactions=4000,
               test_interactions=3000, test_users=60)
    return cfg


def test_same_seed_same_inputs_other_seed_other_inputs():
    cfg = _cfg()
    a = traffic.make_inputs(cfg, "finetune", BIG_SEED, True)
    b = traffic.make_inputs(cfg, "finetune", BIG_SEED, True)
    c = traffic.make_inputs(cfg, "finetune", BIG_SEED + 1, True)
    for part in ("train", "hist"):
        for k in ("users", "items", "times"):
            assert np.array_equal(a[part][k], b[part][k])
            assert len(a[part][k]) == len(c[part][k])
    assert np.array_equal(a["test"], b["test"])
    assert a["test"].shape == c["test"].shape
    assert not np.array_equal(a["train"]["users"], c["train"]["users"])


def test_splits_follow_the_configuration():
    cfg = _cfg()
    assert traffic.split_bounds(cfg) == [0, 20000, 24000, 27000]
    ft = traffic.make_inputs(cfg, "finetune", 3, False)
    assert len(ft["train"]["users"]) == 4000
    assert len(ft["hist"]["users"]) == 20000
    assert ft["hist"]["times"].max() <= ft["train"]["times"].min()
    assert ft["test"] is None
    pre = traffic.make_inputs(cfg, "pretrain", 3, False)
    assert len(pre["train"]["users"]) == cfg["num_interactions"]
    assert len(pre["hist"]["users"]) == 0
    cfg["test_interactions"] = 7000
    with pytest.raises(ValueError):
        traffic.split_bounds(cfg)


def test_amazon_stage_sizes_are_the_recorded_ones():
    cfg = spec.cell("amazon.eval")["config"]
    assert (cfg["finetune_interactions"], cfg["test_interactions"],
            cfg["test_users"]) == (24051, 18076, 8874)
    assert traffic.split_bounds(cfg)[-1] <= cfg["num_interactions"]


def test_test_rows_fall_on_test_users_with_a_history():
    cfg = _cfg()
    inp = traffic.make_inputs(cfg, "finetune", 5, True)
    assert inp["test"].shape == (3000, 2)
    users = np.unique(inp["test"][:, 0])
    assert len(users) == cfg["test_users"]
    hist = np.concatenate([inp["hist"]["users"], inp["train"]["users"]])
    assert np.isin(users, hist).all()
    assert inp["test"][:, 1].max() < cfg["num_items"]


def test_skew_puts_popular_ids_first():
    rng = np.random.default_rng(0)
    ids = traffic.skewed_ids(rng, 1000, 200000, 0.8)
    counts = np.sort(np.bincount(ids, minlength=1000))[::-1]
    # p(rank) ~ (rank + 1)^-0.8: the top id about 10^0.8 times the 10th
    assert 4.0 < counts[0] / counts[9] < 9.0


def test_tables_repeat_for_a_seed():
    cfg = _cfg()
    a = traffic.make_tables(cfg, "finetune", BIG_SEED, torch.device("cpu"))
    b = traffic.make_tables(cfg, "finetune", BIG_SEED, torch.device("cpu"))
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k])
    assert a["params"]["user_embedding"].shape == (cfg["num_users"], 64)
    norms = a["library"]["item_embedding"].norm(dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
