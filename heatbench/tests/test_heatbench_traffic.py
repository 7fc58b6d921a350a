"""The data generator: the same bits for one seed, the law of the
reference's ``synth_cf_dataset`` (clusters, 1/rank popularity in a
cluster's pool, a fixed count of distinct items a user, the test split),
and at least one positive for every user."""
from __future__ import annotations

import pytest
import torch

from heatbench import traffic

MIX = {"columns": 100, "interactions_per_user": 4, "test_frac": 0.2,
       "num_clusters": 16, "item_zipf_exponent": 1.0}


def test_same_seed_same_bits_and_other_seed_differs():
    a, wa = traffic.make_dataset(2000, 500, MIX, 2**31 + 123, "cpu")
    b, wb = traffic.make_dataset(2000, 500, MIX, 2**31 + 123, "cpu")
    c, _ = traffic.make_dataset(2000, 500, MIX, 2**31 + 124, "cpu")
    assert torch.equal(a, b) and torch.equal(wa, wb)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("per_user, train", [(4, 3), (20, 16), (1, 0)])
def test_train_count_splits_as_synth_cf_dataset(per_user, train):
    mix = dict(MIX, interactions_per_user=per_user)
    assert traffic.train_count(mix) == train


@pytest.mark.parametrize("per_user, cols", [(4, 100), (20, 16)])
def test_every_user_has_its_count_of_distinct_items_left_packed(per_user,
                                                                 cols):
    mix = dict(MIX, interactions_per_user=per_user, columns=cols)
    pos, weights = traffic.make_dataset(5000, 3000, mix, 7, "cpu")
    n = traffic.train_count(mix)
    assert (pos[:, :n] >= 0).all() and (pos[:, n:] == -1).all()
    rows = torch.sort(pos[:, :n], dim=1).values
    assert not (rows[:, 1:] == rows[:, :-1]).any()
    assert pos.max() < 3000 and pos.dtype == torch.int64
    assert weights.sum().item() == 5000 * n


def test_a_user_draws_from_one_cluster_with_weight_one_over_rank():
    mix = dict(MIX, interactions_per_user=3, num_clusters=4)
    pos, weights = traffic.make_dataset(400_000, 400, mix, 11, "cpu")
    # every user's items share a cluster: rebuild the clusters from the seed
    gen = traffic.rng.generator(traffic.rng.fold_in(11, traffic.DATA_STREAM),
                                "cpu")
    torch.randint(0, 4, (400_000,), generator=gen)
    item_cluster = torch.randint(0, 4, (400,), generator=gen)
    assert torch.equal(item_cluster[pos[:, 0]], item_cluster[pos[:, 1]])
    # inside a cluster, the item of rank r (ascending id) is drawn with
    # weight 1/r, less what drawing without replacement takes from the top
    pool = torch.nonzero(item_cluster == 0).flatten()
    got = weights[pool].double()
    r = torch.arange(1, pool.numel() + 1, dtype=torch.float64)
    expect = got.sum() / r.reciprocal().sum() / r
    for i in (2, 5, 20):
        assert abs(got[i] - expect[i]) < 0.05 * expect[i]
    assert got[0] < expect[0]


def test_too_few_columns_is_refused():
    with pytest.raises(ValueError):
        traffic.make_dataset(100, 500, dict(MIX, columns=2), 1, "cpu")
