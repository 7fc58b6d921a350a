"""``device_cf_dataset``'s empty-user modes against the reference's (the
port of ``tests/test_stream.py::test_device_cf_dataset_empty_user_guard_modes``
as a parity test): the same datasets go through both packages, which must
raise in the same cases with the same messages; and the memo of one device
view per (dataset, device), dropped with the dataset."""
import gc

import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline

USERS, ITEMS = 32, 960


def _outcome(fn):
    """``("ok", None)`` or ``(exception type name, message)``."""
    try:
        view = fn()
    except ValueError as e:
        return type(e).__name__, str(e)
    assert view is not None
    return "ok", None


def _datasets():
    full = pipeline.synth_cf_dataset(USERS, ITEMS, interactions_per_user=4,
                                     seed=0)
    partial = pipeline.synth_cf_dataset(USERS, ITEMS,
                                        interactions_per_user=4, seed=1)
    partial.train_pos[3, :] = -1
    partial.train_pos[9, :] = -1
    empty = pipeline.synth_cf_dataset(USERS, ITEMS, interactions_per_user=4,
                                      seed=2)
    empty.train_pos[:, :] = -1
    return {"full": full, "partial": partial, "empty": empty}


@pytest.mark.parametrize("name", ["full", "partial", "empty"])
@pytest.mark.parametrize("mode", [None, False, True])
def test_empty_user_modes_match_reference(name, mode):
    ds = _datasets()[name]
    kw = {} if mode is None else {"allow_empty_users": mode}
    jds = jpipe.CFDataset(ds.num_users, ds.num_items, ds.train_pos.copy(),
                          ds.test_pos.copy())
    want = _outcome(lambda: jpipe.device_cf_dataset(jds, **kw))
    got = _outcome(lambda: pipeline.device_cf_dataset(ds, "cpu", **kw))
    assert got == want
    expect_raise = {("partial", False), ("empty", None), ("empty", False)}
    assert (got[0] != "ok") == ((name, mode) in expect_raise)


def test_empty_user_guard_messages():
    """The reference test's assertions, on the port."""
    d = _datasets()
    assert pipeline.device_cf_dataset(d["full"], "cpu",
                                      allow_empty_users=False)
    assert pipeline.device_cf_dataset(d["partial"], "cpu") is not None
    with pytest.raises(ValueError, match="2 user\\(s\\) have zero train"):
        pipeline.device_cf_dataset(d["partial"], "cpu",
                                   allow_empty_users=False)
    with pytest.raises(ValueError, match="stream_ring_dataset"):
        pipeline.device_cf_dataset(d["empty"], "cpu")
    assert pipeline.device_cf_dataset(d["empty"], "cpu",
                                      allow_empty_users=True) is not None


def test_device_view_is_memoized_per_dataset_and_dropped_with_it():
    ds = pipeline.synth_cf_dataset(USERS, ITEMS, interactions_per_user=4)
    a = pipeline.device_cf_dataset(ds, "cpu")
    assert pipeline.device_cf_dataset(ds, "cpu") is a
    assert pipeline.device_cf_dataset(ds, "cpu", allow_empty_users=False) is a
    other = pipeline.synth_cf_dataset(USERS, ITEMS, interactions_per_user=4)
    assert pipeline.device_cf_dataset(other, "cpu") is not a
    np.testing.assert_array_equal(a.train_pos.numpy(), ds.train_pos)
    key = (id(ds), "cpu")
    assert key in pipeline._DEVICE_VIEWS
    del ds
    gc.collect()
    assert key not in pipeline._DEVICE_VIEWS
