"""The port's dispatch seam against the JAX package's: the copied
``DispatchPipeline`` delivers in the same order with the same counters,
``fetch_to_host`` turns a tensor tree into the numpy tree the reference's
fetch gives, and the ported ``StagingCache`` serves the reference's rows."""

import random
from dataclasses import asdict

import numpy as np
import pytest
import torch

from hbbft_tpu.crypto.field import Q
from hbbft_tpu.ops import fq_rns as JR, pipeline as JP, staging as JS
from hbbft_tpu.utils.metrics import Counters as RefCounters
from hbbft_tpu_torch.ops import pipeline as TP, staging as TS
from hbbft_tpu_torch.utils.metrics import Counters


def _drive(P, C, depth, flush_order):
    """A fixed sequence of async and sync submits; returns the delivery
    log and the counters the pipeline billed."""
    log = []
    counters = C()
    pipe = P.DispatchPipeline(counters=counters, depth_fn=lambda: depth)
    for i in range(5):
        pipe.submit(lambda i=i: i, fetch=None, kind="pairing", items=i + 1,
                    on_result=lambda v: log.append(("async", v)))
    sync = pipe.submit(lambda: 99, fetch=None, kind="rlc_dec", items=7, sync=True)
    log.append(("sync", sync.value))
    for i in range(5, 9):
        pipe.submit(lambda i=i: i, fetch=None, kind="combine", items=1,
                    on_result=lambda v: log.append(("async", v)))
    pipe.flush(order=flush_order)
    billed = {k: v for k, v in asdict(counters).items() if "dispatches" in k}
    return log, billed, len(pipe)


@pytest.mark.parametrize("depth", [0, 1, 2, 8])
def test_dispatch_pipeline_matches_the_reference(depth):
    order = [3, 0, 2, 1] if depth >= 4 else list(range(depth))[::-1]
    port = _drive(TP, Counters, depth, order)
    ref = _drive(JP, RefCounters, depth, order)
    assert port == ref
    assert port[2] == 0


def test_pipeline_depth_default_and_kill_switch(monkeypatch):
    monkeypatch.delenv("HBBFT_TPU_NO_PIPELINE", raising=False)
    monkeypatch.delenv("HBBFT_TPU_PIPELINE_DEPTH", raising=False)
    assert TP.pipeline_depth() == JP.pipeline_depth() == 2
    monkeypatch.setenv("HBBFT_TPU_NO_PIPELINE", "1")
    assert TP.pipeline_depth() == JP.pipeline_depth() == 0


def test_fetch_to_host_gives_the_numpy_tree():
    rows = JR.from_ints([1, 2, 3])
    tree = ((torch.as_tensor(rows), torch.as_tensor(-rows)), torch.tensor([True, False, True]))
    out = TP.fetch_to_host(tree)
    assert isinstance(out[0][0], np.ndarray) and out[0][0].dtype == np.float32
    assert np.array_equal(out[0][0], rows) and np.array_equal(out[0][1], -rows)
    assert out[1].tolist() == [True, False, True]


def test_staging_cache_serves_the_reference_rows():
    rng = random.Random(8)
    vals = [rng.randrange(Q) for _ in range(6)]
    calls = [vals[:4], vals[2:] + vals[:1], vals[4:] * 3]
    port = TS.StagingCache(capacity=5, counters=Counters())
    ref = JS.StagingCache(capacity=5, counters=RefCounters())
    for batch in calls:
        got = port.rows(batch)
        assert np.array_equal(got, ref.rows(batch))
        assert np.array_equal(got, JR.from_ints(batch))
    assert len(port) == len(ref) == 5
    assert port.counters.stage_cache_hits == ref.counters.stage_cache_hits
    assert port.counters.stage_cache_misses == ref.counters.stage_cache_misses
    assert TS.StagingCache().capacity == TS.DEFAULT_CAPACITY
    port.clear()
    assert len(port) == 0
