"""The four-card cell on the CPU, where four shards of ``cpu`` stand in
for the cards: correct at a tiny size, traced with its host-clock and
counter readings, and caught when a replica skips executions."""

import pytest

from gpbench.tests.gpbench_helpers import run_cell

CELL = "counter-4m-r3-mesh4.open"


def test_mesh_cell_traced_reads_its_host_and_counter_layers():
    rc, res, err = run_cell(CELL, seconds=2.0, groups=512, trace=1,
                            seed=2**33 + 5)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, err[-3000:]
    names = set(res["metrics"])
    # the host loop's accepted metrics read here as in counter-1m-r3.open
    host = {"tick_ms.open", "execute_ms.open", "queue_wait_ms.open",
            "order_wait_ms.open"}
    assert host | {"cross_card_kb_per_tick.mesh"} <= names
    for n in host:
        assert res["metrics"][n]["value"] > 0, n
    # four shards, each sending its [W, R] = [8, 3] int32 rank block to
    # the three others every tick: 1.152 KB, and nothing else
    kb = res["metrics"]["cross_card_kb_per_tick.mesh"]["value"]
    assert kb == pytest.approx(1.152, rel=0.2), kb
    # device timers and the device trace come only from cards
    assert not {"shard_tick_ms.mesh", "exchange_ms.mesh",
                "shard_gather_roofline_pct.mesh"} & names


def test_mesh_cell_catches_a_replica_that_skips():
    rc, res, err = run_cell(CELL, "--fault", "replica_skips", seconds=1.5,
                            groups=512)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False
    assert res["checks"]["state_groups_wrong"]["value"] > 0
