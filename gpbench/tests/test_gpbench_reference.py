"""The reference's arithmetic on hand-made streams, and the journal reader
against journals the port writes."""

import numpy as np

from gpbench.ledger import Ledger
from gpbench.reference import counter, journal, kv
from gpbench.traffic import OP_GET, OP_PUT, Requests


def test_counter_reference_sums_and_counts():
    group = np.array([0, 2, 2, 1, 2])
    delta = np.array([5, 1, 2, 7, 3])
    acc, cnt = counter.expected(4, group, delta)
    assert acc.tolist() == [5, 7, 6, 0]
    assert cnt.tolist() == [1, 1, 3, 0]
    R = 3
    good = counter.compare(4, group, delta, np.tile(acc, (R, 1)),
                           np.tile(cnt, (R, 1)))
    assert good == {"state_groups_wrong": 0, "state_cells_wrong": 0}
    bad_acc = np.tile(acc, (R, 1))
    bad_acc[2, 1] += 1
    out = counter.compare(4, group, delta, bad_acc, np.tile(cnt, (R, 1)))
    assert out == {"state_groups_wrong": 1, "state_cells_wrong": 1}


def test_kv_replay_by_hand():
    # group 0: PUT 9=1, GET 9, PUT 17=5 (same cell as 9 with 8 cells),
    # GET 9 (evicted: 0), GET 17; group 1: GET 3 (absent)
    seq_group = np.array([0, 0, 0, 0, 0, 1])
    op = np.array([OP_PUT, OP_GET, OP_PUT, OP_GET, OP_GET, OP_GET])
    key = np.array([9, 9, 17, 9, 17, 3])
    val = np.array([1, 0, 5, 0, 0, 0])
    resp, tk, tv = kv.replay(seq_group, op, key, val, 2, 8)
    assert resp.tolist() == [1, 1, 5, 0, 5, 0]
    assert tk[0, 1] == 17 and tv[0, 1] == 5
    assert not tk[1].any()


def _ledger(group, op, key, val, t_prop, t_ack, resp):
    led = Ledger(cap=16)
    n = len(group)
    rids = np.arange(1, n + 1)
    reqs = Requests(np.array(group), np.array(op, np.int32),
                    np.array(key, np.int32), np.array(val, np.int32),
                    np.zeros(n, np.int64))
    for i in range(n):
        one = Requests(*(getattr(reqs, f)[i:i + 1]
                         for f in Requests.__slots__))
        led.admit(rids[i:i + 1], one, t_prop[i], t_prop[i])
    led.ack_rids(rids, np.array(t_ack, float), np.array(resp))
    return led


def _stream(order, R=3):
    """(rid, rep, row, slot) of every replica executing ``order``: a list
    of (rid, row, slot)."""
    cols = [[], [], [], []]
    for r in range(R):
        for rid, row, slot in order:
            for c, v in zip(cols, (rid, r, row, slot)):
                c.append(v)
    return np.array(cols, np.int64)


def test_kv_compare_accepts_a_sound_run_and_flags_faults():
    # two groups on rows 1 and 0; requests 1..4
    led = _ledger(group=[0, 0, 1, 0], op=[OP_PUT, OP_GET, OP_PUT, OP_GET],
                  key=[4, 4, 6, 12], val=[10, 0, 20, 0],
                  t_prop=[0.0, 0.0, 0.0, 2.0], t_ack=[1.0, 1.5, 1.0, 3.0],
                  resp=[10, 10, 20, 0])
    rows_of_group = np.array([1, 0])
    order = [(1, 1, 0), (2, 1, 1), (3, 0, 0), (4, 1, 2)]
    key_tab = np.zeros((3, 2, 8), np.int32)
    val_tab = np.zeros((3, 2, 8), np.int32)
    key_tab[:, 1, 4], val_tab[:, 1, 4] = 4, 10
    key_tab[:, 0, 6], val_tab[:, 0, 6] = 6, 20
    out = kv.compare(led, rows_of_group, _stream(order), key_tab, val_tab)
    assert all(v == 0 for v in out.values()), out

    # a wrong GET answer
    led.resp[2] = 11
    assert kv.compare(led, rows_of_group, _stream(order), key_tab,
                      val_tab)["resp_wrong"] == 1
    led.resp[2] = 10
    # a replica that lost a cell
    bad = key_tab.copy()
    bad[2, 1, 4] = 0
    assert kv.compare(led, rows_of_group, _stream(order), bad,
                      val_tab)["store_cells_wrong"] == 1
    # replicas that disagree on a slot, and a request executed twice
    s = _stream(order)
    s[0, 4 + 1] = 4
    out = kv.compare(led, rows_of_group, s, key_tab, val_tab)
    assert out["order_disagree"] > 0 and out["exec_not_once"] > 0
    # request 4 (proposed at 2.0) ordered before request 2 (acked at 1.5)
    late = [(1, 1, 0), (4, 1, 1), (2, 1, 2), (3, 0, 0)]
    out = kv.compare(led, rows_of_group, _stream(late), key_tab, val_tab)
    assert out["order_realtime"] == 1


def test_journal_reader_reads_what_the_port_journals(tmp_path):
    """The reader decodes the tick records of a journal the port writes
    (the port writes; the reader itself imports nothing of it)."""
    import torch

    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig
    from gigapaxos_tpu_torch.paxos.manager import PaxosManager
    from gigapaxos_tpu_torch.wal.logger import PaxosLogger

    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = 64
    cfg.paxos.compact_outbox = True
    cfg.paxos.device_app = True
    cfg.paxos.kv_slots = 8
    wal = PaxosLogger(str(tmp_path), sync_every_ticks=1, native=False)
    m = PaxosManager(cfg, 3, [None] * 3, wal=wal, device="cpu")
    m.create_paxos_instances([f"g{i}" for i in range(64)], [0, 1, 2])
    got = []
    rows = np.arange(40) % 64
    rids = m.propose_bulk_kv(rows, np.full(40, OP_PUT),
                             np.arange(1, 41), np.arange(100, 140),
                             callbacks=[lambda r, v: got.append(r)] * 40)
    for _ in range(6):
        m.tick()
    wal.close()
    assert len(got) == 40
    recs = []
    for p in sorted(tmp_path.glob("journal.*.log")):
        j = journal.read_journal(str(p))
        assert j["covered"] == len(j["ticks"]) and len(j["barriers"])
        recs += j["ticks"]
    placed = np.concatenate([r[1] for r in recs])
    assert sorted(placed.tolist()) == sorted(rids.tolist())
    desc = np.concatenate([r[2] for r in recs if r[2] is not None], axis=1)
    assert sorted(desc[0].tolist()) == sorted(rids.tolist())
    by = dict(zip(desc[0].tolist(), desc[2].tolist()))
    assert all(by[int(r)] == i + 1 for i, r in enumerate(rids))
    del torch


class _Acks:
    """The ledger's fields that ``journal.acked_early`` reads."""

    def __init__(self, jpos):
        self.jpos = np.asarray(jpos, np.int64)
        self.top = len(self.jpos)


def test_acked_early_by_hand():
    """Records of rids 1-2 end at 100, of rid 3 at 300 (placed again: its
    first record, ending at 200, was not taken); barriers end at 150 and
    400.  Acknowledged at 160, 140, 450 and 350 (rid 3 too early)."""
    records = [(np.array([1, 2], np.int64), 100),
               (np.array([3], np.int64), 200),
               (np.array([3], np.int64), 300)]
    barriers = np.array([150, 400], np.int64)
    acked = np.array([1, 2, 3])
    assert journal.acked_early(records, barriers, _Acks([-1, 160, 150, 450]),
                               acked) == 0
    # rid 2 acknowledged before the barrier at 150 was written
    assert journal.acked_early(records, barriers, _Acks([-1, 160, 140, 450]),
                               acked) == 1
    # rid 3 acknowledged after its second record, before its barrier
    assert journal.acked_early(records, barriers, _Acks([-1, 160, 150, 350]),
                               acked) == 1
    # rid 3 acknowledged before any record of it was written
    assert journal.acked_early(records, barriers, _Acks([-1, 160, 150, 90]),
                               acked) == 1
