"""Peer checkpoint streaming during recovery, twin of the reference's
``tests/test_peer_stream.py``: a restarting node fetches checkpoint blobs
from its peers while its journal replays, and adopts them through the
watermark-checked transfer path.

Each case runs on a three-node ``test_torch_modeb.Twin`` with a journal on
every node; the crashed node recovers in both packages with a
``PeerCheckpointStreamer`` over its own package's donors.  The streamers'
counts, the recovered nodes (state, apps, transfer counts) and every
journal file must be equal.  The case with two groups uses one worker
thread, so that both packages adopt (and journal) the blobs in the same
order.
"""

import pytest
import torch

from gigapaxos_tpu.modeb import PeerCheckpointStreamer as JStreamer
from gigapaxos_tpu_torch.modeb import PeerCheckpointStreamer as TStreamer
from test_torch_modeb import Twin, assert_same_node, make_cfgs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _streamers(tw, donors, window):
    return (JStreamer({n: tw.j[n].donate_ckpt for n in donors},
                      window=window),
            TStreamer({n: tw.t[n].donate_ckpt for n in donors},
                      window=window))


def _recover(tw, streams):
    node = tw.recover("N0", peer_streams=streams, sync=False)
    assert streams[0].stats == streams[1].stats
    assert_same_node(tw.j["N0"], node)
    tw.check_wal()
    return node


def test_peer_stream_recovers_missed_writes(tmp_path):
    tw = Twin(make_cfgs(), wal_root=tmp_path)
    tw.create("svc")
    tw.create("svc2")
    tw.commit("N0", "svc", b"PUT a 1")
    tw.commit("N0", "svc2", b"PUT x 9")
    tw.kill("N0")
    tw.drop_backlog("N0")
    for i in range(4):
        tw.commit("N1", "svc", f"PUT b{i} v{i}".encode(),
                  only={"N1", "N2"})
    tw.commit("N1", "svc2", b"PUT y 10", only={"N1", "N2"})
    streams = _streamers(tw, ("N1", "N2"), window=1)
    node = _recover(tw, streams)
    ps = streams[1]
    # both rows were fetched and adopted (replay alone could not know the
    # writes committed while the node was dead)
    assert ps.stats["fetched"] == 2
    assert ps.stats["applied"] == 2
    assert node.stats["ckpt_transfers"] == 2
    db = tw.tapps["N0"].db
    for i in range(4):
        assert db["svc"].get(f"b{i}") == f"v{i}"
    assert db["svc2"].get("y") == "10"
    tw.cross_recover("N0", tmp_path / "cross")


def test_peer_stream_stale_blobs_dropped(tmp_path):
    """A node that crashed with a complete journal replays to the donors'
    watermark: every streamed blob is stale and dropped."""
    tw = Twin(make_cfgs(), wal_root=tmp_path)
    tw.create("svc")
    tw.commit("N0", "svc", b"PUT a 1")
    tw.commit("N0", "svc", b"PUT b 2")
    tw.spin(4)
    tw.kill("N0")
    tw.drop_backlog("N0")
    streams = _streamers(tw, ("N1", "N2"), window=2)
    node = _recover(tw, streams)
    ps = streams[1]
    assert ps.stats["fetched"] == 1
    assert ps.stats["applied"] == 0
    assert ps.stats["stale"] == 1
    assert node.stats["ckpt_transfers"] == 0
    assert tw.tapps["N0"].db["svc"] == {"a": "1", "b": "2"}
    tw.cross_recover("N0", tmp_path / "cross")


def test_peer_stream_donor_failover(tmp_path):
    """A refusing donor (its fetch raises) rotates to the next one instead
    of starving the stream."""
    tw = Twin(make_cfgs(), wal_root=tmp_path)
    tw.create("svc")
    tw.commit("N0", "svc", b"PUT a 1")
    tw.kill("N0")
    tw.drop_backlog("N0")
    tw.commit("N1", "svc", b"PUT c 3", only={"N1", "N2"})

    def broken(gid):
        raise RuntimeError("donor down")

    streams = (JStreamer({"N1": broken, "N2": tw.j["N2"].donate_ckpt},
                         window=2),
               TStreamer({"N1": broken, "N2": tw.t["N2"].donate_ckpt},
                         window=2))
    _recover(tw, streams)
    assert streams[1].stats["fetched"] == 1
    assert streams[1].stats["applied"] == 1
    assert tw.tapps["N0"].db["svc"].get("c") == "3"
    tw.cross_recover("N0", tmp_path / "cross")
