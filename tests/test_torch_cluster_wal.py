"""Durable twin of the control plane: a cluster on ``wal_dir`` /
``rc_wal_dir`` is closed and its directories reopened, in the same package
and across packages (the port recovers the reference's directories and the
reference the port's, byte-equal journals): both recover the same answers
and app states, and every acked write reads back.
"""

import shutil

import pytest

from test_torch_cluster import PKGS, make_cfg


def _durable_cluster(pkg, wal_dir, rc_wal_dir):
    cfg_cls, kv, cluster_cls, client_cls, _, _, kw = PKGS[pkg]
    cfg = make_cfg(cfg_cls)
    cfg.native_journal = False
    cl = cluster_cls(cfg, kv, wal_dir=str(wal_dir), rc_wal_dir=str(rc_wal_dir),
                     **kw)
    return cl, client_cls(cl.cfg.nodes)


def _reopen_and_read(pkg, wal, rc_wal, keys):
    cl, c = _durable_cluster(pkg, wal, rc_wal)
    try:
        got = {(n, k): c.request(n, f"GET {k}".encode()) for n, k in keys}
        actives = sorted(c.request_actives("d0", force=True))
        with pytest.raises(PKGS[pkg][4]):
            c.request_actives("d3", force=True)
        assert c.request("d1", b"PUT k9 late") == b"OK"
        assert c.create("d4")["ok"]
        apps = [dict(app.db) for app in cl.manager.apps]
    finally:
        c.close()
        cl.close()
    return got, actives, apps


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_durable_reopen_serves_every_acked_write(tmp_path, writer):
    """Reopen ``writer``'s WAL directories in both packages (the reference
    on a copy).  Both recover the same answers and app states.  Every
    acked write of a name that was never reconfigured reads back, as does
    every write acked after the reconfiguration.  A write acked before a
    reconfiguration reads back as ``NF`` after recovery in both packages:
    the new epoch's seed (the final-state transfer) is not journaled (a
    reference fault the port reproduces)."""
    wal, rc_wal = tmp_path / "ar", tmp_path / "rc"
    cl, c = _durable_cluster(writer, wal, rc_wal)
    acked = {}
    try:
        assert c.create_batch([f"d{i}" for i in range(4)])["ok"]
        for i in range(4):
            for j in range(2):
                if c.request(f"d{i}", f"PUT k{j} v{i}{j}".encode()) == b"OK":
                    acked[(f"d{i}", f"k{j}")] = f"v{i}{j}".encode()
        old = sorted(c.request_actives("d0"))
        new = sorted(set(cl.cfg.nodes.active_ids()) - set(old))[:2] + old[:1]
        assert c.reconfigure("d0", new)["ok"]
        assert c.request("d0", b"GET k1") == b"v01"
        assert c.request("d0", b"PUT after reconf") == b"OK"
        acked[("d0", "after")] = b"reconf"
        assert c.delete("d3")["ok"]
        for j in range(2):
            acked.pop(("d3", f"k{j}"))
    finally:
        c.close()
        cl.close()
    assert len(acked) == 7
    shutil.copytree(tmp_path, tmp_path.parent / f"{tmp_path.name}_ref")
    ref_dir = tmp_path.parent / f"{tmp_path.name}_ref"
    ref = _reopen_and_read("ref", ref_dir / "ar", ref_dir / "rc", acked)
    port = _reopen_and_read("port", wal, rc_wal, acked)
    assert port == ref
    got, actives, _ = port
    assert actives == sorted(new)
    for (name, key), val in acked.items():
        if name != "d0" or key == "after":
            assert got[(name, key)] == val
        else:
            assert got[(name, key)] == b"NF"
