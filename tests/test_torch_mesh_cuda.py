"""The sharded tick's kernels on a card: a (1, 8) mesh of one CUDA device
launches both hand kernels inside the shard body, 8 x (5 + 1) a tick, and
its resident blocks and joined compacted outbox equal the unsharded tick.
Imports no JAX (the card's tests compare with the port's own unsharded
tick); skips where there is no card."""

import numpy as np
import pytest
import torch

from gigapaxos_tpu_torch.ops import plane_gather as tpg
from gigapaxos_tpu_torch.ops import tick as pt
from gigapaxos_tpu_torch.parallel import mesh as tmesh
from gigapaxos_tpu_torch.parallel import shard_tick as tstk
from gigapaxos_tpu_torch.paxos import state as pst


@pytest.mark.cuda
def test_shard_body_launches_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    R, G, W, P = 3, 1 << 12, 8, 2
    mesh = tmesh.make_mesh([dev] * 8)
    tick = tstk.make_resident_tick(mesh, -1, 4 * G, 64)
    s = pst.create_groups(pst.init_state(R, G, W, device=dev),
                          np.arange(G), np.ones((G, R), bool))
    u = s
    blocks = tmesh.shard_state(s, mesh)
    rng = np.random.default_rng(0)
    for t in range(3):
        req = np.zeros((R, P, G), np.int32)
        req[0, 0] = 1 + t * G + np.arange(G, dtype=np.int32)
        req[1, 1] = np.where(rng.random(G) < 0.5,
                             (1 << 20) + t * G + np.arange(G), 0)
        ib = pt.TickInbox(torch.from_numpy(req).to(dev),
                          torch.zeros((R, P, G), dtype=torch.bool,
                                      device=dev),
                          torch.ones(R, dtype=torch.bool, device=dev))
        tpg.reset_launches()
        blocks, flats, _ = tick(blocks, tmesh.shard_inbox(ib, mesh))
        got = dict(tpg.launches)
        assert got == {"gather_planes": 8 * 5, "match_planes": 8}, got
        u, uflat = pt.paxos_tick_compact(u, ib, -1, 4 * G, 64)
        co = tstk.join_compact({k: f.cpu().numpy() for k, f in flats.items()},
                               mesh, R, W, G, 4 * G, 64)
        want = pt.unpack_compact(uflat.cpu().numpy(), R, G, 4 * G, 64)
        assert co.n_exec == want.n_exec > 0
        for f, a, b in zip(pt.CompactHostOutbox._fields, co, want):
            assert np.array_equal(a, b), f
    s = tmesh.gather_state(blocks, mesh, dev)
    for f in pst.PaxosState._fields:
        assert torch.equal(getattr(s, f), getattr(u, f)), f
