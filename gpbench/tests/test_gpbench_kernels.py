"""The kernels' byte counts: the hand formula on the tick's shapes, held
against the arrays an eager tick really hands the two kernels."""

import numpy as np

from gpbench import kernels as kb


def test_bytes_at_the_deployment_shape():
    R, W, G, P = 3, 8, 1 << 20, 4
    rwg, wg = R * W * G, W * G
    s1 = 2 * (4 * 4 + 1) * rwg + 4 * wg
    s2 = 2 * (2 * 4 + 2) * wg + 4 * wg
    s3 = 2 * (5 * 4 + 2) * rwg + 4 * wg
    s4 = 2 * (4 + 2) * wg + 4 * wg
    s5 = 2 * (2 * 4 + 2) * rwg + 4 * rwg
    assert kb.gather_bytes(R, W, G) == s1 + s2 + s3 + s4 + s5
    e = R * P * G
    assert kb.match_bytes(R, W, G, P) == 5 * e + 4 * e + 4 * wg + 5 * wg
    # the least time at 3.35 TB/s: 0.886 ms of gathers, 0.056 of match
    assert abs(kb.gather_bytes(R, W, G) / 3.35e12 * 1e3 - 0.8864) < 1e-3
    assert abs(kb.match_bytes(R, W, G, P) / 3.35e12 * 1e3 - 0.0563) < 1e-3


def test_peak_bandwidth_by_card_name():
    assert kb.peak_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    assert kb.peak_bandwidth("NVIDIA H100 PCIe") == 2.0e12
    try:
        kb.peak_bandwidth("NVIDIA A100-SXM4-80GB")
    except ValueError:
        pass
    else:
        raise AssertionError("an unknown card must fail")


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


def test_formula_matches_what_the_tick_hands_the_kernels(monkeypatch):
    """Run the eager tick on the CPU with the two kernel entry points
    wrapped, and count each launch's inputs, index and outputs."""
    import torch

    from gigapaxos_tpu_torch.ops import tick as pt
    from gigapaxos_tpu_torch.ops import window
    from gigapaxos_tpu_torch.paxos import state as st

    R, W, G, P = 3, 8, 64, 4
    seen = {"gather": [], "match": []}
    g0, m0 = window.gather_planes_many, window.match_planes_many

    def gather(arrs, idx):
        out = g0(arrs, idx)
        seen["gather"].append(_nbytes(arrs) + _nbytes([idx]) + _nbytes(out))
        return out

    def match(vals, keys, idx):
        out = m0(vals, keys, idx)
        seen["match"].append(_nbytes(vals) + _nbytes([keys, idx])
                             + _nbytes(out))
        return out

    monkeypatch.setattr(window, "gather_planes_many", gather)
    monkeypatch.setattr(window, "match_planes_many", match)
    s = st.create_groups(st.init_state(R, G, W, device="cpu"),
                         np.arange(G), np.ones((G, R), bool))
    req = torch.zeros((R, P, G), dtype=torch.int32)
    req[0, 0, :] = torch.arange(1, G + 1, dtype=torch.int32)
    inbox = pt.TickInbox(req, torch.zeros((R, P, G), dtype=torch.bool),
                         torch.ones(R, dtype=torch.bool))
    pt.paxos_tick_impl(s, inbox, -1, R * G + 4096)
    assert len(seen["gather"]) == kb.GATHERS_PER_TICK
    assert len(seen["match"]) == kb.MATCHES_PER_TICK
    assert sum(seen["gather"]) == kb.gather_bytes(R, W, G)
    assert sum(seen["match"]) == kb.match_bytes(R, W, G, P)
