"""``ModeBServer`` twin, continued: the migrate and coordinator-death
cases of the reference's ``tests/test_modeb_control_plane.py`` on six
servers of each package (3 actives, 3 reconfigurators, 32 rows a plane),
on the CPU, with the deployment and the scenarios of
``tests/test_torch_server.py``.

Tolerance: 0.  Every response equals the reference's, and so does every
member's app checkpoint of the name once it settles.
"""

import pytest
import torch

from tests.test_torch_server import (ACTIVES, run_scenarios, same,
                                     sc_coordinator_death, sc_migrate)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def results():
    return run_scenarios([("paxos", [sc_migrate, sc_coordinator_death])])


def test_migrate_preserves_state_across_processes(results):
    r = same(results, "sc_migrate")
    assert r[:7] == [True, b"OK", True, b"amherst", True, b"amherst", b"OK"]
    assert set(r[7]) == set(ACTIVES)


def test_coordinator_process_death_fd_failover(results):
    r = same(results, "sc_coordinator_death")
    assert r[1] == b"OK" and r[3] == b"OK" and r[4] == b"1"
