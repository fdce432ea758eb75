"""Phase-vocabulary twin: the port's ``obs/phase.py::DRIVER_PHASES`` equals
the reference's for every driver the port has, and every declared phase is
marked in that driver's tick path (the port's copy of the reference's
``tests/test_obs_coverage.py`` check, over the port's drivers)."""

import re
from pathlib import Path

import pytest

from gigapaxos_tpu.obs import phase as jphase
from gigapaxos_tpu_torch.obs import phase as tphase

ROOT = Path(__file__).resolve().parent.parent

DRIVER_FILES = {
    "modea": "gigapaxos_tpu_torch/paxos/manager.py",
    "modeb": "gigapaxos_tpu_torch/modeb/manager.py",
    "chain": "gigapaxos_tpu_torch/chain/manager.py",
    "chain_modeb": "gigapaxos_tpu_torch/chain/modeb.py",
}


def test_port_drivers_are_the_ported_ones():
    assert set(tphase.DRIVER_PHASES) == set(DRIVER_FILES)
    assert tphase.DRIVER_PHASES == jphase.DRIVER_PHASES
    assert tphase.BLOCKING_PHASE == jphase.BLOCKING_PHASE


@pytest.mark.parametrize("driver", sorted(DRIVER_FILES))
def test_driver_phases_equal_the_reference(driver):
    assert tphase.DRIVER_PHASES[driver] == jphase.DRIVER_PHASES[driver]


@pytest.mark.parametrize("driver", sorted(DRIVER_FILES))
def test_every_declared_phase_is_marked_in_its_driver(driver):
    src = (ROOT / DRIVER_FILES[driver]).read_text()
    assert re.search(rf'phase_clock\(\s*"{driver}"', src), driver
    marked = set(re.findall(r'\.mark\(\s*["\']([a-z_]+)["\']', src))
    declared = set(tphase.DRIVER_PHASES[driver])
    assert declared <= marked, declared - marked
    assert marked <= declared | {tphase.BLOCKING_PHASE}, marked - declared
    assert ".begin()" in src and ".end()" in src


def test_clock_pre_creates_the_declared_series():
    from gigapaxos_tpu_torch.obs.metrics import Registry

    pc = tphase.PhaseClock("modeb", plane="twin", reg=Registry())
    assert set(pc._h) == set(jphase.DRIVER_PHASES["modeb"])
