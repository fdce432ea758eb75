"""Config twin: the port's ``config.py`` against the JAX package's.

Every section's dataclass has the reference's fields, defaults and checks
(the placement and cells sections and the ``cells``/``log_dir``/
``stats_interval_s`` fields included), and the properties loader gives
the same config for the same file and environment: compared as
``dataclasses.asdict``, exactly.
"""

import dataclasses

import pytest

from gigapaxos_tpu import config as jconfig
from gigapaxos_tpu_torch import config as tconfig

SECTIONS = [f.name for f in dataclasses.fields(jconfig.GigapaxosTpuConfig)
            if dataclasses.is_dataclass(getattr(jconfig.GigapaxosTpuConfig(),
                                                f.name))]


def _classes(mod):
    cfg = mod.GigapaxosTpuConfig()
    return {name: type(getattr(cfg, name)) for name in SECTIONS}


def test_every_section_has_the_reference_fields_and_defaults():
    assert [f.name for f in dataclasses.fields(tconfig.GigapaxosTpuConfig)] \
        == [f.name for f in dataclasses.fields(jconfig.GigapaxosTpuConfig)]
    jc, tc = _classes(jconfig), _classes(tconfig)
    for name in SECTIONS:
        jf = [(f.name, f.type) for f in dataclasses.fields(jc[name])]
        tf = [(f.name, f.type) for f in dataclasses.fields(tc[name])]
        assert jf == tf, name
        assert dataclasses.asdict(jc[name]()) == \
            dataclasses.asdict(tc[name]()), name
    assert dataclasses.asdict(jconfig.GigapaxosTpuConfig()) == \
        dataclasses.asdict(tconfig.GigapaxosTpuConfig())


def _value(section, name, default):
    """A non-default value the reference's checks accept for one field."""
    if isinstance(default, bool):
        return not default
    if section == "ssl" and name == "mode":
        return "server_auth"
    if isinstance(default, int):
        if section == "paxos" and name in ("window", "max_groups"):
            return default * 2
        if section == "overload" and name == "intake_lo":
            return 16
        return default + 3 if default >= 0 else 9100
    if isinstance(default, float):
        if name in ("ewma_decay", "client_queue_frac", "read_queue_frac",
                    "retry_fraction", "adaptive_gain"):
            return default / 2
        return default * 2 + 0.5
    return f"/srv/{section}/{name}"


def properties_text():
    """A properties file that names every field of every section, the flat
    keys, the topology and ``universe``."""
    lines = ["# every key", "! a comment", "not a key line", ""]
    cfg = jconfig.GigapaxosTpuConfig()
    for section in SECTIONS:
        if section == "nodes":
            continue
        sub = getattr(cfg, section)
        for f in dataclasses.fields(sub):
            v = _value(section, f.name, getattr(sub, f.name))
            lines.append(f"{section}.{f.name} = "
                         f"{str(v).lower() if isinstance(v, bool) else v}")
    lines += ["log_dir=/var/lib/gptpu", "stats_interval_s=2.5",
              "native_journal=false", "unknown_flat_key=1",
              "paxos.no_such_field=3", "nosection.field=4",
              "active.AR0=127.0.0.1:2100", "active.AR1=10.0.0.2:2101",
              "reconfigurator.RC0=127.0.0.1:3100",
              "reconfigurator.RC1=[::1]:3101",
              "universe=AR1, AR0,AR9"]
    return "\n".join(lines) + "\n"


@pytest.fixture()
def props(tmp_path):
    p = tmp_path / "gigapaxos.properties"
    p.write_text(properties_text())
    return str(p)


def test_load_properties_equals_reference(props, monkeypatch):
    for k in list(__import__("os").environ):
        if k.startswith("GPTPU_"):
            monkeypatch.delenv(k)
    j = jconfig.load_properties(props)
    t = tconfig.load_properties(props)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    # every field moved off its default, and the topology is parsed
    default = dataclasses.asdict(jconfig.GigapaxosTpuConfig())
    got = dataclasses.asdict(t)
    for section in SECTIONS:
        if section == "nodes":
            continue
        for k, v in got[section].items():
            assert v != default[section][k], (section, k)
    assert t.nodes.universe == ["AR1", "AR0", "AR9"]
    assert t.nodes.reconfigurators["RC1"] == ("[::1]", 3101)
    assert t.log_dir == "/var/lib/gptpu" and t.stats_interval_s == 2.5


def test_env_overrides_equal_reference(props, monkeypatch):
    env = {"GPTPU_PAXOS_WINDOW": "32", "GPTPU_PLACEMENT_SKEW_THRESHOLD": "3.5",
           "GPTPU_FD_ADAPTIVE": "yes", "GPTPU_SSL_CERTFILE": "/c.pem",
           "GPTPU_CELLS_N_CELLS": "6", "GPTPU_OBS_HTTP_PORT": "0",
           "GPTPU_OVERLOAD_INTAKE_HI": "99"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j = jconfig.load_properties(props)
    t = tconfig.load_properties(props)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.paxos.window == 32 and t.cells.n_cells == 6
    assert t.placement.skew_threshold == 3.5 and t.fd.adaptive is True
    # apply_env_overrides on a config built in code
    jc, tc = jconfig.GigapaxosTpuConfig(), tconfig.GigapaxosTpuConfig()
    jconfig.apply_env_overrides(jc)
    tconfig.apply_env_overrides(tc)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.obs.http_port == 0 and tc.overload.intake_hi == 99


BAD = [("placement", "ewma_decay", 1.5), ("placement", "ewma_decay", 0.0),
       ("placement", "skew_threshold", 0.5), ("placement", "hysteresis", 0.9),
       ("cells", "n_cells", -1), ("cells", "n_actives", 0),
       ("cells", "n_reconfigurators", 0), ("ssl", "mode", "tls"),
       ("overload", "client_queue_frac", 0.0),
       ("overload", "read_queue_frac", 1.5),
       ("overload", "breaker_threshold", 0)]


@pytest.mark.parametrize("section,name,value", BAD)
def test_validate_raises_on_the_same_bad_values(section, name, value,
                                                monkeypatch, tmp_path):
    for mod in (jconfig, tconfig):
        cfg = mod.GigapaxosTpuConfig()
        setattr(getattr(cfg, section), name, value)
        with pytest.raises(ValueError):
            mod.validate(cfg)
        with pytest.raises(ValueError):
            getattr(mod, type(getattr(cfg, section)).__name__)(
                **{name: value})
    # and through the loader, by file and by environment
    p = tmp_path / "bad.properties"
    p.write_text(f"{section}.{name}={value}\n")
    for mod in (jconfig, tconfig):
        with pytest.raises(ValueError):
            mod.load_properties(str(p))
    monkeypatch.setenv(f"GPTPU_{section.upper()}_{name.upper()}", str(value))
    for mod in (jconfig, tconfig):
        with pytest.raises(ValueError):
            mod.apply_env_overrides(mod.GigapaxosTpuConfig())


def test_managers_still_refuse_placement():
    from gigapaxos_tpu_torch.models.replicable import KVApp
    from gigapaxos_tpu_torch.paxos.manager import PaxosManager

    cfg = tconfig.GigapaxosTpuConfig()
    cfg.paxos.max_groups = 8
    cfg.placement.enabled = True
    with pytest.raises(NotImplementedError, match="placement"):
        PaxosManager(cfg, 3, [KVApp() for _ in range(3)], device="cpu")
