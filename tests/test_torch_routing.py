"""The port's routing decisions (``defuse_tpu_torch.pipeline.routing``,
``ops.verify_batch.verify_cost_model``, ``core.devices.link_profile``)
against ``defuse_tpu``'s, run as ``tests/test_routing.py`` runs the
reference: with the reference's constants put into the port's modules,
every decision and the table equal the reference's at both of its link
points; with the port's own constants (the card's), the crossover at a
slow link and the link override."""

import numpy as np
import pytest

from defuse_tpu.ops import verify_batch as jax_verify
from defuse_tpu.pipeline import routing as jax_routing
from defuse_tpu_torch.core import devices
from defuse_tpu_torch.ops import verify_batch
from defuse_tpu_torch.pipeline import routing

ROUTING_CONSTANTS = ("SCREEN_DEVICE_READS_S", "SCREEN_HOST_READS_S_PER_CORE",
                     "EM_NATIVE_ROWS_S", "EM_DEVICE_COMPUTE_ROWS_S",
                     "EM_UPLOAD_BYTES_PER_ROW", "EM_SLAB_ROWS")
VERIFY_CONSTANTS = ("DEVICE_LANES_S", "HOST_CANDIDATES_S")
SLOW = {"bw_MBps": 1.0, "rtt_ms": 100.0}


@pytest.fixture
def reference_constants(monkeypatch):
    for name in ROUTING_CONSTANTS:
        monkeypatch.setattr(routing, name, getattr(jax_routing, name))
    for name in VERIFY_CONSTANTS:
        monkeypatch.setattr(verify_batch, name, getattr(jax_verify, name))


def seeded_shapes(seed):
    rng = np.random.default_rng(seed)
    return dict(screen_candidates=int(rng.integers(1, 2_000_000)),
                read_pad_len=int(rng.choice([64, 128, 192, 256])),
                verify_candidates=int(rng.integers(1, 4_000_000)),
                verify_reads=int(rng.integers(1, 400_000)),
                verify_read_len=int(rng.integers(20, 251)),
                em_rows=int(rng.integers(1, 40_000)),
                ncpu=int(rng.integers(1, 65)))


@pytest.mark.parametrize("seed", range(8))
def test_decisions_equal_the_reference_at_its_constants(reference_constants,
                                                        seed):
    s = seeded_shapes(seed)
    for link in jax_routing.LINK_POINTS.values():
        assert routing.screen_decision(
            s["screen_candidates"], s["read_pad_len"], link, s["ncpu"]) == \
            jax_routing.screen_decision(
                s["screen_candidates"], s["read_pad_len"], link, s["ncpu"])
        verify = (s["verify_candidates"], s["verify_reads"],
                  s["verify_read_len"], link)
        assert routing.verify_decision(*verify) == \
            jax_routing.verify_decision(*verify)
        assert verify_batch.verify_cost_model(*verify) == \
            jax_verify.verify_cost_model(*verify)
        assert routing.em_decision(s["em_rows"], link) == \
            jax_routing.em_decision(s["em_rows"], link)
    assert routing.routing_table(links=jax_routing.LINK_POINTS, **s) == \
        jax_routing.routing_table(links=jax_routing.LINK_POINTS, **s)


def test_constants_are_the_cards():
    """No rate or link figure of the reference's TPU, host or tunnel is
    the port's: each was measured on the card."""
    for name in ROUTING_CONSTANTS:
        assert getattr(routing, name) != getattr(jax_routing, name), name
    for name in VERIFY_CONSTANTS:
        assert getattr(verify_batch, name) != getattr(jax_verify, name), name
    assert set(routing.LINK_POINTS) == {"h100"}
    for point in jax_routing.LINK_POINTS.values():
        assert point != routing.LINK_POINTS["h100"]


def test_slow_link_keeps_screen_and_verify_on_the_host():
    """At 1 MB/s and 100 ms the link alone outweighs the host's work at the
    bench shapes; at every point each choice is the lower estimate."""
    table = routing.routing_table(links={"slow": SLOW,
                                         **routing.LINK_POINTS})
    assert table["slow"]["screen"]["choice"] == "host"
    assert table["slow"]["verify"]["choice"] == "host"
    assert table["slow"]["em"]["choice"] == "host"
    for point in table.values():
        for stage in ("screen", "verify", "em"):
            d = point[stage]
            assert d["t_dev_s"] > 0 and d["t_host_s"] > 0, (stage, d)
            if d["t_dev_s"] != d["t_host_s"]:
                assert d["choice"] == ("device" if d["t_dev_s"] <
                                       d["t_host_s"] else "host")


def test_card_link_routes_as_measured():
    """At the card's own link and the bench shapes (8 native threads, as on
    the H100's host): the screen on the device, the verify and the EM on
    the host (the numpy oracle, the native EM), the routes that
    ``chip_smoke.py`` phase 14 measured faster on the H100."""
    point = routing.routing_table(ncpu=8)["h100"]
    assert point["link"] == devices.link_profile()
    assert [point[s]["choice"] for s in ("screen", "verify", "em")] == \
        ["device", "host", "host"]


@pytest.mark.parametrize("env,want", [
    ({}, {"bw_MBps": devices.LINK_BW_MBPS, "rtt_ms": devices.LINK_RTT_MS}),
    ({"DEFUSE_LINK_BW": "1000", "DEFUSE_LINK_RTT": "1"},
     {"bw_MBps": 1000.0, "rtt_ms": 1.0, "override": True}),
    ({"DEFUSE_LINK_BW": "250"},
     {"bw_MBps": 250.0, "rtt_ms": devices.LINK_RTT_MS, "override": True})])
def test_link_profile_env_override(monkeypatch, env, want):
    for name in ("DEFUSE_LINK_BW", "DEFUSE_LINK_RTT"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert devices.link_profile() == want


def test_verify_cost_model_reads_the_link_profile(monkeypatch):
    monkeypatch.setenv("DEFUSE_LINK_BW", "1")
    monkeypatch.setenv("DEFUSE_LINK_RTT", "100")
    assert verify_batch.verify_cost_model(262144, 20000, 50) == \
        verify_batch.verify_cost_model(262144, 20000, 50, SLOW)
