"""The port's runtime entry: ``load_config`` and ``engine_factory_from_config``.

``zeebe_tpu_torch/runtime/config.py`` is a copy of the JAX package's (pinned
by ``tests/test_torch_isolation.py``); here the shipped ``dist`` config
loads to the same fields under both packages, environment overrides
included. The engine factory serves ``"host"`` with the brokers' oracle and
``"cuda"`` with ``CudaPartitionEngine`` (``device="cpu"`` here), and refuses
every configuration the port does not run. The empty wave that warms an
engine on the card changes no table, on a fresh engine and on one serving.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from zeebe_tpu.runtime.config import load_config as jax_load_config

from zeebe_tpu_torch.engine.interpreter import WorkflowRepository
from zeebe_tpu_torch.runtime.config import BrokerCfg, load_config
from zeebe_tpu_torch.runtime.engines import engine_factory_from_config
from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIST_CFG = os.path.join(REPO, "dist", "zeebe.cfg.toml")


@pytest.mark.parametrize("env", [
    {},
    {"ZEEBE_ENGINE_TYPE": "cuda", "ZEEBE_NODE_ID": "n-7", "ZEEBE_PORT_OFFSET": "3"},
])
def test_load_config_of_the_dist_file_equals_the_jax_package(env):
    port = load_config(DIST_CFG, env=env)
    ref = jax_load_config(DIST_CFG, env=env)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    if env:
        assert port.engine.type == "cuda" and port.network.client_port == 26531


def _cfg(**engine):
    cfg = BrokerCfg()
    cfg.cluster.partitions = 2
    for name, value in engine.items():
        section, field = name.split("__")
        setattr(getattr(cfg, section), field, value)
    return cfg


def _broker(cfg):
    """What the factory reads of a ``ClusterBroker``."""
    return types.SimpleNamespace(
        cfg=cfg, repository=WorkflowRepository(), clock=lambda: 5,
        planned_device=lambda pid: pytest.fail("device='cpu' skips the plan"),
    )


def test_host_is_the_brokers_oracle():
    assert engine_factory_from_config(_cfg(engine__type="host")) is None
    assert engine_factory_from_config(_cfg(engine__type="HOST"), device="cpu") is None


def test_cuda_builds_the_cuda_engine_with_the_config_sizes():
    cfg = _cfg(engine__type="cuda", engine__capacity=256, engine__num_vars=8,
               engine__sub_capacity=4)
    factory = engine_factory_from_config(cfg, device="cpu")
    broker = _broker(cfg)
    engine = factory(1, broker)
    assert isinstance(engine, CudaPartitionEngine)
    assert engine.device == torch.device("cpu")
    assert (engine.partition_id, engine.num_partitions) == (1, 2)
    assert engine.repository is broker.repository and engine.clock() == 5
    assert (engine.capacity, engine.num_vars) == (256, 8)
    assert engine.state.job_key.shape[0] == 256


def test_a_config_without_an_engine_section_serves_on_the_card(tmp_path):
    """The port's default engine is the CUDA one: only an explicit
    ``type = "host"`` picks the oracle."""
    path = tmp_path / "node.toml"
    path.write_text('[cluster]\nnodeId = "n-1"\npartitions = 2\n')
    cfg = load_config(str(path), env={})
    assert cfg.engine.type == BrokerCfg().engine.type == "cuda"
    factory = engine_factory_from_config(cfg, device="cpu")
    assert isinstance(factory(0, _broker(cfg)), CudaPartitionEngine)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine_factory_from_config(cfg)


def test_cuda_without_a_card_raises_when_the_factory_is_built():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine_factory_from_config(_cfg(engine__type="cuda"))


@pytest.mark.parametrize("fields, match", [
    ({"engine__type": "tpu"}, "JAX package"),
    ({"engine__type": "gpu"}, "unknown engine type"),
    # the mesh is ported: what is refused is a span wider than the plan's
    # cards and an unknown routing mode
    ({"engine__type": "cuda", "mesh__sharded_partitions": 2, "mesh__devices": 1},
     "shardedPartitions"),
    ({"engine__type": "cuda", "mesh__routing": "telepathic"}, "routing"),
])
def test_what_the_port_does_not_run_raises(fields, match):
    with pytest.raises(ValueError, match=match):
        engine_factory_from_config(_cfg(**fields), device="cpu")


def _warm_probe(engine):
    """What an empty wave must leave as it was: every table, the snapshot
    (interns, variable columns, the host oracle's state) and the message
    store's side."""
    from zeebe_tpu_torch.log import stateser
    from zeebe_tpu_torch.tpu.state import state_to_numpy

    return (state_to_numpy(engine.state), stateser.encode_state(engine.snapshot_state()),
            engine._messages_on_device, engine.graph is None)


def _assert_warm_changes_nothing(engine):
    tables, snap, side, no_graph = _warm_probe(engine)
    engine.warm()
    tables2, snap2, side2, no_graph2 = _warm_probe(engine)
    assert tables2.keys() == tables.keys()
    for name, table in tables.items():
        assert np.array_equal(tables2[name], table), name
    assert (snap2, side2, no_graph2) == (snap, side, no_graph)


def test_warm_on_a_fresh_engine_changes_nothing():
    """The factory warms an engine on the card before anything is deployed;
    here on the CPU the same empty wave, through an empty graph."""
    engine = CudaPartitionEngine(0, 1, capacity=64, device="cpu")
    _assert_warm_changes_nothing(engine)
    assert engine.graph is None and engine.host_only_reasons == {}


def test_warm_on_a_serving_engine_changes_nothing(tmp_path):
    """On an engine holding open jobs, stored messages on the device and
    message subscriptions, an empty wave moves no key counter, free list,
    timer or store."""
    import zeebe_tpu_torch.gateway as port_gateway
    import zeebe_tpu_torch.runtime as port_runtime
    from zeebe_tpu_torch.models.bpmn.builder import Bpmn

    clock = port_runtime.ControlledClock(start_ms=1_000_000)
    repo = WorkflowRepository()
    broker = port_runtime.Broker(
        num_partitions=1, clock=clock, data_dir=str(tmp_path),
        engine_factory=lambda pid: CudaPartitionEngine(
            pid, 1, repository=repo, clock=clock, capacity=64, device="cpu"),
    )
    try:
        client = port_gateway.ZeebeClient(broker)
        client.deploy_model(
            Bpmn.create_process("order").start_event("start")
            .service_task("pay", type="payment-service").end_event("end").done())
        client.deploy_model(
            Bpmn.create_process("msgflow").start_event("start")
            .receive_task("wait", message_name="paid", correlation_key="$.oid")
            .end_event("done").done())
        for i in range(3):
            client.create_instance("order", {"orderId": i})
            client.create_instance("msgflow", {"oid": f"o-{i}"})
        client.publish_message("paid", "stored", {"n": 1}, time_to_live_ms=600_000)
        broker.run_until_idle()
        engine = broker.partitions[0].engine
        assert engine._messages_on_device and engine.device_records_processed > 0
        _assert_warm_changes_nothing(engine)
    finally:
        broker.close()
