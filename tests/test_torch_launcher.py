"""``python -m zeebe_tpu_torch``: the port's standalone node.

Started as ``tests/test_launcher.py`` starts the JAX package's node: the
Dockerfile's argument vector with the repo's ``dist`` config and the
compose file's environment names. With ``[engine] type = "host"`` it
serves the order process to the port's ``ClusterClient`` and stops on
SIGTERM with exit code 0; with ``ZEEBE_ENGINE_TYPE=cuda`` on a host
without a card it stops before it serves, naming the missing device.
"""

import os
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch
from test_cluster import wait_until
from test_launcher import DIST_CFG, REPO, _await_line, _stop

from zeebe_tpu_torch.gateway.cluster_client import ClusterClient
from zeebe_tpu_torch.models.bpmn.builder import Bpmn
from zeebe_tpu_torch.transport import RemoteAddress


def _port_offset():
    """A port offset whose 26500..26504 + offset * 10 and 9600 + offset * 10
    are free, searched above the offsets tests/test_launcher.py takes
    first, so the two files can run side by side."""
    for off in range(700, 990):
        try:
            for base in (26500, 26501, 26502, 26503, 26504, 9600):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", base + off * 10))
        except OSError:
            continue
        return off
    pytest.skip("no free port block")


def _spawn(tmp_path, port_offset, extra_env=None):
    env = dict(os.environ)
    env.update({
        "ZEEBE_NODE_ID": "node-0",
        "ZEEBE_HOST": "127.0.0.1",
        "ZEEBE_PORT_OFFSET": str(port_offset),
    })
    env.update(extra_env or {})
    proc = subprocess.Popen(
        [sys.executable, "-m", "zeebe_tpu_torch",
         "--config", DIST_CFG, "--data-dir", str(tmp_path / "data")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    )
    proc.captured_lines = []

    def drain():
        for line in proc.stdout:
            proc.captured_lines.append(line)

    threading.Thread(target=drain, daemon=True).start()
    return proc


def test_host_engine_serves_and_stops_on_sigterm(tmp_path):
    proc = _spawn(tmp_path, _port_offset())
    client = None
    try:
        line = _await_line(proc, "zeebe-tpu broker node-0: engine=host")
        host, port = line.split("client=")[1].split()[0].rsplit(":", 1)
        client = ClusterClient([RemoteAddress(host, int(port))], num_partitions=1)
        deadline = time.time() + 60
        while True:  # the node bootstraps its partition after it starts
            try:
                client.deploy_model(
                    Bpmn.create_process("order-process").start_event()
                    .service_task("collect-money", type="payment-service")
                    .end_event().done())
                break
            except Exception:  # noqa: BLE001 - retried until the deadline
                if time.time() > deadline:
                    raise
                time.sleep(0.2)
        done = []
        worker = client.open_job_worker(
            "payment-service", lambda pid, rec: done.append(rec.key) or {})
        for i in range(8):
            client.create_instance("order-process", {"orderId": i})
        assert wait_until(lambda: len(done) == 8, 60), done
        worker.close()
        client.close()
        client = None
        proc.terminate()
        assert proc.wait(timeout=30) == 0
        time.sleep(0.2)  # let the drain thread catch the tail
        assert any("shutting down" in line for line in proc.captured_lines)
    finally:
        if client is not None:
            client.close()
        _stop([proc])


def test_cuda_engine_without_a_card_exits_before_serving(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = _spawn(tmp_path, _port_offset(), {"ZEEBE_ENGINE_TYPE": "cuda"})
    try:
        rc = proc.wait(timeout=60)
        time.sleep(0.2)
        out = "".join(proc.captured_lines)
        assert rc != 0, out
        assert "no CUDA device on this host" in out
        assert "zeebe-tpu broker" not in out and "gRPC gateway" not in out
    finally:
        _stop([proc])
