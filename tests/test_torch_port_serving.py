"""The port's serving tier: the cases of tests/test_serving.py against the
port's own copies of the server and client, the port's ``build_service``
on runs written by either package, one exchange with both packages'
services side by side, and ``python -m custom_alphazero_tpu_torch.serving``
as a process."""

import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from custom_alphazero_tpu_torch import paths
from custom_alphazero_tpu_torch.config import Config, apply_overrides
from custom_alphazero_tpu_torch.io.checkpoint import save_checkpoint
from custom_alphazero_tpu_torch.models.convert import train_state_to_jax
from custom_alphazero_tpu_torch.runtime.train import init_train_state
from custom_alphazero_tpu_torch.serving import (
    InferenceService,
    MicroBatcher,
    ServingClient,
)
from custom_alphazero_tpu_torch.serving.__main__ import build_service

# One intra-op thread per test process, as tests/test_torch_port_misc.py
# sets it: the suite's workers share the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"model.depth": "1", "model.filters": "8", "model.value_hidden": "8",
        "model.compute_dtype": "float32"}


def _toy_evaluate(scale):
    def evaluate(states):
        b = states.shape[0]
        probs = np.tile(
            np.asarray([[0.5, 0.25, 0.25]], np.float32) * scale, (b, 1)
        )
        values = np.full((b,), scale, np.float32)
        return probs, values

    return evaluate


@pytest.fixture()
def service():
    holder = {"scale": 1.0}

    def reload_model():
        holder["scale"] = 2.0
        return _toy_evaluate(2.0)

    svc = InferenceService(
        _toy_evaluate(1.0),
        port=0,
        inference_batch_size=4,
        inference_timeout=0.2,
        reload_model=reload_model,
    ).start()
    yield svc
    svc.stop()


def test_run_id_and_queue_roundtrip(service):
    client = ServingClient(service.host, service.port)
    assert client.get_run_id() == service.run_id

    states = np.zeros((3, 2, 2), np.float32)
    policies = np.eye(3, dtype=np.float32)
    values = np.asarray([1.0, -1.0, 0.0], np.float32)
    assert client.append_queue(states, policies, values) == 3
    assert client.get_queue_size() == 3

    s, p, v = client.retrieve_queue()
    np.testing.assert_array_equal(s, states)
    np.testing.assert_array_equal(p, policies)
    np.testing.assert_array_equal(v, values)
    # Drain-all semantics.
    assert client.get_queue_size() == 0
    s2, _, _ = client.retrieve_queue()
    assert len(s2) == 0


def test_queue_capacity_bounded():
    svc = InferenceService(_toy_evaluate(1.0), port=0,
                           queue_capacity=5).start()
    try:
        client = ServingClient(svc.host, svc.port)
        client.append_queue(
            np.zeros((8, 1), np.float32),
            np.arange(8, dtype=np.float32)[:, None],
            np.arange(8, dtype=np.float32),
        )
        assert client.get_queue_size() == 5
        _, _, v = client.retrieve_queue()
        # FIFO eviction kept the newest 5.
        np.testing.assert_array_equal(v, [3, 4, 5, 6, 7])
    finally:
        svc.stop()


def test_inference_single_and_batch(service):
    client = ServingClient(service.host, service.port)
    probs, value = client.infer_sample(np.zeros((2, 2), np.float32))
    np.testing.assert_allclose(probs, [0.5, 0.25, 0.25])
    assert value == 1.0
    out = client._call(
        "inference", {"states": np.zeros((4, 2, 2), np.float32).tolist()}
    )
    assert np.asarray(out["probabilities"]).shape == (4, 3)
    assert out["values"] == [1.0] * 4


def test_inference_microbatching_coalesces():
    """batch_size concurrent requests are served by one batched forward."""
    calls = []

    def evaluate(states):
        calls.append(states.shape[0])
        b = states.shape[0]
        return np.ones((b, 3), np.float32) / 3, np.zeros((b,), np.float32)

    svc = InferenceService(
        evaluate, port=0, inference_batch_size=4, inference_timeout=2.0
    ).start()
    try:
        client = ServingClient(svc.host, svc.port, timeout=10.0)
        results = []

        def one(i):
            results.append(client.infer_sample(np.full((2, 2), i,
                                                       np.float32)))

        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert len(results) == 4
        assert calls == [4]  # exactly one coalesced forward
    finally:
        svc.stop()


def test_microbatcher_timeout_flushes_partial():
    batcher = MicroBatcher(_toy_evaluate(1.0), batch_size=8, timeout=0.05)
    probs, value = batcher.infer(np.zeros((2, 2), np.float32))
    np.testing.assert_allclose(probs, [0.5, 0.25, 0.25])
    assert value == 1.0


def test_best_model_update_swaps_evaluator(service):
    client = ServingClient(service.host, service.port)
    _, v1 = client.infer_sample(np.zeros((2, 2), np.float32))
    assert v1 == 1.0
    assert client.update_best_model() is True
    _, v2 = client.infer_sample(np.zeros((2, 2), np.float32))
    assert v2 == 2.0


def test_client_fallbacks_on_dead_server():
    client = ServingClient("127.0.0.1", 1, timeout=0.2)  # nothing listens
    assert client.get_run_id() is None
    probs, value = client.infer_sample(np.zeros((2, 2)), num_actions=3)
    np.testing.assert_array_equal(probs, np.zeros(3))
    assert value == 0.0
    assert client.retrieve_queue() is None
    assert client.update_best_model() is False


def test_many_clients_connect_at_once():
    """32 clients at once are all answered, none by the client's fallback:
    the port's server keeps 128 pending connections where JAX's keeps
    socketserver's 5 (its clients then wait out one-second retries, or are
    reset)."""
    from custom_alphazero_tpu.serving.server import (
        InferenceService as JaxInferenceService,
    )

    svc = InferenceService(_toy_evaluate(1.0), port=0,
                           inference_batch_size=8).start()
    jax_svc = JaxInferenceService(_toy_evaluate(1.0), port=0)
    try:
        assert svc._httpd.request_queue_size == 128
        assert jax_svc._httpd.request_queue_size == 5
        client = ServingClient(svc.host, svc.port, timeout=10.0)
        results = [None] * 32
        barrier = threading.Barrier(32)

        def one(i):
            barrier.wait()
            results[i] = client.infer_sample(np.zeros((2, 2), np.float32))

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert all(r[0].shape == (3,) and r[1] == 1.0 for r in results)
    finally:
        svc.stop()
        jax_svc._httpd.server_close()


def _jax_run(tmp_path, run_id, step):
    """A JAX-written lineage checkpoint ``evaluation/iteration_{step}`` of a
    tiny float32 net; returns (JAX config, JAX net, its train state)."""
    import jax

    from custom_alphazero_tpu import config as jax_config
    from custom_alphazero_tpu import paths as jax_paths
    from custom_alphazero_tpu.io.checkpoint import save_checkpoint as jsave
    from custom_alphazero_tpu.models.policy_value import PolicyValueNet
    from custom_alphazero_tpu.runtime.loop import make_env
    from custom_alphazero_tpu.runtime.train import (
        init_train_state as jax_init,
    )

    cfg = jax_config.apply_overrides(jax_config.Config(), {
        "run.results_dir": str(tmp_path), "run.run_id": run_id, **TINY})
    env = make_env(cfg)
    net = PolicyValueNet(env.num_actions, cfg.model)
    state = jax_init(net, cfg.model, jax.random.PRNGKey(step), env.obs_shape)
    jsave(jax_paths.evaluation_iteration_path(str(tmp_path), cfg.game,
                                              run_id, step), state, 1e-2)
    return cfg, net, state


def _port_cfg(tmp_path, run_id, **extra):
    return apply_overrides(Config(), {
        "run.results_dir": str(tmp_path), "run.run_id": run_id, **TINY,
        **extra})


def test_serving_main_serves_checkpointed_model(tmp_path, capsys):
    """``build_service(device="cpu")`` loads the newest lineage checkpoint
    that the JAX package wrote and serves it; ``best-model/update`` builds
    a new net from a newer one."""
    import jax
    import jax.numpy as jnp

    _, net, state = _jax_run(tmp_path, "serve-test", 50)
    svc = build_service(_port_cfg(tmp_path, "serve-test"), host="127.0.0.1",
                        port=0, batch_size=1, device="cpu").start()
    try:
        assert "Serving best model from iteration 50" in capsys.readouterr().out
        client = ServingClient(svc.host, svc.port)
        assert client.get_run_id() == "serve-test"
        rng = np.random.default_rng(0)
        obs = rng.integers(0, 2, (6, 7, 4)).astype(np.float32)
        probs, value = client.infer_sample(obs)
        assert probs.shape == (7,)
        np.testing.assert_allclose(probs.sum(), 1.0, rtol=1e-5)
        logits, v = net.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            jnp.asarray(obs)[None], train=False)
        np.testing.assert_allclose(
            probs, np.asarray(jax.nn.softmax(logits))[0], rtol=1e-5,
            atol=1e-6)
        assert abs(value - float(v[0])) < 1e-5
        old_forward = svc.batcher._evaluate
        _, newer, newer_state = _jax_run(tmp_path, "serve-test", 60)
        assert client.update_best_model() is True
        assert "iteration 60" in capsys.readouterr().out
        assert svc.batcher._evaluate is not old_forward
        probs2, _ = client.infer_sample(obs)
        logits2, _ = newer.apply(
            {"params": newer_state.params,
             "batch_stats": newer_state.batch_stats},
            jnp.asarray(obs)[None], train=False)
        np.testing.assert_allclose(
            probs2, np.asarray(jax.nn.softmax(logits2))[0], rtol=1e-5,
            atol=1e-6)
        # The earlier net still answers as it did: it was not overwritten.
        np.testing.assert_allclose(old_forward(obs[None])[0][0], probs,
                                   atol=1e-6)
    finally:
        svc.stop()


def test_both_packages_answer_one_exchange_alike(tmp_path):
    """The JAX service and the port's on the same JAX-written run: equal
    JSON for run-id and the queue, and float32 probabilities and values
    within 1e-5."""
    from custom_alphazero_tpu.serving.__main__ import (
        build_service as jax_build_service,
    )

    jcfg, _, _ = _jax_run(tmp_path, "both", 7)
    services = [
        jax_build_service(jcfg, host="127.0.0.1", port=0, batch_size=2),
        build_service(_port_cfg(tmp_path, "both"), host="127.0.0.1", port=0,
                      batch_size=2, device="cpu"),
    ]
    rng = np.random.default_rng(1)
    states = rng.integers(0, 2, (5, 6, 7, 4)).astype(np.float32)
    queue = {"states": states[:3].tolist(),
             "policies": np.eye(7, dtype=np.float32)[:3].tolist(),
             "values": [1.0, -1.0, 0.5]}
    replies = []
    try:
        for svc in services:
            svc.start()
            client = ServingClient(svc.host, svc.port)
            got = {
                "run-id": client._call("run-id", method="GET"),
                "append": client._call("queue/append", queue),
                "size": client._call("queue/size", method="GET"),
                "retrieve": client._call("queue/retrieve"),
                "batch": client._call("inference",
                                      {"states": states.tolist()}),
                "single": [client.infer_sample(s) for s in states[:2]],
            }
            replies.append(got)
    finally:
        for svc in services:
            svc.stop()
    jax_reply, port_reply = replies
    for key in ("run-id", "append", "size", "retrieve"):
        assert port_reply[key] == jax_reply[key], key
    for key in ("probabilities", "values"):
        np.testing.assert_allclose(port_reply["batch"][key],
                                   jax_reply["batch"][key], atol=1e-5)
    for (p, v), (jp, jv) in zip(port_reply["single"], jax_reply["single"]):
        np.testing.assert_allclose(p, jp, atol=1e-5)
        assert abs(v - jv) < 1e-5


def test_serving_port_checkpoint_and_random_init(tmp_path, capsys):
    """A training checkpoint that the port wrote is served when no lineage
    exists; an empty run serves a random init (torch's stream) and warns."""
    cfg = _port_cfg(tmp_path, "port-run")
    state = init_train_state(7, cfg.model, torch.Generator().manual_seed(4),
                             (6, 7, 4), device="cpu")
    save_checkpoint(paths.training_path(str(tmp_path), "connect_n",
                                        "port-run"),
                    train_state_to_jax(state, cfg.model), 1e-2)
    obs = np.zeros((1, 6, 7, 4), np.float32)
    svc = build_service(cfg, host="127.0.0.1", port=0, device="cpu").start()
    assert "Serving last training checkpoint" in capsys.readouterr().out
    with torch.inference_mode():
        logits, value = state.net(torch.from_numpy(obs))
    probs, values = svc.batcher._evaluate(obs)
    np.testing.assert_allclose(probs, torch.softmax(logits, -1).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(values, value.numpy(), atol=1e-6)
    svc.stop()

    empty = build_service(_port_cfg(tmp_path, "empty"), host="127.0.0.1",
                          port=0, device="cpu").start()
    assert "WARNING: no checkpoint found" in capsys.readouterr().out
    probs, values = empty.batcher._evaluate(obs)
    assert probs.shape == (1, 7) and np.isfinite(values).all()
    empty.stop()


def test_serving_module_runs_as_a_process(tmp_path):
    """``python -m custom_alphazero_tpu_torch.serving --device=cpu
    --serving.port=0``: the printed line carries the bound port, requests
    are answered, and SIGINT ends it with exit code 0."""
    _jax_run(tmp_path, "proc", 3)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "custom_alphazero_tpu_torch.serving",
         f"--run.results_dir={tmp_path}", "--run.run_id=proc",
         "--model.depth=1", "--model.filters=8", "--model.value_hidden=8",
         "--serving.port=0", "--serving.host=127.0.0.1", "--device=cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, text=True)
    try:
        lines = [proc.stdout.readline(), proc.stdout.readline()]
        assert lines[0].startswith("Serving best model from iteration 3")
        assert lines[1].startswith("Serving run proc on http://127.0.0.1:")
        port = int(lines[1].rsplit(":", 1)[1].split("/")[0])
        assert port > 0
        client = ServingClient("127.0.0.1", port)
        assert client.get_run_id() == "proc"
        probs, _ = client.infer_sample(np.zeros((6, 7, 4), np.float32))
        assert probs.shape == (7,)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
