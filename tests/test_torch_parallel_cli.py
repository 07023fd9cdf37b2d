"""The port's multi-process entry points on gloo ranks on the CPU: two OS
processes joined through torchrun's environment variables (the
counterpart of ``tests/test_multihost.py``), and ``cli/scaling_bench.py``
on 1 and 2 ranks with its JSON layout and chaos control.  The training
CLI over several ranks and the dry run's ranks run in
``tests/test_torch_parallel.py``'s group of 4."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from ml_audio_inpainting_torch.cli import scaling_bench
from torch_threads import one_thread  # noqa: F401  (a module fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


WORKER = textwrap.dedent(
    """
    import json, sys
    import torch
    torch.set_num_threads(1)
    from ml_audio_inpainting_torch.parallel.dryrun import tiny_cnn_config
    from ml_audio_inpainting_torch.parallel.mesh import initialize_distributed, make_mesh, shard_batch
    from ml_audio_inpainting_torch.parallel.sharding import make_sharded_step, place_state
    from ml_audio_inpainting_torch.train.cnn_trainer import create_cnn_state, make_cnn_train_step
    from ml_audio_inpainting_torch.train.recipe import live_bilstm
    from ml_audio_inpainting_torch.weights import cnn_blstm_flat_variables

    device = initialize_distributed("cpu")
    mesh = make_mesh(device=device)
    cfg = tiny_cnn_config()
    fresh = create_cnn_state(cfg, device=device, seed=0).model.state_dict()
    state = create_cnn_state(cfg, device=device,
                             params=live_bilstm(cnn_blstm_flat_variables(fresh), seed=1))
    step = make_sharded_step(make_cnn_train_step(cfg), state, mesh)
    place_state(state, mesh)
    gen = torch.Generator().manual_seed(7)
    audio = 0.1 * torch.randn(4, cfg.data.max_samples, generator=gen)
    starts = torch.randint(0, cfg.data.max_samples - 800, (4, 2), generator=gen)
    state, m = step(state, *shard_batch((audio, starts), mesh))
    checksum = sum(p.detach().double().abs().sum().item() for p in state.model.parameters())
    print(json.dumps({"rank": torch.distributed.get_rank(), "mesh": mesh.shape,
                      "backend": torch.distributed.get_backend(),
                      "loss": m["loss"].item(), "checksum": checksum}), flush=True)
    torch.distributed.destroy_process_group()
    """
)


def test_two_processes_join_through_torchruns_environment(tmp_path):
    """The multi-host path (the counterpart of ``tests/test_multihost.py``):
    two OS processes with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` set as torchrun sets them; one CNN+BiLSTM DP step;
    their parameter checksums and losses agree."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
               LOCAL_WORLD_SIZE="2")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER], cwd=tmp_path,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert [r["rank"] for r in results] == [0, 1]
    assert results[0]["mesh"] == {"data": 2, "model": 1} and results[0]["backend"] == "gloo"
    assert results[0]["checksum"] == results[1]["checksum"]
    assert results[0]["loss"] == results[1]["loss"] and np.isfinite(results[0]["loss"])


def test_scaling_bench_on_one_and_two_ranks(tmp_path):
    """The JAX CLI's flags and JSON layout; on the CPU the ranks share its
    cores, so the numbers say nothing of speed: only the layout, the drift
    rows against one rank (the same data and draws: reduction order only)
    and the chaos control are held."""
    path = tmp_path / "scaling.json"
    payload = scaling_bench.main(["--devices", "1", "2", "--steps", "2", "--global-batch", "2",
                                  "--models", "cnn_blstm", "--clip-seconds", "0.1", "--chaos",
                                  "--output-json", str(path), "--device", "cpu"])
    assert json.loads(path.read_text()) == payload
    cond = payload["condition"]
    assert {k: cond[k] for k in ("global_batch", "steps", "clip_seconds", "platform")} == {
        "global_batch": 2, "steps": 2, "clip_seconds": 0.1, "platform": "cpu"}
    rows = payload["models"]["cnn_blstm"]
    assert set(rows) == {"1", "2"}
    for row in rows.values():
        assert row["steps_per_sec"] > 0 and np.isfinite(row["final_loss"])
        assert row["backend"] == "gloo"
        assert row["audio_seconds_per_sec"] == pytest.approx(2 * 0.1 * row["steps_per_sec"])
    assert rows["2"]["max_rel_loss_drift_vs_1dev"] <= 1e-5
    chaos = payload["chaos_control"]["cnn_blstm"]
    assert chaos["devices"] == 1 and set(chaos) >= {"init", "every_step", "note"}
    assert all(np.isfinite(chaos[v]["max_rel_loss_drift"]) for v in ("init", "every_step"))
    with pytest.raises(SystemExit, match="% 2 != 0"):
        scaling_bench.main(["--devices", "2", "--global-batch", "3", "--device", "cpu"])
    flags = {a.dest for a in scaling_bench.build_argparser()._actions} - {"help"}
    assert flags == {"devices", "steps", "global_batch", "models", "clip_seconds", "chaos",
                     "chaos_only", "output_json", "device"}
