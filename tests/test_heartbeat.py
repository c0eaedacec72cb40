"""Multi-host failure detection (parallel/heartbeat.py): heartbeat
liveness, startup barrier, dead-peer and wedged-peer (fresh beats,
frozen step) detection, and the Trainer integration."""

import time

import pytest

from deepvcp.parallel import (
    Heartbeat,
    PeerFailure,
    Watchdog,
    check_peers,
    wait_for_all_hosts,
)


def test_heartbeat_and_peer_status(tmp_path):
    d = str(tmp_path)
    hb0 = Heartbeat(d, 0, interval=0.05).start()
    hb1 = Heartbeat(d, 1, interval=0.05).start()
    try:
        wait_for_all_hosts(d, 2, timeout=5.0, poll=0.05)
        peers = check_peers(d, 2, stale_after=5.0)
        assert all(p["status"] == "alive" for p in peers.values())
        # kill peer 1: its beats stop, timestamp goes stale
        hb1.stop()
        time.sleep(0.3)
        peers = check_peers(d, 2, stale_after=0.2)
        assert peers[0]["status"] == "alive"
        assert peers[1]["status"] == "stale"
    finally:
        hb0.stop()
        hb1.stop()


def test_missing_peer_and_barrier_timeout(tmp_path):
    d = str(tmp_path)
    Heartbeat(d, 0, interval=10.0).start().stop()
    peers = check_peers(d, 2, stale_after=60.0)
    assert peers[0]["status"] == "alive"
    assert peers[1]["status"] == "missing"
    with pytest.raises(PeerFailure, match=r"\[1\]"):
        wait_for_all_hosts(d, 2, timeout=0.3, poll=0.05)


def test_watchdog_raises_on_dead_peer(tmp_path):
    d = str(tmp_path)
    hb0 = Heartbeat(d, 0, interval=0.05).start()
    hb1 = Heartbeat(d, 1, interval=0.05).start()
    wd = Watchdog(d, 2, process_id=0, stale_after=0.2)
    try:
        wd.scan()  # both alive
        hb1.stop()
        time.sleep(0.4)
        with pytest.raises(PeerFailure, match="stale"):
            wd.scan()
    finally:
        hb0.stop()


def test_watchdog_detects_wedged_peer(tmp_path):
    """A hung peer keeps beating (daemon thread alive) but its step
    freezes — the failure mode a timestamp-only check cannot see."""
    d = str(tmp_path)
    hb0 = Heartbeat(d, 0, interval=0.05).start()
    hb1 = Heartbeat(d, 1, interval=0.05).start()
    wd = Watchdog(d, 2, process_id=0, stale_after=10.0,
                  step_stale_after=0.3)
    try:
        hb0.update(1)
        hb1.update(1)
        time.sleep(0.1)
        wd.scan()  # baseline: records both peers' steps
        # peer 0 progresses, peer 1 wedges at step 1 with fresh beats
        hb0.update(2)
        time.sleep(0.45)  # > step_stale_after since peer 1 last moved
        with pytest.raises(PeerFailure, match="stalled"):
            wd.scan()
    finally:
        hb0.stop()
        hb1.stop()


def test_on_failure_callback(tmp_path):
    d = str(tmp_path)
    hb0 = Heartbeat(d, 0, interval=0.05).start()
    seen = []
    wd = Watchdog(d, 2, process_id=0, stale_after=0.2,
                  on_failure=lambda peers: seen.append(peers))
    try:
        time.sleep(0.1)
        wd.scan()
        assert seen and seen[0][1]["status"] == "missing"
    finally:
        hb0.stop()


def test_trainer_single_process_heartbeat(tmp_path):
    """cfg.heartbeat_interval wires the detector into Trainer.fit;
    single-process it must run (barrier trivially passes) and clean up."""
    import dataclasses
    import os

    import jax

    from deepvcp import DeepVCPConfig
    from deepvcp.config import TrainConfig
    from deepvcp.data import SyntheticDataset, batch_iterator
    from deepvcp.train import Trainer

    model_cfg = DeepVCPConfig.tiny(num_points=64, use_normal=False)
    tcfg = TrainConfig(
        num_epochs=1, batch_size=2,
        checkpoint_dir=str(tmp_path / "ckpt"),
        metrics_path=str(tmp_path / "m.jsonl"),
        heartbeat_interval=0.1,
    )
    ds = SyntheticDataset(num_clouds=2, num_points=64, extent=1.0, seed=0)
    sample = next(batch_iterator(ds, 2, epoch=0, seed=0))
    tr = Trainer(model_cfg, tcfg)
    tr.setup(sample)
    tr.fit(lambda epoch: batch_iterator(ds, 2, epoch=epoch, seed=0))
    hb = os.path.join(tcfg.checkpoint_dir, "heartbeats",
                      "heartbeat_0.json")
    assert os.path.exists(hb)
